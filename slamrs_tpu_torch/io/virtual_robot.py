"""Virtual robot: a behavioral host-side port of the RP2040 firmware.

Counterpart of ``slamrs_tpu/io/virtual_robot.py``.  The control, the
odometry and the wire encoding are host integer and float64 arithmetic,
the JAX model's line for line, so the bytes it emits are the JAX
model's.  The lidar is the port's own scene raycast
(``models/simulator.lidar_scan``) on ``device`` (``cuda`` unless the
CPU is asked for; without CUDA it raises): the scene lives there, and
the distances and the valid mask come back to numpy once a revolution
(at most 5 Hz), quantized to mm on the host as the JAX model does.

The reference's firmware workspace (slamrs-robot-rtic) is real embedded
code; this module reproduces its OBSERVABLE behavior so the full
host<->robot system can run, be tested, and generate data without
hardware.  Ported task semantics (all citations into the firmware
workspace):

* event loop (firmware/src/main.rs:482-548): NeatoOn/Off gate the lidar,
  SetDownsampling updates the shared factor, SetMotorPiParams swaps the
  PI gains, Drive converts m/s -> encoder steps/s via
  ``MOTOR_STEPS_PER_METER`` (main.rs:107-110), a Pong heartbeat fires
  every second while connected, Disconnected stops the lidar motor.
* PI wheel-speed control (tasks/motors.rs:15-128): 10 Hz loop, Q16.16
  fixed-point arithmetic, anti-windup sat-limit at +-4095, output
  deadband < 100 -> 0, defaults kp=0.5 ki=2.0; SpeedEstimator from
  encoder deltas (ticks/s).
* neato task (tasks/neato.rs:70-129): raw RPM exponential smoothing
  (accumulator >> 2), downsample counter (emit when counter > every,
  then reset), per-frame encoder odometry deltas converted to meters
  (including the firmware's dead RPM sanity check, faithfully omitted —
  tasks/neato.rs:83-86 can never fire).
* wire format: bincode RobotMessage/CommandMessage (slamrs-message) and
  XV11 frames via :func:`slamrs_tpu_torch.io.neato.encode_frame`.

The "plant" (motor -> wheel) is a configurable first-order gain and the
lidar is this framework's own simulator scene raycast, so a
RobotConnection node talking to a VirtualRobot over TCP or a socketpair
exercises the exact same code path as a real robot.
"""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from slamrs_tpu_torch.io.message import CommandMessage, RobotMessage, ScanFrame
from slamrs_tpu_torch.io.neato import BEAMS, encode_frame

# firmware constants (main.rs:107-110)
MOTOR_STEPS_PER_REV = 2000
MOTOR_WHEEL_DIAMETER = 0.06  # meters
MOTOR_STEPS_PER_METER = MOTOR_STEPS_PER_REV / (MOTOR_WHEEL_DIAMETER
                                               * math.pi)
CONTROL_LOOP_PERIOD_S = 0.1  # motors.rs:11
MAX_VALUE = 4095  # motors.rs:13
DEADBAND = 100  # motors.rs:52-58
LIDAR_PERIOD_S = 0.2  # 300 RPM -> 5 Hz revolutions
_ONE = 1 << 16  # Q16.16 scale


def _q(x: float) -> int:
    """float -> Q16.16 (fixed crate F32 semantics, truncating)."""
    return int(x * _ONE)


def _qmul(a: int, b: int) -> int:
    return (a * b) >> 16


class PiController:
    """motors.rs:91-115 in Q16.16: anti-windup integral with sat flag."""

    def __init__(self):
        self.x_integral = 0
        self.sat = 0

    def update(self, target: int, current: int, kp: int, ki2: int) -> int:
        error = target - current
        if (self.sat < 0 and error < 0) or (self.sat > 0 and error > 0):
            pass  # anti wind-up (motors.rs:103-105)
        else:
            self.x_integral += _qmul(ki2, error)
            self.x_integral, self.sat = _satlimit(
                self.x_integral, -_q(MAX_VALUE), _q(MAX_VALUE))
        return _limit(_qmul(kp, error) + self.x_integral,
                      -_q(MAX_VALUE), _q(MAX_VALUE))


def _satlimit(x: int, lo: int, hi: int):
    if x < lo:
        return lo, -1
    if x > hi:
        return hi, 1
    return x, 0


def _limit(x: int, lo: int, hi: int) -> int:
    return max(lo, min(hi, x))


class SpeedEstimator:
    """motors.rs:72-89: encoder-delta speed in ticks/s (Q16.16)."""

    def __init__(self, initial_position: int):
        self.last = initial_position

    def update(self, position: int) -> int:
        diff = position - self.last
        self.last = position
        return _q(diff * 1000 // int(CONTROL_LOOP_PERIOD_S * 1000))


@dataclass
class VirtualRobot:
    """Steppable firmware-behavior model.  Advance virtual time with
    :meth:`step`; feed host commands with :meth:`handle_command`; emitted
    ``RobotMessage`` byte strings accumulate in :attr:`outbox`."""

    scene: Optional[object] = None  # slamrs_tpu_torch.models.simulator.Scene
    scanner_range: float = 5.0
    plant_gain: float = 1.0  # wheel steps/s per PWM unit
    kp: float = 0.5  # motors.rs:121-128 defaults
    ki: float = 2.0

    pose: np.ndarray = field(
        default_factory=lambda: np.zeros(3, np.float64))
    wheel_base: float = 0.2  # host-side constant (connection.rs:25)
    device: object = "cuda"  # where the scene lives and the lidar runs

    def __post_init__(self):
        from slamrs_tpu_torch.graph.app import check_device
        from slamrs_tpu_torch.io.peripherals import (Heartbeat, LedStatus,
                                                     MotorDriver, Pca9685)

        self.device = check_device(self.device)
        if self.scene is not None:
            self.scene = type(self.scene)(
                *(t.to(self.device) for t in self.scene))

        self.connected = False
        self.neato_on = False
        # board peripherals: the status LED's 10 Hz task shares the
        # control-loop cadence (heartbeat.rs runs its own 10 Hz loop);
        # wheel commands go through the register-level PCA9685 motor
        # driver exactly like main.rs:393-394 (M1 right, M0 left)
        self.led = Heartbeat()
        self._led_status_cls = LedStatus
        self.pca = Pca9685()
        driver = MotorDriver(self.pca)
        self._motor_left = driver.motor(0)
        self._motor_right = driver.motor(1)
        self.downsampling = 2
        self.target_left = 0  # steps/s (int, like the shared resources)
        self.target_right = 0
        self.enc_left = 0.0  # float accumulation of encoder steps
        self.enc_right = 0.0
        self._pi_l = PiController()
        self._pi_r = PiController()
        self._est_l = SpeedEstimator(0)
        self._est_r = SpeedEstimator(0)
        self._speed_l = 0.0  # current wheel speeds, steps/s
        self._speed_r = 0.0
        self._last_odo_l = 0
        self._last_odo_r = 0
        self._downsample_counter = 0
        self._rpm_accumulator = 0
        self._rpm_average = 0
        self._t = 0.0
        self._next_control = 0.0
        self._next_rev = LIDAR_PERIOD_S
        self._next_pong = 1.0
        self.outbox: list[bytes] = []

    # ---- host -> robot --------------------------------------------------

    def connect(self) -> None:
        self.connected = True  # Event::Connected (main.rs:499-502)
        self.led.set_status(self._led_status_cls.blinking("green", "fast"))

    def disconnect(self) -> None:
        self.connected = False  # Event::Disconnected stops the lidar
        self.neato_on = False  # (main.rs:503-507)
        self.led.set_status(self._led_status_cls.blinking("green", "slow"))

    def synchronize(self) -> None:
        """Wait for the lidar's device work (a no-op on the CPU)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def handle_command(self, msg: CommandMessage) -> None:
        """event_loop command dispatch (main.rs:508-540)."""
        if msg.kind == "neato_on":
            self.neato_on = True
            self._rpm_average = 0
        elif msg.kind == "neato_off":
            self.neato_on = False
        elif msg.kind == "set_downsampling":
            self.downsampling = msg.every
        elif msg.kind == "set_motor_pi_params":
            self.kp, self.ki = msg.kp, msg.ki
        elif msg.kind == "drive":
            # m/s -> steps/s, truncated like the firmware's `as i32`
            self.target_left = int(msg.left * MOTOR_STEPS_PER_METER)
            self.target_right = int(msg.right * MOTOR_STEPS_PER_METER)
        # Ping and unknown variants fall through (the `_ => {}` arm)

    # ---- time -----------------------------------------------------------

    def step(self, dt: float) -> None:
        """Advance virtual time, running the 10 Hz control loop, the 5 Hz
        lidar revolutions, and the 1 Hz Pong heartbeat at their firmware
        cadences."""
        t_end = self._t + dt
        while True:
            nxt = min(self._next_control, self._next_rev, self._next_pong)
            if nxt > t_end:
                break
            self._integrate(nxt - self._t)
            self._t = nxt
            if self._t >= self._next_control:
                self._control_tick()
                self._next_control += CONTROL_LOOP_PERIOD_S
            if self._t >= self._next_rev:
                self._lidar_rev()
                self._next_rev += LIDAR_PERIOD_S
            if self._t >= self._next_pong:
                if self.connected:
                    self.outbox.append(RobotMessage.pong().encode())
                self._next_pong += 1.0
        self._integrate(t_end - self._t)
        self._t = t_end

    def _integrate(self, dt: float) -> None:
        if dt <= 0:
            return
        self.enc_left += self._speed_l * dt
        self.enc_right += self._speed_r * dt
        dl = self._speed_l * dt / MOTOR_STEPS_PER_METER
        dr = self._speed_r * dt / MOTOR_STEPS_PER_METER
        theta = self.pose[2] + (dr - dl) / self.wheel_base
        s = (dl + dr) / 2.0
        self.pose = np.array([self.pose[0] + math.cos(theta) * s,
                              self.pose[1] + math.sin(theta) * s,
                              theta])

    def _control_tick(self) -> None:
        """motors.rs:15-70, with the PWM->wheel plant closing the loop."""
        cur_l = self._est_l.update(int(self.enc_left))
        cur_r = self._est_r.update(int(self.enc_right))
        kp, ki = _q(self.kp), _q(self.ki)
        ki2 = ki * int(CONTROL_LOOP_PERIOD_S * 1000) // 1000
        out_l = self._pi_l.update(_q(self.target_left), cur_l, kp, ki2)
        out_r = self._pi_r.update(_q(self.target_right), cur_r, kp, ki2)
        pwm_l = out_l >> 16  # .to_num::<i16>()
        pwm_r = out_r >> 16
        if abs(pwm_l) < DEADBAND:
            pwm_l = 0
        if abs(pwm_r) < DEADBAND:
            pwm_r = 0
        # drive the PCA9685 registers and let the plant read the command
        # back out of them (direction pins + 12-bit duty, motor.rs)
        self._motor_left.set_speed_signed(pwm_l)
        self._motor_right.set_speed_signed(pwm_r)
        self._speed_l = self._motor_left.signed_speed * self.plant_gain
        self._speed_r = self._motor_right.signed_speed * self.plant_gain
        self.led.tick()  # heartbeat.rs shares the 10 Hz cadence

    def _lidar_rev(self) -> None:
        """tasks/neato.rs:70-129: one revolution ingested."""
        if not self.neato_on:
            return
        rpm_raw = int(60.0 / LIDAR_PERIOD_S) * 64  # 300 rpm * 64
        self._rpm_accumulator += rpm_raw - self._rpm_average
        self._rpm_average = self._rpm_accumulator >> 2
        rpm = self._rpm_average // 64

        self._downsample_counter += 1
        if self._downsample_counter > self.downsampling:
            self._downsample_counter = 0
        else:
            return

        odo_l = int(self.enc_left)
        odo_r = int(self.enc_right)
        dl = (odo_l - self._last_odo_l) / MOTOR_STEPS_PER_METER
        dr = (odo_r - self._last_odo_r) / MOTOR_STEPS_PER_METER
        self._last_odo_l, self._last_odo_r = odo_l, odo_r

        scan = self._scan()
        frame = encode_frame(scan["distance_mm"], scan["strength"],
                             scan["valid"], rpm=60.0 / LIDAR_PERIOD_S)
        msg = RobotMessage.from_scan(ScanFrame(frame, (dl, dr), int(rpm)))
        self.outbox.append(msg.encode())

    def _scan(self) -> dict:
        if self.scene is None:
            d = np.full(BEAMS, 1500, np.uint16)
            return {"distance_mm": d,
                    "strength": np.full(BEAMS, 200, np.uint16),
                    "valid": np.ones(BEAMS, bool)}
        from slamrs_tpu_torch.models import simulator as sim_model

        pose = torch.from_numpy(self.pose.astype(np.float32)).to(self.device)
        scan = sim_model.lidar_scan(pose, self.scene,
                                    float(np.float32(self.scanner_range)),
                                    BEAMS)
        # one copy to the host: the distances and the valid mask
        host = torch.stack([scan.distances,
                            scan.valid.to(torch.float32)]).cpu().numpy()
        dist = host[0].astype(np.float64) * 1000.0
        valid = host[1] != 0
        return {"distance_mm": np.clip(dist, 0, 0x3FFF).astype(np.uint16),
                "strength": np.full(BEAMS, 200, np.uint16),
                "valid": valid}


# the longest a server thread may take to reach its next step boundary
# (a write waits up to 5 s for a lagging host)
STOP_TIMEOUT_S = 30.0


def _stop_thread(stop: threading.Event, thread: threading.Thread) -> None:
    """Ask a server thread to stop and wait until it has: a thread left
    running a torch call while the interpreter finalizes aborts the
    process."""
    stop.set()
    thread.join(STOP_TIMEOUT_S)
    if thread.is_alive():
        raise RuntimeError(f"the virtual robot's server thread did not stop "
                           f"within {STOP_TIMEOUT_S} s")


class VirtualRobotServer:
    """Serve a VirtualRobot over a ConnectionMedium (socketpair in tests,
    a real TCP listener for interactive use) — the transport-bridge role
    of BOTH firmware bridges: the ESP32 TCP task (tasks/esp.rs) and the
    USB-CDC task (tasks/usb.rs, whose observable behavior is byte
    bridging of the same RobotMessage stream plus DTR-driven
    Connected/Disconnected events — here the server start/close)."""

    def __init__(self, robot: VirtualRobot, medium, realtime: bool = False,
                 dt: float = 0.05):
        self.robot = robot
        self.medium = medium
        self.dt = dt
        self.realtime = realtime
        self._stop = threading.Event()
        self._buf = bytearray()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self.robot.connect()
        self._thread.start()

    def _run(self) -> None:
        import time as _time

        while not self._stop.is_set():
            t0 = _time.monotonic()
            data = self.medium.read(4096)
            if data is None:
                self._stop.set()  # host closed -> stop serving
                break
            if data:
                self._buf.extend(data)
                self._dispatch()
            self.robot.step(self.dt)
            for raw in self.robot.outbox:
                try:
                    self.medium.write(raw)
                except Exception:
                    self._stop.set()
                    break
            self.robot.outbox.clear()
            if self.realtime:
                # the read timeout already consumed wall time; pace the
                # REMAINDER so virtual time tracks the wall clock 1:1
                sleep = self.dt - (_time.monotonic() - t0)
                if sleep > 0:
                    _time.sleep(sleep)

    def _dispatch(self) -> None:
        while True:
            try:
                msg, consumed = CommandMessage.decode(bytes(self._buf))
            except (EOFError, IndexError):
                return
            except ValueError:
                del self._buf[:1]
                continue
            del self._buf[:consumed]
            self.robot.handle_command(msg)

    def close(self) -> None:
        """Stop serving: the server thread ends at its next step boundary
        (a read waits at most the medium's timeout) and is joined; then
        the robot disconnects and its device finishes the work queued
        there, so no torch call is left running behind the caller."""
        _stop_thread(self._stop, self._thread)
        self.robot.disconnect()
        self.robot.synchronize()
        self.medium.close()


class UsbCdcServer:
    """pty-backed USB-CDC bridge (tasks/usb.rs:7-81): the virtual robot
    enumerates as a serial tty device — the host opens :attr:`path` with
    :class:`slamrs_tpu_torch.io.connection.SerialMedium` exactly as it would a
    real ``/dev/ttyACM0`` (baud is nominal; real CDC ignores it too).

    The firmware drives Connected/Disconnected events off the CDC DTR
    line (usb.rs:24-40); the pty equivalents: Connected on the first
    host bytes (opening the port asserts DTR and the host handshake
    immediately writes ``NeatoOn``), Disconnected on hangup (EIO on the
    master once the host closes the slave).  After a hangup the server
    re-arms and accepts the next session, like re-plugging USB.
    """

    def __init__(self, robot: VirtualRobot, realtime: bool = False,
                 dt: float = 0.05):
        import os

        self.robot = robot
        self.dt = dt
        self.realtime = realtime
        self._master, holder = os.openpty()
        self.path = os.ttyname(holder)
        # raw mode on the slave tty (a real CDC ACM device has no line
        # discipline): without this, ICANON line-buffers the binary
        # frames and ECHO feeds host bytes back into the command parser
        self._raw_tty(holder)
        # the holder keeps the pty alive while no host has it open;
        # closed once a host connects so host-close surfaces as EIO
        self._holder: Optional[int] = holder
        self._stop = threading.Event()
        self._buf = bytearray()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    @staticmethod
    def _raw_tty(fd: int) -> None:
        import tty

        tty.setraw(fd)

    def _read_master(self) -> Optional[bytes]:
        """b'' on timeout, None on hangup (host dropped DTR)."""
        import os
        import select

        r, _, _ = select.select([self._master], [], [], self.dt)
        if not r:
            return b""
        try:
            return os.read(self._master, 4096)
        except OSError:  # EIO: slave side fully closed
            return None

    def _run(self) -> None:
        import os
        import select
        import time as _time

        while not self._stop.is_set():
            t0 = _time.monotonic()
            data = self._read_master()
            if data is None:
                if self.robot.connected:
                    self.robot.disconnect()  # DTR dropped (usb.rs:33-40)
                # re-arm: hold the slave open again for the next session
                self._holder = os.open(self.path,
                                       os.O_RDWR | os.O_NOCTTY
                                       | os.O_NONBLOCK)
                self._raw_tty(self._holder)
                continue
            if data:
                if not self.robot.connected:
                    self.robot.connect()  # DTR asserted (usb.rs:24-32)
                    if self._holder is not None:
                        os.close(self._holder)
                        self._holder = None
                self._buf.extend(data)
                self._dispatch()
            self.robot.step(self.dt)
            for raw in self.robot.outbox:
                if not self.robot.connected:
                    break  # nobody listening: drop, like the firmware
                view = memoryview(raw)
                while view and not self._stop.is_set():
                    _, w, _ = select.select([], [self._master], [], 1.0)
                    if not w:
                        break  # stalled host: drop the rest of the frame
                    try:
                        sent = os.write(self._master, view)
                    except OSError:
                        break
                    view = view[sent:]
            self.robot.outbox.clear()
            if self.realtime:
                sleep = self.dt - (_time.monotonic() - t0)
                if sleep > 0:
                    _time.sleep(sleep)

    def _dispatch(self) -> None:
        while True:
            try:
                msg, consumed = CommandMessage.decode(bytes(self._buf))
            except (EOFError, IndexError):
                return
            except ValueError:
                del self._buf[:1]
                continue
            del self._buf[:consumed]
            self.robot.handle_command(msg)

    def close(self) -> None:
        import os

        _stop_thread(self._stop, self._thread)
        if self.robot.connected:
            self.robot.disconnect()
        self.robot.synchronize()
        for fd in (self._master, self._holder):
            if fd is not None:
                try:
                    os.close(fd)
                except OSError:
                    pass
