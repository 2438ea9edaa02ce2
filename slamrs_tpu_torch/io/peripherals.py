"""Behavioral models of the robot's board peripherals.

A copy of ``slamrs_tpu/io/peripherals.py`` (the port imports nothing of
the JAX package).

Closes the firmware-workspace coverage rows that were hardware-only:

* :class:`LedStatus` / :class:`Heartbeat` — the status-LED task
  (slamrs-robot-rtic/firmware/src/tasks/heartbeat.rs:6-95): a 10 Hz
  loop reading a shared ``LedStatus`` and driving the WS2812B at 1/8
  brightness, toggling every 10/5/1 iterations for Slow/Medium/Fast.
* :class:`QuadratureDecoder` — the PIO quadrature program
  (firmware/pio/encoder.pio, a port of adamgreen/QuadratureDecoder):
  a 16-entry jump table on (previous 2-bit state << 2 | current) that
  adds -1/0/+1 per sample, invalid double-transitions counting 0.
* :class:`Pca9685` / :class:`MotorDriver` / :class:`Motor` — the
  Featherwing motor driver (firmware/src/motor.rs): prescale from the
  0.9-corrected frequency, per-channel on/off registers, the
  take-low-first direction sequencing and the (in1, in2, pwm) channel
  map per motor slot.
* :class:`EspAtBridge` — the ESP32 bridge task's host-visible protocol
  (firmware/src/tasks/esp.rs:26-200): the exact AT bring-up sequence
  (SYSMSG -> CWSTATE -> on GotIP: MDNS, CIPMUX, CIPSERVERMAXCONN,
  CIPSERVER), the LED status at each stage, and Connected/Disconnected
  events from client connect/close, driven by the same
  :class:`slamrs_tpu_torch.io.atparser.AtParser` the protocol tests use.

These are deterministic pure-python models (no wall clock): tests and
the virtual robot advance them explicitly.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from slamrs_tpu_torch.io.atparser import AtParser, EspMessage

# heartbeat.rs:16-28
COLORS = {
    "red": (255, 0, 0),
    "green": (0, 255, 0),
    "blue": (0, 0, 255),
    "yellow": (255, 255, 0),
    "cyan": (0, 255, 255),
    "magenta": (255, 0, 255),
    "white": (255, 255, 255),
}
# heartbeat.rs:36-43 (iterations of the 10 Hz loop per toggle)
SPEEDS = {"slow": 10, "medium": 5, "fast": 1}
_SCALE = 8  # heartbeat.rs:58


@dataclasses.dataclass(frozen=True)
class LedStatus:
    """heartbeat.rs:46-52: Off | On(color) | Blinking(color, speed)."""

    mode: str = "off"  # 'off' | 'on' | 'blinking'
    color: str = "green"
    speed: str = "slow"

    @staticmethod
    def off() -> "LedStatus":
        return LedStatus()

    @staticmethod
    def on(color: str) -> "LedStatus":
        return LedStatus("on", color)

    @staticmethod
    def blinking(color: str, speed: str) -> "LedStatus":
        return LedStatus("blinking", color, speed)


class Heartbeat:
    """The 10 Hz LED task (heartbeat.rs:54-95).  Call :meth:`tick` once
    per 100 ms of virtual time; :attr:`rgb` is the WS2812B output."""

    def __init__(self):
        self.status = LedStatus.off()
        self.rgb = (0, 0, 0)
        self._counter = 0
        self._was_on = False

    def set_status(self, status: LedStatus) -> None:
        self.status = status

    def tick(self) -> tuple[int, int, int]:
        s = self.status
        if s.mode == "off":
            self.rgb = (0, 0, 0)
            self._was_on = False
        elif s.mode == "on":
            r, g, b = COLORS[s.color]
            self.rgb = (r // _SCALE, g // _SCALE, b // _SCALE)
            self._was_on = True
        else:  # blinking
            iterations = SPEEDS[s.speed]
            if self._counter % iterations == 0:
                self._was_on = not self._was_on
                if self._was_on:
                    r, g, b = COLORS[s.color]
                    self.rgb = (r // _SCALE, g // _SCALE, b // _SCALE)
                else:
                    self.rgb = (0, 0, 0)
        self._counter += 1
        return self.rgb


# encoder.pio jump table: index = prev_state << 2 | current_state,
# states are the 2-bit (B << 1 | A) pin readings
_QUAD_DELTA = (0, -1, +1, 0,
               +1, 0, 0, -1,
               -1, 0, 0, +1,
               0, +1, -1, 0)


class QuadratureDecoder:
    """PIO quadrature counter (encoder.pio / encoder.rs): one sample of
    the (A, B) pins per :meth:`sample` call, 32-bit wrapping count like
    the DMA-mirrored X register."""

    def __init__(self, a: int = 0, b: int = 0):
        self._state = (b << 1) | a
        self.count = 0

    def sample(self, a: int, b: int) -> int:
        cur = (b << 1) | a
        self.count = (self.count
                      + _QUAD_DELTA[(self._state << 2) | cur]) & 0xFFFFFFFF
        self._state = cur
        return self.count

    @property
    def signed(self) -> int:
        c = self.count
        return c - 0x100000000 if c >= 0x80000000 else c


class Pca9685:
    """Register-level PCA9685 model: 16 channels of (on, off) 12-bit
    counts plus the prescale register (motor.rs:65-86 init math)."""

    def __init__(self, address: int = 0x60):
        self.address = address
        self.enabled = False
        self.prescale = 0
        self.channels = [(0, 0)] * 16
        self.writes: list[tuple[int, int, int]] = []  # (ch, on, off) log

    def enable(self) -> None:
        self.enabled = True

    def set_prescale(self, prescale: int) -> None:
        self.prescale = prescale

    def set_channel_on_off(self, channel: int, on: int, off: int) -> None:
        self.channels[channel] = (on, off)
        self.writes.append((channel, on, off))

    def duty(self, channel: int) -> int:
        on, off = self.channels[channel]
        return off - on


# motor.rs:96-101: (in1, in2, pwm) PCA9685 channels per motor slot
_MOTOR_CHANNELS = {0: (10, 9, 8), 1: (11, 12, 13),
                   2: (4, 3, 2), 3: (5, 6, 7)}


class MotorDriver:
    """motor.rs:23-112: hands out :class:`Motor` instances over a shared
    PCA9685, computing the prescale exactly like the reference."""

    def __init__(self, pwm: Pca9685, frequency_hz: float = 1600.0):
        frequency_hz *= 0.9  # overshoot correction (motor.rs:71)
        prescaleval = 25000000.0 / 4096.0 / frequency_hz - 1.0
        pwm.enable()
        pwm.set_prescale(int(prescaleval + 0.5))
        self.pwm = pwm
        self._taken = [False] * 4

    def motor(self, motor_id: int) -> "Motor":
        if self._taken[motor_id]:
            raise ValueError("MotorAlreadyTaken")
        self._taken[motor_id] = True
        return Motor(self, *_MOTOR_CHANNELS[motor_id])


class Motor:
    """motor.rs:114-170: signed speed = direction pins + 12-bit duty."""

    def __init__(self, driver: MotorDriver, in1: int, in2: int, pwm: int):
        self._driver = driver
        self.in1 = in1
        self.in2 = in2
        self.pwm_channel = pwm

    def set_speed_signed(self, speed: int) -> None:
        if speed > 0:
            self.set_direction("forward")
            duty = speed
        elif speed < 0:
            self.set_direction("backward")
            duty = -speed
        else:
            self.set_direction("free")
            duty = 0
        self._driver.pwm.set_channel_on_off(self.pwm_channel, 0, duty)

    def set_direction(self, direction: str) -> None:
        pwm = self._driver.pwm
        if direction == "forward":
            pwm.set_channel_on_off(self.in2, 0, 0)  # take low first
            pwm.set_channel_on_off(self.in1, 0, 4095)
        elif direction == "backward":
            pwm.set_channel_on_off(self.in1, 0, 0)  # take low first
            pwm.set_channel_on_off(self.in2, 0, 4095)
        elif direction == "free":
            pwm.set_channel_on_off(self.in1, 0, 0)
            pwm.set_channel_on_off(self.in2, 0, 0)
        elif direction == "brake":
            pwm.set_channel_on_off(self.in1, 0, 4095)
            pwm.set_channel_on_off(self.in2, 0, 4095)
        else:
            raise ValueError(direction)

    @property
    def signed_speed(self) -> int:
        """Read the plant-visible command back out of the registers."""
        pwm = self._driver.pwm
        duty = pwm.duty(self.pwm_channel)
        if pwm.duty(self.in1) > 0 and pwm.duty(self.in2) > 0:
            return 0  # brake
        if pwm.duty(self.in1) > 0:
            return duty
        if pwm.duty(self.in2) > 0:
            return -duty
        return 0  # free


class EspAtBridge:
    """The ESP bring-up/bridge protocol as the host sees it
    (tasks/esp.rs:26-200).  Feed ESP-side bytes with :meth:`feed`; the
    commands the firmware would write to the UART accumulate in
    :attr:`sent`; connection events invoke ``on_event`` ('connected' /
    'disconnected'); ``led`` mirrors the firmware's status LED.
    """

    def __init__(self, on_event: Optional[Callable[[str], None]] = None):
        self.parser = AtParser()
        self.sent: list[bytes] = []
        self.led = Heartbeat()
        self.on_event = on_event or (lambda e: None)
        self.state = "reset"  # -> ready -> configured -> listening
        self.is_connected = False
        # init_esp entry (esp.rs:30-31)
        self.led.set_status(LedStatus.blinking("blue", "fast"))

    def _send(self, cmd: bytes) -> None:
        self.sent.append(cmd)

    def feed(self, data: bytes) -> list[EspMessage]:
        msgs = self.parser.consume(data)
        for m in msgs:
            self._handle(m)
        return msgs

    def _handle(self, m: EspMessage) -> None:
        if m.kind == "ready" and self.state == "reset":
            # esp.rs:46-57: configure, then enter the message loop
            self._send(b"AT+SYSMSG=0\r\n")
            self._send(b"AT+CWSTATE?\r\n")
            self.state = "ready"
            self.led.set_status(LedStatus.blinking("blue", "medium"))
        elif m.kind == "wifi_got_ip":
            # esp.rs:139-167: mdns + server bring-up
            self.led.set_status(LedStatus.blinking("cyan", "fast"))
            self._send(b'AT+MDNS=1,"robot","_tcp",8080\r\n')
            self._send(b"AT+CIPMUX=1\r\n")
            self._send(b"AT+CIPSERVERMAXCONN=1\r\n")
            self._send(b"AT+CIPSERVER=1,8080\r\n")
            self.state = "listening"
            self.led.set_status(LedStatus.blinking("green", "slow"))
        elif m.kind == "connect":
            self.is_connected = True
            # Event::Connected (main.rs:499-502)
            self.led.set_status(LedStatus.blinking("green", "fast"))
            self.on_event("connected")
        elif m.kind == "closed":
            self.is_connected = False
            # Event::Disconnected (main.rs:503-507)
            self.led.set_status(LedStatus.blinking("green", "slow"))
            self.on_event("disconnected")
