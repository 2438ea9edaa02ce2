"""The port's robot I/O (``slamrs_tpu_torch.io``, ``slamrs_tpu_torch.native``)
against the JAX package's on the same inputs, on the CPU.

Held to equality (bytes, integers and arrays exact): the bincode wire
codec (every ``CommandMessage`` and ``RobotMessage`` variant, varint
boundaries, truncated and malformed buffers raising alike); the Neato
codec (``parse_frame``, ``encode_frame``, ``parse_packets`` on forged
streams with garbage, bad checksums, partial packets and index wraps;
the port's native parser against its python path and the JAX one); the
native wire codec against the python drain on a 200-message stream cut
at random offsets; the buffer pool, the AT parser and the peripheral
models on the same input sequences; the virtual robot's outbox and every
controller state, with no scene and with ``cmd_robot``'s scene, except
scan distances, which may differ by 1 mm on fewer than 1e-3 of the beams
(the raycast's float32 rounding on the two sides).  Links: ``RobotLink``
against ``VirtualRobotServer`` over a socketpair (handshake, streaming,
drive forwarding, clean end of stream) and the USB-CDC pty session, each
with a deadline of at most 10 s and its threads and descriptors closed
in ``finally``.
"""

from __future__ import annotations

import dataclasses
import os
import socket
import struct
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from slamrs_tpu.io import atparser as jat  # noqa: E402
from slamrs_tpu.io import message as jmsg  # noqa: E402
from slamrs_tpu.io import neato as jneato  # noqa: E402
from slamrs_tpu.io import peripherals as jper  # noqa: E402
from slamrs_tpu.io import pool as jpool  # noqa: E402
from slamrs_tpu.io import virtual_robot as jvr  # noqa: E402
from slamrs_tpu.models import simulator as jsim  # noqa: E402
from slamrs_tpu_torch import native  # noqa: E402
from slamrs_tpu_torch.io import atparser as tat  # noqa: E402
from slamrs_tpu_torch.io import connection as tconn  # noqa: E402
from slamrs_tpu_torch.io import message as tmsg  # noqa: E402
from slamrs_tpu_torch.io import neato as tneato  # noqa: E402
from slamrs_tpu_torch.io import peripherals as tper  # noqa: E402
from slamrs_tpu_torch.io import pool as tpool  # noqa: E402
from slamrs_tpu_torch.io import virtual_robot as tvr  # noqa: E402
from slamrs_tpu_torch.models import simulator as tsim  # noqa: E402

ROBOT_RECTS = [(-2.0, -2.0, 4.0, 4.0), (-0.1, -0.4, 0.5, 0.1)]
ROBOT_LINES = [(-0.6, -0.4, 0.2, 0.4)]
DEADLINE_S = 10.0


def _wait(cond, deadline_s=DEADLINE_S) -> bool:
    end = time.monotonic() + deadline_s
    while not cond() and time.monotonic() < end:
        time.sleep(0.01)
    return cond()


# ---- the wire codec -------------------------------------------------------

COMMANDS = [("ping",), ("neato_on",), ("neato_off",),
            ("set_downsampling", 0), ("set_downsampling", 2),
            ("set_downsampling", 255), ("drive", 0.1, 0.12),
            ("drive", -0.25, 1e-40), ("drive", 3e38, -0.0),
            ("set_motor_pi_params", 0.5, 2.0),
            ("set_motor_pi_params", 0.75, 1.5)]


def _command(mod, spec):
    return getattr(mod.CommandMessage, spec[0])(*spec[1:])


def _decode_alike(jfn, tfn, buf):
    """Both decoders on ``buf``: the same result, or the same error."""
    try:
        want = jfn(buf)
    except Exception as e:  # noqa: BLE001 - the error type is compared
        with pytest.raises(type(e)):
            tfn(buf)
        return None
    got = tfn(buf)
    assert dataclasses.asdict(got[0]) == dataclasses.asdict(want[0])
    assert got[1] == want[1]
    return got


@pytest.mark.parametrize("spec", COMMANDS, ids=lambda s: "-".join(map(str, s)))
def test_command_codec_matches_jax(spec):
    raw = _command(tmsg, spec).encode()
    assert raw == _command(jmsg, spec).encode()
    got = _decode_alike(jmsg.CommandMessage.decode, tmsg.CommandMessage.decode,
                        raw)
    assert got[1] == len(raw)
    for k in range(len(raw)):  # every truncation raises alike
        _decode_alike(jmsg.CommandMessage.decode,
                      tmsg.CommandMessage.decode, raw[:k])
    wire = native.wire_native()
    assert wire is not None, native.build_error
    kind = tmsg.CommandMessage._VARIANTS.index(spec[0])
    m = _command(tmsg, spec)
    assert wire.encode_command(kind, m.every, m.left, m.right, m.kp,
                               m.ki) == raw


def _scan_message(mod, seed, rpm):
    rng = np.random.default_rng(seed)
    frame = mod.ScanFrame(rng.integers(0, 256, 1980, np.uint8).tobytes(),
                          tuple(float(np.float32(v))
                                for v in rng.normal(0, 0.05, 2)), rpm)
    return mod.RobotMessage.from_scan(frame)


@pytest.mark.parametrize("rpm", [0, 250, 251, 300, 0xFFFF])
def test_robot_message_codec_matches_jax(rpm):
    raw = _scan_message(tmsg, rpm, rpm).encode()
    assert raw == _scan_message(jmsg, rpm, rpm).encode()
    got = _decode_alike(jmsg.RobotMessage.decode, tmsg.RobotMessage.decode,
                        raw)
    assert got[1] == len(raw)
    for k in sorted({0, 1, 2, 100, 1980, 1981, 1988, 1989, len(raw) - 1}):
        _decode_alike(jmsg.RobotMessage.decode, tmsg.RobotMessage.decode,
                      raw[:k])
    pong = tmsg.RobotMessage.pong().encode()
    assert pong == jmsg.RobotMessage.pong().encode() == b"\x01"
    _decode_alike(jmsg.RobotMessage.decode, tmsg.RobotMessage.decode, pong)


@pytest.mark.parametrize("value", [0, 1, 250, 251, 0xFFFF, 0x10000,
                                   0xFFFFFFFF, 0x100000000, 2 ** 64 - 1])
def test_varint_boundaries_match_jax(value):
    raw = tmsg.encode_varint(value)
    assert raw == jmsg.encode_varint(value)
    assert tmsg.decode_varint(raw, 0) == jmsg.decode_varint(raw, 0) == (
        value, len(raw))
    for k in range(len(raw)):
        with pytest.raises(EOFError):
            tmsg.decode_varint(raw[:k], 0)
        with pytest.raises(EOFError):
            jmsg.decode_varint(raw[:k], 0)


@pytest.mark.parametrize("buf", [b"\x06", b"\xfe\x00", b"\x02" + bytes(2000),
                                 b"\xff", b"\xfb\x07\x00"])
def test_malformed_messages_raise_alike(buf):
    _decode_alike(jmsg.CommandMessage.decode, tmsg.CommandMessage.decode, buf)
    _decode_alike(jmsg.RobotMessage.decode, tmsg.RobotMessage.decode, buf)
    with pytest.raises(ValueError):
        tmsg.encode_varint(-1)


def _wire_stream(seed, n=200):
    """``n`` RobotMessages (ScanFrames and Pongs) with malformed bytes
    between some of them."""
    rng = np.random.default_rng(seed)
    parts = []
    for i in range(n):
        if rng.random() < 0.2:
            parts.append(tmsg.RobotMessage.pong().encode())
        else:
            rpm = int(rng.choice([0, 300, 251, 0xFFFF]))  # rpm is a u16
            parts.append(_scan_message(tmsg, seed * 1000 + i, rpm).encode())
        if rng.random() < 0.1:  # a malformed discriminant or varint marker
            parts.append(bytes([int(rng.choice([2, 7, 200, 251, 254]))]))
    return b"".join(parts)


def _drain_all(stream, cuts, use_native, monkeypatch):
    """The port's ``RobotLink._drain`` over ``stream`` fed in pieces cut at
    ``cuts``; returns the frames handed to ``on_scan`` (odometry as its
    bytes: a resync can read NaNs) and what is left."""
    got = []
    link = tconn.RobotLink.__new__(tconn.RobotLink)
    link._buf = bytearray()
    link.on_scan = lambda s, o, r: got.append((s, struct.pack("<ff", *o), r))
    if not use_native:
        monkeypatch.setattr(native, "wire_native", lambda: None)
    for a, b in zip((0, *cuts), (*cuts, len(stream))):
        link._buf.extend(stream[a:b])
        link._drain()
    monkeypatch.undo()
    return got, bytes(link._buf)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_native_wire_codec_matches_python_drain(seed, monkeypatch):
    stream = _wire_stream(seed)
    rng = np.random.default_rng(seed + 10)
    cuts = sorted(rng.choice(len(stream), 40, replace=False).tolist())
    py, py_left = _drain_all(stream, cuts, False, monkeypatch)
    nat, nat_left = _drain_all(stream, cuts, True, monkeypatch)
    assert len(py) > 100 and py == nat and py_left == nat_left
    # the JAX package's python decoder on the whole stream agrees
    jax_frames, buf = [], stream
    while True:
        try:
            m, used = jmsg.RobotMessage.decode(buf)
        except EOFError:
            break
        except ValueError:
            buf = buf[1:]
            continue
        buf = buf[used:]
        if m.kind == "scan_frame":
            f = m.scan_frame
            jax_frames.append((f.scan_data, struct.pack("<ff", *f.odometry),
                               f.rpm))
    assert jax_frames == py


# ---- the Neato codec -------------------------------------------------------

def _frame_arrays(seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 0x4000, 360).astype(np.uint16),
            rng.integers(0, 0x10000, 360).astype(np.uint16),
            rng.random(360) < 0.8)


def _frames_equal(a, b):
    assert len(a) == len(b)
    for fa, fb in zip(a, b):
        for name in ("distance", "strength", "valid"):
            x, y = getattr(fa, name), getattr(fb, name)
            assert x.dtype == y.dtype and np.array_equal(x, y), name


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_encode_and_parse_frame_match_jax(seed):
    d, s, v = _frame_arrays(seed)
    raw = tneato.encode_frame(d, s, v, rpm=287.5)
    assert raw == jneato.encode_frame(d, s, v, rpm=287.5)
    frame = tneato.parse_frame(raw)
    _frames_equal([frame], [jneato.parse_frame(raw)])
    assert np.array_equal(frame.distance, d) and np.array_equal(
        frame.valid != 0, v)
    nat = native.neato_native()
    assert nat is not None, native.build_error
    _frames_equal([nat.parse_frame(raw)], [frame])
    junk = np.random.default_rng(seed).integers(0, 256, 1980,
                                                np.uint8).tobytes()
    _frames_equal([tneato.parse_frame(junk), nat.parse_frame(junk)],
                  [jneato.parse_frame(junk)] * 2)
    ta, ja = tneato.NeatoFrame(d, s, v).to_scan_arrays(), \
        jneato.NeatoFrame(d, s, v).to_scan_arrays()
    for x, y in zip(ta, ja):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    with pytest.raises(ValueError):
        tneato.parse_frame(raw[:-1])


def _forged_stream(seed):
    """Revolutions with garbage between packets, bad checksums, cut
    packets, stray start bytes and index wraps, ending in an unclosed
    revolution."""
    rng = np.random.default_rng(seed)
    out = bytearray()
    for rev in range(6):
        raw = bytearray(tneato.encode_frame(*_frame_arrays(seed * 10 + rev)))
        packets = [raw[i * 22:(i + 1) * 22] for i in range(90)]
        if rev == 3:
            packets = packets[:50]  # a short revolution: an early wrap
        for k, p in enumerate(packets):
            r = rng.random()
            if r < 0.05:
                p[20] ^= 0x5A  # bad checksum
            elif r < 0.08:
                p = p[:int(rng.integers(1, 21))]  # a cut packet
            elif r < 0.12:
                out += bytes([0xFA]) + rng.integers(
                    0, 256, int(rng.integers(0, 30)), np.uint8).tobytes()
            elif r < 0.15:
                p[1] = 0x10  # index below the base
            out += p
    return bytes(out)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_parse_packets_matches_jax(seed):
    stream = _forged_stream(seed)
    py = tneato._parse_packets_py(stream)
    assert len(py) >= 5  # the unclosed last revolution is dropped
    _frames_equal(py, jneato._parse_packets_py(stream))
    nat = native.neato_native()
    assert nat is not None, native.build_error
    _frames_equal(nat.parse_packets(stream), py)
    _frames_equal(tneato.parse_packets(stream), py)
    for k in (0, 21, 22, 23, 1000):  # prefixes, partial packets included
        _frames_equal(nat.parse_packets(stream[:k]),
                      tneato._parse_packets_py(stream[:k]))


def test_load_neato_binary_drops_the_unclosed_revolution(tmp_path):
    revs = [tneato.encode_frame(*_frame_arrays(i)) for i in range(5)]
    path = tmp_path / "log.bin"
    path.write_bytes(b"".join(revs))
    frames = tneato.load_neato_binary(path)
    assert len(frames) == 4
    _frames_equal(frames, jneato.load_neato_binary(path))


def test_native_build_goes_under_build_and_records_failure(monkeypatch):
    assert native.neato_native() is not None and native.build_error is None
    assert native.LIB.is_file() and native.LIB.parent.parts[-3:] == (
        "build", "slamrs_tpu_torch", "native")
    assert not list(native.SOURCES[0].parent.glob("*.so"))
    monkeypatch.setattr(native, "build_error", None)  # restored after
    monkeypatch.setattr(native, "_LOADED", {})
    monkeypatch.setattr(native, "build",
                        lambda force=False: (_ for _ in ()).throw(
                            RuntimeError("g++ failed with 1")))
    assert native.neato_native() is None
    assert "g++ failed" in native.build_error
    stream = _forged_stream(0)
    _frames_equal(tneato.parse_packets(stream),  # the python path
                  jneato._parse_packets_py(stream))


# ---- the buffer pool, the AT parser, the peripherals ------------------------

def _pool_trace(mod):
    out = []
    pool = mod.BufferPool(8, 3)
    a, b, c = pool.acquire(), pool.acquire(), pool.acquire()
    out += [pool.acquire() is None, pool.free_count()]
    a.data[:3] = b"abc"
    sa = a.shared()
    sb = sa.clone()
    out += [sa.data, sb.data, pool.free_count()]
    sa.release()
    out.append(pool.free_count())
    sb.release()
    b.release()
    out.append(pool.free_count())
    d = pool.acquire()
    out += [bytes(d.data), pool.free_count()]
    del c, d
    out.append(pool.free_count())
    for x in (0, 7, 10, 12345, 2 ** 40):
        buf = bytearray(16)
        n = mod.format_base_10(x, buf)
        out.append(bytes(buf[:n]))
    for call in (lambda: mod.format_base_10(123, bytearray(2)),
                 lambda: mod.format_base_10(-1, bytearray(4))):
        with pytest.raises(ValueError) as e:
            call()
        out.append(str(e.value))
    out += [e.value for e in mod.EventKind]
    out.append(mod.Event(mod.EventKind.COMMAND, "x").command)
    return out


def test_pool_matches_jax():
    assert _pool_trace(tpool) == _pool_trace(jpool)


AT_STREAM = (b"garbage\r\nready\r\nWIFI CONNECTED\r\nWIFI GOT IP\r\n"
             b"OK\r\n0,CONNECT\r\n+IPD,0,5:hello+IPD,0,0:+IPD,1,3:\x00\n\x01"
             b"SEND OK\r\nERROR\r\n+IPD,x,2:\r\n\r\n0,CLOSED\r\nbusy p...\r\n"
             + bytes(range(256)) + b"\r\n")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_at_parser_matches_jax(seed):
    rng = np.random.default_rng(seed)
    cuts = sorted(rng.choice(len(AT_STREAM), 25, replace=False).tolist())
    out = []
    for mod in (tat, jat):
        parser = mod.AtParser(capacity=64)
        msgs = []
        for a, b in zip((0, *cuts), (*cuts, len(AT_STREAM))):
            msgs += [dataclasses.astuple(m)
                     for m in parser.consume(AT_STREAM[a:b])]
        out.append(msgs)
    assert out[0] == out[1] and len(out[0]) >= 12


def _peripherals_trace(mod, seed):
    rng = np.random.default_rng(seed)
    out = []
    hb = mod.Heartbeat()
    for status in (mod.LedStatus.off(), mod.LedStatus.on("cyan"),
                   mod.LedStatus.blinking("red", "fast"),
                   mod.LedStatus.blinking("blue", "medium"),
                   mod.LedStatus.blinking("green", "slow")):
        hb.set_status(status)
        out += [hb.tick() for _ in range(23)]
    quad = mod.QuadratureDecoder()
    for a, b in rng.integers(0, 2, (500, 2)):
        quad.sample(int(a), int(b))
    out += [quad.count, quad.signed]
    pca = mod.Pca9685()
    driver = mod.MotorDriver(pca, frequency_hz=1000.0)
    motors = [driver.motor(i) for i in range(4)]
    with pytest.raises(ValueError):
        driver.motor(2)
    for speed in rng.integers(-4095, 4096, 40):
        m = motors[int(rng.integers(0, 4))]
        m.set_speed_signed(int(speed))
        out.append(m.signed_speed)
    motors[1].set_direction("brake")
    out += [motors[1].signed_speed, pca.prescale, pca.channels, pca.writes]
    events = []
    esp = mod.EspAtBridge(on_event=events.append)
    for chunk in (b"ready\r\n", b"WIFI GOT IP\r\n", b"0,CONNECT\r\n",
                  b"+IPD,0,3:abc", b"0,CLOSED\r\n"):
        out += [[dataclasses.astuple(m) for m in esp.feed(chunk)],
                esp.state, esp.is_connected, esp.led.status]
    out += [esp.sent, events]
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_peripherals_match_jax(seed):
    got, want = _peripherals_trace(tper, seed), _peripherals_trace(jper, seed)
    assert [dataclasses.astuple(x) if dataclasses.is_dataclass(x) else x
            for x in got] == [dataclasses.astuple(x)
                              if dataclasses.is_dataclass(x) else x
                              for x in want]


# ---- the virtual robot -----------------------------------------------------

def _robot_state(r):
    """Every piece of the firmware model's state, as plain values."""
    return (r.pose.tolist(), r.connected, r.neato_on, r.downsampling,
            r.target_left, r.target_right, r.enc_left, r.enc_right,
            r._pi_l.x_integral, r._pi_l.sat, r._pi_r.x_integral, r._pi_r.sat,
            r._est_l.last, r._est_r.last, r._speed_l, r._speed_r,
            r._last_odo_l, r._last_odo_r, r._downsample_counter,
            r._rpm_accumulator, r._rpm_average, r._t, r._next_control,
            r._next_rev, r._next_pong, r.kp, r.ki, r.led.rgb,
            r.led._counter, dataclasses.astuple(r.led.status),
            r.pca.channels, len(r.pca.writes))


SCRIPT = [(0.0, "neato_on"), (0.0, "set_downsampling", 0),
          (0.0, "drive", 0.10, 0.12), (2.0, "set_motor_pi_params", 0.75, 1.5),
          (3.0, "drive", -0.05, 0.15), (4.0, "set_downsampling", 2),
          (5.0, "neato_off"), (5.5, "ping"), (5.6, "neato_on"),
          (6.0, "drive", 0.0004, 0.0004)]


def _run_robots(scene, seconds=7.0, dt=0.05):
    """The same command script on the JAX model and the port's (CPU),
    the states compared after every step; returns both outboxes."""
    if scene:
        jr = jvr.VirtualRobot(scene=jsim.Scene.build(rects=ROBOT_RECTS,
                                                     lines=ROBOT_LINES),
                              scanner_range=5.0)
        tr = tvr.VirtualRobot(scene=tsim.Scene.build(rects=ROBOT_RECTS,
                                                     lines=ROBOT_LINES),
                              scanner_range=5.0, device="cpu")
    else:
        jr, tr = jvr.VirtualRobot(), tvr.VirtualRobot(device="cpu")
    for r in (jr, tr):
        r.pose = np.array([-1.0, -1.2, 0.0])
        r.connect()
    script = list(SCRIPT)
    for step in range(int(round(seconds / dt))):
        while script and script[0][0] <= step * dt:
            _, kind, *args = script.pop(0)
            jr.handle_command(getattr(jmsg.CommandMessage, kind)(*args))
            tr.handle_command(getattr(tmsg.CommandMessage, kind)(*args))
        jr.step(dt)
        tr.step(dt)
        assert _robot_state(tr) == _robot_state(jr), step
    tr.disconnect()
    jr.disconnect()
    assert _robot_state(tr) == _robot_state(jr)
    return jr.outbox, tr.outbox


def _outboxes_alike(jout, tout):
    """Equal bytes but for the scan distances: those within 1 mm on fewer
    than 1e-3 of the beams.  Returns the count of scan frames."""
    assert len(tout) == len(jout)
    frames = beams = off = 0
    for a, b in zip(jout, tout):
        assert a[:1] == b[:1]
        if a[:1] != b"\x00":
            assert a == b
            continue
        assert len(a) == len(b) and a[1981:] == b[1981:]  # odometry, rpm
        fa, fb = jneato.parse_frame(a[1:1981]), tneato.parse_frame(b[1:1981])
        assert np.array_equal(fa.valid, fb.valid)
        assert np.array_equal(fa.strength, fb.strength)
        d = np.abs(fa.distance.astype(int) - fb.distance.astype(int))
        assert d.max() <= 1
        frames += 1
        beams += d.size
        off += int((d > 0).sum())
    assert off < 1e-3 * max(beams, 1)
    return frames


@pytest.mark.parametrize("scene", [False, True], ids=["no_scene", "scene"])
def test_virtual_robot_matches_jax(scene):
    jout, tout = _run_robots(scene)
    frames = _outboxes_alike(jout, tout)
    assert frames >= 20
    if not scene:
        assert tout == jout


def test_virtual_robot_needs_cuda_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tvr.VirtualRobot()
    scene = tsim.Scene.build(rects=ROBOT_RECTS)
    r = tvr.VirtualRobot(scene=scene, device="cpu")
    assert r.scene.segments.device.type == "cpu"


# ---- links and servers -----------------------------------------------------

class SockMedium(tconn.ConnectionMedium):
    def __init__(self, sock):
        self.sock = sock
        sock.settimeout(0.05)

    def read(self, n):
        try:
            data = self.sock.recv(n)
        except socket.timeout:
            return b""
        except OSError:
            return None
        return data if data else None

    def write(self, data):
        self.sock.sendall(data)

    def close(self):
        try:
            self.sock.close()
        except OSError:
            pass


def test_robot_link_against_virtual_robot_server():
    """Handshake, streaming, drive forwarding and a clean end of stream
    over a socketpair, the port on both ends."""
    a, b = socket.socketpair()
    robot = tvr.VirtualRobot(scene=tsim.Scene.build(rects=ROBOT_RECTS,
                                                    lines=ROBOT_LINES),
                             scanner_range=5.0, device="cpu")
    server = tvr.VirtualRobotServer(robot, SockMedium(b))
    link = None
    got = []
    try:
        link = tconn.RobotLink(SockMedium(a),
                               lambda s, o, r: got.append((s, o, r)),
                               downsampling=1)
        assert _wait(lambda: robot.neato_on and robot.downsampling == 1)
        link.drive(0.25, 0.25)
        assert _wait(lambda: robot.target_left > 0)
        assert robot.target_left == int(np.float32(0.25)
                                        * tvr.MOTOR_STEPS_PER_METER)
        assert _wait(lambda: len(got) >= 3)
        scan, odo, rpm = got[-1]
        frame = tneato.parse_frame(scan)
        d = frame.distance[frame.valid != 0] / 1000.0
        assert d.size > 300 and d.max() < 3.0 and 0 < rpm <= 300
        assert all(isinstance(v, float) for v in odo)
        assert _wait(lambda: robot.pose[0] > -0.95)
        # the robot side closes: the link's reader sees the end of stream
        server.close()
        assert _wait(lambda: not link.alive)
    finally:
        if link is not None:
            link.close()
        server.close()
        a.close()
        b.close()


def test_usb_cdc_session():
    """The pty session: connect on the first host bytes, frames stream,
    commands reach the model, disconnect on close, a second session."""
    robot = tvr.VirtualRobot(device="cpu")  # canned 1,500 mm scan
    server = tvr.UsbCdcServer(robot, realtime=False)
    links = []
    try:
        assert not robot.connected
        got = []
        links.append(tconn.RobotLink(tconn.SerialMedium(server.path),
                                     lambda s, o, r: got.append(s),
                                     downsampling=3))
        assert _wait(lambda: robot.connected and robot.downsampling == 3)
        assert _wait(lambda: len(got) >= 2)
        assert (tneato.parse_frame(got[0]).distance == 1500).all()
        links[0].set_motor_pi_params(0.9, 1.1)
        assert _wait(lambda: (robot.kp, robot.ki) == (
            float(np.float32(0.9)), float(np.float32(1.1))))
        links.pop().close()
        assert _wait(lambda: not robot.connected)
        again = []
        links.append(tconn.RobotLink(tconn.SerialMedium(server.path),
                                     lambda s, o, r: again.append(1)))
        assert _wait(lambda: robot.connected and len(again) >= 1)
    finally:
        for link in links:
            link.close()
        server.close()


def test_open_medium_picks_serial_or_tcp():
    master, slave = os.openpty()
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    mediums = []
    try:
        mediums.append(tconn.open_medium(os.ttyname(slave)))
        assert isinstance(mediums[-1], tconn.SerialMedium)
        srv.bind(("127.0.0.1", 0))
        srv.listen(1)
        port = srv.getsockname()[1]
        mediums.append(tconn.open_medium(f"127.0.0.1:{port}", timeout=0.05))
        assert isinstance(mediums[-1], tconn.TcpMedium)
        conn, _ = srv.accept()
        mediums[-1].write(b"\x01\x02")
        assert conn.recv(2) == b"\x01\x02"
        assert mediums[-1].read(16) == b""  # a timeout, not the end
        conn.close()
        assert _wait(lambda: mediums[-1].read(16) is None, 2.0)
    finally:
        for m in mediums:
            m.close()
        srv.close()
        os.close(master)
        os.close(slave)


def test_wire_floats_round_to_f32_as_in_jax():
    for mod in (tmsg, jmsg):
        raw = mod.CommandMessage.drive(0.1, 0.2).encode()
        m, _ = mod.CommandMessage.decode(raw)
        assert (m.left, m.right) == struct.unpack("<ff", struct.pack(
            "<ff", 0.1, 0.2))
