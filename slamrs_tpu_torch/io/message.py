"""Host <-> robot wire protocol: bincode-v2-standard compatible codec.

A copy of ``slamrs_tpu/io/message.py`` (the port imports nothing of the
JAX package); the tests hold the two byte for byte.

Parity surface: ``slamrs-message/src/lib.rs`` — ``CommandMessage``
(Ping/NeatoOn/NeatoOff/SetDownsampling{every:u8}/Drive{left,right:f32}/
SetMotorPiParams{kp,ki:f32}, lib.rs:10-26) and ``RobotMessage``
(ScanFrame{scan_data:[u8;1980], odometry:[f32;2], rpm:u16} | Pong,
lib.rs:30-41), encoded with ``bincode::config::standard()`` as used at
neato/src/connection.rs:252-298 and firmware tasks/esp.rs:86.

bincode 2 "standard" wire format implemented here:

* enum discriminant: u32, varint-encoded;
* unsigned varint: < 251 one byte; 251 + u16 LE; 252 + u32 LE; 253 + u64 LE;
* ``u8``: always a single raw byte (never varint);
* ``f32``: 4 bytes LE;
* fixed-size arrays: elements back-to-back, no length prefix.

This keeps recorded logs and the real-robot TCP/serial link compatible
with both the reference host app and the RP2040 firmware.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Optional

import numpy as np

SCAN_DATA_BYTES = 1980


# ---- varint ---------------------------------------------------------------

def encode_varint(value: int) -> bytes:
    if value < 0:
        raise ValueError("unsigned only")
    if value < 251:
        return bytes([value])
    if value <= 0xFFFF:
        return b"\xfb" + struct.pack("<H", value)
    if value <= 0xFFFFFFFF:
        return b"\xfc" + struct.pack("<I", value)
    return b"\xfd" + struct.pack("<Q", value)


def decode_varint(buf: bytes, pos: int) -> tuple[int, int]:
    if pos >= len(buf):
        raise EOFError("short buffer")
    b = buf[pos]
    if b < 251:
        return b, pos + 1
    need = {251: 3, 252: 5, 253: 9}.get(b)
    if need is None:
        raise ValueError(f"unsupported varint marker {b}")
    if pos + need > len(buf):
        # a partial multi-byte varint at a stream read boundary must read
        # as "need more bytes", not kill the drain thread (struct.error)
        raise EOFError("short buffer")
    if b == 251:
        return struct.unpack_from("<H", buf, pos + 1)[0], pos + 3
    if b == 252:
        return struct.unpack_from("<I", buf, pos + 1)[0], pos + 5
    return struct.unpack_from("<Q", buf, pos + 1)[0], pos + 9


# ---- messages -------------------------------------------------------------

@dataclasses.dataclass
class CommandMessage:
    """lib.rs:10-26.  kind in {ping, neato_on, neato_off, set_downsampling,
    drive, set_motor_pi_params}."""

    kind: str
    every: int = 0
    left: float = 0.0
    right: float = 0.0
    kp: float = 0.0
    ki: float = 0.0

    _VARIANTS = ("ping", "neato_on", "neato_off", "set_downsampling",
                 "drive", "set_motor_pi_params")

    @staticmethod
    def ping() -> "CommandMessage":
        return CommandMessage("ping")

    @staticmethod
    def neato_on() -> "CommandMessage":
        return CommandMessage("neato_on")

    @staticmethod
    def neato_off() -> "CommandMessage":
        return CommandMessage("neato_off")

    @staticmethod
    def set_downsampling(every: int) -> "CommandMessage":
        return CommandMessage("set_downsampling", every=every)

    @staticmethod
    def drive(left: float, right: float) -> "CommandMessage":
        return CommandMessage("drive", left=left, right=right)

    @staticmethod
    def set_motor_pi_params(kp: float, ki: float) -> "CommandMessage":
        return CommandMessage("set_motor_pi_params", kp=kp, ki=ki)

    def encode(self) -> bytes:
        disc = self._VARIANTS.index(self.kind)
        out = encode_varint(disc)
        if self.kind == "set_downsampling":
            out += bytes([self.every & 0xFF])
        elif self.kind == "drive":
            out += struct.pack("<ff", self.left, self.right)
        elif self.kind == "set_motor_pi_params":
            out += struct.pack("<ff", self.kp, self.ki)
        return out

    @staticmethod
    def decode(buf: bytes, pos: int = 0) -> tuple["CommandMessage", int]:
        disc, pos = decode_varint(buf, pos)
        if disc >= len(CommandMessage._VARIANTS):
            # malformed discriminant -> resync-able error, not IndexError
            raise ValueError(f"unknown CommandMessage variant {disc}")
        kind = CommandMessage._VARIANTS[disc]
        msg = CommandMessage(kind)
        if kind == "set_downsampling":
            if pos >= len(buf):
                raise EOFError("short buffer")
            msg.every = buf[pos]
            pos += 1
        elif kind == "drive":
            if pos + 8 > len(buf):
                raise EOFError("short buffer")
            msg.left, msg.right = struct.unpack_from("<ff", buf, pos)
            pos += 8
        elif kind == "set_motor_pi_params":
            if pos + 8 > len(buf):
                raise EOFError("short buffer")
            msg.kp, msg.ki = struct.unpack_from("<ff", buf, pos)
            pos += 8
        return msg, pos


@dataclasses.dataclass
class ScanFrame:
    """lib.rs:37-41."""

    scan_data: bytes  # 1980 raw Neato bytes
    odometry: tuple[float, float]  # meters (left, right) since last frame
    rpm: int

    def __post_init__(self):
        if len(self.scan_data) != SCAN_DATA_BYTES:
            raise ValueError(f"scan_data must be {SCAN_DATA_BYTES} bytes")


@dataclasses.dataclass
class RobotMessage:
    """lib.rs:30-35.  kind in {scan_frame, pong}."""

    kind: str
    scan_frame: Optional[ScanFrame] = None

    @staticmethod
    def pong() -> "RobotMessage":
        return RobotMessage("pong")

    @staticmethod
    def from_scan(frame: ScanFrame) -> "RobotMessage":
        return RobotMessage("scan_frame", frame)

    def encode(self) -> bytes:
        if self.kind == "scan_frame":
            f = self.scan_frame
            return (encode_varint(0) + bytes(f.scan_data)
                    + struct.pack("<ff", *f.odometry) + encode_varint(f.rpm))
        if self.kind == "pong":
            return encode_varint(1)
        raise ValueError(self.kind)

    @staticmethod
    def decode(buf: bytes, pos: int = 0) -> tuple["RobotMessage", int]:
        disc, pos = decode_varint(buf, pos)
        if disc == 1:
            return RobotMessage.pong(), pos
        if disc != 0:
            raise ValueError(f"unknown RobotMessage variant {disc}")
        if len(buf) - pos < SCAN_DATA_BYTES + 8 + 1:
            raise EOFError("short buffer")  # rpm varint checked in decode
        scan = bytes(buf[pos:pos + SCAN_DATA_BYTES])
        pos += SCAN_DATA_BYTES
        odo = struct.unpack_from("<ff", buf, pos)
        pos += 8
        rpm, pos = decode_varint(buf, pos)
        return RobotMessage.from_scan(ScanFrame(scan, odo, rpm)), pos
