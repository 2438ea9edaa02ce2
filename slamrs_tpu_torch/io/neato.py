"""Neato XV11 lidar protocol: packet/frame parsing and .bin log replay.

A copy of ``slamrs_tpu/io/neato.py`` (the port imports nothing of the JAX
package) over the port's own native library.  The results stay numpy:
the nodes of ``graph/nodes/robot.py`` turn them into tensors.

Parity surface: ``slamrs/neato/src/frame.rs`` —

* 22-byte packets: 0xFA start, index byte (0xA0..0xF9 -> packet 0..89),
  u16 LE motor speed, four 4-byte readings (14-bit distance in mm, valid
  bit = !(b1 & 0x80), strength-warning bit, u16 LE strength), u16 LE
  checksum over the first 20 bytes (frame.rs:74-122);
* a revolution = 90 packets * 4 readings = 360 beams (frame.rs:30-72);
* ``parse_frame``: a 1980-byte buffer laid out as 90 consecutive packets
  (frame.rs:124-134; bad packets leave zeroed lanes, checksum NOT enforced
  on this path — kept);
* ``parse_packets``: byte-stream re-sync scanning for 0xFA, checksum-gated
  insertion, revolution split on index wrap-around, and the reference's
  1-byte (not 22) advance after each packet (frame.rs:136-201 — kept
  verbatim: it is what makes re-sync robust);
* mm -> m conversion and per-degree radians in the Observation conversion
  (frame.rs:212-230).

The hot path (parse a 1980-byte frame to arrays) is vectorized numpy; a
native C++ parser (``slamrs_tpu_torch/native``) accelerates bulk .bin
replay and is used when it builds — both produce identical arrays.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np

PACKET_BYTES = 22
PACKETS_PER_REV = 90
BEAMS = 360
FRAME_BYTES = PACKET_BYTES * PACKETS_PER_REV  # 1980
INDEX_BASE = 0xA0
START_BYTE = 0xFA


@dataclass
class NeatoFrame:
    """Parity: NeatoFrame (frame.rs:8-12)."""

    distance: np.ndarray  # u16[360] mm
    strength: np.ndarray  # u16[360]
    valid: np.ndarray  # u8[360]

    def to_scan_arrays(self):
        """Observation conversion (frame.rs:212-230): per-degree radians,
        mm -> m.  Returns (angles, distances, strengths, valid, present)."""
        angles = np.deg2rad(np.arange(BEAMS, dtype=np.float32))
        return (
            angles,
            self.distance.astype(np.float32) / 1000.0,
            self.strength.astype(np.float32),
            self.valid != 0,
            np.ones(BEAMS, bool),
        )


def checksum_valid(packets: np.ndarray) -> np.ndarray:
    """Vectorized checksum over packets u8[N, 22] (frame.rs:85-106)."""
    p = packets.astype(np.uint32)
    words = p[:, 0:20:2] | (p[:, 1:20:2] << 8)  # u16 LE words [N, 10]
    chk32 = np.zeros(len(p), np.uint32)
    for i in range(10):
        chk32 = (chk32 << 1) + words[:, i]
    checksum = (chk32 & 0x7FFF) + (chk32 >> 15)
    checksum = checksum & 0x7FFF
    stored = p[:, 20] | (p[:, 21] << 8)
    return checksum == stored


def _decode_packets(packets: np.ndarray):
    """u8[N, 22] -> (index u8[N], speed u16[N], distance u16[N,4],
    strength u16[N,4], valid bool[N,4]) per parse_packet/parse_data
    (frame.rs:74-122)."""
    p = packets.astype(np.uint16)
    index = packets[:, 1]
    speed = p[:, 2] | (p[:, 3] << 8)
    base = 4 + 4 * np.arange(4)  # reading offsets
    b0 = p[:, base]
    b1 = p[:, base + 1]
    b2 = p[:, base + 2]
    b3 = p[:, base + 3]
    distance = b0 | ((b1 & 0x3F) << 8)
    strength = (b3 << 8) | b2
    valid = (b1 & 0x80) == 0
    return index, speed, distance, strength, valid


def parse_frame(buf: bytes | np.ndarray) -> NeatoFrame:
    """Parse one 1980-byte frame of 90 consecutive packets (frame.rs:124-134)."""
    arr = np.frombuffer(bytes(buf), np.uint8)
    if arr.size != FRAME_BYTES:
        raise ValueError(f"frame must be {FRAME_BYTES} bytes, got {arr.size}")
    packets = arr.reshape(PACKETS_PER_REV, PACKET_BYTES)
    _, _, dist, strength, valid = _decode_packets(packets)
    return NeatoFrame(
        distance=dist.reshape(BEAMS).astype(np.uint16),
        strength=strength.reshape(BEAMS).astype(np.uint16),
        valid=valid.reshape(BEAMS).astype(np.uint8),
    )


def encode_frame(distance_mm: np.ndarray, strength: np.ndarray,
                 valid: np.ndarray, rpm: float = 300.0) -> bytes:
    """Inverse of :func:`parse_frame`: build a 1980-byte revolution from
    per-beam arrays (the firmware-side wire format, frame.rs:74-134 read
    backwards).  Used by the virtual robot and for parser round-trip
    tests.

    distance_mm u16[360], strength u16[360], valid bool[360]; ``rpm`` is
    stored as the XV11 raw speed field (rpm * 64) in every packet.
    """
    distance_mm = np.asarray(distance_mm, np.uint16).reshape(
        PACKETS_PER_REV, 4)
    strength = np.asarray(strength, np.uint16).reshape(PACKETS_PER_REV, 4)
    valid = np.asarray(valid, bool).reshape(PACKETS_PER_REV, 4)

    pkts = np.zeros((PACKETS_PER_REV, PACKET_BYTES), np.uint8)
    pkts[:, 0] = START_BYTE
    pkts[:, 1] = INDEX_BASE + np.arange(PACKETS_PER_REV)
    speed_raw = int(round(rpm * 64.0)) & 0xFFFF
    pkts[:, 2] = speed_raw & 0xFF
    pkts[:, 3] = speed_raw >> 8
    base = 4 + 4 * np.arange(4)
    d = distance_mm & 0x3FFF
    pkts[:, base] = (d & 0xFF).astype(np.uint8)
    hi = ((d >> 8) & 0x3F).astype(np.uint8)
    hi = hi | np.where(valid, 0, 0x80).astype(np.uint8)  # invalid flag
    pkts[:, base + 1] = hi
    pkts[:, base + 2] = (strength & 0xFF).astype(np.uint8)
    pkts[:, base + 3] = (strength >> 8).astype(np.uint8)

    # checksum over the first 20 bytes (frame.rs:85-106)
    p = pkts.astype(np.uint32)
    words = p[:, 0:20:2] | (p[:, 1:20:2] << 8)
    chk32 = np.zeros(PACKETS_PER_REV, np.uint32)
    for i in range(10):
        chk32 = (chk32 << 1) + words[:, i]
    checksum = ((chk32 & 0x7FFF) + (chk32 >> 15)) & 0x7FFF
    pkts[:, 20] = (checksum & 0xFF).astype(np.uint8)
    pkts[:, 21] = (checksum >> 8).astype(np.uint8)
    return pkts.tobytes()


def parse_packets(data: bytes) -> list[NeatoFrame]:
    """Stream re-sync parser (frame.rs:136-201).

    Scans byte-by-byte for 0xFA; checksum-gated; emits a frame whenever the
    packet index wraps below the previous one.  Uses the native C++ parser
    when available, else the numpy/python path.
    """
    native = _native()
    if native is not None:
        return native.parse_packets(data)
    return _parse_packets_py(data)


def _parse_packets_py(data: bytes) -> list[NeatoFrame]:
    buf = np.frombuffer(data, np.uint8)
    # candidate packet start offsets (any 0xFA with 22 bytes remaining)
    starts = np.flatnonzero(buf[: max(len(buf) - PACKET_BYTES + 1, 0)]
                            == START_BYTE)
    if len(starts) == 0:
        return []
    windows = buf[starts[:, None] + np.arange(PACKET_BYTES)]
    ok = checksum_valid(windows)
    index_raw = windows[:, 1].astype(np.int32)
    ok &= index_raw >= INDEX_BASE  # checked_sub underflow skip (frame.rs:176)
    index = index_raw - INDEX_BASE
    ok &= index < PACKETS_PER_REV

    # NOTE: the reference advances i by 1 even after a valid packet, so
    # overlapping later 0xFA bytes inside a consumed packet are also
    # examined; with the checksum gate this almost never yields a second
    # valid packet, and scanning all candidates replicates it exactly.
    frames: list[NeatoFrame] = []
    dist = np.zeros(BEAMS, np.uint16)
    stren = np.zeros(BEAMS, np.uint16)
    val = np.zeros(BEAMS, np.uint8)
    last_index = 0
    _, _, d4, s4, v4 = _decode_packets(windows)
    for k in np.flatnonzero(ok):
        idx = int(index[k])
        if idx < last_index:
            frames.append(NeatoFrame(dist.copy(), stren.copy(), val.copy()))
            dist[:] = 0
            stren[:] = 0
            val[:] = 0
        sl = slice(idx * 4, idx * 4 + 4)
        dist[sl] = d4[k]
        stren[sl] = s4[k]
        val[sl] = v4[k]
        last_index = idx
    return frames


def load_neato_binary(path: str | Path) -> list[NeatoFrame]:
    """Parity: load_neato_binary (frame.rs:203-210)."""
    return parse_packets(Path(path).read_bytes())


def _native():
    from slamrs_tpu_torch.native import neato_native

    return neato_native()
