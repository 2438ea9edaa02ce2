"""Fixed-capacity zero-copy buffer pool + link events.

A copy of ``slamrs_tpu/io/pool.py`` (the port imports nothing of the JAX
package).

Parity surface: ``slamrs-robot-rtic/library/src/{pool,event,util}.rs`` —
the firmware side's allocation-free frame plumbing, reproduced host-side
for the robot-link data plane (a 1980-byte lidar frame is acquired once
from the pool, filled from the socket/serial read, and shared by
reference with every consumer; no per-frame allocation in the hot loop):

* ``BufferPool<N, M>``: M fixed N-byte buffers with an atomic borrow
  count per slot (pool.rs:9-46).  ``acquire`` returns an
  :class:`OwnedBuffer` (exclusive, writable) or ``None`` when exhausted.
* ``OwnedBuffer.shared()`` converts to a read-only :class:`SharedBuffer`
  that can be cloned; the slot returns to the pool when every reference
  is dropped/released (pool.rs:48-135).
* ``Event``: Connected / Disconnected / Command link events
  (event.rs:1-8) — published by the robot link thread.
* ``format_base_10``: int -> ASCII into a caller buffer (util.rs:7-30),
  kept for wire-protocol tooling parity.

CPython's GIL plus an explicit lock around the borrow table gives the
same guarantees the firmware gets from its atomics.
"""

from __future__ import annotations

import dataclasses
import enum
import threading
from typing import Optional


class BufferPool:
    """M fixed-size N-byte buffers with per-slot borrow counts."""

    def __init__(self, n: int, m: int):
        self.n = n
        self._buffers = [bytearray(n) for _ in range(m)]
        self._borrows = [0] * m
        self._lock = threading.Lock()

    def acquire(self) -> Optional["OwnedBuffer"]:
        """First free slot -> OwnedBuffer, else None (pool.rs:27-46)."""
        with self._lock:
            for i, b in enumerate(self._borrows):
                if b == 0:
                    self._borrows[i] = 1
                    return OwnedBuffer(self, i)
        return None

    def free_count(self) -> int:
        with self._lock:
            return sum(1 for b in self._borrows if b == 0)

    # internal
    def _add(self, i: int, delta: int) -> None:
        with self._lock:
            self._borrows[i] += delta
            assert self._borrows[i] >= 0


class OwnedBuffer:
    """Exclusive writable view of a pool slot (pool.rs:48-75)."""

    def __init__(self, pool: BufferPool, index: int):
        self._pool = pool
        self._index = index
        self._live = True

    @property
    def data(self) -> bytearray:
        assert self._live, "buffer already released/shared"
        return self._pool._buffers[self._index]

    def shared(self) -> "SharedBuffer":
        """Consume into a cloneable read-only view (pool.rs:55-66)."""
        assert self._live
        self._live = False
        # the shared view holds the single borrow this owner had
        return SharedBuffer(self._pool, self._index)

    def release(self) -> None:
        if self._live:
            self._live = False
            self._pool._add(self._index, -1)

    def __del__(self):  # drop semantics (pool.rs:77-87)
        try:
            self.release()
        except Exception:
            pass


class SharedBuffer:
    """Cloneable read-only view; refcounted back to the pool
    (pool.rs:89-135)."""

    def __init__(self, pool: BufferPool, index: int):
        self._pool = pool
        self._index = index
        self._live = True

    @property
    def data(self) -> bytes:
        assert self._live
        return bytes(self._pool._buffers[self._index])

    def clone(self) -> "SharedBuffer":
        assert self._live
        self._pool._add(self._index, 1)
        return SharedBuffer(self._pool, self._index)

    def release(self) -> None:
        if self._live:
            self._live = False
            self._pool._add(self._index, -1)

    def __del__(self):
        try:
            self.release()
        except Exception:
            pass


class EventKind(enum.Enum):
    CONNECTED = "connected"
    DISCONNECTED = "disconnected"
    COMMAND = "command"


@dataclasses.dataclass
class Event:
    """Link event (library/src/event.rs:1-8)."""

    kind: EventKind
    command: Optional[object] = None  # CommandMessage for COMMAND events


def format_base_10(x: int, buffer: bytearray) -> int:
    """Write ``x`` in decimal ASCII into ``buffer``; returns the digit
    count (util.rs:7-30).  Raises ValueError when the buffer is too small
    (the reference's BufferTooSmall)."""
    if x < 0:
        raise ValueError("unsigned only")
    i = 0
    while True:
        m = x % 10
        x //= 10
        if i >= len(buffer):
            raise ValueError("buffer too small")
        buffer[i] = ord("0") + m
        i += 1
        if x == 0:
            break
    buffer[:i] = buffer[:i][::-1]
    return i
