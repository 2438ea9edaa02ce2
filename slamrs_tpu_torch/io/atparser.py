"""Incremental ESP32 AT-command response parser.

A copy of ``slamrs_tpu/io/atparser.py`` (the port imports nothing of the
JAX package).

Parity surface: ``slamrs-robot-rtic/library/src/parse_at.rs`` — the
firmware's stream parser for ESP32-AT responses: line-based URC messages
(``OK``, ``ERROR``, ``ready``, ``WIFI CONNECTED``, ``0,CONNECT`` ...) and
binary ``+IPD,<link>,<len>:<payload>`` data frames (parse_at.rs:76-219).
Host-side equivalent so the full device protocol stack is covered (the
reference's tests, parse_at.rs:225-351, feed canned chunks through a fake
serial reader — mirrored in tests/test_atparser.py; tests/test_torch_io.py
holds this copy against the JAX one).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional


@dataclasses.dataclass
class EspMessage:
    """kind: 'ok' | 'error' | 'ready' | 'wifi_connected' | 'wifi_got_ip' |
    'connect' | 'closed' | 'send_ok' | 'line' | 'data'."""

    kind: str
    link: int = 0
    payload: bytes = b""
    text: str = ""


_LINE_MESSAGES = {
    b"OK": "ok",
    b"ERROR": "error",
    b"ready": "ready",
    b"WIFI CONNECTED": "wifi_connected",
    b"WIFI GOT IP": "wifi_got_ip",
    b"SEND OK": "send_ok",
}


class AtParser:
    """Incremental parser: feed bytes with :meth:`consume`, receive parsed
    messages.  Parity: AtParser::consume/process_buffer
    (parse_at.rs:89-191)."""

    def __init__(self, capacity: int = 4096):
        self.capacity = capacity
        self._buf = bytearray()
        # pending binary payload: (link, remaining length)
        self._ipd: Optional[tuple[int, int]] = None
        self._ipd_data = bytearray()

    def consume(self, chunk: bytes) -> list[EspMessage]:
        out: list[EspMessage] = []
        for b in chunk:
            out.extend(self._consume_byte(b))
        return out

    def _consume_byte(self, b: int) -> Iterator[EspMessage]:
        if self._ipd is not None:
            link, remaining = self._ipd
            self._ipd_data.append(b)
            remaining -= 1
            if remaining == 0:
                payload = bytes(self._ipd_data)
                self._ipd = None
                self._ipd_data = bytearray()
                yield EspMessage("data", link=link, payload=payload)
            else:
                self._ipd = (link, remaining)
            return

        self._buf.append(b)
        if len(self._buf) > self.capacity:
            del self._buf[: len(self._buf) - self.capacity]

        # binary +IPD header terminates with ':' not newline
        if b == ord(":") and self._buf.lstrip().startswith(b"+IPD,"):
            header = bytes(self._buf).strip()
            self._buf.clear()
            parsed = _parse_ipd_header(header)
            if parsed is not None:
                link, length = parsed
                if length == 0:
                    yield EspMessage("data", link=link, payload=b"")
                else:
                    self._ipd = (link, length)
            return

        if b == ord("\n"):
            line = bytes(self._buf).strip()
            self._buf.clear()
            if not line:
                return
            kind = _LINE_MESSAGES.get(line)
            if kind is not None:
                yield EspMessage(kind, text=line.decode("ascii", "replace"))
            elif line.endswith(b",CONNECT"):
                yield EspMessage("connect", link=_link_of(line))
            elif line.endswith(b",CLOSED"):
                yield EspMessage("closed", link=_link_of(line))
            else:
                yield EspMessage("line",
                                 text=line.decode("ascii", "replace"))


def _link_of(line: bytes) -> int:
    try:
        return int(line.split(b",")[0])
    except ValueError:
        return 0


def _parse_ipd_header(header: bytes) -> Optional[tuple[int, int]]:
    """Parse ``+IPD,<link>,<len>`` (parse_at.rs:195-219)."""
    if not header.startswith(b"+IPD,") or not header.endswith(b":"):
        return None
    try:
        parts = header[5:-1].split(b",")
        if len(parts) != 2:
            return None
        return int(parts[0]), int(parts[1])
    except ValueError:
        return None
