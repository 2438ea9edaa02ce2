"""Terminal keyboard teleop: drive the robot from stdin, headlessly.

Counterpart of ``slamrs_tpu/io/teleop.py``: WASD and the arrow keys map
to differential wheel commands (Up = (s, s), UpLeft = (s/3, s), Left =
(-s, s), ...).  A terminal delivers key presses, not key-down state, so
each press sets the command until the next; space or 'x' stops, 'q'/'e'
are the forward diagonals, and 'Q', ctrl-C or end of input ends the
teleop.  Attach with ``python -m slamrs_tpu_torch run <cfg> --realtime
--teleop``.  The reader thread only calls ``set_command``; the
``!Controls`` node publishes the command from the thread that runs the
graph.
"""

from __future__ import annotations

import os
import select
import sys
import threading
from typing import Callable, Optional

# control -> (left_factor, right_factor); multiplied by target_speed
CONTROL_TABLE = {
    "stop": (0.0, 0.0),
    "up": (1.0, 1.0),
    "up_left": (1.0 / 3.0, 1.0),
    "up_right": (1.0, 1.0 / 3.0),
    "down": (-1.0, -1.0),
    "down_left": (-1.0 / 3.0, -1.0),
    "down_right": (-1.0, -1.0 / 3.0),
    "left": (-1.0, 1.0),
    "right": (1.0, -1.0),
}

_KEYMAP = {
    "w": "up", "a": "left", "s": "down", "d": "right",
    "q": "up_left", "e": "up_right",
    "z": "down_left", "c": "down_right",
    " ": "stop", "x": "stop",
    # arrow keys arrive as ESC [ A/B/D/C; the reader collapses the
    # escape sequence to these single tokens
    "\x1b[A": "up", "\x1b[B": "down", "\x1b[D": "left", "\x1b[C": "right",
}


def key_to_command(key: str, target_speed: float
                   ) -> Optional[tuple[float, float]]:
    """(left, right) wheel speeds for a key token, or None if unmapped."""
    ctrl = _KEYMAP.get(key)
    if ctrl is None:
        return None
    fl, fr = CONTROL_TABLE[ctrl]
    return (fl * target_speed, fr * target_speed)


class StdinTeleop:
    """Background stdin reader feeding ``set_command(left, right)``.

    When ``fd`` is a tty it is switched to cbreak (raw-ish) mode for
    unbuffered single-key reads and restored on stop; a pipe fd works
    as-is (used by tests).  'Q' or EOF ends the reader.
    """

    def __init__(self, set_command: Callable[[float, float], None],
                 target_speed: float = 0.1, fd: Optional[int] = None):
        self.set_command = set_command
        self.target_speed = target_speed
        self.fd = sys.stdin.fileno() if fd is None else fd
        self._stop = threading.Event()
        self._saved_attrs = None
        if os.isatty(self.fd):
            import termios
            import tty

            self._saved_attrs = termios.tcgetattr(self.fd)
            tty.setcbreak(self.fd)
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _read_token(self, timeout: float = 0.1) -> Optional[str]:
        """One key token (collapsing ESC [ X arrow sequences); None on
        timeout, '' on EOF."""
        r, _, _ = select.select([self.fd], [], [], timeout)
        if not r:
            return None
        ch = os.read(self.fd, 1)
        if not ch:
            return ""
        if ch != b"\x1b":
            return ch.decode(errors="replace")
        seq = b"\x1b"
        for _ in range(2):  # expect '[' + final byte, already buffered
            r, _, _ = select.select([self.fd], [], [], 0.05)
            if not r:
                break
            nxt = os.read(self.fd, 1)
            if not nxt:
                break
            seq += nxt
        return seq.decode(errors="replace")

    def _run(self) -> None:
        while not self._stop.is_set():
            tok = self._read_token()
            if tok is None:
                continue
            if tok == "" or tok == "Q" or tok == "\x03":  # EOF/quit/ctrl-C
                self.set_command(0.0, 0.0)
                break
            cmd = key_to_command(tok.lower() if len(tok) == 1 else tok,
                                 self.target_speed)
            if cmd is not None:
                self.set_command(*cmd)

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=1.0)
        if self._saved_attrs is not None:
            import termios

            termios.tcsetattr(self.fd, termios.TCSADRAIN, self._saved_attrs)

    @property
    def alive(self) -> bool:
        return self._thread.is_alive()
