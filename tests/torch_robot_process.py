"""The ``robot`` subcommand in its own process, for the SIGINT tests of
``tests/test_torch_robot.py`` (CPU) and ``tests/test_torch_cuda.py``
(the card).  Imports no JAX."""

from __future__ import annotations

import os
import select
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

from slamrs_tpu_torch.io.message import CommandMessage

ROOT = Path(__file__).resolve().parents[1]


def _line(proc, want: str, deadline: float) -> list:
    """Lines of the process's stderr up to and including one holding
    ``want``; raises after ``deadline`` (``time.monotonic``)."""
    lines = []
    while not lines or want not in lines[-1]:
        left = deadline - time.monotonic()
        ready = select.select([proc.stderr], [], [], max(left, 0))[0]
        if not ready or proc.poll() is not None:
            raise AssertionError(f"no {want!r} from the robot: {lines}")
        lines.append(proc.stderr.readline())
    return lines


def connect_close_sigint(device: str, cycles: int = 2,
                         limit_s: float = 60.0, exit_limit_s: float = 20.0):
    """Start ``python -m slamrs_tpu_torch robot --device <device>``; connect
    a host and close it ``cycles`` times, each after the robot has sent
    bytes; then send SIGINT.  Returns ``(exit code, stderr lines)``; the
    exit code is None when the process did not end within
    ``exit_limit_s`` of the signal (it is killed then)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "slamrs_tpu_torch", "robot", "--host",
         "127.0.0.1", "--port", str(port), "--device", device],
        cwd=ROOT, env=env, stderr=subprocess.PIPE, text=True)
    deadline = time.monotonic() + limit_s
    lines = []
    try:
        lines += _line(proc, "listening", deadline)
        for _ in range(cycles):
            with socket.create_connection(("127.0.0.1", port),
                                          timeout=limit_s) as host:
                lines += _line(proc, "host connected", deadline)
                # the lidar on: the server thread raycasts on the device
                host.sendall(CommandMessage.neato_on().encode())
                got = 0
                while got < 4096:  # a few lidar frames
                    got += len(host.recv(4096))
            lines += _line(proc, "host disconnected", deadline)
        proc.send_signal(signal.SIGINT)
        try:
            code = proc.wait(timeout=exit_limit_s)
        except subprocess.TimeoutExpired:
            code = None
        lines += proc.stderr.read().splitlines() if code is not None else []
        return code, lines
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stderr.close()
