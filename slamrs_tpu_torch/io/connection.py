"""Real-robot link: TCP (and optional serial) bincode stream client.

A copy of ``slamrs_tpu/io/connection.py`` (the port imports nothing of
the JAX package) over the port's own native wire codec.  The reader
thread handles bytes only: ``on_scan`` must run no torch operation (the
nodes queue numpy and build tensors on the thread that runs the graph).

Parity surface: ``neato/src/connection.rs`` — a background stream thread
that (on connect) sends ``NeatoOn`` + ``SetDownsampling{every:2}``
(connection.rs:250-262), decodes ``RobotMessage`` frames, converts
``ScanFrame`` odometry with wheel base 0.2 m (connection.rs:25,
``WHEEL_BASE``), forwards ``CommandMessage::Drive`` teleop, and on close
best-effort sends ``NeatoOff`` + ``Drive{0,0}`` (connection.rs:300-313).

The transport seam (:class:`ConnectionMedium`) mirrors the reference's
trait (connection.rs:322-338) so tests inject an in-memory stream.
"""

from __future__ import annotations

import socket
import threading
from typing import Callable, Optional

from slamrs_tpu_torch.io.message import CommandMessage, RobotMessage

WHEEL_BASE = 0.2  # meters; connection.rs:25
DEFAULT_DOWNSAMPLING = 2  # connection.rs:253


class ConnectionMedium:
    """Transport seam (connection.rs:322-338).

    ``read`` contract: ``b""`` means a read timeout (keep polling);
    ``None`` means END OF STREAM (peer closed cleanly) — the reader
    treats it like a stream error and disconnects, matching the
    reference where a clean close surfaces as an UnexpectedEof decode
    error in the read loop."""

    def read(self, n: int) -> Optional[bytes]:
        raise NotImplementedError

    def write(self, data: bytes) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class TcpMedium(ConnectionMedium):
    def __init__(self, host: str, port: int = 8080, timeout: float = 0.2):
        self.sock = socket.create_connection((host, port), timeout=5.0)
        self.sock.settimeout(timeout)  # 200 ms read timeout (connection.rs:291)

    def read(self, n: int) -> Optional[bytes]:
        try:
            data = self.sock.recv(n)
        except socket.timeout:
            return b""
        return data if data else None  # recv() == b'' is EOF

    def write(self, data: bytes) -> None:
        self.sock.sendall(data)

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


class SerialMedium(ConnectionMedium):
    """Serial robot link at 115200 baud (connection.rs:212-227, the
    ``serial2::SerialPort::open(path, 115200)`` transport).

    Implemented on the stdlib (termios + select), with no pyserial
    dependency.  Raw mode, 8N1, with the same 200 ms read timeout the TCP
    medium uses.  Testable against a pty (see tests/test_torch_io.py).
    """

    def __init__(self, path: str, baud: int = 115200,
                 timeout: float = 0.2, _configure: bool = True):
        import os as _os

        self.fd = _os.open(path, _os.O_RDWR | _os.O_NOCTTY | _os.O_NONBLOCK)
        self.timeout = timeout
        if _configure:
            self._configure(baud)

    def _configure(self, baud: int) -> None:
        import termios

        rate = getattr(termios, f"B{baud}", None)
        if rate is None:
            raise ValueError(f"unsupported baud rate {baud}")
        attrs = termios.tcgetattr(self.fd)
        iflag, oflag, cflag, lflag, _, _, cc = attrs
        # raw 8N1 (cfmakeraw semantics)
        iflag &= ~(termios.IGNBRK | termios.BRKINT | termios.PARMRK
                   | termios.ISTRIP | termios.INLCR | termios.IGNCR
                   | termios.ICRNL | termios.IXON)
        oflag &= ~termios.OPOST
        lflag &= ~(termios.ECHO | termios.ECHONL | termios.ICANON
                   | termios.ISIG | termios.IEXTEN)
        cflag &= ~(termios.CSIZE | termios.PARENB | termios.CSTOPB)
        cflag |= termios.CS8 | termios.CREAD | termios.CLOCAL
        cc[termios.VMIN] = 0
        cc[termios.VTIME] = 0
        termios.tcsetattr(self.fd, termios.TCSANOW,
                          [iflag, oflag, cflag, lflag, rate, rate, cc])

    def read(self, n: int) -> Optional[bytes]:
        import os as _os
        import select

        r, _, _ = select.select([self.fd], [], [], self.timeout)
        if not r:
            return b""  # timeout -> not an error (connection.rs:291-293)
        try:
            data = _os.read(self.fd, n)
        except BlockingIOError:
            return b""
        return data if data else None  # readable-but-empty fd is EOF

    def write(self, data: bytes) -> None:
        import os as _os
        import select

        view = memoryview(data)
        while view:
            try:
                sent = _os.write(self.fd, view)
            except BlockingIOError:
                # O_NONBLOCK fd with a full tty buffer (flow-control
                # stall): wait for writability instead of dying
                select.select([], [self.fd], [], 1.0)
                continue
            view = view[sent:]

    def close(self) -> None:
        import os as _os

        try:
            _os.close(self.fd)
        except OSError:
            pass


def open_medium(target: str, timeout: float = 0.2) -> ConnectionMedium:
    """Resolve a connection target like the reference's port picker
    (connection.rs:202-241): a filesystem path (``/dev/tty*``) opens a
    115200-baud serial port; anything else is ``host[:port]`` TCP."""
    if target.startswith("/") :
        return SerialMedium(target, timeout=timeout)
    host, _, port = target.partition(":")
    return TcpMedium(host, int(port) if port else 8080, timeout=timeout)


class RobotLink:
    """Decoded-message pump over a ConnectionMedium.

    ``on_scan(scan_data: bytes, odometry: (l, r), rpm: int)`` is invoked on
    the reader thread for every ScanFrame.
    """

    def __init__(self, medium: ConnectionMedium,
                 on_scan: Callable[[bytes, tuple, int], None],
                 downsampling: int = DEFAULT_DOWNSAMPLING):
        self.medium = medium
        self.on_scan = on_scan
        self._stop = threading.Event()
        self._buf = bytearray()
        medium.write(CommandMessage.neato_on().encode())
        medium.write(CommandMessage.set_downsampling(downsampling).encode())
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def drive(self, left: float, right: float) -> None:
        self.medium.write(CommandMessage.drive(left, right).encode())

    def set_motor_pi_params(self, kp: float, ki: float) -> None:
        self.medium.write(CommandMessage.set_motor_pi_params(kp, ki).encode())

    def set_neato(self, on: bool) -> None:
        """Lidar motor on/off (the reference's Neato checkbox,
        connection.rs:151-180 UI block)."""
        msg = CommandMessage.neato_on() if on else CommandMessage.neato_off()
        self.medium.write(msg.encode())

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                chunk = self.medium.read(4096)
            except OSError:
                # peer reset / closed socket: the reference's reader
                # treats stream errors as a disconnect (connection.rs
                # read-loop Err arm) — end the thread cleanly; the node
                # observes the dead thread and returns to idle
                return
            if chunk is None:
                return  # clean EOF (peer closed) -> same disconnect path
            if chunk:
                self._buf.extend(chunk)
                self._drain()

    def _drain(self) -> None:
        from slamrs_tpu_torch.native import wire_native as load_wire

        wire_native = load_wire()
        if wire_native is not None:
            # native data plane: C++ passes extract every complete frame
            # (incl. the 1-byte resync on malformed variants); loop in
            # case more than one max_frames batch accumulated
            while True:
                frames, consumed = wire_native.decode_scan_frames(
                    bytes(self._buf))
                del self._buf[:consumed]
                for scan, odo, rpm in frames:
                    self.on_scan(scan, odo, rpm)
                if not frames:
                    return
        while True:
            try:
                msg, consumed = RobotMessage.decode(bytes(self._buf))
            except (EOFError, IndexError):
                return  # need more bytes
            except ValueError:
                # decode error: reference logs and drops the stream
                # (connection.rs:294-296); here we resync by skipping a byte
                del self._buf[:1]
                continue
            del self._buf[:consumed]
            if msg.kind == "scan_frame":
                f = msg.scan_frame
                self.on_scan(f.scan_data, f.odometry, f.rpm)

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2.0)
        try:  # best-effort shutdown (connection.rs:300-313)
            self.medium.write(CommandMessage.neato_off().encode())
            self.medium.write(CommandMessage.drive(0.0, 0.0).encode())
        except Exception:
            pass
        self.medium.close()

    @property
    def alive(self) -> bool:
        return self._thread.is_alive()
