"""Recorded-log and real-robot nodes.

Counterpart of ``slamrs_tpu/graph/nodes/robot.py`` (``!FileLoader``,
``!RobotConnection``), with the same YAML fields and topics.  The
FileLoader replays a recorded Neato ``.bin`` log, one frame an app frame
with ``autoplay`` (or the frame set through ``frame_index``), with the
identity pose.  The RobotConnection streams (Scan, Odometry) from a
robot, real or virtual, over TCP or a serial device and forwards the
drive commands; it connects only when :meth:`RobotConnectionNode.connect`
is called, as in the JAX package.

Both publish their scans on the App's device.  A frame's distances,
strengths, valid mask and odometry are laid into one fresh host tensor
(pinned memory on the card) and go over in one copy that does not wait:
the staging tensor is never written again, and the caching host
allocator keeps its memory until the copy is done.  The link's reader
thread only parses bytes to numpy and queues them; the tensors are built
by :meth:`RobotConnectionNode.update`, on the thread that runs the graph.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
from typing import Optional

import numpy as np
import torch

from slamrs_tpu_torch.core.types import Command, OdometryReading, Scan
from slamrs_tpu_torch.graph.node import Node, NodeConfig, PoseMsg, ScanOdometry
from slamrs_tpu_torch.io import neato as neato_io
from slamrs_tpu_torch.io.connection import (WHEEL_BASE, RobotLink, TcpMedium,
                                            open_medium)

_log = logging.getLogger(__name__)


class _ScanStager:
    """Neato frames (numpy) to ``Scan`` tensors on ``device``, one host to
    device copy a frame.  The angles and the ``present`` mask are the same
    every frame and stay on the device."""

    def __init__(self, device):
        self.device = torch.device(device)
        # NeatoFrame.to_scan_arrays's per-degree angles, every lane present
        angles = np.deg2rad(np.arange(neato_io.BEAMS, dtype=np.float32))
        self.angles = torch.from_numpy(angles).to(self.device)
        self.present = torch.ones(neato_io.BEAMS, dtype=torch.bool,
                                  device=self.device)

    def stage(self, frame: neato_io.NeatoFrame,
              odometry=None) -> tuple[Scan, Optional[OdometryReading]]:
        _, dist, strength, valid, _ = frame.to_scan_arrays()
        pinned = self.device.type == "cuda"
        host = torch.empty((4, neato_io.BEAMS), dtype=torch.float32,
                           pin_memory=pinned)
        h = host.numpy()
        h[0], h[1], h[2] = dist, strength, valid
        h[3] = 0.0
        if odometry is not None:
            h[3, :3] = (odometry[0], odometry[1], WHEEL_BASE)
        t = host.to(self.device, non_blocking=pinned)
        scan = Scan(angles=self.angles, distances=t[0], strengths=t[1],
                    valid=t[2] != 0, present=self.present)
        odo = (None if odometry is None
               else OdometryReading(t[3, 0], t[3, 1], t[3, 2]))
        return scan, odo


@dataclasses.dataclass
class FileLoaderNodeConfig(NodeConfig):
    topic_observation: str
    topic_pose: Optional[str] = None
    path: Optional[str] = None  # recorded Neato .bin log
    autoplay: bool = True

    def instantiate(self, pubsub, device) -> "FileLoaderNode":
        return FileLoaderNode(self, pubsub, device)


class FileLoaderNode(Node):
    """Replays a recorded Neato log: publishes the selected frame and the
    identity pose (fileloader.rs:60-80)."""

    def __init__(self, config: FileLoaderNodeConfig, pubsub, device):
        self.config = config
        self.frames = (neato_io.load_neato_binary(config.path)
                       if config.path else [])
        self.frame_index = 0
        self._published = -1
        self._stager = _ScanStager(device)
        self.pub_obs = pubsub.publish(config.topic_observation)
        self.pub_pose = (pubsub.publish(config.topic_pose, PoseMsg)
                         if config.topic_pose else None)

    def update(self) -> None:
        if not self.frames:
            return
        if self.config.autoplay and self._published >= 0:
            self.frame_index = min(self.frame_index + 1, len(self.frames) - 1)
        if self.frame_index != self._published:
            self._published = self.frame_index
            scan, _ = self._stager.stage(self.frames[self.frame_index])
            self.pub_obs.publish(scan)
            if self.pub_pose:
                self.pub_pose.publish(PoseMsg(np.zeros(3, np.float32)))

    @property
    def done(self) -> bool:
        return not self.frames or self.frame_index >= len(self.frames) - 1


@dataclasses.dataclass
class RobotConnectionNodeConfig(NodeConfig):
    topic_observation: str
    topic_command: Optional[str] = None
    host: str = "robot"
    port: int = 8080
    # serial device path (e.g. /dev/ttyUSB0 at 115200 baud); when set it
    # takes precedence over host/port (connection.rs:202-241)
    serial: Optional[str] = None
    downsampling: int = 2

    def instantiate(self, pubsub, device) -> "RobotConnectionNode":
        return RobotConnectionNode(self, pubsub, device)


class RobotConnectionNode(Node):
    """Streams (Scan, Odometry) from the robot; forwards Drive commands
    (connection.rs:206-320)."""

    def __init__(self, config: RobotConnectionNodeConfig, pubsub, device):
        self.config = config
        self._stager = _ScanStager(device)
        self.pub_obs = pubsub.publish(config.topic_observation, ScanOdometry)
        self.sub_cmd = (pubsub.subscribe(config.topic_command, Command)
                        if config.topic_command else None)
        # (NeatoFrame, (left, right)) from the reader thread, numpy only
        self._pending: collections.deque = collections.deque()
        self._link: Optional[RobotLink] = None

    def connect(self) -> None:
        if self.config.serial:
            medium = open_medium(self.config.serial)
        else:
            medium = TcpMedium(self.config.host, self.config.port)
        self._link = RobotLink(medium, self._on_scan,
                               self.config.downsampling)

    def _on_scan(self, scan_data: bytes, odometry, rpm: int) -> None:
        """The link's reader thread: bytes to numpy, no torch op."""
        self._pending.append((neato_io.parse_frame(scan_data),
                              (odometry[0], odometry[1])))

    @property
    def state(self) -> str:
        """Connection lifecycle: "idle" | "running" (the reference's
        ConnectionState, connection.rs:40-47, 135-139)."""
        return "running" if self._link is not None else "idle"

    def set_motor_pi_params(self, kp: float, ki: float) -> None:
        """Live PI gains on the running link (connection.rs:151-180)."""
        if self._link is None:
            raise RuntimeError("not connected")
        self._link.set_motor_pi_params(float(kp), float(ki))

    def set_neato(self, on: bool) -> None:
        """Lidar motor on/off on the running link (connection.rs:151-180)."""
        if self._link is None:
            raise RuntimeError("not connected")
        self._link.set_neato(bool(on))

    def update(self) -> None:
        while self._pending:
            frame, odometry = self._pending.popleft()
            self.pub_obs.publish(ScanOdometry(
                *self._stager.stage(frame, odometry)))
        if self._link is not None and not self._link.alive:
            # the stream thread died (decode error, remote close): back to
            # idle, the reference's handle.is_finished() check
            # (connection.rs:135-139)
            _log.error("robot connection thread ended; returning to idle")
            self._link.close()
            self._link = None
        if self._link is not None and self.sub_cmd is not None:
            cmd = self.sub_cmd.latest()
            if cmd is not None:  # reads the command's two values back
                self._link.drive(float(cmd.speed_left),
                                 float(cmd.speed_right))

    def terminate(self) -> None:
        if self._link is not None:
            self._link.close()
            self._link = None
