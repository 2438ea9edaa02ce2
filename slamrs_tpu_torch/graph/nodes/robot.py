"""Recorded-log and real-robot nodes: their YAML fields only.

Counterpart of the configs of ``slamrs_tpu/graph/nodes/robot.py``
(``!FileLoader``, ``!RobotConnection``).  They parse and check their
fields as the JAX package does, so every preset loads; building one
raises ``NotImplementedError``, because the robot I/O they run on
(``io/``, ``native/``, the ``replay`` and ``robot`` subcommands) is the
next slice of the port (ROADMAP.md).  A graph that holds one never runs
without it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from slamrs_tpu_torch.graph.node import NodeConfig

_ROBOT_IO = ("is not ported yet: the robot I/O (io/, native/, "
             "graph/nodes/robot.py) is the next slice of the port "
             "(ROADMAP.md)")


@dataclasses.dataclass
class FileLoaderNodeConfig(NodeConfig):
    topic_observation: str
    topic_pose: Optional[str] = None
    path: Optional[str] = None  # recorded Neato .bin log
    autoplay: bool = True

    def instantiate(self, pubsub, device):
        raise NotImplementedError(f"!FileLoader {_ROBOT_IO}")


@dataclasses.dataclass
class RobotConnectionNodeConfig(NodeConfig):
    topic_observation: str
    topic_command: Optional[str] = None
    host: str = "robot"
    port: int = 8080
    serial: Optional[str] = None  # a serial device takes precedence
    downsampling: int = 2

    def instantiate(self, pubsub, device):
        raise NotImplementedError(f"!RobotConnection {_ROBOT_IO}")
