"""Utility, teleop and debug nodes.

Counterpart of ``slamrs_tpu/graph/nodes/util.py``, with the same YAML
vocabulary:

* Splitter: a tuple topic into two topics.
* Controls: a scripted drive plan (rows ``[until_t, left, right]``, the
  earliest row whose ``until_t`` has not passed wins) published on change
  only; :meth:`ControlsNode.set_command` (the keyboard teleop of
  ``run --teleop``) suspends the script for good, and its command is
  published by the next ``update`` (the JAX package's publishes at
  once: here every tensor is made on the thread that runs the graph).
* Gamepad: stick to differential drive with a turn damping of 3,
  published on change; ``set_stick(x, y)`` feeds it.
* ShapeTest and GaussianTest draw through the shape renderer;
  GaussianTest also publishes its :class:`Gaussian2D`.
* MousePosition: accepted and inert (it only shows the hovered world
  coordinate in a window).

Commands are two f32 0-dim tensors on the node's device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

from slamrs_tpu_torch.core.types import Command, Gaussian2D
from slamrs_tpu_torch.graph.node import Node, NodeConfig


@dataclasses.dataclass
class SplitterNodeConfig(NodeConfig):
    splits: list = dataclasses.field(default_factory=list)

    def instantiate(self, pubsub, device) -> "SplitterNode":
        return SplitterNode(self, pubsub)


class _OneToTwoSplit:
    def __init__(self, pubsub, input_topic, out1, out2, extract):
        self.sub = pubsub.subscribe(input_topic)
        self.pub1 = pubsub.publish(out1)
        self.pub2 = pubsub.publish(out2)
        self.extract = extract

    def update(self):
        while True:
            msg = self.sub.try_recv()
            if msg is None:
                return
            a, b = self.extract(msg)
            self.pub1.publish(a)
            self.pub2.publish(b)


class SplitterNode(Node):
    def __init__(self, config: SplitterNodeConfig, pubsub):
        self.splitters = []
        for s in config.splits:
            tag, fields = s if isinstance(s, tuple) else (s.get("_tag"), s)
            if tag == "ScannerOdometry":
                ex = lambda m: (m.scan, m.odometry)
            elif tag == "LandmarkOdometry":
                ex = lambda m: (m.landmarks, m.odometry)
            else:
                raise ValueError(f"unknown split {tag!r}")
            out1 = fields.get("scanner") or fields.get("landmark")
            self.splitters.append(_OneToTwoSplit(
                pubsub, fields["input"], out1, fields["odometry"], ex))

    def update(self):
        for s in self.splitters:
            s.update()


@dataclasses.dataclass
class ControlsNodeConfig(NodeConfig):
    topic_command: str
    keyboard_enabled: bool = True
    max_speed: float = 0.1
    # rows [until_time_s, speed_left, speed_right]
    script: list = dataclasses.field(default_factory=list)

    def instantiate(self, pubsub, device) -> "ControlsNode":
        return ControlsNode(self, pubsub, device)


class ControlsNode(Node):
    def __init__(self, config: ControlsNodeConfig, pubsub, device):
        self.config = config
        self.device = device
        self.pub = pubsub.publish(config.topic_command, Command)
        self.time = 0.0
        self.last: Optional[tuple] = None
        # the same row selection as FusedWorld.commands_for
        self._sorted_script = sorted(config.script,
                                     key=lambda r: float(r[0]))
        # the latest teleop command; once set, the script yields for good
        self._teleop: Optional[tuple] = None

    def advance(self, dt: float) -> None:
        self.time += dt

    def set_command(self, left: float, right: float) -> None:
        """Teleop, callable from any thread (the keyboard reader's).  The
        next :meth:`update` publishes the command, on the thread that
        runs the graph, and the drive script is suspended for good;
        otherwise the next frame would publish the script's row again."""
        self._teleop = (float(left), float(right))

    def _publish(self, left, right):
        if self.last != (left, right):  # publish on change
            self.last = (left, right)
            self.pub.publish(Command.make(left, right, device=self.device))

    def update(self) -> None:
        teleop = self._teleop
        if teleop is not None:
            self._publish(*teleop)
            return
        for until, left, right in self._sorted_script:
            if self.time <= until:
                self._publish(float(left), float(right))
                return


@dataclasses.dataclass
class GamepadNodeConfig(NodeConfig):
    topic_command: str
    max_speed: float = 0.2

    def instantiate(self, pubsub, device) -> "GamepadNode":
        return GamepadNode(self, pubsub, device)


class GamepadNode(Node):
    """Stick-to-differential teleop: polar decomposition, square-pad
    magnitude, turn damping, speed scaling, publish on change."""

    TURN_DAMPING = 3.0

    def __init__(self, config: GamepadNodeConfig, pubsub, device):
        self.pub = pubsub.publish(config.topic_command, Command)
        self.device = device
        self.target_speed = config.max_speed
        self.x = 0.0
        self.y = 0.0
        self.last: Optional[tuple] = None

    def set_stick(self, x: float, y: float) -> None:
        self.x = float(x)
        self.y = float(y)

    def update(self) -> None:
        r = math.hypot(self.x, self.y)
        if r > 0.0:
            angle = math.atan2(self.y, self.x)
            max_r = r / max(abs(self.x), abs(self.y))
            magnitude = r / max_r
            left = magnitude * (math.sin(angle)
                                + math.cos(angle) / self.TURN_DAMPING)
            right = magnitude * (math.sin(angle)
                                 - math.cos(angle) / self.TURN_DAMPING)
            cmd = (left * self.target_speed, right * self.target_speed)
        else:
            cmd = (0.0, 0.0)
        if cmd != self.last:
            self.pub.publish(Command.make(*cmd, device=self.device))
            self.last = cmd


@dataclasses.dataclass
class MousePositionNodeConfig(NodeConfig):
    def instantiate(self, pubsub, device) -> Node:
        return Node()


@dataclasses.dataclass
class ShapeTestNodeConfig(NodeConfig):
    grid_steps: int = 255  # color-field rects per axis

    def instantiate(self, pubsub, device) -> "ShapeTestNode":
        return ShapeTestNode(self)


class ShapeTestNode(Node):
    """Renderer smoke test: an RGB rect field plus line and filled
    circles and arrows.  The scene is static: built once, replayed."""

    def __init__(self, config: ShapeTestNodeConfig):
        self.n = config.grid_steps
        self._cached = None

    def draw(self, viz=None) -> None:
        if viz is None:
            return
        target = viz.sr if hasattr(viz, "sr") else viz
        if self._cached is not None:
            target._calls.extend(self._cached)
            return
        from slamrs_tpu_torch.viz.shapes import Color, PrimitiveType

        sr = viz
        n = self.n
        calls_before = len(target._calls)
        sr.begin(PrimitiveType.FILLED)
        for x in range(n):
            for y in range(n):
                c = Color(x / 255.0, y / 255.0, 128 / 255.0)
                sr.rect(x / 255.0, y / 255.0, 1 / 255.0, 1 / 255.0, c)
        sr.end()
        sr.begin(PrimitiveType.LINE)
        sr.circle(0.1, -0.1, 0.05, Color.RED)
        sr.end()
        sr.begin(PrimitiveType.FILLED)
        sr.circle(-0.1, -0.1, 0.05, Color.GREEN)
        sr.end()
        sr.begin(PrimitiveType.LINE)
        sr.arrow(-0.1, 0.1, math.pi + math.pi / 3, 0.1, Color.RED)
        sr.end()
        sr.begin(PrimitiveType.FILLED)
        sr.arrow(0.1, 0.1, math.pi / 6, 0.1, Color.GREEN)
        sr.end()
        self._cached = list(target._calls[calls_before:])


@dataclasses.dataclass
class GaussianTestNodeConfig(NodeConfig):
    topic: str = "gaussian"

    def instantiate(self, pubsub, device) -> "GaussianTestNode":
        return GaussianTestNode(self, pubsub)


class GaussianTestNode(Node):
    """Publishes its mutable :class:`Gaussian2D` every frame and draws its
    covariance ellipse."""

    def __init__(self, config: GaussianTestNodeConfig, pubsub):
        self.gaussian = Gaussian2D()
        self.pub = pubsub.publish(config.topic, Gaussian2D)

    def update(self) -> None:
        self.pub.publish(self.gaussian)

    def draw(self, viz=None) -> None:
        if viz is None:
            return
        from slamrs_tpu_torch.viz.shapes import Color, PrimitiveType

        viz.begin(PrimitiveType.LINE)
        viz.gaussian2d(self.gaussian.mean, self.gaussian.covariance,
                       Color.BLUE)
        viz.end()
