"""Simulator node: the simulator tick in the host graph.

Counterpart of ``slamrs_tpu/graph/nodes/sim.py``, with the same YAML
fields.  The node advances a virtual fixed-timestep clock by the App's
frame time and runs one :func:`~slamrs_tpu_torch.models.simulator.tick`
per whole ``dt``; the App decides the real-time pacing.  The scan timer
is a host value, so the node knows which ticks fire without waiting for
the device, and it publishes the pose, the scan and the landmarks only
on those.

Randomness: a ``torch.Generator`` on the node's device, seeded from
``seed``, gives the landmark sensor's bearing and then range draws on
each tick that fires.  ``landmark_noise`` is a seam for tests: a
callable taking the tick's index and returning ``(noise_a, noise_d)``,
asked on every tick and used on the ticks that fire.

With :meth:`SimulatorNode.use_programs` (the App's default on the card)
each tick is a replay of an idle-tick or a firing-tick program
(``graph/capture.Program``), picked by the host timer.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import numpy as np
import torch

from slamrs_tpu_torch.core.types import Command
from slamrs_tpu_torch.graph import capture
from slamrs_tpu_torch.graph.node import (LandmarkOdometry, Node, NodeConfig,
                                         PoseMsg, ScanOdometry)
from slamrs_tpu_torch.models import simulator as sim_model
from slamrs_tpu_torch.parallel import fleet as pf


@dataclasses.dataclass
class SimulatorNodeConfig(NodeConfig):
    topic_command: str
    running: bool = True
    topic_observation_scanner: Optional[str] = None
    topic_observation_landmarks: Optional[str] = None
    topic_pose: Optional[str] = None
    scene: list = dataclasses.field(default_factory=list)
    landmarks: list = dataclasses.field(default_factory=list)
    parameters: dict = dataclasses.field(default_factory=dict)
    draw_scene: bool = True
    draw_pose: bool = True
    seed: int = 0

    def build_scene(self, device) -> sim_model.Scene:
        """The ``!Line``/``!Rectangle`` scene and its ``!Landmark``s."""
        lines, rects = [], []
        for obj in self.scene:
            tag, fields = obj if isinstance(obj, tuple) else (
                obj.get("_tag"), obj)
            if tag == "Line":
                lines.append((fields["x1"], fields["y1"], fields["x2"],
                              fields["y2"]))
            elif tag == "Rectangle":
                rects.append((fields["x"], fields["y"], fields["width"],
                              fields["height"]))
            else:
                raise ValueError(f"unknown scene object {tag!r}")
        lms = []
        for lm in self.landmarks:
            _, fields = lm if isinstance(lm, tuple) else (lm.get("_tag"), lm)
            lms.append((fields["x"], fields["y"]))
        return sim_model.Scene.build(lines=lines, rects=rects, landmarks=lms,
                                     device=device)

    def instantiate(self, pubsub, device) -> "SimulatorNode":
        return SimulatorNode(self, pubsub, device)


class SimulatorNode(Node):
    def __init__(self, config: SimulatorNodeConfig, pubsub, device):
        self.config = config
        self.device = torch.device(device)
        self.scene = config.build_scene(self.device)
        self.params = sim_model.SimParams.make(**config.parameters)
        self.state = sim_model.SimState.init(self.device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(config.seed)
        self.landmark_noise: Optional[Callable[[int], tuple]] = None
        self.ticks = 0
        self.running = config.running
        self.accumulator = 0.0
        self.dt = sim_model.DEFAULT_DT

        self.sub_cmd = pubsub.subscribe(config.topic_command, Command)
        self.pub_scan = (pubsub.publish(config.topic_observation_scanner,
                                        ScanOdometry)
                         if config.topic_observation_scanner else None)
        self.pub_landmarks = (pubsub.publish(config.topic_observation_landmarks,
                                             LandmarkOdometry)
                              if config.topic_observation_landmarks else None)
        self.pub_pose = (pubsub.publish(config.topic_pose, PoseMsg)
                         if config.topic_pose else None)
        self.cmd = Command.make(device=self.device)

    def advance(self, wall_dt: float) -> None:
        """Fixed-timestep accumulator."""
        if not self.running:
            return
        self.accumulator += wall_dt
        while self.accumulator >= self.dt:
            self.accumulator -= self.dt
            self._one_tick()

    def use_programs(self, graphs: bool) -> None:
        self.program = capture.Program(self._tick_body, self.device, graphs,
                                       self.generator)

    def _one_tick(self) -> None:
        cmd = self.sub_cmd.latest()
        if cmd is not None:
            self.cmd = cmd
        draws = (self.landmark_noise(self.ticks)
                 if self.landmark_noise is not None else None)
        self.ticks += 1
        if self.program is None:
            self.state, out = sim_model.tick(
                self.state, self.cmd, self.params, self.scene, self.dt,
                generator=self.generator, landmark_noise=draws)
        else:
            out = self._program_tick(draws)
        if out.fired:
            if self.pub_pose:
                self.pub_pose.publish(PoseMsg(out.pose))
            if self.pub_scan:
                self.pub_scan.publish(ScanOdometry(out.scan, out.odometry))
            if self.pub_landmarks:
                self.pub_landmarks.publish(
                    LandmarkOdometry(out.landmarks, out.odometry))

    def _program_tick(self, draws) -> sim_model.SimOutputs:
        """The tick through the program: an idle graph or a firing one,
        picked by the host timer.  The graphs hold ``dt`` and every
        parameter but the period (the host timer's alone) as constants,
        so a changed parameter makes new graphs.  What a firing tick
        publishes is copied out of the graph's buffers: two ticks can fire
        in one frame, and the second replay would overwrite the first
        tick's message."""
        p = self.program
        timer, fired = sim_model.timer_step(self.state.scan_timer,
                                            self.params, self.dt)
        kind = (fired, self.dt, self.params._replace(update_period=0.0))
        out = p(kind, self.state, cmd=self.cmd,
                landmark_noise=draws if fired else None)
        self.state = p.state._replace(
            scan_timer=timer, scan_counter=self.state.scan_counter + int(fired))
        if not fired:
            return out
        own = functools.partial(pf.tree_map, lambda x: x.clone()
                                if isinstance(x, torch.Tensor) else x)
        return out._replace(scan=own(out.scan), odometry=own(out.odometry),
                            landmarks=own(out.landmarks))

    def _tick_body(self, key) -> sim_model.SimOutputs:
        p = self.program
        new, out = sim_model.tick(
            p.state, p.inputs["cmd"], self.params, self.scene, self.dt,
            generator=self.generator,
            landmark_noise=p.given("landmark_noise"))
        if out.fired != key[0][0]:
            raise RuntimeError("simulator program: the tick's timer "
                               "disagrees with its graph")
        p.copy_back(new)
        return out

    def set_parameters(self, **kwargs) -> None:
        """Change the running node's parameters (and ``running``); the
        change takes effect on the next tick.  An unknown name raises."""
        if "running" in kwargs:
            self.running = bool(kwargs.pop("running"))
        unknown = set(kwargs) - set(sim_model.SimParams._fields)
        if unknown:
            raise ValueError(f"unknown simulator parameters: {sorted(unknown)}")
        self.params = self.params._replace(
            **{k: float(np.float32(v)) for k, v in kwargs.items()})

    def draw(self, viz=None) -> None:
        """The scene's segments and the ground-truth pose arrow, gated by
        ``draw_scene`` and ``draw_pose``."""
        if viz is None:
            return
        from slamrs_tpu_torch.viz.shapes import Color, PrimitiveType

        if self.config.draw_scene:
            segs = self.scene.segments.cpu().numpy()
            mask = self.scene.segment_mask.cpu().numpy()
            viz.sr.begin(PrimitiveType.LINE)
            viz.sr.lines_batch(segs[mask].reshape(-1, 2, 2),
                               np.float32([0, 0, 0, 1]))
            viz.sr.end()
        if self.config.draw_pose:
            x, y, th = (float(p) for p in self.get_pose())
            viz.sr.begin(PrimitiveType.FILLED)
            viz.sr.arrow(x, y, th, 0.1, Color.BLUE)
            viz.sr.end()

    def get_pose(self) -> np.ndarray:
        """The ground-truth pose, a copy (the program updates its pose
        buffer in place)."""
        return self.state.pose.cpu().numpy().copy()

    def terminate(self) -> None:
        self.running = False
