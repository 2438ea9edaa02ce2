"""SLAM nodes of the host graph: occupancy-grid SLAM, the ICP point
mapper and EKF landmark SLAM.

Counterpart of ``slamrs_tpu/graph/nodes/slam.py``, with the same YAML
fields.  Each node owns its filter's state on its device and takes at
most one observation a frame.  Every update publishes the estimated pose;
the grid node publishes its best particle's map (unpadded, probability)
every ``publish_map_every`` updates.  The messages start their copies to
the host without waiting (``graph/node.py``); the ICP node alone waits,
for its map's point count.

Grid SLAM's draws come from a ``torch.Generator`` on the node's device
seeded from ``seed`` (``models/gridslam.draw_noise``), or from
``noise_for_update``, a seam for tests: a callable taking the update's
index and returning its ``UpdateNoise``.

With ``use_programs`` (the App's default on the card) each node's update
is a replay of its program (``graph/capture.Program``): grid SLAM's
update and map, the ICP update with K4 ten times inside, the EKF update.
The observations are copied into the program's input buffers.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from slamrs_tpu_torch.graph import capture
from slamrs_tpu_torch.graph.node import (GridMapMessage, LandmarkMapMessage,
                                         LandmarkOdometry, Node, NodeConfig,
                                         PointMapMessage, PoseMsg,
                                         ScanOdometry)
from slamrs_tpu_torch.models import ekf as ekf_model
from slamrs_tpu_torch.models import gridslam as gs_model
from slamrs_tpu_torch.models import icp_mapper as icp_model
from slamrs_tpu_torch.utils import trace

# each node's update is one span (``utils/trace.py``); the reference
# instruments ``GridMapSlam::update`` (slam/src/grid/slam.rs:45)
UPDATE_SPAN = "GridMapSlam::update"
ICP_UPDATE_SPAN = "IcpPointMapper::update"


@dataclasses.dataclass
class GridMapSlamNodeConfig(NodeConfig):
    topic_pose: str
    topic_observation_odometry: str
    topic_map: str
    config: dict = dataclasses.field(default_factory=dict)
    seed: int = 1
    publish_map_every: int = 1

    def slam_config(self) -> gs_model.GridSlamConfig:
        c = dict(self.config)
        pos = c.pop("position", (-2.0, -2.0))
        return gs_model.GridSlamConfig(
            position_x=float(pos[0]), position_y=float(pos[1]),
            width=float(c.pop("width", 4.0)),
            height=float(c.pop("height", 4.0)),
            resolution=float(c.pop("resolution", 0.02)),
            n_particles=int(c.pop("n_particles", 10)),
            **c)

    def instantiate(self, pubsub, device) -> "GridMapSlamNode":
        return GridMapSlamNode(self, pubsub, device)


class GridMapSlamNode(Node):
    def __init__(self, config: GridMapSlamNodeConfig, pubsub, device):
        self.cfg = config
        self.device = torch.device(device)
        self.slam_cfg = config.slam_config()
        self.state = gs_model.GridSlamState.init(self.slam_cfg, self.device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(config.seed)
        self.noise_for_update: Optional[
            Callable[[int], gs_model.UpdateNoise]] = None
        self.sub = pubsub.subscribe(config.topic_observation_odometry,
                                    ScanOdometry)
        self.pub_pose = pubsub.publish(config.topic_pose, PoseMsg)
        self.pub_map = pubsub.publish(config.topic_map, GridMapMessage)
        self.updates = 0
        self._position = np.array([self.slam_cfg.position_x,
                                   self.slam_cfg.position_y], np.float32)

    @property
    def stats(self):
        """The update span's statistics (process-wide, every grid SLAM
        node's updates)."""
        return trace.stats(UPDATE_SPAN)

    def use_programs(self, graphs: bool) -> None:
        self.program = capture.Program(self._program_body, self.device,
                                       graphs, self.generator)

    def update(self) -> None:
        msg = self.sub.try_recv()  # one observation a frame
        if msg is None:
            return
        with trace.span(UPDATE_SPAN):
            noise = (self.noise_for_update(self.updates)
                     if self.noise_for_update is not None else None)
            out = self.step(msg.scan, msg.odometry, noise)
            self.pub_pose.publish(PoseMsg(out.pose))
            self.updates += 1
            if self.updates % self.cfg.publish_map_every == 0:
                self.pub_map.publish(GridMapMessage(
                    position=self._position,
                    resolution=self.slam_cfg.resolution,
                    data=self.probability_map()))

    def step(self, scan, odometry, noise=None) -> gs_model.GridSlamOutputs:
        """One SLAM update of the node's state, its draws from the node's
        generator unless ``noise`` is given; through the node's program
        when it has one (whose outputs hold until its next update)."""
        p = self.program
        if p is None:
            if noise is None:
                noise = self._draw()
            self.state, out = gs_model.update(self.state, scan, odometry,
                                              self.slam_cfg, noise=noise)
            return out
        out = p("update", self.state, scan=scan, odometry=odometry,
                noise=noise)
        self.state = p.state
        return out

    def probability_map(self) -> torch.Tensor:
        """The best particle's map as occupancy probabilities, unpadded
        (the JAX node's second ``jit``)."""
        if self.program is None:
            return gs_model.estimated_probability_grid(self.state,
                                                       self.slam_cfg)
        return self.program("map", self.state)

    def _draw(self) -> gs_model.UpdateNoise:
        return gs_model.draw_noise(self.generator, self.slam_cfg.n_particles,
                                   self.device)

    def _program_body(self, key):
        p = self.program
        if key[0] == "map":
            return gs_model.estimated_probability_grid(p.state, self.slam_cfg)
        noise = p.given("noise")
        new, out = gs_model.update(
            p.state, p.inputs["scan"], p.inputs["odometry"], self.slam_cfg,
            noise=self._draw() if noise is None else noise)
        p.copy_back(new)
        return out


@dataclasses.dataclass
class IcpPointMapperNodeConfig(NodeConfig):
    topic_pose: str
    topic_observation: str
    topic_pointmap: str
    icp: dict = dataclasses.field(default_factory=dict)
    capacity: int = 16384
    voxel_size: Optional[float] = None

    def mapper_config(self) -> icp_model.IcpMapConfig:
        """``correspondence_weights`` is ``Uniform``, ``!Step {threshold:
        t}`` (a ``(tag, fields)`` tuple) or a mapping with ``threshold``."""
        icp = dict(self.icp)
        weights = icp.pop("correspondence_weights", "Uniform")
        threshold = None
        if isinstance(weights, tuple):
            tag, fields = weights
            if tag == "Step":
                threshold = float(fields["threshold"])
        elif isinstance(weights, dict) and "threshold" in weights:
            threshold = float(weights["threshold"])
        return icp_model.IcpMapConfig(
            capacity=self.capacity,
            iterations=int(icp.pop("iterations", 10)),
            step_threshold=threshold,
            voxel_size=self.voxel_size)

    def instantiate(self, pubsub, device) -> "IcpPointMapperNode":
        return IcpPointMapperNode(self, pubsub, device)


class IcpPointMapperNode(Node):
    def __init__(self, config: IcpPointMapperNodeConfig, pubsub, device):
        self.cfg = config
        self.device = torch.device(device)
        self.map_cfg = config.mapper_config()
        self.state = icp_model.IcpMapState.init(self.map_cfg, self.device)
        self.sub = pubsub.subscribe(config.topic_observation)
        self.pub_pose = pubsub.publish(config.topic_pose, PoseMsg)
        self.pub_map = pubsub.publish(config.topic_pointmap, PointMapMessage)
        self.updates = 0

    @property
    def stats(self):
        """The update span's statistics (process-wide, every ICP node's
        updates)."""
        return trace.stats(ICP_UPDATE_SPAN)

    def update(self) -> None:
        msg = self.sub.try_recv()  # one observation a frame
        if msg is None:
            return
        scan = msg.scan if isinstance(msg, ScanOdometry) else msg
        with trace.span(ICP_UPDATE_SPAN):
            if self.program is None:
                self.state, out = icp_model.update(self.state, scan,
                                                   self.map_cfg)
            else:
                out = self.program("update", self.state, scan=scan)
                self.state = self.program.state
            self.pub_pose.publish(PoseMsg(out.pose))
            self.updates += 1
            count = int(self.state.count)  # waits for the device
            self.pub_map.publish(PointMapMessage(
                points=self.state.points[:count]))

    def use_programs(self, graphs: bool) -> None:
        self.program = capture.Program(self._program_body, self.device,
                                       graphs)

    def _program_body(self, key) -> icp_model.IcpMapOutputs:
        p = self.program
        new, out = icp_model.update(p.state, p.inputs["scan"], self.map_cfg)
        p.copy_back(new)
        return out


@dataclasses.dataclass
class EKFLandmarkSlamNodeConfig(NodeConfig):
    topic_pose: str
    topic_observation_landmark: str
    topic_map: str
    config: Optional[dict] = None

    def ekf_config(self) -> ekf_model.EkfConfig:
        return ekf_model.EkfConfig(**(self.config or {}))

    def instantiate(self, pubsub, device) -> "EKFLandmarkSlamNode":
        return EKFLandmarkSlamNode(self, pubsub, device)


class EKFLandmarkSlamNode(Node):
    def __init__(self, config: EKFLandmarkSlamNodeConfig, pubsub, device):
        self.cfg = config
        self.device = torch.device(device)
        self.ekf_cfg = config.ekf_config()
        self.state = ekf_model.EkfState.init(self.ekf_cfg, self.device)
        self.sub = pubsub.subscribe(config.topic_observation_landmark,
                                    LandmarkOdometry)
        self.pub_pose = pubsub.publish(config.topic_pose, PoseMsg)
        self.pub_map = pubsub.publish(config.topic_map, LandmarkMapMessage)
        self.updates = 0

    def update(self) -> None:
        msg = self.sub.try_recv()
        if msg is None:
            return
        if self.program is None:
            self.state, out = ekf_model.update(self.state, msg.landmarks,
                                               msg.odometry, self.ekf_cfg)
        else:
            out = self.program("update", self.state, landmarks=msg.landmarks,
                               odometry=msg.odometry)
            self.state = self.program.state
        self.pub_pose.publish(PoseMsg(out.pose))
        self.updates += 1
        self.pub_map.publish(LandmarkMapMessage(
            means=out.landmark_means, covariances=out.landmark_covs,
            seen=out.seen))

    def use_programs(self, graphs: bool) -> None:
        self.program = capture.Program(self._program_body, self.device,
                                       graphs)

    def _program_body(self, key) -> ekf_model.EkfOutputs:
        p = self.program
        new, out = ekf_model.update(p.state, p.inputs["landmarks"],
                                    p.inputs["odometry"], self.ekf_cfg)
        p.copy_back(new)
        return out

    def correlation_matrix(self) -> np.ndarray:
        """Correlation matrix of the full state covariance:
        ``D^-1 Sigma D^-1`` with ``D = diag(sqrt(Sigma_ii))``."""
        cov = self.state.cov.cpu().numpy().astype(np.float64)
        d = np.sqrt(np.clip(np.diag(cov), 1e-30, None))
        return cov / np.outer(d, d)

    def draw(self, viz=None) -> None:
        """The correlation heat map as filled rects: green positive, red
        negative, white zero, with gaps after the pose block."""
        if viz is None:
            return
        from slamrs_tpu_torch.viz.shapes import Color, PrimitiveType

        corr = self.correlation_matrix()
        viz.begin(PrimitiveType.FILLED)
        x_offset, y_offset, size = 2.0, 0.0, 0.08
        for i in range(corr.shape[0]):
            for j in range(corr.shape[1]):
                c = float(corr[i, j])
                if c > 0.0:
                    color = Color(0.0, min(c, 1.0), 0.0)
                elif c == 0.0:
                    color = Color.WHITE
                else:
                    color = Color(min(-c, 1.0), 0.0, 0.0)
                x = x_offset + i * size + (size / 3.0 if i > 2 else 0.0)
                y = y_offset + j * size + (size / 3.0 if j > 2 else 0.0)
                viz.rect(x, y, size, size, color)
        viz.end()
