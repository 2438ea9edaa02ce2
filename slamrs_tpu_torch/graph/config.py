"""Declarative YAML node-graph configuration, without JAX.

Counterpart of ``slamrs_tpu/graph/config.py`` for the tags the fused
world reads: ``!Simulator``, ``!GridMapSlam``, ``!IcpPointMapper``,
``!EKFLandmarkSlam``, ``!Controls`` and ``!Splitter``.  They are checked
for unknown fields as in the JAX package.  Every other ``!Tag`` node
(the host graph's viewers and inputs) is kept as ``(tag, dict)`` and
ignored by :func:`slamrs_tpu_torch.graph.compile.compile_world`.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Optional

from slamrs_tpu_torch.models import ekf as ekf_model
from slamrs_tpu_torch.models import gridslam as gs_model
from slamrs_tpu_torch.models import icp_mapper as icp_model
from slamrs_tpu_torch.models import simulator as sim_model


@dataclasses.dataclass
class SimulatorNodeConfig:
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


@dataclasses.dataclass
class GridMapSlamNodeConfig:
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


@dataclasses.dataclass
class IcpPointMapperNodeConfig:
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


@dataclasses.dataclass
class EKFLandmarkSlamNodeConfig:
    topic_pose: str
    topic_observation_landmark: str
    topic_map: str
    config: Optional[dict] = None

    def ekf_config(self) -> ekf_model.EkfConfig:
        return ekf_model.EkfConfig(**(self.config or {}))


@dataclasses.dataclass
class ControlsNodeConfig:
    topic_command: str
    keyboard_enabled: bool = True
    max_speed: float = 0.1
    # rows [until_time_s, speed_left, speed_right]
    script: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class SplitterNodeConfig:
    splits: list = dataclasses.field(default_factory=list)


NODE_REGISTRY: dict[str, type] = {
    "Simulator": SimulatorNodeConfig,
    "GridMapSlam": GridMapSlamNodeConfig,
    "IcpPointMapper": IcpPointMapperNodeConfig,
    "EKFLandmarkSlam": EKFLandmarkSlamNodeConfig,
    "Controls": ControlsNodeConfig,
    "Splitter": SplitterNodeConfig,
}


@dataclasses.dataclass
class Config:
    settings: dict = dataclasses.field(default_factory=dict)
    nodes: list = dataclasses.field(default_factory=list)  # [(tag, node)]


def _build_node(tag: str, fields: Any):
    if fields is None or fields == {}:
        fields = {}
    cls = NODE_REGISTRY.get(tag)
    if cls is None:
        return fields  # a tag the fused world does not read
    if not isinstance(fields, dict):
        raise ValueError(f"!{tag} expects a mapping, got {type(fields)}")
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(fields) - names
    if unknown:
        raise ValueError(f"!{tag}: unknown fields {sorted(unknown)}")
    return cls(**fields)


def parse_config(contents: str) -> Config:
    import yaml  # only the YAML entry point needs PyYAML

    class _TaggedLoader(yaml.SafeLoader):
        pass

    def _tag(loader, tag_suffix, node):
        if isinstance(node, yaml.MappingNode):
            value = loader.construct_mapping(node, deep=True)
        elif isinstance(node, yaml.SequenceNode):
            value = loader.construct_sequence(node, deep=True)
        else:
            scalar = loader.construct_scalar(node)
            value = {} if scalar in (None, "") else scalar
        return (tag_suffix, value)

    _TaggedLoader.add_multi_constructor("!", _tag)
    raw = yaml.load(contents, Loader=_TaggedLoader)
    if raw is None:
        return Config()
    nodes = []
    for item in raw.get("nodes", []) or []:
        if not isinstance(item, tuple):
            raise ValueError(f"node entries must be !Tagged, got {item!r}")
        tag, fields = item
        nodes.append((tag, _build_node(tag, fields)))
    return Config(settings=raw.get("settings") or {}, nodes=nodes)


def load_config(path: str | Path) -> Config:
    return parse_config(Path(path).read_text())
