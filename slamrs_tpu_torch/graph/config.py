"""Declarative YAML node-graph configuration, without JAX.

Counterpart of ``slamrs_tpu/graph/config.py``: ``settings`` plus a list
of ``!Tag``ged nodes, with the JAX package's 13 tags.  An unknown tag
raises ``ValueError("unknown node type !X")`` and an unknown field of
any tag raises, so a typo in a preset stops the load instead of being
dropped.  Each node config builds its node with ``instantiate(pubsub,
device)``; :func:`slamrs_tpu_torch.graph.compile.compile_world` reads the
simulator, controls, splitter and SLAM tags alone.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any

from slamrs_tpu_torch.graph.node import Node, NodeConfig
from slamrs_tpu_torch.graph.nodes import (  # noqa: F401 (re-exported)
    ControlsNodeConfig, EKFLandmarkSlamNodeConfig, FileLoaderNodeConfig,
    GamepadNodeConfig, GaussianTestNodeConfig, GridMapSlamNodeConfig,
    IcpPointMapperNodeConfig, MousePositionNodeConfig,
    RobotConnectionNodeConfig, ShapeTestNodeConfig, SimulatorNodeConfig,
    SplitterNodeConfig, VisualizerNodeConfig)

NODE_REGISTRY: dict[str, type] = {
    "Simulator": SimulatorNodeConfig,
    "Controls": ControlsNodeConfig,
    "Gamepad": GamepadNodeConfig,
    "MousePosition": MousePositionNodeConfig,
    "ShapeTest": ShapeTestNodeConfig,
    "FileLoader": FileLoaderNodeConfig,
    "RobotConnection": RobotConnectionNodeConfig,
    "IcpPointMapper": IcpPointMapperNodeConfig,
    "Visualizer": VisualizerNodeConfig,
    "GridMapSlam": GridMapSlamNodeConfig,
    "GaussianTest": GaussianTestNodeConfig,
    "Splitter": SplitterNodeConfig,
    "EKFLandmarkSlam": EKFLandmarkSlamNodeConfig,
}


@dataclasses.dataclass
class Config:
    settings: dict = dataclasses.field(default_factory=dict)
    nodes: list = dataclasses.field(default_factory=list)  # [(tag, config)]

    def instantiate_nodes(self, pubsub, device) -> list[Node]:
        return [cfg.instantiate(pubsub, device) for _, cfg in self.nodes]


def _build_node(tag: str, fields: Any) -> NodeConfig:
    cls = NODE_REGISTRY.get(tag)
    if cls is None:
        raise ValueError(f"unknown node type !{tag}")
    if fields is None or fields == {}:
        fields = {}
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
