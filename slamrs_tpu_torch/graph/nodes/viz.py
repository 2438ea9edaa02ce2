"""Headless visualizer node: draws topic values through the shape
renderer, and saves them.

Counterpart of ``slamrs_tpu/graph/nodes/viz.py``, with the same YAML
``topics:`` list (``!GridMap``, ``!Observation``, ``!Pose``,
``!PointMap``, ``!LandmarkObservation``, ``!LandmarkMap``), each topic's
``config`` fields with their defaults (an unknown field raises), the
``topic_pose`` subscription and the constant ``pose:``.  Dense rect
fields (grid cells, point markers) are one batched draw call.  Gridlines
span the map's own extent.

The node keeps each topic's latest message as it came: tensors (a scan)
and pending host copies (a pose, a map) go to the host only when the
topic is drawn or saved.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import numpy as np

import torch

from slamrs_tpu_torch.graph.node import (GridMapMessage, LandmarkMapMessage,
                                         LandmarkOdometry, Node, NodeConfig,
                                         PointMapMessage, PoseMsg,
                                         ScanOdometry)

# per-kind config defaults
def _np(x, dtype=None) -> np.ndarray:
    """``x`` (a tensor on any device, or array-like) as a numpy array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


_DEFAULTS = {
    "Pose": {"color": [0.0, 1.0, 0.0], "radius": 0.1},
    "Observation": {"draw_lines": True, "size": 0.01,
                    "point_color": [0.0, 0.0, 0.0]},
    "PointMap": {"size": 0.01, "point_color": [0.0, 0.0, 0.0]},
    "GridMap": {"gridlines": False},
    "LandmarkObservation": {"radius": 0.02, "color": [0.0, 0.0, 0.0]},
    "LandmarkMap": {"p": 0.95},
}


@dataclasses.dataclass
class VisualizerNodeConfig(NodeConfig):
    topics: list = dataclasses.field(default_factory=list)

    def instantiate(self, pubsub, device) -> "VisualizerNode":
        return VisualizerNode(self, pubsub)


class _TopicViz:
    def __init__(self, kind: str, fields: dict, pubsub):
        self.kind = kind
        if kind not in _DEFAULTS:
            raise ValueError(f"unknown visualizer topic kind {kind!r}")
        self.config = dict(_DEFAULTS[kind])
        given = fields.get("config") or {}
        unknown = set(given) - set(self.config)
        if unknown:
            raise ValueError(
                f"unknown config fields {sorted(unknown)} for "
                f"!{kind} visualizer topic")
        self.config.update(given)
        self.topic = fields["topic"]
        self.sub = pubsub.subscribe(self.topic)
        # secondary: a pose subscription (frame_viz.rs
        # SecondaryValue::Subscription) or a constant pose (::Constant)
        self.pose_sub = (pubsub.subscribe(fields["topic_pose"])
                         if fields.get("topic_pose") else None)
        self.latest: Optional[Any] = None
        # a PoseMsg, a pose tensor, or the constant pose as numpy
        self.latest_pose: Optional[Any] = None
        if fields.get("pose") is not None:
            self.latest_pose = np.asarray(fields["pose"], np.float32)

    def update(self):
        v = self.sub.latest()
        if v is not None:
            self.latest = v
        if self.pose_sub is not None:
            p = self.pose_sub.latest()
            if p is not None:
                self.latest_pose = p

    def pose(self) -> Optional[np.ndarray]:
        """The secondary pose as f32[3] numpy, or None."""
        p = self.latest_pose
        if p is None:
            return None
        return _np(p.pose if isinstance(p, PoseMsg) else p, np.float32)

    # ---- rendering ------------------------------------------------------

    def emit(self, sr) -> None:
        from slamrs_tpu_torch.viz.shapes import Color, PrimitiveType

        m = self.latest
        if m is None:
            return
        c = self.config
        if self.kind == "Pose" and isinstance(m, PoseMsg):
            x, y, th = _np(m.pose, np.float32)
            sr.begin(PrimitiveType.FILLED)
            sr.arrow(float(x), float(y), float(th), c["radius"],
                     Color(*c["color"]))
            sr.end()
        elif self.kind == "Observation":
            # Splitter outputs carry a bare Scan; the tuple topic carries
            # ScanOdometry — accept both (the reference subscribes the
            # Observation half only, visualize.rs:112)
            scan = m.scan if isinstance(m, ScanOdometry) else m
            if getattr(scan, "angles", None) is not None:
                self._emit_observation(sr, scan)
        elif self.kind == "PointMap" and isinstance(m, PointMapMessage):
            pts = _np(m.points, np.float32)
            if len(pts):
                s = c["size"]
                sr.begin(PrimitiveType.FILLED)
                sr.rects_batch(pts - s / 2.0, s, s,
                               np.asarray(list(c["point_color"]) + [1.0]))
                sr.end()
        elif self.kind == "GridMap" and isinstance(m, GridMapMessage):
            self._emit_gridmap(sr, m)
        elif self.kind == "LandmarkObservation":
            lm = m.landmarks if isinstance(m, LandmarkOdometry) else m
            if getattr(lm, "angles", None) is not None:
                self._emit_landmark_obs(sr, lm)
        elif self.kind == "LandmarkMap" and isinstance(m,
                                                       LandmarkMapMessage):
            for i in range(len(m.means)):
                if m.seen is None or m.seen[i]:
                    sr.gaussian2d_confidence(m.means[i], m.covariances[i],
                                             c["p"])

    def _emit_observation(self, sr, scan) -> None:
        """Rays (valid black, invalid red) + endpoint markers
        (visualize.rs:112-165)."""
        from slamrs_tpu_torch.viz.shapes import Color, PrimitiveType

        angles = _np(scan.angles, np.float32)
        dist = _np(scan.distances, np.float32)
        valid = _np(scan.valid, bool)
        present = (_np(scan.present, bool)
                   if getattr(scan, "present", None) is not None
                   else np.ones_like(valid))
        pose = self.pose()
        if pose is not None:
            ox, oy, oth = (float(v) for v in pose[:3])
        else:
            ox = oy = oth = 0.0
        ex = ox + np.cos(angles + oth) * dist
        ey = oy + np.sin(angles + oth) * dist
        keep = present
        c = self.config
        if c["draw_lines"]:
            n = int(keep.sum())
            segs = np.empty((n, 2, 2), np.float32)
            segs[:, 0, 0] = ox
            segs[:, 0, 1] = oy
            segs[:, 1, 0] = ex[keep]
            segs[:, 1, 1] = ey[keep]
            cols = np.where(valid[keep][:, None],
                            np.float32([0, 0, 0, 1]),
                            np.float32([1, 0, 0, 1]))
            sr.begin(PrimitiveType.LINE)
            sr.lines_batch(segs, cols)
            sr.end()
        s = c["size"]
        pts = np.stack([ex[keep] - s / 2.0, ey[keep] - s / 2.0], -1)
        sr.begin(PrimitiveType.FILLED)
        sr.rects_batch(pts, s, s,
                       np.asarray(list(c["point_color"]) + [1.0]))
        sr.end()

    def _emit_gridmap(self, sr, m: GridMapMessage) -> None:
        """Per-cell grayscale rect field + optional gridlines
        (visualize.rs:243-283)."""
        from slamrs_tpu_torch.viz.shapes import Color, PrimitiveType

        data = _np(m.data, np.float32)
        h, w = data.shape
        res = float(m.resolution)
        px, py = float(m.position[0]), float(m.position[1])
        ys, xs = np.mgrid[0:h, 0:w]
        xy = np.stack([px + xs.ravel() * res, py + ys.ravel() * res], -1)
        g = 1.0 - data.ravel()
        cols = np.stack([g, g, g, np.ones_like(g)], -1)
        sr.begin(PrimitiveType.FILLED)
        sr.rects_batch(xy, res, res, cols)
        sr.end()
        if self.config["gridlines"]:
            sr.begin(PrimitiveType.LINE)
            for x in range(w):
                sr.line(px + x * res, py, px + x * res, py + h * res,
                        Color.BLACK)
            for y in range(h):
                sr.line(px, py + y * res, px + w * res, py + y * res,
                        Color.BLACK)
            sr.end()

    def _emit_landmark_obs(self, sr, lm) -> None:
        """Filled circles at pose-relative polar landmarks
        (visualize.rs:320-345) — skipped without a pose, like the
        reference."""
        from slamrs_tpu_torch.viz.shapes import Color, PrimitiveType

        pose = self.pose()
        if pose is None:
            return
        ox, oy, oth = (float(v) for v in pose[:3])
        ang = _np(lm.angles, np.float32) + oth
        d = _np(lm.distances, np.float32)
        valid = (_np(lm.valid, bool)
                 if getattr(lm, "valid", None) is not None
                 else np.ones_like(d, bool))
        c = self.config
        sr.begin(PrimitiveType.FILLED)
        for a, dd in zip(ang[valid], d[valid]):
            sr.circle(ox + dd * math.cos(a), oy + dd * math.sin(a),
                      c["radius"], Color(*c["color"]))
        sr.end()


class VisualizerNode(Node):
    def __init__(self, config: VisualizerNodeConfig, pubsub):
        self.viz: list[_TopicViz] = []
        for t in config.topics:
            tag, fields = t if isinstance(t, tuple) else (t.get("_tag"), t)
            self.viz.append(_TopicViz(tag, fields, pubsub))

    def update(self) -> None:
        for v in self.viz:
            v.update()

    def draw(self, viz: Optional[Any] = None) -> None:
        """Emit every topic's geometry into the app's shape renderer
        (FrameVizualizer::draw, frame_viz.rs:200-215) — composes with
        other nodes' draw hooks (e.g. the simulator's scene/pose)."""
        if viz is None:
            return
        for v in self.viz:
            v.emit(viz.sr)

    def latest(self, topic: str):
        for v in self.viz:
            if v.topic == topic:
                return v.latest
        return None

    def save_npz(self, path: str) -> None:
        arrays = {}
        for v in self.viz:
            key = v.topic.replace("/", "_")
            m = v.latest
            if isinstance(m, GridMapMessage):
                arrays[f"{key}_grid"] = m.data
                arrays[f"{key}_position"] = m.position
                arrays[f"{key}_resolution"] = np.float32(m.resolution)
            elif isinstance(m, PointMapMessage):
                arrays[f"{key}_points"] = m.points
            elif isinstance(m, PoseMsg):
                arrays[f"{key}_pose"] = m.pose
            elif isinstance(m, LandmarkMapMessage):
                arrays[f"{key}_means"] = m.means
                arrays[f"{key}_covs"] = m.covariances
        np.savez(path, **arrays)

    def render_png(self, path: str) -> None:
        """Standalone rasterization of this node's topics (the CLI's
        ``--png`` additionally composes the other nodes' draw hooks
        through the app renderer)."""
        from slamrs_tpu_torch.viz.shapes import ShapeRenderer, render_draw_calls

        sr = ShapeRenderer()
        for v in self.viz:
            v.emit(sr)
        render_draw_calls(sr.flush(), path)
