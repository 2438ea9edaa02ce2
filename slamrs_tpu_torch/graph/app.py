"""Headless application shell: the frame loop that drives a node graph.

Counterpart of ``slamrs_tpu/graph/app.py``.  One frame: tick the pub/sub
distributor, advance the time-based nodes (the simulator, the controls'
clock) by ``frame_dt``, tick, run every node's ``update``, tick, then
(with a renderer) every node's ``draw``.  A ``!Controls`` command made in
``update`` therefore reaches the simulator one frame later, as in the
JAX package's App.

Time is virtual by default (every frame advances ``frame_dt`` seconds, a
deterministic headless run); ``realtime=True`` paces frames against the
wall clock.  The nodes run on ``device``, which defaults to ``cuda`` and
never falls back: without CUDA the App raises, and the CPU runs only
when asked for (``device="cpu"``).  Every torch operation runs on the
thread that calls :meth:`App.frame`.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Optional

import torch

from slamrs_tpu_torch.graph.config import Config, load_config, parse_config
from slamrs_tpu_torch.graph.pubsub import PubSub
from slamrs_tpu_torch.utils import PerfStats


def check_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device without CUDA
    raises instead of falling back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device cuda asked for but CUDA is not available "
                           "(ask for the cpu device to run the plain "
                           "versions)")
    return device


class App:
    def __init__(self, config: Config, frame_dt: float = 1.0 / 30.0,
                 realtime: bool = False, with_renderer: bool = False,
                 device="cuda"):
        self.device = check_device(device)
        self.pubsub = PubSub()
        self.config = config
        self.nodes = config.instantiate_nodes(self.pubsub, self.device)
        self.frame_dt = frame_dt
        self.realtime = realtime
        self.frame_stats = PerfStats()
        self.time = 0.0
        # the world renderer handed to the nodes' draw hooks; headless runs
        # without it skip all vertex work
        self.renderer = None
        self.world_obj = None
        if with_renderer:
            from slamrs_tpu_torch.viz.shapes import ShapeRenderer, WorldObj

            self.renderer = ShapeRenderer()
            self.world_obj = WorldObj(self.renderer)

    @staticmethod
    def from_file(path: str, **kwargs) -> "App":
        return App(load_config(path), **kwargs)

    @staticmethod
    def from_yaml(contents: str, **kwargs) -> "App":
        return App(parse_config(contents), **kwargs)

    def frame(self) -> None:
        """One app frame."""
        with self.frame_stats.timeit():
            self.pubsub.tick()
            for n in self.nodes:
                advance = getattr(n, "advance", None)
                if advance is not None:
                    advance(self.frame_dt)
            self.pubsub.tick()
            for n in self.nodes:
                n.update()
            self.pubsub.tick()
            if self.renderer is not None:
                # immediate mode: drop the previous frame's geometry, so
                # draw calls never pile up across frames
                self.renderer.flush()
                for n in self.nodes:
                    n.draw(self.world_obj)
        self.time += self.frame_dt

    def run(self, frames: Optional[int] = None,
            duration_s: Optional[float] = None) -> None:
        if frames is None:
            frames = int(round((duration_s or 1.0) / self.frame_dt))
        for _ in range(frames):
            t0 = time.perf_counter()
            self.frame()
            if self.realtime:
                sleep = self.frame_dt - (time.perf_counter() - t0)
                if sleep > 0:
                    time.sleep(sleep)

    def apply_config(self, contents: str) -> None:
        """Swap the graph: terminate every node and build the new YAML's
        graph on a fresh PubSub (all node state is discarded)."""
        for n in self.nodes:
            n.terminate()
        self.config = parse_config(contents)
        self.pubsub = PubSub()
        self.nodes = self.config.instantiate_nodes(self.pubsub, self.device)
        self.time = 0.0

    @staticmethod
    def presets() -> dict:
        """The bundled presets of ``configs/``, by name."""
        preset_dir = Path(__file__).resolve().parents[2] / "configs"
        return {p.stem: p.read_text()
                for p in sorted(preset_dir.glob("*.yaml"))}

    def node(self, cls):
        """The first node of class ``cls``, or None."""
        for n in self.nodes:
            if isinstance(n, cls):
                return n
        return None

    def terminate(self) -> None:
        for n in self.nodes:
            n.terminate()
