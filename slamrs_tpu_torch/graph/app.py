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

On a CUDA device the frame runs on one side stream, and each node's
device update is a captured CUDA graph (``graph/capture.Program``; the
JAX nodes' ``jax.jit``): the first update of each kind runs op by op
and is captured, every later one is a replay.  The simulator has an
idle-tick and a firing-tick graph; grid SLAM an update graph and a
probability-map graph; the ICP mapper and the EKF one update graph each.
Messages that leave a graph are copies: device observations are cloned,
and pose and map messages start their host copy right after the replay,
on the same stream.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Optional

import torch

from slamrs_tpu_torch.graph.capture import on_capture_stream
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
    """``capture``: None runs the nodes' device updates as captured CUDA
    graphs on a CUDA device and op by op elsewhere; True captures and
    raises on the CPU; False runs them op by op.  Captured and op by op
    give the same bits."""

    def __init__(self, config: Config, frame_dt: float = 1.0 / 30.0,
                 realtime: bool = False, with_renderer: bool = False,
                 device="cuda", capture: Optional[bool] = None):
        self.device = check_device(device)
        on_cuda = self.device.type == "cuda"
        if capture is True and not on_cuda:
            raise ValueError("App(capture=True) needs a CUDA device, got "
                             f"{self.device}")
        # the nodes' mode: None op by op, else use_programs(graphs)
        self._graphs = True if capture is not False and on_cuda else None
        self.pubsub = PubSub()
        self.config = config
        self.nodes = self._instantiate()
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

    def _instantiate(self) -> list:
        nodes = self.config.instantiate_nodes(self.pubsub, self.device)
        if self._graphs is not None:
            for n in nodes:
                n.use_programs(self._graphs)
        return nodes

    def use_programs(self, graphs: bool = True) -> None:
        """Run the nodes' device updates through their programs from the
        next frame on: captured CUDA graphs with ``graphs`` (CUDA only),
        else the same programs uncaptured, on any device (the CPU tests
        hold them to the op-by-op nodes)."""
        self._graphs = graphs
        for n in self.nodes:
            n.use_programs(graphs)

    def program_stats(self) -> dict:
        """Each node program's ``capture.ProgramStats``, by node class."""
        return {type(n).__name__: n.program.stats for n in self.nodes
                if n.program is not None}

    def frame(self) -> None:
        """One app frame, on the device's capture stream
        (``graph/capture.on_capture_stream``)."""
        with self.frame_stats.timeit(), on_capture_stream(self.device):
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
        self.nodes = self._instantiate()
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
