"""The tiled rollout driver: the ``rollout`` driver's traffic on one world
whose maps are a tile pool (a map set over the port's 1 GiB rule, left to
auto, or ``resample_cow: "tiled"``), updated by K3.

Traffic, set-up, warm-up and the window's loop are those of
``drivers/rollout.py``: consecutive captured ``rollout_cadence`` calls of
``ticks_per_call`` ticks at constant wheel speeds, the state carried,
the grid-SLAM draws injected.  What differs:

* set-up raises unless the world's state holds a ``tile_table``;
* the pinned host buffers hold the pool and the table, and the checked
  call's input and output states are copied whole (2.35 GB each at
  config 3).  The seconds those two copies take are kept out of the
  window's clock: ``window_s`` is its wall time less them;
* traced, the port's device counters are read at the profile's start
  and stop, each after a synchronize and outside the profile, so that
  the summary holds the bands K3 privatized over the profiled frames
  (``tiles_copied``; absent where the port has no ``k3.tiles_copied``);
* the record carries ``k3_sizes`` (K3's sizes, from the benchmark's copy
  of the configuration); K1 does not run here;
* the check is ``reference/tiled.py``'s.
"""

from __future__ import annotations

import contextlib
import time

import torch

from h100bench import compare, harness
from h100bench.drivers import rollout
from h100bench.drivers.rollout import _f32, _ProfiledFrames
from h100bench.reference import tiled

_GRID = ("poses", "grids", "weights", "best_pose", "best_idx", "ancestors",
         "tile_table")


def host_buffers(state) -> dict:
    """Host tensors shaped as a tiled ``WorldState``'s, pinned when the
    state is on a card."""
    def like(t):
        return torch.empty(t.shape, dtype=t.dtype, pin_memory=t.is_cuda)

    return {"world": {n: like(getattr(state, n)) for n in compare._WORLD},
            "grid": {n: like(getattr(state.grid, n)) for n in _GRID}}


def world_to_host(state, into: dict) -> dict:
    """A tiled ``WorldState`` copied into :func:`host_buffers` ``into``."""
    for n in compare._WORLD:
        into["world"][n].copy_(getattr(state, n))
    for n in _GRID:
        into["grid"][n].copy_(getattr(state.grid, n))
    return {**into["world"], "timer": float(state.scan_timer),
            "grid": into["grid"]}


def tiles_copied(dev) -> int | None:
    """The port's device counter ``k3.tiles_copied`` once the device's
    work is done; None where the port has no such counter."""
    from slamrs_tpu_torch.utils import trace

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    counts = getattr(trace, "device_counts", None)
    return None if counts is None else counts().get("k3.tiles_copied")


class _CountingProfile:
    """A profile whose summary also holds the bands K3 privatized between
    its start and its stop (``tiles_copied``)."""

    def __init__(self, profile, dev):
        self.profile, self.dev = profile, dev
        self.before = None

    @property
    def summary(self):
        return self.profile.summary

    def start(self) -> None:
        self.before = tiles_copied(self.dev)
        self.profile.start()

    def stop(self, **counts) -> dict:
        summary = self.profile.stop(**counts)
        after = tiles_copied(self.dev)
        if after is not None and self.before is not None:
            summary["tiles_copied"] = after - self.before
        return summary


class Driver(rollout.Driver):
    # --- set-up ---------------------------------------------------------

    def setup(self) -> None:
        from slamrs_tpu_torch.core.types import Command
        from slamrs_tpu_torch.graph.compile import compile_world
        from slamrs_tpu_torch.graph.config import (SimulatorNodeConfig,
                                                   parse_config)

        harness.log("the port imported")
        self.torch = torch
        dev = self.dev = torch.device(self.ctx.device)
        if self.worlds != 1:
            raise ValueError("the tiled_rollout driver runs one world")
        graph = parse_config(self.yaml_text)
        for _, node in graph.nodes:
            if isinstance(node, SimulatorNodeConfig):
                node.parameters = {**node.parameters,
                                   **self.ctx.workload.get("sim_parameters",
                                                           {})}
        self.fw = compile_world(graph, device=dev)
        self.state = self.fw.init()
        if self.state.grid is None or self.state.grid.tile_table is None:
            raise ValueError("the configuration's maps are not a tile pool: "
                             "the tiled_rollout driver needs a tile_table")
        self.commands = Command(
            torch.full((self.ticks,), _f32(self.left), dtype=torch.float32,
                       device=dev),
            torch.full((self.ticks,), _f32(self.right), dtype=torch.float32,
                       device=dev))
        self.draws = self._make_draws(())
        self.buffers = [host_buffers(self.state) for _ in range(2)]
        harness.log(f"world, draws and host buffers made; pool "
                    f"{list(self.state.grid.grids.shape)} "
                    f"{self.state.grid.grids.dtype}")
        for _ in range(int(self.ctx.workload["warm_calls"])):
            self.state, outs = self._call(self.state, self.draws[0])
            self._to_host(outs)
            self._sync()
            harness.log("warm-up call done")

    # --- the window -------------------------------------------------------

    def window(self, seconds: float, profile) -> dict:
        from slamrs_tpu_torch.graph import capture

        calls = 0
        capture_s, call_s = [], []
        copy_s = 0.0
        traced = profile is not None
        t0 = time.perf_counter()
        while True:
            draws = self.draws[calls % len(self.draws)]
            if calls == self.check_call:
                t = time.perf_counter()
                self.before = world_to_host(self.state, self.buffers[0])
                copy_s += time.perf_counter() - t
                self.check_draws = draws
            t = time.perf_counter()
            with (_ProfiledFrames(capture.FrameProgram,
                                  _CountingProfile(profile, self.dev),
                                  self.ctx.workload, 1)
                  if traced and calls == 0 else contextlib.nullcontext()):
                self.state, outs = self._call(self.state, draws)
            host = self._to_host(outs)
            call_s.append(time.perf_counter() - t)
            stats = self.fw.capture_stats
            capture_s.append(stats.capture_seconds + (
                stats.ticks.capture_seconds if stats.ticks else 0.0))
            if calls == self.check_call:
                t = time.perf_counter()
                self.after = world_to_host(self.state, self.buffers[1])
                copy_s += time.perf_counter() - t
                self.check_outputs = host
            calls += 1
            if time.perf_counter() - t0 - copy_s >= seconds \
                    and calls > self.check_call:
                break
        self._sync()
        window_s = time.perf_counter() - t0 - copy_s
        harness.log("calls: " + harness.describe(call_s, 1e3, "ms"))
        harness.log(f"the checked call's two state copies took {copy_s:.3f} "
                    f"s, outside the window's {window_s:.3f} s")
        return {"window_s": window_s, "world_ticks": calls * self.ticks,
                "attempted": calls, "failed": 0, "calls": calls,
                "capture_s_per_call": capture_s, "copy_s": copy_s,
                "k3_sizes": self._k3_sizes()}

    def _k3_sizes(self) -> dict:
        """The sizes K3's work is counted from, as the benchmark reads
        them from its copy of the configuration."""
        cfg = tiled.reference_world(self.yaml_text, self.ctx.workload,
                                    "cpu").slam
        return {"particles": cfg.n_particles, "rows": cfg.spec.rows,
                "cols": cfg.spec.cols, "resolution": cfg.spec.resolution,
                "max_range_m": cfg.max_scan_range,
                "itemsize": 2 if cfg.grid_dtype == torch.bfloat16 else 4}

    # --- the check --------------------------------------------------------

    def check(self, quantize=None) -> dict:
        """The checked call followed by the reference from its input
        state, materialized (``quantize``: the control, the reference
        computed one precision below the configuration's maps)."""
        t = time.perf_counter()
        values = tiled.follow_and_compare(
            self.yaml_text, self.ctx.workload, self.before, self.after,
            self.check_outputs, self.check_draws, self.left, self.right,
            self.ticks, self.dev, quantize)
        harness.log(f"the reference followed the call and compared in "
                    f"{time.perf_counter() - t:.1f} s")
        return compare.compared(values, self.ctx.workload["limits"])
