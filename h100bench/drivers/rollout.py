"""The rollout driver: consecutive captured cadence rollouts, as a
dataset generator runs them.

Traffic (the cell's workload file): ``ticks_per_call`` ticks a call of
``FusedWorld.rollout_cadence`` on the configuration's ``worlds`` worlds
at constant wheel speeds ``commands`` (left, right, m/s), the state
carried from call to call, each call's per-frame outputs copied to the
host.  ``sim_parameters`` overrides simulator parameters (the scan
period).  The grid-SLAM draws are inputs: ``draw_sets`` sets of every
frame's draws, made on the card from the seed at set-up and handed to
the calls in turn (``noise=``).

Set-up builds the world from the configuration's YAML, makes the draws
and the commands, and warms up with ``warm_calls`` whole calls (the
kernel library builds in the first).  The window runs calls until
``--seconds`` have passed; a call that is under way then finishes.  One
call of the window, drawn from the seed among the first
``check_calls``, is checked: its input and output states are copied to
the host around it, and after the window the reference follows the call
from the input state with the same draws.

Traced (``--trace 1``): the first call of the window profiles
``profile_frames`` frames from frame ``profile_skip`` on, by wrapping
``FrameProgram.frame`` (the same graph replays as untraced).
"""

from __future__ import annotations

import contextlib
import random
import time

import numpy as np

from h100bench import compare, harness
from h100bench.reference import world as ref_world


def _f32(v) -> float:
    return float(np.float32(v))


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        w = ctx.workload
        self.ticks = int(w["ticks_per_call"])
        self.left, self.right = (float(v) for v in w["commands"])
        self.worlds = int(ctx.config.get("worlds", 1))
        self.rng = random.Random(ctx.seed)
        self.check_call = self.rng.randrange(int(w["check_calls"]))
        self.yaml_text = ctx.config_file("yaml").read_text()

    # --- set-up ---------------------------------------------------------

    def setup(self) -> None:
        import torch

        from slamrs_tpu_torch.core.types import Command
        from slamrs_tpu_torch.graph.compile import compile_world
        from slamrs_tpu_torch.graph.config import (SimulatorNodeConfig,
                                                   parse_config)

        harness.log("the port imported")
        self.torch = torch
        dev = torch.device(self.ctx.device)
        self.dev = dev
        graph = parse_config(self.yaml_text)
        for _, node in graph.nodes:
            if isinstance(node, SimulatorNodeConfig):
                node.parameters = {**node.parameters,
                                   **self.ctx.workload.get("sim_parameters",
                                                           {})}
        self.fw = compile_world(graph, device=dev)
        shape = (self.worlds,) if self.worlds > 1 else ()
        self.state = self.fw.init(shape)
        self.commands = Command(
            torch.full((self.ticks,), _f32(self.left), dtype=torch.float32,
                       device=dev),
            torch.full((self.ticks,), _f32(self.right), dtype=torch.float32,
                       device=dev))
        self.draws = self._make_draws(shape)
        # the checked call's input and output states, copied here
        self.buffers = [compare.host_buffers(self.state) for _ in range(2)]
        harness.log("world, draws and host buffers made")
        for _ in range(int(self.ctx.workload["warm_calls"])):
            self.state, outs = self._call(self.state, self.draws[0])
            self._to_host(outs)
            self._sync()
            harness.log("warm-up call done")

    def _make_draws(self, shape) -> list:
        """``draw_sets`` sets of each frame's grid-SLAM draws (numpy
        ``eps_c``, ``eps_t`` ``[F, .., P]`` and ``u01`` ``[F, .., 1]``),
        made on the device from the seed in one call each."""
        torch = self.torch
        p = self.fw.grid_config.n_particles
        frames = ref_world.n_frames_max(self.ticks,
                                        self.fw.params.update_period)
        gen = torch.Generator(device=self.dev)
        gen.manual_seed(self.ctx.seed)
        sets = []
        for _ in range(int(self.ctx.workload["draw_sets"])):
            normal = torch.randn((2, frames, *shape, p), generator=gen,
                                 device=self.dev)
            u01 = torch.rand((frames, *shape, 1), generator=gen,
                             device=self.dev)
            sets.append((normal[0].cpu().numpy(), normal[1].cpu().numpy(),
                         u01.cpu().numpy()))
        return sets

    def _sync(self) -> None:
        if self.dev.type == "cuda":
            self.torch.cuda.synchronize()

    def _call(self, state, draws):
        """One call: on the card ``rollout_cadence`` (captured); on the
        CPU (the tests) the same frame program run without graphs."""
        from slamrs_tpu_torch.graph import capture
        from slamrs_tpu_torch.models.gridslam import UpdateNoise

        noise = UpdateNoise(*draws)
        if self.dev.type != "cuda":
            return capture.run_program(self.fw, state, self.ticks, 0,
                                       self.commands, noise=noise,
                                       graphs=False)
        return self.fw.rollout_cadence(state, self.ticks, seed=0,
                                       commands=self.commands, noise=noise)

    @staticmethod
    def _to_host(outs) -> dict:
        return {"pose": outs.pose.cpu().numpy(),
                "grid_pose": outs.grid_pose.cpu().numpy(),
                "n_eff": outs.n_eff.cpu().numpy()}

    # --- the window -------------------------------------------------------

    def window(self, seconds: float, profile) -> dict:
        from slamrs_tpu_torch.graph import capture

        calls = 0
        capture_s, call_s = [], []
        traced = profile is not None
        t0 = time.perf_counter()
        while True:
            draws = self.draws[calls % len(self.draws)]
            if calls == self.check_call:
                self.before = compare.world_to_host(self.state,
                                                    self.buffers[0])
                self.check_draws = draws
            t = time.perf_counter()
            with (_ProfiledFrames(capture.FrameProgram, profile,
                                  self.ctx.workload, self.worlds)
                  if traced and calls == 0 else contextlib.nullcontext()):
                self.state, outs = self._call(self.state, draws)
            host = self._to_host(outs)
            call_s.append(time.perf_counter() - t)
            stats = self.fw.capture_stats
            capture_s.append(stats.capture_seconds + (
                stats.ticks.capture_seconds if stats.ticks else 0.0))
            if calls == self.check_call:
                self.after = compare.world_to_host(self.state,
                                                   self.buffers[1])
                self.check_outputs = host
            calls += 1
            if time.perf_counter() - t0 >= seconds \
                    and calls > self.check_call:
                break
        self._sync()
        window_s = time.perf_counter() - t0
        harness.log("calls: " + harness.describe(call_s, 1e3, "ms"))
        return {"window_s": window_s, "world_ticks": calls * self.ticks
                * self.worlds, "attempted": calls, "failed": 0,
                "calls": calls, "capture_s_per_call": capture_s,
                "k1_sizes": self._k1_sizes()}

    def _k1_sizes(self) -> dict:
        """The sizes K1's work is counted from, as the benchmark reads
        them from its copy of the configuration."""
        cfg = compare.reference_world(self.yaml_text, self.ctx.workload,
                                      "cpu").slam
        return {"worlds": self.worlds, "particles": cfg.n_particles,
                "rows": cfg.spec.rows, "cols": cfg.spec.cols,
                "resolution": cfg.spec.resolution,
                "max_range_m": cfg.max_scan_range,
                "itemsize": 2 if cfg.grid_dtype == self.torch.bfloat16
                else 4}

    def release(self) -> None:
        """Free the program's state and graphs before the reference runs."""
        self.state = None
        self.fw = None
        import gc

        gc.collect()
        if self.dev.type == "cuda":
            self.torch.cuda.empty_cache()

    # --- the check --------------------------------------------------------

    def check(self, quantize=None) -> dict:
        """The checked call followed by the reference from its input
        state (``quantize``: the control, the reference computed one
        precision below the configuration's)."""
        values = compare.follow_and_compare(
            self.yaml_text, self.ctx.workload, self.before, self.after,
            self.check_outputs, self.check_draws, self.left, self.right,
            self.ticks, self.dev, quantize)
        return compare.compared(values, self.ctx.workload["limits"])


class _ProfiledFrames:
    """Profiles ``profile_frames`` calls of ``FrameProgram.frame`` after
    the first ``profile_skip`` of a rollout call (graph replays, once the
    first frames have been captured)."""

    def __init__(self, cls, profile, workload, worlds):
        self.cls, self.profile = cls, profile
        self.skip = int(workload["profile_skip"])
        self.n = int(workload["profile_frames"])
        self.worlds = worlds
        self.seen = 0
        self.ticks = 0

    def __enter__(self):
        orig = self.orig = self.cls.frame
        outer = self

        def frame(prog, k, *args, **kw):
            i = outer.seen
            outer.seen += 1
            if i == outer.skip:
                outer.profile.start()
            out = orig(prog, k, *args, **kw)
            if outer.skip <= i < outer.skip + outer.n:
                outer.ticks += int(k) + 1
            if i == outer.skip + outer.n - 1:
                outer.profile.stop(frames=outer.n,
                                   world_ticks=outer.ticks * outer.worlds)
            return out

        self.cls.frame = frame
        return self

    def __exit__(self, *exc):
        self.cls.frame = self.orig
        if exc[0] is None and self.profile.summary is None:
            raise RuntimeError("the profiled frames did not all run: the "
                               "call holds fewer frames than profile_skip + "
                               "profile_frames")
        return False
