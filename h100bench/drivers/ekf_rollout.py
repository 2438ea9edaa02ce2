"""The EKF rollout driver: consecutive captured cadence rollouts of a fleet
of worlds that run EKF landmark SLAM alone (a simulator with its landmark
sensor and an ``!EKFLandmarkSlam``), as a dataset generator runs them.

Traffic (the cell's workload file): ``ticks_per_call`` ticks a call of
``FusedWorld.rollout_cadence`` on the configuration's ``worlds`` worlds
at constant wheel speeds ``commands`` (left, right, m/s), the state
carried from call to call, each call's per-frame true and EKF poses and
the filters' ``seen`` flags after it copied to the host.
``sim_parameters`` overrides simulator parameters.  The landmark
sensor's draws are inputs: ``draw_sets`` sets of every frame's bearing
and range normals (``[F, W, L]`` each), made on the card from the seed
at set-up and handed to the calls in turn (``landmark_noise=``).  The
seed also draws each world's start, its heading uniform and its position
uniform within ``start_radius_m`` of the origin, written into the true
pose and into the filter's pose (whose covariance is zero: a known
start), so that the worlds see different landmarks.

Set-up builds the fleet from the configuration's YAML, puts each world
at its start, makes the draws and warms up with ``warm_calls`` whole
calls.  The window runs calls until ``--seconds`` have passed; a call
that is under way then finishes.  One call of the window, drawn from the
seed among the first ``check_calls``, is checked: its input and output
states are copied to the host around it, and after the window the
reference (``reference/ekf.py``) follows the call from the input state
with the same draws.

Traced (``--trace 1``): the first call of the window profiles
``profile_frames`` frames from frame ``profile_skip`` on, as the
``rollout`` driver does, and the window runs at least
``CALLS_AFTER_PROFILE`` calls after it, as ``drivers/icp_rollout.py``
does.  The record carries the rollout driver's keys, ``ekf_sizes``
(worlds, the filter's dimension, the sensor's lanes) and
``valid_lanes_per_frame``: the lanes the sensor saw in the window's
first call a frame, counted on the host from the call's true poses (what
the port's ``ekf.corrections`` counts on the device).

The window loop is the ``rollout`` driver's with this compare module,
these outputs and the traced window's extra calls; the two cannot share
one body without an edit to ``drivers/rollout.py``.
"""

from __future__ import annotations

import contextlib
import math
import time

import numpy as np

from h100bench import compare, ekf_compare, harness
from h100bench.drivers import rollout
from h100bench.drivers.rollout import _f32, _ProfiledFrames
from h100bench.reference import ekf as ref_ekf
from h100bench.reference import world as ref_world

CALLS_AFTER_PROFILE = 8


class Driver(rollout.Driver):
    def __init__(self, ctx):
        super().__init__(ctx)
        r = float(ctx.workload["start_radius_m"])
        starts = []
        for _ in range(self.worlds):
            radius = r * math.sqrt(self.rng.random())
            bearing = self.rng.uniform(-math.pi, math.pi)
            starts.append((radius * math.cos(bearing),
                           radius * math.sin(bearing),
                           self.rng.uniform(-math.pi, math.pi)))
        self.starts = np.asarray(starts, np.float32)
        self.shape = (self.worlds,) if self.worlds > 1 else ()

    # --- set-up ---------------------------------------------------------

    def setup(self) -> None:
        import torch

        from slamrs_tpu_torch.core.types import Command
        from slamrs_tpu_torch.graph.compile import compile_world
        from slamrs_tpu_torch.graph.config import (SimulatorNodeConfig,
                                                   parse_config)

        harness.log("the port imported")
        self.torch = torch
        dev = self.dev = torch.device(self.ctx.device)
        graph = parse_config(self.yaml_text)
        for _, node in graph.nodes:
            if isinstance(node, SimulatorNodeConfig):
                node.parameters = {**node.parameters,
                                   **self.ctx.workload.get("sim_parameters",
                                                           {})}
        self.fw = compile_world(graph, device=dev)
        if self.fw.ekf_config is None or self.fw.grid_config is not None \
                or self.fw.icp_config is not None:
            raise ValueError("the ekf_rollout driver runs worlds with EKF "
                             "landmark SLAM alone")
        state = self.fw.init(self.shape)
        start = torch.from_numpy(self.starts.reshape(*self.shape, 3)).to(dev)
        self.state = state._replace(pose=start.clone(), ekf=state.ekf._replace(
            mean=torch.cat([start, state.ekf.mean[..., 3:]], -1)))
        self.commands = Command(
            torch.full((self.ticks,), _f32(self.left), dtype=torch.float32,
                       device=dev),
            torch.full((self.ticks,), _f32(self.right), dtype=torch.float32,
                       device=dev))
        self.draws = self._make_draws(self.shape)
        self.ref_world = ekf_compare.reference_world(
            self.yaml_text, self.ctx.workload, "cpu")
        # the checked call's input and output states, copied here
        self.buffers = [ekf_compare.host_buffers(self.state)
                        for _ in range(2)]
        harness.log(f"{self.worlds} worlds made, starts within "
                    f"{self.ctx.workload['start_radius_m']} m")
        for i in range(int(self.ctx.workload["warm_calls"])):
            self.state, outs = self._call(self.state,
                                          self.draws[i % len(self.draws)])
            self._outputs_to_host(outs)
            harness.log("warm-up call done")

    def _make_draws(self, shape) -> list:
        """``draw_sets`` sets of each frame's landmark draws (numpy
        ``noise_a``, ``noise_d`` ``[F, .., L]``), made on the device from
        the seed in one call each."""
        torch = self.torch
        lanes = self.fw.scene.landmarks.shape[-2]
        frames = ref_world.n_frames_max(self.ticks,
                                        self.fw.params.update_period)
        gen = torch.Generator(device=self.dev)
        gen.manual_seed(self.ctx.seed)
        sets = []
        for _ in range(int(self.ctx.workload["draw_sets"])):
            normal = torch.randn((2, frames, *shape, lanes), generator=gen,
                                 device=self.dev)
            sets.append((normal[0].cpu().numpy(), normal[1].cpu().numpy()))
        return sets

    def _call(self, state, draws):
        """One call: on the card ``rollout_cadence`` (captured); on the
        CPU (the tests) the same frame program run without graphs."""
        from slamrs_tpu_torch.graph import capture

        if self.dev.type != "cuda":
            return capture.run_program(self.fw, state, self.ticks, 0,
                                       self.commands, landmark_noise=draws,
                                       graphs=False)
        return self.fw.rollout_cadence(state, self.ticks, seed=0,
                                       commands=self.commands,
                                       landmark_noise=draws)

    def _outputs_to_host(self, outs) -> dict:
        return {"pose": outs.pose.cpu().numpy(),
                "ekf_pose": outs.ekf_pose.cpu().numpy(),
                "seen": self.state.ekf.seen.cpu().numpy()}

    def _valid_lanes(self, poses) -> float:
        """The lanes the sensor sees from the frames' true poses
        (``[F, .., 3]``), a frame, counted on the host."""
        t = self.torch.from_numpy(poses)
        return float(ref_ekf.valid_lanes(t, self.ref_world).sum()) \
            / t.shape[0]

    # --- the window -------------------------------------------------------

    def window(self, seconds: float, profile) -> dict:
        from slamrs_tpu_torch.graph import capture

        calls = 0
        capture_s, call_s = [], []
        traced = profile is not None
        least = 1 + (CALLS_AFTER_PROFILE if traced else 0)
        valid = None
        t0 = time.perf_counter()
        while True:
            draws = self.draws[calls % len(self.draws)]
            if calls == self.check_call:
                self.before = ekf_compare.world_to_host(self.state,
                                                        self.buffers[0])
                self.check_draws = draws
            t = time.perf_counter()
            with (_ProfiledFrames(capture.FrameProgram, profile,
                                  self.ctx.workload, self.worlds)
                  if traced and calls == 0 else contextlib.nullcontext()):
                self.state, outs = self._call(self.state, draws)
            host = self._outputs_to_host(outs)
            call_s.append(time.perf_counter() - t)
            capture_s.append(self.fw.capture_stats.capture_seconds)
            if calls == 0:
                valid = self._valid_lanes(host["pose"])
            if calls == self.check_call:
                self.after = ekf_compare.world_to_host(self.state,
                                                       self.buffers[1])
                self.check_outputs = host
            calls += 1
            if time.perf_counter() - t0 >= seconds \
                    and calls > self.check_call and calls >= least:
                break
        self._sync()
        window_s = time.perf_counter() - t0
        harness.log("calls: " + harness.describe(call_s, 1e3, "ms"))
        harness.log(f"the first call's valid lanes a frame, counted on the "
                    f"host: {valid}")
        cfg = self.fw.ekf_config
        return {"window_s": window_s, "world_ticks": calls * self.ticks
                * self.worlds, "attempted": calls, "failed": 0,
                "calls": calls, "capture_s_per_call": capture_s,
                "ekf_sizes": {"worlds": self.worlds, "dim": cfg.dim,
                              "lanes": int(self.fw.scene.landmarks
                                           .shape[-2])},
                "valid_lanes_per_frame": valid}

    # --- the check --------------------------------------------------------

    def check(self, quantize=None, control=None) -> dict:
        """The checked call followed by the reference from its input state
        (``quantize``: the control with the filter held in that dtype;
        ``control``: ``"reorder"`` or ``"tf32"``, ``ekf_compare``'s)."""
        t = time.perf_counter()
        values = ekf_compare.follow_and_compare(
            self.yaml_text, self.ctx.workload, self.before, self.after,
            self.check_outputs, self.check_draws, self.left, self.right,
            self.ticks, self.dev, quantize, control)
        harness.log(f"the reference followed the call and compared in "
                    f"{time.perf_counter() - t:.1f} s")
        return compare.compared(values, self.ctx.workload["limits"])
