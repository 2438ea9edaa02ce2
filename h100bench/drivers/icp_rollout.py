"""The ICP rollout driver: consecutive captured cadence rollouts of a world
that runs ICP odometry alone (a simulator and an ``!IcpPointMapper``).

Traffic (the cell's workload file): ``ticks_per_call`` ticks a call of
``FusedWorld.rollout_cadence`` on one world at constant wheel speeds
``commands`` (left, right, m/s), the state carried from call to call,
each call's per-frame true and ICP poses copied to the host.
``sim_parameters`` overrides simulator parameters.  Nothing is drawn
inside a call: ICP and the lidar are deterministic.  The seed draws the
robot's start, its heading uniform and its position uniform within
``start_radius_m`` of the origin, the simulator's own start, so that
seeds differ in trajectory and map.

Set-up builds the world from the configuration's YAML, puts the robot
at its start and warms up with ``warm_calls`` whole calls (the kernel
library builds in the first, and the map fills).  The window runs calls
until ``--seconds`` have passed; a call that is under way then
finishes.  Every window call runs on the full map: the driver raises if
the map holds fewer points than the mapper's capacity when the window
starts (a map's count never falls, so the checked call's input is full
too).  One call of the window, drawn from the seed among the first
``check_calls``, is checked: its input and output states are copied to
the host around it, and after the window the reference
(``reference/icp.py``) follows the call from the input state.

Traced (``--trace 1``): the first call of the window profiles
``profile_frames`` frames from frame ``profile_skip`` on, as the
``rollout`` driver does.  The profiler's stop lies inside that call and
takes seconds, so a traced window also runs at least
``CALLS_AFTER_PROFILE`` calls after it: the readers of the port's spans
take the median over the window's calls, which is then an unprofiled
call's.  The record carries the rollout driver's keys, so the readers
of both read it, and ``k4_sizes`` (K4's sizes: the beams and the map's
point count at the window's start).

The window loop is the ``rollout`` driver's, with this compare module,
these sizes and the traced window's extra calls; the two loops cannot
share one body without an edit to ``drivers/rollout.py``.
"""

from __future__ import annotations

import contextlib
import math
import time

from h100bench import compare, harness, icp_compare
from h100bench.drivers import rollout
from h100bench.drivers.rollout import _f32, _ProfiledFrames
from h100bench.reference import world as ref_world

CALLS_AFTER_PROFILE = 8


class Driver(rollout.Driver):
    def __init__(self, ctx):
        super().__init__(ctx)
        radius = float(ctx.workload["start_radius_m"]) \
            * math.sqrt(self.rng.random())
        bearing = self.rng.uniform(-math.pi, math.pi)
        self.start = (_f32(radius * math.cos(bearing)),
                      _f32(radius * math.sin(bearing)),
                      _f32(self.rng.uniform(-math.pi, math.pi)))

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
        if self.fw.icp_config is None or self.fw.grid_config is not None \
                or self.fw.ekf_config is not None:
            raise ValueError("the icp_rollout driver runs a world with ICP "
                             "odometry alone")
        self.capacity = self.fw.icp_config.capacity
        state = self.fw.init()
        self.state = state._replace(pose=torch.tensor(
            self.start, dtype=torch.float32, device=dev))
        self.commands = Command(
            torch.full((self.ticks,), _f32(self.left), dtype=torch.float32,
                       device=dev),
            torch.full((self.ticks,), _f32(self.right), dtype=torch.float32,
                       device=dev))
        # the checked call's input and output states, copied here
        self.buffers = [icp_compare.host_buffers(self.state)
                        for _ in range(2)]
        harness.log(f"world made; start pose {self.start}")
        for _ in range(int(self.ctx.workload["warm_calls"])):
            self.state, outs = self._call(self.state)
            self._to_host(outs)
            harness.log("warm-up call done")
        self.points = int(self.state.icp.count)
        if self.points < self.capacity:
            raise RuntimeError(f"the map holds {self.points} points at the "
                               f"window's start, fewer than its capacity "
                               f"{self.capacity}: add warm-up calls")

    def _call(self, state, draws=None):
        """One call: on the card ``rollout_cadence`` (captured); on the
        CPU (the tests) the same frame program run without graphs."""
        from slamrs_tpu_torch.graph import capture

        if self.dev.type != "cuda":
            return capture.run_program(self.fw, state, self.ticks, 0,
                                       self.commands, graphs=False)
        return self.fw.rollout_cadence(state, self.ticks, seed=0,
                                       commands=self.commands)

    @staticmethod
    def _to_host(outs) -> dict:
        return {"pose": outs.pose.cpu().numpy(),
                "icp_pose": outs.icp_pose.cpu().numpy()}

    # --- the window -------------------------------------------------------

    def window(self, seconds: float, profile) -> dict:
        from slamrs_tpu_torch.graph import capture

        calls = 0
        capture_s, call_s = [], []
        traced = profile is not None
        least = 1 + (CALLS_AFTER_PROFILE if traced else 0)
        t0 = time.perf_counter()
        while True:
            if calls == self.check_call:
                self.before = icp_compare.world_to_host(self.state,
                                                        self.buffers[0])
            t = time.perf_counter()
            with (_ProfiledFrames(capture.FrameProgram, profile,
                                  self.ctx.workload, 1)
                  if traced and calls == 0 else contextlib.nullcontext()):
                self.state, outs = self._call(self.state)
            host = self._to_host(outs)
            call_s.append(time.perf_counter() - t)
            stats = self.fw.capture_stats
            capture_s.append(stats.capture_seconds + (
                stats.ticks.capture_seconds if stats.ticks else 0.0))
            if calls == self.check_call:
                self.after = icp_compare.world_to_host(self.state,
                                                       self.buffers[1])
                self.check_outputs = host
            calls += 1
            if time.perf_counter() - t0 >= seconds \
                    and calls > self.check_call and calls >= least:
                break
        self._sync()
        window_s = time.perf_counter() - t0
        harness.log("calls: " + harness.describe(call_s, 1e3, "ms"))
        return {"window_s": window_s, "world_ticks": calls * self.ticks,
                "attempted": calls, "failed": 0, "calls": calls,
                "capture_s_per_call": capture_s,
                "k4_sizes": {"problems": 1, "beams": ref_world.NUM_BEAMS,
                             "points": self.points}}

    # --- the check --------------------------------------------------------

    def check(self, quantize=None) -> dict:
        """The checked call followed by the reference from its input
        state (``quantize``: the control, every scan and map point
        rounded to that dtype)."""
        values = icp_compare.follow_and_compare(
            self.yaml_text, self.ctx.workload, self.before, self.after,
            self.check_outputs, self.left, self.right, self.ticks, self.dev,
            quantize)
        return compare.compared(values, self.ctx.workload["limits"])
