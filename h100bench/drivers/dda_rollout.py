"""The dda rollout driver: the ``rollout`` driver's traffic on one world
whose grid SLAM runs the dda integrator (``integrate: "dda"``, the
default): the DDA walk and its sorted scatter-add, the likelihood on the
old maps, the whole-set gather resample.

Traffic, set-up, warm-up and the window are those of
``drivers/rollout.py``: consecutive captured ``rollout_cadence`` calls of
``ticks_per_call`` ticks at constant wheel speeds, the state carried,
the grid-SLAM draws injected, one call of the first ``check_calls``
checked.  What differs:

* set-up raises unless the world's grid SLAM runs the dda integrator;
* the check is ``reference/dda.py``'s;
* traced, the first call profiles ``profile_frames`` frames from frame
  ``profile_skip`` on, as the ``rollout`` driver does, and the window
  runs at least ``CALLS_AFTER_PROFILE`` calls after it, as
  ``drivers/icp_rollout.py`` does: the profiler's start takes seconds,
  and the readers of the port's spans take the median over the window's
  calls, which is then an unprofiled call's;
* the record carries no K1 sizes: K1 does not run here.

The window loop is the ``rollout`` driver's with the traced window's
extra calls; the two cannot share one body without an edit to
``drivers/rollout.py``.
"""

from __future__ import annotations

import contextlib
import time

from h100bench import compare, harness
from h100bench.drivers import rollout
from h100bench.drivers.rollout import _ProfiledFrames
from h100bench.reference import dda

CALLS_AFTER_PROFILE = 8


class Driver(rollout.Driver):
    # --- set-up ---------------------------------------------------------

    def _make_draws(self, shape) -> list:
        """The rollout driver's draws, once the world is seen to run the
        dda integrator (set-up calls this after building the world, before
        the first call)."""
        cfg = self.fw.grid_config
        if self.worlds != 1 or cfg is None or cfg.integrate != "dda":
            raise ValueError("the dda_rollout driver runs one world whose "
                             "grid SLAM runs integrate: dda")
        return super()._make_draws(shape)

    # --- the window -------------------------------------------------------

    def window(self, seconds: float, profile) -> dict:
        from slamrs_tpu_torch.graph import capture

        calls = 0
        capture_s, call_s = [], []
        traced = profile is not None
        least = 1 + (CALLS_AFTER_PROFILE if traced else 0)
        t0 = time.perf_counter()
        while True:
            draws = self.draws[calls % len(self.draws)]
            if calls == self.check_call:
                self.before = compare.world_to_host(self.state,
                                                    self.buffers[0])
                self.check_draws = draws
            t = time.perf_counter()
            with (_ProfiledFrames(capture.FrameProgram, profile,
                                  self.ctx.workload, 1)
                  if traced and calls == 0 else contextlib.nullcontext()):
                self.state, outs = self._call(self.state, draws)
            host = self._to_host(outs)
            call_s.append(time.perf_counter() - t)
            capture_s.append(self.fw.capture_stats.capture_seconds)
            if calls == self.check_call:
                self.after = compare.world_to_host(self.state,
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
                "capture_s_per_call": capture_s}

    # --- the check --------------------------------------------------------

    def check(self, quantize=None) -> dict:
        """The checked call followed by ``reference/dda.py`` from its input
        state (``quantize``: the control, the reference's maps rounded one
        precision below float32 after each integrate)."""
        t = time.perf_counter()
        values = dda.follow_and_compare(
            self.yaml_text, self.ctx.workload, self.before, self.after,
            self.check_outputs, self.check_draws, self.left, self.right,
            self.ticks, self.dev, quantize)
        harness.log(f"the reference followed the call and compared in "
                    f"{time.perf_counter() - t:.1f} s")
        return compare.compared(values, self.ctx.workload["limits"])
