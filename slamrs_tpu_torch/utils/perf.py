"""Incremental host-side timing statistics.

Counterpart of ``slamrs_tpu/utils/perf.py``: online mean and standard
deviation (Welford), min, max, latest and FPS, in milliseconds of the
host clock.  A block timed on the host around device work measures what
the host waited for: launches, plus the device only where the block
synchronizes.
"""

from __future__ import annotations

import math
import time


class PerfStats:
    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.mean = 0.0
        self.var_sum = 0.0
        self.std = 0.0
        self.sample_count = 0
        self.min = math.inf
        self.max = -math.inf
        self.latest = 0.0

    def update(self, seconds: float) -> None:
        msecs = seconds * 1000.0
        if self.sample_count > 0:
            old_mean = self.mean
            self.mean += (msecs - self.mean) / self.sample_count
            self.var_sum += (msecs - old_mean) * (msecs - self.mean)
            # float cancellation can leave var_sum epsilon-negative
            self.std = math.sqrt(max(self.var_sum, 0.0) / self.sample_count)
        else:
            self.mean = msecs
        self.min = min(self.min, msecs)
        self.max = max(self.max, msecs)
        self.latest = msecs
        self.sample_count += 1

    def latest_fps(self) -> float:
        return 1000.0 / self.latest if self.latest > 0 else math.inf

    def timeit(self):
        """Context manager measuring a block."""
        stats = self

        class _Timer:
            def __enter__(self):
                self.t0 = time.perf_counter()
                return self

            def __exit__(self, *exc):
                stats.update(time.perf_counter() - self.t0)
                return False

        return _Timer()

    def __str__(self) -> str:
        return (
            f"{self.mean:6.2f} ± {self.std:5.2f} ms "
            f"[{self.min:6.2f}, {self.max:6.2f}] n={self.sample_count}"
        )
