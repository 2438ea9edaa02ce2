"""The share of a rollout call's wall time (its first device work to the
next call's) in which the device waited on the host: the sampled
frames' idle under the fill, the launch and the loop, scaled to the
call's frames, plus the call's ends, from the port's replay events on
the host clock with the profiler off (``h100bench/replay_idle.py``),
median over the window's calls that no profiler recorded in (None
where there is none)."""

from h100bench.program_calls import median_over_calls
from h100bench.replay_idle import host_wait_share


def read(record):
    return median_over_calls(record, host_wait_share)
