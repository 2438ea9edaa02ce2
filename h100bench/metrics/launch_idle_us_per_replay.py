"""Microseconds a sampled replay cycle (one graph replay's end to the
next's) in which the device waited under the next frame's
``graph.launch`` span (the launch counts and ``graph.replay()``: any
part of the replay the device runs before ``replay()`` returns counts
in it), from the port's replay events on the host clock with the
profiler off (``h100bench/replay_idle.py``), median over the window's calls
that no profiler recorded in (None where there is none)."""

from h100bench.replay_idle import median_per_replay_us


def read(record):
    return median_per_replay_us(record, "launch")
