"""Milliseconds a rollout call in which the device waited up to the end
of its frame loop's second replay and after its last, up to the next
call's first device work: the draws' upload, the lead's eager frame, the
trailing ticks, the hand-over, the call's own Python outside its loop
(and its first frame's fill and launch) and the caller's time between
calls (the copy of the outputs to the host), from the port's replay
events on the host clock with the profiler off
(``h100bench/replay_idle.py``), median over the window's calls that no
profiler recorded in (None where there is none)."""

from h100bench.program_calls import median_over_calls
from h100bench.replay_idle import ends_idle


def read(record):
    return median_over_calls(
        record, lambda c: (v * 1e3 if (v := ends_idle(c)) is not None
                           else None))
