"""Microseconds of host time a rollout call spends copying each frame's
inputs (wheel speeds, injected draws) into the graphs' static buffers
(the port's ``frame.fill`` spans) per graph replay (``graph.launch``),
median over the window's calls."""

from h100bench.program_calls import median_over_calls, per_replay


def read(record):
    return median_over_calls(
        record, lambda c: (v * 1e6 if (v := per_replay(c, "frame.fill"))
                           is not None else None))
