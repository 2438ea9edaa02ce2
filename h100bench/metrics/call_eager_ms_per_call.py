"""Milliseconds a rollout call spends in its eager frames (the port's
``frame.eager`` spans: frame 0 and the first frame of each idle count,
run op by op before their capture, and the trailing ticks' first),
median over the window's calls."""

from h100bench.program_calls import median_over_calls, span


def read(record):
    return median_over_calls(record,
                             lambda c: span(c, "frame.eager")[1] * 1e3)
