"""Milliseconds of a rollout call's own host time: the ``rollout_cadence``
call's duration less every span opened directly inside it (the frame
loop's Python: slicing the speeds, the idle counts, building the frame
program, the bookkeeping between frames), median over the window's
calls."""

from h100bench.program_calls import median_over_calls


def read(record):
    return median_over_calls(record, lambda c: c["self_seconds"] * 1e3)
