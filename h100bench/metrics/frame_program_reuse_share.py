"""Share of the window's rollout calls that ran on the frame program kept
from the call before (the port's host counter named by
``graph/capture.REUSED``, ``rollout.program_reused``, 1 in such a call),
with no eager frame 0 and no capture of a graph the program holds.

A port that keeps no frame program names no such counter: nothing to
read."""

from h100bench.program_calls import window_calls


def read(record):
    calls = window_calls(record)
    if not calls:
        return None
    from slamrs_tpu_torch.graph import capture

    name = getattr(capture, "REUSED", None)
    if name is None:
        return None
    return sum(1 for c in calls if c["counts"].get(name)) / len(calls)
