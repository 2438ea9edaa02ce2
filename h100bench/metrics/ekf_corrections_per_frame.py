"""Observation lanes the EKF corrects a scan frame, summed over the
worlds (the port's device counter ``ekf.corrections``, which
``models/ekf.update`` adds the valid lanes to on the device inside the
graphs, over the call's ``rollout.frames``), in the window's first call;
nothing where the port has no such counter.

The first call alone: every call's count is fixed by the seed, but the
number of calls a window holds is not, so a median or a total over the
window could differ between two runs of one seed."""

from h100bench.program_calls import window_calls


def read(record):
    calls = window_calls(record)
    if not calls:
        return None
    first = calls[0]
    gains = first.get("device", {}).get("ekf.corrections")
    frames = first["counts"].get("rollout.frames")
    if not gains or not frames:
        return None
    return sum(int(t.item()) for t in gains) / frames
