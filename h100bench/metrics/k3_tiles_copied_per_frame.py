"""Bands K3 privatizes a scan frame (the port's device counter
``k3.tiles_copied``, which the copy-on-write plan adds to on the device
inside the graphs, over the call's ``rollout.frames``), in the window's
first call.

The first call alone: every call's count is fixed by the seed, but the
number of calls a window holds is not, so a median or a total over the
window could differ between two runs of one seed."""

from h100bench.program_calls import window_calls


def read(record):
    calls = window_calls(record)
    if not calls:
        return None
    first = calls[0]
    gains = first.get("device", {}).get("k3.tiles_copied")
    frames = first["counts"].get("rollout.frames")
    if not gains or not frames:
        return None
    return sum(int(t.item()) for t in gains) / frames
