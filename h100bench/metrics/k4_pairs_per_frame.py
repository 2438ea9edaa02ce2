"""Source and map point pairs K4 compares a scan frame (the port's device
counter ``k4.pairs``, which ICP adds to on the device inside the graphs,
over the call's ``rollout.frames``), in the window's first call, as
``k2_maps_copied_per_frame`` reads its counter."""

from h100bench.program_calls import window_calls


def read(record):
    calls = window_calls(record)
    if not calls:
        return None
    first = calls[0]
    gains = first.get("device", {}).get("k4.pairs")
    frames = first["counts"].get("rollout.frames")
    if not gains or not frames:
        return None
    return sum(int(t.item()) for t in gains) / frames
