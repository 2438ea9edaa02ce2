"""Launches of the dda integrate kernel (``dda_integrate_kernel``: a dda
update's DDA walk, inverse sensor model and per-cell sum) in the profiled
window per scan frame: one where each frame's update integrates on the
kernel; nothing where no kernel of that name ran (a tree without it, a
world of another integrator)."""

from h100bench.harness import kernel_time


def read(record):
    t = record.get("trace")
    if not t or not t.get("frames"):
        return None
    launches, _ = kernel_time(t, "dda_integrate_kernel")
    if launches == 0:
        return None
    return launches / t["frames"]
