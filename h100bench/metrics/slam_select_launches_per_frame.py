"""Launches of the selection kernel (``slam_select_kernel``: a grid SLAM
update's weight carry, normalization, argmax, N_eff, gated systematic
resample and pose gathers) in the profiled window per scan frame: one
where each frame's single-world update selects on the kernel; nothing
where no kernel of that name ran (a tree without it, a fleet, a world
with no grid)."""

from h100bench.harness import kernel_time


def read(record):
    t = record.get("trace")
    if not t or not t.get("frames"):
        return None
    launches, _ = kernel_time(t, "slam_select_kernel")
    if launches == 0:
        return None
    return launches / t["frames"]
