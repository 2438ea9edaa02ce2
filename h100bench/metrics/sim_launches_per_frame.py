"""Launches of the simulator kernel (``sim_frame_kernel``) in the profiled
window per scan frame: one where each frame's ticks and lidar scan run on
the kernel (the profiled frames hold no trailing idle run); nothing where
no kernel of that name ran (a tree without it)."""

from h100bench.harness import kernel_time


def read(record):
    t = record.get("trace")
    if not t or not t.get("frames"):
        return None
    launches, _ = kernel_time(t, "sim_frame_kernel")
    if launches == 0:
        return None
    return launches / t["frames"]
