"""The simulator kernel's (``sim_frame_kernel``) device time in the
profiled window per scan frame, in microseconds; nothing where no kernel
of that name ran (a tree without it)."""

from h100bench.harness import kernel_time


def read(record):
    t = record.get("trace")
    if not t or not t.get("frames"):
        return None
    launches, seconds = kernel_time(t, "sim_frame_kernel")
    if launches == 0:
        return None
    return seconds / t["frames"] * 1e6
