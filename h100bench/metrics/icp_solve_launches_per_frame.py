"""Launches of the ICP solve kernel (``icp_solve_kernel``) in the profiled
window per scan frame: ten iterations and the prologue, 11 where each
ICP call of a frame runs on the kernel; nothing where no kernel of that
name ran (a tree without it)."""

from h100bench.harness import kernel_time


def read(record):
    t = record.get("trace")
    if not t or not t.get("frames"):
        return None
    launches, _ = kernel_time(t, "icp_solve_kernel")
    if launches == 0:
        return None
    return launches / t["frames"]
