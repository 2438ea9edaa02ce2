"""K3's (the tiled fused likelihood and integrate,
``fused_update_tiled_kernel``) device time in the profiled window per
scan frame, in microseconds."""

from h100bench.harness import kernel_time


def read(record):
    t = record.get("trace")
    if not t or not t.get("frames"):
        return None
    launches, seconds = kernel_time(t, "fused_update_tiled_kernel")
    if launches == 0:
        return None
    return seconds / t["frames"] * 1e6
