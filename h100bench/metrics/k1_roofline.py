"""K1's share of its roofline, in percent: the least time of the
launches the profiled window held (``roofline/k1.py``, from the spec and
the cell's sizes) over their device time (kernels named
``fused_update_kernel``)."""

from h100bench.harness import kernel_time
from h100bench.roofline import k1


def read(record):
    t = record.get("trace")
    sizes = record.get("k1_sizes")
    if not t or not sizes:
        return None
    launches, seconds = kernel_time(t, "fused_update_kernel")
    if launches == 0 or seconds <= 0:
        return None
    return launches * k1.least_seconds(sizes) / seconds * 100.0
