"""K4's share of its roofline, in percent: the least time of the
launches the profiled window held (``roofline/k4.py``, from the beams
and the map's point count) over their device time (kernels named
``nn_argmin_kernel``)."""

from h100bench.harness import kernel_time
from h100bench.roofline import k4


def read(record):
    t = record.get("trace")
    sizes = record.get("k4_sizes")
    if not t or not sizes:
        return None
    launches, seconds = kernel_time(t, "nn_argmin_kernel")
    if launches == 0 or seconds <= 0:
        return None
    return launches * k4.least_seconds(sizes) / seconds * 100.0
