"""K3's share of its roofline, in percent: the least time of the profiled
frames' updates (``roofline/k3.py``, from the spec, the cell's sizes and
the bands privatized over those frames, the port's ``k3.tiles_copied``)
over their device time (kernels named ``fused_update_tiled_kernel``).

Nothing where the port counts no privatized bands, and nothing unless the
profile holds one launch a profiled frame: the count covers every frame,
so a launch the profile lost would leave its bytes without its time."""

from h100bench.harness import kernel_time
from h100bench.roofline import k3


def read(record):
    t = record.get("trace")
    sizes = record.get("k3_sizes")
    if not t or not sizes or t.get("tiles_copied") is None:
        return None
    launches, seconds = kernel_time(t, "fused_update_tiled_kernel")
    if launches == 0 or launches != t.get("frames") or seconds <= 0:
        return None
    return (k3.least_seconds(sizes, launches, t["tiles_copied"]) / seconds
            * 100.0)
