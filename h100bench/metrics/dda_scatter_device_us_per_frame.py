"""The device time of the dda integrator's scatter-add in the profiled
window per scan frame, in microseconds: the sort and the accumulate that
its one ``index_put_(accumulate=True)`` launches on the card.  The sort is
PyTorch's cub radix sort of the lanes' flat cell indices: a
``DeviceRadixSortHistogramKernel``, a ``DeviceRadixSortExclusiveSumKernel``
and one ``DeviceRadixSortOnesweepKernel`` per 8 bits of the largest index
(three at ``grid_slam_dda``'s 1,024 x 80 x 80 cells); the accumulate is
``indexing_backward_kernel_stride_1``.  Nothing else in a dda frame
launches either (a profile of ``dda.rollout`` on an H100); nothing where
neither ran (a world of another integrator).  The index arithmetic and
bounds checks around them are not counted."""

from h100bench.harness import kernel_time

KERNELS = ("DeviceRadixSort", "indexing_backward_kernel")


def read(record):
    t = record.get("trace")
    if not t or not t.get("frames"):
        return None
    launches = seconds = 0
    for fragment in KERNELS:
        n, s = kernel_time(t, fragment)
        launches += n
        seconds += s
    if launches == 0:
        return None
    return seconds / t["frames"] * 1e6
