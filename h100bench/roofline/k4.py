"""The work of one launch of K4, the nearest-neighbour argmin
(``nn_argmin_kernel``), counted from the scan's beams and the map's point
count alone: never from the port's launch plan (its split of the map
over CTAs, its partials and their merge).

Each of ``beams`` source points is compared with each of the map's
``points`` valid points: ``FLOPS_PER_PAIR`` float32 operations a pair
(the two products, their sum, the doubling, the difference from the
map point's squared norm, the compare).  Each source point and each
map point is read once and each index written once.  The least time is
the larger of bytes over the peak bandwidth and operations over the
float32 peak; at the ICP mapper's sizes the operations bound it.
"""

from __future__ import annotations

from h100bench.roofline import peaks

FLOPS_PER_PAIR = 6
POINT_BYTES = 2 * 4  # float32 x, y
INDEX_BYTES = 4  # int32


def launch_work(sizes: dict) -> tuple[float, float]:
    """``(bytes, flops)`` of one launch; ``sizes`` holds ``problems``,
    ``beams`` (source points a problem) and ``points`` (valid map points
    a problem)."""
    b, n_p, n_q = sizes["problems"], sizes["beams"], sizes["points"]
    nbytes = b * (n_p * (POINT_BYTES + INDEX_BYTES) + n_q * POINT_BYTES)
    return float(nbytes), float(b * n_p * n_q * FLOPS_PER_PAIR)


def least_seconds(sizes: dict) -> float:
    """The least time of one launch on the H100."""
    nbytes, flops = launch_work(sizes)
    return max(nbytes / peaks.HBM_BYTES_PER_S,
               flops / peaks.FP32_FLOPS_PER_S)
