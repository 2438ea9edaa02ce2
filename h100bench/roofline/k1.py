"""The work of one launch of K1, the fused likelihood and integrate
(``fused_update_kernel``), counted from the grid's spec and the cell's
sizes alone: never from the port's launch geometry or its prepared
inputs.

For each particle, the cells of the map's own width (``cols`` of
``width / resolution``, not the columns the port pads to) whose centres
lie within ``max_scan_range`` of the particle are read once and written
once; each scan's beams are read once; each particle's pose is read and
its likelihood written.  That is the disc that the integrate defines.
The robot circles near the middle of the map in the benchmark's cells,
so every disc lies inside it, and the count of a disc is the mean over
the centre's position within its cell (the disc's area where it lies
inside the map); :func:`disc_cells` counts one centre exactly, clipped to
the map, which the tests hold against a brute-force count.

Operations: ``CELL_FLOPS`` float32 operations a disc cell (offsets, the
squared distance, its root, the bearing and its beam, the interval test,
the density and the add; atan2 and the root counted as one each) and
``BEAM_FLOPS`` a beam and particle (the endpoint's rotation and the
mixture's exp and log).  Counted low on purpose: the least time is the
larger of bytes over the peak bandwidth and these operations over the
float32 peak, so an undercount can only lower the share.
"""

from __future__ import annotations

import math

import numpy as np

from h100bench.roofline import peaks

CELL_FLOPS = 20
BEAM_FLOPS = 12
BEAMS = 360
SCAN_BYTES_PER_BEAM = 4 + 1 + 1  # distance, valid, present
POSE_BYTES = 3 * 4 + 4  # the sampled pose in, the likelihood out


def disc_cells(rows: int, cols: int, resolution: float, max_range_m: float,
               cx: float, cy: float) -> int:
    """Cells ``(i, j)`` of a ``rows x cols`` map whose centres
    ``(j + 0.5, i + 0.5)`` lie within ``max_range_m / resolution`` cells
    of ``(cx, cy)`` (grid units)."""
    r = max_range_m / resolution
    j0, j1 = max(0, math.floor(cx - r)), min(cols, math.ceil(cx + r) + 1)
    i0, i1 = max(0, math.floor(cy - r)), min(rows, math.ceil(cy + r) + 1)
    if j0 >= j1 or i0 >= i1:
        return 0
    xs = np.arange(j0, j1) + 0.5 - cx
    ys = np.arange(i0, i1) + 0.5 - cy
    return int(((xs[None, :] ** 2 + ys[:, None] ** 2) <= r * r).sum())


def mean_disc_cells(rows: int, cols: int, resolution: float,
                    max_range_m: float, samples: int = 16) -> float:
    """:func:`disc_cells` averaged over ``samples x samples`` centres
    spread over the map's middle cell."""
    total = 0
    for a in range(samples):
        for b in range(samples):
            total += disc_cells(rows, cols, resolution, max_range_m,
                                cols // 2 + (a + 0.5) / samples,
                                rows // 2 + (b + 0.5) / samples)
    return total / samples ** 2


def launch_work(sizes: dict) -> tuple[float, float]:
    """``(bytes, flops)`` of one launch over every particle of every
    world; ``sizes`` holds ``worlds``, ``particles`` (a world's),
    ``rows``, ``cols``, ``resolution``, ``max_range_m`` and ``itemsize``
    (bytes of a map cell)."""
    n = sizes["worlds"] * sizes["particles"]
    cells = mean_disc_cells(sizes["rows"], sizes["cols"],
                            sizes["resolution"], sizes["max_range_m"])
    nbytes = (n * cells * 2 * sizes["itemsize"] + n * POSE_BYTES
              + sizes["worlds"] * BEAMS * SCAN_BYTES_PER_BEAM)
    flops = n * cells * CELL_FLOPS + n * BEAMS * BEAM_FLOPS
    return float(nbytes), float(flops)


def least_seconds(sizes: dict) -> float:
    """The least time of one launch on the H100: the larger of its bytes
    over the peak bandwidth and its operations over the float32 peak."""
    nbytes, flops = launch_work(sizes)
    return max(nbytes / peaks.HBM_BYTES_PER_S,
               flops / peaks.FP32_FLOPS_PER_S)
