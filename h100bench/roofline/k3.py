"""The work of K3, the fused likelihood and integrate on tile-pool maps
(``fused_update_tiled_kernel``), over a profiled stretch of frames,
counted from the grid's spec, the cell's sizes and the bands the port
privatized (its device counter ``k3.tiles_copied``): never from the
port's launch geometry, its plan or its prepared inputs.

Each update privatizes the shared bands that a particle's scan disc
touches: each such band is written once whole, its ``band_rows`` rows at
the map's own ``cols`` (not the columns the port pads to).  The tiles
they are copied from are not counted: after a resample many slots share
one ancestor's tiles, so one shared tile is the source of many copies
and is read once for all of them, and the counter does not say how many
distinct tiles those were (a read counted for each copy put K3 above
100 % of this roofline on the card).  A particle whose bands it owns
reads and writes only its disc cells, once each, as ``k1.py`` counts
them.  A
particle with a privatized band may have every disc cell inside it, so
the disc cells counted are those of the particle-updates that privatized
nothing, at least ``n - copied`` of the ``n`` (each of the others holds
one of the ``copied`` bands at least).  Each scan's beams are read once, each particle's pose
read and its likelihood written, as in ``k1.py``; its operations are
K1's, a disc cell and a beam of every particle.  The robot circles near
the middle of the map, so every band it touches is a whole band of the
map and every disc lies inside it.

The band height is the storage's unit of copy, fixed by the spec: the
rows of the window that holds a scan disc (``band_rows``), which the
tests hold against the port's tile geometry.  Counted low on purpose:
the least time is the larger of bytes over the peak bandwidth and
operations over the float32 peak, so an undercount can only lower the
share.
"""

from __future__ import annotations

import math

from h100bench.roofline import k1, peaks

ADDITIONAL_STEPS = 2  # beyond the range, as the integrate's disc


def band_rows(resolution: float, max_range_m: float) -> int:
    """Rows of a band: the scan disc (``2 * (ceil(range) + 3) + 1``
    cells) with 8 rows of slack, rounded up to 8."""
    half = int(math.ceil(max_range_m / resolution)) + ADDITIONAL_STEPS + 1
    return (2 * half + 1 + 8 + 7) // 8 * 8


def window_work(sizes: dict, launches: int, copied: int
                ) -> tuple[float, float]:
    """``(bytes, flops)`` of ``launches`` updates of one world that
    privatized ``copied`` bands in all; ``sizes`` holds ``particles``,
    ``rows``, ``cols``, ``resolution``, ``max_range_m`` and ``itemsize``
    (bytes of a map cell)."""
    n = launches * sizes["particles"]
    cells = k1.mean_disc_cells(sizes["rows"], sizes["cols"],
                               sizes["resolution"], sizes["max_range_m"])
    band = band_rows(sizes["resolution"], sizes["max_range_m"]) \
        * sizes["cols"]
    item = sizes["itemsize"]
    nbytes = (copied * band * item + max(0, n - copied) * cells * 2 * item
              + n * k1.POSE_BYTES
              + launches * k1.BEAMS * k1.SCAN_BYTES_PER_BEAM)
    flops = n * cells * k1.CELL_FLOPS + n * k1.BEAMS * k1.BEAM_FLOPS
    return float(nbytes), float(flops)


def least_seconds(sizes: dict, launches: int, copied: int) -> float:
    """The least time of those updates on the H100."""
    nbytes, flops = window_work(sizes, launches, copied)
    return max(nbytes / peaks.HBM_BYTES_PER_S,
               flops / peaks.FP32_FLOPS_PER_S)
