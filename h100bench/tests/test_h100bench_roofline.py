"""K1's work counted from the spec and the sizes: the disc count against
a brute-force count, inside the map and across its edge."""

import math

import pytest

from h100bench.roofline import k1, peaks


def brute(rows, cols, res, rng, cx, cy):
    r = rng / res
    return sum(1 for i in range(rows) for j in range(cols)
               if (j + 0.5 - cx) ** 2 + (i + 0.5 - cy) ** 2 <= r * r)


@pytest.mark.parametrize("rows,cols,res,rng,cx,cy", [
    (40, 40, 0.1, 1.0, 20.3, 19.7),  # inside the map
    (40, 40, 0.1, 1.0, 3.2, 20.0),  # across the left edge
    (40, 40, 0.1, 1.0, 39.5, 0.4),  # across two edges
    (20, 30, 0.05, 0.5, 29.9, 10.1),  # a wide map, across the right edge
    (10, 10, 0.1, 2.0, 5.0, 5.0),  # the disc holds the whole map
])
def test_disc_cells_equals_brute_force(rows, cols, res, rng, cx, cy):
    assert k1.disc_cells(rows, cols, res, rng, cx, cy) == brute(
        rows, cols, res, rng, cx, cy)


def test_mean_disc_is_the_disc_area_inside_the_map():
    # the headline (80 x 80 at 0.05 m, 1 m range) and the fleet's map
    for rows, cols, res in ((80, 80, 0.05), (200, 200, 0.02)):
        r = 1.0 / res
        got = k1.mean_disc_cells(rows, cols, res, 1.0)
        assert abs(got - math.pi * r * r) / (math.pi * r * r) < 0.01


def test_launch_work_counts_the_map_width_not_the_padding():
    sizes = dict(worlds=1, particles=1024, rows=80, cols=80, resolution=0.05,
                 max_range_m=1.0, itemsize=2)
    nbytes, flops = k1.launch_work(sizes)
    cells = k1.mean_disc_cells(80, 80, 0.05, 1.0)
    assert nbytes >= 1024 * cells * 4 and nbytes < 1024 * cells * 4 * 1.05
    assert k1.least_seconds(sizes) == pytest.approx(
        max(nbytes / peaks.HBM_BYTES_PER_S, flops / peaks.FP32_FLOPS_PER_S))
    fleet = dict(sizes, worlds=256, particles=10, rows=200, cols=200,
                 resolution=0.02, itemsize=4)
    assert k1.launch_work(fleet)[0] > 2560 * 7800 * 8
