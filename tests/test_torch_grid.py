"""slamrs_tpu_torch.ops.grid against slamrs_tpu.ops.grid.

The same numpy inputs, made from a seed, go through the JAX function
(lifted over particles with ``vmap``) and the port's batched one.  Gates:

- ``traverse_ray`` on identical grid coordinates (random rays, rays
  within one cell, axis-aligned rays, rays leaving the grid): cells,
  centers and mask equal exactly (the same sequential float32 walk);
- ``inverse_sensor_model_log_odds``, ``dense_window_for``,
  ``world_to_grid``: exact; ``scan_endpoints``: cos and sin within 1 ulp
  (two libraries), the endpoints within 2 ulps of their largest term;
- ``grid_log_likelihood``: rtol 1e-5 / atol 1e-4 (sums of ~360 logs in
  another order);
- ``grid_integrate`` and ``grid_integrate_dense`` (window and full-grid
  mode): at least 99.9 % of cells within 5e-3 and the touched cells' signs
  agreeing on 99.9 %, ``tests/test_parity.py``'s occupancy gate (an
  endpoint one ulp apart can cross a cell boundary).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from slamrs_tpu.ops import grid as jg  # noqa: E402
from slamrs_tpu_torch.ops import grid as tg  # noqa: E402

P = 8
B = 360
RANGE = 1.0


def _t(a):
    return torch.from_numpy(np.array(a))


def _specs(geom):
    return jg.GridSpec2D(*geom), tg.GridSpec2D(*geom)


HEADLINE = (-2.0, -2.0, 4.0, 4.0, 0.05)
FINE = (-2.0, -2.0, 4.0, 4.0, 0.02)
SMALL = (-0.5, -0.5, 1.0, 1.0, 0.05)  # 20 x 20: the dense full-grid mode


def _rays(seed, n=512, size=40.0):
    """Grid-coordinate rays: random ones, some within one cell, some
    axis-aligned (either sign), some of zero length, some leaving the
    grid through each edge."""
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(0, size, n).astype(np.float32)
    y0 = rng.uniform(0, size, n).astype(np.float32)
    x1 = (x0 + rng.uniform(-25, 25, n)).astype(np.float32)
    y1 = (y0 + rng.uniform(-25, 25, n)).astype(np.float32)
    k = n // 8
    x1[:k] = np.floor(x0[:k]) + rng.uniform(0, 1, k).astype(np.float32)
    y1[:k] = np.floor(y0[:k]) + rng.uniform(0, 1, k).astype(np.float32)
    x1[k:2 * k] = x0[k:2 * k]  # vertical
    y1[2 * k:3 * k] = y0[2 * k:3 * k]  # horizontal
    x1[3 * k:3 * k + 8] = x0[3 * k:3 * k + 8]  # zero length
    y1[3 * k:3 * k + 8] = y0[3 * k:3 * k + 8]
    x0[4 * k:4 * k + 4] = [0.0, size - 1e-3, 0.5, 3.0]  # on the edges
    y0[4 * k:4 * k + 4] = [3.0, 0.5, 0.0, size - 1e-3]
    x0[5 * k:5 * k + 4] = [-0.5, size + 0.5, 2.0, 2.0]  # starting outside
    y0[5 * k:5 * k + 4] = [2.0, 2.0, -0.5, size + 0.5]
    return x0, y0, x1, y1


@pytest.mark.parametrize("seed", range(4))
def test_traverse_ray_matches_jax_exactly(seed):
    size = 40
    x0, y0, x1, y1 = _rays(seed, size=float(size))
    steps = 40
    jout = jg.traverse_ray(x0, y0, x1, y1, size, size, steps)
    tout = tg.traverse_ray(_t(x0), _t(y0), _t(x1), _t(y1), size, size,
                           steps)
    for name, j, t in zip(("xs", "ys", "centers", "mask"), jout, tout):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j),
                                      err_msg=name)
    mask = tout[3].numpy()
    assert mask.any(axis=-1).sum() > 0.9 * len(x0)
    n = mask.sum(axis=-1)
    assert (n[len(x0) // 8 * 3:len(x0) // 8 * 3 + 8] == 3).all()  # same cell


def test_traverse_ray_degenerate_same_cell():
    """start == end: 1 + ADDITIONAL_STEPS emissions of the same cell (the
    NaN error keeps the walk in place)."""
    xs, ys, _, mask = tg.traverse_ray(torch.tensor(2.5), torch.tensor(3.5),
                                      torch.tensor(2.5), torch.tensor(3.5),
                                      10, 10, 8)
    assert int(mask.sum()) == 3
    assert (xs[mask] == 2).all() and (ys[mask] == 3).all()


def test_inverse_sensor_model_matches_jax_exactly():
    rng = np.random.default_rng(1)
    d = rng.uniform(0, 30, 4096).astype(np.float32)
    m = rng.uniform(0, 30, 4096).astype(np.float32)
    d[:64] = m[:64] - 1.0  # on the band edges
    d[64:128] = m[64:128] + 1.0
    d[128:192] = m[128:192]
    hit = rng.uniform(size=4096) < 0.6
    j = np.asarray(jg.inverse_sensor_model_log_odds(d, m, hit))
    t = tg.inverse_sensor_model_log_odds(_t(d), _t(m), _t(hit)).numpy()
    assert t.dtype == np.float32
    np.testing.assert_array_equal(t, j)


def _poses(seed, spec, p=P):
    rng = np.random.default_rng(seed)
    x = rng.uniform(spec.position_x + 0.2,
                    spec.position_x + spec.width - 0.2, p)
    y = rng.uniform(spec.position_y + 0.2,
                    spec.position_y + spec.height - 0.2, p)
    th = rng.uniform(-np.pi, np.pi, p)
    poses = np.stack([x, y, th], -1).astype(np.float32)
    poses[0, :2] = [spec.position_x + 0.01, spec.position_y + 0.01]
    return poses


def _scan(seed, b=B, first=0.0):
    """A uniform 1-degree table from ``first``; distances up to 1.2 m
    (a few past the range), ~80 % valid, the last lanes absent."""
    rng = np.random.default_rng(seed)
    angles = (first + np.deg2rad(np.arange(b))).astype(np.float32)
    dist = rng.uniform(0.05, 1.2, b).astype(np.float32)
    valid = rng.uniform(size=b) < 0.8
    present = np.ones(b, bool)
    present[-(b // 36 + 1):] = False
    return angles, dist, valid, present


def test_scan_endpoints_within_ulps():
    spec = tg.GridSpec2D(*HEADLINE)
    poses = _poses(2, spec, 64)
    angles, dist, _, _ = _scan(3)
    j = np.asarray(jax.vmap(lambda q: jg.scan_endpoints(
        q, angles, dist))(poses))
    t = tg.scan_endpoints(_t(poses), _t(angles), _t(dist)).numpy()
    assert t.shape == j.shape == (64, B, 2)
    # cos and sin within 1 ulp; the endpoint within 2 ulps of the largest
    # term of its sum (a cos one ulp apart moves the product by up to one
    # of its ulps, and the sum rounds once more)
    a = poses[:, 2:3] + angles
    for jf, tf in ((jnp.cos, torch.cos), (jnp.sin, torch.sin)):
        jv = np.asarray(jf(a))
        assert (np.abs(tf(_t(a)).numpy() - jv)
                <= np.spacing(np.abs(jv))).all()
    terms = np.stack([np.cos(a) * dist, np.sin(a) * dist], -1)
    big = np.maximum(np.maximum(np.abs(terms), np.abs(j)),
                     np.abs(poses[:, None, :2])).astype(np.float32)
    assert (np.abs(t - j) <= 2 * np.spacing(big)).all()


@pytest.mark.parametrize("geom", [HEADLINE, FINE, SMALL,
                                  (-4.0, -4.0, 8.0, 8.0, 0.05),
                                  (0.0, 0.0, 2.0, 1.0, 0.1)])
@pytest.mark.parametrize("max_range", [1.0, 5.0])
def test_dense_window_and_steps_match_jax(geom, max_range):
    js, ts = _specs(geom)
    assert tg.dense_window_for(ts, max_range) == \
        jg.dense_window_for(js, max_range)
    assert ts.max_ray_steps(max_range) == js.max_ray_steps(max_range)
    xy = _poses(4, ts, 32)[:, :2]
    np.testing.assert_array_equal(ts.world_to_grid(_t(xy)).numpy(),
                                  np.asarray(js.world_to_grid(xy)))


def _maps(seed, spec, p=P, touched=0.3):
    """Log-odds maps with ~30 % nonzero cells and the rest exactly 0."""
    rng = np.random.default_rng(seed)
    g = (rng.normal(size=(p, spec.rows, spec.cols)) * 2.0).astype(np.float32)
    g[rng.uniform(size=g.shape) > touched] = 0.0
    return g


@pytest.mark.parametrize("geom", [HEADLINE, FINE])
def test_grid_log_likelihood_matches_jax(geom):
    js, ts = _specs(geom)
    grids = _maps(5, ts)
    poses = _poses(6, ts)
    angles, dist, valid, present = _scan(7)
    j = np.asarray(jax.vmap(lambda g, q: jg.grid_log_likelihood(
        g, js, q, angles, dist, valid, present))(grids, poses))
    t = tg.grid_log_likelihood(_t(grids), ts, _t(poses), _t(angles),
                               _t(dist), _t(valid), _t(present)).numpy()
    assert t.shape == (P,)
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-4)


def _occupancy_gate(t, j):
    assert t.shape == j.shape and t.dtype == np.float32
    agree = float((np.abs(t - j) <= 5e-3).mean())
    assert agree >= 0.999, agree
    touched = np.abs(j) > 1e-6
    assert touched.sum() > 0
    sign = float((np.sign(t[touched]) == np.sign(j[touched])).mean())
    assert sign >= 0.999, sign


@pytest.mark.parametrize("geom", [HEADLINE, FINE])
@pytest.mark.parametrize("prior", ["zeros", "maps"])
def test_grid_integrate_matches_jax(geom, prior):
    js, ts = _specs(geom)
    grids = (np.zeros((P, ts.rows, ts.cols), np.float32) if prior == "zeros"
             else _maps(8, ts))
    poses = _poses(9, ts)
    angles, dist, valid, present = _scan(10)
    steps = js.max_ray_steps(RANGE)
    j = np.asarray(jax.vmap(lambda g, q: jg.grid_integrate(
        g, js, q, angles, dist, valid, present, steps))(grids, poses))
    tin = _t(grids)
    t = tg.grid_integrate(tin, ts, _t(poses), _t(angles), _t(dist),
                          _t(valid), _t(present), steps)
    assert torch.equal(tin, _t(grids))  # a new tensor; the input stays
    _occupancy_gate(t.numpy(), j)


@pytest.mark.parametrize("geom,first", [(HEADLINE, 0.0), (FINE, 0.0),
                                        (SMALL, 0.0), (HEADLINE, -0.7)])
def test_grid_integrate_dense_matches_jax(geom, first):
    """Window mode at both resolutions (the origin clipped at the grid's
    corner for particle 0), full-grid mode on a 20 x 20 grid, and a table
    that starts at -0.7 rad."""
    js, ts = _specs(geom)
    window = jg.dense_window_for(js, RANGE)
    full = window * window * 2 >= ts.rows * ts.cols
    assert full == (geom == SMALL)
    grids = _maps(11, ts)
    poses = _poses(12, ts)
    angles, dist, valid, present = _scan(13, first=first)
    j = np.asarray(jax.vmap(lambda g, q: jg.grid_integrate_dense(
        g, js, q, angles, dist, valid, present, window))(grids, poses))
    t = tg.grid_integrate_dense(_t(grids), ts, _t(poses), _t(angles),
                                _t(dist), _t(valid), _t(present), window)
    _occupancy_gate(t.numpy(), j)
    assert (t.numpy() != grids).any()


def test_grid_integrate_dense_partial_sector_matches_jax():
    """A 90-beam sector: cells past the last beam are absent."""
    js, ts = _specs(HEADLINE)
    window = jg.dense_window_for(js, RANGE)
    grids = np.zeros((P, ts.rows, ts.cols), np.float32)
    poses = _poses(14, ts)
    angles, dist, valid, present = _scan(15, b=90)
    j = np.asarray(jax.vmap(lambda g, q: jg.grid_integrate_dense(
        g, js, q, angles, dist, valid, present, window))(grids, poses))
    t = tg.grid_integrate_dense(_t(grids), ts, _t(poses), _t(angles),
                                _t(dist), _t(valid), _t(present),
                                window).numpy()
    _occupancy_gate(t, j)
    # about a quarter of the disc: the sector's cells only
    assert 0 < (t != 0).sum() < 0.5 * (np.asarray(jax.vmap(
        lambda g, q: jg.grid_integrate_dense(
            g, js, q, *_scan(15)[:1], *_scan(15)[1:], window))(
        grids, poses)) != 0).sum()


def test_scatter_is_reproducible():
    """Two calls on the same inputs give bitwise-equal maps."""
    ts = tg.GridSpec2D(*HEADLINE)
    grids = _t(_maps(16, ts))
    args = (ts, _t(_poses(17, ts)), *(_t(x) for x in _scan(18)),
            ts.max_ray_steps(RANGE))
    a = tg.grid_integrate(grids, *args)
    b = tg.grid_integrate(grids, *args)
    assert torch.equal(a, b)


@pytest.mark.parametrize("geom", [HEADLINE, FINE])
@pytest.mark.parametrize("batch", [(), (3,)])
def test_new_grid(geom, batch):
    js, ts = _specs(geom)
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        j = js.new_grid(batch, jdt)
        t = ts.new_grid(batch, tdt, device="cpu")
        assert t.shape == j.shape and t.dtype == tdt
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(j, np.float32))
    assert ts.new_grid().dtype == torch.float32
