"""slamrs_tpu_torch.ops.tiles against slamrs_tpu.ops.tiles.

The geometry helpers and the copy-on-write plan must equal the JAX
package's exactly, so that a JAX tiled state carries over.  The plain
tiled update (what the wrapper runs on CPU tensors) is held against the
JAX package's Pallas kernel in interpret mode on the three geometries of
``tests/test_tiles.py`` (2-band span, column-cropped wide map, 3-band
span), across updates with pending lineage relabels.  Gates: the fraction
of materialized cells with |diff| > 0.01 below 1e-4 (the TPU kernel's
atan2 is a polynomial, the port's the library's), the likelihood within
rtol 1e-5 / atol 1e-4 (sums in another order), tables equal on the 2-band
geometries (the JAX package's k-span window merge, not ported, moves some
windows and so privatizes other bands), and the padded column tail
exactly 0.  The port's tiled plain version is also bitwise its dense one,
and changes no materialized cell outside ``cell_pass_box``, the box the
kernels compute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from slamrs_tpu.ops import tiles as jt  # noqa: E402
from slamrs_tpu.ops.grid import GridSpec2D as JSpec  # noqa: E402
from slamrs_tpu_torch.ops import fused as tf  # noqa: E402
from slamrs_tpu_torch.ops import tiles as tt  # noqa: E402
from slamrs_tpu_torch.ops.grid import GridSpec2D as TSpec  # noqa: E402

P = 8
B = 360
FLIP_GATE = 1e-4
LIK_RTOL, LIK_ATOL = 1e-5, 1e-4
GEOMS = {
    "2band": (-3.2, -6.4, 6.4, 12.8, 0.05),   # 256 x 128, 5 bands of 56
    "wide": (-12.8, -6.4, 25.6, 12.8, 0.05),  # 256 x 512, column-cropped
    "kspan": (-6.4, -2.4, 12.8, 4.8, 0.05),   # 96 x 256, 3-band span
    "config3": (-25.0, -25.0, 50.0, 50.0, 0.05),  # 1,000 x 1,000
    "0.02m": (-2.0, -2.0, 4.0, 4.0, 0.02),    # 200 x 200, 3-band span
}


@pytest.mark.parametrize("geom", list(GEOMS))
def test_geometry_helpers_match_jax(geom):
    js, ts = JSpec(*GEOMS[geom]), TSpec(*GEOMS[geom])
    p = 1024
    hb_j = jt.auto_band_rows(js, 1.0)
    assert tt.auto_band_rows(ts, 1.0) == hb_j
    assert tt.auto_band_rows(ts, 1.0, torch.float32) == \
        jt.auto_band_rows(js, 1.0, jnp.float32)
    assert tt.tile_geometry(ts, 1.0, hb_j) == jt.tile_geometry(js, 1.0, hb_j)
    assert tt.tile_geometry(ts, 1.0) == jt.tile_geometry(js, 1.0)
    if hb_j is not None:
        assert tt.span_geometry(ts, 1.0, hb_j) == \
            jt.span_geometry(js, 1.0, hb_j)
    # shapes only: no pool is allocated on either side
    jpool, jtable = jax.eval_shape(lambda: jt.init_tiled(p, js, 1.0))
    tpool, ttable = tt.init_tiled(p, ts, 1.0, device="meta")
    assert tuple(tpool.shape) == jpool.shape
    assert tuple(ttable.shape) == jtable.shape
    assert tpool.dtype == torch.bfloat16 and ttable.dtype == torch.int32
    if geom == "config3":
        assert tuple(tpool.shape) == (20480, 56, 1024)
        assert tuple(ttable.shape) == (1024, 18)
    if geom in ("kspan", "0.02m"):
        assert tt.span_of(ts, 1.0, tpool.shape[1]) >= 3


def _plans(table, t0, n_phys, kspan):
    j = [np.asarray(x) for x in jax.jit(jt.tiled_plan, static_argnums=(2, 3))(
        jnp.asarray(table), jnp.asarray(t0), n_phys, kspan)]
    t = [x.numpy() for x in tt.tiled_plan(torch.from_numpy(table),
                                          torch.from_numpy(t0), n_phys,
                                          kspan)]
    return j, t


@pytest.mark.parametrize("kspan", [2, 3])
def test_tiled_plan_matches_jax(kspan):
    """The sequence of ``test_tiled_plan_invariants`` (all shared, then
    exclusive, then everything relabelled onto one row), then random
    tables with sharing."""
    nb = 5
    n_phys = P * nb + kspan * P
    t0 = np.array([0, 0, 1, 2, 2, 2, 1, 0], np.int32)
    if kspan == 2:
        t0[3:6] = [2, 3, 3]
    table = np.zeros((P, nb), np.int32)
    (js, jd, jtab), (ts, td, ttab) = _plans(table, t0, n_phys, kspan)
    for a, b in ((js, ts), (jd, td), (jtab, ttab)):
        np.testing.assert_array_equal(b, a)
    (_, jd2, _), (_, td2, _) = _plans(ttab, t0, n_phys, kspan)
    np.testing.assert_array_equal(td2, jd2)
    relabeled = ttab[np.zeros(P, np.int64)]
    (js3, jd3, jt3), (ts3, td3, tt3) = _plans(relabeled, t0, n_phys, kspan)
    for a, b in ((js3, ts3), (jd3, td3), (jt3, tt3)):
        np.testing.assert_array_equal(b, a)
    rng = np.random.default_rng(kspan)
    for _ in range(3):
        table = rng.integers(0, P * nb, (P, nb)).astype(np.int32)
        t0 = rng.integers(0, nb - kspan + 1, P).astype(np.int32)
        j, t = _plans(table, t0, n_phys, kspan)
        for a, b in zip(j, t):
            np.testing.assert_array_equal(b, a)


def _random_state(spec, seed):
    """A tiled pool with random log-odds (~30 % zeros, zero column tail)
    and a random table sharing tiles."""
    rng = np.random.default_rng(seed)
    jpool, jtable = jt.init_tiled(P, JSpec(*GEOMS[spec]), 1.0)
    nb = jtable.shape[1]
    pool = rng.normal(scale=1.5, size=jpool.shape).astype(np.float32)
    pool[rng.uniform(size=pool.shape) < 0.3] = 0.0
    pool[:, :, TSpec(*GEOMS[spec]).cols:] = 0.0
    table = rng.integers(0, P * nb, (P, nb)).astype(np.int32)
    return pool, table


def _step_inputs(spec, rng, step):
    s = GEOMS[spec]
    poses = np.stack([rng.uniform(s[0] + 0.1, s[0] + s[2] - 0.1, P),
                      rng.uniform(s[1] + 0.1, s[1] + s[3] - 0.1, P),
                      rng.uniform(-3.0, 3.0, P)], -1).astype(np.float32)
    if step == 1:  # r0/t0 clamp at both y-edges
        poses[0, 1] = s[1] + 0.01
        poses[1, 1] = s[1] + s[3] - 0.01
    dist = rng.uniform(0.1, 1.0, B).astype(np.float32)
    valid = rng.uniform(size=B) < 0.8
    present = np.ones(B, bool)
    present[350:] = False
    anc = np.sort(rng.integers(0, P // 2, P)).astype(np.int32)
    return poses, dist, valid, present, anc


def _bf(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("geom,static", [("2band", True), ("2band", False),
                                         ("wide", False), ("kspan", True)])
def test_tiled_update_matches_jax(geom, static):
    js, ts = JSpec(*GEOMS[geom]), TSpec(*GEOMS[geom])
    pool, table = _random_state(geom, 1)
    jpool = jnp.asarray(pool).astype(jnp.bfloat16)
    jtab = jnp.asarray(table)
    tpool = torch.from_numpy(pool).to(torch.bfloat16)
    ttab = torch.from_numpy(table)
    rng = np.random.default_rng(2)
    dphi = 2 * np.pi / B
    a0 = np.float32(0.05)
    for step in range(3):
        poses, dist, valid, present, anc = _step_inputs(geom, rng, step)
        jpool, jtab, jl = jt.fused_update_tiled(
            jpool, jtab, poses, a0, dist, valid, present, js, B, 1.0,
            dphi=dphi if static else jnp.float32(dphi), interpret=True,
            ancestors=jnp.asarray(anc))
        tpool, ttab, tl = tt.fused_update_tiled(
            tpool, ttab, torch.from_numpy(poses), torch.tensor(a0),
            torch.from_numpy(dist), torch.from_numpy(valid),
            torch.from_numpy(present), ts, B, 1.0,
            dphi=dphi if static else torch.tensor(dphi, dtype=torch.float32),
            ancestors=torch.from_numpy(anc))
        if geom != "kspan":
            np.testing.assert_array_equal(ttab.numpy(), np.asarray(jtab))
        jm = _bf(jt.materialize(jpool, jtab, js))
        tm = tt.materialize(tpool, ttab, ts).float().numpy()
        flip = float((np.abs(tm - jm) > 0.01).mean())
        assert flip < FLIP_GATE, f"step {step}: flip fraction {flip}"
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   rtol=LIK_RTOL, atol=LIK_ATOL)
        assert (tm[:, :, ts.cols:] == 0).all()


@pytest.mark.parametrize("scan", ["within", "far"])
@pytest.mark.parametrize("geom", ["2band", "wide", "kspan"])
def test_tiled_plain_is_dense_plain(geom, scan):
    """The tiled plain update on materialized maps is bitwise the dense
    plain update with the same lineage, whatever window row origin each
    picks, as long as the scan stays in range.  With beams past the range
    (``far``: a third out to 5 m) a particle within half a window of the
    top edge differs where the bands run past the grid: the tiled window
    origin clips into the band padding and the dense one into the grid,
    so over-range beams mark other rows and see other endpoints (both
    packages pick their origins so).  Every particle whose two windows
    start on the same row stays bitwise equal."""
    ts = TSpec(*GEOMS[geom])
    pool, table = _random_state(geom, 3)
    tpool = torch.from_numpy(pool).to(torch.bfloat16)
    ttab = torch.from_numpy(table)
    rng = np.random.default_rng(4)
    for step in range(3):
        poses, dist, valid, present, anc = _step_inputs(geom, rng, step)
        if scan == "far":
            dist[::3] = rng.uniform(1.0, 5.0, dist[::3].shape)
        args = (torch.from_numpy(poses), 0.05, torch.from_numpy(dist),
                torch.from_numpy(valid), torch.from_numpy(present), ts, B,
                1.0)
        anc_t = torch.from_numpy(anc)
        dense = tt.materialize(tpool, ttab, ts).contiguous()
        dg, dl = tf.fused_update(dense, *args, dphi=2 * np.pi / B,
                                 ancestors=anc_t)
        same = tt.plan_step(tpool, ttab, *args, dphi=2 * np.pi / B,
                            ancestors=anc_t).prep.r0 == tf.prepare(
            ts.rows, dense.shape[2], *args[:5], ts, B, 1.0,
            2 * np.pi / B).r0
        tpool, ttab, tl = tt.fused_update_tiled(
            tpool, ttab, *args, dphi=2 * np.pi / B, ancestors=anc_t)
        if scan == "within":
            same[:] = True
        elif step == 1 and geom != "kspan":  # padded rows past the grid:
            assert not bool(same[1])  # the top-edge windows start apart
        assert torch.equal(tt.materialize(tpool, ttab, ts)[same], dg[same])
        assert torch.equal(tl[same], dl[same])


def test_tiled_wrapper_rejects_bad_inputs_before_any_launch():
    ts = TSpec(*GEOMS["2band"])
    pool, table = tt.init_tiled(P, ts, 1.0, device="meta")
    poses = torch.zeros(P, 3, device="meta")
    scan = (0.0, torch.ones(B, device="meta"),
            torch.ones(B, dtype=torch.bool, device="meta"),
            torch.ones(B, dtype=torch.bool, device="meta"), ts, B, 1.0)
    with pytest.raises(TypeError):
        tt.fused_update_tiled(pool.half(), table, poses, *scan)
    with pytest.raises(ValueError, match="table"):
        tt.fused_update_tiled(pool, table.long(), poses, *scan)
    with pytest.raises(ValueError, match="poses"):
        tt.fused_update_tiled(pool, table, poses[:3], *scan)
    with pytest.raises(ValueError, match="ancestors"):
        tt.fused_update_tiled(pool, table, poses, *scan,
                              ancestors=torch.zeros(P, device="meta"))
    with pytest.raises(ValueError, match="cuda or cpu"):
        tt.fused_update_tiled(pool, table, poses, *scan)
    with pytest.raises(ValueError, match="too small"):
        tt.tiled_plan(torch.zeros(P, 5, dtype=torch.int32),
                      torch.zeros(P, dtype=torch.int32), P * 5 + P)


@pytest.mark.parametrize("scan", ["within", "over_range", "edges"])
@pytest.mark.parametrize("geom", ["2band", "kspan"])
def test_tiled_plain_changes_only_the_box(geom, scan):
    """Over an update with a lineage relabel, the materialized maps change
    only inside the box, by value, with beams inside the range, beams
    past it (out to 5 m, past the quantizer's cap), and poses on the
    grid's column and row edges."""
    ts = TSpec(*GEOMS[geom])
    x, y, w, h, _ = GEOMS[geom]
    pool, table = _random_state(geom, 5)
    tpool = torch.from_numpy(pool).to(torch.bfloat16)
    ttab = torch.from_numpy(table)
    rng = np.random.default_rng(6)
    poses, dist, valid, present, anc = _step_inputs(geom, rng, 0)
    if scan == "over_range":
        dist[::3] = rng.uniform(1.0, 5.0, dist[::3].shape)
    if scan == "edges":
        poses[0, 0], poses[1, 0] = x + 0.01, x + w - 0.01
        poses[2, 1], poses[3, 1] = y + 0.01, y + h - 0.01
        poses[4, :2] = x + 0.01, y + 0.01
        poses[5, :2] = x + w - 0.01, y + h - 0.01
    args = (torch.from_numpy(poses), 0.05, torch.from_numpy(dist),
            torch.from_numpy(valid), torch.from_numpy(present), ts, B, 1.0)
    anc = torch.from_numpy(anc)
    before = tt.materialize(tpool, ttab[anc.long()])
    step = tt.plan_step(tpool, ttab, *args, dphi=2 * np.pi / B,
                        ancestors=anc)
    tpool, ttab, _ = tt.fused_update_tiled(tpool, ttab, *args,
                                           dphi=2 * np.pi / B, ancestors=anc)
    after = tt.materialize(tpool, ttab)
    p, rows, cols = after.shape
    y0, y1, x0, x1 = tf.cell_pass_box(step.prep, cols)
    gy = torch.arange(rows)[None, :] - step.prep.r0.long()[:, None]
    gx = torch.arange(cols)[None, :]
    box = (((gy >= y0.long()[:, None]) & (gy < y1.long()[:, None]))[:, :, None]
           & ((gx >= x0.long()[:, None]) & (gx < x1.long()[:, None]))[:, None])
    changed = after != before
    assert changed.any() and not (changed & ~box).any()
    if scan == "over_range":  # wider than the disc of max_range_m
        assert bool(((x1 - x0) > 2 * (tf.disc_half(ts, 1.0) + 2)).any())
