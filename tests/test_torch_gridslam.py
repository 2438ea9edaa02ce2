"""slamrs_tpu_torch.models.gridslam against slamrs_tpu.models.gridslam.

Five consecutive fused-path updates (16 particles) on simulated scans of
the ``grid_slam_fused.yaml`` scene, both packages fed the same injected
draws (the JAX package's ``derive_noise``).  Gates: resample ancestors
identical at every step; weights rtol 1e-4 (likelihood sums of ~300
beams taken in another order, then exponentiated); best pose atol 1e-4 m;
final maps' flip fraction (cells with |diff| > 0.01) below 1e-3 (atan2
bin flips of the TPU kernel's polynomial compound over the updates).

The dda and dense integrators (16 particles at 0.05 m) under the same
injected draws: ancestors identical, poses within 1e-5 m, maps at
``tests/test_parity.py``'s gate (>= 99.9 % of cells within 5e-3, signs
of touched cells on >= 99.9 %); the port's dda against
``tests/parity_oracle.py`` at ``tests/test_parity.py``'s gates; the
port's dense and fused paths against its dda at
``tests/test_path_deviation.py``'s.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from slamrs_tpu.core import motion as jmotion  # noqa: E402
from slamrs_tpu.core.types import OdometryReading as JOdo  # noqa: E402
from slamrs_tpu.core.types import Scan as JScan  # noqa: E402
from slamrs_tpu.models import gridslam as jgs  # noqa: E402
from slamrs_tpu.models import simulator as jsim  # noqa: E402
from slamrs_tpu_torch.core.types import OdometryReading, Scan  # noqa: E402
from slamrs_tpu_torch.models import gridslam as tgs  # noqa: E402

P = 16
STEPS = 5
TICKS_PER_SCAN = 6
DT = np.float32(1.0 / 30.0)


def _config(cls, frac, dtype):
    return cls(position_x=-2.0, position_y=-2.0, width=4.0, height=4.0,
               resolution=0.05, n_particles=P, max_scan_range=1.0,
               integrate="fused", resample_neff_frac=frac, grid_dtype=dtype)


def _frames():
    """(scan, odometry) numpy pairs along a curving drive."""
    scene = jsim.Scene.build(
        rects=[(-1.0, -1.0, 2.0, 2.0), (-0.1, -0.4, 0.5, 0.1),
               (-0.6, 0.4, 0.2, 0.5)], lines=[(-0.6, -0.4, 0.2, 0.4)])
    pose = jnp.zeros(3, jnp.float32)
    sl, sr = np.float32(0.05) * DT, np.float32(0.08) * DT
    frames = []
    for _ in range(STEPS):
        al = ar = np.float32(0.0)
        for _ in range(TICKS_PER_SCAN):
            pose = jmotion.integrate_exact(pose, sl, sr, np.float32(0.1))
            al, ar = np.float32(al + sl), np.float32(ar + sr)
        scan = jsim.lidar_scan(pose, scene, np.float32(1.0))
        frames.append((tuple(np.asarray(x) for x in scan),
                       (al, ar, np.float32(0.1))))
    return frames


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("frac", [0.5, 1.0])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_updates_match_jax(frac, dtype):
    jcfg = _config(jgs.GridSlamConfig, frac, dtype)
    tcfg = _config(tgs.GridSlamConfig, frac, dtype)
    jst = jgs.GridSlamState.init(jcfg)
    tst = tgs.GridSlamState.init(tcfg, "cpu")
    assert tst.grids.shape == jst.grids.shape
    keys = jax.random.split(jax.random.key(3), STEPS)
    for k, (scan, odo) in zip(keys, _frames()):
        noise = jgs.derive_noise(k, P)
        jst, jout = jgs.update(jst, JScan(*scan), JOdo(*odo), None, jcfg,
                               noise=noise)
        tst, tout = tgs.update(
            tst, Scan(*(_t(x) for x in scan)),
            OdometryReading(*(torch.tensor(v) for v in odo)), tcfg,
            noise=tgs.UpdateNoise(*(_t(x) for x in noise)))
        np.testing.assert_array_equal(tst.ancestors.numpy(),
                                      np.asarray(jst.ancestors))
        np.testing.assert_allclose(tst.weights.numpy(),
                                   np.asarray(jst.weights), rtol=1e-4)
        np.testing.assert_allclose(tout.pose.numpy(), np.asarray(jout.pose),
                                   atol=1e-4)
        np.testing.assert_allclose(float(tout.n_eff), float(jout.n_eff),
                                   rtol=1e-3)
        assert bool(tout.resampled) == bool(jout.resampled)
    jg = np.asarray(jst.grids.astype(jnp.float32))
    flip = float((np.abs(tst.grids.float().numpy() - jg) > 0.01).mean())
    assert flip < 1e-3, flip


def test_config_fields_and_defaults_match():
    jf = {f.name: f.default for f in dataclasses.fields(jgs.GridSlamConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(tgs.GridSlamConfig)}
    assert tf == jf
    cfg = _config(tgs.GridSlamConfig, 0.5, "bfloat16")
    jcfg = _config(jgs.GridSlamConfig, 0.5, "bfloat16")
    assert cfg.padded_cols == jcfg.padded_cols
    assert (cfg.grid_spec.rows, cfg.grid_spec.cols) == \
        (jcfg.grid_spec.rows, jcfg.grid_spec.cols)


@pytest.mark.parametrize("change", [
    dict(integrate="dda"), dict(integrate="dense"),
    dict(resample_cow="deferred"),
    dict(resample_cow="deferred", fused_resident=True),
    dict(resample_cow="copy")])
def test_unported_paths_raise(change):
    """The dda and dense integrators are accepted: their maps are the JAX
    package's unpadded ``f32[P, H, W]`` whatever ``grid_dtype`` says, and
    an unknown ``integrate`` raises ValueError.  The dead-end
    ``resample_cow="deferred"`` and unknown values raise ValueError."""
    cfg = dataclasses.replace(_config(tgs.GridSlamConfig, 0.5, "float32"),
                              **change)
    if "integrate" in change:
        cfg = dataclasses.replace(cfg, grid_dtype="bfloat16")
        jcfg = dataclasses.replace(
            _config(jgs.GridSlamConfig, 0.5, "bfloat16"), **change)
        tst = tgs.GridSlamState.init(cfg, "cpu")
        jst = jgs.GridSlamState.init(jcfg)
        for name in ("poses", "grids", "weights", "best_pose", "ancestors"):
            t, j = getattr(tst, name), np.asarray(getattr(jst, name))
            assert tuple(t.shape) == j.shape, name
            assert str(t.dtype).split(".")[-1] == j.dtype.name, name
        assert tst.grids.shape == (P, 80, 80) and tst.tile_table is None
        assert tgs.resample_mechanism(cfg, tst) == "gather"
        with pytest.raises(ValueError, match="integrate"):
            tgs.GridSlamState.init(
                dataclasses.replace(cfg, integrate=change["integrate"] + "x"),
                "cpu")
        return
    with pytest.raises(ValueError, match="ROADMAP"):
        tgs.GridSlamState.init(cfg, "cpu")


def test_fused_resident_is_accepted_and_ignored():
    """``fused_resident`` changes the resample mechanism, never the
    storage."""
    cfg = _config(tgs.GridSlamConfig, 0.5, "float32")
    a = tgs.GridSlamState.init(cfg, "cpu")
    b = tgs.GridSlamState.init(dataclasses.replace(cfg, fused_resident=False),
                               "cpu")
    assert a.grids.shape == b.grids.shape and a.grids.dtype == b.grids.dtype


# ---------------------------------------------------------------------------
# Resample mechanisms.  The JAX package picks one of four per update
# (tiled / deferred lineage / copy-on-write / whole-set gather,
# slamrs_tpu/models/gridslam.py:320-385,439-478); the mechanism fixes the
# slot order after a resample, and the injected draws are indexed by slot,
# so port and JAX package agree slot by slot only if they pick the same one.

WIDE = dict(position_x=-12.8, position_y=-6.4, width=25.6, height=12.8)
B = 360
P8 = 8


def _mech_config(cls, frac, geom=WIDE, **kw):
    return cls(**geom, resolution=0.05, n_particles=P8, max_scan_range=1.0,
               integrate="fused", grid_dtype="bfloat16",
               resample_neff_frac=frac, **kw)


def _random_scan(seed):
    """A 360-beam scan inside the range clamp (distances <= 1 m)."""
    rng = np.random.default_rng(seed)
    dist = rng.uniform(0.1, 1.0, B).astype(np.float32)
    valid = rng.uniform(size=B) < 0.8
    present = np.ones(B, bool)
    present[350:] = False
    angles = (np.arange(B) * (2 * np.pi / B)).astype(np.float32)
    return angles, dist, np.ones(B, np.float32), valid, present


ODO = (np.float32(0.02), np.float32(0.03), np.float32(0.2))


def _step_both(jst, tst, jcfg, tcfg, step, seed=0):
    scan = _random_scan(400 + 17 * seed + step)
    noise = jgs.derive_noise(jax.random.key(500 + 17 * seed + step), P8)
    jst, jout = jgs.update(jst, JScan(*scan), JOdo(*ODO), None, jcfg,
                           noise=noise)
    tst, tout = tgs.update(
        tst, Scan(*(_t(x) for x in scan)),
        OdometryReading(*(torch.tensor(v) for v in ODO)), tcfg,
        noise=tgs.UpdateNoise(*(_t(x) for x in noise)))
    return jst, jout, tst, tout


def _assert_slots_equal(jst, jout, tst, tout):
    """Poses slot by slot, then weights, then the output pose."""
    np.testing.assert_allclose(tst.poses.numpy(), np.asarray(jst.poses),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(tst.weights.numpy(), np.asarray(jst.weights),
                               rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(tout.pose.numpy(), np.asarray(jout.pose),
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tst.ancestors.numpy(),
                                  np.asarray(jst.ancestors))


def test_mechanism_fault_wide_not_resident_matches_jax():
    """``fused_resident=False`` on a map wider than 256 padded columns:
    the JAX package resamples by copy-on-write there, so the port must
    too; a port that always defers the lineage diverges after the first
    resample."""
    jcfg = _mech_config(jgs.GridSlamConfig, 1.0, fused_resident=False)
    tcfg = _mech_config(tgs.GridSlamConfig, 1.0, fused_resident=False)
    jst = jgs.GridSlamState.init(jcfg)
    tst = tgs.GridSlamState.init(tcfg, "cpu")
    for step in range(3):
        jst, jout, tst, tout = _step_both(jst, tst, jcfg, tcfg, step)
        _assert_slots_equal(jst, jout, tst, tout)


SPEC = dict(position_x=-3.2, position_y=-6.4, width=6.4, height=12.8)


def _maps_flip(tst, jst, tcfg):
    from slamrs_tpu.ops import tiles as jtiles
    from slamrs_tpu_torch.ops import tiles as ttiles

    tm = ttiles.materialize(tst.grids, tst.tile_table[tst.ancestors.long()],
                            tcfg.grid_spec).float().numpy()
    jm = np.asarray(jtiles.materialize(
        jst.grids, jst.tile_table[jst.ancestors], jcfg_spec(tcfg))
        .astype(jnp.float32))
    assert (tm[:, :, tcfg.grid_spec.cols:] == 0).all()
    return float((np.abs(tm - jm) > 0.01).mean())


def jcfg_spec(tcfg):
    from slamrs_tpu.ops.grid import GridSpec2D as JSpec

    s = tcfg.grid_spec
    return JSpec(s.position_x, s.position_y, s.width, s.height, s.resolution)


@pytest.mark.parametrize("frac", [1.0, 0.0])
def test_gridslam_tiled_matches_jax(frac):
    """``resample_cow="tiled"``: the band-table relabel with pending
    lineage in both packages; poses, weights and tables slot by slot,
    materialized maps within the flip gate."""
    jcfg = _mech_config(jgs.GridSlamConfig, frac, SPEC, resample_cow="tiled")
    tcfg = _mech_config(tgs.GridSlamConfig, frac, SPEC, resample_cow="tiled")
    jst = jgs.GridSlamState.init(jcfg)
    tst = tgs.GridSlamState.init(tcfg, "cpu")
    assert tst.grids.shape == jst.grids.shape
    assert tgs.resample_mechanism(tcfg, tst) == "tiled"
    for step in range(3):
        jst, jout, tst, tout = _step_both(jst, tst, jcfg, tcfg, step, seed=1)
        _assert_slots_equal(jst, jout, tst, tout)
        np.testing.assert_array_equal(tst.tile_table.numpy(),
                                      np.asarray(jst.tile_table))
        assert _maps_flip(tst, jst, tcfg) < 1e-4
    # the estimated map goes through one particle's tiles
    tp = tgs.estimated_probability_grid(tst, tcfg).numpy()
    jp = np.asarray(jgs.estimated_probability_grid(jst, jcfg))
    assert tp.shape == jp.shape == tcfg.grid_spec.shape
    assert float((np.abs(tp - jp) > 2e-3).mean()) < 1e-4


def test_auto_tiled_selection_matches_jax(monkeypatch):
    """With the auto threshold lowered on both sides, ``resample_cow=None``
    stores tile pools in both packages and updates them alike."""
    monkeypatch.setattr(jgs, "_AUTO_TILED_BYTES", 1 << 16)
    monkeypatch.setattr(tgs, "_AUTO_TILED_BYTES", 1 << 16)
    jcfg = _mech_config(jgs.GridSlamConfig, 1.0, SPEC)
    tcfg = _mech_config(tgs.GridSlamConfig, 1.0, SPEC)
    assert tgs.auto_tiled(tcfg) and jgs.auto_tiled(jcfg)
    assert not tgs.auto_tiled(dataclasses.replace(tcfg, resample_cow=True))
    jst = jgs.GridSlamState.init(jcfg)
    tst = tgs.GridSlamState.init(tcfg, "cpu")
    assert tst.tile_table is not None and jst.tile_table is not None
    assert tst.grids.shape == jst.grids.shape
    for step in range(2):
        jst, jout, tst, tout = _step_both(jst, tst, jcfg, tcfg, step, seed=2)
        _assert_slots_equal(jst, jout, tst, tout)
        assert _maps_flip(tst, jst, tcfg) < 1e-4


@pytest.mark.parametrize("geom,change,want", [
    (WIDE, dict(fused_resident=False), "cow"),
    (WIDE, dict(), "deferred"),
    (WIDE, dict(fused_resident=False, resample_cow=True), "cow"),
    (WIDE, dict(fused_resident=False, resample_cow=False), "gather"),
    (WIDE, dict(fused_resident=True, resample_cow=False), "deferred"),
    (WIDE, dict(fused_resident=True, resample_cow="staged"), "deferred"),
    (SPEC, dict(fused_resident=False), "cow"),
    (SPEC, dict(resample_cow="tiled"), "tiled")])
def test_resample_mechanism_table(geom, change, want):
    cfg = _mech_config(tgs.GridSlamConfig, 1.0, geom, **change)
    assert tgs.resample_mechanism(cfg, tgs.GridSlamState.init(cfg, "cpu")) \
        == want


def test_resample_mechanism_errors_match_jax():
    pinned = _mech_config(tgs.GridSlamConfig, 1.0, WIDE,
                          fused_resident=False, resample_cow="staged")
    with pytest.raises(ValueError, match="staged"):
        tgs.resample_mechanism(pinned, tgs.GridSlamState.init(pinned, "cpu"))
    tiled = _mech_config(tgs.GridSlamConfig, 1.0, SPEC, resample_cow="tiled")
    dense = _mech_config(tgs.GridSlamConfig, 1.0, SPEC)
    with pytest.raises(ValueError, match="tile_table"):
        tgs.resample_mechanism(
            dataclasses.replace(tiled, resample_cow=True),
            tgs.GridSlamState.init(tiled, "cpu"))
    with pytest.raises(ValueError, match="no tile pool"):
        tgs.resample_mechanism(tiled, tgs.GridSlamState.init(dense, "cpu"))


def test_estimated_probability_grid_dense_matches_jax():
    jcfg = _mech_config(jgs.GridSlamConfig, 1.0, SPEC)
    tcfg = _mech_config(tgs.GridSlamConfig, 1.0, SPEC)
    jst = jgs.GridSlamState.init(jcfg)
    tst = tgs.GridSlamState.init(tcfg, "cpu")
    for step in range(2):
        jst, jout, tst, tout = _step_both(jst, tst, jcfg, tcfg, step, seed=3)
    tp = tgs.estimated_probability_grid(tst, tcfg).numpy()
    jp = np.asarray(jgs.estimated_probability_grid(jst, jcfg))
    assert tp.shape == jp.shape == tcfg.grid_spec.shape
    assert float((np.abs(tp - jp) > 2e-3).mean()) < 1e-4


def test_tiled_state_carried_over_from_jax():
    """A JAX tiled state (pool, table, pending lineage) through
    ``convert.grid_state_from_numpy``; one port update from it equals one
    JAX update."""
    from slamrs_tpu_torch import convert

    jcfg = _mech_config(jgs.GridSlamConfig, 1.0, SPEC, resample_cow="tiled")
    tcfg = _mech_config(tgs.GridSlamConfig, 1.0, SPEC, resample_cow="tiled")
    jst = jgs.GridSlamState.init(jcfg)
    scan = _random_scan(90)
    noise = jgs.derive_noise(jax.random.key(91), P8)
    jst, _ = jgs.update(jst, JScan(*scan), JOdo(*ODO), None, jcfg,
                        noise=noise)
    tst = convert.grid_state_from_numpy(
        *(np.asarray(x) for x in jst[:6]), device="cpu",
        tile_table=np.asarray(jst.tile_table))
    assert tst.grids.dtype == torch.bfloat16
    assert tst.tile_table.dtype == torch.int32
    assert not np.array_equal(tst.ancestors.numpy(), np.arange(P8))
    jst, jout, tst, tout = _step_both(jst, tst, jcfg, tcfg, 1, seed=4)
    _assert_slots_equal(jst, jout, tst, tout)
    np.testing.assert_array_equal(tst.tile_table.numpy(),
                                  np.asarray(jst.tile_table))
    assert _maps_flip(tst, jst, tcfg) < 1e-4


# ---------------------------------------------------------------------------
# The dda (fidelity) and dense integrators (slamrs_tpu/models/gridslam.py:
# 401-416): the likelihood on the old maps at the sampled poses, the old
# maps integrated at the same poses, the whole-set gather.


def _nonfused_config(cls, integrate, frac, p=P):
    return cls(position_x=-2.0, position_y=-2.0, width=4.0, height=4.0,
               resolution=0.05, n_particles=p, max_scan_range=1.0,
               integrate=integrate, resample_neff_frac=frac)


def _occupancy_gate(tg, jg):
    """``tests/test_parity.py``'s map gate: >= 99.9 % of cells within 5e-3
    and the touched cells' signs agreeing on >= 99.9 %."""
    assert tg.shape == jg.shape
    agree = float((np.abs(tg - jg) <= 5e-3).mean())
    assert agree >= 0.999, agree
    touched = np.abs(jg) > 1e-6
    sign = float((np.sign(tg[touched]) == np.sign(jg[touched])).mean())
    assert sign >= 0.999, sign


@pytest.mark.parametrize("frac", [0.5, 1.0])
@pytest.mark.parametrize("integrate", ["dda", "dense"])
def test_nonfused_updates_match_jax(integrate, frac):
    """Five updates under the JAX package's injected draws: ancestors
    identical, poses within 1e-5 m, weights rtol 1e-4, maps at the
    occupancy gate."""
    jcfg = _nonfused_config(jgs.GridSlamConfig, integrate, frac)
    tcfg = _nonfused_config(tgs.GridSlamConfig, integrate, frac)
    jst = jgs.GridSlamState.init(jcfg)
    tst = tgs.GridSlamState.init(tcfg, "cpu")
    assert tst.grids.shape == jst.grids.shape == (P, 80, 80)
    keys = jax.random.split(jax.random.key(5), STEPS)
    for k, (scan, odo) in zip(keys, _frames()):
        noise = jgs.derive_noise(k, P)
        jst, jout = jgs.update(jst, JScan(*scan), JOdo(*odo), None, jcfg,
                               noise=noise)
        tst, tout = tgs.update(
            tst, Scan(*(_t(x) for x in scan)),
            OdometryReading(*(torch.tensor(v) for v in odo)), tcfg,
            noise=tgs.UpdateNoise(*(_t(x) for x in noise)))
        np.testing.assert_array_equal(tst.ancestors.numpy(), np.arange(P))
        np.testing.assert_allclose(tst.poses.numpy(), np.asarray(jst.poses),
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(tst.weights.numpy(),
                                   np.asarray(jst.weights), rtol=1e-4)
        np.testing.assert_allclose(tout.pose.numpy(), np.asarray(jout.pose),
                                   rtol=0, atol=1e-5)
        assert bool(tout.resampled) == bool(jout.resampled)
        assert tst.grids.dtype == torch.float32
        _occupancy_gate(tst.grids.numpy(), np.asarray(jst.grids))


def _oracle_scans(T=6):
    """``tests/test_parity.py``'s simulated trajectory: scans and
    odometry."""
    scene = jsim.Scene.build(
        rects=[(-1.0, -1.0, 2.0, 2.0), (-0.1, -0.4, 0.5, 0.1)],
        lines=[(-0.6, -0.4, 0.2, 0.4)])
    pose = jnp.zeros(3)
    out = []
    for t in range(T):
        sl, sr = np.float32(0.004 + 0.001 * t), np.float32(0.006)
        pose = jmotion.integrate_exact(pose, jnp.float32(sl),
                                       jnp.float32(sr), 0.1)
        scan = jsim.lidar_scan(pose, scene, 1.0, 360)
        out.append((tuple(np.asarray(x) for x in scan),
                    (sl, sr, np.float32(0.1))))
    return out


def test_dda_matches_parity_oracle():
    """The port's dda against ``tests/parity_oracle.py`` (a line-by-line
    port of the reference) on the same draws, at ``tests/test_parity.py``'s
    gates: lineage identical (poses within 1e-5 m every step), best-pose
    RMSE <= 1e-3 m, >= 99.9 % of cells within 5e-3, signs of touched cells
    on >= 99.9 %."""
    import parity_oracle as oracle
    from slamrs_tpu_torch.core import motion as tmotion

    p = 8
    cfg = _nonfused_config(tgs.GridSlamConfig, "dda", 1.0, p)
    state = tgs.GridSlamState.init(cfg, "cpu")
    orc = oracle.GridMapSlam(cfg.position_x, cfg.position_y, cfg.width,
                             cfg.height, cfg.resolution, p)
    keys = jax.random.split(jax.random.key(0), 6)
    best_t, best_o = [], []
    for t, (k, (scan, odo)) in enumerate(zip(keys, _oracle_scans())):
        noise = tgs.UpdateNoise(*(_t(x) for x in jgs.derive_noise(k, p)))
        todo = OdometryReading(*(torch.tensor(v) for v in odo))
        sampled = tmotion.sample(state.poses, todo.distance_left,
                                 todo.distance_right, todo.wheel_base,
                                 eps=(noise.eps_c, noise.eps_t))
        state, out = tgs.update(state, Scan(*(_t(x) for x in scan)), todo,
                                cfg, noise=noise)
        angles, dist, _, valid, present = scan
        orc.update({"angles": angles.astype(np.float64),
                    "distances": dist.astype(np.float64), "valid": valid,
                    "present": present}, float(odo[0]), float(odo[1]),
                   float(odo[2]), sampled.numpy().astype(np.float64),
                   float(noise.u01[0]) / p)
        best_t.append(out.pose.numpy().astype(np.float64))
        best_o.append(orc.best_pose)
        np.testing.assert_allclose(state.poses.numpy(), np.stack(orc.poses),
                                   atol=1e-5,
                                   err_msg=f"lineage diverges at step {t}")
    err = np.stack(best_t)[:, :2] - np.stack(best_o)[:, :2]
    assert np.sqrt((err ** 2).mean()) <= 1e-3
    grids_o = np.stack([m.odds for m in orc.maps])
    _occupancy_gate(state.grids.numpy().astype(np.float64), grids_o)


def test_fast_paths_match_port_dda_statistically():
    """``tests/test_path_deviation.py`` on the port: the same rollout (same
    draws, same commands) through dda, dense and fused; best-particle pose
    RMSE against dda <= 2 cells, occupancy classification agreement >= 90 %
    of the cells either path touched."""
    from slamrs_tpu_torch.core import motion as tmotion
    from slamrs_tpu_torch.models import simulator as tsim

    p, steps, res = 6, 6, 0.05
    scene = tsim.Scene.build(
        rects=[(-1.0, -1.0, 2.0, 2.0), (-0.1, -0.4, 0.5, 0.1)],
        lines=[(-0.6, -0.4, 0.2, 0.4)], device="cpu")
    # the draws of tests/test_path_deviation.py's key chain
    key, draws = jax.random.key(7), []
    for _ in range(steps):
        key, k = jax.random.split(key)
        draws.append(tgs.UpdateNoise(*(_t(x)
                                       for x in jgs.derive_noise(k, p))))

    def rollout(integrate):
        cfg = _nonfused_config(tgs.GridSlamConfig, integrate, 1.0, p)
        state = tgs.GridSlamState.init(cfg, "cpu")
        pose = torch.zeros(3)
        sl, sr = torch.tensor(0.004), torch.tensor(0.0065)
        best = []
        for noise in draws:
            pose = tmotion.integrate_exact(pose, sl, sr, 0.1)
            scan = tsim.lidar_scan(pose, scene, 1.0, 360)
            state, out = tgs.update(state, scan,
                                    OdometryReading(sl, sr, torch.tensor(0.1)),
                                    cfg, noise=noise)
            best.append(out.pose.numpy())
        return (np.stack(best),
                tgs.estimated_probability_grid(state, cfg).numpy())

    def cls(g):
        return np.where(g > 0.6, 1, np.where(g < 0.4, -1, 0))

    poses_dda, grid_dda = rollout("dda")
    for name in ("dense", "fused"):
        poses, grid = rollout(name)
        assert grid.shape == grid_dda.shape == (80, 80)
        rmse = float(np.sqrt(((poses[:, :2] - poses_dda[:, :2]) ** 2).mean()))
        assert rmse <= 2 * res, f"{name} pose RMSE vs dda: {rmse}"
        a, b = cls(grid_dda), cls(grid)
        touched = (a != 0) | (b != 0)
        agree = float((a[touched] == b[touched]).mean())
        print(f"{name}: pose RMSE {rmse * 1000:.1f} mm, cell agreement "
              f"{agree:.3f} over {int(touched.sum())} cells")
        assert agree >= 0.90, f"{name} occupancy agreement {agree}"


def test_chip_smoke_path_deviation_draws_match_jax():
    """``chip_smoke.py`` imports no JAX, so it carries
    ``tests/test_path_deviation.py``'s draws as numbers: they must be the
    JAX package's."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    key, rows = jax.random.key(7), []
    for _ in range(6):
        key, k = jax.random.split(key)
        rows.append(np.concatenate([np.asarray(x).ravel()
                                    for x in jgs.derive_noise(k, 6)]))
    np.testing.assert_array_equal(
        np.asarray(smoke.PATH_DEVIATION_DRAWS, np.float32), np.stack(rows))


@pytest.mark.parametrize("integrate", ["dda", "dense"])
def test_nonfused_state_carried_over_from_jax(integrate):
    """A JAX dda or dense state after two updates crosses through
    ``convert.grid_state_from_numpy``; one more update in both packages."""
    from slamrs_tpu_torch import convert

    jcfg = _nonfused_config(jgs.GridSlamConfig, integrate, 0.5)
    tcfg = _nonfused_config(tgs.GridSlamConfig, integrate, 0.5)
    frames = _frames()
    keys = jax.random.split(jax.random.key(11), 3)
    jst = jgs.GridSlamState.init(jcfg)
    for k, (scan, odo) in zip(keys[:2], frames[:2]):
        jst, _ = jgs.update(jst, JScan(*scan), JOdo(*odo), None, jcfg,
                            noise=jgs.derive_noise(k, P))
    tst = convert.grid_state_from_numpy(*(np.asarray(x) for x in jst[:6]),
                                        device="cpu")
    assert tst.grids.dtype == torch.float32 and tst.tile_table is None
    assert torch.equal(tst.grids, _t(jst.grids))
    scan, odo = frames[2]
    noise = jgs.derive_noise(keys[2], P)
    jst, jout = jgs.update(jst, JScan(*scan), JOdo(*odo), None, jcfg,
                           noise=noise)
    tst, tout = tgs.update(
        tst, Scan(*(_t(x) for x in scan)),
        OdometryReading(*(torch.tensor(v) for v in odo)), tcfg,
        noise=tgs.UpdateNoise(*(_t(x) for x in noise)))
    np.testing.assert_allclose(tst.poses.numpy(), np.asarray(jst.poses),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(tst.weights.numpy(), np.asarray(jst.weights),
                               rtol=1e-4)
    np.testing.assert_allclose(tout.pose.numpy(), np.asarray(jout.pose),
                               rtol=0, atol=1e-5)
    _occupancy_gate(tst.grids.numpy(), np.asarray(jst.grids))


def test_nonfused_rejects_a_tiled_state():
    """The JAX package's errors (gridslam.py:322-332): a tile pool under a
    dda config, and a dda config pinning ``resample_cow="tiled"``."""
    tiled = _mech_config(tgs.GridSlamConfig, 1.0, SPEC, resample_cow="tiled")
    dda = dataclasses.replace(tiled, integrate="dda", resample_cow=None)
    with pytest.raises(ValueError, match="tile_table"):
        tgs.resample_mechanism(dda, tgs.GridSlamState.init(tiled, "cpu"))
    pinned = dataclasses.replace(dda, resample_cow="tiled")
    with pytest.raises(ValueError, match="no tile pool"):
        tgs.resample_mechanism(pinned, tgs.GridSlamState.init(pinned, "cpu"))
