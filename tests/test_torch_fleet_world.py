"""Fleets in slamrs_tpu_torch: K1's world axis, the grid functions on
per-particle scans, and a fleet of worlds stepped tick by tick.

K1's plain version with the world axis (one flattened call, a beam table
per world) against the JAX kernel vmapped over worlds in interpret mode,
at ``tests/test_torch_fused.py``'s gates (flip fraction below 1e-4,
likelihood rtol 1e-5 / atol 1e-4); a one-world call, and each world of a
fleet, bitwise equal to the single-world call, its box per world.  The
grid functions on ``[P, B]`` scans bitwise equal to per-world ``[B]``
calls.

A 3-world fleet of grid SLAM (fused, 16 particles at 0.05 m), the ICP
mapper and the EKF through ``rollout_cadence`` in both packages, the
port fed the draws the JAX package makes inside its batched step (its
per-frame key split into the landmark key and the grid key, the grid key
split into one key per world), at ``tests/test_torch_world.py``'s gates:
best pose atol 1e-4 m, N_eff rtol 1e-3, ground truth atol 1e-5 m, ICP
pose atol 1e-4 m, maps' flip fraction below 1e-3.  The free-running EKF
is chaotic in float32 (a first sighting cancels the 1,000 prior): the
port's own batched and single-world runs of these draws differ by
1.6e-3 m in one world (measured on the CPU), so its free run is held to
the reference's free-running EKF gate of 2e-3 (``tests/test_torch_ekf.py``)
and one more update from the JAX package's final state, carried over by
``convert.py``, to 1e-5.  The ICP mapper and the EKF over 3 worlds
against each world updated alone, and the CLI's ``--worlds``.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from slamrs_tpu.core.types import OdometryReading as JOdo  # noqa: E402
from slamrs_tpu.graph import compile as jcompile  # noqa: E402
from slamrs_tpu.models import ekf as jekf  # noqa: E402
from slamrs_tpu.models import gridslam as jgs  # noqa: E402
from slamrs_tpu.models import icp_mapper as jmap  # noqa: E402
from slamrs_tpu.models import simulator as jsim  # noqa: E402
from slamrs_tpu.ops import fused as jf  # noqa: E402
from slamrs_tpu.ops.grid import GridSpec2D as JSpec  # noqa: E402
from slamrs_tpu_torch import convert  # noqa: E402
from slamrs_tpu_torch.__main__ import main as cli_main  # noqa: E402
from slamrs_tpu_torch.core.types import (LandmarkScan,  # noqa: E402
                                         OdometryReading)
from slamrs_tpu_torch.graph import compile as tcompile  # noqa: E402
from slamrs_tpu_torch.models import ekf as tekf  # noqa: E402
from slamrs_tpu_torch.models import gridslam as tgs  # noqa: E402
from slamrs_tpu_torch.models import icp_mapper as tmap  # noqa: E402
from slamrs_tpu_torch.ops import fused as tf  # noqa: E402
from slamrs_tpu_torch.ops import grid as tgrid  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
GRID_YAML = str(ROOT / "configs" / "grid_slam.yaml")
P = 16
W = 3
TICKS = 40
BASE = dict(position_x=-2.0, position_y=-2.0, width=4.0, height=4.0,
            resolution=0.05, n_particles=P, max_scan_range=1.0,
            integrate="fused", grid_dtype="bfloat16", resample_neff_frac=0.5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _flip(t, j):
    return float((np.abs(t.float().numpy()
                         - np.asarray(jnp.asarray(j, jnp.float32))) > 0.01)
                 .mean())


def _k1_case(seed=0, far=False):
    """Per-world scans (world 1's beams short, or with ``far`` a third of
    them past the range; world 2 with a 90-beam sector of present lanes),
    maps with ~30 % exact zeros, two poses on the edges, block-diagonal
    lineage.  Beams past the range are left out of the comparisons with
    the JAX kernel, whose lane-packed view assumes the disc of the range
    (it then differs from the JAX package's own reference)."""
    rng = np.random.default_rng(seed)
    grids = rng.normal(scale=1.5, size=(W * P, 80, 128)).astype(np.float32)
    grids[rng.uniform(size=grids.shape) < 0.3] = 0.0
    poses = np.stack([rng.uniform(-1.3, 1.3, W * P),
                      rng.uniform(-1.3, 1.3, W * P),
                      rng.uniform(-3.0, 3.0, W * P)], -1).astype(np.float32)
    poses[0, 0], poses[1, 1] = -1.99, 1.99  # on the edges
    anc = rng.integers(0, P, (W, P)).astype(np.int32)
    nb = 360
    dist = rng.uniform(0.1, 1.0, (W, nb)).astype(np.float32)
    if far:
        dist[1, ::3] = rng.uniform(1.0, 5.0, dist[1, ::3].shape)
    else:
        dist[1] *= 0.4
    valid = rng.uniform(size=(W, nb)) < 0.8
    present = rng.uniform(size=(W, nb)) < 0.9
    present[2, 90:] = False
    a0 = np.array([0.1, -0.3, 1.0], np.float32)
    return grids, poses, anc, a0, dist, valid, present


@pytest.mark.parametrize("mode", ["lineage", "in_place"])
@pytest.mark.parametrize("static", [True, False], ids=["static", "traced"])
def test_k1_world_axis_matches_jax_vmapped(mode, static):
    """One flattened plain K1 call over 3 worlds against the JAX kernel
    vmapped over worlds (interpret mode): flip fraction below 1e-4,
    likelihood rtol 1e-5 / atol 1e-4 (``tests/test_torch_fused.py``'s
    gates)."""
    grids, poses, anc, a0, dist, valid, present = _k1_case()
    spec = tgrid.GridSpec2D(-2.0, -2.0, 4.0, 4.0, 0.05)
    jspec = JSpec(spec.position_x, spec.position_y, spec.width, spec.height,
                  spec.resolution)
    dphi = np.array([np.radians(1.0), np.radians(1.0), np.radians(0.9)],
                    np.float32)
    if static:
        dphi[:] = np.float32(np.radians(1.0))
    jg = jnp.asarray(grids).astype(jnp.bfloat16).reshape(W, P, 80, 128)
    lineage = mode == "lineage"

    def one(g, q, a, d, v, pr, dp, an):
        return jf.fused_update(
            g, q, a, d, v, pr, jspec, 360, 1.0, interpret=True,
            ancestors=an if lineage else None,
            dphi=float(np.radians(1.0)) if static else dp)

    g_j, l_j = jax.vmap(one)(jg, poses.reshape(W, P, 3), a0, dist, valid,
                             present, dphi, anc)
    flat_anc = (anc + P * np.arange(W, dtype=np.int32)[:, None]).reshape(-1)
    tg = torch.from_numpy(grids).to(torch.bfloat16)
    kw = dict(dphi=float(np.radians(1.0)) if static else _t(dphi))
    if lineage:
        kw["ancestors"] = _t(flat_anc)
    else:
        kw["in_place"] = True
    g_t, l_t = tf.fused_update(tg, _t(poses), _t(a0), _t(dist), _t(valid),
                               _t(present), spec, 360, 1.0, **kw)
    assert g_t.shape == (W * P, 80, 128)
    assert _flip(g_t, g_j.reshape(W * P, 80, 128)) < 1e-4
    np.testing.assert_allclose(l_t.numpy(), np.asarray(l_j).reshape(-1),
                               rtol=1e-5, atol=1e-4)


def test_k1_one_world_is_the_single_world_call():
    """A fleet of one world (``[1, B]`` scan, ``[1]`` angles0) gives the
    single-world call's bits; each world of a fleet gives its own
    single-world call's bits; the box is per world."""
    grids, poses, anc, a0, dist, valid, present = _k1_case(1, far=True)
    spec = tgrid.GridSpec2D(-2.0, -2.0, 4.0, 4.0, 0.05)
    dphi = float(np.radians(1.0))
    tg = torch.from_numpy(grids)
    fleet_anc = _t((anc + P * np.arange(W, dtype=np.int32)[:, None])
                   .reshape(-1))
    g_f, l_f = tf.fused_update(tg, _t(poses), _t(a0), _t(dist), _t(valid),
                               _t(present), spec, 360, 1.0, dphi=dphi,
                               ancestors=fleet_anc)
    box_f = tf.cell_pass_box(tf.prepare(80, 128, _t(poses), _t(a0), _t(dist),
                                        _t(valid), _t(present), spec, 360,
                                        1.0, dphi), 128)
    for w in range(W):
        sl = slice(w * P, (w + 1) * P)
        args = (tg[sl], _t(poses[sl]), float(a0[w]), _t(dist[w]),
                _t(valid[w]), _t(present[w]), spec, 360, 1.0)
        g_1, l_1 = tf.fused_update(*args, dphi=dphi, ancestors=_t(anc[w]))
        g_b, l_b = tf.fused_update(
            tg[sl], _t(poses[sl]), _t(a0[w:w + 1]), _t(dist[w:w + 1]),
            _t(valid[w:w + 1]), _t(present[w:w + 1]), spec, 360, 1.0,
            dphi=dphi, ancestors=_t(anc[w]))
        assert torch.equal(g_b, g_1) and torch.equal(l_b, l_1)
        assert torch.equal(g_f[sl], g_1) and torch.equal(l_f[sl], l_1)
        box_1 = tf.cell_pass_box(tf.prepare(80, 128, *args[1:6], spec, 360,
                                            1.0, dphi), 128)
        for a, b in zip(box_f, box_1):
            assert torch.equal(a[sl], b)


@pytest.mark.parametrize("fn", ["dda", "dense", "likelihood"])
def test_grid_functions_take_a_scan_per_particle(fn):
    """A ``[P, B]`` scan gives, row for row, the bits of the ``[B]`` call
    of each particle's world (two worlds of 4 particles)."""
    spec = tgrid.GridSpec2D(-2.0, -2.0, 4.0, 4.0, 0.05)
    g = torch.Generator().manual_seed(2)
    grids = torch.randn(8, 80, 80, generator=g) * 2.0
    grids[torch.rand(grids.shape, generator=g) > 0.3] = 0.0
    poses = torch.rand(8, 3, generator=g) * 2.0 - 1.0
    angles = torch.stack([0.1 + torch.deg2rad(torch.arange(
        360, dtype=torch.float32)), torch.deg2rad(torch.arange(
            360, dtype=torch.float32) * 0.5)])
    dist = 0.05 + 1.15 * torch.rand(2, 360, generator=g)
    valid = torch.rand(2, 360, generator=g) < 0.8
    present = torch.rand(2, 360, generator=g) < 0.9
    if fn == "dda":
        call = lambda *a: tgrid.grid_integrate(*a, spec.max_ray_steps(1.0))
    elif fn == "dense":
        call = lambda *a: tgrid.grid_integrate_dense(
            *a, tgrid.dense_window_for(spec, 1.0))
    else:
        call = tgrid.grid_log_likelihood
    rows = [t.repeat_interleave(4, 0) for t in (angles, dist, valid,
                                                present)]
    both = call(grids, spec, poses, *rows)
    for w in range(2):
        sl = slice(4 * w, 4 * w + 4)
        one = call(grids[sl], spec, poses[sl], angles[w], dist[w], valid[w],
                   present[w])
        assert torch.equal(both[sl], one)



def _fire_ticks(jw, n_steps, timer=0.0):
    dt, period = np.float32(jw.dt), np.float32(jw.params.update_period)
    timer = np.float32(timer)
    fire = []
    for i in range(n_steps):
        timer = np.float32(timer + dt)
        if timer > period:
            fire.append(i)
            timer = np.float32(timer - period)
    return np.array(fire)


def _fleet_draws(jw, n_steps, seed, worlds):
    """The draws of the JAX package's batched ``rollout_cadence``: per
    scan frame, ``k_lm, k_grid = split(key)``; each world's grid draws
    from ``split(k_grid, W)[w]`` through ``derive_noise``; the landmark
    bearing and range noise ``[W, L]`` from ``split(k_lm)``.  Returns
    ``(eps_c, eps_t, u01)`` and ``(noise_a, noise_d)`` with a leading
    frame axis, as numpy."""
    keys = jax.random.split(jax.random.key(seed), n_steps)[
        _fire_ticks(jw, n_steps)]
    lanes = jw.scene.landmarks.shape[0]
    p = jw.grid_config.n_particles
    grid, lm = [], []
    for key in keys:
        k_lm, k_grid = jax.random.split(key)
        draws = [jgs.derive_noise(k, p)
                 for k in jax.random.split(k_grid, worlds)]
        grid.append([np.stack([np.asarray(d[i]) for d in draws])
                     for i in range(3)])
        k1, k2 = jax.random.split(k_lm)
        lm.append([np.asarray(jax.random.normal(k, (worlds, lanes)))
                   for k in (k1, k2)])
    return (tuple(np.stack([f[i] for f in grid]) for i in range(3)),
            tuple(np.stack([f[i] for f in lm]) for i in range(2)))


def test_fleet_rollout_cadence_matches_jax():
    """Grid SLAM, ICP and the EKF over 3 worlds for 40 ticks (6 scan
    frames), the JAX package's in-step draws injected; then the final
    states through ``convert.py``."""
    jw = jcompile.make_fused(
        grid_config=jgs.GridSlamConfig(**BASE),
        icp_config=jmap.IcpMapConfig(capacity=2048, step_threshold=0.05),
        ekf_config=jekf.EkfConfig())
    tw = tcompile.make_fused(
        grid_config=tgs.GridSlamConfig(**BASE),
        icp_config=tmap.IcpMapConfig(capacity=2048, step_threshold=0.05),
        ekf_config=tekf.EkfConfig(), device="cpu")
    js0 = jw.init((W,))
    jst, jo = jw.rollout_cadence(js0, TICKS, seed=0, initial_timer=0.0)
    noise, lm_noise = _fleet_draws(jw, TICKS, 0, W)
    tst, to = tw.rollout_cadence(tw.init((W,)), TICKS, seed=0,
                                 initial_timer=0.0, noise=noise,
                                 landmark_noise=lm_noise)
    frames = len(noise[0])
    assert to.grid_pose.shape == (frames, W, 3) == to.ekf_pose.shape
    np.testing.assert_array_equal(to.fired.numpy(), np.asarray(jo.fired))
    np.testing.assert_allclose(to.pose.numpy(), np.asarray(jo.pose),
                               atol=1e-5)
    np.testing.assert_allclose(to.grid_pose.numpy(), np.asarray(jo.grid_pose),
                               atol=1e-4)
    np.testing.assert_allclose(to.n_eff.numpy(), np.asarray(jo.n_eff),
                               rtol=1e-3)
    np.testing.assert_allclose(to.icp_pose.numpy(), np.asarray(jo.icp_pose),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(to.ekf_pose.numpy(), np.asarray(jo.ekf_pose),
                               atol=2e-3, rtol=0)
    assert _flip(tst.grid.grids, jst.grid.grids) < 1e-3
    np.testing.assert_array_equal(tst.grid.ancestors.numpy(),
                                  np.asarray(jst.grid.ancestors))
    np.testing.assert_array_equal(tst.icp.count.numpy(),
                                  np.asarray(jst.icp.count))
    np.testing.assert_array_equal(tst.ekf.seen.numpy(),
                                  np.asarray(jst.ekf.seen))
    assert np.float32(tst.scan_timer) == np.asarray(jst.scan_timer)

    g, i, e = jst.grid, jst.icp, jst.ekf
    state = convert.world_state_from_numpy(
        np.asarray(jst.pose), np.asarray(jst.accum_left),
        np.asarray(jst.accum_right), np.asarray(jst.scan_timer),
        np.asarray(jst.scan_counter),
        convert.grid_state_from_numpy(*(np.asarray(x) for x in g[:6]),
                                      device="cpu"), "cpu",
        icp=convert.icp_state_from_numpy(*(np.asarray(x) for x in i), "cpu"),
        ekf=convert.ekf_state_from_numpy(*(np.asarray(x) for x in e), "cpu"))
    for part, port in (("pose", state.pose), ("grid.poses", state.grid.poses),
                       ("icp.points", state.icp.points),
                       ("ekf.cov", state.ekf.cov)):
        obj = jst
        for name in part.split("."):
            obj = getattr(obj, name)
        assert torch.equal(port, _t(obj)), part
    assert state.grid.best_idx.shape == (W,)

    # one EKF update of every world from the carried-over state
    lm = jsim.landmark_scan(jax.random.key(5), jst.pose, jw.scene, jw.params)
    odo = JOdo(*(jnp.full((W,), v, jnp.float32) for v in (0.01, 0.012, 0.1)))
    je, _ = jax.vmap(lambda s, o, d: jekf.update(s, o, d, jw.ekf_config))(
        jst.ekf, lm, odo)
    te, _ = tekf.update(state.ekf, LandmarkScan(*(_t(x) for x in lm)),
                        OdometryReading(*(_t(x) for x in odo)), tw.ekf_config)
    np.testing.assert_allclose(te.mean.numpy(), np.asarray(je.mean),
                               atol=1e-5, rtol=0)


def test_cli_rollout_worlds_on_cpu(capsys):
    cli_main(["rollout", GRID_YAML, "--steps", "31", "--worlds", "3",
              "--device", "cpu"])  # one scan every 30 ticks
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    report = json.loads(out[0])
    assert report["worlds"] == 3 and report["scans"] == 1
    assert np.array(report["final_pose"]).shape == (3, 3)
    assert np.isfinite(report["grid_pose_rmse_xy"])


def test_cli_worlds_does_not_fall_back_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA is not available"):
        cli_main(["rollout", GRID_YAML, "--steps", "3", "--worlds", "4"])


def test_icp_and_ekf_worlds_match_their_single_world_updates():
    """An ICP mapper and an EKF over 3 worlds with distinct scans (the
    voxel gate on) against each world updated alone: three updates, the
    ICP pose and map within 1e-6 m, the EKF from the same state within
    1e-5 (one update; ``tests/test_torch_ekf.py``'s carried-over gate)."""
    from slamrs_tpu_torch.models import simulator as tsim

    scene = tsim.Scene.build(rects=[(-1.0, -1.0, 2.0, 2.0),
                                    (-0.1, -0.4, 0.5, 0.1)],
                             landmarks=[(-1.0, -1.0), (1.0, 1.0),
                                        (0.6, -0.4)], device="cpu")
    cfg = tmap.IcpMapConfig(capacity=1024, step_threshold=0.05,
                            voxel_size=0.05)
    fleet = tmap.IcpMapState.init(cfg, "cpu", (W,))
    single = [tmap.IcpMapState.init(cfg, "cpu") for _ in range(W)]
    g = torch.Generator().manual_seed(3)
    for k in range(3):
        pose = torch.rand(W, 3, generator=g) * 0.1 + 0.02 * k
        scan = tsim.lidar_scan(pose, scene, 1.0)
        fleet, out = tmap.update(fleet, scan, cfg)
        for w in range(W):
            single[w], one = tmap.update(
                single[w], type(scan)(*(x[w] for x in scan)), cfg)
            torch.testing.assert_close(out.pose[w], one.pose, atol=1e-6,
                                       rtol=0)
            assert int(fleet.count[w]) == int(single[w].count)
            torch.testing.assert_close(fleet.points[w], single[w].points,
                                       atol=1e-6, rtol=0)
            assert torch.equal(fleet.voxel_bitmap[w], single[w].voxel_bitmap)

    ecfg = tekf.EkfConfig(num_landmarks=4)
    params = tsim.SimParams.make()
    est = tekf.EkfState.init(ecfg, "cpu", (W,))
    pose = torch.rand(W, 3, generator=g) * 0.2
    odo = OdometryReading(torch.full((W,), 0.01), torch.full((W,), 0.012),
                          0.1)
    for k in range(2):
        lm = tsim.landmark_scan(pose, scene, params, generator=g)
        start = est
        est, out = tekf.update(est, lm, odo, ecfg)
        for w in range(W):
            one, o1 = tekf.update(
                tekf.EkfState(*(x[w] for x in start)),
                type(lm)(*(x[w] for x in lm)),
                OdometryReading(odo[0][w], odo[1][w], 0.1), ecfg)
            torch.testing.assert_close(est.mean[w], one.mean, atol=1e-5,
                                       rtol=0)
            assert torch.equal(est.seen[w], one.seen)
            torch.testing.assert_close(out.landmark_covs[w],
                                       o1.landmark_covs, rtol=1e-4,
                                       atol=1e-4 * float(
                                           o1.landmark_covs.abs().max()))
