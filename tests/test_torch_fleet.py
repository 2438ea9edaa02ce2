"""Batched worlds (fleets) of slamrs_tpu_torch against slamrs_tpu.

The port's ``update_fleet`` against the JAX package's
``update_fleet(mesh=None)`` at ``tests/test_fleet_cow.py``'s sizes and
inputs: 3 worlds x 16 particles on 4 x 4 m maps at 0.05 m (bf16), each
world with its own 64-beam scan; tiled pools at 2 worlds on 6.4 x 12.8 m.
The JAX package draws a fleet's randomness inside the step from one key
per world (``update`` splits it); the tests rebuild those draws with
``derive_noise(keys[w], P)`` and hand them to the port.  Gates as in
``tests/test_torch_gridslam.py``: poses slot for slot within 1e-6 m
(the port's copy-on-write plan is the JAX plan, so slot order matches
too), ancestors identical, weights rtol 1e-4, maps' flip fraction
(|diff| > 0.01) below 1e-3 (atan2 bin flips of the TPU kernel's
polynomial), tiled maps below 1e-4, dda and dense maps at
``tests/test_parity.py``'s occupancy gate.  Also: the flattened
copy-on-write plan keeps every copy inside its world, a fleet state
carried over from the JAX package by ``convert.py``, and the routing
errors.  K1's world axis, the grid functions on per-particle scans and
the fleet world (``rollout_cadence``, the CLI) are in
``tests/test_torch_fleet_world.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from slamrs_tpu.core.types import OdometryReading as JOdo  # noqa: E402
from slamrs_tpu.core.types import Scan as JScan  # noqa: E402
from slamrs_tpu.models import gridslam as jgs  # noqa: E402
from slamrs_tpu.ops import tiles as jtiles  # noqa: E402
from slamrs_tpu.ops.grid import GridSpec2D as JSpec  # noqa: E402
from slamrs_tpu_torch.core.types import OdometryReading, Scan  # noqa: E402
from slamrs_tpu_torch.models import gridslam as tgs  # noqa: E402
from slamrs_tpu_torch.ops import cow as tcow  # noqa: E402
from slamrs_tpu_torch.ops import tiles as ttiles  # noqa: E402

B = 64
P = 16
W = 3
BASE = dict(position_x=-2.0, position_y=-2.0, width=4.0, height=4.0,
            resolution=0.05, n_particles=P, max_scan_range=1.0,
            integrate="fused", grid_dtype="bfloat16", resample_neff_frac=1.0)
TILED = dict(BASE, position_x=-3.2, position_y=-6.4, width=6.4, height=12.8,
             resample_cow="tiled")


def _fleet_inputs(seed, worlds, step=0):
    """``tests/test_fleet_cow.py``'s distinct per-world scans, odometry and
    keys (JAX arrays)."""
    rng = np.random.default_rng(seed + 131 * step)
    angles = jnp.broadcast_to(
        jnp.arange(B, dtype=jnp.float32) * (2 * np.pi / B), (worlds, B))
    dist = jnp.asarray(rng.uniform(0.15, 0.95, size=(worlds, B)),
                       jnp.float32)
    valid = jnp.asarray(rng.random((worlds, B)) > 0.1)
    present = jnp.asarray(rng.random((worlds, B)) > 0.05)
    scan = JScan(angles, dist, jnp.ones((worlds, B), jnp.float32), valid,
                 present)
    odo = JOdo(jnp.full((worlds,), 0.02, jnp.float32),
               jnp.full((worlds,), 0.03, jnp.float32),
               jnp.full((worlds,), 0.2, jnp.float32))
    keys = jax.random.split(jax.random.key(700 + step), worlds)
    return scan, odo, keys


def _t(a):
    return torch.from_numpy(np.array(a))


def _fleet_noise(keys):
    """The draws the JAX package's fleet update makes in the step: each
    world's key through ``derive_noise``, stacked ``[W, ...]``."""
    draws = [jgs.derive_noise(k, P) for k in keys]
    return tgs.UpdateNoise(*(_t(np.stack([np.asarray(d[i]) for d in draws]))
                             for i in range(3)))


def _step_both(jst, tst, jcfg, tcfg, seed, step, worlds=W):
    scan, odo, keys = _fleet_inputs(seed, worlds, step)
    jst, jout = jgs.update_fleet(jst, scan, odo, keys, jcfg, mesh=None)
    tst, tout = tgs.update_fleet(
        tst, Scan(*(_t(x) for x in scan)),
        OdometryReading(*(_t(x) for x in odo)), tcfg,
        noise=_fleet_noise(keys))
    return jst, jout, tst, tout


def _assert_slots_equal(jst, jout, tst, tout):
    np.testing.assert_allclose(tst.poses.numpy(), np.asarray(jst.poses),
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tst.ancestors.numpy(),
                                  np.asarray(jst.ancestors))
    np.testing.assert_allclose(tst.weights.numpy(), np.asarray(jst.weights),
                               rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(tout.pose.numpy(), np.asarray(jout.pose),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(tout.n_eff.numpy(), np.asarray(jout.n_eff),
                               rtol=1e-3)
    np.testing.assert_array_equal(tout.resampled.numpy(),
                                  np.asarray(jout.resampled))
    np.testing.assert_array_equal(tst.best_idx.numpy(),
                                  np.asarray(jst.best_idx))


def _flip(t, j):
    return float((np.abs(t.float().numpy()
                         - np.asarray(jnp.asarray(j, jnp.float32))) > 0.01)
                 .mean())


def _occupancy_gate(tg, jg):
    """``tests/test_parity.py``'s map gate."""
    tg, jg = tg.numpy(), np.asarray(jg)
    assert tg.shape == jg.shape
    assert float((np.abs(tg - jg) <= 5e-3).mean()) >= 0.999
    touched = np.abs(jg) > 1e-6
    assert float((np.sign(tg[touched]) == np.sign(jg[touched])).mean()) \
        >= 0.999


ROUTES = {
    "cow_local": dict(BASE),
    "gather": dict(BASE, fleet_resample="gather"),
    "resample_cow_false": dict(BASE, resample_cow=False),
    "fused_resident": dict(BASE, fused_resident=True),
    "dda": dict(BASE, integrate="dda", resample_neff_frac=0.7),
    "dense": dict(BASE, integrate="dense", resample_neff_frac=0.7),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_update_fleet_matches_jax(route):
    """Two updates of every world through each route of
    ``update_fleet``; the fused routes keep one kernel call for the
    fleet."""
    jcfg = jgs.GridSlamConfig(**ROUTES[route])
    tcfg = tgs.GridSlamConfig(**ROUTES[route])
    jst = jgs.GridSlamState.init(jcfg, (W,))
    tst = tgs.GridSlamState.init(tcfg, "cpu", (W,))
    for name in ("poses", "grids", "weights", "best_pose", "best_idx",
                 "ancestors"):
        assert tuple(getattr(tst, name).shape) == getattr(jst, name).shape
    for step in range(2):
        jst, jout, tst, tout = _step_both(jst, tst, jcfg, tcfg, 11, step)
        _assert_slots_equal(jst, jout, tst, tout)
        if tcfg.integrate == "fused":
            assert _flip(tst.grids, jst.grids) < 1e-3
        else:
            _occupancy_gate(tst.grids, jst.grids)
    if route == "fused_resident":  # the lineage stays pending
        assert not np.array_equal(tst.ancestors.numpy(),
                                  np.broadcast_to(np.arange(P), (W, P)))
    tp = tgs.estimated_probability_grid(tst, tcfg).numpy()
    jp = np.asarray(jgs.estimated_probability_grid(jst, jcfg))
    assert tp.shape == jp.shape == (W, *tcfg.grid_spec.shape)
    assert float((np.abs(tp - jp) > 2e-3).mean()) < 1e-3


def test_tiled_fleet_matches_jax():
    """Tiled pools, one per world, updated once per world: tables and
    poses slot for slot, materialized maps (through the pending lineage)
    within the tiled flip gate, two updates."""
    jcfg = jgs.GridSlamConfig(**TILED)
    tcfg = tgs.GridSlamConfig(**TILED)
    worlds = 2
    jst = jgs.GridSlamState.init(jcfg, (worlds,))
    tst = tgs.GridSlamState.init(tcfg, "cpu", (worlds,))
    assert tuple(tst.grids.shape) == jst.grids.shape
    assert tuple(tst.tile_table.shape) == jst.tile_table.shape
    spec = tcfg.grid_spec
    jspec = JSpec(spec.position_x, spec.position_y, spec.width, spec.height,
                  spec.resolution)
    for step in range(2):
        jst, jout, tst, tout = _step_both(jst, tst, jcfg, tcfg, 37, step,
                                          worlds)
        _assert_slots_equal(jst, jout, tst, tout)
        np.testing.assert_array_equal(tst.tile_table.numpy(),
                                      np.asarray(jst.tile_table))
        for i in range(worlds):
            tm = ttiles.materialize(
                tst.grids[i], tst.tile_table[i][tst.ancestors[i].long()],
                spec)
            jm = jtiles.materialize(
                jst.grids[i], jnp.take(jst.tile_table[i], jst.ancestors[i],
                                       axis=0), jspec)
            assert _flip(tm, jm) < 1e-4
    tp = tgs.estimated_probability_grid(tst, tcfg).numpy()
    jp = np.asarray(jgs.estimated_probability_grid(jst, jcfg))
    assert tp.shape == jp.shape == (worlds, *spec.shape)
    assert float((np.abs(tp - jp) > 2e-3).mean()) < 1e-4


def test_cow_plan_keeps_copies_in_their_world():
    """The flattened copy-on-write plan of block-diagonal ancestors: every
    copy's source and destination lie in one world block, and applying it
    gives each world the multiset of its own gather."""
    rng = np.random.default_rng(5)
    p, worlds = 16, 8
    w = rng.uniform(size=(worlds, p)) ** 6
    u01 = rng.uniform(size=(worlds, 1)).astype(np.float32)
    from slamrs_tpu_torch.ops import resample as tres

    anc = tres.systematic_resample(_t(w / w.sum(1, keepdims=True))
                                   .float(), _t(u01))
    anc[3] = torch.arange(p, dtype=torch.int32)  # one world keeps its set
    flat = (anc + p * torch.arange(worlds, dtype=torch.int32)[:, None]
            ).reshape(-1)
    src, dst, n = tcow.cow_plan(flat)
    live = slice(0, int(n))
    assert torch.equal(src[live] // p, dst[live] // p)
    grids = torch.arange(worlds * p, dtype=torch.float32).reshape(-1, 1)
    grids = grids.expand(-1, 4).contiguous()
    poses = grids[:, :3].clone()
    new_poses, new_grids = tcow.cow_resample(grids.clone(), poses, flat)
    gathered = grids[flat.long()]
    for k in range(worlds):
        sl = slice(k * p, (k + 1) * p)
        assert sorted(new_grids[sl, 0].tolist()) == \
            sorted(gathered[sl, 0].tolist())
        assert torch.equal(new_poses[sl], new_grids[sl, :3])


def test_fleet_routes_and_errors():
    """The fused routes launch nothing but the plain versions here; the
    config decides the mechanism per world as the JAX package does; a
    single-world state is refused."""
    cfg = tgs.GridSlamConfig(**BASE)
    st = tgs.GridSlamState.init(cfg, "cpu")
    scan, odo, keys = _fleet_inputs(3, 1)
    with pytest.raises(ValueError, match="fleet state"):
        tgs.update_fleet(st, Scan(*(_t(x) for x in scan)),
                         OdometryReading(*(_t(x) for x in odo)), cfg,
                         generator=torch.Generator().manual_seed(0))
    fleet = tgs.GridSlamState.init(cfg, "cpu", (2,))
    with pytest.raises(ValueError, match="noise or a generator"):
        tgs.update_fleet(fleet, None, None, cfg)
    staged = dataclasses.replace(cfg, resample_cow="staged")
    # the JAX package's fleet pins copy on write over "staged" too
    scan, odo, keys = _fleet_inputs(3, 2)
    gen = torch.Generator().manual_seed(0)
    st2, out = tgs.update_fleet(fleet, Scan(*(_t(x) for x in scan)),
                                OdometryReading(*(_t(x) for x in odo)),
                                staged, generator=gen)
    assert torch.equal(st2.ancestors,
                       torch.arange(P, dtype=torch.int32).expand(2, P))
    assert bool(torch.isfinite(out.pose).all())


def test_fleet_state_carried_over_from_jax():
    """A JAX fleet after one update (the slot-exact gather route) crosses
    through ``convert.grid_state_from_numpy``; both packages then update
    it once more."""
    from slamrs_tpu_torch import convert

    cfg = dict(BASE, fleet_resample="gather")
    jcfg, tcfg = jgs.GridSlamConfig(**cfg), tgs.GridSlamConfig(**cfg)
    scan, odo, keys = _fleet_inputs(19, W)
    jst, _ = jgs.update_fleet(jgs.GridSlamState.init(jcfg, (W,)), scan, odo,
                              keys, jcfg, mesh=None)
    tst = convert.grid_state_from_numpy(*(np.asarray(x) for x in jst[:6]),
                                        device="cpu")
    assert tst.grids.dtype == torch.bfloat16 and tst.best_idx.shape == (W,)
    assert torch.equal(tst.grids.float(),
                       _t(np.asarray(jst.grids, np.float32)))
    jst, jout, tst, tout = _step_both(jst, tst, jcfg, tcfg, 19, 1)
    _assert_slots_equal(jst, jout, tst, tout)
    assert _flip(tst.grids, jst.grids) < 1e-3
