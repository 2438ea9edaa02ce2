"""Sharded fleets of slamrs_tpu_torch (``parallel/``) against slamrs_tpu.

The port's meshes here are ``torch.device("cpu")`` entries; the JAX
package's are the 8 virtual CPU devices of ``tests/conftest.py``.

* ``_plan`` (the local-first resample's replicated plan) against the JAX
  package's, every output equal: identity, systematic, degenerate (one
  ancestor) and overflow ancestors;
* ``resample_fleet`` on a 2 x 4 mesh at ``tests/test_fleet_resample.py``'s
  ``W, P, H, C = 2, 64, 8, 128``: the JAX package's result slot for slot
  (the plan is deterministic), the overflow fallback (``spill_cap=1``)
  included;
* ``make_mesh``'s errors (the JAX text) and ``fleet_shardings`` against
  the JAX ``PartitionSpec`` s, fused and tiled;
* ``update_fleet(mesh=)`` against the JAX package's, one case per mesh
  route, under the JAX draws (``derive_noise`` per world), at
  ``tests/test_torch_fleet.py``'s gates; the tiled particle-mesh error;
* sharded rollouts against one-device rollouts: ``"gather"``, the
  world-only copy on write and dda (``compile_world(grid_slam.yaml)`` at
  16 worlds on 4 x 2) bitwise, ``"local"`` as a per-world multiset after
  one frame; a sharded checkpoint round trip and resume.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from slamrs_tpu.graph import compile as jcompile  # noqa: E402
from slamrs_tpu.models import gridslam as jgs  # noqa: E402
from slamrs_tpu.ops.resample import systematic_resample as jsys  # noqa: E402
from slamrs_tpu.parallel import fleet as jfleet  # noqa: E402
from slamrs_tpu.parallel import resample as jres  # noqa: E402
from slamrs_tpu_torch.core.types import (Command, OdometryReading,  # noqa: E402
                                         Scan)
from slamrs_tpu_torch.graph import compile as tcompile  # noqa: E402
from slamrs_tpu_torch.graph.config import load_config  # noqa: E402
from slamrs_tpu_torch.models import gridslam as tgs  # noqa: E402
from slamrs_tpu_torch.parallel import fleet as tfleet  # noqa: E402
from slamrs_tpu_torch.parallel import resample as tres  # noqa: E402
from slamrs_tpu_torch.utils import checkpoint  # noqa: E402
from test_torch_fleet import (BASE, TILED, _assert_slots_equal,  # noqa: E402
                              _fleet_inputs, _fleet_noise, _flip,
                              _occupancy_gate, _t)

CPU = torch.device("cpu")
CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def _mesh(n, particle_axis):
    return tfleet.make_mesh(n, particle_axis=particle_axis,
                            devices=[CPU] * 8)


# ---- the plan and the resample -------------------------------------------

def _ancestors(kind, p, seed, worlds=None):
    """Sorted ancestors of ``kind``, ``[P]`` or ``[worlds, P]`` (JAX);
    ``"overflow"`` is ``"systematic"``'s, meant for ``spill_cap=1``."""
    shape = (p,) if worlds is None else (worlds, p)
    if kind == "identity":
        return jnp.broadcast_to(jnp.arange(p, dtype=jnp.int32), shape)
    if kind == "degenerate":
        return jnp.full(shape, 17, jnp.int32)
    n = 1 if worlds is None else worlds
    w = jax.nn.softmax(jax.random.normal(jax.random.key(seed), (n, p))
                       * 2.0, axis=-1)
    anc = jax.vmap(jsys)(jax.random.split(jax.random.key(seed + 1), n), w)
    return anc[0] if worlds is None else anc


PLAN_CASES = {"identity": 8, "systematic": 8, "degenerate": 8,
              "overflow": 1}


@pytest.mark.parametrize("kind", list(PLAN_CASES))
def test_plan_matches_jax(kind):
    """Every output array of ``_plan`` equal to the JAX package's, one
    world and over a worlds axis."""
    p, s, cap = 64, 4, PLAN_CASES[kind]
    anc = _ancestors(kind, p, 9)
    want = jres._plan(anc, s, p // s, cap)
    got = tres._plan(_t(anc), s, p // s, cap)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert bool(got[4]) == (kind == "overflow")
    batch = _ancestors(kind, p, 3, worlds=3)
    got = tres._plan(_t(batch), s, p // s, cap)
    for i in range(3):
        want = jres._plan(batch[i], s, p // s, cap)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g[i].numpy(), np.asarray(w))


RW, RP, RH, RC = 2, 64, 8, 128


@pytest.mark.parametrize("kind", list(PLAN_CASES))
def test_resample_fleet_matches_jax_slot_for_slot(kind):
    """``resample_fleet`` on a 2 x 4 mesh: the JAX package's grids and
    poses slot for slot (``spill_cap=1`` forces the overflow fallback)."""
    ids = jnp.arange(RP, dtype=jnp.float32)
    grids = jnp.zeros((RW, RP, RH, RC), jnp.float32).at[:, :, 0, 0].set(
        ids[None] + 1000.0 * jnp.arange(RW, dtype=jnp.float32)[:, None])
    grids = grids + jax.random.normal(jax.random.key(0),
                                      (RW, RP, RH, RC)) * 1e-3
    poses = jnp.broadcast_to(grids[:, :, 0, 0][..., None], (RW, RP, 3))
    anc = _ancestors(kind, RP, 6, worlds=RW)
    cap = 1 if kind == "overflow" else None
    jmesh = jfleet.make_mesh(8, particle_axis=4)
    jg, jq = jax.jit(lambda g, q, a: jres.resample_fleet(
        g, q, a, jmesh, spill_cap=cap))(grids, poses, anc)
    mesh = _mesh(8, 4)
    wp = tfleet.WORLD_PARTICLE
    tg, tq = tres.resample_fleet(
        tfleet.Sharded.place(_t(grids), mesh, wp),
        tfleet.Sharded.place(_t(poses), mesh, wp), _t(anc), mesh,
        spill_cap=cap)
    assert tg.blocks[1][3].shape == (1, RP // 4, RH, RC)
    np.testing.assert_array_equal(tg.full().numpy(), np.asarray(jg))
    np.testing.assert_array_equal(tq.full().numpy(), np.asarray(jq))
    overflow = bool(tres._plan(_t(anc), 4, RP // 4, cap or 8)[4].any())
    assert overflow == (kind == "overflow")


def test_fused_update_batched_per_block_is_the_fleet_launch():
    """K1 once per block of a 2 x 2 mesh (``per_world = P_loc``, each
    world's scan copied to its blocks) gives the maps and likelihoods of
    the one-launch fleet call, bit for bit."""
    from slamrs_tpu_torch.ops.grid import GridSpec2D
    from slamrs_tpu_torch.parallel.shard import fused_update_batched

    scan, _, _ = _fleet_inputs(41, 2)
    scan = Scan(*(_t(x) for x in scan))
    g = torch.Generator().manual_seed(3)
    grids = (torch.randn(2, 8, 80, 128, generator=g) * 2).to(torch.bfloat16)
    poses = torch.randn(2, 8, 3, generator=g) * 0.3
    spec = GridSpec2D(-2.0, -2.0, 4.0, 4.0, 0.05)
    dphi = scan.angles[:, 1] - scan.angles[:, 0]
    args = (scan.angles[:, 0], scan.distances, scan.valid, scan.present,
            spec, scan.angles.shape[-1], 1.0, dphi)
    want_g, want_l = fused_update_batched(grids.clone(), poses, *args)
    mesh = _mesh(4, 2)
    wp = tfleet.WORLD_PARTICLE
    got_g, got_l = fused_update_batched(
        tfleet.Sharded.place(grids, mesh, wp),
        tfleet.Sharded.place(poses, mesh, wp), *args, mesh=mesh)
    assert torch.equal(got_g.full(), want_g)
    assert torch.equal(got_l.full(), want_l)


def test_make_mesh_and_its_errors(monkeypatch):
    """The JAX text for an uneven particle axis; no CUDA: no mesh (never
    the CPU in its place); the axes and the shape dict."""
    with pytest.raises(ValueError) as jerr:
        jfleet.make_mesh(6, particle_axis=4)
    with pytest.raises(ValueError) as terr:
        _mesh(6, 4)
    assert str(terr.value) == str(jerr.value)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfleet.make_mesh()
    mesh = _mesh(8, 2)
    jmesh = jfleet.make_mesh(8, particle_axis=2)
    assert mesh.shape == dict(zip(jmesh.axis_names, jmesh.devices.shape))
    assert mesh.axis_names == jmesh.axis_names
    assert mesh == _mesh(8, 2) and mesh != _mesh(8, 4)


@pytest.mark.parametrize("layout", ["fused", "tiled"])
def test_fleet_shardings_match_jax(layout):
    """Leaf for leaf the JAX package's ``PartitionSpec`` s, on a world
    with grid SLAM, ICP and EKF."""
    kw = dict(BASE, n_particles=8, resolution=0.1)
    if layout == "tiled":
        kw.update(TILED, n_particles=8)
    jworld = jcompile.make_fused(grid_config=jgs.GridSlamConfig(**kw))
    jworld = dataclasses.replace(
        jworld, icp_config=_icp_ekf()[0], ekf_config=_icp_ekf()[1])
    jstate = jworld.init((4,))
    jmesh = jfleet.make_mesh(8, particle_axis=2)
    jspecs = [s.spec for s in jax.tree.leaves(
        jfleet.fleet_shardings(jstate, jmesh, 4))]
    tworld = tcompile.make_fused(grid_config=tgs.GridSlamConfig(**kw),
                                 icp_config=_icp_ekf(True)[0],
                                 ekf_config=_icp_ekf(True)[1], device=CPU)
    tstate = tworld.init((4,))
    specs = tfleet.tree_leaves(tfleet.fleet_shardings(tstate, _mesh(8, 2),
                                                      4))
    assert specs == jspecs and len(specs) == len(
        tfleet.tree_leaves(tstate))
    assert (tstate.grid.tile_table is not None) == (layout == "tiled")


def _icp_ekf(port=False):
    from slamrs_tpu.models.ekf import EkfConfig as JEkf
    from slamrs_tpu.models.icp_mapper import IcpMapConfig as JIcp
    from slamrs_tpu_torch.models.ekf import EkfConfig
    from slamrs_tpu_torch.models.icp_mapper import IcpMapConfig

    return (IcpMapConfig(), EkfConfig()) if port else (JIcp(), JEkf())


# ---- update_fleet(mesh=) against the JAX package --------------------------

# route -> (config, worlds, mesh entries, particle axis, updates).  The
# world-only routes run the one-device fleet update per world shard
# (held against the JAX package over two updates in
# tests/test_torch_fleet.py), so one update each keeps the JAX package's
# interpret-mode kernels short; the particle-block routes take two.
MESH_ROUTES = {
    "world_only_cow": (dict(BASE), 2, 2, 1, 1),
    "gather": (dict(BASE, fleet_resample="gather"), 2, 8, 4, 2),
    "local": (dict(BASE), 2, 8, 4, 2),
    "tiled_world_only": (dict(TILED), 2, 2, 1, 1),
    "dda": (dict(BASE, integrate="dda", resample_neff_frac=0.7), 2, 8, 4, 2),
}


@pytest.mark.parametrize("route", list(MESH_ROUTES))
def test_update_fleet_mesh_matches_jax(route):
    """Updates through each mesh route of both packages under the same
    draws: poses and ancestors slot for slot, weights, outputs and maps
    at ``tests/test_torch_fleet.py``'s gates."""
    kw, worlds, n, pa, updates = MESH_ROUTES[route]
    jcfg, tcfg = jgs.GridSlamConfig(**kw), tgs.GridSlamConfig(**kw)
    jmesh = jfleet.make_mesh(n, particle_axis=pa)
    mesh = _mesh(n, pa)
    jupdate = jax.jit(lambda st, sc, od, k: jgs.update_fleet(
        st, sc, od, k, jcfg, mesh=jmesh))
    jst = jgs.GridSlamState.init(jcfg, (worlds,))
    tst = tgs.GridSlamState.init(tcfg, CPU, (worlds,))
    for step in range(updates):
        scan, odo, keys = _fleet_inputs(29, worlds, step)
        jst, jout = jupdate(jst, scan, odo, keys)
        tst, tout = tgs.update_fleet(
            tst, Scan(*(_t(x) for x in scan)),
            OdometryReading(*(_t(x) for x in odo)), tcfg,
            noise=_fleet_noise(keys), mesh=mesh)
        assert tfleet.mesh_of(tst) == mesh
        whole = tfleet.unshard_world_state(tst)
        _assert_slots_equal(jst, jout, whole, tout)
        if route == "tiled_world_only":
            np.testing.assert_array_equal(whole.tile_table.numpy(),
                                          np.asarray(jst.tile_table))
            assert _flip(whole.grids, jst.grids) < 1e-4
        elif tcfg.integrate == "fused":
            assert _flip(whole.grids, jst.grids) < 1e-3
        else:
            _occupancy_gate(whole.grids, jst.grids)


def test_tiled_fleet_on_a_particle_mesh_raises_the_jax_error():
    jcfg, tcfg = jgs.GridSlamConfig(**TILED), tgs.GridSlamConfig(**TILED)
    scan, odo, keys = _fleet_inputs(3, 2)
    with pytest.raises(ValueError) as jerr:
        jgs.update_fleet(jgs.GridSlamState.init(jcfg, (2,)), scan, odo,
                         keys, jcfg, mesh=jfleet.make_mesh(4, 2))
    with pytest.raises(ValueError) as terr:
        tgs.update_fleet(tgs.GridSlamState.init(tcfg, CPU, (2,)),
                         Scan(*(_t(x) for x in scan)),
                         OdometryReading(*(_t(x) for x in odo)), tcfg,
                         noise=_fleet_noise(keys), mesh=_mesh(4, 2))
    assert str(terr.value) == str(jerr.value)


# ---- sharded rollouts against one-device rollouts ------------------------

def _fleet_world(mesh=None, **kw):
    cfg = tgs.GridSlamConfig(**dict(dict(BASE, resolution=0.1,
                                         n_particles=8), **kw))
    return tcompile.make_fused(grid_config=cfg, num_beams=64, device=CPU,
                               mesh=mesh)


def _assert_states_equal(a, b):
    for x, y in zip(tfleet.tree_leaves(a), tfleet.tree_leaves(b)):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y)
        else:
            assert x == y


@pytest.mark.parametrize("route", ["gather", "world_only_cow"])
def test_sharded_rollout_equals_unsharded(route):
    """``make_fused(mesh=)`` for 40 ticks (six scan frames, resampling
    every frame) bitwise the one-device fleet under the same seed, and a
    one-device world runs the sharded state on its mesh."""
    kw = {"fleet_resample": "gather"} if route == "gather" else {}
    mesh = _mesh(8, 4 if route == "gather" else 1)
    worlds = 4 if route == "gather" else 8
    plain = _fleet_world(**kw)
    s0, o0 = plain.rollout_cadence(plain.init((worlds,)), 40, seed=5)
    s1, o1 = _fleet_world(mesh, **kw).rollout_cadence(
        plain.init((worlds,)), 40, seed=5)
    s2, o2 = plain.rollout_cadence(
        tfleet.shard_world_state(plain.init((worlds,)), mesh, worlds), 40,
        seed=5)
    assert int(o0.fired.sum()) == 6 and bool((o0.n_eff > 0).all())
    for s, o in ((s1, o1), (s2, o2)):
        assert tfleet.mesh_of(s) == mesh
        _assert_states_equal(tfleet.unshard_world_state(s), s0)
        _assert_states_equal(o, o0)
    with pytest.raises(ValueError, match="another mesh"):
        _fleet_world(_mesh(8, 2), **kw).step(
            s1, Command(torch.tensor(0.05), torch.tensor(0.08)))


def test_local_rollout_is_the_gather_multiset_after_one_frame():
    """One scan frame on a 4 x 2 mesh: ``"local"`` and ``"gather"`` hold
    the same per-world particle multiset (pose and map)."""
    mesh = _mesh(8, 2)
    out = {}
    for mode in ("local", "gather"):
        fw = _fleet_world(mesh, fleet_resample=mode)
        final, outs = fw.rollout(fw.init((4,)), 8, seed=5)
        assert bool(outs.fired.any())
        grid = tfleet.unshard_world_state(final).grid
        out[mode] = (grid.poses.numpy(), grid.grids.float().numpy())
    for w in range(4):
        keys = {m: np.argsort([p.tobytes() + g.tobytes() for p, g in zip(
            out[m][0][w], out[m][1][w])]) for m in out}
        for i in range(2):
            np.testing.assert_array_equal(out["local"][i][w][keys["local"]],
                                          out["gather"][i][w][keys["gather"]])


def test_grid_slam_yaml_sharded_equals_unsharded():
    """``compile_world(grid_slam.yaml)`` (dda, 10 particles at 0.02 m) at
    16 worlds on a 4 x 2 mesh, 35 ticks (one scan): bitwise the
    one-device fleet, and the world axis really cut."""
    fw = tcompile.compile_world(load_config(CONFIGS / "grid_slam.yaml"),
                                device=CPU)
    mesh = _mesh(8, 2)
    s0, o0 = fw.rollout(fw.init((16,)), 35, seed=3)
    s1, o1 = fw.rollout(tfleet.shard_world_state(fw.init((16,)), mesh, 16),
                        35, seed=3)
    assert int(o0.fired.sum()) == 1
    assert len(s1.grid.grids.blocks) == 4 and len(s1.grid.grids.blocks[0]) \
        == 2 and s1.grid.grids.blocks[0][0].shape[:2] == (4, 5)
    _assert_states_equal(tfleet.unshard_world_state(s1), s0)
    _assert_states_equal(o1, o0)


def test_sharded_checkpoint_round_trip_and_resume(tmp_path):
    """A sharded state saves the one-device layout's bytes, loads onto
    its template's mesh, and 60 resumed ticks equal 60 continued ones."""
    mesh = _mesh(8, 2)
    fw = _fleet_world(mesh, resample_neff_frac=0.5)
    state, _ = fw.rollout_cadence(fw.init((4,)), 30, seed=1)
    sharded, whole = tmp_path / "s.npz", tmp_path / "w.npz"
    checkpoint.save(str(sharded), state)
    checkpoint.save(str(whole), tfleet.unshard_world_state(state))
    with np.load(sharded) as a, np.load(whole) as b:
        assert a.files == b.files
        for k in a.files:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    loaded = checkpoint.load(str(sharded),
                             tfleet.shard_world_state(fw.init((4,)), mesh, 4))
    assert tfleet.mesh_of(loaded) == mesh
    _assert_states_equal(tfleet.unshard_world_state(loaded),
                         tfleet.unshard_world_state(state))
    a, oa = fw.rollout_cadence(loaded, 60, seed=2)
    b, ob = fw.rollout_cadence(state, 60, seed=2)
    _assert_states_equal(tfleet.unshard_world_state(a),
                         tfleet.unshard_world_state(b))
    _assert_states_equal(oa, ob)
