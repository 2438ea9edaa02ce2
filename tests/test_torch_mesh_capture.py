"""Sharded (mesh) frames and the tick-by-tick rollout as programs
(``slamrs_tpu_torch/graph/capture.py``), on the CPU.

The programs run uncaptured here (``capture.run_program`` and
``capture.run_ticks`` with ``graphs=False``): the code a CUDA graph
captures, on the same static buffers, with the same copy-back, the same
static draw buffers, the same outputs written at a device-held index and,
on a particle-sharded ``"local"`` mesh, the same cut at the overflow read
(one host read of every world row's flag a frame, then each row's branch
writing its blocks in place).  Meshes are ``[cpu] x n``.

* every mesh route bitwise the eager mesh rollout
  (``rollout_cadence(capture=False)``) over a few frames, under the seed
  and under injected draws: world-only copy on write 8 x 1, ``"gather"``
  2 x 4, ``"local"`` 2 x 4 without and with overflow fallbacks (a spill
  cap of 1 forces them), tiled 2 x 1, dda 4 x 2, ICP 4 x 1, EKF 4 x 1;
  the overflow reads: one a frame on ``"local"``, none elsewhere;
* the ``"gather"`` mesh against the JAX package's sharded rollout on its
  8 virtual CPU devices under the JAX draws, at
  ``test_update_fleet_mesh_matches_jax``'s gates;
* the cadence rollout's trailing idle ticks as one ``("idle", n)`` run;
* the tick programs bitwise ``FusedWorld.rollout``'s eager loop (fused,
  dda, ICP, EKF, and a ``"local"`` mesh), and the fused one against the
  JAX package's ``fw.rollout`` under its draws; kept across tick calls,
  and shared by cadence and tick calls on one carried state;
* ``capture=True`` raises on the CPU (``ValueError``) and on a mesh over
  several distinct devices (``NotImplementedError``).

The ``cuda`` cases (captured against eager on the card) are in
``tests/test_torch_cuda.py``.
"""

from __future__ import annotations

import dataclasses
import functools
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from slamrs_tpu_torch.graph import capture  # noqa: E402
from slamrs_tpu_torch.graph import compile as tcompile  # noqa: E402
from slamrs_tpu_torch.graph.config import load_config  # noqa: E402
from slamrs_tpu_torch.models import ekf as tekf  # noqa: E402
from slamrs_tpu_torch.models import gridslam as tgs  # noqa: E402
from slamrs_tpu_torch.models import icp_mapper as tmap  # noqa: E402
from slamrs_tpu_torch.parallel import fleet as tfleet  # noqa: E402
from slamrs_tpu_torch.parallel import resample as tres  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
SCRIPT = [[4.0, 0.05, 0.08], [8.0, 0.08, 0.05], [999.0, 0.06, 0.06]]
TICKS = 27  # four scan frames and two trailing idle ticks
SMALL = dict(position_x=-2.0, position_y=-2.0, width=4.0, height=4.0,
             resolution=0.1, n_particles=8, max_scan_range=1.0,
             integrate="fused", grid_dtype="bfloat16", resample_neff_frac=1.0)

# route: (world kind, grid overrides, mesh entries, particle axis, worlds,
# spill cap of the local relabel or None)
MESH_ROUTES = {
    "world_only_cow_8x1": ("grid", {}, 8, 1, 8, None),
    "gather_2x4": ("grid", dict(fleet_resample="gather"), 8, 4, 2, None),
    "local_2x4": ("grid", dict(n_particles=16), 8, 4, 2, None),
    "local_2x4_overflow": ("grid", dict(n_particles=16), 8, 4, 2, 1),
    "tiled_2x1": ("grid", dict(position_x=-3.2, position_y=-6.4, width=6.4,
                               height=12.8, resample_cow="tiled"), 2, 1, 2,
                  None),
    "dda_4x2": ("grid", dict(integrate="dda", grid_dtype="float32",
                             resample_neff_frac=0.7), 8, 2, 4, None),
    "icp_4x1": ("icp", None, 4, 1, 4, None),
    "ekf_4x1": ("ekf", None, 4, 1, 4, None),
}


def _world(kind, grid=None, mesh=None, device=CPU):
    if kind == "icp":
        return tcompile.make_fused(
            icp_config=tmap.IcpMapConfig(capacity=2048, step_threshold=0.05),
            control_script=SCRIPT, mesh=mesh, device=device)
    if kind == "ekf":
        return tcompile.make_fused(ekf_config=tekf.EkfConfig(),
                                   control_script=SCRIPT, mesh=mesh,
                                   device=device)
    if kind == "dda_yaml":
        fw = tcompile.compile_world(
            load_config(str(ROOT / "configs" / "grid_slam.yaml")),
            device=device)
        fw.grid_config = dataclasses.replace(fw.grid_config, n_particles=4)
        return fw
    return tcompile.make_fused(
        grid_config=tgs.GridSlamConfig(**dict(SMALL, **(grid or {}))),
        num_beams=64, control_script=SCRIPT, mesh=mesh, device=device)


def _mesh(n, particle_axis, device=CPU):
    return tfleet.make_mesh(n, particle_axis=particle_axis,
                            devices=[torch.device(device)] * n)


def _draws(fw, worlds, n_steps, seed, frames=None):
    """numpy draws of every scan frame (or of ``frames``), as ``noise=``
    and ``landmark_noise=`` take them."""
    if frames is None:
        frames = fw.fire_schedule(n_steps, 0.0)[0].size
    rng = np.random.default_rng(seed)
    out = {}
    if fw.grid_config is not None:
        p = fw.grid_config.n_particles
        out["noise"] = (rng.standard_normal((frames, *worlds, p), np.float32),
                        rng.standard_normal((frames, *worlds, p), np.float32),
                        rng.random((frames, *worlds, 1), np.float32))
    if fw.ekf_config is not None:
        lanes = fw.scene.landmarks.shape[0]
        out["landmark_noise"] = tuple(
            rng.standard_normal((frames, *worlds, lanes), np.float32)
            for _ in range(2))
    return out


def _assert_same_run(a, b):
    (sa, oa), (sb, ob) = a, b
    if tfleet.mesh_of(sa) is not None:
        assert tfleet.mesh_of(sb) == tfleet.mesh_of(sa)
        sa, sb = (tfleet.unshard_world_state(s) for s in (sa, sb))
    la, lb = capture._tensor_leaves(sa), capture._tensor_leaves(sb)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)
    assert sa.scan_timer == sb.scan_timer
    assert sa.scan_counter == sb.scan_counter
    for x, y in zip(oa, ob):
        assert (x is None) == (y is None)
        if x is not None:
            assert x.dtype == y.dtype and torch.equal(x, y)


class _Reads:
    """Counts the overflow reads and the fallbacks they chose."""

    def __init__(self, monkeypatch):
        self.reads, self.flags = 0, []
        orig = tres._read_overflow

        def read(flags):
            self.reads += 1
            out = orig(flags)
            self.flags.extend(out)
            return out

        monkeypatch.setattr(tres, "_read_overflow", read)


class _Runs:
    """The keys of the programs' runs (``Program.run``), in order."""

    def __init__(self, monkeypatch):
        self.keys = []
        orig = capture.Program.run

        def run(prog, key, sample=None):
            self.keys.append(key)
            return orig(prog, key, sample)

        monkeypatch.setattr(capture.Program, "run", run)


def _spill_cap(monkeypatch, cap):
    if cap is not None:
        monkeypatch.setattr(tgs, "resample_fleet", functools.partial(
            tres.resample_fleet, spill_cap=cap))


@pytest.mark.parametrize("draws", ["seed", "injected"])
@pytest.mark.parametrize("route", list(MESH_ROUTES))
def test_mesh_program_equals_the_eager_mesh_rollout(route, draws,
                                                    monkeypatch):
    kind, grid, n, axis, w, cap = MESH_ROUTES[route]
    _spill_cap(monkeypatch, cap)
    mesh = _mesh(n, axis)
    fw = _world(kind, grid, mesh)
    kw = _draws(fw, (w,), TICKS, 5) if draws == "injected" else {}
    eager = fw.rollout_cadence(fw.init((w,)), TICKS, seed=3, capture=False,
                               **kw)
    reads = _Reads(monkeypatch)
    program = capture.run_program(fw, fw.init((w,)), TICKS, seed=3,
                                  graphs=False, **kw)
    _assert_same_run(eager, program)
    frames = int(eager[1].fired.shape[0])
    stats = fw.capture_stats
    assert frames == 4 and stats.frames == frames
    assert stats.eager == frames + 1  # and the trailing idle ticks' run
    assert stats.ticks is None
    local = "local" in route
    # one overflow read a frame on "local" (frame 0 before the program)
    assert reads.reads == (frames if local else 0)
    assert stats.overflow_reads == (frames - 1 if local else 0)
    if route == "local_2x4_overflow":
        assert any(reads.flags), "no overflow fallback was taken"
    elif local:
        assert not any(reads.flags)


@pytest.mark.parametrize("route", list(MESH_ROUTES))
def test_trailing_idle_ticks_are_one_run(route, monkeypatch):
    """The two idle ticks after the last scan are one run of the program,
    keyed ``("idle", 2)``, after frames 1-3 (frame 0 builds it)."""
    kind, grid, n, axis, w, cap = MESH_ROUTES[route]
    _spill_cap(monkeypatch, cap)
    fw = _world(kind, grid, _mesh(n, axis))
    runs = _Runs(monkeypatch)
    capture.run_program(fw, fw.init((w,)), TICKS, seed=3, graphs=False)
    idle = np.diff(fw.fire_schedule(TICKS, 0.0)[0], prepend=-1) - 1
    assert runs.keys == [*(int(k) for k in idle[1:]), ("idle", TICKS - 25)]
    assert fw.capture_stats.replays + fw.capture_stats.eager == 4 + 1


def test_mesh_program_resumes_and_splits_one_read_a_frame(monkeypatch):
    """A second program rollout from the first's returned (static) state
    equals the eager mesh loop continued from its own; the local relabel's
    program reads the flags of both world rows at once, once a frame."""
    mesh = _mesh(8, 4)
    fw = _world("grid", dict(n_particles=16), mesh)
    s1, _ = fw.rollout_cadence(fw.init((2,)), TICKS, seed=0, capture=False)
    s2, _ = capture.run_program(fw, fw.init((2,)), TICKS, seed=0,
                                graphs=False)
    reads = _Reads(monkeypatch)
    _assert_same_run(fw.rollout_cadence(s1, TICKS, seed=1, capture=False),
                     capture.run_program(fw, s2, TICKS, seed=1, graphs=False))
    assert reads.reads == 8 and len(reads.flags) == 16


def test_mesh_program_matches_jax_sharded_rollout():
    """The ``"gather"`` route on a 2 x 4 mesh, the frame program fed the
    JAX package's in-step draws, against the JAX package's jitted
    ``rollout_cadence`` on a 2 x 4 mesh of its virtual CPU devices:
    poses slot for slot, ancestors, weights and outputs at
    ``test_update_fleet_mesh_matches_jax``'s gates, maps' flip fraction
    below 1e-3."""
    import jax
    import jax.numpy as jnp

    from slamrs_tpu.graph import compile as jcompile
    from slamrs_tpu.models import gridslam as jgs
    from slamrs_tpu.parallel import fleet as jfleet
    from test_torch_fleet import BASE, _flip
    from test_torch_fleet_world import _fleet_draws

    cfg = dict(BASE, fleet_resample="gather")
    w, ticks = 2, 14
    jmesh = jfleet.make_mesh(8, particle_axis=4)
    jw = jcompile.make_fused(grid_config=jgs.GridSlamConfig(**cfg),
                             mesh=jmesh)
    js0 = jfleet.shard_world_state(jw.init((w,)), jmesh, w)
    shardings = jfleet.fleet_shardings(js0, jmesh, w)

    cmds = jw.commands_for(ticks)  # concrete: the host unrolls them

    @jax.jit
    def run(s):
        final, outs = jw.rollout_cadence(s, ticks, seed=4, commands=cmds,
                                         initial_timer=0.0)
        return jax.lax.with_sharding_constraint(final, shardings), outs

    jst, jo = run(js0)
    noise, _ = _fleet_draws(jw, ticks, 4, w)
    tw = tcompile.make_fused(grid_config=tgs.GridSlamConfig(**cfg),
                             mesh=_mesh(8, 4), device=CPU)
    tst, to = capture.run_program(tw, tw.init((w,)), ticks, seed=4,
                                  initial_timer=0.0, noise=noise,
                                  graphs=False)
    assert tfleet.mesh_of(tst) == tw.mesh and to.fired.shape[0] == 2
    g = tfleet.unshard_world_state(tst).grid
    np.testing.assert_allclose(g.poses.numpy(), np.asarray(jst.grid.poses),
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(g.ancestors.numpy(),
                                  np.asarray(jst.grid.ancestors))
    np.testing.assert_allclose(g.weights.numpy(),
                               np.asarray(jst.grid.weights), rtol=1e-4,
                               atol=1e-7)
    np.testing.assert_allclose(to.grid_pose.numpy(), np.asarray(jo.grid_pose),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(to.n_eff.numpy(), np.asarray(jo.n_eff),
                               rtol=1e-3)
    np.testing.assert_allclose(to.pose.numpy(), np.asarray(jo.pose),
                               atol=1e-5)
    assert _flip(g.grids, jnp.asarray(jst.grid.grids)) < 1e-3


# ---- the tick programs ----------------------------------------------------

TICK_ROUTES = {
    "fused": ("grid", {}, None, ()),
    "dda": ("dda_yaml", None, None, ()),
    "icp": ("icp", None, None, ()),
    "ekf": ("ekf", None, None, ()),
    "local_2x4": ("grid", dict(n_particles=16), (8, 4), (2,)),
}


@pytest.mark.parametrize("draws", ["seed", "injected"])
@pytest.mark.parametrize("route", list(TICK_ROUTES))
def test_tick_programs_equal_the_eager_rollout(route, draws):
    kind, grid, mesh, worlds = TICK_ROUTES[route]
    fw = _world(kind, grid, None if mesh is None else _mesh(*mesh))
    ticks = 35 if kind == "dda_yaml" else 20  # grid_slam.yaml: 1 scan/s
    kw = _draws(fw, worlds, ticks, 8) if draws == "injected" else {}
    eager = fw.rollout(fw.init(worlds), ticks, seed=2, capture=False, **kw)
    program = capture.run_ticks(fw, fw.init(worlds), ticks, seed=2,
                                graphs=False, **kw)
    _assert_same_run(eager, program)
    assert bool(eager[1].fired.any()) and not bool(eager[1].fired.all())
    stats = fw.capture_stats
    assert stats.frames == ticks and stats.eager == ticks
    assert eager[1].pose.shape[0] == ticks


@pytest.mark.parametrize("draws", ["seed", "injected"])
@pytest.mark.parametrize("route", list(TICK_ROUTES))
def test_tick_program_is_kept_across_calls(route, draws, monkeypatch):
    """A tick rollout handed the state the last one returned runs on the
    kept program (``rollout.program_reused``): every tick a run of it,
    none run before it, bitwise the eager rollout continued."""
    from slamrs_tpu_torch.utils import trace

    kind, grid, mesh, worlds = TICK_ROUTES[route]
    fw = _world(kind, grid, None if mesh is None else _mesh(*mesh))
    ticks = 35 if kind == "dda_yaml" else 20
    state, eager = fw.init(worlds), fw.init(worlds)
    runs = _Runs(monkeypatch)
    kept = None
    for call, seed in enumerate((2, 9)):
        kw = (_draws(fw, worlds, ticks, 8 + seed, frames=ticks)
              if draws == "injected" else {})
        lead = int(fw.fire_schedule(ticks, state.scan_timer)[0][0]) + 1
        want = fw.rollout(eager, ticks, seed=seed, capture=False, **kw)
        runs.keys.clear()
        got = capture.run_ticks(fw, state, ticks, seed=seed, graphs=False,
                                **kw)
        _assert_same_run(want, got)
        eager, state = want[0], got[0]
        assert trace.calls()[-1]["counts"].get(capture.REUSED) \
            == (1 if call else None)
        assert (fw.frame_program is kept) == (call > 0)
        kept = fw.frame_program
        assert len(runs.keys) == (ticks if call else ticks - lead)
        assert {k[0] for k in runs.keys} == {"tick"}
        assert fw.capture_stats.eager == ticks  # without graphs: every run


def _interleaved(fw, worlds, ticks, run) -> list:
    """Cadence, tick and cadence calls on one carried state through
    ``run(method, state, ticks, seed)``, each bitwise the eager loops
    continued; returns whether each ran on the kept program."""
    from slamrs_tpu_torch.utils import trace

    state, eager = fw.init(worlds), fw.init(worlds)
    reused = []
    for method, seed in (("rollout_cadence", 3), ("rollout", 8),
                         ("rollout_cadence", 5)):
        want = getattr(fw, method)(eager, ticks, seed=seed, capture=False)
        got = run(method, state, ticks, seed)
        _assert_same_run(want, got)
        eager, state = want[0], got[0]
        reused.append(trace.calls()[-1]["counts"].get(capture.REUSED) == 1)
    return reused


@pytest.mark.parametrize("route", list(TICK_ROUTES))
def test_cadence_and_tick_calls_share_the_kept_program(route):
    """The tick call needs a row a tick, more than the cadence call's
    program holds, and builds; the cadence call after it runs on that
    program."""
    kind, grid, mesh, worlds = TICK_ROUTES[route]
    fw = _world(kind, grid, None if mesh is None else _mesh(*mesh))
    ticks = 35 if kind == "dda_yaml" else 20

    def run(method, state, ticks, seed):
        fn = capture.run_program if method == "rollout_cadence" \
            else capture.run_ticks
        return fn(fw, state, ticks, seed=seed, graphs=False)

    assert _interleaved(fw, worlds, ticks, run) == [False, False, True]


def test_tick_programs_match_jax_rollout():
    """The fused grid world (``grid_slam_fused.yaml``, 16 particles) for
    60 ticks through the tick programs, fed the JAX rollout's draws,
    against ``jax.jit(fw.rollout)`` at ``test_torch_world.py``'s gates."""
    import jax
    import jax.numpy as jnp

    from slamrs_tpu.graph import compile as jcompile
    from slamrs_tpu.graph.config import load_config as jload
    from torch_compare import rollout_grid_noise

    yaml = str(ROOT / "configs" / "grid_slam_fused.yaml")
    jw = jcompile.compile_world(jload(yaml))
    tw = tcompile.compile_world(load_config(yaml), device=CPU)
    jw.grid_config = dataclasses.replace(jw.grid_config, n_particles=16)
    tw.grid_config = dataclasses.replace(tw.grid_config, n_particles=16)
    ticks = 60
    js0 = jw.init()
    jst, jo = jax.jit(lambda s: jw.rollout(s, ticks, seed=0))(js0)
    tst, to = capture.run_ticks(
        tw, tw.init(), ticks, seed=0, graphs=False,
        noise=rollout_grid_noise(jw, js0, ticks, 0, 0.0))
    np.testing.assert_array_equal(to.fired.numpy(), np.asarray(jo.fired))
    np.testing.assert_allclose(to.grid_pose.numpy(), np.asarray(jo.grid_pose),
                               atol=1e-4)
    np.testing.assert_allclose(to.n_eff.numpy(), np.asarray(jo.n_eff),
                               rtol=1e-3)
    np.testing.assert_allclose(to.pose.numpy(), np.asarray(jo.pose),
                               atol=1e-5)
    jg = np.asarray(jst.grid.grids.astype(jnp.float32))
    flip = float((np.abs(tst.grid.grids.float().numpy() - jg) > 0.01).mean())
    assert flip < 1e-3, flip
    assert np.float32(tst.scan_timer) == np.asarray(jst.scan_timer)


# ---- the switch -----------------------------------------------------------

@pytest.mark.parametrize("method", ["rollout", "rollout_cadence"])
def test_capture_true_raises_on_the_cpu_and_on_distinct_devices(method):
    fw = _world("grid")
    with pytest.raises(ValueError, match="CUDA"):
        getattr(fw, method)(fw.init(), TICKS, capture=True)
    mesh = _mesh(2, 1)
    with pytest.raises(ValueError, match="CUDA"):
        getattr(fw, method)(tfleet.shard_world_state(fw.init((2,)), mesh, 2),
                            TICKS, capture=True)
    two_cards = tfleet.make_mesh(2, devices=[torch.device("cuda", 0),
                                             torch.device("cuda", 1)])
    with pytest.raises(NotImplementedError, match="distinct devices"):
        getattr(dataclasses.replace(fw, mesh=two_cards), method)(
            fw.init((2,)), TICKS, capture=True)
    with pytest.raises(NotImplementedError, match="distinct devices"):
        capture.check_graphs(two_cards, "cuda:0", "a rollout")
    # None runs the eager loop on the CPU, as False does
    fw.capture_stats = None
    _assert_same_run(getattr(fw, method)(fw.init(), TICKS, seed=1),
                     getattr(fw, method)(fw.init(), TICKS, seed=1,
                                         capture=False))
    assert fw.capture_stats is None
