"""The cadence rollout's frame program (``slamrs_tpu_torch/graph/capture.py``).

On the CPU, the frame program runs without capture
(``capture.run_program(..., graphs=False)``): the code a CUDA graph
captures, on the same static buffers, with the same copy-back into the
static state, the same static draw buffers and the same outputs written
at a device-held frame index.  It must equal the eager frame loop
(``rollout_cadence(capture=False)``) bitwise, state and outputs, under
the seed and under injected draws, for a fused lineage world (K1
deferred), a tiled one (K3), copy on write (K1 in place + K2), gather,
dda (``configs/grid_slam.yaml``), dense, ICP + EKF, and a 3-world fleet
(K1 over the world axis + K2).  Against the JAX package's
``rollout_cadence`` under the JAX draws (``tests/torch_compare.py``) it
holds ``tests/test_torch_world.py``'s gates: per-frame best pose 1e-4 m,
N_eff rtol 1e-3, ground truth 1e-5 m, map flip fraction < 1e-3; ICP
1e-4 m, EKF 1e-3 m.  ``capture=True`` raises on the CPU (a CPU mesh
too) and on a mesh over several distinct devices, and a CPU mesh runs
eagerly with ``capture=None``.  The program kept on the world runs
calls on the state the last call returned, bitwise the eager loop
continued, and a fresh state builds a new one
(``test_kept_program_carries_calls_as_the_eager_loop``; on the card,
``tests/test_torch_cuda.py``'s ``kept`` tests, and here an ICP-only
world's).

The ``cuda`` cases hold the captured run against the eager loop on the
card, bitwise, under the seed and under injected draws, with the
wrappers' launch counts equal.  Run them there (no JAX needed):

    python -m pytest tests/test_torch_capture.py -q --noconftest -m cuda
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from slamrs_tpu_torch.graph import capture  # noqa: E402
from slamrs_tpu_torch.graph import compile as tcompile  # noqa: E402
from slamrs_tpu_torch.graph.config import load_config  # noqa: E402
from slamrs_tpu_torch.models import ekf as tekf  # noqa: E402
from slamrs_tpu_torch.models import icp_mapper as tmap  # noqa: E402
from slamrs_tpu_torch.models.gridslam import GridSlamConfig  # noqa: E402
from slamrs_tpu_torch.models.simulator import Scene, SimParams  # noqa: E402
from slamrs_tpu_torch.parallel import fleet as pf  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SCRIPT = [[4.0, 0.05, 0.08], [8.0, 0.08, 0.05], [999.0, 0.06, 0.06]]
TICKS = 40


def _ticks(route: str, card: bool = False) -> int:
    """Ticks for 6 scan frames (14 on the card); ``grid_slam.yaml`` scans
    once a second."""
    if route == "dda":
        return 450 if card else 190
    return 90 if card else TICKS


# route: (worlds, grid config overrides, or a preset)
ROUTES = {
    "lineage": ((), dict()),
    "tiled": ((), dict(resample_cow="tiled")),
    "cow": ((), dict(resample_cow=True, fused_resident=False)),
    "gather": ((), dict(resample_cow=False, fused_resident=False)),
    "dense": ((), dict(integrate="dense", grid_dtype="float32")),
    "dda": ((), "grid_slam.yaml"),
    "icp_ekf": ((), None),
    "fleet": ((3,), dict(n_particles=6)),
}


def _world(route: str, device):
    worlds, spec = ROUTES[route]
    if spec == "grid_slam.yaml":
        fw = tcompile.compile_world(
            load_config(str(ROOT / "configs" / "grid_slam.yaml")),
            device=device)
        fw.grid_config = dataclasses.replace(fw.grid_config, n_particles=4)
        return fw, worlds
    if spec is None:
        return tcompile.make_fused(
            icp_config=tmap.IcpMapConfig(capacity=2048, step_threshold=0.05),
            ekf_config=tekf.EkfConfig(), control_script=SCRIPT,
            device=device), worlds
    cfg = GridSlamConfig(position_x=-2.0, position_y=-2.0, width=4.0,
                         height=4.0, resolution=0.05, n_particles=8,
                         max_scan_range=1.0, integrate="fused",
                         resample_neff_frac=0.5, grid_dtype="bfloat16")
    cfg = dataclasses.replace(cfg, **spec)
    rects = [(-1.0, -1.0, 2.0, 2.0), (-0.1, -0.4, 0.5, 0.1),
             (-0.6, 0.4, 0.2, 0.5)]
    return tcompile.make_fused(
        scene=Scene.build(rects=rects, lines=[(-0.6, -0.4, 0.2, 0.4)],
                          device=device),
        params=SimParams.make(wheel_base=0.1, update_period=0.2,
                              scanner_range=1.0),
        grid_config=cfg, control_script=SCRIPT, device=device), worlds


def _draws(fw, worlds, n_steps, seed, frames=None):
    """numpy draws of every frame, as ``noise=`` and ``landmark_noise=``
    take them (the grid's when the world runs grid SLAM, the landmark
    sensor's when it runs the EKF), for the frames ``n_steps`` ticks fire
    from a timer at 0, or ``frames``."""
    if frames is None:
        frames = fw.fire_schedule(n_steps, 0.0)[0].size
    rng = np.random.default_rng(seed)
    noise = lm = None
    if fw.grid_config is not None:
        p = fw.grid_config.n_particles
        noise = (rng.standard_normal((frames, *worlds, p), np.float32),
                 rng.standard_normal((frames, *worlds, p), np.float32),
                 rng.random((frames, *worlds, 1), np.float32))
    if fw.ekf_config is not None:
        lanes = fw.scene.landmarks.shape[0]
        lm = tuple(rng.standard_normal((frames, *worlds, lanes), np.float32)
                   for _ in range(2))
    return dict(noise=noise, landmark_noise=lm)


def _trailing(fw, ticks, timer) -> int:
    """1 when ``ticks`` ticks from ``timer`` end on idle ticks, which the
    program runs as one ``("idle", n)`` run, else 0."""
    return int(fw.fire_schedule(ticks, timer)[0][-1] < ticks - 1)


def _assert_same_run(a, b):
    (sa, oa), (sb, ob) = a, b
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


@pytest.mark.parametrize("draws", ["seed", "injected"])
@pytest.mark.parametrize("route", list(ROUTES))
def test_frame_program_equals_the_eager_loop(route, draws):
    fw, worlds = _world(route, "cpu")
    ticks = _ticks(route)
    kw = _draws(fw, worlds, ticks, 5) if draws == "injected" else {}
    eager = fw.rollout_cadence(fw.init(worlds), ticks, seed=3,
                               capture=False, **kw)
    program = capture.run_program(fw, fw.init(worlds), ticks, seed=3,
                                  graphs=False, **kw)
    _assert_same_run(eager, program)
    stats = fw.capture_stats
    assert stats.frames == eager[1].fired.shape[0]
    # without graphs every run is eager: each frame, the trailing ticks'
    assert stats.eager == stats.frames + _trailing(fw, ticks, 0.0)
    assert stats.graphs == 0 and stats.replays == 0
    if worlds:
        assert eager[1].pose.shape[1] == worlds[0]


def test_capture_none_runs_the_eager_loop_on_the_cpu():
    fw, _ = _world("lineage", "cpu")
    fw.capture_stats = None
    a = fw.rollout_cadence(fw.init(), TICKS, seed=1)
    assert fw.capture_stats is None  # no frame program on the CPU
    _assert_same_run(a, fw.rollout_cadence(fw.init(), TICKS, seed=1,
                                           capture=False))


def test_frame_program_resumes_from_its_own_state():
    """A second rollout from the program's returned state (the static
    buffers) equals the eager loop continued from its own."""
    fw, _ = _world("lineage", "cpu")
    s1, _ = fw.rollout_cadence(fw.init(), TICKS, seed=0, capture=False)
    s2, _ = capture.run_program(fw, fw.init(), TICKS, seed=0, graphs=False)
    _assert_same_run(fw.rollout_cadence(s1, TICKS, seed=1, capture=False),
                     capture.run_program(fw, s2, TICKS, seed=1,
                                         graphs=False))


def _values(outs) -> list:
    """The tensors of a rollout's outputs."""
    return [t for t in outs if t is not None]


def _same_values(tensors, copies) -> bool:
    return len(tensors) == len(copies) and all(
        torch.equal(a, b) for a, b in zip(tensors, copies))


@pytest.mark.parametrize("draws", ["seed", "injected"])
@pytest.mark.parametrize("route", list(ROUTES))
def test_kept_program_carries_calls_as_the_eager_loop(route, draws):
    """Three calls with the state carried and a new seed (or new draws)
    each: the kept program (a frame count that changes from call to call,
    a new idle count at frame 0) equals the eager loop continued, bitwise; the
    second and third run on the kept program (``rollout.program_reused``)
    with statistics of their own; call 1's outputs survive call 3; a
    fresh ``init()`` builds a new program and leaves the returned state
    alone."""
    from slamrs_tpu_torch.utils import trace

    fw, worlds = _world(route, "cpu")
    ticks = _ticks(route)
    eager_state, state = fw.init(worlds), fw.init(worlds)
    kept, frames = None, []
    for call, seed in enumerate((3, 11, 4)):
        kw = (_draws(fw, worlds, ticks, 20 + seed,
                     frames=capture._frames_max(fw, ticks))
              if draws == "injected" else {})
        trailing = _trailing(fw, ticks, state.scan_timer)
        eager = fw.rollout_cadence(eager_state, ticks, seed=seed,
                                   capture=False, **kw)
        state, out = capture.run_program(fw, state, ticks, seed=seed,
                                          graphs=False, **kw)
        _assert_same_run(eager, (state, out))
        eager_state = eager[0]
        rec = trace.calls()[-1]
        assert rec["name"] == "rollout_cadence"
        assert rec["counts"].get(capture.REUSED) == (1 if call else None)
        assert (fw.frame_program is kept) == (call > 0)
        kept = fw.frame_program
        stats = fw.capture_stats
        assert stats.frames == out.fired.shape[0]
        assert stats.eager == stats.frames + trailing and stats.replays == 0
        assert all(a is b for a, b in zip(
            capture._tensor_leaves(state), capture._tensor_leaves(kept.state)))
        if call == 0:
            out1, out1_values = out, [t.clone() for t in _values(out)]
        frames.append(stats.frames)
    assert len(set(frames)) > 1
    assert _same_values(_values(out1), out1_values)
    returned = [t.clone() for t in capture._tensor_leaves(state)]
    capture.run_program(fw, fw.init(worlds), ticks, seed=5, graphs=False)
    assert fw.frame_program is not kept
    assert trace.calls()[-1]["counts"].get(capture.REUSED) is None
    assert _same_values(capture._tensor_leaves(state), returned)


def test_capture_true_raises_on_the_cpu():
    fw, _ = _world("lineage", "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        fw.rollout_cadence(fw.init(), TICKS, capture=True)
    with pytest.raises(ValueError, match="CUDA"):
        capture.run_program(fw, fw.init(), TICKS, graphs=True)


def test_capture_true_raises_on_a_mesh_and_none_runs_it_eagerly():
    """``capture=True`` raises on a CPU mesh (no CUDA graphs there) and on
    a mesh over several distinct devices (not captured yet); on the CPU
    mesh ``capture=None`` runs the eager loop, which the uncaptured frame
    program equals (``tests/test_torch_mesh_capture.py`` has every
    route)."""
    fw, _ = _world("fleet", "cpu")
    mesh = pf.make_mesh(2, devices=[torch.device("cpu")] * 2)
    sharded = pf.shard_world_state(fw.init((2,)), mesh, 2)
    with pytest.raises(ValueError, match="CUDA"):
        fw.rollout_cadence(sharded, TICKS, capture=True)
    two_cards = pf.make_mesh(2, devices=[torch.device("cuda", 0),
                                         torch.device("cuda", 1)])
    with pytest.raises(NotImplementedError, match="mesh"):
        dataclasses.replace(fw, mesh=two_cards).rollout_cadence(
            fw.init((2,)), TICKS, capture=True)
    _assert_same_run(  # block for block
        fw.rollout_cadence(pf.shard_world_state(fw.init((2,)), mesh, 2),
                           TICKS, seed=2, capture=False),
        capture.run_program(fw, pf.shard_world_state(fw.init((2,)), mesh, 2),
                            TICKS, seed=2, graphs=False))
    st, outs = fw.rollout_cadence(sharded, TICKS, seed=2)
    one, one_outs = fw.rollout_cadence(fw.init((2,)), TICKS, seed=2,
                                       capture=False)
    assert torch.equal(outs.grid_pose, one_outs.grid_pose)
    assert torch.equal(pf.unshard_world_state(st).pose, one.pose)


def test_frame_program_matches_jax():
    """The grid world at ``test_torch_world.py``'s gates, the frame
    program fed the JAX rollout's draws."""
    import jax.numpy as jnp

    from slamrs_tpu.graph import compile as jcompile
    from slamrs_tpu.graph.config import load_config as jload
    from torch_compare import rollout_grid_noise

    yaml = str(ROOT / "configs" / "grid_slam_fused.yaml")
    jw = jcompile.compile_world(jload(yaml))
    tw = tcompile.compile_world(load_config(yaml), device="cpu")
    jw.grid_config = dataclasses.replace(jw.grid_config, n_particles=16)
    tw.grid_config = dataclasses.replace(tw.grid_config, n_particles=16)
    ticks = 60
    js0 = jw.init()
    jst, jo = jw.rollout_cadence(js0, ticks, seed=0, initial_timer=0.0)
    tst, to = capture.run_program(
        tw, tw.init(), ticks, seed=0, initial_timer=0.0, graphs=False,
        noise=rollout_grid_noise(jw, js0, ticks, 0, 0.0))
    np.testing.assert_array_equal(to.fired.numpy(), np.asarray(jo.fired))
    np.testing.assert_allclose(to.grid_pose.numpy(), np.asarray(jo.grid_pose),
                               atol=1e-4)
    np.testing.assert_allclose(to.n_eff.numpy(), np.asarray(jo.n_eff),
                               rtol=1e-3)
    np.testing.assert_allclose(to.pose.numpy(), np.asarray(jo.pose),
                               atol=1e-5)
    np.testing.assert_allclose(tst.pose.numpy(), np.asarray(jst.pose),
                               atol=1e-5)
    assert np.float32(tst.scan_timer) == np.asarray(jst.scan_timer)
    jg = np.asarray(jst.grid.grids.astype(jnp.float32))
    flip = float((np.abs(tst.grid.grids.float().numpy() - jg) > 0.01).mean())
    assert flip < 1e-3, flip
    np.testing.assert_array_equal(tst.grid.ancestors.numpy(),
                                  np.asarray(jst.grid.ancestors))
    assert tst.grid.best_idx.dtype == torch.int32


def test_frame_program_icp_ekf_matches_jax():
    from slamrs_tpu.graph import compile as jcompile
    from slamrs_tpu.models import ekf as jekf
    from slamrs_tpu.models import icp_mapper as jmap
    from torch_compare import rollout_landmark_noise

    jw = jcompile.make_fused(
        icp_config=jmap.IcpMapConfig(capacity=2048, step_threshold=0.05),
        ekf_config=jekf.EkfConfig())
    tw = tcompile.make_fused(
        icp_config=tmap.IcpMapConfig(capacity=2048, step_threshold=0.05),
        ekf_config=tekf.EkfConfig(), device="cpu")
    ticks = 60
    jst, jo = jw.rollout_cadence(jw.init(), ticks, seed=0, initial_timer=0.0)
    tst, to = capture.run_program(
        tw, tw.init(), ticks, seed=0, graphs=False,
        landmark_noise=rollout_landmark_noise(jw, ticks, 0))
    np.testing.assert_allclose(to.pose.numpy(), np.asarray(jo.pose),
                               atol=1e-5)
    np.testing.assert_allclose(to.icp_pose.numpy(), np.asarray(jo.icp_pose),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(to.ekf_pose.numpy(), np.asarray(jo.ekf_pose),
                               atol=1e-3, rtol=0)
    assert int(tst.icp.count) == int(jst.icp.count)


# --- on the card --------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


CARD_ROUTES = ["lineage", "tiled", "cow", "gather", "dense", "dda",
               "icp_ekf", "fleet"]


@pytest.mark.cuda
@pytest.mark.parametrize("draws", ["seed", "injected"])
@pytest.mark.parametrize("route", CARD_ROUTES)
def test_captured_equals_eager_on_the_card(route, draws, dev):
    fw, worlds = _world(route, dev)
    ticks = _ticks(route, card=True)  # graphs are captured and replayed
    kw = _draws(fw, worlds, ticks, 5) if draws == "injected" else {}
    before = capture.launch_counts()
    eager = fw.rollout_cadence(fw.init(worlds), ticks, seed=3,
                               capture=False, **kw)
    torch.cuda.synchronize()
    mid = capture.launch_counts()
    captured = fw.rollout_cadence(fw.init(worlds), ticks, seed=3,
                                  capture=True, **kw)
    torch.cuda.synchronize()
    after = capture.launch_counts()
    _assert_same_run(eager, captured)
    stats = fw.capture_stats
    assert stats.graphs >= 1 and stats.replays >= 1
    assert stats.replays + stats.eager \
        == stats.frames + _trailing(fw, ticks, 0.0)
    for name in before:  # replays count what the eager frames count
        assert after[name] - mid[name] == mid[name] - before[name], name


@pytest.mark.cuda
def test_capture_true_raises_on_a_card_mesh(dev):
    """A mesh whose entries are all the card captures (bitwise the eager
    mesh loop); one over several distinct devices raises with
    ``capture=True``."""
    fw, _ = _world("fleet", dev)
    mesh = pf.make_mesh(2, devices=[dev] * 2)
    runs = [fw.rollout_cadence(pf.shard_world_state(fw.init((2,)), mesh, 2),
                               90, seed=4, capture=c) for c in (False, True)]
    _assert_same_run(*((pf.unshard_world_state(s), o) for s, o in runs))
    assert fw.capture_stats.replays >= 1
    two_cards = pf.make_mesh(2, devices=[torch.device("cuda", 0),
                                         torch.device("cuda", 1)])
    with pytest.raises(NotImplementedError):
        dataclasses.replace(fw, mesh=two_cards).rollout_cadence(
            fw.init((2,)), TICKS, capture=True)


@pytest.mark.cuda
def test_kept_program_of_an_icp_only_world_on_the_card(dev):
    """``configs/icp_test.yaml``'s world, ICP odometry alone (no grid
    state, no draws): from the third carried call every frame and
    trailing tick is a replay, with no eager run and no capture, and each
    call gives the bits of a fresh program run on a copy of its input."""
    from test_torch_cuda import _kept_calls

    config = load_config(str(ROOT / "configs" / "icp_test.yaml"))
    fw = tcompile.compile_world(config, device=dev)
    fresh = tcompile.compile_world(config, device=dev)
    assert fw.grid_config is None and fw.icp_config is not None
    for call, (stats, reused, runs) in enumerate(
            _kept_calls(fw, fresh, (), 90, False, (3, 8, 5, 1))):
        assert reused == (call > 0)
        assert stats.replays + stats.eager == runs
        if call >= 2:
            assert stats.eager == 0 and stats.capture_seconds == 0
            assert stats.replays == runs and stats.ticks is None
