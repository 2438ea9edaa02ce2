"""The port's main path as a whole against the JAX package.

``compile_world(load_config("configs/grid_slam_fused.yaml"))`` in both
packages (16 particles instead of 1,024), then ``rollout_cadence`` over
60 ticks, the port fed the draws the JAX rollout made.  Gates: per-frame
best-particle pose atol 1e-4 m and N_eff rtol 1e-3 (weights go through
exp of likelihood sums taken in another order), final ground-truth pose
atol 1e-5 m (float32 kinematics, cos/sin one ulp apart over 60 ticks),
final maps' flip fraction (|diff| > 0.01) below 1e-3 (atan2 bin flips of
the TPU kernel's polynomial).  Also: the same through ``make_fused``
(static beam spacing), a rollout continued by both packages from the
JAX package's state carried over by ``slamrs_tpu_torch.convert``, the
YAML parse, the CLI, and import hygiene.  The repo's default preset,
``configs/grid_slam.yaml`` (the dda integrator, 10 particles at 0.02 m),
for 3 scan frames at the same gates, and through the CLI on the CPU.

The ICP and EKF worlds (``make_fused`` with the JAX package's default
scene, 90 ticks): the ICP mapper's pose per frame within 1e-4 m of the
JAX package's (the solves' sum order moves it by up to ~4e-5 m over 14
frames, measured on the CPU); the EKF's pose, with the JAX package's
landmark draws injected, within the reference's own EKF gate of 1e-3 m
(``tests/test_parity.py``): the free-running filter is chaotic in
float32 (``tests/test_torch_ekf.py``), and gaps of ~6e-4 m were measured
on the CPU.  A frame continued from the JAX package's state, carried
over by ``convert.py``, holds both to 1e-5 m.  Both presets
(``configs/icp_test.yaml``, ``configs/landmarks.yaml``) compile to the
JAX package's configs and scenes.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from slamrs_tpu.graph import compile as jcompile  # noqa: E402
from slamrs_tpu.graph.config import load_config as jload  # noqa: E402
from slamrs_tpu.models import ekf as jekf  # noqa: E402
from slamrs_tpu.models import icp_mapper as jmap  # noqa: E402
from slamrs_tpu_torch import convert  # noqa: E402
from slamrs_tpu_torch.__main__ import main as cli_main  # noqa: E402
from slamrs_tpu_torch.graph import compile as tcompile  # noqa: E402
from slamrs_tpu_torch.graph.config import load_config as tload  # noqa: E402
from slamrs_tpu_torch.models import ekf as tekf  # noqa: E402
from slamrs_tpu_torch.models import icp_mapper as tmap  # noqa: E402

from torch_compare import (rollout_grid_noise,  # noqa: E402
                           rollout_landmark_noise)

ROOT = Path(__file__).resolve().parents[1]
YAML = str(ROOT / "configs" / "grid_slam_fused.yaml")
GRID_YAML = str(ROOT / "configs" / "grid_slam.yaml")
ICP_YAML = str(ROOT / "configs" / "icp_test.yaml")
EKF_YAML = str(ROOT / "configs" / "landmarks.yaml")
P = 16
TICKS = 60


def _worlds(kind):
    if kind == "compile_world":
        jw = jcompile.compile_world(jload(YAML))
        tw = tcompile.compile_world(tload(YAML), device="cpu")
    else:
        cfg = tload(YAML)  # the same grid config, through make_fused
        node = next(n for _, n in cfg.nodes if hasattr(n, "slam_config"))
        jcfg = jcompile.compile_world(jload(YAML)).grid_config
        jw = jcompile.make_fused(grid_config=jcfg)
        tw = tcompile.make_fused(grid_config=node.slam_config(), device="cpu")
    jw.grid_config = dataclasses.replace(jw.grid_config, n_particles=P)
    tw.grid_config = dataclasses.replace(tw.grid_config, n_particles=P)
    return jw, tw


def _check(jst, jo, tst, to):
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


@pytest.mark.parametrize("kind", ["compile_world", "make_fused"])
def test_rollout_cadence_matches_jax(kind):
    jw, tw = _worlds(kind)
    assert (tw.grid_config.beam_spacing is None) == (kind == "compile_world")
    js0 = jw.init()
    jst, jo = jw.rollout_cadence(js0, TICKS, seed=0, initial_timer=0.0)
    noise = rollout_grid_noise(jw, js0, TICKS, 0, 0.0)
    tst, to = tw.rollout_cadence(tw.init(), TICKS, seed=0, initial_timer=0.0,
                                 noise=noise)
    assert to.grid_pose.shape == (len(noise[0]), 3)
    _check(jst, jo, tst, to)


def test_state_carried_over_from_jax():
    """JAX runs 3 frames; its state crosses through convert.py; both
    packages continue 3 more frames from it."""
    jw, tw = _worlds("compile_world")
    tw.scene = convert.scene_from_numpy(*(np.asarray(x) for x in jw.scene),
                                        "cpu")
    first, rest = 19, 19  # 3 scan frames each from these timers
    jst, _ = jw.rollout_cadence(jw.init(), first, seed=0, initial_timer=0.0)
    g = jst.grid
    grid = convert.grid_state_from_numpy(
        np.asarray(g.poses), np.asarray(g.grids), np.asarray(g.weights),
        np.asarray(g.best_pose), np.asarray(g.best_idx),
        np.asarray(g.ancestors), "cpu")
    assert grid.grids.dtype == torch.bfloat16
    assert torch.equal(grid.grids.float(),
                       torch.from_numpy(np.asarray(g.grids, np.float32)))
    tst = convert.world_state_from_numpy(
        np.asarray(jst.pose), np.asarray(jst.accum_left),
        np.asarray(jst.accum_right), np.asarray(jst.scan_timer),
        np.asarray(jst.scan_counter), grid, "cpu")

    timer = float(jst.scan_timer)
    jst2, jo2 = jw.rollout_cadence(jst, rest, seed=1, initial_timer=timer)
    noise = rollout_grid_noise(jw, jst, rest, 1, timer)
    assert len(noise[0]) == 3
    tst2, to2 = tw.rollout_cadence(tst, rest, seed=1, noise=noise)
    _check(jst2, jo2, tst2, to2)


def test_yaml_parse_matches_jax():
    jw = jcompile.compile_world(jload(YAML))
    tw = tcompile.compile_world(tload(YAML), device="cpu")
    assert dataclasses.asdict(tw.grid_config) == \
        dataclasses.asdict(jw.grid_config)
    np.testing.assert_array_equal(tw.scene.segments.numpy(),
                                  np.asarray(jw.scene.segments))
    np.testing.assert_array_equal(tw.scene.segment_mask.numpy(),
                                  np.asarray(jw.scene.segment_mask))
    assert tw.control_script == jw.control_script
    assert tw.dt == jw.dt and tw.num_beams == jw.num_beams
    for name in tw.params._fields:
        assert np.float32(getattr(tw.params, name)) == \
            np.asarray(getattr(jw.params, name))
    cmd_t, cmd_j = tw.commands_for(400), jw.commands_for(400)
    np.testing.assert_array_equal(cmd_t.speed_left.numpy(),
                                  np.asarray(cmd_j.speed_left))
    np.testing.assert_array_equal(cmd_t.speed_right.numpy(),
                                  np.asarray(cmd_j.speed_right))


def test_compile_world_carries_resample_cow_tiled():
    """``resample_cow: tiled`` in the YAML reaches the grid config through
    the loader, the world's state holds a tile pool shaped as the JAX
    package's, and the world steps it."""
    from slamrs_tpu.graph.config import parse_config as jparse
    from slamrs_tpu_torch.graph.config import parse_config

    text = Path(YAML).read_text().replace(
        "n_particles: 1024", "n_particles: 8").replace(
        'grid_dtype: "bfloat16"', 'grid_dtype: "bfloat16"\n'
        '    resample_cow: "tiled"')
    jw = jcompile.compile_world(jparse(text))
    tw = tcompile.compile_world(parse_config(text), device="cpu")
    assert tw.grid_config.resample_cow == "tiled"
    assert dataclasses.asdict(tw.grid_config) == \
        dataclasses.asdict(jw.grid_config)
    st = tw.init()
    jst = jw.init()
    assert st.grid.tile_table is not None
    assert tuple(st.grid.grids.shape) == jst.grid.grids.shape
    assert tuple(st.grid.tile_table.shape) == jst.grid.tile_table.shape
    st, outs = tw.rollout_cadence(st, 14, seed=0)
    assert outs.fired.shape[0] == 2 and st.grid.tile_table is not None
    assert bool(torch.isfinite(outs.grid_pose).all())


def test_unported_nodes_raise():
    """Grid SLAM's dda integrator, asked for by a node, builds and inits
    as the JAX package's does (unpadded f32 maps); an unknown integrator
    raises when the world is initialized."""
    from slamrs_tpu.graph.config import parse_config as jparse
    from slamrs_tpu_torch.graph.config import parse_config

    text = Path(YAML).read_text().replace('integrate: "fused"',
                                          'integrate: "dda"')
    assert text != Path(YAML).read_text()
    fw = tcompile.compile_world(parse_config(text), device="cpu")
    jw = jcompile.compile_world(jparse(text))
    assert dataclasses.asdict(fw.grid_config) == \
        dataclasses.asdict(jw.grid_config)
    st, jst = fw.init().grid, jw.init().grid
    assert tuple(st.grids.shape) == jst.grids.shape == (1024, 80, 80)
    assert st.grids.dtype == torch.float32 and jst.grids.dtype == jnp.float32
    bad = tcompile.compile_world(
        parse_config(text.replace('integrate: "dda"', 'integrate: "ray"')),
        device="cpu")
    with pytest.raises(ValueError, match="integrate"):
        bad.init()


def test_rollout_and_cadence_agree_without_noise():
    """The per-tick rollout and the cadence rollout draw the same seeded
    numbers and give the same frames."""
    _, tw = _worlds("make_fused")
    s1, o1 = tw.rollout(tw.init(), 20, seed=4)
    s2, o2 = tw.rollout_cadence(tw.init(), 20, seed=4)
    fired = o1.fired
    assert int(fired.sum()) == o2.fired.shape[0] == s1.scan_counter
    torch.testing.assert_close(o1.grid_pose[fired], o2.grid_pose,
                               atol=1e-6, rtol=0)
    torch.testing.assert_close(s1.pose, s2.pose, atol=1e-6, rtol=0)


def test_cli_rollout_on_cpu(capsys):
    cli_main(["rollout", YAML, "--steps", "14", "--device", "cpu"])
    report = json.loads(capsys.readouterr().out)
    assert report["steps"] == 14 and report["scans"] == 2
    assert len(report["final_pose"]) == 3
    assert np.isfinite(report["grid_pose_rmse_xy"])


def test_cli_does_not_fall_back_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA is not available"):
        cli_main(["rollout", YAML, "--steps", "3"])


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import slamrs_tpu_torch as pkg\n"
        "mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "'slamrs_tpu_torch.')]\n"
        "for name in mods:\n"
        "    importlib.import_module(name)\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'slamrs_tpu')]\n"
        "assert not bad, bad\n"
        "print(len(mods))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 49  # every module was imported


def _icp_ekf_worlds():
    jw = jcompile.make_fused(
        icp_config=jmap.IcpMapConfig(capacity=2048, step_threshold=0.05),
        ekf_config=jekf.EkfConfig())
    tw = tcompile.make_fused(
        icp_config=tmap.IcpMapConfig(capacity=2048, step_threshold=0.05),
        ekf_config=tekf.EkfConfig(), device="cpu")
    return jw, tw


def test_icp_ekf_world_matches_jax():
    jw, tw = _icp_ekf_worlds()
    for name in ("segments", "segment_mask", "landmarks", "landmark_mask"):
        np.testing.assert_array_equal(getattr(tw.scene, name).numpy(),
                                      np.asarray(getattr(jw.scene, name)))
    ticks = 90
    jst, jo = jw.rollout_cadence(jw.init(), ticks, seed=0, initial_timer=0.0)
    tst, to = tw.rollout_cadence(
        tw.init(), ticks, seed=0,
        landmark_noise=rollout_landmark_noise(jw, ticks, 0))
    assert to.grid_pose is None and to.n_eff is None
    assert to.icp_pose.shape == (14, 3) == to.ekf_pose.shape
    np.testing.assert_allclose(to.pose.numpy(), np.asarray(jo.pose),
                               atol=1e-5)
    np.testing.assert_allclose(to.icp_pose.numpy(), np.asarray(jo.icp_pose),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(to.ekf_pose.numpy(), np.asarray(jo.ekf_pose),
                               atol=1e-3, rtol=0)
    assert int(tst.icp.count) == int(jst.icp.count) == 2048  # map full
    np.testing.assert_array_equal(tst.ekf.seen.numpy(),
                                  np.asarray(jst.ekf.seen))


def test_icp_ekf_state_carried_over_from_jax():
    """JAX runs 3 frames; its ICP and EKF states cross through
    convert.py; both packages continue 1 more frame from them."""
    jw, tw = _icp_ekf_worlds()
    jst, _ = jw.rollout_cadence(jw.init(), 19, seed=0, initial_timer=0.0)
    i, e = jst.icp, jst.ekf
    tst = convert.world_state_from_numpy(
        np.asarray(jst.pose), np.asarray(jst.accum_left),
        np.asarray(jst.accum_right), np.asarray(jst.scan_timer),
        np.asarray(jst.scan_counter), None, "cpu",
        icp=convert.icp_state_from_numpy(
            *(np.asarray(x) for x in i), "cpu"),
        ekf=convert.ekf_state_from_numpy(
            *(np.asarray(x) for x in e), "cpu"))
    assert int(tst.icp.count) == int(i.count) and tst.scan_counter == 3
    timer = float(jst.scan_timer)
    jst2, jo2 = jw.rollout_cadence(jst, 7, seed=1, initial_timer=timer)
    tst2, to2 = tw.rollout_cadence(
        tst, 7, seed=1,
        landmark_noise=rollout_landmark_noise(jw, 7, 1, timer))
    assert to2.icp_pose.shape[0] == 1
    np.testing.assert_allclose(to2.icp_pose.numpy(), np.asarray(jo2.icp_pose),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(to2.ekf_pose.numpy(), np.asarray(jo2.ekf_pose),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(tst2.icp.points.numpy(),
                               np.asarray(jst2.icp.points), atol=1e-5, rtol=0)
    assert int(tst2.icp.count) == int(jst2.icp.count)
    np.testing.assert_allclose(tst2.ekf.mean.numpy(),
                               np.asarray(jst2.ekf.mean), atol=1e-5, rtol=0)


@pytest.mark.parametrize("yaml", [ICP_YAML, EKF_YAML],
                         ids=["icp_test", "landmarks"])
def test_compile_world_icp_ekf_presets_match_jax(yaml):
    jw = jcompile.compile_world(jload(yaml))
    tw = tcompile.compile_world(tload(yaml), device="cpu")
    for name in ("grid_config", "icp_config", "ekf_config"):
        tc, jc = getattr(tw, name), getattr(jw, name)
        assert (tc is None) == (jc is None), name
        if tc is not None:
            assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert (tw.icp_config is None) == (yaml == EKF_YAML)
    for name in ("segments", "segment_mask", "landmarks", "landmark_mask"):
        np.testing.assert_array_equal(getattr(tw.scene, name).numpy(),
                                      np.asarray(getattr(jw.scene, name)))
    for name in tw.params._fields:
        assert np.float32(getattr(tw.params, name)) == \
            np.asarray(getattr(jw.params, name))
    assert tw.control_script == jw.control_script


@pytest.mark.parametrize("injected", [False, True],
                         ids=["generator", "injected"])
def test_icp_ekf_rollout_and_cadence_agree(injected):
    """Per tick and per frame, the same draws (the seeded generator's, or
    per-frame landmark draws handed to both) give the same frames; on
    idle ticks each filter's previous estimate is carried."""
    _, tw = _icp_ekf_worlds()
    rng = np.random.default_rng(9)
    draws = (tuple(rng.normal(size=(3, 7)).astype(np.float32)
                   for _ in range(2)) if injected else None)
    s1, o1 = tw.rollout(tw.init(), 20, seed=4, landmark_noise=draws)
    s2, o2 = tw.rollout_cadence(tw.init(), 20, seed=4, landmark_noise=draws)
    fired = o1.fired
    assert int(fired.sum()) == o2.fired.shape[0] == 3
    for name in ("icp_pose", "ekf_pose"):
        torch.testing.assert_close(getattr(o1, name)[fired],
                                   getattr(o2, name), atol=1e-6, rtol=0)
        per_tick = getattr(o1, name)
        first = int(torch.nonzero(fired)[0])
        torch.testing.assert_close(per_tick[first + 1],
                                   per_tick[first])  # carried
    torch.testing.assert_close(s1.ekf.mean, s2.ekf.mean, atol=1e-6, rtol=0)


@pytest.mark.parametrize("yaml,key", [(ICP_YAML, "icp_pose_rmse_xy"),
                                      (EKF_YAML, "ekf_pose_rmse_xy")],
                         ids=["icp_test", "landmarks"])
def test_cli_reports_icp_and_ekf_rmse(yaml, key, capsys):
    cli_main(["rollout", yaml, "--steps", "14", "--device", "cpu"])
    report = json.loads(capsys.readouterr().out)
    assert report["scans"] == 2 and np.isfinite(report[key])
    assert "grid_pose_rmse_xy" not in report


def test_grid_slam_yaml_matches_jax():
    """The repo's default preset, ``configs/grid_slam.yaml`` (dda, 10
    particles at 0.02 m), through ``compile_world`` in both packages: the
    same config, then 3 scan frames (95 ticks) with the JAX rollout's draws
    injected, held to ``_check``'s gates."""
    jw = jcompile.compile_world(jload(GRID_YAML))
    tw = tcompile.compile_world(tload(GRID_YAML), device="cpu")
    assert tw.grid_config.integrate == "dda"
    assert dataclasses.asdict(tw.grid_config) == \
        dataclasses.asdict(jw.grid_config)
    js0 = jw.init()
    jst, jo = jw.rollout_cadence(js0, 95, seed=0, initial_timer=0.0)
    noise = rollout_grid_noise(jw, js0, 95, 0, 0.0)
    assert len(noise[0]) == 3
    tst, to = tw.rollout_cadence(tw.init(), 95, seed=0, initial_timer=0.0,
                                 noise=noise)
    assert tst.grid.grids.shape == (10, 200, 200)
    _check(jst, jo, tst, to)


def test_cli_rollout_grid_slam_yaml_on_cpu(capsys):
    cli_main(["rollout", GRID_YAML, "--steps", "61", "--device", "cpu"])
    report = json.loads(capsys.readouterr().out)
    assert report["steps"] == 61 and report["scans"] == 2
    assert report["device"] == "cpu"
    assert np.isfinite(report["grid_pose_rmse_xy"])
