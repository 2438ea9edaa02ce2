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
YAML parse, the CLI, and import hygiene.
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
from slamrs_tpu_torch import convert  # noqa: E402
from slamrs_tpu_torch.__main__ import main as cli_main  # noqa: E402
from slamrs_tpu_torch.graph import compile as tcompile  # noqa: E402
from slamrs_tpu_torch.graph.config import load_config as tload  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
YAML = str(ROOT / "configs" / "grid_slam_fused.yaml")
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


def _jax_noise(jw, state, n_steps, seed, timer):
    """The per-frame draws JAX's rollout_cadence makes (same fire pattern
    and key discipline), as numpy."""
    dt, period = np.float32(jw.dt), np.float32(jw.params.update_period)
    timer = np.float32(timer)
    fire = []
    for i in range(n_steps):
        timer = np.float32(timer + dt)
        if timer > period:
            fire.append(i)
            timer = np.float32(timer - period)
    keys = jax.random.split(jax.random.key(seed), n_steps)[np.array(fire)]
    return tuple(np.asarray(x) for x in jw._grid_noise(keys, state))


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
    noise = _jax_noise(jw, js0, TICKS, 0, 0.0)
    tst, to = tw.rollout_cadence(tw.init(), TICKS, seed=0, initial_timer=0.0,
                                 noise=noise)
    assert to.grid_pose.shape == (len(noise[0]), 3)
    _check(jst, jo, tst, to)


def test_state_carried_over_from_jax():
    """JAX runs 3 frames; its state crosses through convert.py; both
    packages continue 3 more frames from it."""
    jw, tw = _worlds("compile_world")
    tw.scene = convert.scene_from_numpy(np.asarray(jw.scene.segments),
                                        np.asarray(jw.scene.segment_mask),
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
    noise = _jax_noise(jw, jst, rest, 1, timer)
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
    from slamrs_tpu_torch.graph.config import parse_config

    text = Path(YAML).read_text() + (
        "\n- !IcpPointMapper\n  topic_observation: \"robot/observation\"\n")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tcompile.compile_world(parse_config(text), device="cpu")
    with pytest.raises(NotImplementedError):
        tcompile.make_fused(ekf_config=object(), device="cpu")


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
    assert int(out.stdout.strip()) >= 18  # every module was imported
