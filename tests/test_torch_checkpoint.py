"""Checkpoints of the port's rollout state (``slamrs_tpu_torch.utils.
checkpoint``) in the JAX package's ``.npz`` layout.

Round trips, bitwise (bf16 maps included), of the headline world's state
(``configs/grid_slam_fused.yaml`` at 16 particles), a tiled one, the ICP
and EKF world and a 3-world fleet; a resumed rollout equals one continued
from the state in memory.  A checkpoint written by the JAX package's
``save`` resumes in the port: its leaves load unchanged, and the port's
rollout from it, fed the JAX draws, matches the JAX package's resumed
rollout at ``tests/test_torch_world.py``'s gates (best pose 1e-4 m, N_eff
rtol 1e-3, ground truth 1e-5 m, map flip fraction < 1e-3; ICP 1e-4 m,
EKF 1e-3 m).  A leaf count or shape that differs from the template's
raises, as in the JAX package.  Also ``rollout --save-state/--resume``.

The other way: a checkpoint the port writes (fused, dda, a 3-world fleet,
ICP, EKF) has the JAX layout leaf for leaf: every leaf's dtype is the
one the JAX package's ``save`` writes for its own state (the dtypes of
``jax.tree.leaves``, bf16 widened to f32; ``best_idx`` is int32), it
loads in the JAX package with warnings as errors, and the JAX package
resumes from it (the fused world at the gates above, the port fed the
JAX draws).
"""

from __future__ import annotations

import dataclasses
import json
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from slamrs_tpu.graph import compile as jcompile  # noqa: E402
from slamrs_tpu.graph.config import parse_config as jparse  # noqa: E402
from slamrs_tpu.models import ekf as jekf  # noqa: E402
from slamrs_tpu.models import icp_mapper as jmap  # noqa: E402
from slamrs_tpu.utils import checkpoint as jckpt  # noqa: E402
from slamrs_tpu_torch.__main__ import main as cli_main  # noqa: E402
from slamrs_tpu_torch.graph import compile as tcompile  # noqa: E402
from slamrs_tpu_torch.graph.config import parse_config  # noqa: E402
from slamrs_tpu_torch.models import ekf as tekf  # noqa: E402
from slamrs_tpu_torch.models import icp_mapper as tmap  # noqa: E402
from slamrs_tpu_torch.utils import checkpoint  # noqa: E402
from torch_compare import (flip_fraction, rollout_grid_noise,  # noqa: E402
                           rollout_landmark_noise)

ROOT = Path(__file__).resolve().parents[1]
YAML = ROOT / "configs" / "grid_slam_fused.yaml"


def _headline_text(particles=16, extra=""):
    return YAML.read_text().replace(
        "n_particles: 1024", f"n_particles: {particles}").replace(
        'grid_dtype: "bfloat16"', 'grid_dtype: "bfloat16"' + extra)


def _world(kind: str):
    if kind == "headline":
        return tcompile.compile_world(parse_config(_headline_text()),
                                      device="cpu"), ()
    if kind == "tiled":
        return tcompile.compile_world(parse_config(_headline_text(
            8, '\n    resample_cow: "tiled"')), device="cpu"), ()
    if kind == "icp_ekf":
        return tcompile.make_fused(
            icp_config=tmap.IcpMapConfig(capacity=2048, step_threshold=0.05),
            ekf_config=tekf.EkfConfig(), device="cpu"), ()
    fw = tcompile.compile_world(parse_config(_headline_text(6)),
                                device="cpu")
    return fw, (3,)  # a fleet of 3 worlds


def _assert_same(a, b):
    la, lb = checkpoint.leaves(a), checkpoint.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.shape == y.shape
            assert torch.equal(x, y)
        else:
            assert type(x) is type(y) and x == y


@pytest.mark.parametrize("kind", ["headline", "tiled", "icp_ekf", "fleet"])
def test_round_trip_and_resume(kind, tmp_path):
    fw, worlds = _world(kind)
    state, _ = fw.rollout_cadence(fw.init(worlds), 13, seed=0)
    path = tmp_path / "s.npz"
    checkpoint.save(path, state)
    loaded = checkpoint.load(path, fw.init(worlds))
    _assert_same(loaded, state)
    if state.grid is not None:
        assert loaded.grid.grids.dtype == torch.bfloat16
        assert (state.grid.tile_table is not None) == (kind == "tiled")
    with np.load(path) as data:  # the JAX package's layout
        assert sorted(data.files) == sorted(
            f"leaf_{i}" for i in range(len(checkpoint.leaves(state))))
        assert data["leaf_3"].shape == () and data["leaf_3"].dtype == \
            np.float32  # the scan timer
        assert data["leaf_4"].dtype == np.int32  # the scan counter
    # the in-place resample mechanisms write the input state: continue a
    # fresh load, not the state the rollout returned
    again = checkpoint.load(path, fw.init(worlds))
    s1, o1 = fw.rollout_cadence(loaded, 13, seed=1)
    s2, o2 = fw.rollout_cadence(again, 13, seed=1)
    _assert_same(s1, s2)
    for x, y in zip(o1, o2):
        assert (x is None) == (y is None)
        if x is not None:
            assert torch.equal(x, y)


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    text = _headline_text()
    jw = jcompile.compile_world(jparse(text))
    tw = tcompile.compile_world(parse_config(text), device="cpu")
    jst, _ = jw.rollout_cadence(jw.init(), 19, seed=0, initial_timer=0.0)
    path = str(tmp_path / "jax.npz")
    jckpt.save(path, jst)
    tst = checkpoint.load(path, tw.init())
    assert tst.grid.grids.dtype == torch.bfloat16
    assert torch.equal(tst.grid.grids.float(),
                       torch.from_numpy(np.asarray(jst.grid.grids,
                                                   np.float32)))
    assert tst.scan_timer == float(jst.scan_timer)
    assert tst.scan_counter == int(jst.scan_counter) == 3
    timer = float(jst.scan_timer)
    jst2, jo = jw.rollout_cadence(jst, 19, seed=1, initial_timer=timer)
    noise = rollout_grid_noise(jw, jst, 19, 1, timer)
    tst2, to = tw.rollout_cadence(tst, 19, seed=1, noise=noise)
    np.testing.assert_array_equal(to.fired.numpy(), np.asarray(jo.fired))
    np.testing.assert_allclose(to.grid_pose.numpy(),
                               np.asarray(jo.grid_pose), atol=1e-4)
    np.testing.assert_allclose(to.n_eff.numpy(), np.asarray(jo.n_eff),
                               rtol=1e-3)
    np.testing.assert_allclose(tst2.pose.numpy(), np.asarray(jst2.pose),
                               atol=1e-5)
    assert flip_fraction(tst2.grid.grids.float().numpy(),
                         np.asarray(jst2.grid.grids.astype(jnp.float32))) \
        < 1e-3


def test_jax_icp_ekf_checkpoint_resumes_in_the_port(tmp_path):
    jw = jcompile.make_fused(
        icp_config=jmap.IcpMapConfig(capacity=2048, step_threshold=0.05),
        ekf_config=jekf.EkfConfig())
    tw, _ = _world("icp_ekf")
    jst, _ = jw.rollout_cadence(jw.init(), 19, seed=0, initial_timer=0.0)
    path = str(tmp_path / "jax.npz")
    jckpt.save(path, jst)
    tst = checkpoint.load(path, tw.init())
    assert int(tst.icp.count) == int(jst.icp.count)
    timer = float(jst.scan_timer)
    jst2, jo = jw.rollout_cadence(jst, 13, seed=1, initial_timer=timer)
    tst2, to = tw.rollout_cadence(
        tst, 13, seed=1,
        landmark_noise=rollout_landmark_noise(jw, 13, 1, timer))
    np.testing.assert_allclose(to.icp_pose.numpy(), np.asarray(jo.icp_pose),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(to.ekf_pose.numpy(), np.asarray(jo.ekf_pose),
                               atol=1e-3, rtol=0)


def test_mismatch_raises(tmp_path):
    fw, _ = _world("headline")
    path = tmp_path / "s.npz"
    checkpoint.save(path, fw.init())
    smaller = dataclasses.replace(fw, grid_config=dataclasses.replace(
        fw.grid_config, n_particles=8))
    with pytest.raises(ValueError, match="shape"):
        checkpoint.load(path, smaller.init())
    icp, _ = _world("icp_ekf")
    with pytest.raises(ValueError, match="leaves"):
        checkpoint.load(path, icp.init())
    with pytest.raises(ValueError, match="leaves"):  # the JAX package too
        jckpt.load(str(path), jcompile.make_fused(
            icp_config=jmap.IcpMapConfig(capacity=2048)).init())


def test_cli_save_state_and_resume(tmp_path, capsys):
    cfg = tmp_path / "small.yaml"
    cfg.write_text(_headline_text())
    path = tmp_path / "s.npz"
    cli_main(["rollout", str(cfg), "--steps", "13", "--device", "cpu",
              "--save-state", str(path)])
    first = json.loads(capsys.readouterr().out)
    cli_main(["rollout", str(cfg), "--steps", "13", "--device", "cpu",
              "--resume", str(path), "--seed", "1"])
    resumed = json.loads(capsys.readouterr().out)
    fw, _ = _world("headline")
    state, _ = fw.rollout_cadence(fw.init(), 13, seed=0)
    assert first["final_pose"] == state.pose.tolist()
    state, outs = fw.rollout_cadence(state, 13, seed=1)
    assert resumed["final_pose"] == state.pose.tolist()
    assert resumed["scans"] == int(outs.fired.sum()) == 2


_PRESETS = {"dda": "grid_slam.yaml", "icp": "icp_test.yaml",
            "ekf": "landmarks.yaml"}


def _both_worlds(kind: str):
    """The JAX and the port's world of ``kind``, and its worlds axis."""
    if kind in _PRESETS:
        path = str(ROOT / "configs" / _PRESETS[kind])
        jw = jcompile.compile_world(jparse(Path(path).read_text()))
        tw = tcompile.compile_world(parse_config(Path(path).read_text()),
                                    device="cpu")
        if kind == "dda":
            jw.grid_config = dataclasses.replace(jw.grid_config,
                                                 n_particles=4)
            tw.grid_config = dataclasses.replace(tw.grid_config,
                                                 n_particles=4)
        return jw, tw, ()
    text = _headline_text(6 if kind == "fleet" else 16)
    return (jcompile.compile_world(jparse(text)),
            tcompile.compile_world(parse_config(text), device="cpu"),
            (3,) if kind == "fleet" else ())


@pytest.mark.parametrize("kind", ["fused", "dda", "fleet", "icp", "ekf"])
def test_port_checkpoint_resumes_in_jax(kind, tmp_path):
    jw, tw, worlds = _both_worlds(kind)
    ticks = 95 if kind == "dda" else 19  # 3 scan frames (dda: 1 s apart)
    tst, _ = tw.rollout_cadence(tw.init(worlds), ticks, seed=0)
    path = str(tmp_path / "port.npz")
    checkpoint.save(path, tst)
    jpath = str(tmp_path / "jax.npz")
    jinit = jw.init(worlds)
    jckpt.save(jpath, jinit)
    jleaves = jax.tree.leaves(jinit)
    with np.load(path) as ours, np.load(jpath) as theirs:
        assert len(jleaves) == sum(k.startswith("leaf_") for k in ours.files)
        for i, leaf in enumerate(jleaves):
            want = np.float32 if leaf.dtype == jnp.bfloat16 else leaf.dtype
            assert ours[f"leaf_{i}"].dtype == want == \
                theirs[f"leaf_{i}"].dtype, i
    if tst.grid is not None:
        assert tst.grid.best_idx.dtype == torch.int32
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        jst = jckpt.load(path, jinit)
    assert int(jst.scan_counter) == tst.scan_counter == 3
    timer = float(jst.scan_timer)
    assert timer == tst.scan_timer
    jst2, jo = jw.rollout_cadence(jst, ticks, seed=1, initial_timer=timer)
    assert int(jst2.scan_counter) == 6
    assert all(bool(jnp.isfinite(x).all()) for x in jax.tree.leaves(jo))
    if kind != "fused":
        return
    tst2, to = tw.rollout_cadence(
        tst, 19, seed=1, noise=rollout_grid_noise(jw, jst, 19, 1, timer))
    np.testing.assert_allclose(to.grid_pose.numpy(),
                               np.asarray(jo.grid_pose), atol=1e-4)
    np.testing.assert_allclose(to.n_eff.numpy(), np.asarray(jo.n_eff),
                               rtol=1e-3)
    np.testing.assert_allclose(tst2.pose.numpy(), np.asarray(jst2.pose),
                               atol=1e-5)
    np.testing.assert_array_equal(tst2.grid.best_idx.numpy(),
                                  np.asarray(jst2.grid.best_idx))
