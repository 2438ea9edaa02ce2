"""The port's host graph (``slamrs_tpu_torch.graph.app.App``) against the
JAX package's App on the same YAML, frame by frame, on the CPU.

Draws are injected: JAX threefry and torch Philox never agree, so the
JAX nodes' key chains are rebuilt (``tests/torch_compare.py``) and handed
to the port's nodes through their seams (``GridMapSlamNode.
noise_for_update``, ``SimulatorNode.landmark_noise``).  Gates, those of
``tests/test_torch_world.py``: the ground-truth pose after every frame
within 1e-5 m; grid SLAM's published pose per update within 1e-4 m and
the final maps' flip fraction (|log-odds diff| > 0.01) below 1e-3; the
ICP mapper's published pose within 1e-4 m; the EKF's within 1e-3 m (the
reference's own EKF gate: the filter is chaotic in float32).  The
Controls messages are equal.  Also: the YAML loader refusing an unknown
tag and an unknown field of each of the 13 tags as the JAX package
does, the robot-I/O presets building as many nodes as the JAX package's
(no live connection is opened), ``apply_config``, no CPU fallback, and
the ``run`` CLI on the CPU.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from slamrs_tpu.graph.app import App as JApp  # noqa: E402
from slamrs_tpu.graph.config import parse_config as jparse  # noqa: E402
from slamrs_tpu.graph.config import NODE_REGISTRY as JREG  # noqa: E402
from slamrs_tpu.graph.nodes import sim as jsim  # noqa: E402
from slamrs_tpu.graph.nodes import slam as jslam  # noqa: E402
from slamrs_tpu.graph.nodes.viz import VisualizerNode as JViz  # noqa: E402
from slamrs_tpu_torch import convert  # noqa: E402
from slamrs_tpu_torch.__main__ import main as cli_main  # noqa: E402
from slamrs_tpu_torch.graph.app import App  # noqa: E402
from slamrs_tpu_torch.graph.config import NODE_REGISTRY  # noqa: E402
from slamrs_tpu_torch.graph.config import parse_config  # noqa: E402
from slamrs_tpu_torch.graph.nodes import sim as tsim  # noqa: E402
from slamrs_tpu_torch.graph.nodes import slam as tslam  # noqa: E402
from slamrs_tpu_torch.graph.nodes.viz import VisualizerNode  # noqa: E402
from slamrs_tpu_torch.models.gridslam import UpdateNoise  # noqa: E402
from torch_compare import (flip_fraction, node_grid_noise,  # noqa: E402
                           node_landmark_noise)

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = ROOT / "configs"


def _yaml(name: str, particles: int | None = None) -> str:
    text = (CONFIGS / f"{name}.yaml").read_text()
    if particles is not None:
        text = text.replace("n_particles: 1024", f"n_particles: {particles}")
    return text


def _floats(msgs) -> list:
    return [(float(m.speed_left), float(m.speed_right)) for m in msgs]


def _run_pair(text: str, frames: int, pose_topic: str, slam_cls,
              command_topic: str = "robot/command", before_frame=None):
    """Both Apps on ``text`` for ``frames`` frames, the JAX nodes' draws
    injected into the port's; ``before_frame(jnode, tnode)`` runs before
    each frame.  Returns the two apps and the published SLAM poses of
    each side, after checking the ground truth and the commands."""
    japp = JApp.from_yaml(text)
    tapp = App.from_yaml(text, device="cpu")
    jnode, tnode = japp.node(slam_cls[0]), tapp.node(slam_cls[1])
    if isinstance(tnode, tslam.GridMapSlamNode):
        draws = node_grid_noise(jnode.cfg.seed,
                                jnode.slam_cfg.n_particles, frames)
        tnode.noise_for_update = lambda i: UpdateNoise(
            *(torch.from_numpy(x) for x in draws[i]))
    jsimn, tsimn = japp.node(jsim.SimulatorNode), tapp.node(tsim.SimulatorNode)
    lanes = int(jsimn.scene.landmarks.shape[0])
    lm = node_landmark_noise(jsimn.config.seed, lanes, frames + 2)
    tsimn.landmark_noise = lambda i: tuple(torch.from_numpy(x) for x in lm[i])
    jsub = japp.pubsub.subscribe(pose_topic)
    tsub = tapp.pubsub.subscribe(pose_topic)
    jcmd = japp.pubsub.subscribe(command_topic)
    tcmd = tapp.pubsub.subscribe(command_topic)
    truth_j, truth_t = [], []
    for _ in range(frames):
        if before_frame is not None:
            before_frame(jnode, tnode)
        japp.frame()
        tapp.frame()
        truth_j.append(np.asarray(jsimn.get_pose()))
        truth_t.append(tsimn.get_pose())
    np.testing.assert_allclose(np.array(truth_t), np.array(truth_j),
                               atol=1e-5, rtol=0)
    assert tsimn.ticks == frames
    assert _floats(tcmd.drain()) == _floats(jcmd.drain())
    jposes = np.array([m.pose for m in jsub.drain()])
    tposes = np.array([m.pose for m in tsub.drain()])
    assert len(tposes) == len(jposes) > 0
    return japp, tapp, jposes, tposes


@pytest.mark.parametrize("name,particles,frames", [
    ("grid_slam", None, 75),  # dda, 10 particles at 0.02 m: 2 updates
    ("grid_slam_fused", 16, 45),  # K1's plain version: 7 updates
])
def test_grid_slam_app_matches_jax(name, particles, frames):
    japp, tapp, jposes, tposes = _run_pair(
        _yaml(name, particles), frames, "robot/pose",
        (jslam.GridMapSlamNode, tslam.GridMapSlamNode))
    np.testing.assert_allclose(tposes, jposes, atol=1e-4, rtol=0)
    jnode = japp.node(jslam.GridMapSlamNode)
    tnode = tapp.node(tslam.GridMapSlamNode)
    assert tnode.updates == jnode._updates == len(tposes)
    assert flip_fraction(tnode.state.grids.float().numpy(),
                         np.asarray(jnode.state.grids, np.float32)) < 1e-3
    np.testing.assert_array_equal(tnode.state.ancestors.numpy(),
                                  np.asarray(jnode.state.ancestors))
    jm = japp.node(JViz).latest("slam/map")
    tm = tapp.node(VisualizerNode).latest("slam/map")
    assert tm.data.shape == jm.data.shape == (
        tnode.slam_cfg.grid_spec.rows, tnode.slam_cfg.grid_spec.cols)
    np.testing.assert_array_equal(tm.position, jm.position)
    assert tm.resolution == jm.resolution
    assert flip_fraction(tm.data, jm.data, tol=1e-3) < 1e-3  # probability


def test_icp_app_matches_jax():
    _, tapp, jposes, tposes = _run_pair(
        _yaml("icp_test"), 90, "robot/pose",
        (jslam.IcpPointMapperNode, tslam.IcpPointMapperNode))
    np.testing.assert_allclose(tposes, jposes, atol=1e-4, rtol=0)
    node = tapp.node(tslam.IcpPointMapperNode)
    pm = tapp.node(VisualizerNode).latest("slam/map")
    assert pm.points.shape == (int(node.state.count), 2)


def _carry_ekf_state(jnode, tnode):
    """The JAX node's EKF state into the port's node."""
    tnode.state = convert.ekf_state_from_numpy(
        *(np.asarray(x) for x in jnode.state), "cpu")


def test_landmarks_app_matches_jax():
    """Free run: within the reference's free-running EKF gate of 2e-3 m a
    frame (``tests/test_torch_ekf.py``) and 1e-3 m RMSE.  The float32
    filter is chaotic: the first sighting cancels a 1,000 prior, and the
    port's EKF fed the JAX App's own observations drifts the same
    ~1.1e-3 m from it over these 14 updates (measured on the CPU).
    Lockstep (the JAX node's state carried into the port's node before
    every frame): each update within 1e-5 m."""
    japp, tapp, jposes, tposes = _run_pair(
        _yaml("landmarks"), 90, "slam/pose",
        (jslam.EKFLandmarkSlamNode, tslam.EKFLandmarkSlamNode))
    np.testing.assert_allclose(tposes, jposes, atol=2e-3, rtol=0)
    assert np.sqrt(((tposes - jposes)[:, :2] ** 2).mean()) <= 1e-3
    jn = japp.node(jslam.EKFLandmarkSlamNode)
    tn = tapp.node(tslam.EKFLandmarkSlamNode)
    np.testing.assert_array_equal(tn.state.seen.numpy(),
                                  np.asarray(jn.state.seen))
    _, _, jposes, tposes = _run_pair(
        _yaml("landmarks"), 90, "slam/pose",
        (jslam.EKFLandmarkSlamNode, tslam.EKFLandmarkSlamNode),
        before_frame=_carry_ekf_state)
    np.testing.assert_allclose(tposes, jposes, atol=1e-5, rtol=0)


def test_registry_has_the_jax_tags():
    assert set(NODE_REGISTRY) == set(JREG) and len(NODE_REGISTRY) == 13
    for tag, cls in NODE_REGISTRY.items():
        assert [f.name for f in dataclasses.fields(cls)] == \
            [f.name for f in dataclasses.fields(JREG[tag])], tag


def _raises_alike(text: str):
    with pytest.raises(ValueError) as jerr:
        jparse(text)
    with pytest.raises(ValueError) as terr:
        parse_config(text)
    assert str(terr.value) == str(jerr.value)
    return str(terr.value)


def test_unknown_tag_raises_as_in_jax():
    assert _raises_alike("nodes:\n- !Foo {a: 1}") == "unknown node type !Foo"


@pytest.mark.parametrize("tag", sorted(JREG))
def test_unknown_field_raises_as_in_jax(tag):
    msg = _raises_alike(f"nodes:\n- !{tag} {{topicz: []}}")
    assert msg == f"!{tag}: unknown fields ['topicz']"


@pytest.mark.parametrize("name", ["neato", "neato_grid_slam",
                                  "neato_replay"])
def test_robot_io_presets_instantiate(name):
    cfg = parse_config(_yaml(name))  # the fields parse and are checked
    japp = JApp(jparse(_yaml(name)))
    app = App(cfg, device="cpu")
    assert len(app.nodes) == len(cfg.nodes) == len(japp.nodes)
    assert [type(n).__name__ for n in app.nodes] == \
        [type(n).__name__ for n in japp.nodes]
    from slamrs_tpu_torch.graph.nodes.robot import RobotConnectionNode

    link = app.node(RobotConnectionNode)
    assert link is None or link.state == "idle"  # connect() is explicit
    app.run(frames=2)
    app.terminate()


def test_apply_config_and_presets():
    from slamrs_tpu_torch.graph.nodes.util import ControlsNode

    app = App.from_yaml("nodes:\n- !MousePosition\n", device="cpu")
    assert app.node(ControlsNode) is None
    app.apply_config("nodes:\n- !Controls {topic_command: c}\n")
    assert app.node(ControlsNode) is not None and app.time == 0.0
    assert App.presets() == JApp.presets()


def test_no_cpu_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        App.from_yaml("nodes:\n- !MousePosition\n")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        App.from_file(str(CONFIGS / "grid_slam.yaml"), device="cuda")
    with pytest.raises(SystemExit, match="CUDA is not available"):
        cli_main(["run", str(CONFIGS / "grid_slam.yaml")])


def test_controls_teleop_publishes_from_update():
    """``set_command`` (the keyboard thread's entry) is published by the
    next update and suspends the script for good."""
    app = App.from_yaml("nodes:\n- !Controls\n  topic_command: c\n"
                        "  script: [[0.5, 0.1, 0.1], [999.0, 0.2, 0.2]]\n",
                        device="cpu")
    from slamrs_tpu_torch.graph.nodes.util import ControlsNode

    sub = app.pubsub.subscribe("c")
    app.run(frames=3)
    controls = app.node(ControlsNode)
    controls.set_command(0.3, -0.3)
    assert len(sub) == 1  # nothing is published off the frame thread
    app.run(frames=30)
    assert _floats(sub.drain()) == [
        (float(np.float32(0.1)),) * 2, (float(np.float32(0.3)),
                                       float(np.float32(-0.3)))]


def test_cli_run_on_cpu(tmp_path, capsys):
    npz = tmp_path / "out.npz"
    png = tmp_path / "out.png"
    cli_main(["run", str(CONFIGS / "grid_slam.yaml"), "--duration", "1.2",
              "--device", "cpu", "--npz", str(npz), "--png", str(png)])
    out = capsys.readouterr().out
    assert "ran 1.2s of sim time" in out
    with np.load(npz) as data:
        assert data["slam_map_grid"].shape == (200, 200)
        assert data["robot_pose_pose"].shape == (3,)
    assert png.stat().st_size > 1000


def test_cli_rollout_still_prints_one_report(capsys):
    cli_main(["rollout", str(CONFIGS / "landmarks.yaml"), "--steps", "14",
              "--device", "cpu"])
    report = json.loads(capsys.readouterr().out)
    assert report["scans"] == 2 and np.isfinite(report["ekf_pose_rmse_xy"])
