"""The App's node programs (``graph/capture.Program`` in the nodes of
``slamrs_tpu_torch/graph/nodes/``) on the CPU.

On the CPU the programs run uncaptured (``App.use_programs(graphs=
False)``): the code a CUDA graph captures, on the same static state and
input buffers, with the same copy-back and the same copies of what
leaves a program.  Each preset's App must equal the op-by-op App
bitwise (every published message, the simulator's and the SLAM node's
final states) under the seed and under injected draws, and the
programmed App must match the JAX App at ``tests/test_torch_app.py``'s
gates under the JAX draws (``tests/torch_compare.py``): ground truth
1e-5 m; grid SLAM's pose 1e-4 m with map flip fractions below 1e-3; ICP
1e-4 m; the free-running EKF 2e-3 m a frame and 1e-3 m RMSE, in lockstep
1e-5 m (the JAX state set into the node before every frame, which the
program loads).  The same for ``configs/neato_replay.yaml`` over the
port's virtual robot's log.  Also: ``set_parameters`` changes the next
tick on the program path, two firing ticks in one frame publish two
scans of their own, ``App(capture=True)`` raises on the CPU, and a
program refuses an input whose shape changed.

The captured graphs against the op-by-op App run on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``'s ``app_capture_*``).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from slamrs_tpu.graph.app import App as JApp  # noqa: E402
from slamrs_tpu.graph.nodes import robot as jrobot  # noqa: E402
from slamrs_tpu.graph.nodes import sim as jsim  # noqa: E402
from slamrs_tpu.graph.nodes import slam as jslam  # noqa: E402
from slamrs_tpu.models import gridslam as jgs  # noqa: E402
from slamrs_tpu_torch import convert  # noqa: E402
from slamrs_tpu_torch.core.types import Command  # noqa: E402
from slamrs_tpu_torch.graph import capture  # noqa: E402
from slamrs_tpu_torch.graph.app import App  # noqa: E402
from slamrs_tpu_torch.graph.nodes import robot as trobot  # noqa: E402
from slamrs_tpu_torch.graph.nodes import sim as tsim  # noqa: E402
from slamrs_tpu_torch.graph.nodes import slam as tslam  # noqa: E402
from slamrs_tpu_torch.graph.nodes.sim import SimulatorNodeConfig  # noqa
from slamrs_tpu_torch.graph.pubsub import PubSub  # noqa: E402
from slamrs_tpu_torch.models.gridslam import UpdateNoise  # noqa: E402
from torch_compare import (flip_fraction, node_grid_noise,  # noqa: E402
                           node_landmark_noise)

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = ROOT / "configs"

# preset: (particles, frames, (JAX node, port node), pose topic), at
# tests/test_torch_app.py's sizes
PRESETS = {
    "grid_slam": (None, 75, (jslam.GridMapSlamNode, tslam.GridMapSlamNode),
                  "robot/pose"),
    "grid_slam_fused": (16, 45, (jslam.GridMapSlamNode,
                                 tslam.GridMapSlamNode), "robot/pose"),
    "icp_test": (None, 90, (jslam.IcpPointMapperNode,
                            tslam.IcpPointMapperNode), "robot/pose"),
    "landmarks": (None, 90, (jslam.EKFLandmarkSlamNode,
                             tslam.EKFLandmarkSlamNode), "slam/pose"),
}
# the topics whose every message is compared: the SLAM node's and the
# simulator's observations (copies out of the firing tick's program)
TOPICS = ("slam/map", "robot/observation_odometry", "robot/observation")


def _yaml(name: str, particles=None) -> str:
    text = (CONFIGS / f"{name}.yaml").read_text()
    if particles is not None:
        text = text.replace("n_particles: 1024", f"n_particles: {particles}")
    return text


def _values(msg) -> list:
    """Every array a message carries, as numpy."""
    if dataclasses.is_dataclass(msg):
        msg = tuple(getattr(msg, f.name) for f in dataclasses.fields(msg))
    if isinstance(msg, tuple):
        return [v for x in msg for v in _values(x)]
    if isinstance(msg, torch.Tensor):
        return [msg.numpy()]
    if isinstance(msg, (bool, int, float)):
        return [np.asarray(msg)]
    return [np.asarray(getattr(msg, a)) for a in
            ("pose", "position", "data", "points", "means", "covariances",
             "seen") if hasattr(type(msg), a)]


def _inject(app, frames: int) -> None:
    """The JAX nodes' draws into the port's seams: the grid node's updates
    and the simulator's landmark sensor."""
    grid = app.node(tslam.GridMapSlamNode)
    if grid is not None:
        draws = node_grid_noise(grid.cfg.seed, grid.slam_cfg.n_particles,
                                frames)
        grid.noise_for_update = lambda i: UpdateNoise(
            *(torch.from_numpy(x) for x in draws[i]))
    sim = app.node(tsim.SimulatorNode)
    if sim is not None:
        lanes = int(sim.scene.landmarks.shape[0])
        lm = node_landmark_noise(sim.config.seed, lanes, frames + 2)
        sim.landmark_noise = lambda i: tuple(torch.from_numpy(x)
                                             for x in lm[i])


def _run(text: str, frames, pose_topic: str, programs: bool,
         injected: bool):
    """The port's App on ``text`` for ``frames`` frames (``None`` runs
    until a replay's loader is done, and two more).  Returns the App,
    the published poses, every message of ``TOPICS`` as arrays, and the
    ground truth after each frame."""
    app = App.from_yaml(text, device="cpu")
    assert all(n.program is None for n in app.nodes)  # op by op by default
    if programs:
        app.use_programs(graphs=False)
    if injected:
        _inject(app, frames or 100)
    poses = app.pubsub.subscribe(pose_topic)
    subs = {t: app.pubsub.subscribe(t) for t in TOPICS}
    sim = app.node(tsim.SimulatorNode)
    loader = app.node(trobot.FileLoaderNode)
    truth = []
    n = 0
    while (n < frames) if frames else not loader.done:
        app.frame()
        n += 1
        if sim is not None:
            truth.append(sim.get_pose())
    if loader is not None:
        app.run(frames=2)
    msgs = {t: [_values(m) for m in s.drain()] for t, s in subs.items()}
    return (app, np.array([m.pose for m in poses.drain()]), msgs,
            np.array(truth))


def _assert_same(a, b) -> None:
    """Two runs of ``_run``: the same bits everywhere."""
    (app_a, poses_a, msgs_a, truth_a), (app_b, poses_b, msgs_b, truth_b) = \
        a, b
    np.testing.assert_array_equal(poses_a, poses_b)
    np.testing.assert_array_equal(truth_a, truth_b)
    for topic in TOPICS:
        assert len(msgs_a[topic]) == len(msgs_b[topic]), topic
        for x, y in zip(msgs_a[topic], msgs_b[topic]):
            assert len(x) == len(y)
            for u, v in zip(x, y):
                assert u.dtype == v.dtype
                np.testing.assert_array_equal(u, v)
    for na, nb in zip(app_a.nodes, app_b.nodes):
        state_a, state_b = getattr(na, "state", None), getattr(nb, "state",
                                                               None)
        if isinstance(state_a, tuple):
            la = capture._tensor_leaves(state_a)
            lb = capture._tensor_leaves(state_b)
            assert len(la) == len(lb) > 0
            for x, y in zip(la, lb):
                assert x.dtype == y.dtype and torch.equal(x, y)


def _program_calls(app) -> dict:
    """Each node's program calls, by class: every tick, update and
    published map."""
    calls = {}
    for n in app.nodes:
        if isinstance(n, tsim.SimulatorNode):
            calls["SimulatorNode"] = n.ticks
        elif isinstance(n, tslam.GridMapSlamNode):
            calls["GridMapSlamNode"] = n.updates + \
                n.updates // n.cfg.publish_map_every
        elif hasattr(n, "updates"):
            calls[type(n).__name__] = n.updates
    return calls


@pytest.mark.parametrize("draws", ["seed", "injected"])
@pytest.mark.parametrize("name", list(PRESETS))
def test_programs_equal_the_op_by_op_app(name, draws):
    particles, frames, (_, cls), topic = PRESETS[name]
    text = _yaml(name, particles)
    injected = draws == "injected"
    eager = _run(text, frames, topic, False, injected)
    programmed = _run(text, frames, topic, True, injected)
    _assert_same(eager, programmed)
    app = programmed[0]
    stats = app.program_stats()
    calls = _program_calls(app)
    assert set(stats) == set(calls)
    for node, s in stats.items():  # uncaptured: every call eager
        assert s.eager == calls[node] > 0 and s.graphs == s.replays == 0
    assert app.node(cls).updates >= 2


def _matches_jax(name: str, carry=None):
    """The programmed App under the JAX draws beside the JAX App, frame by
    frame (``carry(jnode, tnode)`` before each frame), the ground truth
    checked.  Returns both apps and their published poses."""
    particles, frames, (jcls, tcls), topic = PRESETS[name]
    text = _yaml(name, particles)
    japp = JApp.from_yaml(text)
    tapp = App.from_yaml(text, device="cpu")
    tapp.use_programs(graphs=False)
    _inject(tapp, frames)
    jsub, tsub = japp.pubsub.subscribe(topic), tapp.pubsub.subscribe(topic)
    jsimn, tsimn = japp.node(jsim.SimulatorNode), tapp.node(tsim.SimulatorNode)
    truth_j, truth_t = [], []
    for _ in range(frames):
        if carry is not None:
            carry(japp.node(jcls), tapp.node(tcls))
        japp.frame()
        tapp.frame()
        truth_j.append(np.asarray(jsimn.get_pose()))
        truth_t.append(tsimn.get_pose())
    np.testing.assert_allclose(np.array(truth_t), np.array(truth_j),
                               atol=1e-5, rtol=0)
    jposes = np.array([m.pose for m in jsub.drain()])
    tposes = np.array([m.pose for m in tsub.drain()])
    assert len(tposes) == len(jposes) > 0
    return japp, tapp, jposes, tposes


@pytest.mark.parametrize("name", ["grid_slam", "grid_slam_fused"])
def test_grid_programs_match_jax(name):
    japp, tapp, jposes, tposes = _matches_jax(name)
    np.testing.assert_allclose(tposes, jposes, atol=1e-4, rtol=0)
    jnode = japp.node(jslam.GridMapSlamNode)
    tnode = tapp.node(tslam.GridMapSlamNode)
    assert tnode.updates == jnode._updates == len(tposes)
    assert flip_fraction(tnode.state.grids.float().numpy(),
                         np.asarray(jnode.state.grids, np.float32)) < 1e-3
    np.testing.assert_array_equal(tnode.state.ancestors.numpy(),
                                  np.asarray(jnode.state.ancestors))
    prob = tnode.probability_map().numpy()
    jprob = np.asarray(jgs.estimated_probability_grid(jnode.state,
                                                      jnode.slam_cfg))
    assert prob.shape == jprob.shape
    assert flip_fraction(prob, jprob, tol=1e-3) < 1e-3


def test_icp_program_matches_jax():
    _, tapp, jposes, tposes = _matches_jax("icp_test")
    np.testing.assert_allclose(tposes, jposes, atol=1e-4, rtol=0)


def _carry_ekf_state(jnode, tnode):
    tnode.state = convert.ekf_state_from_numpy(
        *(np.asarray(x) for x in jnode.state), "cpu")


def test_ekf_program_matches_jax():
    """Free run at the reference's free-running gate; in lockstep (the
    JAX node's state set into the port's node before every frame, which
    the program copies into its static state) within 1e-5 m."""
    japp, tapp, jposes, tposes = _matches_jax("landmarks")
    np.testing.assert_allclose(tposes, jposes, atol=2e-3, rtol=0)
    assert np.sqrt(((tposes - jposes)[:, :2] ** 2).mean()) <= 1e-3
    np.testing.assert_array_equal(
        tapp.node(tslam.EKFLandmarkSlamNode).state.seen.numpy(),
        np.asarray(japp.node(jslam.EKFLandmarkSlamNode).state.seen))
    _, _, jposes, tposes = _matches_jax("landmarks", _carry_ekf_state)
    assert len(tposes) == len(jposes) > 0
    np.testing.assert_allclose(tposes, jposes, atol=1e-5, rtol=0)


ROBOT_RECTS = [(-2.0, -2.0, 4.0, 4.0), (-0.1, -0.4, 0.5, 0.1)]
ROBOT_LINES = [(-0.6, -0.4, 0.2, 0.4)]


@pytest.fixture(scope="module")
def replay_text(tmp_path_factory):
    """``neato_replay.yaml`` over a 16-revolution log of the port's
    virtual robot (15 frames replay)."""
    from slamrs_tpu_torch.io import message as msg
    from slamrs_tpu_torch.io.virtual_robot import VirtualRobot
    from slamrs_tpu_torch.models.simulator import Scene

    robot = VirtualRobot(scene=Scene.build(rects=ROBOT_RECTS,
                                           lines=ROBOT_LINES),
                         scanner_range=5.0, device="cpu")
    robot.pose = np.array([-1.0, -1.2, 0.0])
    robot.connect()
    for m in (msg.CommandMessage.neato_on(),
              msg.CommandMessage.set_downsampling(0),
              msg.CommandMessage.drive(0.10, 0.12)):
        robot.handle_command(m)
    for _ in range(int(round(3.25 / 0.05))):
        robot.step(0.05)
    frames = [msg.RobotMessage.decode(raw)[0].scan_frame
              for raw in robot.outbox if raw[:1] == b"\x00"]
    assert len(frames) == 16
    path = tmp_path_factory.mktemp("log") / "robot.bin"
    path.write_bytes(b"".join(f.scan_data for f in frames))
    text = (CONFIGS / "neato_replay.yaml").read_text()
    assert "path: null" in text
    return text.replace("path: null", f"path: {path}")


def test_replay_programs_equal_the_op_by_op_app_and_match_jax(replay_text):
    cls = tslam.IcpPointMapperNode
    eager = _run(replay_text, None, "robot/pose", False, False)
    programmed = _run(replay_text, None, "robot/pose", True, False)
    _assert_same(eager, programmed)
    app, tposes = programmed[0], programmed[1]
    node = app.node(cls)
    assert node.updates == len(tposes) == 15
    assert app.program_stats()["IcpPointMapperNode"].eager == 15
    japp = JApp.from_yaml(replay_text)
    jsub = japp.pubsub.subscribe("robot/pose")
    loader = japp.node(jrobot.FileLoaderNode)
    while not loader.done:
        japp.frame()
    japp.run(frames=2)
    jposes = np.array([m.pose for m in jsub.drain()])
    np.testing.assert_allclose(tposes, jposes, atol=1e-4, rtol=0)


def _sim(update_period, programs: bool):
    ps = PubSub()
    node = SimulatorNodeConfig(
        topic_command="cmd", topic_observation_scanner="scan",
        scene=[("Line", {"x1": -2.0, "y1": -2.0, "x2": 2.0, "y2": -2.0})],
        parameters={"update_period": update_period}).instantiate(ps, "cpu")
    if programs:
        node.use_programs(graphs=False)
    return node, ps


def test_set_parameters_take_effect_on_the_next_tick_through_programs():
    """``tests/test_torch_viz.py``'s test on the program path: the period
    (read by the host timer alone) and the scanner range (a constant of
    the firing tick's program) change the next tick."""
    node, ps = _sim(0.5, programs=True)
    sub = ps.subscribe("scan")
    node.advance(1.0)  # 30 ticks at a 0.5 s cadence
    slow = node.state.scan_counter
    assert 1 <= slow <= 3
    node.set_parameters(update_period=0.0)  # every tick fires from now
    node.advance(node.dt)
    assert node.state.scan_counter == slow + 1
    node.advance(1.0)
    assert node.state.scan_counter == slow + 31
    ps.tick()
    far = sub.drain()[-1].scan
    node.set_parameters(scanner_range=5.0)  # the wall 2 m away in range
    node.advance(node.dt)
    ps.tick()
    near = sub.latest().scan
    assert int(near.valid.sum()) > int(far.valid.sum()) == 0
    node.set_parameters(running=False)
    node.advance(1.0)
    assert node.state.scan_counter == slow + 32
    assert node.program.stats.eager == node.ticks > 60


def test_two_firing_ticks_in_one_frame_publish_two_scans():
    """Two ticks fire within one ``advance``: each message holds its own
    copy of its tick's scan and odometry, the same bits as op by op."""
    runs = []
    for programs in (False, True):
        node, ps = _sim(0.0, programs)
        sub = ps.subscribe("scan")
        ps.publish("cmd", Command).publish(Command.make(0.3, 0.2))
        ps.tick()
        node.advance(2 * node.dt + 1e-6)
        ps.tick()
        runs.append(sub.drain())
    for msgs in runs:
        assert len(msgs) == 2
        a, b = msgs
        assert a.scan.distances.data_ptr() != b.scan.distances.data_ptr()
        assert not torch.equal(a.scan.distances, b.scan.distances)
        assert float(b.odometry.distance_left) == float(
            a.odometry.distance_left)  # one tick's travel each
    for x, y in zip(*runs):
        for u, v in zip(_values(x), _values(y)):
            np.testing.assert_array_equal(u, v)


def test_capture_true_raises_on_the_cpu():
    text = _yaml("icp_test")
    with pytest.raises(ValueError, match="capture=True"):
        App.from_yaml(text, device="cpu", capture=True)
    for capture_ in (None, False):
        app = App.from_yaml(text, device="cpu", capture=capture_)
        assert all(n.program is None for n in app.nodes)
        assert app.program_stats() == {}


def test_program_refuses_a_changed_input_shape():
    node, ps = _sim(0.2, programs=True)
    node.advance(node.dt)
    program = node.program
    with pytest.raises(RuntimeError, match="changed from"):
        program.fill("cmd", Command(torch.zeros(2), torch.zeros(2)))
    with pytest.raises(ValueError, match="CUDA graphs need a CUDA device"):
        capture.Program(lambda key: None, "cpu", graphs=True)


def test_programs_free_with_their_owner():
    """No reference cycle holds a program: the App's node programs and a
    rollout's world program (kept on its world) go when their owner does, without the cyclic collector, which could
    otherwise run inside a later capture, where destroying a graph
    invalidates that capture."""
    import gc
    import weakref

    from slamrs_tpu_torch.graph.compile import compile_world
    from slamrs_tpu_torch.graph.config import load_config

    gc.collect()
    gc.disable()
    try:
        app = App.from_yaml(_yaml("icp_test"), device="cpu")
        app.use_programs(graphs=False)
        app.run(frames=14)
        refs = [weakref.ref(n.program) for n in app.nodes
                if n.program is not None]
        del app
        assert len(refs) == 2 and all(r() is None for r in refs)
        fw = compile_world(load_config(str(CONFIGS / "icp_test.yaml")),
                           device="cpu")
        state, _ = capture.run_program(fw, fw.init(), 20, graphs=False)
        capture.run_program(fw, state, 20, graphs=False)
        kept = weakref.ref(fw.frame_program)
        # 20 ticks end on idle ticks: the program holds their run's input
        assert any(isinstance(name[1], tuple) and name[1][0] == "idle"
                   for name in kept().inputs)
        del fw, state
        assert kept() is None
        assert not [o for o in gc.get_objects()
                    if isinstance(o, capture.FrameProgram)]
    finally:
        gc.enable()
