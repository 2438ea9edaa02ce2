"""The port's robot nodes (``!FileLoader``, ``!RobotConnection``) and its
``replay`` and ``robot`` subcommands against the JAX package's, on the CPU.

The recordings are made by the JAX package's virtual robot in
``cmd_robot``'s 4 x 4 m scene: it starts at (-1.0, -1.2, 0), is sent
``NeatoOn``, ``SetDownsampling{0}`` and ``Drive(0.10, 0.12)`` and is
stepped at 0.05 s.  Gates:

* replay: ``configs/neato_replay.yaml`` with ``path`` set, in the JAX App
  and the port's App: the same frame count (one fewer than the
  revolutions written: the unclosed last one is dropped), ICP poses
  within 1e-4 m an update (the App ICP gate of ``test_torch_app.py``),
  and within 0.01 m RMSE of the robot's true pose in the first scan's
  frame; the ``replay`` JSON equal to the JAX package's;
* live link: ``configs/neato_grid_slam.yaml`` at full size (dda, 10
  particles, 8 x 8 m at 0.02 m) fed the same ``ScanFrame`` bytes through
  the nodes' ``_on_scan``, with no socket, so the run is deterministic;
  the grid node's draws are the JAX node's key chain
  (``tests/torch_compare.py``); grid poses within 1e-4 m an update;
* the nodes: the FileLoader's Scan equal to the JAX node's arrays, its
  autoplay, ``frame_index`` and ``done``; the RobotConnection's bytes on
  the wire (handshake, live PI gains, Neato on and off, drive) equal to
  the JAX node's; its return to idle on a dead stream; ``connect()``
  over TCP to the port's ``robot`` subcommand in its own process.

Every socket test has a deadline of at most 10 s and closes its threads,
descriptors and processes in ``finally``.
"""

from __future__ import annotations

import os
import signal
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from slamrs_tpu.__main__ import main as jcli  # noqa: E402
from slamrs_tpu.graph.app import App as JApp  # noqa: E402
from slamrs_tpu.graph.nodes import robot as jrobot  # noqa: E402
from slamrs_tpu.graph.nodes import slam as jslam  # noqa: E402
from slamrs_tpu.graph.pubsub import PubSub as JPubSub  # noqa: E402
from slamrs_tpu.io import connection as jconn  # noqa: E402
from slamrs_tpu.io import message as jmsg  # noqa: E402
from slamrs_tpu.io import virtual_robot as jvr  # noqa: E402
from slamrs_tpu.models import simulator as jsim  # noqa: E402
from slamrs_tpu_torch.__main__ import main as tcli  # noqa: E402
from slamrs_tpu_torch.core.types import Command  # noqa: E402
from slamrs_tpu_torch.graph.app import App  # noqa: E402
from slamrs_tpu_torch.graph.node import ScanOdometry  # noqa: E402
from slamrs_tpu_torch.graph.nodes import robot as trobot  # noqa: E402
from slamrs_tpu_torch.graph.nodes import slam as tslam  # noqa: E402
from slamrs_tpu_torch.graph.pubsub import PubSub  # noqa: E402
from slamrs_tpu_torch.io import connection as tconn  # noqa: E402
from slamrs_tpu_torch.io import message as tmsg  # noqa: E402
from slamrs_tpu_torch.models.gridslam import UpdateNoise  # noqa: E402
from torch_compare import node_grid_noise  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = ROOT / "configs"
ROBOT_RECTS = [(-2.0, -2.0, 4.0, 4.0), (-0.1, -0.4, 0.5, 0.1)]
ROBOT_LINES = [(-0.6, -0.4, 0.2, 0.4)]
DEADLINE_S = 10.0


def _wait(cond, deadline_s=DEADLINE_S) -> bool:
    end = time.monotonic() + deadline_s
    while not cond() and time.monotonic() < end:
        time.sleep(0.01)
    return cond()


def _record(seconds: float):
    """The JAX virtual robot's ScanFrames over ``seconds`` of virtual time
    and its true pose at each."""
    robot = jvr.VirtualRobot(scene=jsim.Scene.build(rects=ROBOT_RECTS,
                                                    lines=ROBOT_LINES),
                             scanner_range=5.0)
    robot.pose = np.array([-1.0, -1.2, 0.0])
    robot.connect()
    for m in (jmsg.CommandMessage.neato_on(),
              jmsg.CommandMessage.set_downsampling(0),
              jmsg.CommandMessage.drive(0.10, 0.12)):
        robot.handle_command(m)
    truth = []
    rev = robot._lidar_rev

    def rev_with_truth():
        n = len(robot.outbox)
        rev()
        if len(robot.outbox) > n:
            truth.append(robot.pose.copy())

    robot._lidar_rev = rev_with_truth
    for _ in range(int(round(seconds / 0.05))):
        robot.step(0.05)
    frames = [jmsg.RobotMessage.decode(raw)[0].scan_frame
              for raw in robot.outbox if raw[:1] == b"\x00"]
    assert len(frames) == len(truth)
    return frames, np.array(truth)


@pytest.fixture(scope="module")
def replay_log(tmp_path_factory):
    """A 26-revolution log (25 frames replay) and the true poses."""
    frames, truth = _record(5.25)
    path = tmp_path_factory.mktemp("log") / "robot.bin"
    path.write_bytes(b"".join(f.scan_data for f in frames))
    return path, truth


def _replay_yaml(path) -> str:
    text = (CONFIGS / "neato_replay.yaml").read_text()
    assert "path: null" in text
    return text.replace("path: null", f"path: {path}")


def _replay(app, loader_cls, icp_cls):
    """Frames until the loader is done and its last scan is mapped."""
    poses = app.pubsub.subscribe("robot/pose")
    loader, icp = app.node(loader_cls), app.node(icp_cls)
    frames = 0
    while not loader.done:
        app.frame()
        frames += 1
    app.run(frames=2)
    updates = icp.updates if hasattr(icp, "updates") else None
    return np.array([m.pose for m in poses.drain()]), updates, frames


def _in_first_frame(truth):
    """Poses relative to the first, in its frame."""
    x0, y0, t0 = truth[0]
    c, s = np.cos(-t0), np.sin(-t0)
    dx, dy = truth[:, 0] - x0, truth[:, 1] - y0
    return np.stack([c * dx - s * dy, s * dx + c * dy], axis=1)


def test_replay_app_matches_jax(replay_log):
    path, truth = replay_log
    text = _replay_yaml(path)
    jposes, _, jframes = _replay(JApp.from_yaml(text), jrobot.FileLoaderNode,
                                 jslam.IcpPointMapperNode)
    tposes, updates, tframes = _replay(App.from_yaml(text, device="cpu"),
                                       trobot.FileLoaderNode,
                                       tslam.IcpPointMapperNode)
    assert len(truth) == 26 and tframes == jframes
    assert len(tposes) == len(jposes) == updates == len(truth) - 1
    np.testing.assert_allclose(tposes, jposes, atol=1e-4, rtol=0)
    err = tposes[:, :2] - _in_first_frame(truth[:len(tposes)])
    assert np.sqrt((err ** 2).mean()) <= 0.01


def test_replay_cli_prints_the_jax_line(replay_log, capsys):
    path, _ = replay_log
    jcli(["replay", str(path)])
    want = capsys.readouterr().out
    tcli(["replay", str(path)])
    got = capsys.readouterr().out
    assert got == want == '{"frames": 25, "valid_beams_median": 360}\n'
    empty = path.parent / "empty.bin"
    empty.write_bytes(b"\x00garbage")
    jcli(["replay", str(empty)])
    want = capsys.readouterr().out
    tcli(["replay", str(empty)])
    assert capsys.readouterr().out == want == (
        '{"frames": 0, "valid_beams_median": 0}\n')


def test_file_loader_publishes_the_jax_scan(replay_log):
    path, _ = replay_log
    yaml = (f"nodes:\n- !FileLoader\n  topic_observation: obs\n"
            f"  topic_pose: pose\n  path: {path}\n  autoplay: false\n")
    japp, tapp = JApp.from_yaml(yaml), App.from_yaml(yaml, device="cpu")
    jl, tl = japp.node(jrobot.FileLoaderNode), tapp.node(
        trobot.FileLoaderNode)
    jobs, tobs = japp.pubsub.subscribe("obs"), tapp.pubsub.subscribe("obs")
    tpose = tapp.pubsub.subscribe("pose")
    for index in (None, None, 7, 7, 24, 3):  # None: leave the index
        if index is not None:
            jl.frame_index = tl.frame_index = index
        japp.frame()
        tapp.frame()
    jmsgs, tmsgs = jobs.drain(), tobs.drain()
    assert len(tmsgs) == len(jmsgs) == 4  # frames 0, 7, 24, 3
    for j, t in zip(jmsgs, tmsgs):
        for name in ("angles", "distances", "strengths", "valid", "present"):
            a, b = np.asarray(getattr(j, name)), getattr(t, name).numpy()
            assert a.dtype == b.dtype and np.array_equal(a, b), name
    poses = tpose.drain()
    assert len(poses) == 4 and all((p.pose == 0).all() for p in poses)
    assert not tl.done and len(tl.frames) == 25
    tl.config.autoplay = True
    tapp.run(frames=30)
    assert tl.done and tl.frame_index == 24
    empty = App.from_yaml("nodes:\n- !FileLoader\n  topic_observation: o\n",
                          device="cpu")
    empty.run(frames=2)
    assert empty.node(trobot.FileLoaderNode).done


def test_live_link_grid_slam_matches_jax():
    """``neato_grid_slam.yaml`` at full size fed the same ScanFrames on
    both sides through ``_on_scan``: grid poses within 1e-4 m an update."""
    frames, _ = _record(2.0)
    text = (CONFIGS / "neato_grid_slam.yaml").read_text()
    japp, tapp = JApp.from_yaml(text), App.from_yaml(text, device="cpu")
    jn = japp.node(jrobot.RobotConnectionNode)
    tn = tapp.node(trobot.RobotConnectionNode)
    jg, tg = japp.node(jslam.GridMapSlamNode), tapp.node(
        tslam.GridMapSlamNode)
    assert tg.state.grids.shape == (10, 400, 400)
    assert tg.state.grids.dtype == torch.float32
    draws = node_grid_noise(jg.cfg.seed, jg.slam_cfg.n_particles,
                            len(frames))
    tg.noise_for_update = lambda i: UpdateNoise(
        *(torch.from_numpy(x) for x in draws[i]))
    jsub, tsub = (app.pubsub.subscribe("robot/pose") for app in (japp, tapp))
    tobs = tapp.pubsub.subscribe("robot/observation_odometry")
    for f in [*frames, None, None]:
        if f is not None:
            jn._on_scan(f.scan_data, f.odometry, f.rpm)
            tn._on_scan(f.scan_data, f.odometry, f.rpm)
        japp.frame()
        tapp.frame()
    jposes = np.array([m.pose for m in jsub.drain()])
    tposes = np.array([m.pose for m in tsub.drain()])
    assert len(tposes) == len(jposes) == len(frames) == tg.updates == 10
    np.testing.assert_allclose(tposes, jposes, atol=1e-4, rtol=0)
    assert np.abs(tposes[-1, :2]).max() > 0.05  # the robot moved
    msgs = tobs.drain()
    assert len(msgs) == 10
    odo = msgs[0].odometry
    assert [float(v) for v in odo] == [
        float(np.float32(v)) for v in (*frames[0].odometry, 0.2)]


class CaptureMedium(tconn.ConnectionMedium):
    """Records writes; reads nothing (or ends the stream)."""

    def __init__(self):
        self.writes = []
        self.eof = False
        self._lock = threading.Lock()

    def read(self, n):
        if self.eof:
            return None
        time.sleep(0.001)
        return b""

    def write(self, data):
        with self._lock:
            self.writes.append(bytes(data))


def test_connection_node_bytes_match_jax():
    """The handshake, live PI gains, the Neato toggle, a drive command
    and the shutdown bytes equal the JAX node's; the node needs a link
    for the live calls and returns to idle when the stream ends."""
    out = []
    for side in ("jax", "port"):
        medium = CaptureMedium()
        if side == "jax":
            ps = JPubSub()
            node = jrobot.RobotConnectionNodeConfig(
                topic_observation="scan", topic_command="cmd",
                downsampling=3).instantiate(ps)
            node._link = jconn.RobotLink(medium, node._on_scan, 3)
            import jax.numpy as jnp

            from slamrs_tpu.core.types import Command as JCommand
            cmd = JCommand(jnp.float32(0.1), jnp.float32(-0.05))
        else:
            ps = PubSub()
            node = trobot.RobotConnectionNodeConfig(
                topic_observation="scan", topic_command="cmd",
                downsampling=3).instantiate(ps, "cpu")
            with pytest.raises(RuntimeError, match="not connected"):
                node.set_motor_pi_params(1.0, 1.0)
            with pytest.raises(RuntimeError, match="not connected"):
                node.set_neato(True)
            assert node.state == "idle"
            node._link = tconn.RobotLink(medium, node._on_scan, 3)
            cmd = Command.make(0.1, -0.05, device="cpu")
        try:
            assert node.state == "running"
            node.set_motor_pi_params(kp=0.75, ki=1.5)
            node.set_neato(False)
            node.set_neato(True)
            ps.publish("cmd", type(cmd)).publish(cmd)
            ps.tick()
            node.update()
            medium.eof = True  # the robot hangs up
            assert _wait(lambda: not node._link.alive)
            node.update()
            assert node.state == "idle"
        finally:
            node.terminate()
        out.append(medium.writes)
    assert out[1] == out[0] and len(out[1]) == 8
    assert out[1][5] == tmsg.CommandMessage.drive(0.1, -0.05).encode()


@pytest.fixture
def robot_process():
    """``python -m slamrs_tpu_torch robot --device cpu`` on a free port;
    stopped with SIGINT (ctrl-C) and reaped."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "slamrs_tpu_torch", "robot", "--host",
         "127.0.0.1", "--port", str(port), "--device", "cpu"],
        cwd=ROOT, env=env, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stderr.readline()  # blocks until it listens (or dies)
        assert "listening" in line, line
        yield proc, port
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(timeout=DEADLINE_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        proc.stderr.close()


def test_connect_to_the_robot_subcommand(robot_process):
    """``connect()`` over TCP to the ``robot`` subcommand: ScanOdometry
    on the node's device, a drive command moves the robot, ``terminate``
    returns and the process ends at ctrl-C."""
    proc, port = robot_process
    yaml = ("nodes:\n- !RobotConnection\n  topic_observation: obs\n"
            "  topic_command: cmd\n  host: 127.0.0.1\n"
            f"  port: {port}\n  downsampling: 0\n")
    app = App.from_yaml(yaml, device="cpu")
    node = app.node(trobot.RobotConnectionNode)
    obs = app.pubsub.subscribe("obs")
    cmd = app.pubsub.publish("cmd", Command)
    got = []
    try:
        assert node.state == "idle"
        node.connect()
        assert node.state == "running"
        cmd.publish(Command.make(0.2, 0.2, device="cpu"))

        def frames():
            app.frame()
            got.extend(obs.drain())
            return len(got) >= 6

        assert _wait(frames)
    finally:
        node.terminate()
    assert node.state == "idle"
    msg = got[-1]
    assert isinstance(msg, ScanOdometry)
    assert msg.scan.distances.shape == (360,)
    assert msg.scan.valid.sum() > 300
    assert sum(float(m.odometry.distance_left) for m in got) > 0.0
    assert proc.poll() is None  # the robot serves on after a host leaves


def test_robot_cli_needs_cuda_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA is not available"):
        tcli(["robot", "--port", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        App.from_file(str(CONFIGS / "neato_replay.yaml"))


def test_bench_is_not_a_port_subcommand(capsys):
    with pytest.raises(SystemExit):
        tcli(["bench"])
    assert "invalid choice" in capsys.readouterr().err
    tcli_help = subprocess.run(
        [sys.executable, "-m", "slamrs_tpu_torch", "--help"], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT)), capture_output=True,
        text=True, timeout=60).stdout
    assert "the port's benchmark is python3 -m h100bench.run" in " ".join(
        tcli_help.split())


def test_robot_process_exits_0_at_sigint_after_links_close():
    """``python -m slamrs_tpu_torch robot --device cpu``: two hosts connect
    (the lidar on), take a few frames and close; at SIGINT the process
    ends with exit code 0 within its own 20 s limit."""
    from torch_robot_process import connect_close_sigint

    code, lines = connect_close_sigint("cpu", cycles=2)
    assert code == 0, lines
    assert sum("host disconnected" in line for line in lines) == 2
