"""The port's host-graph plumbing against the JAX package's: pub/sub,
the shape renderer and the framebuffer, the visualizer node, spans, the
simulator node's live parameters, the teleop reader and the messages'
deferred host copies.

The renderer, the framebuffer and the visualizer are numpy in both
packages, so their outputs are held bitwise equal on the same draw calls
and the same messages; the pub/sub is held to the same deliveries under
the same sequence of operations.
"""

from __future__ import annotations

import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from slamrs_tpu.graph import node as jnode  # noqa: E402
from slamrs_tpu.graph import pubsub as jps  # noqa: E402
from slamrs_tpu.graph.nodes.viz import VisualizerNodeConfig as JViz  # noqa
from slamrs_tpu.io import teleop as jteleop  # noqa: E402
from slamrs_tpu.viz import framebuffer as jfb  # noqa: E402
from slamrs_tpu.viz import shapes as jshapes  # noqa: E402
from slamrs_tpu_torch.core.types import Scan  # noqa: E402
from slamrs_tpu_torch.graph import node as tnode  # noqa: E402
from slamrs_tpu_torch.graph import pubsub as tps  # noqa: E402
from slamrs_tpu_torch.graph.nodes.sim import SimulatorNodeConfig  # noqa
from slamrs_tpu_torch.graph.nodes.viz import VisualizerNodeConfig  # noqa
from slamrs_tpu_torch.io import teleop as tteleop  # noqa: E402
from slamrs_tpu_torch.utils import trace  # noqa: E402
from slamrs_tpu_torch.viz import framebuffer as tfb  # noqa: E402
from slamrs_tpu_torch.viz import shapes as tshapes  # noqa: E402


def _pubsub_log(mod) -> list:
    """A fixed sequence of pub/sub operations; what each subscriber got."""
    ps = mod.PubSub()
    log = []
    ps.set_waker(lambda: log.append("wake"))
    a1, a2 = ps.subscribe("a", int), ps.subscribe("a")
    b = ps.subscribe("b")
    pa, pb = ps.publish("a", int), ps.publish("b")
    for i in range(3):
        pa.publish(i)
    log.append(("before tick", a1.try_recv()))
    log.append(("tick", ps.tick()))
    log.append(("a1", a1.try_recv(), a1.drain()))
    log.append(("a2 latest", a2.latest(), len(a2)))
    pb.publish("x")
    pb.publish("y")
    ps.tick()
    log.append(("b", len(b), b.latest(), b.try_recv()))
    log.append(("empty tick", ps.tick()))
    for call in (lambda: ps.subscribe("a", str),
                 lambda: pa.publish("not an int"),
                 lambda: ps.publish("a", float)):
        with pytest.raises(mod.TopicTypeError):
            call()
    log.append(("topics", ps.topic_names()))
    ticker = mod.Ticker(ps, interval_s=0.001)
    pa.publish(7)
    deadline = time.monotonic() + 5.0
    while not len(a1) and time.monotonic() < deadline:
        time.sleep(0.001)
    ticker.stop()
    log.append(("ticker", a1.drain()))
    return log


def test_pubsub_same_deliveries_as_jax():
    assert _pubsub_log(tps) == _pubsub_log(jps)


def _draw(mod) -> list:
    """The same draw calls on a renderer of ``mod``."""
    sr = mod.ShapeRenderer(max_vertices=5000)
    C, P = mod.Color, mod.PrimitiveType
    sr.begin(P.LINE)
    sr.line(0, 0, 1, 1, C.RED)
    sr.rect(-0.5, 0.25, 2, 1.5, C.BLACK)
    sr.circle(0.3, -0.2, 0.7, C.GREEN, segments=17)
    sr.arrow(0.1, 0.2, 2.1, 0.4, C.BLUE)
    sr.gaussian2d([1.0, 2.0], [[0.04, 0.01], [0.01, 0.02]], C.RED)
    sr.end()
    sr.begin(P.FILLED)
    sr.rect(1.0, 1.0, 0.5, 0.25, C(0.2, 0.4, 0.6, 0.5))
    sr.circle(-1.0, 0.5, 0.3, C.BLUE)
    sr.arrow(-0.2, -0.3, -1.0, 0.5, C.GREEN)
    g = np.random.default_rng(3)
    sr.rects_batch(g.uniform(-3, 3, (50, 2)), 0.1, 0.2,
                   g.uniform(0, 1, (50, 4)))
    sr.end()
    sr.begin(P.LINE)
    sr.lines_batch(g.uniform(-4, 4, (30, 2, 2)), np.float32([0, 0, 0, 1]))
    sr.rects_batch(g.uniform(-3, 3, (5, 2)), 0.3, 0.3,
                   np.float32([1, 0, 1, 1]))
    sr.end()
    sr.gaussian2d_confidence([0.5, -0.5], [[0.09, -0.02], [-0.02, 0.04]])
    sr.begin(P.POINT)
    for i in range(40):
        sr.point(i * 0.1 - 2.0, np.sin(i), C.BLACK)
    sr.end()
    sr.begin(P.FILLED)
    sr.rects_batch(g.uniform(-3, 3, (2000, 2)), 0.01, 0.01,
                   np.float32([0, 0, 1, 1]))  # past the vertex budget
    sr.end()
    return sr.flush()


def _same_calls(tcalls, jcalls):
    assert len(tcalls) == len(jcalls) > 0
    for t, j in zip(tcalls, jcalls):
        assert t.primitive.value == j.primitive.value
        assert t.vertices.dtype == j.vertices.dtype
        assert t.vertices.tobytes() == j.vertices.tobytes()
        assert t.colors.tobytes() == j.colors.tobytes()


def test_shape_renderer_vertices_bitwise_as_jax():
    _same_calls(_draw(tshapes), _draw(jshapes))


@pytest.mark.parametrize("zoom,pan", [(1.0, (0, 0)), (2.5, (30, -12))])
def test_framebuffer_bytes_bitwise_as_jax(zoom, pan):
    fbs = []
    for shapes, fb in ((tshapes, tfb), (jshapes, jfb)):
        cam = shapes.Camera(160, 120)
        cam.zoom_by(zoom)
        cam.pan(*pan)
        fbs.append(fb.render(_draw(shapes), cam, width=160, height=120))
    assert fbs[0].dtype == fbs[1].dtype == np.uint8
    assert fbs[0].tobytes() == fbs[1].tobytes()
    assert len(np.unique(fbs[0].reshape(-1, 4), axis=0)) > 3


def test_camera_unproject_as_jax():
    t, j = tshapes.Camera(800, 600), jshapes.Camera(800, 600)
    for cam in (t, j):
        cam.zoom_by(1.7)
        cam.pan(13.0, -4.0)
    assert t.extent() == j.extent()
    np.testing.assert_array_equal(t.unproject(123.0, 45.0),
                                  j.unproject(123.0, 45.0))


def _viz_topics():
    return [("GridMap", {"topic": "map", "config": {"gridlines": True}}),
            ("Observation", {"topic": "obs", "topic_pose": "pose",
                             "config": {"point_color": [0.0, 1.0, 0.0]}}),
            ("Pose", {"topic": "pose", "config": {"radius": 0.2}}),
            ("PointMap", {"topic": "points", "config": {}}),
            ("LandmarkObservation", {"topic": "lms", "pose": [0.1, 0, 0.3],
                                     "config": {}}),
            ("LandmarkMap", {"topic": "lmmap", "config": {"p": 0.9}})]


def _viz_messages(node_mod, tensors: bool):
    g = np.random.default_rng(5)
    wrap = (lambda a: torch.from_numpy(np.array(a))) if tensors \
        else (lambda a: a)
    grid = g.uniform(0, 1, (6, 9)).astype(np.float32)
    pose = np.float32([0.3, -0.2, 0.7])
    n = 24
    angles = np.linspace(0, 2 * np.pi, n, endpoint=False).astype(np.float32)
    dist = g.uniform(0.1, 2.0, n).astype(np.float32)
    valid = g.uniform(0, 1, n) > 0.3
    present = g.uniform(0, 1, n) > 0.1
    scan = (Scan if tensors else jscan_type())(
        wrap(angles), wrap(dist), wrap(np.ones(n, np.float32)), wrap(valid),
        wrap(present))
    means = g.uniform(-1, 1, (4, 2)).astype(np.float32)
    covs = np.stack([np.eye(2, dtype=np.float32) * 0.01 * (i + 1)
                     for i in range(4)])
    seen = np.array([True, False, True, True])
    lm = type("LM", (), {})()
    lm.angles, lm.distances = wrap(angles[:5]), wrap(dist[:5])
    lm.valid = wrap(valid[:5])
    return {
        "map": node_mod.GridMapMessage(np.float32([-1.0, -0.5]), 0.25,
                                       wrap(grid)),
        "obs": node_mod.ScanOdometry(scan, None),
        "pose": node_mod.PoseMsg(wrap(pose)),
        "points": node_mod.PointMapMessage(wrap(g.uniform(-1, 1, (30, 2))
                                                .astype(np.float32))),
        "lms": lm,
        "lmmap": node_mod.LandmarkMapMessage(wrap(means), wrap(covs),
                                             wrap(seen)),
    }


def jscan_type():
    from slamrs_tpu.core.types import Scan as JScan

    return JScan


def _viz_run(cfg_cls, ps_mod, node_mod, shapes, tensors, tmp):
    ps = ps_mod.PubSub()
    cfg = cfg_cls(topics=_viz_topics())
    node = cfg.instantiate(ps, "cpu") if tensors else cfg.instantiate(ps)
    for topic, msg in _viz_messages(node_mod, tensors).items():
        ps.publish(topic).publish(msg)
    ps.tick()
    node.update()
    sr = shapes.ShapeRenderer()
    node.draw(shapes.WorldObj(sr))
    node.save_npz(tmp)
    return sr.flush(), dict(np.load(tmp))


def test_visualizer_draws_and_saves_as_jax(tmp_path):
    tcalls, tsaved = _viz_run(VisualizerNodeConfig, tps, tnode, tshapes,
                              True, tmp_path / "t.npz")
    jcalls, jsaved = _viz_run(JViz, jps, jnode, jshapes, False,
                              tmp_path / "j.npz")
    _same_calls(tcalls, jcalls)
    assert sorted(tsaved) == sorted(jsaved)
    for k in jsaved:
        assert tsaved[k].tobytes() == jsaved[k].tobytes(), k


def test_visualizer_rejects_unknown_config_fields():
    with pytest.raises(ValueError, match="unknown config"):
        VisualizerNodeConfig(topics=[("Pose", {"topic": "p", "config": {
            "colour": [1, 0, 0]}})]).instantiate(tps.PubSub(), "cpu")


def test_messages_copy_tensors_to_the_host_on_read():
    t = torch.arange(6, dtype=torch.bfloat16).reshape(2, 3)
    msg = tnode.GridMapMessage([0, 0], 0.5, t)
    t.add_(100)  # the message holds a copy made when it was built
    assert isinstance(msg.data, np.ndarray) and msg.data.dtype == np.float32
    np.testing.assert_array_equal(msg.data, np.arange(6).reshape(2, 3))
    assert tnode.PoseMsg(np.zeros(3)).pose.shape == (3,)


def test_spans_and_report():
    trace.reset()
    with trace.span("unit/test"):
        pass
    for _ in range(2):
        with trace.span("unit/repeated"):
            pass
    st = trace.all_stats()
    assert st["unit/test"].sample_count == 1
    assert st["unit/repeated"].sample_count == 2
    assert st["unit/repeated"].min <= st["unit/repeated"].mean
    rep = trace.report().splitlines()
    assert [line.split()[0] for line in rep] == ["unit/repeated",
                                                  "unit/test"]
    with torch.profiler.profile() as prof:
        with trace.span("unit/profiled"):
            torch.ones(3).sum()
    assert "unit/profiled" in {e.key for e in prof.key_averages()}
    trace.reset()
    assert trace.report() == ""


def _sim(update_period):
    ps = tps.PubSub()
    node = SimulatorNodeConfig(
        topic_command="cmd", topic_observation_scanner="scan",
        scene=[("Line", {"x1": -2.0, "y1": -2.0, "x2": 2.0, "y2": -2.0})],
        parameters={"update_period": update_period}).instantiate(ps, "cpu")
    return node, ps


def test_set_parameters_take_effect_on_the_next_tick():
    node, ps = _sim(0.5)
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
    with pytest.raises(ValueError, match="update_perod"):
        node.set_parameters(update_perod=0.1)


def _teleop_commands(mod, keys: bytes) -> list:
    r, w = os.pipe()
    got = []
    reader = mod.StdinTeleop(lambda a, b: got.append((a, b)),
                             target_speed=0.2, fd=r)
    os.write(w, keys)
    reader._thread.join(timeout=10.0)
    assert not reader.alive
    reader.stop()
    os.close(r)
    os.close(w)
    return got


def test_teleop_reader_as_jax():
    keys = b"wad\x1b[Aqz x?e\x1b[CQw"
    got = _teleop_commands(tteleop, keys)
    assert got == _teleop_commands(jteleop, keys)
    assert got[0] == (0.2, 0.2) and got[-1] == (0.0, 0.0)


def test_debug_nodes_draw_as_jax():
    """``configs/shape_test.yaml`` (ShapeTest, GaussianTest,
    MousePosition) through both Apps with a renderer: the same draw calls
    on the first and a later frame, and the Gaussian published."""
    from pathlib import Path

    from slamrs_tpu.graph.app import App as JApp
    from slamrs_tpu_torch.core.types import Gaussian2D
    from slamrs_tpu_torch.graph.app import App

    text = (Path(__file__).resolve().parents[1] / "configs" /
            "shape_test.yaml").read_text().replace(
        "- !ShapeTest", "- !ShapeTest {grid_steps: 7}")
    tapp = App.from_yaml(text, with_renderer=True, device="cpu")
    japp = JApp.from_yaml(text, with_renderer=True)
    sub = tapp.pubsub.subscribe("gaussian", Gaussian2D)
    for _ in range(2):
        tapp.frame()
        japp.frame()
        _same_calls(list(tapp.renderer._calls), list(japp.renderer._calls))
    msgs = sub.drain()
    assert len(msgs) == 2 and msgs[0].covariance.shape == (2, 2)


def test_gamepad_as_jax():
    from slamrs_tpu.graph.nodes.util import GamepadNodeConfig as JCfg
    from slamrs_tpu_torch.graph.nodes.util import GamepadNodeConfig

    def run(node, ps):
        sub = ps.subscribe("cmd")
        got = []
        for x, y in [(0, 1), (1, 1), (1, 1), (-0.3, 0.8), (0, 0), (0, 0)]:
            node.set_stick(x, y)
            node.update()
            ps.tick()
            got += [(float(m.speed_left), float(m.speed_right))
                    for m in sub.drain()]
        return got

    tps_, jps_ = tps.PubSub(), jps.PubSub()
    got = run(GamepadNodeConfig(topic_command="cmd", max_speed=0.5)
              .instantiate(tps_, "cpu"), tps_)
    assert got == run(JCfg(topic_command="cmd", max_speed=0.5)
                      .instantiate(jps_), jps_)
    assert len(got) == 4  # published on change only


def test_ekf_heat_map_draws_as_jax():
    """The EKF node's correlation heat map from the same state."""
    import jax.numpy as jnp

    from slamrs_tpu.graph.nodes.slam import EKFLandmarkSlamNodeConfig as JE
    from slamrs_tpu_torch.graph.nodes.slam import EKFLandmarkSlamNodeConfig

    g = np.random.default_rng(2)
    a = g.normal(0, 1, (9, 9)).astype(np.float32)
    cov = (a @ a.T + np.eye(9, dtype=np.float32)).astype(np.float32)
    cov[5] = cov[:, 5] = 0.0  # zero correlations draw white
    cfg = {"num_landmarks": 3}
    tn = EKFLandmarkSlamNodeConfig("p", "o", "m", cfg).instantiate(
        tps.PubSub(), "cpu")
    jn = JE("p", "o", "m", cfg).instantiate(jps.PubSub())
    tn.state = tn.state._replace(cov=torch.from_numpy(cov))
    jn.state = jn.state._replace(cov=jnp.asarray(cov))
    calls = []
    for node, shapes in ((tn, tshapes), (jn, jshapes)):
        sr = shapes.ShapeRenderer()
        node.draw(sr)
        calls.append(sr.flush())
    _same_calls(*calls)


def test_png_export_and_a_missing_matplotlib(tmp_path, monkeypatch):
    """``render_png`` writes a PNG through matplotlib; without matplotlib
    it and ``save_png`` stop with an error that names it."""
    import sys

    ps = tps.PubSub()
    node = VisualizerNodeConfig(topics=_viz_topics()).instantiate(ps, "cpu")
    for topic, msg in _viz_messages(tnode, True).items():
        ps.publish(topic).publish(msg)
    ps.tick()
    node.update()
    node.render_png(str(tmp_path / "viz.png"))
    assert (tmp_path / "viz.png").stat().st_size > 1000
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(RuntimeError, match="matplotlib"):
        node.render_png(str(tmp_path / "again.png"))
    with pytest.raises(RuntimeError, match="matplotlib"):
        tfb.save_png(np.zeros((4, 4, 4), np.uint8), str(tmp_path / "fb.png"))
