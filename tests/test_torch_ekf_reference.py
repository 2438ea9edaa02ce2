"""The ``ekf_landmarks_fleet`` benchmark configuration's plain reference
(``h100bench/reference/ekf.py``) against the port's EKF landmark SLAM and
landmark sensor, the check that decides the ``ekf.rollout`` cell's
``correct`` (``h100bench/ekf_compare.py``), the ``ekf_rollout`` driver
and the port's device counter ``ekf.corrections`` (``models/ekf.py``).

On the CPU: the port's ``update`` against the reference's, one world and
a fleet, bitwise; short cadence calls of a 4-world ``landmarks.yaml``
fleet (30 ticks, injected landmark draws, starts off the origin, some
lanes out of range) run by the frame program without graphs, followed by
the reference to 0; the counter against the valid lanes counted on the
host; the tiny ``ekf`` cell of ``h100bench/tests/fixtures`` run whole
through the harness; planted faults, each of which turns ``correct``
false; the controls past the warm-up (the float32 reorder within the
limits, bfloat16 over them).  The ``cuda`` case counts the corrections
inside replayed graphs at the cell's 256 worlds on the card:

    python -m pytest tests/test_torch_ekf_reference.py -q --noconftest -m cuda
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
for _p in (str(ROOT), str(ROOT / "h100bench" / "tests")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import fixture_bench  # noqa: E402
from h100bench import compare, control, ekf_compare, harness  # noqa: E402
from h100bench.drivers import ekf_rollout  # noqa: E402
from h100bench.reference import ekf as ref_ekf  # noqa: E402
from h100bench.reference import world as ref_world  # noqa: E402
from slamrs_tpu_torch.core.types import (  # noqa: E402
    Command, OdometryReading)
from slamrs_tpu_torch.graph import capture  # noqa: E402
from slamrs_tpu_torch.graph.compile import compile_world  # noqa: E402
from slamrs_tpu_torch.graph.config import parse_config  # noqa: E402
from slamrs_tpu_torch.models import ekf as ekf_model  # noqa: E402
from slamrs_tpu_torch.models import simulator as sim_model  # noqa: E402
from slamrs_tpu_torch.utils import trace  # noqa: E402

YAML = (ROOT / "configs" / "landmarks.yaml").read_text()
CELL = "tiny.ekf"
CELLS = {CELL: ("tiny_ekf", "rollout_60")}
LIMITS = json.loads((ROOT / "h100bench" / "workloads" / "ekf.rollout.json")
                    .read_text())["limits"]
W = 4
TICKS = 30  # 4 or 5 scans a call
SPEEDS = (0.04, 0.06)
# starts off the origin, from which some landmarks are out of range
STARTS = [(0.31, -0.22, 2.4), (-0.45, 0.1, -1.0), (0.05, 0.48, 3.1),
          (1.2, -0.9, 0.3)]


def _world(worlds=W):
    fw = compile_world(parse_config(YAML), device="cpu")
    world = ekf_compare.reference_world(YAML, {}, "cpu")
    state = fw.init((worlds,))
    start = torch.tensor(STARTS[:worlds], dtype=torch.float32)
    state = state._replace(pose=start.clone(), ekf=state.ekf._replace(
        mean=torch.cat([start, state.ekf.mean[:, 3:]], -1)))
    return fw, world, state


def _commands(n, device="cpu"):
    return Command(*(torch.full((n,), v, dtype=torch.float32, device=device)
                     for v in SPEEDS))


def _draws(seed, frames, worlds=W, device="cpu"):
    g = torch.Generator(device=device).manual_seed(seed)
    return tuple(x.cpu().numpy() for x in torch.randn(
        (2, frames, worlds, 7), generator=g, device=device))


def _host(state):
    h = ekf_compare.world_to_host(state, ekf_compare.host_buffers(state))
    return {**h, "ekf": {k: v.clone() for k, v in h["ekf"].items()}}


def _call(fw, state, draws, ticks=TICKS):
    return capture.run_program(fw, state, ticks, 0, _commands(ticks),
                               landmark_noise=draws, graphs=False)


def _checked_call(fw, state, draws, ticks=TICKS, **control):
    """One frame-program call from ``state`` held against the reference:
    ``(state after, outputs, the compared numbers)``."""
    before = _host(state)
    state, outs = _call(fw, state, draws, ticks)
    after = _host(state)
    host = {"pose": outs.pose.numpy(), "ekf_pose": outs.ekf_pose.numpy()}
    values = ekf_compare.follow_and_compare(
        YAML, {}, before, after, host, draws, *SPEEDS, ticks, "cpu",
        **control)
    return state, outs, values


def _correct(values):
    got = compare.compared(values, LIMITS)
    return all(v["value"] <= v["limit"] for v in got.values())


# --- the reference against the port ----------------------------------------

@pytest.mark.parametrize("worlds", [(), (W,)])
def test_reference_update_is_the_ports_update_bitwise(worlds):
    """Updates from seeded random poses and odometry with seeded draws:
    first sightings, lanes out of range, headings past pi; mean,
    covariance and seen flags bitwise."""
    fw, world, _ = _world()
    state = ekf_model.EkfState.init(fw.ekf_config, "cpu", worlds)
    mine = ref_ekf.EkfState(*(t.clone() for t in state))
    g = torch.Generator().manual_seed(21)
    firsts = invalid = 0
    for _ in range(12):
        pose = torch.cat([torch.rand(*worlds, 2, generator=g) * 2.4 - 1.2,
                          torch.rand(*worlds, 1, generator=g) * 8.0 - 4.0],
                         -1)
        dl = torch.rand(worlds, generator=g) * 0.02
        dr = torch.rand(worlds, generator=g) * 0.02
        na = torch.randn(*worlds, 7, generator=g)
        nd = torch.randn(*worlds, 7, generator=g)
        obs = sim_model.landmark_scan(pose, fw.scene, fw.params,
                                      noise_a=na, noise_d=nd)
        ref_obs = ref_ekf.landmark_scan(pose, world, na, nd)
        for a, b in zip(obs, ref_obs):
            assert torch.equal(a, b)
        firsts += int((obs.valid & ~state.seen[..., :7]).sum())
        invalid += int((~obs.valid).sum())
        state, out = ekf_model.update(
            state, obs, OdometryReading(dl, dr, fw.params.wheel_base),
            fw.ekf_config)
        mine = ref_ekf.update(mine, ref_obs, (dl, dr, world.wheel_base),
                              world.ekf)
        for a, b in zip(state, mine):
            assert torch.equal(a, b)
        assert torch.equal(out.pose, mine.mean[..., 0:3])
    assert firsts > 0 and invalid > 0


def test_port_follows_the_reference_over_carried_calls():
    """Three carried 30-tick calls of the 4-world fleet, each followed by
    the reference from its input state to 0; no world sees every
    landmark."""
    fw, _, state = _world()
    seen = []
    for seed in range(3):
        state, outs, values = _checked_call(fw, state, _draws(seed, 6))
        assert values == {"pose_gap": 0.0, "cov_gap": 0.0, "seen_gap": 0.0}
        assert outs.pose.shape[1:] == (W, 3) and outs.pose.shape[0] >= 4
        seen.append(state.ekf.seen.sum(-1).tolist())
    assert max(seen[-1]) < 7 and min(seen[0]) >= 1


def test_reference_imports_neither_jax_nor_the_port():
    code = ("import sys, torch\n"
            f"sys.path.insert(0, {str(ROOT)!r})\n"
            "from h100bench.reference import ekf\n"
            "from h100bench import ekf_compare, ekf_control\n"
            "tops = {m.split('.')[0] for m in sys.modules}\n"
            "bad = tops & {'jax', 'jaxlib', 'flax', 'slamrs_tpu',\n"
            "              'slamrs_tpu_torch'}\n"
            "assert not bad, bad\n"
            "assert torch.backends.cuda.matmul.allow_tf32 is False\n"
            "assert torch.backends.cudnn.allow_tf32 is False\n")
    done = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert done.returncode == 0, done.stderr


@pytest.mark.parametrize("shape", [(3, 4), (2, 5, 6), (7,)])
def test_reordered_product_is_the_product(shape):
    g = torch.Generator().manual_seed(4)
    a = torch.randn(*shape[:-1], 5, shape[-1], generator=g,
                    dtype=torch.float64)
    b = torch.randn(*shape[:-1], shape[-1], 3, generator=g,
                    dtype=torch.float64)
    torch.testing.assert_close(ref_ekf.reordered_product(a, b), a @ b)
    v = torch.randn(shape[-1], generator=g, dtype=torch.float64)
    m = torch.randn(4, shape[-1], generator=g, dtype=torch.float64)
    torch.testing.assert_close(ref_ekf.reordered_product(m, v), m @ v)


# --- the counter -------------------------------------------------------------

def test_ekf_corrections_counts_the_valid_lanes():
    """A call's ``ekf.corrections`` gain is the lanes the sensor saw from
    the frames' true poses, counted on the host, and the eager loop from
    a copy of the same state with the same draws counts the same and
    ends on the same bits."""
    fw, world, state = _world()
    copy = state._replace(pose=state.pose.clone(), ekf=ekf_model.EkfState(
        *(t.clone() for t in state.ekf)))
    draws = _draws(5, 6)
    trace.reset()
    counter = trace.device_counter("ekf.corrections", "cpu")
    prog, out_p = _call(fw, state, draws)
    by_program = int(counter)
    rec = trace.calls()[-1]
    assert sum(int(t) for t in rec["device"]["ekf.corrections"]) \
        == by_program
    host = int(ref_ekf.valid_lanes(out_p.pose, world).sum())
    assert by_program == host > 0
    assert host < out_p.pose.shape[0] * W * 7  # some lanes out of range
    eager, out_e = fw.rollout_cadence(copy, TICKS, seed=0,
                                      commands=_commands(TICKS),
                                      landmark_noise=draws, capture=False)
    assert int(counter) - by_program == by_program
    assert torch.equal(out_e.ekf_pose, out_p.ekf_pose)
    assert torch.equal(eager.ekf.cov, prog.ekf.cov)


@pytest.mark.parametrize("worlds", [(), (3,)])
def test_ekf_corrections_gains_each_update(worlds):
    fw, world, _ = _world()
    state = ekf_model.EkfState.init(fw.ekf_config, "cpu", worlds)
    trace.reset()
    counter = trace.device_counter("ekf.corrections", "cpu")
    g = torch.Generator().manual_seed(8)
    for _ in range(4):
        pose = torch.rand(*worlds, 3, generator=g) * 2.0 - 1.0
        obs = sim_model.landmark_scan(pose, fw.scene, fw.params,
                                      generator=g)
        before = int(counter)
        z = torch.zeros(worlds)
        state, _ = ekf_model.update(
            state, obs, OdometryReading(z, z, fw.params.wheel_base),
            fw.ekf_config)
        assert int(counter) - before == int(obs.valid.sum())


# --- the cell ----------------------------------------------------------------

@pytest.mark.parametrize("trace_on", [False, True])
def test_tiny_ekf_cell_runs_correct_on_the_cpu(tmp_path, trace_on):
    bench = harness.Bench(fixture_bench.make_root(tmp_path, CELLS))
    result = harness.run_cell(bench, CELL, 2 ** 33 + 7, 0.4, trace_on,
                              device="cpu")
    assert result["correct"], result["compared"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert result["compared"] == {k: {"value": 0.0, "limit": float(v)}
                                  for k, v in LIMITS.items()}
    metrics = {n: v["value"] for n, v in result["metrics"].items()}
    if trace_on:
        assert result["attempted"] >= 1 + ekf_rollout.CALLS_AFTER_PROFILE
        assert metrics["ekf_corrections_per_frame"] > 0
        assert metrics["frame_program_reuse_share"] == 1.0
        # no kernel runs on the CPU: the device readers find nothing
        assert "ekf_launches_per_frame" not in metrics
    else:
        assert {"setup_s", "world_ticks_per_s"} <= set(metrics)


def test_corrections_reader_is_the_hosts_count_of_valid_lanes(tmp_path):
    """The driver's record: ``ekf_corrections_per_frame`` reads the lanes
    the window's first call saw a frame, as the host counts them from its
    true poses; the worlds start apart and see different lanes."""
    bench = harness.Bench(fixture_bench.make_root(tmp_path, CELLS))
    ctx = harness.Context(bench, CELL, 2 ** 31 + 3, "cpu")
    driver = ekf_rollout.Driver(ctx)
    assert len({tuple(s) for s in driver.starts}) == 4
    assert (np.hypot(driver.starts[:, 0], driver.starts[:, 1]) <= 0.5).all()
    trace.reset()
    driver.setup()
    record = driver.window(0.2, None)
    reader = harness.load_module(
        ROOT / "h100bench" / "metrics" / "ekf_corrections_per_frame.py",
        "test_ekf_metric_corrections")
    assert reader.read(record) == record["valid_lanes_per_frame"] > 0
    assert record["ekf_sizes"] == {"worlds": 4, "dim": 23, "lanes": 7}
    assert record["world_ticks"] == record["calls"] * 60 * 4


def test_ekf_driver_refuses_a_world_without_the_ekf_alone(tmp_path):
    root = fixture_bench.make_root(tmp_path, CELLS)
    yaml = root / "h100bench" / "configs" / "tiny_ekf.yaml"
    yaml.write_text((root / "h100bench" / "configs" / "tiny_icp.yaml")
                    .read_text())
    bench = harness.Bench(root)
    with pytest.raises(ValueError, match="EKF landmark SLAM alone"):
        harness.run_cell(bench, CELL, 3, 0.2, False, device="cpu")


# --- planted faults ----------------------------------------------------------

def last_lane_dropped(monkeypatch):
    """The filter skips the last observation lane."""
    real = ekf_model.update

    def skipping(state, obs, odometry, config):
        valid = obs.valid.clone()
        valid[..., -1] = False
        return real(state, obs._replace(valid=valid), odometry, config)
    monkeypatch.setattr(ekf_model, "update", skipping)


def motion_jacobian_dropped(monkeypatch):
    """The covariance is propagated without the motion's Jacobian."""
    real = ekf_model._motion_prediction

    def flat(mean, odometry):
        g, gx = real(mean, odometry)
        return g, torch.eye(3).expand_as(gx).clone()
    monkeypatch.setattr(ekf_model, "_motion_prediction", flat)


def noise_swapped(monkeypatch):
    """The sensor puts the range draws on the bearings and back."""
    real = sim_model.landmark_scan

    def swapped(pose, scene, params, generator=None, noise_a=None,
                noise_d=None):
        return real(pose, scene, params, generator, noise_d, noise_a)
    monkeypatch.setattr(sim_model, "landmark_scan", swapped)


FAULTS = [last_lane_dropped, motion_jacobian_dropped, noise_swapped]


@pytest.mark.parametrize("fault", FAULTS)
def test_fault_makes_correct_false(monkeypatch, fault):
    fw, _, state = _world()
    state, _ = _call(fw, state, _draws(1, 6))
    fault(monkeypatch)
    _, _, values = _checked_call(fw, state, _draws(2, 6))
    assert not _correct(values), values


def test_fault_in_the_tiny_cell_makes_correct_false(tmp_path, monkeypatch):
    bench = harness.Bench(fixture_bench.make_root(tmp_path, CELLS))
    last_lane_dropped(monkeypatch)
    result = harness.run_cell(bench, CELL, 2 ** 33 + 1, 0.3, False,
                              device="cpu")
    assert not result["correct"], result["compared"]


def test_bfloat16_control_fails_its_limits(tmp_path):
    bench = harness.Bench(fixture_bench.make_root(tmp_path, CELLS))
    got = control.readings(bench, CELL, 2 ** 32 + 5, 0.2, True,
                           device="cpu")
    lim = bench.workload_params(CELL)["limits"]
    assert all(got["sound"][k] <= v for k, v in lim.items()), got
    assert any(got["control"][k] > v for k, v in lim.items()), got


def test_controls_past_the_warm_up_calls():
    """Two whole 900-tick calls of the cell's traffic (each world's circle
    closed, every landmark it passes seen), then a checked call: the
    float32 reorder stays within the limits, TF32 products and bfloat16
    fail them by more than ten times."""
    fw, _, state = _world()
    frames = ref_world.n_frames_max(900, 0.2)
    for seed in range(2):
        state, _ = _call(fw, state, _draws(seed, frames), 900)
    before = _host(state)
    draws = _draws(2, frames)

    def control(**kw):
        ref = ekf_compare.follow(YAML, {}, before, draws, *SPEEDS, 900,
                                 "cpu")
        got = ekf_compare.follow(YAML, {}, before, draws, *SPEEDS, 900,
                                 "cpu", **kw)
        return ekf_compare.numbers(got, ref)
    reorder = control(control="reorder")
    assert _correct(reorder) and reorder["pose_gap"] > 0, reorder
    for low in (control(control="tf32"), control(quantize=torch.bfloat16)):
        assert any(low[k] > 10 * v for k, v in LIMITS.items() if v), low


def test_gaps_wrap_headings_and_scale_the_covariance():
    a = torch.tensor([[0.0, 0.0, math.pi - 1e-4]])
    b = torch.tensor([[0.0, 1e-5, -math.pi + 1e-4]])
    assert ekf_compare.pose_gap(a, b) == pytest.approx(2e-4, rel=1e-3)
    assert ekf_compare.pose_gap(a, b[:, :2]) == math.inf
    ca = torch.diag(torch.tensor([0.0, 4.0, 100.0]))
    cb = ca.clone()
    cb[1, 2] = cb[2, 1] = 2.0  # sqrt(4 * 100) = 20
    assert ekf_compare.cov_gap(ca, cb) == pytest.approx(0.1)
    ca[0, 0] = 1e-3  # the reference's variance is 0: the gap is absolute
    assert ekf_compare.cov_gap(ca, cb) == pytest.approx(0.1)
    ca[0, 0] = 0.5
    assert ekf_compare.cov_gap(ca, cb) == pytest.approx(0.5)
    assert ekf_compare.cov_gap(ca, cb * math.nan) == math.inf


# --- on the card -------------------------------------------------------------

@pytest.mark.cuda
def test_ekf_corrections_in_replayed_graphs_on_the_card():
    """The cell's 256-world fleet, captured on the card: the counter gains
    inside the graph replays the valid lanes counted on the host, an
    eager call from a copy of the same state with the same draws ends on
    the same bits, and the reference follows the captured call to 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    text = (ROOT / "h100bench" / "configs" / "ekf_landmarks_fleet.yaml") \
        .read_text()
    fw = compile_world(parse_config(text), device=dev)
    world = ekf_compare.reference_world(text, {}, dev)
    worlds = 256
    g = torch.Generator().manual_seed(3)
    start = (torch.rand(worlds, 3, generator=g) - 0.5).to(dev)
    state = fw.init((worlds,))
    state = state._replace(pose=start.clone(), ekf=state.ekf._replace(
        mean=torch.cat([start, state.ekf.mean[:, 3:]], -1)))
    frames = ref_world.n_frames_max(900, 0.2)
    commands = _commands(900, dev)
    state, _ = fw.rollout_cadence(state, 900, commands=commands,
                                  landmark_noise=_draws(1, frames, worlds,
                                                        dev))
    draws = _draws(2, frames, worlds, dev)
    before = _host(state)
    copy = state._replace(pose=state.pose.clone(),
                          accum_left=state.accum_left.clone(),
                          accum_right=state.accum_right.clone(),
                          ekf=ekf_model.EkfState(*(t.clone()
                                                   for t in state.ekf)))
    state, out = fw.rollout_cadence(state, 900, commands=commands,
                                    landmark_noise=draws)
    torch.cuda.synchronize()
    rec = trace.calls()[-1]
    assert rec["counts"].get(capture.REUSED)
    gained = sum(int(t) for t in rec["device"]["ekf.corrections"])
    assert gained == int(ref_ekf.valid_lanes(out.pose, world).sum()) > 0
    eager, out_e = fw.rollout_cadence(copy, 900, commands=commands,
                                      landmark_noise=draws, capture=False)
    assert torch.equal(out_e.ekf_pose, out.ekf_pose)
    assert torch.equal(eager.ekf.cov, state.ekf.cov)
    after = _host(state)
    host = {"pose": out.pose.cpu().numpy(),
            "ekf_pose": out.ekf_pose.cpu().numpy()}
    values = ekf_compare.follow_and_compare(text, {}, before, after, host,
                                            draws, *SPEEDS, 900, dev)
    assert values == {"pose_gap": 0.0, "cov_gap": 0.0, "seen_gap": 0.0}
