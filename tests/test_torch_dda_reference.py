"""The ``grid_slam_dda`` benchmark configuration's plain reference
(``h100bench/reference/dda.py``) against the port's dda grid SLAM, the
``dda_rollout`` driver that runs the ``dda.rollout`` cell, its two
readers, and the port's device counter ``dda.cells`` (``ops/grid.py``).

On the CPU: the port's dda ``update`` against the reference's on seeded
random scans and odometry under injected draws, 32 particles on a 2 x 2 m
map at 0.05 m, 24 updates with resamples, bitwise; the reference's walk
and inverse sensor model against ``tests/parity_oracle.py`` (the Rust
reference line by line) on a few hundred rays; the tiny ``dda`` cell of
``h100bench/tests/fixtures`` run whole through the harness; three planted
faults (a dropped overshoot step, a changed tolerance, the maps' gather
skipped), each of which turns ``correct`` false; the bf16 control, which
fails its limits; the counter against the oracle's count of emitted
lanes.  The ``cuda`` case counts the lanes inside replayed graphs on the
card against an eager call:

    python -m pytest tests/test_torch_dda_reference.py -q --noconftest -m cuda
"""

from __future__ import annotations

import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
for _p in (str(ROOT), str(ROOT / "h100bench" / "tests"), str(ROOT / "tests")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import fixture_bench  # noqa: E402
import parity_oracle as oracle  # noqa: E402
from h100bench import compare, control, harness  # noqa: E402
from h100bench.reference import dda  # noqa: E402
from h100bench.reference import slam as ref_slam  # noqa: E402
from h100bench.reference import world as ref_world  # noqa: E402
from slamrs_tpu_torch.core.types import (  # noqa: E402
    Command, OdometryReading, Scan)
from slamrs_tpu_torch.graph import capture  # noqa: E402
from slamrs_tpu_torch.graph.compile import compile_world  # noqa: E402
from slamrs_tpu_torch.graph.config import parse_config  # noqa: E402
from slamrs_tpu_torch.models import gridslam  # noqa: E402
from slamrs_tpu_torch.models.gridslam import UpdateNoise  # noqa: E402
from slamrs_tpu_torch.ops import grid as grid_ops  # noqa: E402
from slamrs_tpu_torch.utils import trace  # noqa: E402

CELL = "tiny.dda"
CELLS = {CELL: ("tiny_dda", "rollout_60")}
YAML = (fixture_bench.FIXTURES / "configs" / "tiny_dda.yaml").read_text()
LIMITS = json.loads((fixture_bench.FIXTURES / "workloads" / f"{CELL}.json")
                    .read_text())["limits"]
TICKS = 60  # 10 scans a call
SPEEDS = (0.05, 0.08)
P = 32
WHEEL_BASE = 0.1
CONFIG = gridslam.GridSlamConfig(
    position_x=-1.0, position_y=-1.0, width=2.0, height=2.0,
    resolution=0.05, n_particles=P, max_scan_range=1.0,
    resample_neff_frac=0.5, integrate="dda")
REF_CONFIG = dda.DdaConfig.from_yaml(dict(
    position=[-1.0, -1.0], width=2.0, height=2.0, resolution=0.05,
    n_particles=P, max_scan_range=1.0, resample_neff_frac=0.5,
    integrate="dda"))


# --- one update at a time, on seeded random inputs ------------------------

def _random_update_inputs(g):
    """A scan (distances up to the range, ~10 % of beams invalid, ~5 %
    absent, a few of zero length), odometry and the draws."""
    b = 360
    angles = torch.deg2rad(torch.arange(b, dtype=torch.float32))
    distances = torch.rand(b, generator=g) * 0.95 + 0.05
    distances[torch.rand(b, generator=g) < 0.02] = 0.0
    valid = torch.rand(b, generator=g) > 0.1
    present = torch.rand(b, generator=g) > 0.05
    dl, dr = torch.rand(2, generator=g) * 0.03
    noise = (torch.randn(P, generator=g), torch.randn(P, generator=g),
             torch.rand(1, generator=g))
    return (angles, distances, valid, present), (dl, dr), noise


@pytest.mark.parametrize("seed", [3, 2**33 + 11])
def test_port_update_is_the_reference_update_bitwise(seed):
    """24 updates from a fresh state on random scans: every update's
    sampled, resampled poses, weights, N_eff, best pose and maps equal the
    reference's bit for bit, through several resamples."""
    g = torch.Generator().manual_seed(seed)
    state = gridslam.GridSlamState.init(CONFIG, "cpu")
    ref = ref_slam.SlamState(state.poses, state.grids, state.weights,
                             state.best_pose, state.best_idx,
                             state.ancestors)
    resamples = 0
    for _ in range(24):
        (angles, distances, valid, present), (dl, dr), noise = \
            _random_update_inputs(g)
        scan = Scan(angles, distances, torch.zeros_like(distances), valid,
                    present)
        state, out = gridslam.update(
            state, scan, OdometryReading(dl, dr, WHEEL_BASE), CONFIG,
            noise=UpdateNoise(*noise))
        ref, ref_out = dda.update(ref, (angles, distances, valid, present),
                                  (dl, dr, WHEEL_BASE), REF_CONFIG, noise)
        for name in ("poses", "grids", "weights", "best_pose", "best_idx",
                     "ancestors"):
            assert torch.equal(getattr(state, name), getattr(ref, name)), \
                name
        assert torch.equal(out.n_eff, ref_out.n_eff)
        assert torch.equal(out.pose, ref_out.pose)
        resamples += int(out.resampled)
    assert resamples >= 3
    assert (state.grids != 0).any()


# --- the reference against the Rust reference's line-by-line oracle ------

COLS, ROWS = 24, 18


def _rays(kind, rng):
    """``[n, 4]`` float32 rays (x0, y0, x1, y1) in grid coordinates."""
    def start(n):
        return rng.uniform(0.0, [COLS, ROWS], (n, 2))

    if kind == "zero_length":
        s = start(60)
        s[:20] = np.floor(s[:20]) + 0.5  # cell centres
        return np.concatenate([s, s], 1)
    if kind == "axis_aligned":
        s = start(80)
        length = rng.uniform(-10.0, 10.0, 80)
        e = s.copy()
        e[:40, 0] += length[:40]  # along x
        e[40:, 1] += length[40:]  # along y
        return np.concatenate([s, e], 1)
    if kind == "diagonal":
        # on a 1/8 lattice: every step's error is exact, ties included
        s = np.round(start(80) * 8) / 8
        length = np.round(rng.uniform(0.5, 9.0, 80) * 8) / 8
        sign = rng.choice([-1.0, 1.0], (80, 2))
        return np.concatenate([s, s + sign * length[:, None]], 1)
    if kind == "leaving":
        s = start(80)
        a = rng.uniform(-np.pi, np.pi, 80)
        far = s + 40.0 * np.stack([np.cos(a), np.sin(a)], 1)
        s[60:] = rng.uniform(-6.0, -1.0, (20, 2))  # starting outside
        return np.concatenate([s, far], 1)
    s = start(120)
    return np.concatenate([s, s + rng.uniform(-12.0, 12.0, (120, 2))], 1)


@pytest.mark.parametrize("kind", ["zero_length", "axis_aligned", "diagonal",
                                  "leaving", "random"])
def test_reference_walk_is_the_oracles(kind):
    rays = _rays(kind, np.random.default_rng(len(kind))).astype(np.float32)
    x0, y0, x1, y1 = (torch.from_numpy(rays[:, i].copy()) for i in range(4))
    cx, cy, emitted, unfinished = dda.walk(x0, y0, x1, y1, COLS, ROWS, 48)
    assert not unfinished.any()
    emitted_any = 0
    for i, (a, b, c, d) in enumerate(rays):
        want = [(x, y) for x, y, _, _ in oracle.grid_ray(
            a, b, c, d, COLS, ROWS)]
        m = emitted[i]
        got = list(zip(cx[i][m].tolist(), cy[i][m].tolist()))
        assert got == want, (i, (a, b, c, d))
        emitted_any += bool(want)
    if kind == "leaving":
        assert 0 < emitted_any < len(rays)  # the outside starts emit none
    if kind == "zero_length":  # 1 + the 2 overshoot steps on one cell
        assert (emitted.sum(-1) == 3).all()


def test_reference_walk_raises_past_its_step_count():
    cfg = dda.DdaConfig(dda.Spec(0.0, 0.0, 4.0, 4.0, 0.05), 2, 1.0, 0.5)
    pose = torch.tensor([[2.0, 2.0, 0.0], [2.0, 2.0, 1.0]])
    beams = (torch.zeros(1), torch.full((1,), 1.5), torch.ones(1, dtype=bool),
             torch.ones(1, dtype=bool))
    with pytest.raises(ValueError, match="more than 34 steps"):
        dda.integrate(torch.zeros(2, 80, 80), cfg.spec, pose, *beams,
                      cfg.steps)


def test_reference_inverse_sensor_model_is_the_oracles():
    rng = np.random.default_rng(5)
    measured = rng.uniform(0.0, 20.0, 400).astype(np.float32)
    # distances on and around each band's edges
    offsets = np.array([-3.0, -1.0, -0.5, 0.0, 0.5, 1.0, 1.5, 3.0],
                       np.float32)
    dist = (measured[:, None] + offsets).astype(np.float32)
    dist = np.concatenate([dist, rng.uniform(0.0, 22.0, (400, 4))
                           .astype(np.float32)], 1)
    for hit in (True, False):
        got = dda.inverse_sensor_model(
            torch.from_numpy(dist), torch.from_numpy(measured)[:, None],
            torch.full((400, 1), hit))
        want = np.array([[oracle.inverse_sensor_model(d, m, hit)
                          for d in row] for row, m in zip(dist, measured)],
                        np.float32)
        assert np.array_equal(got.numpy(), want)
        assert got.dtype == torch.float32


def test_reference_refuses_another_integrator():
    with pytest.raises(ValueError, match="integrate: dda"):
        dda.DdaConfig.from_yaml({"integrate": "fused"})


# --- whole calls, the tiny cell, faults and the control ---------------------

def _world():
    fw = compile_world(parse_config(YAML), device="cpu")
    return fw, fw.init()


def _commands(n, device="cpu"):
    return Command(*(torch.full((n,), v, dtype=torch.float32, device=device)
                     for v in SPEEDS))


def _draws(seed, p=P):
    frames = ref_world.n_frames_max(TICKS, 0.2)
    g = torch.Generator().manual_seed(seed)
    normal = torch.randn((2, frames, p), generator=g)
    return (normal[0].numpy(), normal[1].numpy(),
            torch.rand((frames, 1), generator=g).numpy())


def _copy(state):
    return compare.world_to_host(state, compare.host_buffers(state))


def _checked_call(fw, state, draws):
    """One frame-program call from ``state`` held against the reference:
    ``(state after, n_eff of each frame, the compared numbers,
    correct)``."""
    before = _copy(state)
    state, outs = capture.run_program(fw, state, TICKS, 0, _commands(TICKS),
                                      noise=UpdateNoise(*draws),
                                      graphs=False)
    after = _copy(state)
    host = {"pose": outs.pose.numpy(), "grid_pose": outs.grid_pose.numpy(),
            "n_eff": outs.n_eff.numpy()}
    values = dda.follow_and_compare(YAML, {}, before, after, host, draws,
                                    *SPEEDS, TICKS, "cpu")
    got = compare.compared(values, LIMITS)
    correct = all(v["value"] <= v["limit"] for v in got.values())
    return state, outs.n_eff, values, correct


def test_port_follows_the_dda_reference_over_carried_calls():
    fw, state = _world()
    resamples = 0
    for seed in range(2):
        state, n_eff, values, correct = _checked_call(fw, state,
                                                      _draws(seed))
        assert correct, values
        assert values == {"pose_gap": 0.0, "n_eff_gap": 0.0, "map_gap": 0.0}
        resamples += int((n_eff <= 0.5 * P).sum())
    assert resamples >= 2


@pytest.mark.parametrize("trace_on", [False, True])
def test_tiny_dda_cell_runs_correct_on_the_cpu(tmp_path, trace_on):
    bench = harness.Bench(fixture_bench.make_root(tmp_path, CELLS))
    result = harness.run_cell(bench, CELL, 2 ** 33 + 7, 0.4, trace_on,
                              device="cpu")
    assert result["correct"], result["compared"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert all(v["value"] == 0.0 for v in result["compared"].values())
    metrics = {n: v["value"] for n, v in result["metrics"].items()}
    if trace_on:
        assert result["attempted"] >= 9  # the profiled call and 8 more
        assert metrics["dda_cells_per_frame"] > 0
        assert metrics["frame_program_reuse_share"] == 1.0
        # no kernel runs on the CPU: the device readers find nothing
        assert "dda_scatter_device_us_per_frame" not in metrics
    else:
        assert {"setup_s", "world_ticks_per_s"} <= set(metrics)


def test_dda_driver_refuses_a_fused_world(tmp_path):
    root = fixture_bench.make_root(tmp_path, CELLS)
    yaml = root / "h100bench" / "configs" / "tiny_dda.yaml"
    yaml.write_text(yaml.read_text().replace('integrate: "dda"',
                                             'integrate: "fused"'))
    bench = harness.Bench(root)
    with pytest.raises(ValueError, match="integrate: dda"):
        harness.run_cell(bench, CELL, 3, 0.2, False, device="cpu")


def overshoot_dropped(monkeypatch):
    """The walk stops one step early past the endpoint."""
    real = grid_ops.traverse_ray

    def short(*a, **k):
        return real(*a, additional_steps=grid_ops.ADDITIONAL_STEPS - 1)
    monkeypatch.setattr(grid_ops, "traverse_ray", short)


def tolerance_changed(monkeypatch):
    """The occupied band is 3 cells wide, not 2."""
    real = grid_ops.inverse_sensor_model_log_odds

    def wide(*a, **k):
        return real(*a, tolerance=3.0)
    monkeypatch.setattr(grid_ops, "inverse_sensor_model_log_odds", wide)


def gather_skipped(monkeypatch):
    """The resample moves the poses but not the maps: the ancestors are
    left pending, which the dda update never applies."""
    real = gridslam.resample_mechanism

    def deferred(config, state):
        return "deferred" if config.integrate == "dda" else real(config,
                                                                state)
    monkeypatch.setattr(gridslam, "resample_mechanism", deferred)


FAULTS = [overshoot_dropped, tolerance_changed, gather_skipped]


@pytest.mark.parametrize("fault", FAULTS)
def test_fault_in_the_dda_path_makes_correct_false(monkeypatch, fault):
    fw, state = _world()
    fault(monkeypatch)
    results = []
    for seed in range(2):  # a skipped gather shows after a resample
        state, _, values, correct = _checked_call(fw, state, _draws(seed))
        results.append((correct, values))
    assert not all(c for c, _ in results), results


def test_fault_in_the_tiny_cell_makes_correct_false(tmp_path, monkeypatch):
    bench = harness.Bench(fixture_bench.make_root(tmp_path, CELLS))
    overshoot_dropped(monkeypatch)
    result = harness.run_cell(bench, CELL, 2 ** 33 + 1, 0.3, False,
                              device="cpu")
    assert not result["correct"], result["compared"]


def test_bfloat16_control_fails_its_limits(tmp_path):
    bench = harness.Bench(fixture_bench.make_root(tmp_path, CELLS))
    got = control.readings(bench, CELL, 2 ** 32 + 5, 0.2, True,
                           device="cpu")
    assert got["control_dtype"] == "bfloat16"
    assert all(v == 0.0 for v in got["sound"].values()), got
    assert any(got["control"][k] > v for k, v in LIMITS.items()), got


# --- the counter and the readers --------------------------------------------

def test_dda_cells_counts_the_oracles_emitted_lanes():
    """After one update, ``dda.cells`` gained what the oracle's walk
    emits for every particle's present beams from the update's own grid
    coordinates."""
    g = torch.Generator().manual_seed(8)
    state = gridslam.GridSlamState.init(CONFIG, "cpu")
    state = state._replace(poses=torch.randn(P, 3, generator=g) * 0.3)
    beams, (dl, dr), noise = _random_update_inputs(g)
    angles, distances, valid, present = beams
    spec = CONFIG.grid_spec
    poses = ref_slam.motion_sample(state.poses, dl, dr, WHEEL_BASE, *noise[:2])
    start = spec.world_to_grid(poses[:, 0:2]).numpy()
    ends = spec.world_to_grid(grid_ops.scan_endpoints(
        poses, angles, distances)).numpy()
    want = sum(len(list(oracle.grid_ray(*start[p], *ends[p, b], spec.cols,
                                        spec.rows)))
               for p in range(P) for b in range(360) if present[b])
    counter = trace.device_counter("dda.cells", "cpu")
    before = int(counter)
    gridslam.update(state, Scan(angles, distances, torch.zeros(360), valid,
                                present),
                    OdometryReading(dl, dr, WHEEL_BASE), CONFIG,
                    noise=UpdateNoise(*noise))
    assert int(counter) - before == want > 0


def test_dda_cells_eager_and_program_count_the_same():
    """A call's ``dda.cells`` gain, in its record, is what the counter
    gained, and the eager loop from a copy of the same state with the same
    draws counts the same and ends on the same bits."""
    fw, state = _world()
    draws = UpdateNoise(*_draws(9))
    copy = state._replace(grid=state.grid._replace(
        grids=state.grid.grids.clone()))
    trace.reset()
    counter = trace.device_counter("dda.cells", "cpu")
    prog, out_p = capture.run_program(fw, state, TICKS, 0, _commands(TICKS),
                                      noise=draws, graphs=False)
    by_program = int(counter)
    rec = trace.calls()[-1]
    assert sum(int(t) for t in rec["device"]["dda.cells"]) == by_program > 0
    assert rec["counts"]["rollout.frames"] == out_p.n_eff.shape[0]
    eager, out_e = fw.rollout_cadence(copy, TICKS, seed=0,
                                      commands=_commands(TICKS),
                                      noise=draws, capture=False)
    assert int(counter) - by_program == by_program
    assert torch.equal(out_e.grid_pose, out_p.grid_pose)
    assert torch.equal(eager.grid.grids, prog.grid.grids)


def _reader(name):
    return harness.load_module(ROOT / "h100bench" / "metrics" / f"{name}.py",
                               f"test_dda_metric_{name}")


def test_dda_readers_say_nothing_without_the_counter_or_the_kernels(
        monkeypatch):
    summary = {"window_s": 1.0, "busy_s": 0.5, "frames": 15,
               "kernels": {"fused_update_kernel": {"count": 15,
                                                   "seconds": 0.01}}}
    scatter = _reader("dda_scatter_device_us_per_frame")
    assert scatter.read({"trace": summary}) is None
    assert scatter.read({}) is None
    summary["kernels"]["void at::native::indexing_backward_kernel_stride_1"
                       "<float>(...)"] = {"count": 15, "seconds": 15 * 1e-3}
    summary["kernels"]["void at_cuda_detail::cub::"
                       "DeviceRadixSortOnesweepKernel<...>"] = {
        "count": 45, "seconds": 15 * 2e-3}
    assert scatter.read({"trace": summary}) == pytest.approx(3000.0)
    cells = _reader("dda_cells_per_frame")
    assert cells.read({"calls": 0}) is None

    def first_call(device, frames=10):
        return [{"device": device, "counts": {"rollout.frames": frames}}]
    monkeypatch.setattr(cells, "window_calls", lambda record: record["c"])
    assert cells.read({"c": []}) is None
    assert cells.read({"c": first_call({})}) is None  # no such counter
    assert cells.read({"c": first_call(
        {"k3.tiles_copied": [torch.tensor(5)]})}) is None
    counted = {"dda.cells": [torch.tensor(2000), torch.tensor(500)]}
    assert cells.read({"c": first_call(counted, frames=0)}) is None
    assert cells.read({"c": first_call(counted)}) == 250.0


@pytest.mark.cuda
def test_dda_cells_in_replayed_graphs_on_the_card():
    """The tiny world's captured rollout on the card: the counter gains
    inside the graph replays what an eager call from a copy of the same
    state with the same draws counts, both end on the same bits, and the
    reference follows the captured call to 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    fw = compile_world(parse_config(YAML), device=dev)
    state = fw.init()
    commands = _commands(TICKS, dev)
    state, _ = fw.rollout_cadence(state, TICKS, commands=commands,
                                  noise=UpdateNoise(*_draws(1)))
    draws = _draws(2)
    copy = state._replace(
        pose=state.pose.clone(), accum_left=state.accum_left.clone(),
        accum_right=state.accum_right.clone(),
        grid=state.grid._replace(**{n: getattr(state.grid, n).clone()
                                    for n in ("poses", "grids", "weights",
                                              "best_pose", "best_idx",
                                              "ancestors")}))
    before_host = _copy(copy)
    counter = trace.device_counter("dda.cells", dev)
    before = int(counter)
    state, out = fw.rollout_cadence(state, TICKS, commands=commands,
                                    noise=UpdateNoise(*draws))
    torch.cuda.synchronize()
    rec = trace.calls()[-1]
    assert rec["counts"].get(capture.REUSED)
    replayed = sum(int(t) for t in rec["device"]["dda.cells"])
    assert replayed == int(counter) - before > 0
    after_host = _copy(state)
    host = {"pose": out.pose.cpu().numpy(),
            "grid_pose": out.grid_pose.cpu().numpy(),
            "n_eff": out.n_eff.cpu().numpy()}
    before = int(counter)
    eager, out_e = fw.rollout_cadence(copy, TICKS, commands=commands,
                                      noise=UpdateNoise(*draws),
                                      capture=False)
    torch.cuda.synchronize()
    assert int(counter) - before == replayed
    assert torch.equal(out.grid_pose, out_e.grid_pose)
    assert torch.equal(state.grid.grids, eager.grid.grids)
    values = dda.follow_and_compare(YAML, {}, before_host, after_host, host,
                                    draws, *SPEEDS, TICKS, dev)
    assert values == {"pose_gap": 0.0, "n_eff_gap": 0.0, "map_gap": 0.0}
    assert not math.isnan(float(out.n_eff.min()))
