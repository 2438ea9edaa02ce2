"""The ``icp_odometry`` benchmark configuration's plain reference
(``h100bench/reference/icp.py``) against the port's ICP odometry, the
check that decides the ``icp.rollout`` cell's ``correct``
(``h100bench/icp_compare.py``), K4's count (``h100bench/roofline/k4.py``)
and the port's device counter ``k4.pairs`` (``ops/icp.py``).

On the CPU: ``compile_world(configs/icp_test.yaml)`` at a 1,024-point map
and 3 iterations, run by the frame program without graphs while its map
fills, against the reference from the same seeded start; the tiny
``icp`` cell of ``h100bench/tests/fixtures`` run whole through the
harness; three planted faults (an ICP iteration dropped, every
correspondence shifted by one lane, an append lost), each of which turns
``correct`` false; the bfloat16 control, which fails its limits.  The
``cuda`` case counts K4's pairs inside the replayed graphs at the full
16,384-point map on the card:

    python -m pytest tests/test_torch_icp_reference.py -q --noconftest -m cuda
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import math
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
for _p in (str(ROOT), str(ROOT / "h100bench" / "tests")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import fixture_bench  # noqa: E402
from h100bench import compare, control, harness, icp_compare  # noqa: E402
from h100bench.drivers import icp_rollout  # noqa: E402
from h100bench.reference import icp as ref_icp  # noqa: E402
from h100bench.reference import world as ref_world  # noqa: E402
from h100bench.roofline import k4, peaks  # noqa: E402
from slamrs_tpu_torch.core.types import Command  # noqa: E402
from slamrs_tpu_torch.graph import capture  # noqa: E402
from slamrs_tpu_torch.graph.compile import compile_world  # noqa: E402
from slamrs_tpu_torch.graph.config import parse_config  # noqa: E402
from slamrs_tpu_torch.models import icp_mapper  # noqa: E402
from slamrs_tpu_torch.ops import icp as ticp  # noqa: E402
from slamrs_tpu_torch.utils import trace  # noqa: E402

YAML = (ROOT / "configs" / "icp_test.yaml").read_text()
CELL = "tiny.icp"
LIMITS = json.loads((fixture_bench.FIXTURES / "workloads" / f"{CELL}.json")
                    .read_text())["limits"]
TICKS = 60  # 10 scans a call
CELLS = {CELL: ("tiny_icp", "rollout_60")}
SPEEDS = (0.05, 0.08)


def _world():
    """``icp_test.yaml``'s world with a 1,024-point map and 3 iterations,
    the port's and the reference's, and a state at a given start."""
    fw = compile_world(parse_config(YAML), device="cpu")
    fw.icp_config = dataclasses.replace(fw.icp_config, capacity=1024,
                                        iterations=3)
    world = icp_compare.reference_world(YAML, {}, "cpu")
    world = world._replace(icp=world.icp._replace(capacity=1024,
                                                  iterations=3))
    state = fw.init()
    return fw, world, state._replace(pose=torch.tensor([0.031, -0.022, 2.4]))


def _commands(n, device="cpu"):
    return Command(*(torch.full((n,), v, dtype=torch.float32, device=device)
                     for v in SPEEDS))


def _checked_call(fw, world, state):
    """One frame-program call from ``state`` held against the reference:
    ``(state after, the compared numbers, correct)``."""
    before = icp_compare.world_to_host(state,
                                       icp_compare.host_buffers(state))
    before = {**before, "icp": {k: v.clone() for k, v in
                                before["icp"].items()}}
    state, outs = capture.run_program(fw, state, TICKS, 0, _commands(TICKS),
                                      graphs=False)
    after = icp_compare.world_to_host(state, icp_compare.host_buffers(state))
    host = {"pose": outs.pose.numpy(), "icp_pose": outs.icp_pose.numpy()}
    values = icp_compare.follow_and_compare(
        YAML, {}, before, after, host, *SPEEDS, TICKS, "cpu")
    got = compare.compared(values, LIMITS)
    return state, values, all(v["value"] <= v["limit"] for v in got.values())


@pytest.fixture
def small_reference(monkeypatch):
    fw, world, state = _world()
    monkeypatch.setattr(icp_compare, "reference_world",
                        lambda yaml_text, workload, device: world)
    return fw, world, state


def test_port_follows_the_reference_while_the_map_fills(small_reference):
    """Three carried calls of 10 scans from a fresh map: the map fills in
    the first, and every frame's true and ICP pose, the map and its count
    agree with the reference within the cell's limits."""
    fw, world, state = small_reference
    counts = []
    for _ in range(3):
        state, values, correct = _checked_call(fw, world, state)
        assert correct, values
        counts.append(int(state.icp.count))
    assert counts[0] == counts[-1] == 1024


def test_reference_update_is_the_mappers_update():
    """One mapper update of the port and of the reference, from a state
    with points in its map, give the same pose and the same map."""
    fw, world, state = _world()
    icp_state = state.icp
    ref_state = ref_icp.IcpState(*(getattr(icp_state, n).clone()
                                   for n in ref_icp.IcpState._fields))
    from slamrs_tpu_torch.models import simulator as sim

    g = torch.Generator().manual_seed(4)
    for _ in range(4):
        pose = torch.cat([torch.rand(2, generator=g) * 0.4 - 0.2,
                          torch.rand(1, generator=g) * 6.0 - 3.0])
        scan = sim.lidar_scan(pose, fw.scene, fw.params.scanner_range, 360)
        icp_state, _ = icp_mapper.update(icp_state, scan, fw.icp_config)
        ref_state = ref_icp.update(ref_state,
                                   ref_world.lidar_scan(pose, world),
                                   world.icp)
        assert int(icp_state.count) == int(ref_state.count)
        assert compare.gap(icp_state.pose, ref_state.pose) <= 1e-6
        assert compare.gap(icp_state.points, ref_state.points) <= 1e-6


@pytest.mark.parametrize("trace_on", [False, True])
def test_tiny_icp_cell_runs_correct_on_the_cpu(tmp_path, trace_on):
    bench = harness.Bench(fixture_bench.make_root(tmp_path, CELLS))
    result = harness.run_cell(bench, CELL, 2 ** 33 + 7, 0.4, trace_on,
                              device="cpu")
    assert result["correct"], result["compared"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["compared"]) == {"pose_gap", "map_gap"}
    metrics = {n: v["value"] for n, v in result["metrics"].items()}
    if trace_on:  # the tiny cell's K4: 3 iterations x 360 x 1,024 a frame
        assert metrics["k4_pairs_per_frame"] == 3 * 360 * 1024
        # the profiled call and the calls after it that the span readers'
        # median needs
        assert result["attempted"] >= 1 + icp_rollout.CALLS_AFTER_PROFILE
        assert metrics["frame_program_reuse_share"] == 1.0
        assert metrics["frame_capture_ms_per_call"] == 0.0
    else:
        assert {"setup_s", "world_ticks_per_s"} <= set(metrics)


def test_icp_driver_refuses_a_map_that_is_not_full(tmp_path, monkeypatch):
    bench = harness.Bench(fixture_bench.make_root(tmp_path, CELLS))
    real = icp_mapper.IcpMapConfig

    def roomy(*a, **k):
        return real(*a, **{**k, "capacity": 1 << 16})
    monkeypatch.setattr(icp_mapper, "IcpMapConfig", roomy)
    with pytest.raises(RuntimeError, match="fewer than its capacity"):
        harness.run_cell(bench, CELL, 3, 0.2, False, device="cpu")


# --- planted faults -------------------------------------------------------

def iteration_dropped(monkeypatch):
    """ICP stops one iteration short."""
    real = ticp.icp_point_to_normal

    def short(*a, iterations=10, **k):
        return real(*a, iterations=iterations - 1, **k)
    monkeypatch.setattr(ticp, "icp_point_to_normal", short)


def correspondences_shifted(monkeypatch):
    """Every correspondence is the map lane after the nearest."""
    real = ticp.nearest_neighbors

    def shifted(p, q, q_count):
        idx = real(p, q, q_count)
        return torch.minimum(idx + 1, (q_count[..., None] - 1).clamp_min(0))
    monkeypatch.setattr(ticp, "nearest_neighbors", shifted)


def append_lost(monkeypatch):
    """An update that appends points loses the last of them."""
    real = icp_mapper.update

    def lossy(state, scan, config):
        new, out = real(state, scan, config)
        lost = (out.appended > 0) & (new.count < config.capacity)
        return new._replace(count=new.count - lost.to(new.count.dtype)), out
    monkeypatch.setattr(icp_mapper, "update", lossy)


FAULTS = [iteration_dropped, correspondences_shifted, append_lost]


@pytest.mark.parametrize("fault", FAULTS)
def test_fault_while_the_map_fills_makes_correct_false(small_reference,
                                                       monkeypatch, fault):
    fw, world, state = small_reference
    fault(monkeypatch)
    _, values, correct = _checked_call(fw, world, state)
    assert not correct, values


@pytest.mark.parametrize("fault", [iteration_dropped,
                                   correspondences_shifted])
def test_fault_in_the_tiny_cell_makes_correct_false(tmp_path, monkeypatch,
                                                    fault):
    """At the full map of the cell's window (an append lost shows only
    while the map fills: a full map appends nothing)."""
    bench = harness.Bench(fixture_bench.make_root(tmp_path, CELLS))
    fault(monkeypatch)
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


# --- K4's count and the counter ---------------------------------------------

@pytest.mark.parametrize("problems,beams,points",
                         [(1, 5, 7), (2, 3, 4), (3, 1, 9)])
def test_k4_count_equals_a_brute_force_count(problems, beams, points):
    sizes = dict(problems=problems, beams=beams, points=points)
    pairs, read, written = 0, set(), set()
    for b, i, j in itertools.product(range(problems), range(beams),
                                     range(points)):
        pairs += 1
        read |= {("p", b, i), ("q", b, j)}
        written.add(("idx", b, i))
    nbytes, flops = k4.launch_work(sizes)
    assert flops == pairs * k4.FLOPS_PER_PAIR
    assert nbytes == (sum(k4.POINT_BYTES for _ in read)
                      + k4.INDEX_BYTES * len(written))
    assert k4.least_seconds(sizes) == max(
        nbytes / peaks.HBM_BYTES_PER_S, flops / peaks.FP32_FLOPS_PER_S)


def test_k4_least_time_at_the_mappers_map_is_bound_by_operations():
    sizes = dict(problems=1, beams=360, points=16384)
    assert k4.launch_work(sizes)[1] / k4.FLOPS_PER_PAIR * 10 == 58_982_400
    assert k4.least_seconds(sizes) == pytest.approx(
        360 * 16384 * 6 / peaks.FP32_FLOPS_PER_S)


def _reader(name):
    return harness.load_module(ROOT / "h100bench" / "metrics" / f"{name}.py",
                               f"test_icp_metric_{name}")


def test_k4_readers_say_nothing_without_k4_in_the_trace():
    summary = {"window_s": 1.0, "busy_s": 0.5, "frames": 15,
               "kernels": {"fused_update_kernel": {"count": 15,
                                                   "seconds": 0.01}}}
    record = {"trace": summary,
              "k4_sizes": dict(problems=1, beams=360, points=16384)}
    assert _reader("k4_roofline").read(record) is None
    assert _reader("k4_device_us_per_frame").read(record) is None
    summary["kernels"]["nn_argmin_kernel"] = {"count": 150,
                                              "seconds": 150 * 12e-6}
    share = _reader("k4_roofline").read(record)
    assert share == pytest.approx(
        k4.least_seconds(record["k4_sizes"]) / 12e-6 * 100)
    assert _reader("k4_device_us_per_frame").read(record) == \
        pytest.approx(120.0)
    assert _reader("k4_roofline").read({"trace": summary}) is None


def test_k4_pairs_counter_gains_each_update_on_the_cpu():
    """``iterations x 360 x q_count`` a mapper update, the map's count as
    the update found it (0 on the first scan)."""
    from slamrs_tpu_torch.models import simulator as sim

    trace.reset()
    fw, _, state = _world()
    counter = trace.device_counter("k4.pairs", "cpu")
    icp_state = state.icp
    g = torch.Generator().manual_seed(9)
    for _ in range(6):
        pose = torch.cat([torch.rand(2, generator=g) * 0.4 - 0.2,
                          torch.rand(1, generator=g) * 6.0 - 3.0])
        scan = sim.lidar_scan(pose, fw.scene, fw.params.scanner_range, 360)
        before, found = int(counter), int(icp_state.count)
        icp_state, _ = icp_mapper.update(icp_state, scan, fw.icp_config)
        assert int(counter) - before == 3 * 360 * found


def test_k4_pairs_counter_sums_a_fleet():
    trace.reset()
    counter = trace.device_counter("k4.pairs", "cpu")
    p = torch.zeros(2, 5, 2)
    q = torch.rand(2, 8, 2)
    ticp.icp_point_to_normal(p, torch.ones(2, 5, dtype=torch.bool), q,
                             torch.tensor([3, 8], dtype=torch.int32),
                             torch.zeros(2, 3), iterations=4)
    assert int(counter) == 4 * 5 * (3 + 8)


@pytest.mark.cuda
def test_k4_pairs_counter_in_replayed_graphs_on_the_card():
    """The captured rollout of ``icp_test.yaml`` at its full 16,384-point
    map: the counter gains 10 x 360 x 16,384 a frame inside the graph
    replays, as the eager loop counts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    fw = compile_world(parse_config(YAML), device=dev)
    state = fw.init()
    commands = _commands(900, dev)
    for _ in range(2):  # 300 scans fill the map
        state, _ = fw.rollout_cadence(state, 900, commands=commands)
    assert int(state.icp.count) == 16384
    timer = state.scan_timer
    state, out = fw.rollout_cadence(state, 900, commands=commands)
    torch.cuda.synchronize()
    rec = trace.calls()[-1]
    frames = rec["counts"]["rollout.frames"]
    assert frames == out.fired.shape[0] and rec["counts"].get(capture.REUSED)
    gained = sum(int(t) for t in rec["device"]["k4.pairs"])
    assert gained / frames == 10 * 360 * 16384 == 58_982_400
    fires = fw.fire_schedule(900, timer)[0]
    trailing = int(fires[-1] < 899)  # the trailing idle ticks: one replay
    assert fw.capture_stats.replays == frames + trailing
    assert not math.isnan(float(out.icp_pose.abs().max()))
