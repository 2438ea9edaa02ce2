"""The ``grid_slam_config3`` benchmark configuration's plain reference for
tile-pool maps (``h100bench/reference/tiled.py``) against the port's
tiled grid SLAM, the ``tiled_rollout`` driver that runs the
``config3.tiled`` cell, K3's count (``h100bench/roofline/k3.py``) and
the port's device counter ``k3.tiles_copied`` (``ops/tiles.py``).

On the CPU: ``grid_slam_config3.yaml``'s world at 64 particles on 10 x 10 m
maps at 0.05 m with the tile pool pinned, run by the frame program without
graphs over several resamples, against the reference from the same state
and draws; the tiny ``tiled`` cell of ``h100bench/tests/fixtures`` run
whole through the harness; three planted faults in the copy-on-write
storage (a shared tile written in place, a table relabel dropped, a
privatized band written to another fresh tile), each of which turns
``correct`` false; the float8 control, which fails its limits.  The
``cuda`` case counts the bands privatized inside the replayed graphs of
the full config-3 pool on the card:

    python -m pytest tests/test_torch_tiled_reference.py -q --noconftest -m cuda
"""

from __future__ import annotations

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
from h100bench import compare, control, harness  # noqa: E402
from h100bench.drivers import tiled_rollout  # noqa: E402
from h100bench.reference import tiled  # noqa: E402
from h100bench.reference import world as ref_world  # noqa: E402
from h100bench.roofline import k1, k3, peaks  # noqa: E402
from slamrs_tpu_torch.core.types import Command  # noqa: E402
from slamrs_tpu_torch.graph import capture  # noqa: E402
from slamrs_tpu_torch.graph.compile import compile_world  # noqa: E402
from slamrs_tpu_torch.graph.config import parse_config  # noqa: E402
from slamrs_tpu_torch.models.gridslam import UpdateNoise  # noqa: E402
from slamrs_tpu_torch.ops import tiles  # noqa: E402
from slamrs_tpu_torch.ops.grid import GridSpec2D  # noqa: E402
from slamrs_tpu_torch.utils import trace  # noqa: E402

CONFIG3_YAML = (ROOT / "h100bench" / "configs"
                / "grid_slam_config3.yaml").read_text()
# config 3's world at 64 particles on 10 x 10 m maps, the tile pool pinned
YAML = (CONFIG3_YAML
        .replace("position: [-25.0, -25.0]", "position: [-5.0, -5.0]")
        .replace("width: 50.0", "width: 10.0")
        .replace("height: 50.0", "height: 10.0")
        .replace("n_particles: 1024", "n_particles: 64")
        .replace('grid_dtype: "bfloat16"',
                 'grid_dtype: "bfloat16"\n    resample_cow: "tiled"'))
CELL = "tiny.tiled"
CELLS = {CELL: ("tiny_tiled", "rollout_60")}
LIMITS = json.loads((fixture_bench.FIXTURES / "workloads" / f"{CELL}.json")
                    .read_text())["limits"]
TICKS = 60  # 10 scans a call
SPEEDS = (0.05, 0.08)
P = 64


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
    return tiled_rollout.world_to_host(state,
                                       tiled_rollout.host_buffers(state))


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
    values = tiled.follow_and_compare(YAML, {}, before, after, host, draws,
                                      *SPEEDS, TICKS, "cpu")
    got = compare.compared(values, LIMITS)
    correct = all(v["value"] <= v["limit"] for v in got.values())
    return state, outs.n_eff, values, correct


def test_port_follows_the_tiled_reference_over_resamples():
    """Three carried calls of 10 scans from a fresh pool: the filter
    resamples several times, and every frame's poses and N_eff, and the
    materialized maps, poses and weights after each call agree with the
    reference within the cell's limits."""
    fw, state = _world()
    assert state.grid.tile_table is not None
    resamples = 0
    for seed in range(3):
        state, n_eff, values, correct = _checked_call(fw, state,
                                                      _draws(seed))
        assert correct, values
        assert values["pose_gap"] == 0.0 and values["map_gap"] == 0.0
        resamples += int((n_eff <= 0.5 * P).sum())
    assert resamples >= 3
    # the slots read shared tiles: a resample relabelled the table
    table = state.grid.tile_table[state.grid.ancestors.long()]
    assert table.unique().numel() < table.numel()


def test_materialize_reads_each_slot_through_its_lineage():
    pool = torch.arange(5 * 2 * 3, dtype=torch.float32).reshape(5, 2, 3)
    table = torch.tensor([[1, 2], [3, 4], [0, 0]], dtype=torch.int32)
    anc = torch.tensor([1, 1, 2], dtype=torch.int32)
    dense = tiled.materialize(pool, table, anc, rows=3)
    assert dense.shape == (3, 3, 3)
    assert torch.equal(dense[0], torch.cat([pool[3], pool[4]])[:3])
    assert torch.equal(dense[1], dense[0])
    assert torch.equal(tiled.materialize(pool, table, anc, 3, 2, 3)[0],
                       pool[0][[0, 1, 0]])


@pytest.mark.parametrize("trace_on", [False, True])
def test_tiny_tiled_cell_runs_correct_on_the_cpu(tmp_path, trace_on):
    bench = harness.Bench(fixture_bench.make_root(tmp_path, CELLS))
    result = harness.run_cell(bench, CELL, 2 ** 33 + 7, 0.4, trace_on,
                              device="cpu")
    assert result["correct"], result["compared"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["compared"]) == {"pose_gap", "n_eff_gap", "map_gap"}
    metrics = {n: v["value"] for n, v in result["metrics"].items()}
    if trace_on:
        assert metrics["k3_tiles_copied_per_frame"] > 0
        assert metrics["frame_program_reuse_share"] == 1.0
        assert metrics["frame_capture_ms_per_call"] == 0.0
        # no kernel runs on the CPU: the device readers find nothing
        assert "k3_roofline" not in metrics
        assert "k1_roofline" not in metrics
    else:
        assert {"setup_s", "world_ticks_per_s"} <= set(metrics)


def test_tiled_driver_refuses_maps_that_are_not_a_tile_pool(tmp_path):
    root = fixture_bench.make_root(tmp_path, CELLS)
    yaml = root / "h100bench" / "configs" / "tiny_tiled.yaml"
    yaml.write_text(yaml.read_text().replace('resample_cow: "tiled"\n', ""))
    bench = harness.Bench(root)
    with pytest.raises(ValueError, match="not a tile pool"):
        harness.run_cell(bench, CELL, 3, 0.2, False, device="cpu")


def test_profile_records_the_bands_privatized_between_start_and_stop():
    """The driver's profile wrapper reads ``k3.tiles_copied`` at start and
    stop, outside the profile, into the summary."""
    trace.reset()
    counter = trace.device_counter("k3.tiles_copied", "cpu")

    class Fake:
        summary = None

        def start(self):
            pass

        def stop(self, **counts):
            self.summary = dict(counts)
            return self.summary

    counter.add_(5)
    prof = tiled_rollout._CountingProfile(Fake(), torch.device("cpu"))
    prof.start()
    counter.add_(37)
    assert prof.stop(frames=3)["tiles_copied"] == 37
    assert prof.summary == {"frames": 3, "tiles_copied": 37}


# --- planted faults -------------------------------------------------------

def shared_tile_written_in_place(monkeypatch):
    """The plan hands out no fresh tile: a shared band is written where
    it lies (copy on write skipped)."""
    real = tiles.tiled_plan

    def in_place(table, t0, n_phys, kspan=2):
        src, _, _ = real(table, t0, n_phys, kspan)
        return src, src.clone(), table
    monkeypatch.setattr(tiles, "tiled_plan", in_place)


def relabel_dropped(monkeypatch):
    """The pending lineage is not applied to the table."""
    real = tiles.plan_step

    def unrelabelled(*a, **k):
        k.pop("ancestors", None)
        return real(*a[:11], **k)
    monkeypatch.setattr(tiles, "plan_step", unrelabelled)


def band_to_another_fresh_tile(monkeypatch):
    """Each privatized band is written to the next particle's fresh tile,
    while the table names its own."""
    real = tiles.plan_step

    def crossed(*a, **k):
        step = real(*a, **k)
        dst = step.dst.reshape(-1).clone()
        fresh = torch.nonzero(dst != step.src.reshape(-1)).reshape(-1)
        dst[fresh] = dst[fresh.roll(1)]
        return step._replace(dst=dst.reshape(step.dst.shape))
    monkeypatch.setattr(tiles, "plan_step", crossed)


FAULTS = [shared_tile_written_in_place, relabel_dropped,
          band_to_another_fresh_tile]


@pytest.mark.parametrize("fault", FAULTS)
def test_fault_in_the_tile_pool_makes_correct_false(monkeypatch, fault):
    fw, state = _world()
    fault(monkeypatch)
    results = []
    for seed in range(2):  # a relabel shows after the first resample
        state, _, values, correct = _checked_call(fw, state, _draws(seed))
        results.append((correct, values))
    assert not all(c for c, _ in results), results


@pytest.mark.parametrize("fault", [shared_tile_written_in_place,
                                   band_to_another_fresh_tile])
def test_fault_in_the_tiny_cell_makes_correct_false(tmp_path, monkeypatch,
                                                    fault):
    bench = harness.Bench(fixture_bench.make_root(tmp_path, CELLS))
    fault(monkeypatch)
    result = harness.run_cell(bench, CELL, 2 ** 33 + 1, 0.3, False,
                              device="cpu")
    assert not result["correct"], result["compared"]


def test_float8_control_fails_its_limits(tmp_path):
    bench = harness.Bench(fixture_bench.make_root(tmp_path, CELLS))
    got = control.readings(bench, CELL, 2 ** 32 + 5, 0.2, True,
                           device="cpu")
    lim = bench.workload_params(CELL)["limits"]
    assert all(got["sound"][k] <= v for k, v in lim.items()), got
    assert any(got["control"][k] > v for k, v in lim.items()), got


# --- K3's count and the counter ---------------------------------------------

def _brute_disc_cells(rows, cols, resolution, max_range_m, samples=16):
    """Cells whose centres lie within range of the centre, counted one by
    one, averaged over centres spread over the map's middle cell."""
    r = max_range_m / resolution
    total = 0
    for a, b in itertools.product(range(samples), repeat=2):
        cx = cols // 2 + (a + 0.5) / samples
        cy = rows // 2 + (b + 0.5) / samples
        total += sum((j + 0.5 - cx) ** 2 + (i + 0.5 - cy) ** 2 <= r * r
                     for i in range(rows) for j in range(cols))
    return total / samples ** 2


@pytest.mark.parametrize("launches,copied", [(3, 0), (3, 50), (2, 200)])
def test_k3_count_equals_a_brute_force_count(launches, copied):
    sizes = dict(particles=40, rows=24, cols=30, resolution=0.1,
                 max_range_m=0.5, itemsize=2)
    n = launches * sizes["particles"]
    cells = _brute_disc_cells(24, 30, 0.1, 0.5)
    band = sum(1 for _ in itertools.product(
        range(k3.band_rows(0.1, 0.5)), range(30)))
    owned = max(0, n - copied)
    want_bytes = (copied * band * 2 + owned * cells * 2 * 2
                  + n * (3 * 4 + 4) + launches * 360 * (4 + 1 + 1))
    want_flops = n * cells * k1.CELL_FLOPS + n * 360 * k1.BEAM_FLOPS
    nbytes, flops = k3.window_work(sizes, launches, copied)
    assert nbytes == pytest.approx(want_bytes, rel=1e-12)
    assert flops == pytest.approx(want_flops, rel=1e-12)
    assert k3.least_seconds(sizes, launches, copied) == max(
        nbytes / peaks.HBM_BYTES_PER_S, flops / peaks.FP32_FLOPS_PER_S)


@pytest.mark.parametrize("extent,resolution", [(50.0, 0.05), (10.0, 0.05),
                                               (10.0, 0.1), (20.0, 0.02)])
def test_k3_band_rows_are_the_ports_tile_height(extent, resolution):
    spec = GridSpec2D(-extent / 2, -extent / 2, extent, extent, resolution)
    pool, _ = tiles.init_tiled(8, spec, 1.0, device="meta")
    assert k3.band_rows(resolution, 1.0) == pool.shape[1] \
        == tiles.tile_geometry(spec, 1.0)[0]


def test_k3_count_at_config3_is_bound_by_band_copies():
    """~2,000 bands a frame (nearly every particle privatizes both bands
    after a resample) dominate: 56 x 1,000 bf16 cells written a band."""
    sizes = dict(particles=1024, rows=1000, cols=1000, resolution=0.05,
                 max_range_m=1.0, itemsize=2)
    nbytes, _ = k3.window_work(sizes, 1, 2000)
    assert nbytes == 2000 * 56 * 1000 * 2 + 1024 * 16 + 360 * 6
    assert k3.least_seconds(sizes, 1, 2000) == pytest.approx(
        nbytes / peaks.HBM_BYTES_PER_S)


def _reader(name):
    return harness.load_module(ROOT / "h100bench" / "metrics" / f"{name}.py",
                               f"test_tiled_metric_{name}")


def test_k3_readers_say_nothing_without_k3_or_its_counter():
    summary = {"window_s": 1.0, "busy_s": 0.5, "frames": 15,
               "kernels": {"fused_update_kernel": {"count": 15,
                                                   "seconds": 0.01}}}
    sizes = dict(particles=1024, rows=1000, cols=1000, resolution=0.05,
                 max_range_m=1.0, itemsize=2)
    record = {"trace": summary, "k3_sizes": sizes}
    assert _reader("k3_roofline").read(record) is None
    assert _reader("k3_device_us_per_frame").read(record) is None
    summary["kernels"]["void fused_update_tiled_kernel<bf16>"] = {
        "count": 15, "seconds": 15 * 125e-6}
    assert _reader("k3_device_us_per_frame").read(record) == \
        pytest.approx(125.0)
    assert _reader("k3_roofline").read(record) is None  # no counter
    summary["tiles_copied"] = 15 * 1600
    share = _reader("k3_roofline").read(record)
    assert share == pytest.approx(
        k3.least_seconds(sizes, 15, 15 * 1600) / (15 * 125e-6) * 100)
    assert 0 < share <= 100
    summary["kernels"]["void fused_update_tiled_kernel<bf16>"]["count"] = 14
    assert _reader("k3_roofline").read(record) is None  # a launch lost
    assert _reader("k3_tiles_copied_per_frame").read({"calls": 0}) is None


def test_k3_counter_adds_the_plans_fresh_count():
    trace.reset()
    counter = trace.device_counter("k3.tiles_copied", "cpu")
    g = torch.Generator().manual_seed(3)
    table = torch.zeros((6, 4), dtype=torch.int32)
    n_phys = 6 * 4 + 2 * 6
    for _ in range(5):
        t0 = torch.randint(0, 3, (6,), generator=g, dtype=torch.int32)
        src, dst, new_table = tiles.tiled_plan(table, t0, n_phys)
        before = int(counter)
        rc = torch.bincount(table.reshape(-1).long(), minlength=n_phys)
        fresh = rc[src.long()] != 1
        tiles.tiled_plan(table, t0, n_phys)
        assert int(counter) - before == int(fresh.sum()) \
            == int((dst != src).sum())
        table = new_table[torch.randint(0, 6, (6,), generator=g)]


def test_k3_counter_gains_each_update_of_a_world():
    """Over a carried call, ``k3.tiles_copied`` gains in the call's record
    what the plans privatized, ~2 bands a particle on the first frame of
    a fresh pool (every band is the shared zero tile)."""
    fw, state = _world()
    trace.reset()
    counter = trace.device_counter("k3.tiles_copied", "cpu")
    state, outs = capture.run_program(fw, state, TICKS, 0, _commands(TICKS),
                                      noise=UpdateNoise(*_draws(4)),
                                      graphs=False)
    rec = trace.calls()[-1]
    gained = sum(int(t) for t in rec["device"]["k3.tiles_copied"])
    assert gained == int(counter) >= 2 * P
    assert rec["counts"]["rollout.frames"] == outs.n_eff.shape[0]


@pytest.mark.cuda
def test_k3_tiles_copied_in_replayed_graphs_on_the_card():
    """The captured rollout of ``grid_slam_config3.yaml`` on its full
    2.35 GB tile pool: the counter gains inside the graph replays what an
    eager call from a copy of the same state with the same draws counts,
    and both calls end on the same pool, table and poses."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    fw = compile_world(parse_config(CONFIG3_YAML), device=dev)
    state = fw.init()
    assert list(state.grid.grids.shape) == [20480, 56, 1024]
    commands = _commands(900, dev)
    frames = ref_world.n_frames_max(900, 0.2)
    g = torch.Generator(device=dev).manual_seed(11)

    def noise():  # injected draws are host arrays
        return UpdateNoise(*(x.cpu().numpy() for x in (
            torch.randn((frames, 1024), generator=g, device=dev),
            torch.randn((frames, 1024), generator=g, device=dev),
            torch.rand((frames, 1), generator=g, device=dev))))

    state, _ = fw.rollout_cadence(state, 900, commands=commands,
                                  noise=noise())
    draws = noise()
    # every tensor of the kept program's state is a static buffer that
    # the next call writes: the eager side starts from clones of them all
    copy = state._replace(
        pose=state.pose.clone(), accum_left=state.accum_left.clone(),
        accum_right=state.accum_right.clone(),
        grid=state.grid._replace(**{n: getattr(state.grid, n).clone()
                                    for n in state.grid._fields}))
    counter = trace.device_counter("k3.tiles_copied", dev)
    before = int(counter)
    state, out = fw.rollout_cadence(state, 900, commands=commands,
                                    noise=draws)
    torch.cuda.synchronize()
    rec = trace.calls()[-1]
    assert rec["counts"].get(capture.REUSED)
    replayed = sum(int(t) for t in rec["device"]["k3.tiles_copied"])
    assert replayed == int(counter) - before > 0
    frames_run = rec["counts"]["rollout.frames"]
    assert 500 <= replayed / frames_run <= 2 * 1024
    before = int(counter)
    eager, out_e = fw.rollout_cadence(copy, 900, commands=commands,
                                      noise=draws, capture=False)
    torch.cuda.synchronize()
    assert int(counter) - before == replayed
    assert torch.equal(out.grid_pose, out_e.grid_pose)
    assert torch.equal(state.grid.tile_table, eager.grid.tile_table)
    assert torch.equal(state.grid.grids, eager.grid.grids)
    assert not math.isnan(float(out.n_eff.min()))
