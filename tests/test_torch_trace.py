"""The port's spans, calls and counters (``slamrs_tpu_torch/utils/trace.py``)
and where the captured rollout opens them (``graph/capture.py``,
``ops/cow.py``).

A span's self time is its duration less its children's; a call closes
into a bounded record of the spans and counts under it; a span opens a
``record_function`` range only while a profiler records.  On the CPU the
frame program (``run_program(graphs=False)``) makes a record whose eager
frames and frames agree with its ``ProgramStats``, and a fleet's device
counter of the maps K2 copies agrees with the copy plans' ancestors.  The
``cuda`` case (a device counter first used inside a capture raises) runs
on the card:

    python -m pytest tests/test_torch_trace.py -q --noconftest -m cuda
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from slamrs_tpu_torch.graph import capture  # noqa: E402
from slamrs_tpu_torch.graph import compile as tcompile  # noqa: E402
from slamrs_tpu_torch.models.gridslam import GridSlamConfig  # noqa: E402
from slamrs_tpu_torch.models.simulator import Scene, SimParams  # noqa: E402
from slamrs_tpu_torch.ops import cow  # noqa: E402
from slamrs_tpu_torch.utils import trace  # noqa: E402

SCRIPT = [[4.0, 0.05, 0.08], [8.0, 0.08, 0.05], [999.0, 0.06, 0.06]]


@pytest.fixture(autouse=True)
def fresh_trace():
    trace.reset()
    yield
    trace.reset()


def _closes(record) -> float:
    """A call's duration less its self time and every span's self time:
    0 when every span's time is accounted for once."""
    return record["seconds"] - record["self_seconds"] - sum(
        s["self_seconds"] for s in record["spans"].values())


def test_self_time_is_the_duration_less_the_children():
    with trace.span("t/parent") as parent:
        time.sleep(0.002)
        with trace.span("t/child") as a:
            time.sleep(0.003)
            with trace.span("t/grandchild") as g:
                time.sleep(0.001)
        with trace.span("t/child") as b:
            time.sleep(0.001)
    assert parent.self_seconds + a.seconds + b.seconds == pytest.approx(
        parent.seconds, abs=1e-9)
    assert a.self_seconds + g.seconds == pytest.approx(a.seconds, abs=1e-9)
    assert g.self_seconds == g.seconds >= 0.001
    assert parent.self_seconds >= 0.002
    st = trace.all_stats()
    assert st["t/child"].sample_count == 2
    assert st["t/child"].total_seconds == pytest.approx(a.seconds
                                                        + b.seconds)
    assert st["t/child"].self_seconds == pytest.approx(
        a.seconds + b.seconds - g.seconds)
    assert st["t/parent"].mean == pytest.approx(parent.seconds * 1e3)


def test_calls_make_bounded_records_and_spans_outside_make_none():
    with trace.span("t/outside"):
        trace.count("t/outside_count", 3)
    assert trace.calls() == []
    assert trace.counts() == {"t/outside_count": 3}
    with trace.call("t/call") as c:
        with trace.span("t/a"):
            trace.count("t/frames", 2)
            with trace.call("t/inner"):  # a span of the open call
                with trace.span("t/a"):
                    pass
        trace.count("t/frames")
    (rec,) = trace.calls()
    assert rec["name"] == "t/call" and rec["seconds"] == c.seconds
    assert rec["self_seconds"] == c.self_seconds
    assert rec["counts"] == {"t/frames": 3}
    assert trace.counts() == {"t/outside_count": 3, "t/frames": 3}
    assert {n: s["count"] for n, s in rec["spans"].items()} == {
        "t/a": 2, "t/inner": 1}
    assert abs(_closes(rec)) < 1e-9
    for _ in range(trace.MAX_CALLS + 3):
        with trace.call("t/many"):
            pass
    recs = trace.calls()
    assert len(recs) == trace.MAX_CALLS
    assert all(r["name"] == "t/many" for r in recs)


def test_a_span_opens_a_profiler_range_only_while_one_records(monkeypatch):
    opened = []
    real = torch.profiler.record_function

    def counting(name):
        opened.append(name)
        return real(name)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    with trace.span("t/quiet"):
        torch.ones(3).sum()
    assert opened == []
    with torch.profiler.profile() as prof:
        with trace.call("t/profiled_call"):
            with trace.span("t/profiled"):
                torch.ones(3).sum()
    assert opened == ["t/profiled_call", "t/profiled"]
    keys = {e.key for e in prof.key_averages()}
    assert {"t/profiled_call", "t/profiled"} <= keys


@pytest.mark.parametrize("name", ["cudaLaunchKernel", "cuGraphLaunch",
                                  "frame.GraphLaunch", "x.Memcpy",
                                  "x.MemsetAsync", "my.LaunchKernel"])
def test_span_names_that_read_as_host_cuda_calls_raise(name):
    with pytest.raises(ValueError, match="host CUDA call"):
        with trace.span(name):
            pass


def test_device_counters_add_on_the_device_and_reset_in_place():
    c = trace.device_counter("t/dev", "cpu")
    c.add_(torch.tensor(4, dtype=torch.int32))
    assert trace.device_counter("t/dev", torch.device("cpu")) is c
    with trace.call("t/one"):
        c.add_(3)
    with trace.call("t/two"):
        c.add_(5)
    gains = [int(r["device"]["t/dev"][0]) for r in trace.calls()]
    assert gains == [7, 5]  # the first call's counts what came before it
    assert trace.device_counts()["t/dev"] == 12
    trace.reset()
    assert trace.device_counter("t/dev", "cpu") is c and int(c) == 0


def _world(device="cpu", worlds=(), **grid):
    cfg = GridSlamConfig(position_x=-2.0, position_y=-2.0, width=4.0,
                         height=4.0, resolution=0.05, n_particles=8,
                         max_scan_range=1.0, integrate="fused",
                         resample_neff_frac=0.5, grid_dtype="bfloat16")
    cfg = dataclasses.replace(cfg, **grid)
    rects = [(-1.0, -1.0, 2.0, 2.0), (-0.1, -0.4, 0.5, 0.1),
             (-0.6, 0.4, 0.2, 0.5)]
    fw = tcompile.make_fused(
        scene=Scene.build(rects=rects, lines=[(-0.6, -0.4, 0.2, 0.4)],
                          device=device),
        params=SimParams.make(wheel_base=0.1, update_period=0.2,
                              scanner_range=1.0),
        grid_config=cfg, control_script=SCRIPT, device=device)
    return fw, fw.init(worlds)


@pytest.mark.parametrize("ticks", [40, 43])  # 40 ends on idle ticks
def test_frame_program_record_agrees_with_its_stats(ticks):
    fw, state = _world()
    _, outs = capture.run_program(fw, state, ticks, seed=2, graphs=False)
    (rec,) = trace.calls()
    stats = fw.capture_stats
    frames = int(outs.fired.shape[0])
    trailing = int(ticks == 40)  # the trailing idle ticks' one run
    assert rec["name"] == "rollout_cadence"
    assert rec["counts"] == {"rollout.frames": frames}
    spans = rec["spans"]
    assert spans["frame.eager"]["count"] == stats.eager
    assert stats.eager == frames + trailing  # without graphs every run
    assert spans["frame.fill"]["count"] == frames - 1 + trailing
    assert ("rollout.ticks" in spans) == bool(trailing)
    assert stats.ticks is None
    assert "graph.launch" not in spans and "frame.capture" not in spans
    assert abs(_closes(rec)) <= 1e-6 * rec["seconds"]
    assert rec["self_seconds"] > 0


def test_tick_program_record_counts_ticks():
    fw, state = _world()
    capture.run_ticks(fw, state, 20, seed=2, graphs=False)
    (rec,) = trace.calls()
    stats = fw.capture_stats
    assert rec["name"] == "rollout"
    assert rec["counts"] == {"rollout.frames": 20}
    assert rec["spans"]["frame.eager"]["count"] == stats.eager
    assert abs(_closes(rec)) <= 1e-6 * rec["seconds"]


def test_k2_counter_counts_the_maps_each_plan_copies(monkeypatch):
    ancestors = []
    real = cow.cow_plan

    def plan(anc):
        ancestors.append(anc.clone())
        return real(anc)

    monkeypatch.setattr(cow, "cow_plan", plan)
    fw, state = _world(worlds=(3,), n_particles=6, resample_cow=True,
                       fused_resident=False)
    for seed in (1, 2):
        state, _ = capture.run_program(fw, state, 60, seed=seed,
                                       graphs=False)
    assert ancestors
    # a plan copies every child after an ancestor's first
    want = sum(a.numel() - np.unique(a.numpy()).size for a in ancestors)
    assert want > 0
    assert trace.device_counts()["k2.maps_copied"] == want
    gains = [sum(int(t) for t in r["device"]["k2.maps_copied"])
             for r in trace.calls()]
    assert sum(gains) == want and all(g >= 0 for g in gains)


# --- on the card --------------------------------------------------------


@pytest.mark.cuda
def test_device_counter_first_used_inside_a_capture_raises():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    made = trace.device_counter("t/made_before", dev)
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        graph = torch.cuda.CUDAGraph()
        graph.capture_begin()
        try:
            made.add_(1)
            with pytest.raises(RuntimeError, match="inside a CUDA graph"):
                trace.device_counter("t/made_inside", dev)
        finally:
            graph.capture_end()
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    assert int(made) == 3
