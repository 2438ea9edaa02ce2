"""The readers of the port's own spans and counters (``program_calls.py``
and its five metrics): a traced tiny cell on the CPU, synthetic call
records with replays, and a port that keeps no call records."""

from pathlib import Path

import pytest
import torch

from h100bench import harness

METRICS = Path(__file__).resolve().parents[1] / "metrics"
READERS = ("call_eager_ms_per_call", "frame_fill_us_per_replay",
           "graph_launch_us_per_replay", "call_self_ms_per_call",
           "k2_maps_copied_per_frame")


def reader(name):
    return harness.load_module(METRICS / f"{name}.py", f"test_metric_{name}")


@pytest.mark.parametrize("cell,k2", [("tiny.rollout", False),
                                     ("tiny.fleet", True)])
def test_traced_tiny_cell_reports_the_program_readers(bench_root, cell, k2):
    from slamrs_tpu_torch.utils import trace

    trace.reset()
    result = harness.run_cell(bench_root, cell, 5, 0.3, True, device="cpu")
    assert result["correct"]
    metrics = {n: v["value"] for n, v in result["metrics"].items()}
    # the CPU runs the frame program without graphs: eager frames, no
    # replays; K2 only where the fleet resamples by copy on write
    assert metrics["call_eager_ms_per_call"] > 0
    assert metrics["call_self_ms_per_call"] > 0
    assert "frame_fill_us_per_replay" not in metrics
    assert "graph_launch_us_per_replay" not in metrics
    if k2:
        assert metrics["k2_maps_copied_per_frame"] > 0
    else:  # no counter, or one that an earlier fleet made and reset
        assert metrics.get("k2_maps_copied_per_frame", 0) == 0
    calls = [c for c in trace.calls() if c["name"] == "rollout_cadence"]
    n = len(calls) - 1  # the warm-up call came first
    assert n >= 1
    record = {"calls": n}
    for name in READERS:
        assert reader(name).read(record) == metrics.get(name), name


def _call(eager_s, fill_s, launch_s, replays, self_s, copies=None,
          frames=10):
    spans = {"frame.eager": {"count": 2, "seconds": eager_s},
             "frame.fill": {"count": replays + 1, "seconds": fill_s}}
    if replays:
        spans["graph.launch"] = {"count": replays, "seconds": launch_s}
    return {"name": "rollout_cadence", "seconds": 1.0,
            "self_seconds": self_s, "spans": spans,
            "counts": {"rollout.frames": frames},
            "device": {} if copies is None else
            {"k2.maps_copied": [torch.tensor(c) for c in copies]}}


def test_readers_take_the_window_calls_median(monkeypatch):
    from slamrs_tpu_torch.utils import trace

    calls = [_call(9.0, 9.0, 9.0, 9, 9.0, copies=[900]),  # warm-up
             {"name": "rollout", "spans": {}},
             _call(0.010, 0.0009, 0.0018, 9, 0.004, copies=[30, 12]),
             _call(0.030, 0.0009, 0.0027, 9, 0.002, copies=[1]),
             _call(0.020, 0.0018, 0.0009, 9, 0.003, copies=[2])]
    monkeypatch.setattr(trace, "calls", lambda: calls)
    record = {"calls": 3}
    got = {n: reader(n).read(record) for n in READERS}
    assert got["call_eager_ms_per_call"] == pytest.approx(20.0)
    assert got["frame_fill_us_per_replay"] == pytest.approx(100.0)
    assert got["graph_launch_us_per_replay"] == pytest.approx(200.0)
    assert got["call_self_ms_per_call"] == pytest.approx(3.0)
    assert got["k2_maps_copied_per_frame"] == pytest.approx(4.2)
    assert all(reader(n).read({"calls": 0}) is None for n in READERS)


def test_readers_say_nothing_without_call_records(monkeypatch):
    from slamrs_tpu_torch.utils import trace

    monkeypatch.delattr(trace, "calls")
    for name in READERS:
        assert reader(name).read({"calls": 4}) is None, name
