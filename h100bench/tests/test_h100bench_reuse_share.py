"""``frame_program_reuse_share``: the share of a window's rollout calls
that ran on the frame program kept from the call before (the port's
counter ``rollout.program_reused``), on synthetic call records, on a
traced tiny cell on the CPU, and on a port that keeps no frame
program."""

from pathlib import Path

import pytest

from h100bench import harness

METRICS = Path(__file__).resolve().parents[1] / "metrics"
NAME = "frame_program_reuse_share"


def reader():
    return harness.load_module(METRICS / f"{NAME}.py", f"test_metric_{NAME}")


def _call(reused, frames=10):
    counts = {"rollout.frames": frames}
    if reused:
        counts["rollout.program_reused"] = 1
    return {"name": "rollout_cadence", "seconds": 1.0, "self_seconds": 0.1,
            "spans": {"graph.launch": {"count": frames, "seconds": 1e-3}},
            "counts": counts, "device": {}}


def test_share_of_the_window_calls(monkeypatch):
    from slamrs_tpu_torch.utils import trace

    calls = [_call(False),  # the warm-up's build
             {"name": "rollout", "spans": {}, "counts": {}},
             _call(False), _call(True), _call(True), _call(True)]
    monkeypatch.setattr(trace, "calls", lambda: calls)
    read = reader().read
    assert read({"calls": 4}) == pytest.approx(0.75)
    assert read({"calls": 3}) == 1.0
    assert read({"calls": 0}) is None


def test_nothing_to_read_without_a_kept_program_or_records(monkeypatch):
    """A port that keeps no frame program names no counter
    (``capture.REUSED``), and one that keeps no call records gives no
    calls: the reader says nothing, whatever the calls count."""
    from slamrs_tpu_torch.graph import capture
    from slamrs_tpu_torch.utils import trace

    monkeypatch.setattr(trace, "calls", lambda: [_call(True)] * 3)
    read = reader().read
    assert read({"calls": 2}) == 1.0
    monkeypatch.delattr(capture, "REUSED")
    assert read({"calls": 2}) is None
    monkeypatch.undo()
    monkeypatch.delattr(trace, "calls")
    assert read({"calls": 2}) is None


@pytest.mark.parametrize("cell", ["tiny.rollout", "tiny.scan30hz",
                                  "tiny.fleet"])
def test_traced_tiny_cell_reuses_after_the_warm_up(bench_root, cell):
    """Every window call carries the state the call before returned, so
    each runs on the kept program."""
    from slamrs_tpu_torch.utils import trace

    trace.reset()
    result = harness.run_cell(bench_root, cell, 7, 0.3, True, device="cpu")
    assert result["correct"]
    assert result["metrics"][NAME]["value"] == 1.0
    assert result["metrics"][NAME]["unit"] == "share"
