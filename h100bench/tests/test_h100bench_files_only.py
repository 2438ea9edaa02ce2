"""A cell, a configuration and a per-layer metric added as files alone,
with entries in ``BENCHMARK.json``, run without an edit of any file the
benchmark already has: the fixture cells are such files."""

import json

from h100bench import harness


def test_added_metric_and_cell_run_without_an_edit(bench_root):
    root = bench_root.root
    (root / "h100bench" / "metrics" / "tiny_calls.py").write_text(
        "def read(record):\n    return float(record.get('calls', 0))\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["per_layer"].append({
        "name": "tiny_calls", "unit": "calls", "better": "higher",
        "source": "program_counter", "layer": "captured frames",
        "moves": "world_ticks_per_s", "workloads": ["tiny.rollout"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    bench = harness.Bench(root)
    result = harness.run_cell(bench, "tiny.rollout", 5, 0.3, True,
                              device="cpu")
    assert result["metrics"]["tiny_calls"]["value"] >= 1
    assert result["correct"]
