"""A benchmark root for the tests: the real ``h100bench/`` code with the
tiny CPU configurations and cells of ``fixtures/`` added as files, and a
``BENCHMARK.json`` that names them."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

HERE = Path(__file__).resolve().parent
BENCH = HERE.parent
FIXTURES = HERE / "fixtures"

CELLS = {"tiny.rollout": ("tiny_fused", "rollout_60"),
         "tiny.scan30hz": ("tiny_fused", "rollout_60_every_tick"),
         "tiny.fleet": ("tiny_fleet", "rollout_60")}


def make_root(tmp: Path, cells=CELLS) -> Path:
    """``tmp`` holding ``h100bench/`` with the fixtures and a
    ``BENCHMARK.json`` naming ``cells``, every metric of the real one
    (each metric's cells those of the fixtures of the same driver)."""
    root = Path(tmp)
    shutil.copytree(BENCH, root / "h100bench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    for kind in ("configs", "workloads"):
        for f in (FIXTURES / kind).iterdir():
            shutil.copy(f, root / "h100bench" / kind / f.name)
    real = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    configs = sorted({c for c, _ in cells.values()})
    spec = dict(real)
    spec["configs"] = [{"name": c, "source": "tests",
                        "file": f"h100bench/configs/{c}.json",
                        "reduced": [], "why": "tests"} for c in configs]
    spec["workloads"] = [{"name": n, "config": c, "traffic": t, "chips": 1,
                          "why": "tests"} for n, (c, t) in cells.items()]

    def fixture_cells(m):
        if "workloads" not in m:
            return m
        drivers = {json.loads((BENCH / "workloads" / f"{w}.json")
                              .read_text())["driver"]
                   for w in m["workloads"]}
        mine = [n for n in cells
                if json.loads((FIXTURES / "workloads" / f"{n}.json")
                              .read_text())["driver"] in drivers]
        return dict(m, workloads=mine)

    for kind in ("end_to_end", "per_layer"):
        spec[kind] = [fixture_cells(m) for m in real[kind]]
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return root
