"""``BENCHMARK.json`` against the files it names and the limits every
benchmark keeps."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}


def test_top_level_keys_and_sizes():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= SPEC["run_seconds"] <= 51
    assert 1 <= len(SPEC["paths"]) <= 16
    assert len(SPEC["command"]) <= 32
    for p in SPEC["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p)
        assert (ROOT / p).is_dir() and not p.endswith("_torch")
    for word in SPEC["command"]:
        assert not word.startswith("/") and ".." not in word


@pytest.mark.parametrize("kind", sorted(KEYS))
def test_entries(kind):
    names = [e["name"] for e in SPEC[kind]]
    assert len(names) == len(set(names))
    for e in SPEC[kind]:
        extra = {"workloads"} if kind in ("end_to_end", "per_layer") else set()
        assert KEYS[kind] <= set(e) <= KEYS[kind] | extra, e["name"]
        assert NAME.match(e["name"])
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200
                assert "\n" not in e[key] and "\t" not in e[key]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                             "higher")


def test_every_name_is_found_as_files():
    bench = ROOT / "h100bench"
    for c in SPEC["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert c["file"].startswith("h100bench/")
        assert (ROOT / c["file"]).parent.joinpath(cfg["yaml"]).is_file()
        assert set(c["reduced"]) == set(cfg["reduced"])
    configs = {c["name"] for c in SPEC["configs"]}
    used = set()
    for w in SPEC["workloads"]:
        params = json.loads((bench / "workloads" / f"{w['name']}.json")
                            .read_text())
        assert params["config"] == w["config"] and w["config"] in configs
        assert (bench / "drivers" / f"{params['driver']}.py").is_file()
        assert w["chips"] in (1, 4)
        used.add(w["config"])
    assert used == configs
    for kind in ("end_to_end", "per_layer"):
        for m in SPEC[kind]:
            assert (bench / "metrics" / f"{m['name']}.py").is_file()


def test_every_cell_reports_what_it_must():
    cells = [w["name"] for w in SPEC["workloads"]]
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}

    def reports(m, cell):
        return "workloads" not in m or cell in m["workloads"]

    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
    assert "setup_s" in e2e
    for cell in cells:
        mine = [n for n, m in e2e.items() if reports(m, cell)]
        assert "setup_s" in mine and len(mine) >= 2, cell
        assert any(reports(m, cell) for m in SPEC["per_layer"]), cell
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert reports(e2e[m["moves"]], cell), (m["name"], cell)
    for m in SPEC["per_layer"]:
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%", m["name"]


def test_four_chip_cells_and_the_check_fit():
    cells = SPEC["workloads"]
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)
    runs = 2 + 14 * 24
    assert (runs * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200
            <= 43200)


def test_limits_of_every_cell_are_set():
    for w in SPEC["workloads"]:
        params = json.loads((ROOT / "h100bench" / "workloads"
                             / f"{w['name']}.json").read_text())
        assert params["limits"] and all(v >= 0 for v in
                                        params["limits"].values())
