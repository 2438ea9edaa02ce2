"""The ``ekf.rollout`` cell's files: its three readers on fixture records,
``ekf_compare`` on the program's own state and on a perturbed one, and
the entries ``BENCHMARK.json`` holds for the cell."""

import json
import math
from pathlib import Path

import pytest
import torch

from h100bench import compare, ekf_compare, harness

ROOT = Path(__file__).resolve().parents[2]
METRICS = ROOT / "h100bench" / "metrics"
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELL = "ekf.rollout"
NEW = ("ekf_corrections_per_frame", "ekf_launches_per_frame",
       "ekf_device_us_per_frame")
LIMITS = json.loads((ROOT / "h100bench" / "workloads" / f"{CELL}.json")
                    .read_text())["limits"]


def reader(name):
    return harness.load_module(METRICS / f"{name}.py", f"test_metric_{name}")


def record(kernels, frames=15):
    return {"trace": {"window_s": 0.04, "busy_s": 0.02, "frames": frames,
                      "kernels": kernels}}


def test_device_readers_leave_out_the_simulator_kernel():
    rec = record({
        "(anonymous namespace)::sim_frame_kernel(...)":
            {"count": 15, "seconds": 15 * 9e-6},
        "void at::native::vectorized_elementwise_kernel<4, ...>":
            {"count": 12000, "seconds": 12000 * 1.5e-6},
        "sm90_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize64x64x8":
            {"count": 720, "seconds": 720 * 4e-6},
        "Memcpy DtoD (Device -> Device)": {"count": 45, "seconds": 45e-6}})
    assert reader("ekf_launches_per_frame").read(rec) == pytest.approx(
        (12000 + 720 + 45) / 15)
    assert reader("ekf_device_us_per_frame").read(rec) == pytest.approx(
        (12000 * 1.5 + 720 * 4 + 45) / 15)


@pytest.mark.parametrize("rec", [
    record({"sim_frame_kernel": {"count": 15, "seconds": 1e-4}}),
    record({"elementwise_kernel": {"count": 15, "seconds": 1e-4}},
           frames=0),
    {"trace": None}, {}])
def test_device_readers_say_nothing_without_ekf_work(rec):
    for name in NEW[1:]:
        assert reader(name).read(rec) is None, name


def test_corrections_reader_reads_the_first_window_call(monkeypatch):
    r = reader("ekf_corrections_per_frame")
    assert r.read({"calls": 0}) is None

    def calls(*devices, frames=150):
        return [{"device": d, "counts": {"rollout.frames": frames}}
                for d in devices]
    monkeypatch.setattr(r, "window_calls", lambda rec: rec["c"])
    assert r.read({"c": []}) is None
    assert r.read({"c": calls({})}) is None  # a port without the counter
    assert r.read({"c": calls({"dda.cells": [torch.tensor(5)]})}) is None
    first = {"ekf.corrections": [torch.tensor(150 * 1017)]}
    assert r.read({"c": calls(first, frames=0)}) is None
    later = {"ekf.corrections": [torch.tensor(1)]}
    assert r.read({"c": calls(first, later)}) == 1017.0


def _side(worlds=3, d=23, frames=5, seed=0):
    g = torch.Generator().manual_seed(seed)
    a = torch.randn(worlds, d, d, generator=g, dtype=torch.float64)
    cov = (a @ a.transpose(-1, -2) + torch.eye(d, dtype=torch.float64)) \
        .float()
    mean = torch.randn(worlds, d, generator=g)
    mean[:, 2] = math.pi - 1e-6
    return {"frames_pose": torch.randn(frames, worlds, 3, generator=g),
            "frames_ekf": torch.randn(frames, worlds, 3, generator=g),
            "pose": torch.randn(worlds, 3, generator=g), "mean": mean,
            "cov": cov, "seen": torch.rand(worlds, 10, generator=g) < 0.5}


def _correct(values):
    got = compare.compared(values, LIMITS)
    return all(v["value"] <= v["limit"] for v in got.values())


def test_compare_reads_0_on_the_programs_own_state():
    side = _side()
    values = ekf_compare.numbers(side, {k: v.clone()
                                        for k, v in side.items()})
    assert values == {"pose_gap": 0.0, "cov_gap": 0.0, "seen_gap": 0.0}
    assert _correct(values)


@pytest.mark.parametrize("perturb,name", [
    (lambda s: s["frames_ekf"].__setitem__((2, 1, 0), s["frames_ekf"][
        2, 1, 0] + 5e-4), "pose_gap"),
    (lambda s: s["mean"].__setitem__((0, 7), s["mean"][0, 7] - 5e-4),
     "pose_gap"),
    (lambda s: s["cov"].__setitem__((1, 4, 9), s["cov"][1, 4, 9] * 1.05),
     "cov_gap"),
    (lambda s: s["seen"].__setitem__((2, 3), ~s["seen"][2, 3]), "seen_gap"),
    (lambda s: s.__setitem__("frames_pose", s["frames_pose"][:-1]),
     "pose_gap")])
def test_compare_is_over_its_limit_on_a_perturbed_state(perturb, name):
    ref = _side()
    prog = {k: v.clone() for k, v in ref.items()}
    perturb(prog)
    values = ekf_compare.numbers(prog, ref)
    assert values[name] > LIMITS[name] and not _correct(values), values


def test_heading_wrapped_across_pi_reads_as_its_small_gap():
    ref = _side()
    prog = {k: v.clone() for k, v in ref.items()}
    prog["mean"][:, 2] = -math.pi + 1e-6  # 2e-6 rad across the wrap
    assert ekf_compare.numbers(prog, ref)["pose_gap"] < LIMITS["pose_gap"]


def test_benchmark_names_the_cell_its_configuration_and_metrics():
    cfg = [c for c in SPEC["configs"] if c["name"] == "ekf_landmarks_fleet"]
    assert len(cfg) == 1 and cfg[0]["reduced"] == []
    params = json.loads((ROOT / cfg[0]["file"]).read_text())
    assert (params["worlds"], params["precision"], params["control_dtype"]) \
        == (256, "float32", "bfloat16")
    cell = [w for w in SPEC["workloads"] if w["name"] == CELL]
    assert cell == [{**cell[0], "config": "ekf_landmarks_fleet",
                     "traffic": "rollout_900_scan_5hz", "chips": 1}]
    work = json.loads((ROOT / "h100bench" / "workloads" / f"{CELL}.json")
                      .read_text())
    assert work["driver"] == "ekf_rollout" and work["ticks_per_call"] == 900
    assert work["commands"] == [0.04, 0.06]
    assert set(work["limits"]) == {"pose_gap", "cov_gap", "seen_gap"}
    assert work["limits"]["seen_gap"] == 0
    layer = {m["layer"] for m in SPEC["per_layer"] if m["name"] in NEW}
    assert layer == {"EKF (models/ekf.py, models/simulator.landmark_scan)"}
    for m in SPEC["per_layer"]:
        if m["name"] in NEW:
            assert m["workloads"] == [CELL] and \
                m["moves"] == "world_ticks_per_s"
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert CELL in e2e["world_ticks_per_s"]["workloads"]
    assert CELL not in e2e["peak_device_gib"]["workloads"]
    every_rollout = {m["name"] for m in SPEC["per_layer"]
                     if "dda.rollout" in m.get("workloads", ())
                     and "icp.rollout" in m["workloads"]}
    for name in every_rollout:
        m = [x for x in SPEC["per_layer"] if x["name"] == name][0]
        assert CELL in m["workloads"], name
