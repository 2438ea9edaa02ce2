"""The selection kernel's readers on fixture records: launches and device
time per profiled frame, and nothing where the kernel did not run (the
parent tree, a fleet, an ICP world)."""

from pathlib import Path

import pytest

from h100bench import harness

METRICS = Path(__file__).resolve().parents[1] / "metrics"
NAMES = ("slam_select_launches_per_frame",
         "slam_select_device_us_per_frame")


def reader(name):
    return harness.load_module(METRICS / f"{name}.py", f"test_metric_{name}")


def record(kernels, frames=15):
    return {"trace": {"window_s": 0.02, "busy_s": 0.004, "frames": frames,
                      "kernels": kernels}}


def test_readers_per_profiled_frame():
    rec = record({"fused_update_kernel": {"count": 15, "seconds": 3.5e-4},
                  "(anonymous namespace)::slam_select_kernel(float const*)":
                  {"count": 15, "seconds": 15 * 5e-6},
                  "(anonymous namespace)::slam_propose_kernel(float const*)":
                  {"count": 15, "seconds": 15 * 3e-6}})
    assert reader(NAMES[0]).read(rec) == pytest.approx(1.0)
    assert reader(NAMES[1]).read(rec) == pytest.approx(5.0)


@pytest.mark.parametrize("rec", [
    record({"fused_update_kernel": {"count": 15, "seconds": 3.5e-4},
            "slam_propose_kernel": {"count": 15, "seconds": 4.5e-5}}),
    record({"slam_select_kernel": {"count": 15, "seconds": 1e-4}},
           frames=0),
    {"trace": None}, {}])
def test_readers_say_nothing_without_the_kernel(rec):
    for name in NAMES:
        assert reader(name).read(rec) is None, name
