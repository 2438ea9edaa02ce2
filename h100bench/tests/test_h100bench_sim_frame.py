"""The simulator kernel's readers on fixture records: launches and device
time per profiled frame, and nothing where the kernel did not run (the
parent tree)."""

from pathlib import Path

import pytest

from h100bench import harness

METRICS = Path(__file__).resolve().parents[1] / "metrics"
NAMES = ("sim_launches_per_frame", "sim_device_us_per_frame")


def reader(name):
    return harness.load_module(METRICS / f"{name}.py", f"test_metric_{name}")


def record(kernels, frames=15):
    return {"trace": {"window_s": 0.04, "busy_s": 0.004, "frames": frames,
                      "kernels": kernels}}


def test_readers_per_profiled_frame():
    rec = record({"nn_argmin_kernel": {"count": 150, "seconds": 150 * 8e-6},
                  "(anonymous namespace)::sim_frame_kernel(float const*)":
                  {"count": 15, "seconds": 15 * 5e-6}})
    assert reader(NAMES[0]).read(rec) == pytest.approx(1.0)
    assert reader(NAMES[1]).read(rec) == pytest.approx(5.0)


@pytest.mark.parametrize("rec", [
    record({"nn_argmin_kernel": {"count": 150, "seconds": 1e-3}}),
    record({"sim_frame_kernel": {"count": 15, "seconds": 1e-4}}, frames=0),
    {"trace": None}, {}])
def test_readers_say_nothing_without_the_kernel(rec):
    for name in NAMES:
        assert reader(name).read(rec) is None, name
