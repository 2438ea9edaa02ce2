"""The ICP solve kernel's readers on fixture records: launches and device
time per profiled frame, and nothing where the kernel did not run (the
parent tree, or a cell without ICP)."""

from pathlib import Path

import pytest

from h100bench import harness

METRICS = Path(__file__).resolve().parents[1] / "metrics"
NAMES = ("icp_solve_launches_per_frame", "icp_solve_device_us_per_frame")


def reader(name):
    return harness.load_module(METRICS / f"{name}.py", f"test_metric_{name}")


def record(kernels, frames=15):
    return {"trace": {"window_s": 0.04, "busy_s": 0.004, "frames": frames,
                      "kernels": kernels}}


def test_readers_per_profiled_frame():
    rec = record({"nn_argmin_kernel": {"count": 150, "seconds": 150 * 8e-6},
                  "(anonymous namespace)::icp_solve_kernel(float2 const*)":
                  {"count": 165, "seconds": 165 * 4e-6}})
    assert reader(NAMES[0]).read(rec) == pytest.approx(11.0)
    assert reader(NAMES[1]).read(rec) == pytest.approx(44.0)


@pytest.mark.parametrize("rec", [
    record({"nn_argmin_kernel": {"count": 150, "seconds": 1e-3}}),
    record({"icp_solve_kernel": {"count": 165, "seconds": 1e-3}}, frames=0),
    {"trace": None}, {}])
def test_readers_say_nothing_without_the_kernel(rec):
    for name in NAMES:
        assert reader(name).read(rec) is None, name
