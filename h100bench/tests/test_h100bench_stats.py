"""The end-to-end readers: the rate over the whole window, and the device
readers with no device time."""

from pathlib import Path

import pytest

from h100bench import harness

METRICS = Path(__file__).resolve().parents[1] / "metrics"


def reader(name):
    return harness.load_module(METRICS / f"{name}.py", f"test_metric_{name}")


def test_rate_is_over_the_whole_window():
    rec = {"world_ticks": 900 * 7 * 256, "window_s": 2.5}
    assert reader("world_ticks_per_s").read(rec) == pytest.approx(
        900 * 7 * 256 / 2.5)


def test_peak_and_setup():
    assert reader("peak_device_gib").read({"peak_bytes": 3 * 2 ** 30}) == 3
    assert reader("setup_s").read({"setup_s": 12.5}) == 12.5


def test_device_readers_say_nothing_without_device_time():
    rec = {"trace": {"busy_s": 0.0, "window_s": 1.0, "frames": 10,
                     "world_ticks": 60, "host_calls": 0, "kernels": {}},
           "calls": 1,
           "k1_sizes": {"worlds": 1}}
    for name in ("device_idle_share", "device_busy_us_per_tick",
                 "frame_host_calls",
                 "k1_roofline", "k2_device_us_per_frame"):
        assert reader(name).read(rec) is None, name
