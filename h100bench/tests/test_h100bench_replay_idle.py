"""The readers of the port's sampled device idle (``replay_idle.py`` and
its five metrics): synthetic call records with sampled frames, a
profiled call among them, a window whose only call is profiled, a port
that keeps no such record, and a traced tiny cell on the CPU (no graphs, so
nothing to read)."""

from pathlib import Path

import pytest

from h100bench import harness, replay_idle

METRICS = Path(__file__).resolve().parents[1] / "metrics"
PER_REPLAY = {"loop_idle_us_per_replay": "loop",
              "fill_idle_us_per_replay": "fill",
              "launch_idle_us_per_replay": "launch"}
READERS = (*PER_REPLAY, "call_ends_idle_ms_per_call", "host_wait_share")


def reader(name):
    return harness.load_module(METRICS / f"{name}.py", f"test_metric_{name}")


def _sample(fill, launch, loop, host=140):
    """Idle in microseconds under each phase of one sampled frame, and
    the frame's host time."""
    return {"fill": fill * 1e-6, "launch": launch * 1e-6,
            "loop": loop * 1e-6, "host": host * 1e-6,
            "device": (0.001, 0.0011)}


def _call(samples, ends_ms, cycles=150, wall_ms=25.0, closed=True,
          loop_ms=None, profiled=False):
    """A call record whose loop took ``loop_ms`` (by default its cycles
    at the samples' 140 µs) of its ``wall_ms``."""
    ends = {"call": ends_ms * 0.4e-3, "rollout.draws_upload": ends_ms * 0.1e-3,
            "rollout.ticks": ends_ms * 0.1e-3,
            "rollout.hand_over": ends_ms * 0.1e-3}
    if closed:
        ends["outside"] = ends_ms * 0.3e-3
    return {"name": "rollout_cadence", "seconds": wall_ms * 1e-3,
            "self_seconds": 0.004, "spans": {}, "counts": {}, "device": {},
            "replays": {"every": 16, "cycles": cycles, "samples": samples,
                        "profiled": profiled,
                        "loop_s": (cycles * 140e-3 if loop_ms is None
                                   else loop_ms) * 1e-3,
                        "ends": ends, "head_ns": 0, "wall_s": wall_ms * 1e-3}}


def _read(monkeypatch, calls, n):
    from slamrs_tpu_torch.utils import trace

    monkeypatch.setattr(trace, "calls", lambda: calls)
    return {name: reader(name).read({"calls": n}) for name in READERS}


def test_readers_scale_the_samples_and_take_the_window_calls_median(
        monkeypatch):
    calls = [_call([_sample(900, 900, 900)], 900.0),  # warm-up
             {"name": "rollout", "spans": {}},
             _call([_sample(10, 2, 4), _sample(30, 4, 8)], 4.0),
             _call([_sample(40, 6, 2), _sample(40, 6, 2)], 6.0, cycles=100),
             _call([_sample(500, 500, 500)], 500.0, profiled=True),
             _call([_sample(5, 0, 0), _sample(15, 2, 2)], 2.0, cycles=120)]
    got = _read(monkeypatch, calls, 4)
    assert got["fill_idle_us_per_replay"] == pytest.approx(20.0)
    assert got["launch_idle_us_per_replay"] == pytest.approx(3.0)
    assert got["loop_idle_us_per_replay"] == pytest.approx(2.0)
    assert got["call_ends_idle_ms_per_call"] == pytest.approx(4.0)
    # per call: (fill + launch + loop a cycle) x cycles + ends, over wall
    # (the loop's host time is the samples' 140 µs a run)
    shares = [((29 * 150) * 1e-6 + 4e-3) / 25e-3,
              ((48 * 100) * 1e-6 + 6e-3) / 25e-3,
              ((12 * 120) * 1e-6 + 2e-3) / 25e-3]
    assert got["host_wait_share"] == pytest.approx(sorted(shares)[1])
    for call in (calls[2], calls[3], calls[5]):
        loop = sum(replay_idle.per_replay(call, p)
                   for p in replay_idle.PHASES) * call["replays"]["cycles"]
        assert loop == pytest.approx(replay_idle.loop_idle(call))
        assert (loop + replay_idle.ends_idle(call)) / 25e-3 == pytest.approx(
            replay_idle.host_wait_share(call))


def test_a_window_whose_only_call_is_profiled_reads_its_other_samples(
        monkeypatch):
    """A traced window whose only call a profiler recorded in reads
    nothing: the profiler's cost lies in the whole call (its host runs
    slower after ``stop()``), so no part of it is read as unprofiled.
    The window's other calls, where it has any, read alone."""
    profiled = _call([_sample(12, 3, 1, host=160)] * 9, 5.0,
                     wall_ms=9000.0, loop_ms=8990.0, profiled=True)
    got = _read(monkeypatch, [profiled], 1)
    assert all(v is None for v in got.values())
    got = _read(monkeypatch, [profiled, _call([_sample(8, 1, 1)], 3.0)], 2)
    assert got["fill_idle_us_per_replay"] == pytest.approx(8.0)
    assert got["call_ends_idle_ms_per_call"] == pytest.approx(3.0)


def test_a_call_with_every_sample_profiled_or_none_reads_nothing(
        monkeypatch):
    """A profiled call (every sample in it) reads nothing, its ends
    neither; a call with no sampled frame reads its ends alone."""
    profiled = _call([_sample(900, 900, 900)], 3.0, profiled=True)
    assert all(v is None for v in _read(monkeypatch, [profiled], 1).values())
    got = _read(monkeypatch, [_call([], 3.0)], 1)
    assert all(got[n] is None for n in (*PER_REPLAY, "host_wait_share"))
    assert got["call_ends_idle_ms_per_call"] == pytest.approx(3.0)


def test_the_last_call_reads_its_ends_up_to_its_close(monkeypatch):
    """A window's last call, which no call followed (a traced window's
    only call): its ends have no ``outside``, its wall ends at its
    close."""
    got = _read(monkeypatch, [_call([_sample(8, 1, 1)], 3.0, closed=False,
                                    wall_ms=20.0)], 1)
    assert got["fill_idle_us_per_replay"] == pytest.approx(8.0)
    assert got["call_ends_idle_ms_per_call"] == pytest.approx(3.0 * 0.7)
    assert got["host_wait_share"] == pytest.approx(
        (10 * 150 * 1e-6 + 2.1e-3) / 20e-3)


def test_records_without_sampled_replays_read_nothing(monkeypatch):
    from slamrs_tpu_torch.utils import trace

    bare = _call([_sample(8, 1, 1)], 3.0)
    del bare["replays"]
    got = _read(monkeypatch, [bare, bare], 2)
    assert all(v is None for v in got.values())
    assert all(v is None for v in _read(monkeypatch, [], 0).values())
    monkeypatch.delattr(trace, "calls")
    for name in READERS:
        assert reader(name).read({"calls": 4}) is None, name


def test_a_traced_tiny_cell_on_the_cpu_reports_none_of_them(bench_root):
    """The CPU runs the frame program without graphs: no replay, no
    sampled point, none of the five in the result line."""
    from slamrs_tpu_torch.utils import trace

    trace.reset()
    result = harness.run_cell(bench_root, "tiny.rollout", 5, 0.3, True,
                              device="cpu")
    assert result["correct"]
    assert not set(READERS) & set(result["metrics"])
    assert all("replays" not in c for c in trace.calls())
