"""The seeded-path comparison runs a rollout cell's calls with the draws
injected and with the port's seed, in turns, and profiles one call of
each (on the CPU the profile holds no device time, so its readers say
nothing)."""

import pytest

from h100bench import seeded_gap


def test_windows_alternate_injected_and_seeded(bench_root):
    lines = list(seeded_gap.windows(bench_root, "tiny.rollout", 2 ** 32 + 9,
                                    0.05, 1, device="cpu"))
    assert [x["draws"] for x in lines] == ["injected", "seeded"] * 2
    assert all(x["world_ticks_per_s"] > 0 for x in lines[:2])
    assert all(v is None for x in lines[2:] for v in x["profiled"].values())


def test_refuses_a_cell_without_injected_draws(bench_root, tmp_path):
    import json

    path = bench_root.path("workloads", "tiny.rollout.json")
    spec = json.loads(path.read_text())
    path.write_text(json.dumps(dict(spec, driver="other")))
    with pytest.raises(ValueError):
        next(seeded_gap.windows(bench_root, "tiny.rollout", 1, 0.05, 1,
                                device="cpu"))
