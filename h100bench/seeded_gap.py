"""The gap between a rollout cell's injected draws and the seeded path.

    python3 -m h100bench.seeded_gap --workload <cell> --seed <n> --seconds <s> [--rounds 2]

A rollout cell hands every call its grid-SLAM draws (``noise=``) so that
the reference can follow the call with the same numbers.  A dataset
generator or ``python -m slamrs_tpu_torch rollout`` calls
``rollout_cadence`` with a seed instead, and the captured graphs draw
inside themselves.  With the draws injected, each call copies its draws
to the card and each replayed frame copies its frame's draws into the
graph's static buffers first.

In one process, after the cell's own set-up and one seeded warm-up call,
this runs windows of the cell's calls in turn with the draws injected and
with the seed (``noise=None``), ``--rounds`` of each, then one profiled
call of each, and prints one JSON line a window: world-ticks/s, and for
the profiled calls the cell's per-layer readers.  The benchmark's own
runs do not run it, and nothing here is checked against the reference.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from h100bench import harness  # noqa: E402

PROFILED = ("frame_host_calls", "device_busy_us_per_tick",
            "device_idle_share", "k1_roofline")


def windows(bench: harness.Bench, cell: str, seed: int, seconds: float,
            rounds: int, device: str = "cuda"):
    """The cell's set-up, then one dict a window (see above)."""
    import torch

    ctx = harness.Context(bench, cell, seed, device)
    if ctx.workload["driver"] != "rollout":
        raise ValueError(f"{cell}: only the rollout driver injects draws")
    driver = bench.module("drivers", "rollout").Driver(ctx)
    driver.setup()
    from slamrs_tpu_torch.graph import capture

    # what ``rollout_cadence(state, ticks, seed, commands)`` runs on the
    # card; on the CPU (the tests) the same frame program without graphs
    calls = {"injected": driver._call,
             "seeded": lambda state, draws: capture.run_program(
                 driver.fw, state, driver.ticks, seed, driver.commands,
                 graphs=driver.dev.type == "cuda")}
    driver.state, outs = calls["seeded"](driver.state, None)
    driver._to_host(outs)
    driver._sync()
    for r in range(rounds):
        for mode, call in calls.items():
            driver._call = call
            rec = driver.window(seconds, None)
            yield {"cell": cell, "draws": mode, "round": r,
                   "calls": rec["calls"],
                   "world_ticks_per_s": rec["world_ticks"] / rec["window_s"]}
    for mode, call in calls.items():
        driver._call = call
        profile = harness.Profile(torch)
        rec = driver.window(0.0, profile)
        rec["trace"] = profile.summary
        yield {"cell": cell, "draws": mode, "profiled": {
                   m: bench.module("metrics", m).read(rec) for m in PROFILED},
               "device_ops": profile.summary["device_ops"][:5]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    root = Path.cwd()
    for key, value in harness.cache_env(root).items():
        os.environ[key] = value
    bench = harness.Bench(root)
    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 2
    for line in windows(bench, args.workload, args.seed, args.seconds,
                        args.rounds):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
