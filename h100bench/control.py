"""Readings that the limits of the correctness check are set from.

    python3 -m h100bench.control --workload <cell> --seeds 1,2,3 [--control-seeds 1,2,3] [--seconds 0.5]

For each seed, in one process: the cell's set-up, a short window at the
cell's own load (long enough to run the checked calls or updates), then
the compared numbers of the program against the reference (the sound
readings, the lower end of each limit) and, for the control seeds, of the
control against the reference: the reference computed one precision
below the configuration's maps (its ``control_dtype``) put in the
program's place (the upper end).  Prints one JSON line a seed.  The
benchmark's own runs do not run it.
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


def readings(bench: harness.Bench, cell: str, seed: int, seconds: float,
             control: bool, device: str = "cuda") -> dict:
    """The sound (and with ``control`` the control's) compared values of
    one seed."""
    ctx = harness.Context(bench, cell, seed, device)
    driver = bench.module("drivers", ctx.workload["driver"]).Driver(ctx)
    driver.setup()
    driver.window(seconds, None)
    driver.release()
    out = {"cell": cell, "seed": seed,
           "sound": {k: v["value"] for k, v in driver.check().items()}}
    if control:
        import torch

        dtype = getattr(torch, ctx.config["control_dtype"])
        out["control"] = {k: v["value"]
                          for k, v in driver.check(quantize=dtype).items()}
        out["control_dtype"] = ctx.config["control_dtype"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=0.5)
    args = ap.parse_args(argv)
    root = Path.cwd()
    for key, value in harness.cache_env(root).items():
        os.environ[key] = value
    bench = harness.Bench(root)
    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 2
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    seeds = [int(s) for s in args.seeds.split(",") if s]
    for seed in seeds + sorted(controls - set(seeds)):
        print(json.dumps(readings(bench, args.workload, seed, args.seconds,
                                  seed in controls)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
