"""Readings of an EKF cell's float32 controls, beside ``control.py``'s
bfloat16 one, that its limits are set from.

    python3 -m h100bench.ekf_control --workload ekf.rollout --seeds 1,2,3 [--seconds 0.5]

For each seed, in one process: the cell's set-up, a short window (long
enough to run the checked call), then the compared numbers of the program
against the reference (the sound reading) and of two controls against
the reference (``ekf_compare``): ``reorder``, every matrix product summed
in another float32 order, which a limit must pass; ``tf32``, every
product of operands rounded to TF32, which a limit must fail.  Prints
one JSON line a seed.  The benchmark's own runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from h100bench import ekf_compare, harness  # noqa: E402


def readings(bench: harness.Bench, cell: str, seed: int, seconds: float,
             device: str = "cuda") -> dict:
    """The sound and the two controls' compared values of one seed."""
    ctx = harness.Context(bench, cell, seed, device)
    driver = bench.module("drivers", ctx.workload["driver"]).Driver(ctx)
    driver.setup()
    driver.window(seconds, None)
    driver.release()
    out = {"cell": cell, "seed": seed,
           "sound": {k: v["value"] for k, v in driver.check().items()}}
    for control in ekf_compare.CONTROLS:
        out[control] = {k: v["value"] for k, v in
                        driver.check(control=control).items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
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
    for seed in (int(s) for s in args.seeds.split(",") if s):
        print(json.dumps(readings(bench, args.workload, seed, args.seconds)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
