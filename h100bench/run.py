"""One run of one benchmark cell on one H100.

    python3 -m h100bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout (where ``BENCHMARK.json`` is).  Prints the
numbers that decide ``correct`` beside their limits as the last lines of
standard error, and one JSON object as the last line of standard output.
Exits with 2, printing no result, without CUDA or with fewer cards than
the cell asks for, and with 3 if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

if __package__ in (None, ""):  # run as a file: the checkout's root first
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from h100bench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    root = Path.cwd()
    for key, value in harness.cache_env(root).items():
        os.environ[key] = value
    bench = harness.Bench(root)
    chips = bench.cell(args.workload)["chips"]

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"error: cell {args.workload} needs {chips} CUDA device(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = harness.run_cell(bench, args.workload, args.seed, args.seconds,
                              bool(args.trace))
    found = harness.foreign_modules()
    if found:
        print(f"error: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for name, v in result["compared"].items():
        print(f"{name} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
