#!/usr/bin/env python3
"""Device times of the fused update kernels of the checkout in the working
directory: K1 in lineage mode at ``[1024, 80, 128]`` and ``[1024, 200,
256]`` bf16, K1 in place on BASELINE config 3's ``[1024, 1000, 1024]``
maps, and K3 on the config-3 tile pool after a resample; the inputs and
the timing (CUDA events, median of 20) are ``chip_smoke.py``'s.  Prints
one line, ``KERNEL_TIMES {...}``.

Run from the root of a checkout on a machine with one NVIDIA GPU.  To
compare two commits on one card, unpack the other one (``git archive``)
into a directory that ``.gitignore`` lists and run this file from each
root in turns, the path of this file given from the other:

    python3 kernel_times.py change
    (cd build/parent && python3 ../../kernel_times.py parent)
"""

import json
import sys

sys.path.insert(0, ".")  # the checkout in the working directory


def main() -> int:
    import torch

    import chip_smoke as cs
    from slamrs_tpu_torch import kernels
    from slamrs_tpu_torch.ops import fused, tiles
    from slamrs_tpu_torch.ops.grid import GridSpec2D

    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: CUDA is not available")
    kernels.build(force=True)
    kernels.library()
    out = {"tree": sys.argv[1] if len(sys.argv) > 1 else "."}
    for label, res in (("0.05m", 0.05), ("0.02m", 0.02)):
        spec = GridSpec2D(-2.0, -2.0, 4.0, 4.0, res)
        args, kw = cs.kernel_case(torch, fused, spec, 1024, 3, 360, True)
        grids, poses, a0, dist, valid, present, _, nb, rng = args
        prep = fused.prepare(grids.shape[1], grids.shape[2], poses, a0, dist,
                             valid, present, spec, nb, rng, kw["dphi"])
        anc = kw["ancestors"]
        out[f"k1_lineage_{label}_us"] = 1e3 * cs.time_call(
            torch, lambda: fused.launch_kernel(grids, anc, prep, spec, nb))
    spec = cs._spec(cs.CONFIG3)
    grids = cs.config3_maps(torch, 61)
    g = torch.Generator(device="cuda").manual_seed(62)
    args, dphi, _ = cs.tiled_step_inputs(torch, spec, 1024, g, 360, True)
    prep = fused.prepare(1000, 1024, *args[:5], spec, 360, 1.0, dphi)
    out["k1_in_place_config3_ms"] = cs.time_call(
        torch, lambda: fused.launch_kernel(grids, None, prep, spec, 360))
    del grids
    # K3 as chip_smoke times it: one update from the zero pool, then
    # bench.py's relabel with the poses following the lineage
    pool, table = tiles.init_tiled(1024, spec, 1.0, device="cuda")
    args, dphi, _ = cs.tiled_step_inputs(torch, spec, 1024, g, 360, True)
    _, table, _ = tiles.fused_update_tiled(pool, table, *args, dphi=dphi)
    anc = cs.cow_plans(torch)["bench"]
    st = tiles.plan_step(pool, table, args[0][anc.long()], *args[1:],
                         dphi=dphi, ancestors=anc)
    out["k3_config3_ms"] = cs.time_call(
        torch, lambda: tiles.launch_kernel(pool, st, spec, 360))
    print("KERNEL_TIMES", json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
