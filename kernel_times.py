#!/usr/bin/env python3
"""Device times of the kernels of the checkout in the working directory:
K1 in lineage mode at ``[1024, 80, 128]`` and ``[1024, 200, 256]`` bf16,
K1 in place on BASELINE config 3's ``[1024, 1000, 1024]`` maps, K3 on the
config-3 tile pool after a resample, and K4 at bench.py's ICP batch
(``[2048, 360] x [2048, 360]``) and the ICP mapper's shape (``[1, 360] x
[1, 16384]``, ``q_count`` 10,000, and 0 and 44), with a one-element
fill as the floor of a launch timed this way; the inputs and the timing
(CUDA events, median of 20) are ``chip_smoke.py``'s.  The ICP solve
kernel at the ``icp_odometry`` cell's shape (360 lanes against the full
16,384-point map, Step 0.05), one iteration and the prologue, beside its
plain version on the card, where the tree has the kernel; likewise the
proposal kernel (a grid update's motion sample, log-probability and
fused-kernel inputs) at the headline's and config 3's shapes, and the
dda integrate kernel (walk, inverse sensor model and per-cell sum) at the
``dda.rollout`` cell's shape beside the plain chain.  Then a
profiled 300-tick ICP run (``configs/icp_test.yaml``): device busy time,
its device operations a scan frame, K4's and the solve kernel's share of
it and their launches, and the memsets; and ptxas's register, spill and
shared-memory lines per source.  Prints one line, ``KERNEL_TIMES
{...}``.

Run from the root of a checkout on a machine with one NVIDIA GPU.  To
compare two commits on one card, unpack the other one (``git archive``)
into a directory that ``.gitignore`` lists and run this file from each
root in turns, the path of this file given from the other:

    python3 kernel_times.py change
    (cd build/parent && python3 ../../kernel_times.py parent)
"""

import json
import os
import subprocess
import sys

sys.path.insert(0, ".")  # the checkout in the working directory


def main() -> int:
    import torch

    import chip_smoke as cs
    from slamrs_tpu_torch import kernels
    from slamrs_tpu_torch.ops import fused, icp, tiles
    from slamrs_tpu_torch.ops.grid import GridSpec2D

    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: CUDA is not available")
    kernels.build(force=True)
    kernels.library()
    out = {"tree": sys.argv[1] if len(sys.argv) > 1 else ".",
           "ptxas": ptxas_stats(kernels)}
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
    del pool
    # K4 at bench.py's batch and the ICP mapper's shape (q_count 10,000);
    # at the mapper's shape also with q_count 0 (no pairs) and 44 (one
    # pair a lane in each of 44 chunks), where a tree has those sets, and
    # a one-element fill as the floor of a launch timed this way
    cases = cs.nn_cases(torch)
    for label, key in (("bench_2048x360x360", "k4_bench_us"),
                       ("mapper_1x360x16384_qc10000", "k4_mapper_us"),
                       ("mapper_1x360x16384_qc0", "k4_mapper_qc0_us"),
                       ("mapper_1x360x16384_qc44", "k4_mapper_qc44_us")):
        if label in cases:
            p, q, qc = cases[label]
            out[key] = 1e3 * cs.time_call(
                torch, lambda: icp.launch_kernel(p, q, qc))
    out["fill_1_us"] = 1e3 * cs.time_call(
        torch, lambda: torch.zeros(1, device="cuda"))
    if hasattr(icp, "icp_solve"):
        out.update(icp_solve_times(torch, cs, icp))
    if hasattr(cs, "PROPOSE_SHAPES"):
        out.update(slam_propose_times(torch, cs))
    if hasattr(cs, "dda_integrate_times"):
        out.update({f"dda_integrate_{k}": v
                    for k, v in cs.dda_integrate_times(torch).items()})
    out.update(icp_run_profile(torch, cs))
    print("KERNEL_TIMES", json.dumps(out), flush=True)
    return 0


def ptxas_stats(kernels):
    """Per source of ``csrc/``, ptxas's lines on registers, spills and
    shared memory (``-Xptxas -v``, the build's flags)."""
    procs = {src.name: subprocess.Popen(
        [kernels.nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
         os.devnull, str(src)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for src in kernels.sources()}
    return {name: [ln.split(":", 1)[-1].strip()
                   for ln in proc.communicate()[0].splitlines()
                   if "Used" in ln or "spill" in ln]
            for name, proc in procs.items()}


def icp_solve_times(torch, cs, icp):
    """The ICP solve kernel at the ``icp_odometry`` cell's shape
    (``chip_smoke.icp_solve_cases``' mapper set): one iteration (K4's
    indices given) and the transform-only prologue, and the plain version
    of the iteration on the card on the same inputs."""
    p, mask, q, qc, x0, thr = cs.icp_solve_cases(torch)[
        "mapper_1x360x16384_step0.05"]
    p_t = icp.transform_points(p, x0)
    corr = icp.nearest_neighbors(p_t, q, qc)
    x, pt, chi = x0.clone(), p_t.clone(), torch.empty(1, 1, device="cuda")
    # repeated in place: the pose moves, the work (lanes, reads) does not
    return {"icp_solve_step_us": 1e3 * cs.time_call(
                torch, lambda: icp.icp_solve(p, mask, q, qc, corr, x, x, pt,
                                             chi, 0, thr)),
            "icp_solve_prologue_us": 1e3 * cs.time_call(
                torch, lambda: icp.icp_solve(p, mask, q, qc, None, x0, x, pt,
                                             chi, 0, thr)),
            "icp_solve_plain_step_us": 1e3 * cs.time_call(
                torch, lambda: icp.solve_step_reference(
                    p, mask, q, qc, x0, p_t, corr, thr))}


def slam_propose_times(torch, cs):
    """The proposal kernel and its plain chain on the card at the
    headline's maps and config 3's tile pool (``chip_smoke.propose_case``,
    1,024 particles, 360 beams, static spacing)."""
    from slamrs_tpu_torch.ops import propose
    from slamrs_tpu_torch.ops.grid import GridSpec2D

    out = {}
    for label in ("headline_1024", "config3_tiled_1024"):
        geom, p, tiled = cs.PROPOSE_SHAPES[label]
        spec = GridSpec2D(*geom)
        rows, cols = cs.propose_rows_cols(torch, spec, p, tiled)
        poses, odometry, eps, scan, static = cs.propose_case(torch, spec, p,
                                                             1)
        args = (poses, odometry, eps, scan, spec, 1.0, static, rows, cols)
        out[f"slam_propose_{label}_us"] = 1e3 * cs.time_call(
            torch, lambda: propose.slam_propose(*args))
        out[f"slam_propose_plain_{label}_us"] = 1e3 * cs.time_call(
            torch, lambda: propose.slam_propose_reference(*args))
    return out


def icp_run_profile(torch, cs, ticks=300):
    """A warm ``configs/icp_test.yaml`` run of ``ticks`` ticks under
    ``torch.profiler``: the device's busy time and operations, its scan
    frames, K4's share of it (the kernels ``nn_argmin_kernel`` and, before
    the one-launch design, ``nn_finish_kernel``) and the solve kernel's,
    their CUDA launches, and the memsets on the card."""
    from torch.profiler import ProfilerActivity, profile

    fw = cs.preset_world(torch, "icp_test.yaml")
    fw.rollout_cadence(fw.init(), 30, seed=2)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, outs = fw.rollout_cadence(fw.init(), ticks, seed=1)
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    k4 = [e for e in dev if "nn_argmin" in e.key or "nn_finish" in e.key]
    solve = [e for e in dev if "icp_solve_kernel" in e.key]
    return {"icp_run_device_ms":
            sum(e.self_device_time_total for e in dev) / 1e3,
            "icp_run_frames": int(outs.fired.shape[0]),
            "icp_run_launches": sum(e.count for e in dev),
            "icp_run_solve_device_ms":
            sum(e.self_device_time_total for e in solve) / 1e3,
            "icp_run_solve_launches": sum(e.count for e in solve),
            "icp_run_k4_device_ms":
            sum(e.self_device_time_total for e in k4) / 1e3,
            "icp_run_k4_launches": sum(e.count for e in k4),
            "icp_run_memsets": sum(e.count for e in dev
                                   if "memset" in e.key.lower())}


if __name__ == "__main__":
    sys.exit(main())
