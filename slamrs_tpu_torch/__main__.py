"""CLI: ``python -m slamrs_tpu_torch rollout <config.yaml> [--steps N]
[--seed S] [--device cuda]``.

Runs the fused world of a YAML node graph through ``rollout_cadence`` and
prints one JSON report: steps, scans, final ground-truth pose, and, for
each filter the world runs (grid SLAM's best particle, the ICP mapper,
the EKF), the RMSE of its pose against ground truth over the scan
frames.
The device defaults to ``cuda`` and nothing falls back: without CUDA it
stops with an error, and ``--device cpu`` must be asked for.
"""

from __future__ import annotations

import argparse
import json


def cmd_rollout(args) -> dict:
    import torch

    from slamrs_tpu_torch.graph.compile import compile_world
    from slamrs_tpu_torch.graph.config import load_config

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("error: --device cuda but CUDA is not available "
                         "(pass --device cpu to run the plain versions)")
    fw = compile_world(load_config(args.config), device=device)
    state, outs = fw.rollout_cadence(fw.init(), args.steps, seed=args.seed)
    pose = outs.pose.cpu()
    report = {
        "steps": args.steps,
        "worlds": 1,
        "scans": int(outs.fired.sum()),
        "final_pose": state.pose.cpu().tolist(),
        "device": str(device),
    }
    for name in ("grid_pose", "icp_pose", "ekf_pose"):
        est = getattr(outs, name)
        if est is not None:
            err = est.cpu()[:, :2] - pose[:, :2]
            report[f"{name}_rmse_xy"] = float(torch.sqrt((err ** 2).mean()))
    return report


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="slamrs_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    ro = sub.add_parser("rollout", help="fused-world rollout")
    ro.add_argument("config")
    ro.add_argument("--steps", type=int, default=900)
    ro.add_argument("--seed", type=int, default=0)
    ro.add_argument("--device", default="cuda")
    ro.set_defaults(fn=cmd_rollout)
    args = p.parse_args(argv)
    print(json.dumps(args.fn(args)))


if __name__ == "__main__":
    main()
