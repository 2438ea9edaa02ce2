"""CLI: ``python -m slamrs_tpu_torch rollout <config.yaml> [--steps N]
[--worlds W] [--seed S] [--device cuda]``.

Runs the fused world of a YAML node graph through ``rollout_cadence``,
as one world or as a fleet of ``W`` worlds on one device, and prints one
JSON report: steps, worlds, scans, final ground-truth pose (one per
world for a fleet), and, for each filter the world runs (grid SLAM's
best particle, the ICP mapper, the EKF), the RMSE of its pose against
ground truth over every world and scan frame.
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
    if args.worlds < 1:
        raise SystemExit(f"error: --worlds must be at least 1, got "
                         f"{args.worlds}")
    fw = compile_world(load_config(args.config), device=device)
    worlds = (args.worlds,) if args.worlds > 1 else ()
    state, outs = fw.rollout_cadence(fw.init(worlds), args.steps,
                                     seed=args.seed)
    pose = outs.pose.cpu()
    report = {
        "steps": args.steps,
        "worlds": args.worlds,
        "scans": int(outs.fired.sum()),
        "final_pose": state.pose.cpu().tolist(),
        "device": str(device),
    }
    for name in ("grid_pose", "icp_pose", "ekf_pose"):
        est = getattr(outs, name)
        if est is not None:
            err = est.cpu()[..., :2] - pose[..., :2]
            report[f"{name}_rmse_xy"] = float(torch.sqrt((err ** 2).mean()))
    return report


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="slamrs_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    ro = sub.add_parser("rollout", help="fused-world rollout")
    ro.add_argument("config")
    ro.add_argument("--steps", type=int, default=900)
    ro.add_argument("--worlds", type=int, default=1)
    ro.add_argument("--seed", type=int, default=0)
    ro.add_argument("--device", default="cuda")
    ro.set_defaults(fn=cmd_rollout)
    args = p.parse_args(argv)
    print(json.dumps(args.fn(args)))


if __name__ == "__main__":
    main()
