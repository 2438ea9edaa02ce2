"""CLI: ``python -m slamrs_tpu_torch <command>``.

    run      <config.yaml> [--duration S] [--realtime] [--teleop]
             [--png out.png] [--npz out.npz] [--device cuda]
    rollout  <config.yaml> [--steps N] [--worlds W] [--seed S]
             [--save-state s.npz] [--resume s.npz] [--device cuda]

``run`` drives the YAML's node graph (``graph/app.py``) headlessly for
``--duration`` seconds of simulated time; ``--teleop`` drives its
``!Controls`` node from the keyboard, ``--png`` draws the last frame
(needs matplotlib) and ``--npz`` saves the visualizer's topics.

``rollout`` runs the fused world of a YAML node graph through
``rollout_cadence``, as one world or as a fleet of ``W`` worlds on one
device, and prints one JSON report: steps, worlds, scans, final
ground-truth pose (one per world for a fleet), and, for each filter the
world runs (grid SLAM's best particle, the ICP mapper, the EKF), the
RMSE of its pose against ground truth over every world and scan frame.
``--resume`` starts from a checkpoint (the port's, or one written by
``python -m slamrs_tpu rollout --save-state``) and ``--save-state``
writes the final state (``utils/checkpoint.py``).

The device defaults to ``cuda`` and nothing falls back: without CUDA it
stops with an error, and ``--device cpu`` must be asked for.
"""

from __future__ import annotations

import argparse
import json
import sys


def _device(name: str):
    from slamrs_tpu_torch.graph.app import check_device

    try:
        return check_device(name)
    except RuntimeError as e:
        raise SystemExit(f"error: {e}") from None


def cmd_run(args) -> None:
    from slamrs_tpu_torch.graph.app import App
    from slamrs_tpu_torch.graph.nodes.viz import VisualizerNode

    app = App.from_file(args.config, realtime=args.realtime,
                        with_renderer=bool(args.png),
                        device=_device(args.device))
    teleop = None
    if args.teleop:
        from slamrs_tpu_torch.graph.nodes.util import ControlsNode
        from slamrs_tpu_torch.io.teleop import StdinTeleop

        controls = app.node(ControlsNode)
        if controls is None:
            print("--teleop: config has no !Controls node", file=sys.stderr)
        else:
            teleop = StdinTeleop(controls.set_command,
                                 target_speed=controls.config.max_speed)
            print("teleop: WASD/arrows drive, space stops, Q quits",
                  file=sys.stderr)
    try:
        app.run(duration_s=args.duration)
    finally:
        # restore the terminal (cbreak mode) even when run() raises
        if teleop is not None:
            teleop.stop()
    print(f"ran {args.duration}s of sim time; frame {app.frame_stats}")
    if args.png and app.renderer is not None:
        # the composed frame: every node's draw hook plus the visualizer
        from slamrs_tpu_torch.viz.shapes import render_draw_calls

        render_draw_calls(app.renderer.flush(), args.png)
        print("wrote", args.png)
    viz = app.node(VisualizerNode)
    if viz is not None and args.npz:
        viz.save_npz(args.npz)
        print("wrote", args.npz)
    app.terminate()


def cmd_rollout(args) -> dict:
    import torch

    from slamrs_tpu_torch.graph.compile import compile_world
    from slamrs_tpu_torch.graph.config import load_config
    from slamrs_tpu_torch.utils import checkpoint

    device = _device(args.device)
    if args.worlds < 1:
        raise SystemExit(f"error: --worlds must be at least 1, got "
                         f"{args.worlds}")
    fw = compile_world(load_config(args.config), device=device)
    worlds = (args.worlds,) if args.worlds > 1 else ()
    state = fw.init(worlds)
    if args.resume:
        state = checkpoint.load(args.resume, state)
        print(f"resumed from {args.resume}", file=sys.stderr)
    state, outs = fw.rollout_cadence(state, args.steps, seed=args.seed)
    if args.save_state:
        checkpoint.save(args.save_state, state)
        print(f"saved state to {args.save_state}", file=sys.stderr)
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
    print(json.dumps(report))
    return report


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="slamrs_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("run", help="run a node-graph config headlessly")
    r.add_argument("config")
    r.add_argument("--duration", type=float, default=10.0)
    r.add_argument("--realtime", action="store_true")
    r.add_argument("--teleop", action="store_true",
                   help="drive the !Controls node from the keyboard "
                        "(WASD/arrows; implies an interactive terminal)")
    r.add_argument("--png", help="draw the last frame (needs matplotlib)")
    r.add_argument("--npz", help="save the visualizer's topics")
    r.add_argument("--device", default="cuda")
    r.set_defaults(fn=cmd_run)

    ro = sub.add_parser("rollout", help="fused-world rollout")
    ro.add_argument("config")
    ro.add_argument("--steps", type=int, default=900)
    ro.add_argument("--worlds", type=int, default=1)
    ro.add_argument("--seed", type=int, default=0)
    ro.add_argument("--save-state", dest="save_state",
                    help="checkpoint the final state to .npz")
    ro.add_argument("--resume", help="resume from a .npz checkpoint")
    ro.add_argument("--device", default="cuda")
    ro.set_defaults(fn=cmd_rollout)
    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
