"""CLI: ``python -m slamrs_tpu_torch <command>``.

    run      <config.yaml> [--duration S] [--realtime] [--teleop]
             [--png out.png] [--npz out.npz] [--device cuda]
    rollout  <config.yaml> [--steps N] [--worlds W] [--seed S]
             [--save-state s.npz] [--resume s.npz] [--device cuda]
    robot    [--host H] [--port P] [--cdc] [--device cuda]
    replay   <file.bin>

``run`` drives the YAML's node graph (``graph/app.py``) headlessly for
``--duration`` seconds of simulated time; ``--teleop`` drives its
``!Controls`` node from the keyboard, ``--png`` draws the last frame
(needs matplotlib) and ``--npz`` saves the visualizer's topics.

``rollout`` runs the fused world of a YAML node graph through
``rollout_cadence``, as one world or as a fleet of ``W`` worlds on one
device (on the card each scan frame is a CUDA graph replay,
``graph/capture.py``; on the CPU the eager frame loop), and prints one
JSON report: steps, worlds, scans, final
ground-truth pose (one per world for a fleet), and, for each filter the
world runs (grid SLAM's best particle, the ICP mapper, the EKF), the
RMSE of its pose against ground truth over every world and scan frame.
``--resume`` starts from a checkpoint (the port's, or one written by
``python -m slamrs_tpu rollout --save-state``) and ``--save-state``
writes the final state (``utils/checkpoint.py``): ordinary tensors, the
captured run's static buffers, which outlive its graphs.

``robot`` serves a virtual robot (``io/virtual_robot.py``, a model of
the robot's firmware) in a small walled scene, over TCP or, with
``--cdc``, over a pty standing for the USB-CDC serial port, so a
``!RobotConnection`` drives it as it would the robot; its lidar raycast
runs on ``--device``.  ``replay`` parses a recorded Neato ``.bin`` log
and prints one JSON line, the frame count and the median count of valid
beams a frame; it only parses bytes and needs no device.

The device defaults to ``cuda`` and nothing falls back: without CUDA it
stops with an error, and ``--device cpu`` must be asked for.  The JAX
package's ``bench`` has no subcommand here: the port's benchmark is
``python3 -m h100bench.run``.
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


# cmd_robot's scene: a 4 x 4 m room with a box and a slanted wall
ROBOT_RECTS = [(-2.0, -2.0, 4.0, 4.0), (-0.1, -0.4, 0.5, 0.1)]
ROBOT_LINES = [(-0.6, -0.4, 0.2, 0.4)]


class _SocketMedium:
    """The virtual robot's side of a TCP connection: 50 ms reads (``b""``
    on a timeout, None at the end of the stream), and writes with a 5 s
    window so a frame is never cut when the host's reader lags."""

    def __init__(self, sock):
        self.sock = sock
        sock.settimeout(0.05)

    def read(self, n):
        import socket

        try:
            data = self.sock.recv(n)
        except socket.timeout:
            return b""
        return data if data else None

    def write(self, data):
        self.sock.settimeout(5.0)
        try:
            self.sock.sendall(data)
        finally:
            self.sock.settimeout(0.05)

    def close(self):
        self.sock.close()


def cmd_robot(args) -> None:
    """Serve a virtual robot until ctrl-C.  SIGINT only sets a flag: the
    main thread polls it between short waits, so the server in use stops
    at a step boundary, is joined and its device synchronized before the
    process exits with code 0 (a KeyboardInterrupt raised in the middle
    of that shutdown could leave its thread running into finalization)."""
    import signal
    import socket
    import threading

    from slamrs_tpu_torch.io.virtual_robot import (UsbCdcServer,
                                                   VirtualRobot,
                                                   VirtualRobotServer)
    from slamrs_tpu_torch.models.simulator import Scene

    device = _device(args.device)
    scene = Scene.build(rects=ROBOT_RECTS, lines=ROBOT_LINES, device=device)
    stop = threading.Event()
    signal.signal(signal.SIGINT, lambda *_: stop.set())

    def robot():
        return VirtualRobot(scene=scene, scanner_range=5.0, device=device)

    def serve(thread) -> None:
        while thread.is_alive() and not stop.is_set():
            thread.join(0.2)

    if args.cdc:
        # the host opens the printed path as `serial:` of a !RobotConnection
        server = UsbCdcServer(robot(), realtime=True)
        print(f"virtual robot (USB-CDC) at {server.path}", file=sys.stderr,
              flush=True)
        try:
            serve(server._thread)
        finally:
            server.close()
        return
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind((args.host, args.port))
    srv.listen(1)
    srv.settimeout(0.2)  # wake to see the stop flag
    print(f"virtual robot listening on {args.host}:{args.port}",
          file=sys.stderr, flush=True)
    try:
        while not stop.is_set():
            try:
                conn, addr = srv.accept()
            except socket.timeout:
                continue
            print(f"host connected: {addr}", file=sys.stderr, flush=True)
            server = VirtualRobotServer(robot(), _SocketMedium(conn),
                                        realtime=True)
            try:
                serve(server._thread)
            finally:
                # unblock a read or a send in flight, so the server thread
                # reaches its step boundary
                try:
                    conn.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                server.close()
            print("host disconnected", file=sys.stderr, flush=True)
    finally:
        srv.close()


def cmd_replay(args) -> None:
    import numpy as np

    from slamrs_tpu_torch.io.neato import load_neato_binary

    frames = load_neato_binary(args.file)
    valid = np.array([(f.valid != 0).sum() for f in frames])
    print(json.dumps({
        "frames": len(frames),
        "valid_beams_median": int(np.median(valid)) if len(frames) else 0,
    }))


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        prog="slamrs_tpu_torch",
        epilog="The JAX package's bench subcommand has no counterpart "
               "here: the port's benchmark is python3 -m h100bench.run.")
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

    vr = sub.add_parser("robot", help="serve a virtual robot over TCP "
                                      "(or a pty with --cdc)")
    vr.add_argument("--host", default="0.0.0.0")
    vr.add_argument("--port", type=int, default=8080)
    vr.add_argument("--cdc", action="store_true",
                    help="serve over a pty (the USB-CDC bridge, "
                         "tasks/usb.rs); prints the tty path")
    vr.add_argument("--device", default="cuda",
                    help="where the lidar raycast runs")
    vr.set_defaults(fn=cmd_robot)

    rp = sub.add_parser("replay", help="parse a recorded Neato .bin log")
    rp.add_argument("file")
    rp.set_defaults(fn=cmd_replay)
    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
