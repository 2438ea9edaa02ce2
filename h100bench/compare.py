"""What decides ``correct``: the program's outputs and states held against
the plain reference (``reference/``), followed from the program's own
state with the same draws, and the numbers compared with their limits.

A cadence rollout call: the reference follows the checked call from the
state the call was given (its input state, copied to the host before the
call) and the numbers are the largest gaps between the program's and the
reference's

* ``pose_gap``: true poses and best-particle poses of every frame, and
  the particles', the best pose and the true pose after the call (metres
  and radians);
* ``n_eff_gap``: N_eff of every frame over the particle count, and the
  weights after the call times the particle count;
* ``map_gap``: every cell of every particle's map after the call, the
  pending lineage applied (log-odds).

The scan timer and the frame count are not compared by themselves: a
frame at another tick than the reference's moves the true pose, and a
frame more or less leaves the per-frame outputs of unequal length, which
reads as no number at all (``FAR``).

The control is the reference computed one precision below the
configuration's maps (``control_dtype``) put in the program's place.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from h100bench.reference import slam as ref_slam
from h100bench.reference import world as ref_world

FAR = 1e300  # a compared number that could not be read


_WORLD = ("pose", "accum_left", "accum_right")
_GRID = ("poses", "grids", "weights", "best_pose", "best_idx", "ancestors")


def host_buffers(state) -> dict:
    """Host tensors shaped as a port ``WorldState``'s, pinned when the
    state is on a card (so that a copy into them runs at full speed)."""
    def like(t):
        return torch.empty(t.shape, dtype=t.dtype, pin_memory=t.is_cuda)

    return {"world": {n: like(getattr(state, n)) for n in _WORLD},
            "grid": {n: like(getattr(state.grid, n)) for n in _GRID}}


def world_to_host(state, into: dict) -> dict:
    """A port ``WorldState`` copied into :func:`host_buffers` ``into``
    (the host waits for the copies)."""
    for n in _WORLD:
        into["world"][n].copy_(getattr(state, n))
    for n in _GRID:
        into["grid"][n].copy_(getattr(state.grid, n))
    return {**into["world"], "timer": float(state.scan_timer),
            "grid": into["grid"]}


def grid_from_host(h: dict, device) -> ref_slam.SlamState:
    return ref_slam.SlamState(**{k: v.to(device) for k, v in h.items()})


def gap(a, b) -> float:
    """Largest absolute difference (infinite when the shapes differ)."""
    a = torch.as_tensor(a)
    b = torch.as_tensor(b).to(a.device)
    if a.shape != b.shape:
        return math.inf
    if a.numel() == 0:
        return 0.0
    d = (a.to(torch.float64) - b.to(torch.float64)).abs()
    return float(torch.nan_to_num(d, nan=math.inf).max())


def observed(after: dict, outs: dict) -> dict:
    """The compared quantities of one side: the call's per-frame outputs
    and the state after it (its grid on its device)."""
    g = after["grid"]
    return {"frames_pose": outs["pose"], "frames_best": outs["grid_pose"],
            "frames_n_eff": outs["n_eff"], "pose": after["pose"],
            "poses": g.poses, "best_pose": g.best_pose,
            "weights": g.weights, "maps": ref_slam.materialized(g)}


def numbers(prog: dict, ref: dict, p: int) -> dict:
    """The compared numbers between two sides' :func:`observed`."""
    return {
        "pose_gap": max(gap(prog[k], ref[k]) for k in (
            "frames_pose", "frames_best", "pose", "poses", "best_pose")),
        "n_eff_gap": max(gap(prog["frames_n_eff"], ref["frames_n_eff"]) / p,
                         gap(prog["weights"], ref["weights"]) * p),
        "map_gap": gap(prog["maps"].float(), ref["maps"].float()),
    }


def reference_world(yaml_text: str, workload: dict, device):
    graph = ref_world.load_yaml(yaml_text)
    sim = ref_world.node(graph, "Simulator")
    sim["parameters"] = {**(sim.get("parameters") or {}),
                         **workload.get("sim_parameters", {})}
    return ref_world.build_world(graph, device)


def follow(yaml_text: str, workload: dict, before: dict, draws, left: float,
           right: float, ticks: int, device, quantize=None) -> dict:
    """The reference's side of a checked call, as :func:`observed`."""
    world = reference_world(yaml_text, workload, device)
    sim = ref_world.SimState(before["pose"].to(device),
                             before["accum_left"].to(device),
                             before["accum_right"].to(device),
                             before["timer"])
    grid = grid_from_host(before["grid"], device)
    dev_draws = tuple(torch.from_numpy(np.asarray(d)).to(device)
                      for d in draws)
    sim, grid, outs = ref_world.follow_call(
        sim, grid, world, left, right, ticks, dev_draws, quantize,
        workload.get("reference_block"))
    return observed({"pose": sim.pose, "grid": grid},
                    {"pose": outs.pose, "grid_pose": outs.grid_pose,
                     "n_eff": outs.n_eff})


def program_side(after: dict, outs: dict, device) -> dict:
    side = dict(after, grid=grid_from_host(after["grid"], device))
    return observed(side, {k: torch.from_numpy(v).to(device)
                           for k, v in outs.items()})


def follow_and_compare(yaml_text, workload, before, after, outs, draws,
                       left, right, ticks, device, quantize=None) -> dict:
    """The numbers between the program's checked call (or, with
    ``quantize``, the control in its place) and the reference."""
    ref = follow(yaml_text, workload, before, draws, left, right, ticks,
                 device)
    if quantize is None:
        prog = program_side(after, outs, device)
    else:
        prog = follow(yaml_text, workload, before, draws, left, right, ticks,
                      device, quantize)
    p = int(before["grid"]["poses"].shape[-2])
    return numbers(prog, ref, p)


def compared(values: dict, limits: dict) -> dict:
    """``{name: {"value", "limit"}}`` for every limit; a value that is
    missing or not finite reads as ``FAR`` (JSON has no infinity)."""
    out = {}
    for name, limit in limits.items():
        v = values.get(name)
        v = FAR if v is None or not math.isfinite(v) else float(v)
        out[name] = {"value": v, "limit": float(limit)}
    return out
