"""What decides ``correct`` in an ICP odometry cell: the program's outputs
and state held against the plain reference (``reference/icp.py``),
followed from the checked call's input state.

The numbers are the largest gaps between the program's and the
reference's

* ``pose_gap``: the true and the ICP pose of every frame, and both after
  the call (metres and radians);
* ``map_gap``: every point of the map after the call (metres); a map of
  another point count reads as ``FAR``.

As in ``compare.py``, a frame more or less leaves the per-frame outputs
of unequal length, which reads as no number at all (``FAR``).  The
control is the reference with every scan and map point rounded to the
configuration's ``control_dtype`` put in the program's place.
"""

from __future__ import annotations

import math

import torch

from h100bench import compare
from h100bench.reference import icp as ref_icp
from h100bench.reference import world as ref_world

_WORLD = ("pose", "accum_left", "accum_right")


def host_buffers(state) -> dict:
    """Host tensors shaped as a port ``WorldState``'s simulator and ICP
    leaves, pinned when the state is on a card."""
    def like(t):
        return torch.empty(t.shape, dtype=t.dtype, pin_memory=t.is_cuda)

    return {"world": {n: like(getattr(state, n)) for n in _WORLD},
            "icp": {n: like(getattr(state.icp, n))
                    for n in ref_icp.IcpState._fields}}


def world_to_host(state, into: dict) -> dict:
    """A port ``WorldState`` copied into :func:`host_buffers` ``into``
    (the host waits for the copies)."""
    for n in _WORLD:
        into["world"][n].copy_(getattr(state, n))
    for n in ref_icp.IcpState._fields:
        into["icp"][n].copy_(getattr(state.icp, n))
    return {**into["world"], "timer": float(state.scan_timer),
            "icp": into["icp"]}


def observed(after: dict, outs: dict) -> dict:
    """The compared quantities of one side: the call's per-frame outputs
    and the state after it."""
    icp = after["icp"]
    return {"frames_pose": outs["pose"], "frames_icp": outs["icp_pose"],
            "pose": after["pose"], "icp_pose": icp["pose"],
            "points": icp["points"], "count": int(icp["count"])}


def numbers(prog: dict, ref: dict) -> dict:
    """The compared numbers between two sides' :func:`observed`."""
    n = ref["count"]
    return {
        "pose_gap": max(compare.gap(prog[k], ref[k]) for k in (
            "frames_pose", "frames_icp", "pose", "icp_pose")),
        "map_gap": (compare.gap(prog["points"][:n], ref["points"][:n])
                    if prog["count"] == n else math.inf),
    }


def reference_world(yaml_text: str, workload: dict, device):
    graph = ref_world.load_yaml(yaml_text)
    sim = ref_world.node(graph, "Simulator")
    sim["parameters"] = {**(sim.get("parameters") or {}),
                         **workload.get("sim_parameters", {})}
    return ref_icp.build_world(graph, device)


def follow(yaml_text: str, workload: dict, before: dict, left: float,
           right: float, ticks: int, device, quantize=None) -> dict:
    """The reference's side of a checked call, as :func:`observed`."""
    world = reference_world(yaml_text, workload, device)
    sim = ref_world.SimState(before["pose"].to(device),
                             before["accum_left"].to(device),
                             before["accum_right"].to(device),
                             before["timer"])
    icp = ref_icp.IcpState(**{k: v.to(device)
                              for k, v in before["icp"].items()})
    sim, icp, outs = ref_icp.follow_call(sim, icp, world, left, right, ticks,
                                         quantize)
    return observed({"pose": sim.pose, "icp": icp._asdict()},
                    {"pose": outs.pose, "icp_pose": outs.icp_pose})


def follow_and_compare(yaml_text, workload, before, after, outs, left, right,
                       ticks, device, quantize=None) -> dict:
    """The numbers between the program's checked call (or, with
    ``quantize``, the control in its place) and the reference."""
    ref = follow(yaml_text, workload, before, left, right, ticks, device)
    if quantize is None:
        prog = observed(after, {k: torch.from_numpy(v).to(device)
                                for k, v in outs.items()})
    else:
        prog = follow(yaml_text, workload, before, left, right, ticks,
                      device, quantize)
    return numbers(prog, ref)
