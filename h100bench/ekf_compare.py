"""What decides ``correct`` in an EKF landmark SLAM cell: the program's
outputs and filter held against the plain reference (``reference/ekf.py``),
followed from the checked call's input state with the call's landmark
draws.

The numbers are the largest gaps between the program's and the
reference's

* ``pose_gap``: every world's true and EKF pose of every frame, and
  after the call every world's true pose and its filter's whole mean
  (metres; radians for the headings, whose differences are wrapped to
  [-pi, pi));
* ``cov_gap``: every entry of every world's covariance after the call,
  over ``sqrt(Sigma_ii Sigma_jj)`` of the reference's (the absolute gap
  where that is 0);
* ``seen_gap``: the landmarks' ``seen`` flags after the call that differ.

The whole call is compared, not each update from the program's own
input: past the warm-up calls every landmark a world's circle passes is
seen, so no first sighting cancels the 1,000 prior inside the checked
call, and on the card float32 in another sum order stays within 1.1e-5 m
and 8.1e-5 of the covariance over a call, while TF32 and bfloat16
products move the filters by metres (``PERF.md`` §2).  As in
``compare.py``, a
frame more or less leaves the per-frame outputs of unequal length, which
reads as no number at all (``FAR``).

The controls put in the program's place (``control``): ``"reorder"``,
the reference with every matrix product summed in another float32 order
(``reference/ekf.reordered_product``); ``"tf32"``, the reference with
every matrix product a TF32 product (``reference/ekf.tf32_product``:
the operands rounded to TF32); and ``quantize``, the filter's mean and
covariance held in that dtype between updates.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from h100bench.reference import ekf as ref_ekf
from h100bench.reference import world as ref_world

_WORLD = ("pose", "accum_left", "accum_right")
CONTROLS = ("reorder", "tf32")


def host_buffers(state) -> dict:
    """Host tensors shaped as a port ``WorldState``'s simulator and EKF
    leaves, pinned when the state is on a card."""
    def like(t):
        return torch.empty(t.shape, dtype=t.dtype, pin_memory=t.is_cuda)

    return {"world": {n: like(getattr(state, n)) for n in _WORLD},
            "ekf": {n: like(getattr(state.ekf, n))
                    for n in ref_ekf.EkfState._fields}}


def world_to_host(state, into: dict) -> dict:
    """A port ``WorldState`` copied into :func:`host_buffers` ``into``
    (the host waits for the copies)."""
    for n in _WORLD:
        into["world"][n].copy_(getattr(state, n))
    for n in ref_ekf.EkfState._fields:
        into["ekf"][n].copy_(getattr(state.ekf, n))
    return {**into["world"], "timer": float(state.scan_timer),
            "ekf": into["ekf"]}


def observed(after: dict, outs: dict) -> dict:
    """The compared quantities of one side: the call's per-frame outputs
    and the state after it."""
    ekf = after["ekf"]
    return {"frames_pose": outs["pose"], "frames_ekf": outs["ekf_pose"],
            "pose": after["pose"], "mean": ekf["mean"], "cov": ekf["cov"],
            "seen": ekf["seen"]}


def pose_gap(a, b) -> float:
    """Largest absolute difference of two poses or means (``[.., 3]`` or
    ``[.., D]``), the heading's (index 2) wrapped; infinite when the
    shapes differ or a difference is not a number."""
    a = torch.as_tensor(a)
    b = torch.as_tensor(b).to(a.device)
    if a.shape != b.shape:
        return math.inf
    if a.numel() == 0:
        return 0.0
    d = a.to(torch.float64) - b.to(torch.float64)
    d[..., 2] = torch.remainder(d[..., 2] + math.pi, 2 * math.pi) - math.pi
    return float(torch.nan_to_num(d.abs(), nan=math.inf).max())


def cov_gap(a, b) -> float:
    """Largest entry of ``|a - b|`` over ``sqrt(b_ii b_jj)`` (``|a - b|``
    where that is 0) of two covariances ``[.., D, D]``."""
    a = torch.as_tensor(a)
    b = torch.as_tensor(b).to(a.device)
    if a.shape != b.shape:
        return math.inf
    diag = torch.diagonal(b, dim1=-2, dim2=-1).to(torch.float64)
    scale = torch.sqrt((diag[..., :, None] * diag[..., None, :]).abs())
    d = (a.to(torch.float64) - b.to(torch.float64)).abs()
    d = torch.where(scale > 0, d / torch.where(scale > 0, scale, 1.0), d)
    return float(torch.nan_to_num(d, nan=math.inf).max())


def numbers(prog: dict, ref: dict) -> dict:
    """The compared numbers between two sides' :func:`observed`."""
    seen_p, seen_r = (torch.as_tensor(s) for s in (prog["seen"],
                                                   ref["seen"]))
    return {
        "pose_gap": max(pose_gap(prog[k], ref[k]) for k in (
            "frames_pose", "frames_ekf", "pose", "mean")),
        "cov_gap": cov_gap(prog["cov"], ref["cov"]),
        "seen_gap": (float((seen_p.cpu() != seen_r.cpu()).sum())
                     if seen_p.shape == seen_r.shape else math.inf),
    }


def reference_world(yaml_text: str, workload: dict, device):
    graph = ref_world.load_yaml(yaml_text)
    sim = ref_world.node(graph, "Simulator")
    sim["parameters"] = {**(sim.get("parameters") or {}),
                         **workload.get("sim_parameters", {})}
    return ref_ekf.build_world(graph, device)


def follow(yaml_text: str, workload: dict, before: dict, draws, left: float,
           right: float, ticks: int, device, quantize=None,
           control=None) -> dict:
    """The reference's side of a checked call (or the control's), as
    :func:`observed`."""
    if control is not None and control not in CONTROLS:
        raise ValueError(f"unknown control {control!r}")
    world = reference_world(yaml_text, workload, device)
    sim = ref_world.SimState(before["pose"].to(device),
                             before["accum_left"].to(device),
                             before["accum_right"].to(device),
                             before["timer"])
    ekf = ref_ekf.EkfState(**{k: v.to(device)
                              for k, v in before["ekf"].items()})
    dev_draws = tuple(torch.from_numpy(np.asarray(d)).to(device)
                      for d in draws)
    product = {"reorder": ref_ekf.reordered_product,
               "tf32": ref_ekf.tf32_product}.get(control,
                                                 ref_ekf.matrix_product)
    sim, ekf, outs = ref_ekf.follow_call(sim, ekf, world, left, right,
                                         ticks, dev_draws, product, quantize)
    return observed({"pose": sim.pose, "ekf": ekf._asdict()},
                    {"pose": outs.pose, "ekf_pose": outs.ekf_pose})


def follow_and_compare(yaml_text, workload, before, after, outs, draws,
                       left, right, ticks, device, quantize=None,
                       control=None) -> dict:
    """The numbers between the program's checked call (or, with
    ``quantize`` or ``control``, the control in its place) and the
    reference."""
    ref = follow(yaml_text, workload, before, draws, left, right, ticks,
                 device)
    if quantize is None and control is None:
        prog = observed(after, {k: torch.from_numpy(v).to(device)
                                for k, v in outs.items()})
    else:
        prog = follow(yaml_text, workload, before, draws, left, right, ticks,
                      device, quantize, control)
    return numbers(prog, ref)
