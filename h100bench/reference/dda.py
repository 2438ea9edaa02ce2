"""Grid SLAM on the dda integrator in plain PyTorch, and the numbers that
decide ``correct`` for a cell whose world runs it.

The dda integrator is the Rust reference's own map update (antbern/slamrs
``slam/src/grid/ray.rs`` and ``map.rs``), which this file follows from
that description, not from the port's code:

* the DDA walk (``ray.rs:5-111``): from the floor cell of the start, a
  budget of one step, the 2 overshoot steps and every cell boundary
  crossed in x and in y; the error accumulator ``(floor(x0) + 1 - x0) *
  dy - (floor(y0) + 1 - y0) * dx`` (the far side's fraction when the ray
  runs backwards, infinite along an axis with no extent), the walk
  stepping in y while the error is above 0 and in x otherwise (a NaN,
  both extents 0, steps x by 0 and stays on the cell); a cell is emitted
  while budget is left and it lies in the grid, and the walk ends at the
  first cell outside it; cells are measured at their centres (+0.5);
* the inverse sensor model (``map.rs:148-172``): a hit beam marks cells
  nearer than its distance less half the 2-cell tolerance free, cells
  within the tolerance occupied and cells beyond it unknown; a beam that
  hit nothing marks the cells before its distance free;
* the endpoint likelihood (``map.rs:113-145``): for each valid beam whose
  endpoint lies in the grid, the log of ``Z_HIT * p + (1 - Z_HIT) /
  maxdist``, or of the uniform ``1 / maxdist`` where the cell is untouched
  (log-odds exactly 0);
* one update (``slam.rs:45-75``): the motion sample from the injected
  draws, the likelihood on the old maps at the sampled poses, the scan
  integrated into the old maps at the same poses, the motion
  log-probability, the weights and the N_eff-gated systematic resample
  (``slam.py``'s frozen copies), then every slot's pose and map gathered
  by its ancestor.

All in float32 on the device the check runs on, TF32 off.  What makes
the bits the program's, and why they must be:

* the grid coordinates divide by a 0-dim tensor of the cell size (CUDA's
  division by a Python number multiplies by its reciprocal);
* the walk runs every (particle, beam) lane at once for a static number
  of steps, ``ceil(range / cell * sqrt 2) + 2 + 3``; :func:`integrate`
  raises if a lane had budget left after them;
* every lane's increment is added with one ``index_put_(accumulate=
  True)`` over the lanes in particle, beam, step order, the lanes the
  walk did not emit adding 0.0 at their map's cell (0, 0).  That is the
  order in which the port sums them: PyTorch sorts the cells (stably) and
  adds each cell's lanes in turn on the card, in lane order on the CPU.
  Another order rounds a cell's log-odds otherwise; a changed log-odds
  moves a likelihood, a moved likelihood flips a pick of the systematic
  resample, and from there the filters part.

``quantize`` rounds the maps after each integrate through a narrower float
type: the benchmark's control (the reference one precision below the
configuration's float32 maps).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from h100bench import compare
from h100bench.reference import slam
from h100bench.reference import world as ref_world
from h100bench.reference.fused import (ADDITIONAL_STEPS, L_FREE, L_OCCUPIED,
                                       SENSOR_MAXDIST, TOLERANCE_CELLS,
                                       Z_HIT, Spec, f32)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class DdaConfig:
    spec: Spec
    n_particles: int
    max_scan_range: float
    resample_neff_frac: float

    @property
    def steps(self) -> int:
        """The walk's static step count for rays up to the scan range."""
        cells = self.max_scan_range / self.spec.resolution
        return int(math.ceil(cells * math.sqrt(2.0))) + ADDITIONAL_STEPS + 3

    @staticmethod
    def from_yaml(config: dict) -> "DdaConfig":
        """A ``!GridMapSlam`` block's ``config`` mapping (``integrate``
        left out is the dda, the port's default)."""
        if config.get("integrate", "dda") != "dda":
            raise ValueError("this reference follows integrate: dda only")
        pos = config.get("position", (-2.0, -2.0))
        return DdaConfig(
            spec=Spec(float(pos[0]), float(pos[1]),
                      float(config.get("width", 4.0)),
                      float(config.get("height", 4.0)),
                      float(config.get("resolution", 0.02))),
            n_particles=int(config.get("n_particles", 10)),
            max_scan_range=float(config.get("max_scan_range", 1.0)),
            resample_neff_frac=float(config.get("resample_neff_frac", 1.0)))


# --- the map update (ray.rs, map.rs) ----------------------------------------

def to_grid(spec: Spec, x: Tensor, y: Tensor):
    """World coordinates (metres) to grid coordinates (cells)."""
    res = f32(spec.resolution, x.device)
    return (x - spec.position_x) / res, (y - spec.position_y) / res


def endpoints(pose: Tensor, angles: Tensor, distances: Tensor):
    """Each beam's endpoint in the world, ``[P, B]`` x and y."""
    a = pose[:, 2:3] + angles
    return (pose[:, 0:1] + torch.cos(a) * distances,
            pose[:, 1:2] + torch.sin(a) * distances)


def walk(x0: Tensor, y0: Tensor, x1: Tensor, y1: Tensor, cols: int,
         rows: int, steps: int):
    """The DDA walk of every ray from ``(x0, y0)`` to ``(x1, y1)`` (grid
    coordinates, broadcast together) for ``steps`` steps: the cells
    ``x``, ``y`` (int64 ``[..., steps]``), whether each was emitted, and
    whether a ray still had budget left in the grid after the last."""
    x0, y0, x1, y1 = torch.broadcast_tensors(x0, y0, x1, y1)
    dx, dy = torch.abs(x1 - x0), torch.abs(y1 - y0)
    fx0, fy0 = torch.floor(x0), torch.floor(y0)
    x, y = fx0.long(), fy0.long()
    nx, ny = torch.floor(x1).long() - x, torch.floor(y1).long() - y
    forward_x, forward_y = x1 > x0, y1 > y0
    zero = torch.zeros_like(x)
    # ray.rs:36-66: the budget, the increments and the error
    budget = (1 + ADDITIONAL_STEPS
              + torch.where(dx == 0.0, zero, torch.abs(nx))
              + torch.where(dy == 0.0, zero, torch.abs(ny)))
    step_x = torch.where(dx == 0.0, zero,
                         torch.where(forward_x, 1, -1))
    step_y = torch.where(dy == 0.0, zero,
                         torch.where(forward_y, 1, -1))
    inf = torch.full_like(dx, math.inf)
    error = (torch.where(dx == 0.0, inf,
                         torch.where(forward_x, (fx0 + 1.0 - x0) * dy,
                                     (x0 - fx0) * dy))
             - torch.where(dy == 0.0, inf,
                           torch.where(forward_y, (fy0 + 1.0 - y0) * dx,
                                       (y0 - fy0) * dx)))

    def in_grid(x, y):
        return (x >= 0) & (x < cols) & (y >= 0) & (y < rows)

    cells_x, cells_y, emitted = [], [], []
    going = torch.ones_like(x, dtype=torch.bool)
    for _ in range(steps):
        # ray.rs:80-105: emit the cell, then step
        going = going & (budget > 0) & in_grid(x, y)
        cells_x.append(x)
        cells_y.append(y)
        emitted.append(going)
        up = error > 0.0
        x = torch.where(up, x, x + step_x)
        y = torch.where(up, y + step_y, y)
        error = torch.where(up, error - dx, error + dy)
        budget = budget - 1
    unfinished = going & (budget > 0) & in_grid(x, y)
    return (torch.stack(cells_x, -1), torch.stack(cells_y, -1),
            torch.stack(emitted, -1), unfinished)


def inverse_sensor_model(distance: Tensor, measured: Tensor,
                         hit: Tensor) -> Tensor:
    """map.rs:148-172 as log-odds; distances in cells."""
    half = TOLERANCE_CELLS / 2.0
    when_hit = torch.where(distance < measured - half, L_FREE,
                           torch.where(distance > measured + half, 0.0,
                                       L_OCCUPIED))
    when_missed = torch.where(distance < measured, L_FREE, 0.0)
    return torch.where(hit, when_hit, when_missed).to(torch.float32)


def integrate(grids: Tensor, spec: Spec, pose: Tensor, angles: Tensor,
              distances: Tensor, valid: Tensor, present: Tensor,
              steps: int) -> Tensor:
    """map.rs:71-106 for every particle: each present beam walks from the
    particle's cell to its endpoint's and adds each emitted cell's
    increment.  ``grids`` ``f32[P, H, W]``, ``pose`` ``[P, 3]``, the scan
    ``[B]``; returns new maps."""
    p, h, w = grids.shape
    sx, sy = to_grid(spec, pose[:, 0:1], pose[:, 1:2])  # [P, 1]
    ex, ey = to_grid(spec, *endpoints(pose, angles, distances))  # [P, B]
    cx, cy, emitted, unfinished = walk(sx, sy, ex, ey, spec.cols,
                                       spec.rows, steps)
    if bool(unfinished.any()):
        raise ValueError(f"a ray needs more than {steps} steps")
    lane = emitted & present[..., None]  # [P, B, T]
    ddx = (cx.to(torch.float32) + 0.5) - sx[..., None]
    ddy = (cy.to(torch.float32) + 0.5) - sy[..., None]
    dist = torch.sqrt(ddx * ddx + ddy * ddy)
    measured = distances / f32(spec.resolution, distances.device)
    inc = inverse_sensor_model(dist, measured[..., None], valid[..., None])
    inc = torch.where(lane, inc, 0.0)
    cell = torch.where(lane, cy * w + cx, 0)
    cell = cell + (torch.arange(p, device=grids.device) * (h * w))[:, None,
                                                                    None]
    out = grids.clone()
    out.view(-1).index_put_((cell.reshape(-1),), inc.reshape(-1),
                            accumulate=True)
    return out


def log_likelihood(grids: Tensor, spec: Spec, pose: Tensor, angles: Tensor,
                   distances: Tensor, valid: Tensor,
                   present: Tensor) -> Tensor:
    """map.rs:113-145 for every particle: ``f32[P]``."""
    p, h, w = grids.shape
    gx, gy = to_grid(spec, *endpoints(pose, angles, distances))
    inside = (gx >= 0.0) & (gy >= 0.0) & (gx < spec.cols) & (gy < spec.rows)
    use = valid & present & inside
    # the endpoint's cell: truncated; lanes outside are read but not used
    xi = torch.clamp(gx.to(torch.int32), 0, spec.cols - 1).long()
    yi = torch.clamp(gy.to(torch.int32), 0, spec.rows - 1).long()
    odds = torch.gather(grids.reshape(p, h * w), 1, yi * w + xi)
    prob = 1.0 - 1.0 / (1.0 + torch.exp(odds))
    mixture = Z_HIT * prob + (1.0 - Z_HIT) / SENSOR_MAXDIST
    factor = torch.where(odds == 0.0, 1.0 / SENSOR_MAXDIST, mixture)
    return torch.sum(torch.where(use, torch.log(factor), 0.0), dim=-1)


# --- one update and a call ------------------------------------------------

def update(state: slam.SlamState, scan, odometry, cfg: DdaConfig, noise,
           quantize=None):
    """One update (slam.rs:45-75) with the whole-set gather:
    ``(state, outputs)``.  ``scan`` is ``(angles, distances, valid,
    present)`` ``[B]``, ``odometry`` ``(left, right, wheel_base)``,
    ``noise`` ``(eps_c [P], eps_t [P], u01 [1])``."""
    angles, distances, valid, present = scan
    dl, dr, wb = odometry
    beams = (angles, distances, valid, present)
    poses = slam.motion_sample(state.poses, dl, dr, wb, noise[0], noise[1])
    log_lik = log_likelihood(state.grids, cfg.spec, poses, *beams)
    grids = integrate(state.grids, cfg.spec, poses, *beams, cfg.steps)
    if quantize is not None:
        grids = grids.to(quantize).to(torch.float32)
    log_motion = slam.motion_log_prob(state.poses, poses, dl, dr, wb)
    weights, ancestors, best_idx, n_eff = slam.weigh_and_select(
        log_lik, log_motion, state.weights, cfg.resample_neff_frac,
        cfg.n_particles, noise[2])
    best_pose = poses[best_idx.long()]
    pick = ancestors.long()
    new_state = slam.SlamState(
        poses=poses[pick], grids=grids[pick], weights=weights,
        best_pose=best_pose, best_idx=best_idx,
        ancestors=torch.arange(cfg.n_particles, dtype=torch.int32,
                               device=poses.device))
    return new_state, slam.SlamOutputs(best_pose, n_eff)


def reference_world(yaml_text: str, workload: dict, device):
    """The configuration's world: ``world.py``'s scene and simulator
    parameters (with the cell's ``sim_parameters``) and this file's
    filter configuration."""
    graph = ref_world.load_yaml(yaml_text)
    node = ref_world.node(graph, "GridMapSlam")
    cfg = DdaConfig.from_yaml(node["config"])
    # world.py builds the fused filter's config beside the scene; one
    # that it accepts stands in, replaced below
    node["config"] = {"integrate": "fused"}
    sim = ref_world.node(graph, "Simulator")
    sim["parameters"] = {**(sim.get("parameters") or {}),
                         **workload.get("sim_parameters", {})}
    return ref_world.build_world(graph, device)._replace(slam=cfg)


def follow_call(sim: ref_world.SimState, grid: slam.SlamState, world,
                left: float, right: float, n_steps: int, draws,
                quantize=None):
    """One cadence rollout call of ``n_steps`` ticks at constant wheel
    speeds from ``(sim, grid)``, each scan tick's filter update
    :func:`update` with frame ``f``'s ``draws``: ``(sim, grid,
    outputs)``."""
    dev = sim.pose.device
    speed_l = torch.full((), ref_world._f32(left), dtype=torch.float32,
                         device=dev)
    speed_r = torch.full((), ref_world._f32(right), dtype=torch.float32,
                         device=dev)
    fired, timer = ref_world.fire_schedule(n_steps, sim.timer,
                                           world.update_period)
    poses, best, n_eff = [], [], []
    for i in range(n_steps):
        f = len(poses)
        scans = f < len(fired) and i == fired[f]
        sim, _ = ref_world.tick(sim, speed_l, speed_r, world,
                                force_fire=scans)
        if scans:
            odometry = (sim.accum_left, sim.accum_right, world.wheel_base)
            grid, out = update(grid, ref_world.lidar_scan(sim.pose, world),
                               odometry, world.slam,
                               tuple(d[f] for d in draws), quantize)
            sim = sim._replace(accum_left=torch.zeros_like(sim.accum_left),
                               accum_right=torch.zeros_like(sim.accum_right))
            poses.append(sim.pose)
            best.append(out.pose)
            n_eff.append(out.n_eff)
    return (sim._replace(timer=timer), grid,
            ref_world.CallOutputs(torch.stack(poses), torch.stack(best),
                                  torch.stack(n_eff)))


# --- the comparison ------------------------------------------------------

def follow(yaml_text: str, workload: dict, before: dict, draws, left: float,
           right: float, ticks: int, device, quantize=None) -> dict:
    """The reference's side of a checked call from its input state
    ``before`` (host tensors; each slot's map read through the pending
    lineage), as ``compare.observed``."""
    world = reference_world(yaml_text, workload, device)
    sim = ref_world.SimState(before["pose"].to(device),
                             before["accum_left"].to(device),
                             before["accum_right"].to(device),
                             before["timer"])
    grid = compare.grid_from_host(before["grid"], device)
    grid = grid._replace(grids=slam.materialized(grid),
                         ancestors=torch.arange(world.slam.n_particles,
                                                dtype=torch.int32,
                                                device=device))
    dev_draws = tuple(torch.from_numpy(np.asarray(d)).to(device)
                      for d in draws)
    sim, grid, outs = follow_call(sim, grid, world, left, right, ticks,
                                  dev_draws, quantize)
    return compare.observed({"pose": sim.pose, "grid": grid},
                            {"pose": outs.pose, "grid_pose": outs.grid_pose,
                             "n_eff": outs.n_eff})


def follow_and_compare(yaml_text, workload, before, after, outs, draws,
                       left, right, ticks, device, quantize=None) -> dict:
    """The numbers between the program's checked call (or, with
    ``quantize``, the control in its place) and the reference:
    ``compare.numbers``' ``pose_gap``, ``n_eff_gap`` and ``map_gap``."""
    ref = follow(yaml_text, workload, before, draws, left, right, ticks,
                 device)
    if quantize is None:
        prog = compare.program_side(after, outs, device)
    else:
        prog = follow(yaml_text, workload, before, draws, left, right, ticks,
                      device, quantize)
    return compare.numbers(prog, ref, int(before["grid"]["poses"].shape[-2]))
