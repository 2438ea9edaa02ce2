"""ICP odometry in plain PyTorch: the point map and point-to-normal ICP of
antbern/slamrs's ``IcpPointMapper`` (slam/src/pointmap.rs:35-79,
slam/src/icp.rs:82-128), followed over a cadence rollout call from a
given state on the simulated world of ``reference/world.py``.

A frozen copy of the port's plain paths (``models/icp_mapper.update``,
``ops/icp.icp_point_to_normal``, ``compute_normals``, ``_pinv_solve``)
in float32, with the nearest neighbour as a brute-force argmin over the
map (no kernel), reading the scene and the mapper's settings from the
benchmark's own copy of the configuration.  TF32 is off, so every
float32 product is a float32 product.

Departures from the Rust reference, each the port's too:

* the nearest neighbour is a brute force over the valid map lanes with
  K4's per-pair arithmetic, ``d2 = q2 - 2 (px qx + py qy)`` with
  ``q2 = qx qx + qy qy``, each product and sum rounded, and the first
  index of the minimum on ties; the Rust mapper asks a kd-tree
  (``kd_tree::KdMap``, icp.rs:61-68,131-146), which finds an equally near
  point and may take another on ties;
* the 3 x 3 normal equations are solved in closed form (the adjugate,
  with a floor of ``1e-8 x trace`` on the diagonal that acts only when
  they are numerically singular) where the Rust code calls nalgebra's
  ``lstsq`` (icp.rs:211-215);
* the map is a buffer of ``capacity`` points (16,384 by default) whose
  appends past it are dropped; the Rust map grows without bound.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from h100bench.reference import world as ref_world

Tensor = torch.Tensor

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

_BIG = 1e30  # pushes map lanes at or past the count out of the argmin


class IcpConfig(NamedTuple):
    capacity: int
    iterations: int
    step_threshold: float | None


class IcpWorld(NamedTuple):
    """The fields ``reference/world.py``'s ``tick`` and ``lidar_scan``
    read, and the mapper's settings."""

    segments: Tensor
    segment_mask: Tensor
    wheel_base: float
    update_period: float
    scanner_range: float
    icp: IcpConfig


class IcpState(NamedTuple):
    points: Tensor  # f32[C, 2]
    count: Tensor  # i32[]
    pose: Tensor  # f32[3]
    initialized: Tensor  # bool[]


def icp_config(mapper: dict) -> IcpConfig:
    """The ``!IcpPointMapper`` node's settings (the port's defaults where
    the node gives none)."""
    if mapper.get("voxel_size") is not None:
        raise NotImplementedError("the reference has no voxel gate")
    icp = mapper.get("icp") or {}
    weights = icp.get("correspondence_weights") or {}
    threshold = (float(weights["threshold"])
                 if weights.get("_tag") == "Step" else None)
    return IcpConfig(capacity=int(mapper.get("capacity", 16384)),
                     iterations=int(icp.get("iterations", 10)),
                     step_threshold=threshold)


def build_world(graph: dict, device) -> IcpWorld:
    """The simulator's scene and parameters and the mapper's settings of a
    node graph; lines first, then each rectangle's four sides, as
    ``reference/world.build_world`` reads them (which needs a
    ``!GridMapSlam`` node)."""
    sim = ref_world.node(graph, "Simulator")
    lines, rects = [], []
    for obj in sim.get("scene") or []:
        if obj["_tag"] == "Line":
            lines.append((obj["x1"], obj["y1"], obj["x2"], obj["y2"]))
        elif obj["_tag"] == "Rectangle":
            rects.append((obj["x"], obj["y"], obj["width"], obj["height"]))
        else:
            raise ValueError(f"unknown scene object {obj['_tag']}")
    segs = [tuple(map(float, s)) for s in lines]
    for (x, y, w, h) in rects:
        segs += [(x, y, x + w, y), (x + w, y, x + w, y + h),
                 (x + w, y + h, x, y + h), (x, y + h, x, y)]
    arr = np.zeros((max(len(segs), 1), 4), np.float32)
    arr[:len(segs)] = np.asarray(segs, np.float32).reshape(-1, 4)
    params = dict(wheel_base=0.1, update_period=0.2, scanner_range=1.0)
    params.update(sim.get("parameters") or {})
    f32 = ref_world._f32
    return IcpWorld(
        segments=torch.from_numpy(arr).to(device),
        segment_mask=torch.arange(arr.shape[0], device=device) < len(segs),
        wheel_base=f32(params["wheel_base"]),
        update_period=f32(params["update_period"]),
        scanner_range=f32(params["scanner_range"]),
        icp=icp_config(ref_world.node(graph, "IcpPointMapper")))


# --- point-to-normal ICP ----------------------------------------------------

def rot2(theta: Tensor) -> Tensor:
    c, s = torch.cos(theta), torch.sin(theta)
    return torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)], -2)


def drot2(theta: Tensor) -> Tensor:
    c, s = torch.cos(theta), torch.sin(theta)
    return torch.stack([torch.stack([-s, -c], -1), torch.stack([c, -s], -1)],
                       -2)


def transform_points(points: Tensor, x: Tensor) -> Tensor:
    """R(x2) p + (x0, x1).  points [N, 2], x [3]."""
    return points @ rot2(x[..., 2]).transpose(-1, -2) + x[..., None, 0:2]


def compute_normals(q: Tensor, q_count: Tensor) -> Tensor:
    """``normalize(perp(q[i+1] - q[i-1]))`` on the interior lanes of the
    ``q_count`` leading ones, zero elsewhere (icp.rs:226-254)."""
    nq = q.shape[-2]
    diff = torch.roll(q, -1, dims=-2) - torch.roll(q, 1, dims=-2)
    perp = torch.stack([-diff[..., 1], diff[..., 0]], dim=-1)
    norm = torch.sqrt(torch.sum(perp * perp, dim=-1, keepdim=True))
    normal = torch.where(norm > 0.0,
                         perp / torch.where(norm > 0.0, norm, 1.0), 0.0)
    idx = torch.arange(nq, device=q.device)
    qc = q_count[..., None]
    interior = (idx >= 1) & (idx < qc - 1) & (qc > 2)
    return torch.where(interior[..., None], normal, 0.0)


def nearest(p: Tensor, q: Tensor, q_count: Tensor) -> Tensor:
    """The first index of the nearest of the ``q_count`` leading lanes of
    ``q [Nq, 2]`` for each of ``p [Np, 2]``, by K4's per-pair arithmetic;
    0 where the map is empty."""
    nq = q.shape[-2]
    qx, qy = q[..., 0], q[..., 1]
    valid = torch.arange(nq, device=q.device) < q_count[..., None]
    q2 = qx * qx + qy * qy + torch.where(valid, 0.0, _BIG)
    px, py = p[..., :, None, 0], p[..., :, None, 1]
    d2 = q2[..., None, :] - 2.0 * (px * qx[..., None, :]
                                   + py * qy[..., None, :])
    idx = torch.clamp_max(torch.argmin(d2, dim=-1), nq - 1).to(torch.int32)
    return torch.where(q_count[..., None] > 0, idx, 0)


def solve3(h: Tensor, b: Tensor, rcond: float = 1e-8) -> Tensor:
    """``h dx = b`` for the symmetric 3 x 3 ``h``: the adjugate over the
    determinant, ``rcond x trace`` added on the diagonal."""
    tr = h[..., 0, 0] + h[..., 1, 1] + h[..., 2, 2]
    lam = (rcond * torch.clamp_min(tr, 1e-30))[..., None, None]
    a_mat = h + lam * torch.eye(3, dtype=h.dtype, device=h.device)
    a, bb, c = a_mat[..., 0, 0], a_mat[..., 0, 1], a_mat[..., 0, 2]
    d, e, f = a_mat[..., 1, 1], a_mat[..., 1, 2], a_mat[..., 2, 2]
    c00 = d * f - e * e
    c01 = c * e - bb * f
    c02 = bb * e - c * d
    c11 = a * f - c * c
    c12 = bb * c - a * e
    c22 = a * d - bb * bb
    det = a * c00 + bb * c01 + c * c02
    inv_det = torch.where(torch.abs(det) > 1e-30, 1.0 / det, 0.0)
    x0 = c00 * b[..., 0] + c01 * b[..., 1] + c02 * b[..., 2]
    x1 = c01 * b[..., 0] + c11 * b[..., 1] + c12 * b[..., 2]
    x2 = c02 * b[..., 0] + c12 * b[..., 1] + c22 * b[..., 2]
    return torch.stack([x0, x1, x2], dim=-1) * inv_det[..., None]


def icp_point_to_normal(p: Tensor, p_mask: Tensor, q: Tensor,
                        q_count: Tensor, pose: Tensor, cfg: IcpConfig):
    """``cfg.iterations`` Gauss-Newton steps of the point-to-normal error
    ``e = n . (R p + t - q)`` from ``pose``; the Step weight ``e^2 <
    threshold^2`` (uniform without one), masked lanes weighing 0.
    Returns ``(pose, p under it)``."""
    q_normals = compute_normals(q, q_count)
    x = pose
    for _ in range(cfg.iterations):
        p_t = transform_points(p, x)
        corr = nearest(p_t, q, q_count).long()
        take = corr[..., None].expand(*corr.shape, 2)
        qc = torch.gather(q, -2, take)
        nc = torch.gather(q_normals, -2, take)
        e = torch.sum(nc * (p_t - qc), dim=-1)
        d_rp = p @ drot2(x[..., 2]).transpose(-1, -2)
        jac = torch.cat([nc, torch.sum(nc * d_rp, dim=-1, keepdim=True)], -1)
        if cfg.step_threshold is None:
            w = torch.ones_like(e)
        else:
            t = cfg.step_threshold
            w = (e * e < t * t).to(e.dtype)
        w = w * p_mask.to(e.dtype)
        h = torch.einsum("...ni,...nj->...ij", jac * w[..., None], jac)
        g = torch.einsum("...ni,...n->...i", jac, w * e)
        x = x + solve3(h, -g)
        theta = torch.atan2(torch.sin(x[..., 2]), torch.cos(x[..., 2]))
        x = torch.cat([x[..., 0:2], theta[..., None]], dim=-1)
    return x, transform_points(p, x)


# --- the point map ---------------------------------------------------------

def scan_points(scan) -> tuple[Tensor, Tensor]:
    """The scan's lanes as points in the robot's frame and the mask of the
    valid, present ones."""
    angles, distances, valid, present = scan
    a = 0.0 + angles
    px = 0.0 + torch.cos(a) * distances
    py = 0.0 + torch.sin(a) * distances
    return torch.stack([px, py], dim=-1), valid & present


def update(state: IcpState, scan, cfg: IcpConfig, quantize=None) -> IcpState:
    """One scan: matched against the map from the last estimate (the
    first scan leaves the pose and puts its raw points in), then its
    valid points under the new pose appended in lane order while the map
    has room.  ``quantize``: every scan and map point rounded to that
    dtype where it is read or appended (the control)."""
    p, mask = scan_points(scan)
    points = state.points
    if quantize is not None:
        p = p.to(quantize).to(p.dtype)
        points = points.to(quantize).to(points.dtype)
    pose, moved = icp_point_to_normal(p, mask, points, state.count,
                                      state.pose, cfg)
    first = not bool(state.initialized)
    if first:
        pose, moved = state.pose, p
    if quantize is not None:
        moved = moved.to(quantize).to(moved.dtype)
    count = int(state.count)
    new = moved[mask][:cfg.capacity - count]
    points = points.clone()
    points[count:count + new.shape[0]] = new
    return IcpState(points, torch.full_like(state.count, count + new.shape[0]),
                    pose, torch.ones_like(state.initialized))


class CallOutputs(NamedTuple):
    pose: Tensor  # [F, 3] the true pose at each scan
    icp_pose: Tensor  # [F, 3] the mapper's estimate after each scan


def follow_call(sim: ref_world.SimState, icp: IcpState, world: IcpWorld,
                left: float, right: float, n_steps: int, quantize=None):
    """One cadence rollout call of ``n_steps`` ticks at constant wheel
    speeds from ``(sim, icp)``: frames of idle ticks, each ending in a
    scan tick that updates the mapper, then the idle ticks after the last
    scan.  Returns ``(sim, icp, outputs)``."""
    dev = sim.pose.device
    f32 = ref_world._f32
    speed_l = torch.full((), f32(left), dtype=torch.float32, device=dev)
    speed_r = torch.full((), f32(right), dtype=torch.float32, device=dev)
    fired, timer = ref_world.fire_schedule(n_steps, sim.timer,
                                           world.update_period)
    scans = set(fired)
    poses, icp_poses = [], []
    for i in range(n_steps):
        sim, _ = ref_world.tick(sim, speed_l, speed_r, world,
                                force_fire=i in scans)
        if i in scans:
            icp = update(icp, ref_world.lidar_scan(sim.pose, world),
                         world.icp, quantize)
            sim = sim._replace(accum_left=torch.zeros_like(sim.accum_left),
                               accum_right=torch.zeros_like(sim.accum_right))
            poses.append(sim.pose)
            icp_poses.append(icp.pose)
    return (sim._replace(timer=timer), icp,
            CallOutputs(torch.stack(poses), torch.stack(icp_poses)))
