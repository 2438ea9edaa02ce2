"""Rao-Blackwellized particle-filter grid SLAM in plain PyTorch: the
motion model, the fused update (``fused.py``), the weights, N_eff, the
systematic resample and how the resampled maps reach their slots.

A frozen copy of the port's plain paths (``core/motion.py``,
``core/math.py``, ``ops/resample.py``, ``ops/cow.cow_plan``,
``models/gridslam.update`` and ``update_fleet``) for the two resample
mechanisms that the benchmark's configurations take:

* ``deferred``: the maps stay where they are and the next update reads
  particle ``i``'s map from ``grids[ancestors[i]]`` (one world whose map
  set is small, the headline);
* ``cow``: every map is updated where it lies, then each extra child of
  an ancestor takes a freed slot, in the order the copy plan gives (a
  fleet of worlds on one device).

The mechanism fixes the slot order after a resample, and the draws are
indexed by slot, so the choice follows the port's rule line for line.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch

from h100bench.reference import fused

Tensor = torch.Tensor

_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)
_MIN_CENTER_STD = 0.01
_CENTER_STD_RATE = 0.05
_THETA_STD_BASE = 5.0 * 3.141592653589793 / 180.0
_THETA_STD_RATE = 0.1


@dataclasses.dataclass(frozen=True)
class SlamConfig:
    spec: fused.Spec
    n_particles: int
    max_scan_range: float
    resample_neff_frac: float
    grid_dtype: torch.dtype
    beam_spacing: Optional[float] = None  # None: taken from the scan

    @staticmethod
    def from_yaml(config: dict) -> "SlamConfig":
        """A ``!GridMapSlam`` block's ``config`` mapping."""
        pos = config.get("position", (-2.0, -2.0))
        if config.get("integrate") != "fused":
            raise ValueError("the reference follows integrate: fused only")
        for key in ("resample_cow", "fused_resident", "fleet_resample"):
            if config.get(key) is not None:
                raise ValueError(f"the reference follows the automatic "
                                 f"resample only, not {key}")
        return SlamConfig(
            spec=fused.Spec(float(pos[0]), float(pos[1]),
                            float(config.get("width", 4.0)),
                            float(config.get("height", 4.0)),
                            float(config.get("resolution", 0.02))),
            n_particles=int(config.get("n_particles", 10)),
            max_scan_range=float(config.get("max_scan_range", 1.0)),
            resample_neff_frac=float(config.get("resample_neff_frac", 1.0)),
            grid_dtype=(torch.bfloat16
                        if config.get("grid_dtype") == "bfloat16"
                        else torch.float32))


class SlamState(NamedTuple):
    poses: Tensor  # [.., P, 3]
    grids: Tensor  # [.., P, rows, padded cols]
    weights: Tensor  # [.., P]
    best_pose: Tensor  # [.., 3]
    best_idx: Tensor  # [..] i32
    ancestors: Tensor  # [.., P] i32, the pending lineage


class SlamOutputs(NamedTuple):
    pose: Tensor
    n_eff: Tensor


def mechanism(cfg: SlamConfig, worlds: int) -> str:
    """The port's choice with resample_cow, fused_resident and
    fleet_resample left to their defaults: one world takes the deferred
    lineage when its map set counts as resident (twice it plus 8 MiB in
    120 MiB) or the geometry allows the lineage kernel; a fleet on one
    device always copies on write."""
    if worlds:
        return "cow"
    spec = cfg.spec
    itemsize = torch.empty((), dtype=cfg.grid_dtype).element_size()
    grid_bytes = cfg.n_particles * spec.rows * spec.padded_cols * itemsize
    if grid_bytes > 1 << 30:
        raise ValueError("a map set over 1 GiB takes the tile pool, which "
                         "the reference does not follow")
    resident = 2 * grid_bytes + 8 * 2**20 <= 120 * 1024 * 1024
    rows, cols = spec.rows, spec.padded_cols
    wr = fused.window_rows(spec, cfg.max_scan_range)
    wr = min(wr, rows - rows % 8 if rows % 8 else rows)
    full_width = (cols <= 256
                  or fused.disc_half(spec, cfg.max_scan_range) > 64)
    hbm_ok = full_width and rows - wr <= wr
    return "deferred" if resident or hbm_ok else "cow"


# --- the motion model -------------------------------------------------

def _deltas(dl, dr, wheel_base):
    return (dl + dr) * 0.5, (dr - dl) / wheel_base


def _stds(dc, dt):
    return ((_MIN_CENTER_STD + torch.abs(dc) * _CENTER_STD_RATE) * 0.5,
            _THETA_STD_BASE + _THETA_STD_RATE * torch.abs(dt))


def motion_sample(pose, dl, dr, wheel_base, eps_c, eps_t):
    dc, dt = _deltas(dl, dr, wheel_base)
    c_std, t_std = _stds(dc, dt)
    batch = torch.broadcast_shapes(pose.shape[:-1], torch.as_tensor(dc).shape)
    eps_c = torch.broadcast_to(eps_c, batch).to(pose.dtype)
    eps_t = torch.broadcast_to(eps_t, batch).to(pose.dtype)
    center = dc + c_std * eps_c
    theta = pose[..., 2] + dt + t_std * eps_t
    x = pose[..., 0] + torch.cos(theta) * center
    y = pose[..., 1] + torch.sin(theta) * center
    return torch.stack([x, y, theta], dim=-1)


def _angle_diff(alpha, beta):
    two_pi = 2.0 * math.pi
    diff = torch.remainder(beta - alpha + math.pi, two_pi) - math.pi
    return torch.where(diff < -math.pi, diff + two_pi, diff)


def _normal_logpdf(x, mean, std):
    z = (x - mean) / std
    return -0.5 * z * z - torch.log(std) - _LOG_SQRT_2PI


def motion_log_prob(old, new, dl, dr, wheel_base):
    dc, dt = _deltas(dl, dr, wheel_base)
    c_std, t_std = _stds(dc, dt)
    center = torch.sqrt((old[..., 0] - new[..., 0]) ** 2
                        + (old[..., 1] - new[..., 1]) ** 2)
    angle = _angle_diff(old[..., 2], new[..., 2])
    return (_normal_logpdf(center, dc, c_std)
            + _normal_logpdf(angle, dt, t_std))


def integrate_exact(pose, sl, sr, wheel_base):
    sbar = (sr + sl) * 0.5
    theta = pose[..., 2] + (sr - sl) / wheel_base
    x = pose[..., 0] + sbar * torch.cos(theta)
    y = pose[..., 1] + sbar * torch.sin(theta)
    return torch.stack([x, y, theta], dim=-1)


# --- weights and the resample -------------------------------------------

def weigh_and_select(log_lik, log_motion, prev_weights, frac, p, u01):
    log_w = torch.log(prev_weights) + log_lik + log_motion
    log_w = log_w - torch.amax(log_w, dim=-1, keepdim=True)
    w = torch.exp(log_w)
    weights = w / torch.sum(w, dim=-1, keepdim=True)
    best_idx = torch.argmax(weights, dim=-1).to(torch.int32)
    n_eff = 1.0 / torch.sum(weights * weights, dim=-1)
    do_resample = n_eff <= frac * p
    # systematic: u_m = (u01 + m) / N, ancestor = #(cum_i < u_m)
    u01 = u01.to(weights.dtype)
    u = u01 / p + torch.arange(p, dtype=weights.dtype,
                               device=weights.device) / p
    cum = torch.cumsum(weights, dim=-1)
    idx = torch.sum(cum[..., None, :] < u[..., :, None], dim=-1)
    ancestors = torch.clamp(idx, 0, p - 1).to(torch.int32)
    identity = torch.arange(p, dtype=torch.int32, device=weights.device)
    fire = do_resample[..., None]
    ancestors = torch.where(fire, ancestors, identity)
    weights = torch.where(fire, torch.full_like(weights, 1.0 / p), weights)
    return weights, ancestors, best_idx, n_eff


def cow_plan(ancestors: Tensor):
    """Copy ``j < n`` moves map ``src[j]`` into freed slot ``dst[j]``: each
    ancestor keeps its own slot, its extra children take the freed slots
    in ascending order."""
    p = ancestors.shape[-1]
    dev = ancestors.device
    i32 = torch.int32
    j = torch.arange(p, dtype=i32, device=dev)
    counts = torch.zeros(p, dtype=i32, device=dev).index_add_(
        0, ancestors.long(), torch.ones(p, dtype=i32, device=dev))
    extra = torch.clamp_min(counts - 1, 0)
    bounds = torch.cumsum(extra, 0, dtype=i32)
    n = int(bounds[-1])
    src = torch.clamp(torch.searchsorted(bounds, j, right=True).to(i32),
                      0, p - 1)
    is_free = counts == 0
    rank = torch.cumsum(is_free, 0, dtype=i32) - 1
    free_sorted = torch.zeros(p + 1, dtype=i32, device=dev).scatter_(
        0, torch.where(is_free, rank, p).long(), j)[:p]
    return src[:n].long(), free_sorted[:n].long()


# --- one update -----------------------------------------------------------

def _dphi(cfg: SlamConfig, angles: Tensor):
    if cfg.beam_spacing is not None:
        return cfg.beam_spacing
    return angles[..., 1] - angles[..., 0]


def update(state: SlamState, scan, odometry, cfg: SlamConfig, noise,
           quantize=None, block=None):
    """One world's update with the deferred lineage: ``(state, outputs)``.
    ``scan`` is ``(angles, distances, valid, present)`` ``[B]``,
    ``odometry`` ``(left, right, wheel_base)``, ``noise`` ``(eps_c [P],
    eps_t [P], u01 [1])``."""
    angles, distances, valid, present = scan
    dl, dr, wb = odometry
    p, spec = cfg.n_particles, cfg.spec
    if mechanism(cfg, 0) != "deferred":
        raise ValueError("the reference follows one world by the deferred "
                         "lineage only")
    new_poses = motion_sample(state.poses, dl, dr, wb, noise[0], noise[1])
    rows, cols = state.grids.shape[-2:]
    prep = fused.prepare(rows, cols, new_poses, angles[0], distances, valid,
                         present, spec, angles.shape[-1], cfg.max_scan_range,
                         _dphi(cfg, angles))
    maps = state.grids[state.ancestors.long()]
    grids, log_lik = fused.plain_update(maps, prep, spec, angles.shape[-1],
                                        quantize, block)
    log_motion = motion_log_prob(state.poses, new_poses, dl, dr, wb)
    weights, ancestors, best_idx, n_eff = weigh_and_select(
        log_lik, log_motion, state.weights, cfg.resample_neff_frac, p,
        noise[2])
    best_pose = new_poses[best_idx.long()]
    new_state = SlamState(poses=new_poses[ancestors.long()], grids=grids,
                          weights=weights, best_pose=best_pose,
                          best_idx=best_idx, ancestors=ancestors)
    return new_state, SlamOutputs(best_pose, n_eff)


def update_fleet(state: SlamState, scan, odometry, cfg: SlamConfig, noise,
                 quantize=None, block=None):
    """A fleet's update (``[W, P, ...]``, one scan ``[W, B]`` and odometry
    ``[W]`` a world): every map updated where it lies, then one copy on
    write over the flattened maps."""
    angles, distances, valid, present = scan
    dl, dr, wb = odometry
    w, p = state.poses.shape[:2]
    spec = cfg.spec
    dev = state.poses.device
    new_poses = motion_sample(state.poses, dl[:, None], dr[:, None], wb,
                              noise[0], noise[1])
    rows, cols = state.grids.shape[-2:]
    flat_poses = new_poses.reshape(w * p, 3)
    grids = state.grids.reshape(w * p, rows, cols)
    prep = fused.prepare(rows, cols, flat_poses, angles[:, 0], distances,
                         valid, present, spec, angles.shape[-1],
                         cfg.max_scan_range, _dphi(cfg, angles))
    grids, log_lik = fused.plain_update(grids, prep, spec, angles.shape[-1],
                                        quantize, block)
    log_motion = motion_log_prob(state.poses, new_poses, dl[:, None],
                                 dr[:, None], wb)
    weights, ancestors, best_idx, n_eff = weigh_and_select(
        log_lik.reshape(w, p), log_motion, state.weights,
        cfg.resample_neff_frac, p, noise[2])
    best_pose = torch.gather(new_poses, 1, best_idx.long()[:, None, None]
                             .expand(w, 1, 3))[:, 0]
    offsets = (p * torch.arange(w, dtype=torch.int32, device=dev))[:, None]
    src, dst = cow_plan((ancestors + offsets).reshape(w * p))
    grids[dst] = grids[src]
    flat_poses = flat_poses.clone()
    flat_poses[dst] = flat_poses[src]
    identity = torch.arange(p, dtype=torch.int32, device=dev).expand(w, p)
    new_state = SlamState(poses=flat_poses.reshape(w, p, 3),
                          grids=grids.reshape(w, p, rows, cols),
                          weights=weights, best_pose=best_pose,
                          best_idx=best_idx,
                          ancestors=identity.contiguous())
    return new_state, SlamOutputs(best_pose, n_eff)


def materialized(state: SlamState) -> Tensor:
    """Each slot's map with the pending lineage applied."""
    if state.grids.dim() == 3:
        return state.grids[state.ancestors.long()]
    return torch.stack([g[a.long()] for g, a in zip(state.grids,
                                                   state.ancestors)])
