"""The simulated world in plain PyTorch: the scene, the 360-beam lidar,
the exact differential-drive motion and the float32 scan timer, and the
cadence rollout (frames of idle ticks, each ending in a scan tick that
feeds grid SLAM) followed from a given state.

A frozen copy of the port's plain paths (``models/simulator.py``,
``ops/raycast.py``, ``graph/compile.FusedWorld.frame`` / ``idle`` /
``step`` / ``fire_schedule``), reading the scene and the parameters from
the benchmark's own copy of the configuration (``load_yaml``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from h100bench.reference import slam

Tensor = torch.Tensor

DT = 1.0 / 30.0
NUM_BEAMS = 360
NO_HIT = 1e30


def load_yaml(text: str) -> dict:
    """A node-graph YAML as plain data: ``!Tag`` mappings become
    ``{"_tag": tag, **fields}``."""
    import yaml

    class Loader(yaml.SafeLoader):
        pass

    def tagged(loader, suffix, node):
        if isinstance(node, yaml.MappingNode):
            return {"_tag": suffix, **loader.construct_mapping(node, deep=True)}
        if isinstance(node, yaml.SequenceNode):
            return {"_tag": suffix,
                    "items": loader.construct_sequence(node, deep=True)}
        return {"_tag": suffix}

    Loader.add_multi_constructor("!", tagged)
    return yaml.load(text, Loader=Loader)


def node(graph: dict, tag: str) -> dict:
    for n in graph.get("nodes") or []:
        if n.get("_tag") == tag:
            return n
    raise KeyError(f"no !{tag} node")


def _f32(v) -> float:
    return float(np.float32(v))


class World(NamedTuple):
    segments: Tensor  # f32[S, 4]
    segment_mask: Tensor  # bool[S]
    wheel_base: float
    update_period: float
    scanner_range: float
    slam: slam.SlamConfig


def build_world(graph: dict, device) -> World:
    """The simulator's scene and parameters and the grid SLAM config of a
    node graph; lines first, then each rectangle's four sides."""
    sim = node(graph, "Simulator")
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
    return World(
        segments=torch.from_numpy(arr).to(device),
        segment_mask=torch.arange(arr.shape[0], device=device) < len(segs),
        wheel_base=_f32(params["wheel_base"]),
        update_period=_f32(params["update_period"]),
        scanner_range=_f32(params["scanner_range"]),
        slam=slam.SlamConfig.from_yaml(node(graph, "GridMapSlam")["config"]))


def raycast(origin, angles, segments, segment_mask):
    directions = torch.stack([torch.cos(angles), torch.sin(angles)], dim=-1)
    o = torch.broadcast_to(origin[..., None, :], directions.shape)
    x1, y1 = segments[..., 0], segments[..., 1]
    x2, y2 = segments[..., 2], segments[..., 3]
    x3, y3 = o[..., 0:1], o[..., 1:2]
    dx, dy = directions[..., 0:1], directions[..., 1:2]
    denom = (x1 - x2) * (-dy) - (y1 - y2) * (-dx)
    safe = torch.where(denom == 0.0, torch.ones_like(denom), denom)
    t = ((x1 - x3) * (-dy) - (y1 - y3) * (-dx)) / safe
    u = -((x1 - x2) * (y1 - y3) - (y1 - y2) * (x1 - x3)) / safe
    ok = (denom != 0.0) & (t >= 0.0) & (t <= 1.0) & (u > 0.0) & segment_mask
    dist = torch.amin(torch.where(ok, u, torch.full_like(u, NO_HIT)), dim=-1)
    return dist, dist < NO_HIT


def lidar_scan(pose: Tensor, world: World):
    """``(angles, distances, valid, present)`` from ``pose [..., 3]``."""
    dev = pose.device
    rel = torch.deg2rad(torch.arange(NUM_BEAMS, dtype=torch.float32,
                                     device=dev))
    batch = pose.shape[:-1]
    rel = torch.broadcast_to(rel, (*batch, NUM_BEAMS))
    dist, hit = raycast(pose[..., 0:2], pose[..., 2:3] + rel, world.segments,
                        world.segment_mask)
    rng = torch.full_like(dist, world.scanner_range)
    valid = hit & (dist < rng)
    distances = torch.where(hit, torch.where(valid, dist, rng), 0.0)
    return rel, distances, valid, hit


def timer_step(timer: float, period: float, dt: float = DT):
    """The float32 host scan timer of one tick: ``(timer, fired)``."""
    t = np.float32(np.float32(timer) + np.float32(dt))
    fired = bool(t > np.float32(period))
    if fired:
        t = np.float32(t - np.float32(period))
    return float(t), fired


class SimState(NamedTuple):
    pose: Tensor  # f32[.., 3]
    accum_left: Tensor
    accum_right: Tensor
    timer: float


def tick(sim: SimState, left: Tensor, right: Tensor, world: World,
         force_fire: bool = False):
    """One tick's motion under wheel speeds ``left``, ``right`` (0-dim
    f32): ``(sim, fired)``; a scan tick's wheel travel is left in the
    accumulators for the update to read."""
    dt32 = _f32(DT)
    sl, sr = left * dt32, right * dt32
    pose = slam.integrate_exact(sim.pose, sl, sr, world.wheel_base)
    timer, fired = timer_step(sim.timer, world.update_period)
    fired = fired or force_fire or world.update_period == 0.0
    return SimState(pose, sim.accum_left + sl, sim.accum_right + sr,
                    timer), fired


def scan_update(sim: SimState, grid: slam.SlamState, world: World, noise,
                quantize=None, block=None):
    """The scan tick's filter update from the accumulated wheel travel:
    ``(sim with the accumulators reset, grid, outputs)``."""
    scan = lidar_scan(sim.pose, world)
    odometry = (sim.accum_left, sim.accum_right, world.wheel_base)
    update = slam.update_fleet if sim.pose.dim() > 1 else slam.update
    grid, out = update(grid, scan, odometry, world.slam, noise, quantize,
                       block)
    zero_l, zero_r = (torch.zeros_like(sim.accum_left),
                      torch.zeros_like(sim.accum_right))
    return sim._replace(accum_left=zero_l, accum_right=zero_r), grid, out


def fire_schedule(n_steps: int, timer: float, period: float):
    fired = []
    for i in range(n_steps):
        timer, f = timer_step(timer, period)
        if f:
            fired.append(i)
    return fired, timer


class CallOutputs(NamedTuple):
    pose: Tensor  # [F, .., 3] the true pose at each scan
    grid_pose: Tensor  # [F, .., 3] the best particle's pose
    n_eff: Tensor  # [F, ..]


def follow_call(sim: SimState, grid: slam.SlamState, world: World,
                left: float, right: float, n_steps: int, draws,
                quantize=None, block=None):
    """One cadence rollout call of ``n_steps`` ticks at constant wheel
    speeds from ``(sim, grid)``: frames of idle ticks, each ending in a
    scan tick that updates grid SLAM with frame ``f``'s ``draws``
    (``(eps_c [F, ..], eps_t [F, ..], u01 [F, .., 1])``), then the idle
    ticks after the last scan.  Returns ``(sim, grid, outputs)``."""
    dev = sim.pose.device
    speed_l = torch.full((), _f32(left), dtype=torch.float32, device=dev)
    speed_r = torch.full((), _f32(right), dtype=torch.float32, device=dev)
    fired, timer = fire_schedule(n_steps, sim.timer, world.update_period)
    poses, best, n_eff = [], [], []
    f = 0
    for i in range(n_steps):
        sim, fires = tick(sim, speed_l, speed_r, world,
                          force_fire=(f < len(fired) and i == fired[f]))
        if f < len(fired) and i == fired[f]:
            noise = tuple(d[f] for d in draws)
            sim, grid, out = scan_update(sim, grid, world, noise, quantize,
                                         block)
            poses.append(sim.pose)
            best.append(out.pose)
            n_eff.append(out.n_eff)
            f += 1
    sim = sim._replace(timer=timer)
    return sim, grid, CallOutputs(torch.stack(poses), torch.stack(best),
                                  torch.stack(n_eff))


def n_frames_max(n_steps: int, period: float) -> int:
    """At most how many scans ``n_steps`` ticks hold, from any timer."""
    if period == 0.0:
        return n_steps
    per = max(1, int(math.floor(period / DT * (1.0 - 1e-6))))
    return n_steps // per + 1
