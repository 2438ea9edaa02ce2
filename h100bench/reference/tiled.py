"""Grid SLAM on tile-pool maps, followed in plain PyTorch, and the numbers
that decide ``correct`` for a cell whose maps are a tile pool.

A map set over 1 GiB is stored by the port as a tile pool: ``pool
[n_phys, hb, cols]`` of full-width row bands and a band table ``i32[P,
nb]`` (band ``b`` of particle ``i`` is pool tile ``table[i, b]``).  A
resample relabels the table instead of moving map bytes (the pending
lineage ``ancestors`` is applied as ``table[ancestors]`` by the next
update), and an update gives each shared band it writes a fresh tile
(copy on write).  None of that changes what a map holds: slot ``i``'s map
is its ``nb`` tiles read through table row ``ancestors[i]``, stacked and
cut to the grid's rows, and an update of those maps is the deferred
lineage's update of dense maps.

So the reference materializes the call's input state into dense
per-particle maps ``[P, rows, cols]`` with the pending lineage applied,
follows the call by the deferred lineage on them with ``slam.py``'s
motion, weights and systematic resample and ``fused.plain_update`` (in
blocks of particles), and holds the program's materialized maps, poses
and weights after the call against its own.  It does not ask
``slam.mechanism``, whose guard refuses a map set over 1 GiB: the storage
is the program's, read from its state.

The compared numbers are ``compare.py``'s: ``pose_gap``, ``n_eff_gap``
and ``map_gap`` over every cell of every materialized map, taken in
blocks of particles so that no float64 copy of a whole 2.1 GB map set is
made.
"""

from __future__ import annotations

import numpy as np
import torch

from h100bench import compare
from h100bench.reference import fused, slam
from h100bench.reference import world as ref_world

MAP_BLOCK = 128  # particles whose maps are compared at a time


# --- the storage ------------------------------------------------------------

def materialize(pool, table, ancestors, rows: int, s: int = 0, e=None):
    """Slots ``[s, e)``'s dense maps ``[e - s, rows, cols]``: slot ``i``'s
    tiles through table row ``ancestors[i]``, stacked, cut to ``rows``."""
    anc = ancestors[s:e].long()
    tiles = table.index_select(0, anc).long()
    dense = pool.index_select(0, tiles.reshape(-1))
    return dense.reshape(anc.shape[0], -1, pool.shape[-1])[:, :rows]


def dense_state(grid: dict, rows: int, device) -> slam.SlamState:
    """A tiled state (host tensors: ``grids`` the pool, ``tile_table``,
    and the filter's fields) as the reference's dense state on
    ``device``, the pending lineage applied."""
    pool = grid["grids"].to(device)
    maps = materialize(pool, grid["tile_table"].to(device),
                       grid["ancestors"].to(device), rows)
    del pool
    p = maps.shape[0]
    return slam.SlamState(
        poses=grid["poses"].to(device), grids=maps.contiguous(),
        weights=grid["weights"].to(device),
        best_pose=grid["best_pose"].to(device),
        best_idx=grid["best_idx"].to(device),
        ancestors=torch.arange(p, dtype=torch.int32, device=device))


def reference_world(yaml_text: str, workload: dict, device):
    """The configuration's world; a ``resample_cow`` of ``"tiled"`` (the
    storage pinned) is accepted and dropped, as is none."""
    graph = ref_world.load_yaml(yaml_text)
    cfg = ref_world.node(graph, "GridMapSlam")["config"]
    if cfg.get("resample_cow") not in (None, "tiled"):
        raise ValueError(f"the tile-pool reference follows resample_cow "
                         f"'tiled' or auto, not {cfg['resample_cow']!r}")
    cfg.pop("resample_cow", None)
    sim = ref_world.node(graph, "Simulator")
    sim["parameters"] = {**(sim.get("parameters") or {}),
                         **workload.get("sim_parameters", {})}
    return ref_world.build_world(graph, device)


# --- the call -------------------------------------------------------------

def update(state: slam.SlamState, scan, odometry, cfg: slam.SlamConfig,
           noise, quantize=None, block=None):
    """One update by the deferred lineage on dense maps (``slam.update``
    without its storage guard): ``(state, outputs)``."""
    angles, distances, valid, present = scan
    dl, dr, wb = odometry
    new_poses = slam.motion_sample(state.poses, dl, dr, wb, noise[0],
                                   noise[1])
    rows, cols = state.grids.shape[-2:]
    prep = fused.prepare(rows, cols, new_poses, angles[0], distances, valid,
                         present, cfg.spec, angles.shape[-1],
                         cfg.max_scan_range, slam._dphi(cfg, angles))
    maps = state.grids.index_select(0, state.ancestors.long())
    grids, log_lik = fused.plain_update(maps, prep, cfg.spec,
                                        angles.shape[-1], quantize, block)
    log_motion = slam.motion_log_prob(state.poses, new_poses, dl, dr, wb)
    weights, ancestors, best_idx, n_eff = slam.weigh_and_select(
        log_lik, log_motion, state.weights, cfg.resample_neff_frac,
        cfg.n_particles, noise[2])
    best_pose = new_poses[best_idx.long()]
    new_state = slam.SlamState(poses=new_poses[ancestors.long()],
                               grids=grids, weights=weights,
                               best_pose=best_pose, best_idx=best_idx,
                               ancestors=ancestors)
    return new_state, slam.SlamOutputs(best_pose, n_eff)


def follow_call(sim: ref_world.SimState, grid: slam.SlamState, world,
                left: float, right: float, n_steps: int, draws,
                quantize=None, block=None):
    """``world.follow_call`` with :func:`update` as the scan tick's
    filter update: ``(sim, grid, outputs)``."""
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
                               tuple(d[f] for d in draws), quantize, block)
            sim = sim._replace(accum_left=torch.zeros_like(sim.accum_left),
                               accum_right=torch.zeros_like(sim.accum_right))
            poses.append(sim.pose)
            best.append(out.pose)
            n_eff.append(out.n_eff)
    return (sim._replace(timer=timer), grid,
            ref_world.CallOutputs(torch.stack(poses), torch.stack(best),
                                  torch.stack(n_eff)))


# --- the comparison -----------------------------------------------------

def _side(pose, grid, outs, maps) -> dict:
    """One side's compared quantities; ``maps(s, e)`` gives slots
    ``[s, e)``'s materialized maps."""
    return {"frames_pose": outs["pose"], "frames_best": outs["grid_pose"],
            "frames_n_eff": outs["n_eff"], "pose": pose,
            "poses": grid["poses"], "best_pose": grid["best_pose"],
            "weights": grid["weights"], "maps": maps}


def follow(yaml_text: str, workload: dict, before: dict, draws, left: float,
           right: float, ticks: int, device, quantize=None) -> dict:
    """The reference's side of a checked call from its input state
    ``before`` (host tensors, the grid a tiled state)."""
    world = reference_world(yaml_text, workload, device)
    sim = ref_world.SimState(before["pose"].to(device),
                             before["accum_left"].to(device),
                             before["accum_right"].to(device),
                             before["timer"])
    grid = dense_state(before["grid"], world.slam.spec.rows, device)
    dev_draws = tuple(torch.from_numpy(np.asarray(d)).to(device)
                      for d in draws)
    sim, grid, outs = follow_call(sim, grid, world, left, right, ticks,
                                  dev_draws, quantize,
                                  workload.get("reference_block"))

    def maps(s, e):
        return grid.grids.index_select(0, grid.ancestors[s:e].long())

    return _side(sim.pose, grid._asdict(),
                 {"pose": outs.pose, "grid_pose": outs.grid_pose,
                  "n_eff": outs.n_eff}, maps)


def program_side(after: dict, outs: dict, rows: int, device) -> dict:
    """The program's side: its state after the call (host tensors, a
    tiled grid) and the call's per-frame outputs (numpy)."""
    g = {k: v.to(device) for k, v in after["grid"].items()}

    def maps(s, e):
        return materialize(g["grids"], g["tile_table"], g["ancestors"],
                           rows, s, e)

    return _side(after["pose"].to(device), g,
                 {k: torch.from_numpy(v).to(device) for k, v in outs.items()},
                 maps)


def numbers(prog: dict, ref: dict, p: int) -> dict:
    """``compare.numbers`` over two sides whose maps are read in blocks of
    :data:`MAP_BLOCK` particles."""
    maps = 0.0
    for s in range(0, p, MAP_BLOCK):
        e = min(p, s + MAP_BLOCK)
        maps = max(maps, compare.gap(prog["maps"](s, e).float(),
                                     ref["maps"](s, e).float()))
    return {
        "pose_gap": max(compare.gap(prog[k], ref[k]) for k in (
            "frames_pose", "frames_best", "pose", "poses", "best_pose")),
        "n_eff_gap": max(compare.gap(prog["frames_n_eff"],
                                     ref["frames_n_eff"]) / p,
                         compare.gap(prog["weights"], ref["weights"]) * p),
        "map_gap": maps,
    }


def follow_and_compare(yaml_text, workload, before, after, outs, draws,
                       left, right, ticks, device, quantize=None) -> dict:
    """The numbers between the program's checked call (or, with
    ``quantize``, the control in its place) and the reference."""
    ref = follow(yaml_text, workload, before, draws, left, right, ticks,
                 device)
    if quantize is None:
        rows = reference_world(yaml_text, workload, "cpu").slam.spec.rows
        prog = program_side(after, outs, rows, device)
    else:
        prog = follow(yaml_text, workload, before, draws, left, right, ticks,
                      device, quantize)
    return numbers(prog, ref, int(before["grid"]["poses"].shape[-2]))
