"""The long-horizon gate for the port: grid SLAM's fused path against
dda over 500 consecutive updates.

Counterpart of ``tests/test_longrun.py::test_longrun_fused_vs_dda_500_
updates`` (its setup ``_rollout_longrun``): 8 particles on the 4 x 4 m
scene at 0.05 m, scans to 1 m, N_eff gate 0.5, the same drive plan,
dda in float32 and fused in bfloat16.  Each update goes through the grid
node's update program (``GridMapSlamNode.step``), uncaptured on the CPU
and as a CUDA graph replay on the card, with the JAX package's seed-7
draws injected (``data/longrun_draws_seed7.npz``, the chain that
``torch_compare.node_grid_noise(7, 8, 500)`` rebuilds; tail drift is
chaotic across seeds, so fresh draws could not be held to the JAX
numbers).  The truth path, scans and odometry are made on the CPU and
moved to the device once.  No JAX here: ``chip_smoke.py`` runs it on the
card too.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from slamrs_tpu_torch.core import motion
from slamrs_tpu_torch.core.types import OdometryReading, Scan
from slamrs_tpu_torch.graph.nodes.slam import GridMapSlamNodeConfig
from slamrs_tpu_torch.graph.pubsub import PubSub
from slamrs_tpu_torch.models import simulator as sim_model
from slamrs_tpu_torch.models.gridslam import UpdateNoise

DRAWS = Path(__file__).resolve().parent / "data" / "longrun_draws_seed7.npz"
UPDATES = 500
PARTICLES = 8
WHEEL_BASE = float(np.float32(0.1))
# the JAX test's gates (tests/test_longrun.py:162-165)
GATES = {"dda_tail_drift_m": 0.10, "fused_tail_drift_m": 0.15,
         "path_rmse_m": 0.10, "map_agreement": 0.80}
# the JAX package's numbers, printed by ``make longrun`` (x86 CPU, JAX
# 0.9.0): as its docstring records them
JAX_CPU = {"dda_tail_drift_m": 0.0861, "fused_tail_drift_m": 0.0986,
           "path_rmse_m": 0.0761, "map_agreement": 0.825}


def drive(t: int) -> tuple[float, float]:
    """Arcs both ways and straights, staying in bounds (wheel travel a
    tick, m)."""
    return [(0.004, 0.0065), (0.006, 0.006), (0.0065, 0.004),
            (0.005, 0.005)][(t // 40) % 4]


def load_draws() -> tuple:
    """``(eps_c f32[500, 8], eps_t f32[500, 8], u01 f32[500, 1])``."""
    with np.load(DRAWS) as z:
        return z["eps_c"], z["eps_t"], z["u01"]


def inputs(n: int = UPDATES):
    """The truth poses f32[n, 3], the scans (a ``Scan`` of [n, 360]
    tensors) and the odometry (three f32[n]) of the drive, on the CPU."""
    scene = sim_model.Scene.build(
        rects=[(-1.0, -1.0, 2.0, 2.0), (-0.1, -0.4, 0.5, 0.1),
               (-0.6, 0.4, 0.2, 0.5)],
        lines=[(-0.6, -0.4, 0.2, 0.4)])
    left, right = (torch.tensor([drive(t)[i] for t in range(n)],
                                dtype=torch.float32) for i in (0, 1))
    pose = torch.zeros(3)
    truth, scans = [], []
    for t in range(n):
        pose = motion.integrate_exact(pose, left[t], right[t], WHEEL_BASE)
        truth.append(pose)
        scans.append(sim_model.lidar_scan(pose, scene, 1.0, 360))
    wheel_base = torch.full((n,), WHEEL_BASE)
    return (torch.stack(truth), Scan(*(torch.stack(x) for x in zip(*scans))),
            OdometryReading(left, right, wheel_base))


def rollout(integrate: str, grid_dtype: str, device, graphs: bool, scans,
            odometry, draws):
    """``UPDATES`` updates of a grid node through its update program on
    ``device``: the best pose after each (numpy f32[n, 3]), the final
    probability map (unpadded), and the node."""
    node = GridMapSlamNodeConfig(
        topic_pose="pose", topic_observation_odometry="obs",
        topic_map="map",
        config=dict(position=(-2.0, -2.0), width=4.0, height=4.0,
                    resolution=0.05, n_particles=PARTICLES,
                    max_scan_range=1.0, integrate=integrate,
                    resample_neff_frac=0.5, grid_dtype=grid_dtype),
    ).instantiate(PubSub(), device)
    node.use_programs(graphs)
    scans = Scan(*(x.to(device) for x in scans))
    odometry = OdometryReading(*(x.to(device) for x in odometry))
    draws = [torch.from_numpy(x).to(device) for x in draws]
    best = []
    for i in range(scans.angles.shape[0]):
        out = node.step(Scan(*(x[i] for x in scans)),
                        OdometryReading(*(x[i] for x in odometry)),
                        UpdateNoise(*(x[i] for x in draws)))
        best.append(out.pose.clone())  # the program's until its next update
    prob = node.probability_map().float().cpu().numpy()
    return torch.stack(best).cpu().numpy(), prob, node


def gate_numbers(truth, best_d, best_f, grid_d, grid_f) -> dict:
    """The JAX test's four numbers: each path's mean tracking error over
    the last 100 updates, the fused-against-dda path RMSE, and the share
    of cells either map classifies (p > 0.6 occupied, < 0.4 free) that
    both classify alike."""
    err_d = np.linalg.norm(best_d[:, :2] - truth[:, :2], axis=1)
    err_f = np.linalg.norm(best_f[:, :2] - truth[:, :2], axis=1)
    rmse = float(np.sqrt(((best_f[:, :2] - best_d[:, :2]) ** 2).mean()))

    def cls(g):
        return np.where(g > 0.6, 1, np.where(g < 0.4, -1, 0))

    a, b = cls(grid_d), cls(grid_f[:grid_d.shape[0], :grid_d.shape[1]])
    touched = (a != 0) | (b != 0)
    return {"dda_tail_drift_m": float(err_d[-100:].mean()),
            "fused_tail_drift_m": float(err_f[-100:].mean()),
            "path_rmse_m": rmse,
            "map_agreement": float((a[touched] == b[touched]).mean())}


def run(device, graphs: bool) -> tuple[dict, dict]:
    """Both paths on ``device``: the four numbers, and the two nodes."""
    truth, scans, odometry = inputs()
    draws = load_draws()
    best_d, grid_d, node_d = rollout("dda", "float32", device, graphs, scans,
                                     odometry, draws)
    best_f, grid_f, node_f = rollout("fused", "bfloat16", device, graphs,
                                     scans, odometry, draws)
    return (gate_numbers(truth.numpy(), best_d, best_f, grid_d, grid_f),
            {"dda": node_d, "fused": node_f})


def failed_gates(numbers: dict) -> list:
    """The gates ``numbers`` misses (the last is a lower bound)."""
    return [k for k, limit in GATES.items()
            if not (numbers[k] >= limit if k == "map_agreement"
                    else numbers[k] <= limit)]
