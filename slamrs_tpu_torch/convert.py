"""Carry state from the JAX package into the port.

The system has no trained weights: its state (particle poses, log-odds
maps or a tile pool with its band table, weights, lineage; the ICP
mapper's point map and pose; the EKF's mean, covariance and seen flags;
the world's ground truth and scene) is what carries over.  The pending
lineage means what it means in the JAX package: under the deferred and
tiled resample mechanisms the next update applies it, under copy on
write and the whole-set gather it is the identity (see
``models/gridslam.resample_mechanism``, which picks the mechanism as the
JAX package does, so a carried-over state goes on in the same slot
order).  Each function takes numpy arrays, for example
``np.asarray`` of the JAX package's state, and returns the port's tuple
on ``device``.  A bf16 map arrives as an ``ml_dtypes.bfloat16`` array and
goes through float32 to ``torch.bfloat16``, which is lossless.  A fleet's
arrays carry their leading ``[W]`` axis through unchanged (a tiled
fleet: one pool and table per world).
"""

from __future__ import annotations

import numpy as np
import torch

from slamrs_tpu_torch.graph.compile import WorldState
from slamrs_tpu_torch.models.ekf import EkfState
from slamrs_tpu_torch.models.gridslam import GridSlamState
from slamrs_tpu_torch.models.icp_mapper import IcpMapState
from slamrs_tpu_torch.models.simulator import Scene


def _f32(a, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32).copy()).to(device)


def _i32(a, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.int32).copy()).to(device)


def _bool(a, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, bool).copy()).to(device)


def grid_state_from_numpy(poses, grids, weights, best_pose, best_idx,
                          ancestors, device, tile_table=None
                          ) -> GridSlamState:
    """A :class:`GridSlamState` from numpy arrays, one world's or a
    fleet's.  ``grids`` keeps its storage type: bf16
    (``ml_dtypes.bfloat16``) stays bf16, else f32.  For tiled maps
    ``grids`` is the tile pool ``[n_phys, hb, Wp]`` and ``tile_table``
    its ``i32[P, nb]`` band table (``[W, ...]`` each for a fleet)."""
    grids = np.asarray(grids)
    dtype = torch.bfloat16 if grids.dtype.name == "bfloat16" \
        else torch.float32
    return GridSlamState(
        poses=_f32(poses, device),
        grids=_f32(grids, device).to(dtype),
        weights=_f32(weights, device),
        best_pose=_f32(best_pose, device),
        best_idx=_i32(best_idx, device),
        ancestors=_i32(ancestors, device),
        tile_table=None if tile_table is None else _i32(tile_table, device))


def icp_state_from_numpy(points, count, pose, initialized, voxel_bitmap,
                         device) -> IcpMapState:
    """An :class:`IcpMapState` from numpy arrays."""
    return IcpMapState(points=_f32(points, device), count=_i32(count, device),
                       pose=_f32(pose, device),
                       initialized=_bool(initialized, device),
                       voxel_bitmap=_bool(voxel_bitmap, device))


def ekf_state_from_numpy(mean, cov, seen, device) -> EkfState:
    """An :class:`EkfState` from numpy arrays."""
    return EkfState(mean=_f32(mean, device), cov=_f32(cov, device),
                    seen=_bool(seen, device))


def world_state_from_numpy(pose, accum_left, accum_right, scan_timer,
                           scan_counter, grid: GridSlamState | None,
                           device, icp: IcpMapState | None = None,
                           ekf: EkfState | None = None) -> WorldState:
    """A :class:`WorldState` from numpy arrays; ``grid``, ``icp`` and
    ``ekf`` are already the port's (see the functions above)."""
    return WorldState(
        pose=_f32(pose, device),
        accum_left=_f32(accum_left, device),
        accum_right=_f32(accum_right, device),
        scan_timer=float(np.float32(scan_timer)),
        scan_counter=int(np.asarray(scan_counter)),
        grid=grid, icp=icp, ekf=ekf)


def scene_from_numpy(segments, segment_mask, landmarks, landmark_mask,
                     device) -> Scene:
    """A :class:`Scene` from padded ``f32[S, 4]`` segments, ``f32[L, 2]``
    landmarks and their masks."""
    return Scene(segments=_f32(segments, device),
                 segment_mask=_bool(segment_mask, device),
                 landmarks=_f32(landmarks, device),
                 landmark_mask=_bool(landmark_mask, device))
