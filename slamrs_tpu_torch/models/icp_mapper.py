"""ICP scan-to-map odometry with a growing point map.

Counterpart of ``slamrs_tpu/models/icp_mapper.py``.  The first scan
initializes the map at the identity pose; every later scan is matched
against the map with point-to-normal ICP from the previous estimate, the
estimate becomes the ICP result, and the transformed scan points are
appended to the map.

The map is a fixed-capacity buffer ``f32[C, 2]`` with a device-side
count; appends past capacity are dropped (the newest points go).  An
optional voxel gate (``voxel_size``) appends a point only if its voxel
held no map point before this update, tracked in a bitmap.  The first
scan is a ``torch.where`` on the ``initialized`` flag, not a host
branch: ICP against an empty map has zero normals, hence a zero step.
Nothing here reads a device value on the host, so an update never waits
for the card.

A fleet is a state with a leading ``[W]`` axis on every field and a
``[W, B]`` scan: the worlds run together, each of ICP's nearest-neighbour
steps one K4 call over ``W`` problems, as the JAX package's
``vmap(update)``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from slamrs_tpu_torch.core.types import Scan
from slamrs_tpu_torch.ops import icp as _icp
from slamrs_tpu_torch.ops.grid import GridSpec2D

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class IcpMapConfig:
    """Same fields and defaults as the JAX package's ``IcpMapConfig``."""

    capacity: int = 16384
    iterations: int = 10
    step_threshold: float | None = None  # None == uniform weights
    voxel_size: float | None = None  # None == append every valid point
    # voxel bitmap extent (used only when voxel_size is set)
    extent_x: float = -10.0
    extent_y: float = -10.0
    extent_w: float = 20.0
    extent_h: float = 20.0

    @property
    def voxel_spec(self) -> GridSpec2D | None:
        if self.voxel_size is None:
            return None
        return GridSpec2D(self.extent_x, self.extent_y, self.extent_w,
                          self.extent_h, self.voxel_size)


class IcpMapState(NamedTuple):
    """One world's mapper, or a fleet's with a leading ``[W]`` axis."""

    points: Tensor  # f32[C, 2] map buffer
    count: Tensor  # i32[] valid lanes
    pose: Tensor  # f32[3] current estimate
    initialized: Tensor  # bool[]
    voxel_bitmap: Tensor  # bool[VH, VW] (1x1 when the gate is off)

    @staticmethod
    def init(config: IcpMapConfig, device,
             worlds: tuple[int, ...] = ()) -> "IcpMapState":
        vs = config.voxel_spec
        shape = vs.shape if vs is not None else (1, 1)
        w = tuple(worlds)
        return IcpMapState(
            points=torch.zeros((*w, config.capacity, 2), dtype=torch.float32,
                               device=device),
            count=torch.zeros(w, dtype=torch.int32, device=device),
            pose=torch.zeros((*w, 3), dtype=torch.float32, device=device),
            initialized=torch.zeros(w, dtype=torch.bool, device=device),
            voxel_bitmap=torch.zeros((*w, *shape), dtype=torch.bool,
                                     device=device))


class IcpMapOutputs(NamedTuple):
    pose: Tensor  # f32[3]
    chi: Tensor  # f32[iterations] per-iteration chi (0 on the first scan)
    appended: Tensor  # i32[] points added to the map by this update


def _flat_offsets(batch: tuple[int, ...], stride: int, device) -> Tensor:
    """``[..., 1]`` offsets ``w * stride`` of each world's block in a
    flattened ``[W * stride]`` buffer (0 for one world)."""
    n = 1
    for d in batch:
        n *= d
    return (torch.arange(n, device=device) * stride).reshape(*batch, 1)


def update(state: IcpMapState, scan: Scan, config: IcpMapConfig
           ) -> tuple[IcpMapState, IcpMapOutputs]:
    """One scan-matching update of a single world, or of every world of a
    fleet (leading ``[W]`` axes on ``state`` and ``scan``)."""
    dev = state.points.device
    batch = state.pose.shape[:-1]
    identity = torch.zeros((*batch, 3), dtype=torch.float32, device=dev)
    p, p_mask = scan.to_points(identity)  # [..., B, 2], [..., B]

    result = _icp.icp_point_to_normal(
        p, p_mask, state.points, state.count, state.pose,
        iterations=config.iterations, step_threshold=config.step_threshold)

    # first scan: the pose stays, the raw points go in
    init = state.initialized
    new_pose = torch.where(init[..., None], result.transformation,
                           state.pose)
    insert_pts = torch.where(init[..., None, None],
                             result.transformed_points, p)

    keep = p_mask
    bitmap = state.voxel_bitmap
    vs = config.voxel_spec
    if vs is not None:
        g = vs.world_to_grid(insert_pts)  # [..., B, 2]
        in_b = (g[..., 0] >= 0) & (g[..., 1] >= 0) & \
            (g[..., 0] < vs.cols) & (g[..., 1] < vs.rows)
        gx = torch.clamp(g[..., 0].to(torch.int32), 0, vs.cols - 1).long()
        gy = torch.clamp(g[..., 1].to(torch.int32), 0, vs.rows - 1).long()
        sink = vs.rows * vs.cols
        # each world's bitmap and one sink cell, flattened
        cell = gy * vs.cols + gx + _flat_offsets(batch, sink + 1, dev)
        flat = torch.cat([bitmap.reshape(*batch, sink),
                          bitmap.new_zeros(*batch, 1)], -1).reshape(-1)
        # the gate reads the bitmap as it was before this update, so two
        # new points in one fresh voxel are both kept
        keep = keep & in_b & ~flat[cell]
        # mark the kept points' voxels; the others write into the sink
        sink_cell = _flat_offsets(batch, sink + 1, dev) + sink
        flat.index_fill_(0, torch.where(keep, cell, sink_cell).reshape(-1),
                         True)
        bitmap = flat.reshape(*batch, sink + 1)[..., :sink].reshape(
            bitmap.shape)

    # masked append: lane i goes to slot count + (#kept lanes before i);
    # lanes not kept, and slots past capacity, write into a sink row
    cap = config.capacity
    offsets = torch.cumsum(keep.to(torch.int32), -1, dtype=torch.int32) - 1
    slots = state.count[..., None] + offsets
    ok = keep & (slots < cap)
    slots = torch.where(ok, slots, cap).long() \
        + _flat_offsets(batch, cap + 1, dev)
    points = torch.cat([state.points, state.points.new_zeros(*batch, 1, 2)],
                       -2)
    points = points.reshape(-1, 2).index_copy_(
        0, slots.reshape(-1),
        torch.where(ok[..., None], insert_pts, 0.0).reshape(-1, 2))
    points = points.reshape(*batch, cap + 1, 2)
    appended = torch.sum(ok.to(torch.int32), dim=-1, dtype=torch.int32)
    count = torch.clamp_max(state.count + appended, cap)

    new_state = IcpMapState(points=points[..., :cap, :], count=count,
                            pose=new_pose, initialized=torch.ones_like(init),
                            voxel_bitmap=bitmap)
    chi = torch.where(init[..., None], result.chi_values, 0.0)
    return new_state, IcpMapOutputs(pose=new_pose, chi=chi, appended=appended)
