"""The fused update (K1) of a fleet, one launch per mesh block.

Counterpart of ``slamrs_tpu/parallel/shard.py``.  The kernel is
independent across (world, particle): each block of a sharded fleet runs
it on its own ``[W_loc, P_loc, H, C]`` maps with each world's scan row
copied to the block's device, so the maps and likelihoods are those of
the one-launch fleet call, bit for bit.
"""

from __future__ import annotations

import torch

from slamrs_tpu_torch.ops.fused import fused_update
from slamrs_tpu_torch.ops.grid import GridSpec2D
from slamrs_tpu_torch.parallel.fleet import (Mesh, Sharded, WORLD_PARTICLE,
                                             world_part)

Tensor = torch.Tensor


def _fleet_call(grids: Tensor, poses: Tensor, angles0, distances, valid,
                present, spec, num_beams, max_range_m, dphi):
    """One in-place K1 launch over ``grids [W, P, H, C]``, ``per_world =
    P``; returns ``(grids, log_lik [W, P])``."""
    w, p = grids.shape[:2]
    g, lik = fused_update(grids.reshape(w * p, *grids.shape[2:]),
                          poses.reshape(w * p, 3), angles0, distances, valid,
                          present, spec, num_beams, max_range_m, dphi=dphi,
                          in_place=True)
    return g.reshape(grids.shape), lik.reshape(w, p)


def fused_update_batched(grids, poses, angles0, distances, valid, present,
                         spec: GridSpec2D, num_beams: int,
                         max_range_m: float, dphi, mesh: Mesh | None = None,
                         dphi_static: float | None = None):
    """K1 over a fleet, in place: grids ``[W, P, H, C]``, poses ``[W, P,
    3]``, per-world scans (``angles0`` and ``dphi`` ``[W]``, the rest
    ``[W, B]``).  ``dphi_static`` (a float) replaces ``dphi`` and selects
    the static bin pipeline.  Returns ``(grids', log_lik [W, P])``.

    ``mesh=None``: one launch for the fleet.  With a mesh, ``grids`` and
    ``poses`` are :class:`Sharded` blocks and the scans one-device
    tensors or cut over worlds; one launch per block on the block's
    device, and ``log_lik`` comes back cut like the grids."""
    dp = dphi_static if dphi_static is not None else dphi
    if mesh is None:
        return _fleet_call(grids, poses, angles0, distances, valid, present,
                           spec, num_beams, max_range_m, dp)
    out_g, out_l = [], []
    for r, row in enumerate(grids.blocks):
        row_g, row_l = [], []
        for t, g in enumerate(row):
            dev = g.device

            def part(x):
                return world_part(x, mesh, r, dev)

            g, lik = _fleet_call(g, poses.blocks[r][t], part(angles0),
                                 part(distances), part(valid), part(present),
                                 spec, num_beams, max_range_m, part(dp))
            row_g.append(g)
            row_l.append(lik)
        out_g.append(row_g)
        out_l.append(row_l)
    return (Sharded(mesh, WORLD_PARTICLE, out_g),
            Sharded(mesh, WORLD_PARTICLE, out_l))
