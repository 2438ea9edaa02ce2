"""Batched ray against line-segment raycasting.

Counterpart of ``slamrs_tpu/ops/raycast.py``: the two-line closed form
with ``t`` on the segment and ``u`` along the ray, then a min over
segments.  Plain tensor code over a ``[..., B, S]`` broadcast (the JAX
package has no kernel here either); on the card the world's lidar runs
the same arithmetic inside the simulator kernel
(``models/simulator.sim_frame``, ``csrc/sim_frame.cu``), and this is its
plain version.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor

# "no intersection"; large but finite so the min and later math stay finite
NO_HIT: float = 1e30


def segment_intersect(origins: Tensor, directions: Tensor, segments: Tensor,
                      segment_mask: Tensor | None = None) -> Tensor:
    """Intersection parameter ``u`` of each ray with every segment.

    origins/directions: f32[..., 2]; segments: f32[S, 4] rows
    ``(x1, y1, x2, y2)``; segment_mask: bool[S].  Returns f32[..., S],
    ``NO_HIT`` where the ray misses (t outside [0, 1], u <= 0, parallel,
    or masked).
    """
    x1 = segments[..., 0]
    y1 = segments[..., 1]
    x2 = segments[..., 2]
    y2 = segments[..., 3]

    x3 = origins[..., 0:1]
    y3 = origins[..., 1:2]
    dx = directions[..., 0:1]
    dy = directions[..., 1:2]

    denom = (x1 - x2) * (-dy) - (y1 - y2) * (-dx)
    safe_denom = torch.where(denom == 0.0, torch.ones_like(denom), denom)

    t = ((x1 - x3) * (-dy) - (y1 - y3) * (-dx)) / safe_denom
    u = -((x1 - x2) * (y1 - y3) - (y1 - y2) * (x1 - x3)) / safe_denom

    ok = (denom != 0.0) & (t >= 0.0) & (t <= 1.0) & (u > 0.0)
    if segment_mask is not None:
        ok = ok & segment_mask
    return torch.where(ok, u, torch.full_like(u, NO_HIT))


def raycast(origin: Tensor, angles: Tensor, segments: Tensor,
            segment_mask: Tensor | None = None) -> tuple[Tensor, Tensor]:
    """Closest hit of a fan of beams from one origin per batch element.

    origin: f32[..., 2]; angles: f32[..., B] world-frame.  Returns
    ``(dist f32[..., B], hit bool[..., B])``.
    """
    directions = torch.stack([torch.cos(angles), torch.sin(angles)], dim=-1)
    o = torch.broadcast_to(origin[..., None, :], directions.shape)
    u = segment_intersect(o, directions, segments, segment_mask)
    dist = torch.amin(u, dim=-1)
    hit = dist < NO_HIT
    return dist, hit
