"""Occupancy-grid geometry and the inverse-sensor-model constants.

Counterpart of ``slamrs_tpu/ops/grid.py:43-106`` (constants and
``GridSpec2D``, with ``world_to_grid`` for the ICP map's voxel gate).
The DDA and dense integrators are not ported yet.
"""

from __future__ import annotations

import dataclasses
import math as pymath

import torch

# Inverse sensor model constants (same values as the JAX package).
P_FREE = 0.30
P_OCCUPIED = 0.9
P_PRIOR = 0.5
Z_HIT = 0.9
SENSOR_MAXDIST = 1.0  # meters
TOLERANCE_CELLS = 2.0
ADDITIONAL_STEPS = 2

L_FREE = pymath.log(P_FREE / (1.0 - P_FREE))
L_OCCUPIED = pymath.log(P_OCCUPIED / (1.0 - P_OCCUPIED))
L_PRIOR = 0.0


@dataclasses.dataclass(frozen=True)
class GridSpec2D:
    """Static geometry of an occupancy grid: cell counts are
    ceil(extent / resolution); ``position`` is the lower-left corner."""

    position_x: float
    position_y: float
    width: float  # meters
    height: float  # meters
    resolution: float  # meters per cell

    @property
    def cols(self) -> int:
        return int(pymath.ceil(self.width / self.resolution))

    @property
    def rows(self) -> int:
        return int(pymath.ceil(self.height / self.resolution))

    @property
    def shape(self) -> tuple[int, int]:
        return (self.rows, self.cols)

    def world_to_grid(self, xy):
        """Continuous world coordinates ``f32[..., 2]`` to grid ones (the
        offsets stay Python floats: a tensor built from them on the card
        would be a synchronous host copy)."""
        res = self.resolution
        return torch.stack([(xy[..., 0] - self.position_x) / res,
                            (xy[..., 1] - self.position_y) / res], dim=-1)

    def max_ray_steps(self, max_range_m: float) -> int:
        """Static bound on DDA steps for rays up to ``max_range_m``."""
        cells = max_range_m / self.resolution
        return int(pymath.ceil(cells * pymath.sqrt(2.0))) + ADDITIONAL_STEPS + 3
