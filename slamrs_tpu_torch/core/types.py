"""Core domain types as tuples of tensors.

Counterpart of ``slamrs_tpu/core/types.py``.  A scan carries a fixed
number of beam lanes plus two masks (``present``: the sensor emitted the
lane at all; ``valid``: it is a true hit), a landmark scan a fixed number
of observation lanes, and a pose is a plain ``f32[..., 3]`` tensor
``(x, y, theta)``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

Tensor = torch.Tensor


class Pose2:
    """Helpers for ``f32[..., 3]`` pose tensors ``(x, y, theta)``."""

    DIM = 3

    @staticmethod
    def make(x=0.0, y=0.0, theta=0.0, device=None) -> Tensor:
        return torch.tensor([x, y, theta], dtype=torch.float32, device=device)

    @staticmethod
    def identity(batch_shape=(), device=None) -> Tensor:
        return torch.zeros((*batch_shape, 3), dtype=torch.float32,
                           device=device)

    @staticmethod
    def x(p: Tensor) -> Tensor:
        return p[..., 0]

    @staticmethod
    def y(p: Tensor) -> Tensor:
        return p[..., 1]

    @staticmethod
    def theta(p: Tensor) -> Tensor:
        return p[..., 2]

    @staticmethod
    def xy(p: Tensor) -> Tensor:
        return p[..., 0:2]


class Scan(NamedTuple):
    """A full lidar revolution with fixed beam lanes."""

    angles: Tensor  # f32[..., B] radians, sensor-relative
    distances: Tensor  # f32[..., B] meters
    strengths: Tensor  # f32[..., B]
    valid: Tensor  # bool[..., B] the return is a true hit
    present: Tensor  # bool[..., B] the lane carries a measurement

    @property
    def num_beams(self) -> int:
        return self.angles.shape[-1]

    def to_points(self, origin: Tensor) -> tuple[Tensor, Tensor]:
        """Every lane projected to a world-frame point from ``origin``
        (f32[..., 3]), with the mask of valid, present lanes.  Returns
        ``(points f32[..., B, 2], mask bool[..., B])``."""
        a = origin[..., 2:3] + self.angles
        px = origin[..., 0:1] + torch.cos(a) * self.distances
        py = origin[..., 1:2] + torch.sin(a) * self.distances
        return torch.stack([px, py], dim=-1), self.valid & self.present

    @staticmethod
    def empty(num_beams: int = 360, batch_shape=(), device=None) -> "Scan":
        """A scan with no returns: 1-degree beam angles, zero distances
        and strengths, every lane absent and invalid."""
        sh = (*batch_shape, num_beams)
        angles = torch.deg2rad(torch.arange(num_beams, dtype=torch.float32,
                                            device=device)).expand(sh)

        def zeros(dtype):
            return torch.zeros(sh, dtype=dtype, device=device)

        return Scan(angles=angles.contiguous(),
                    distances=zeros(torch.float32),
                    strengths=zeros(torch.float32), valid=zeros(torch.bool),
                    present=zeros(torch.bool))


class OdometryReading(NamedTuple):
    """Measured wheel travel since the previous reading (meters)."""

    distance_left: Tensor
    distance_right: Tensor
    wheel_base: Tensor | float

    @staticmethod
    def make(left=0.0, right=0.0, wheel_base=0.1,
             device=None) -> "OdometryReading":
        """Three f32 0-dim tensors on ``device``."""
        f = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
        return OdometryReading(f(left), f(right), f(wheel_base))


class Command(NamedTuple):
    """Target wheel speeds, m/s."""

    speed_left: Tensor
    speed_right: Tensor

    @staticmethod
    def make(left=0.0, right=0.0, device=None) -> "Command":
        """Two f32 0-dim tensors on ``device``, filled on the device (a
        tensor made from a Python value on the card would be a
        synchronous host copy)."""
        f = lambda v: torch.full((), float(np.float32(v)),
                                 dtype=torch.float32, device=device)
        return Command(f(left), f(right))


class LandmarkScan(NamedTuple):
    """Landmark observations with fixed lanes: ``association`` is the
    landmark id (the simulator knows it), ``valid`` masks unused lanes."""

    angles: Tensor  # f32[..., L] radians, robot-relative
    distances: Tensor  # f32[..., L] meters
    association: Tensor  # i32[..., L]
    valid: Tensor  # bool[..., L]

    @property
    def num_lanes(self) -> int:
        return self.angles.shape[-1]

    @staticmethod
    def empty(num_lanes: int, batch_shape=(), device=None) -> "LandmarkScan":
        """``num_lanes`` invalid lanes of zeros."""
        sh = (*batch_shape, num_lanes)
        return LandmarkScan(
            angles=torch.zeros(sh, dtype=torch.float32, device=device),
            distances=torch.zeros(sh, dtype=torch.float32, device=device),
            association=torch.zeros(sh, dtype=torch.int32, device=device),
            valid=torch.zeros(sh, dtype=torch.bool, device=device))


@dataclasses.dataclass
class Gaussian2D:
    """A 2D Gaussian on the host: ``mean`` f32[2], ``covariance``
    f32[2, 2] (numpy; the Gaussian debug node and the covariance-ellipse
    drawing use it)."""

    mean: np.ndarray = None
    covariance: np.ndarray = None

    def __post_init__(self):
        if self.mean is None:
            self.mean = np.zeros(2, np.float32)
        if self.covariance is None:
            self.covariance = np.eye(2, dtype=np.float32)
