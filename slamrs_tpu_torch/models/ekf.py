"""EKF landmark SLAM with known association.

Counterpart of ``slamrs_tpu/models/ekf.py``: state ``[x, y, theta, l1x,
l1y, ..., lNx, lNy]`` with initial covariance 1000 I and a zero pose
block; the velocity motion model with its straight-line branch (a
``torch.where`` with a safe denominator); motion noise (0.02 m, 0.02 m,
5 deg) on the pose block; then a sequential Kalman correction per
observation lane: first-sighting initialization at the expected
position, the 2 x D measurement Jacobian, observation noise (0.03 m,
3 deg), angle wrapping of the innovation and of theta.

``reference_jacobian`` keeps the JAX package's choice: False (default)
is the textbook Jacobian with its 1/q normalization, True the
reference's unnormalized one.

The JAX package's ``lax.scan`` over observation lanes is a Python loop
over the ``L`` lanes with ``torch.where`` on ``valid``.  Landmark rows
are read and written with ``index_select``/``index_copy`` on index
tensors: indexing by a 0-dim tensor would read it on the host, a sync.
Constants are added to the covariance as Python floats for the same
reason (a tensor built from Python values on the card is a synchronous
host copy).

A fleet is a state with a leading ``[W]`` axis and ``[W, L]``
observations: the lanes are still taken one at a time, each lane's
correction over every world at once (batched products), as the JAX
package's ``vmap(update)``.  Landmark rows are gathered and scattered
along the last axis, per world.

Each update adds the observation lanes it corrects (the valid ones,
summed over the worlds) on the device to the counter ``ekf.corrections``
(``utils/trace.device_counter``): one integer sum and one add, replayed
in captured graphs.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from slamrs_tpu_torch.core import math as m
from slamrs_tpu_torch.core.types import LandmarkScan, OdometryReading
from slamrs_tpu_torch.utils import trace

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class EkfConfig:
    """Same fields and defaults as the JAX package's ``EkfConfig``."""

    num_landmarks: int = 10
    initial_landmark_variance: float = 1000.0
    motion_std_x: float = 0.02
    motion_std_y: float = 0.02
    motion_std_theta_deg: float = 5.0
    obs_std_distance: float = 0.03
    obs_std_angle_deg: float = 3.0
    # the reference's unnormalized Jacobian (see the module docstring)
    reference_jacobian: bool = False

    @property
    def dim(self) -> int:
        return 3 + 2 * self.num_landmarks


class EkfState(NamedTuple):
    """One world's filter, or a fleet's with a leading ``[W]`` axis."""

    mean: Tensor  # f32[D]
    cov: Tensor  # f32[D, D]
    seen: Tensor  # bool[N]

    @staticmethod
    def init(config: EkfConfig, device,
             worlds: tuple[int, ...] = ()) -> "EkfState":
        d = config.dim
        w = tuple(worlds)
        cov = torch.eye(d, dtype=torch.float32, device=device) \
            * config.initial_landmark_variance
        cov[:3, :3] = 0.0
        return EkfState(
            mean=torch.zeros((*w, d), dtype=torch.float32, device=device),
            cov=cov.expand(*w, d, d).contiguous(),
            seen=torch.zeros((*w, config.num_landmarks), dtype=torch.bool,
                             device=device))


class EkfOutputs(NamedTuple):
    pose: Tensor  # f32[3]
    landmark_means: Tensor  # f32[N, 2]
    landmark_covs: Tensor  # f32[N, 2, 2]
    seen: Tensor  # bool[N]


def _var_deg(std_deg: float) -> float:
    """float32 ``deg2rad(std)**2`` rounded as the JAX package rounds it."""
    rad = np.float32(std_deg) * np.float32(np.pi / 180.0)
    return float(np.float32(rad * rad))


def _motion_prediction(mean: Tensor, odometry: OdometryReading
                       ) -> tuple[Tensor, Tensor]:
    """``(delta_mean f32[3], Jacobian f32[3, 3])`` of the velocity motion
    model from ``mean``'s pose."""
    omega_dt = (odometry.distance_right - odometry.distance_left) \
        / odometry.wheel_base
    v_dt = (odometry.distance_left + odometry.distance_right) * 0.5
    theta = mean[..., 2]

    nonzero = omega_dt != 0.0
    safe_omega = torch.where(nonzero, omega_dt, 1.0)
    v_over_omega = v_dt / safe_omega

    s, c = torch.sin(theta), torch.cos(theta)
    s2, c2 = torch.sin(theta + omega_dt), torch.cos(theta + omega_dt)

    g_rot = torch.stack([-v_over_omega * s + v_over_omega * s2,
                         v_over_omega * c - v_over_omega * c2,
                         omega_dt], dim=-1)
    g_lin = torch.stack([v_dt * c, v_dt * s, torch.zeros_like(v_dt)], dim=-1)
    g = torch.where(nonzero[..., None], g_rot, g_lin)

    j_rot = torch.stack([-v_over_omega * c + v_over_omega * c2,
                         -v_over_omega * s + v_over_omega * s2], dim=-1)
    j_lin = torch.stack([-v_dt * s, v_dt * c], dim=-1)
    j = torch.where(nonzero[..., None], j_rot, j_lin)

    one, zero = torch.ones_like(v_dt), torch.zeros_like(v_dt)
    gx = torch.stack([torch.stack([one, zero, j[..., 0]], -1),
                      torch.stack([zero, one, j[..., 1]], -1),
                      torch.stack([zero, zero, one], -1)], -2)
    return g, gx


def _matvec(a: Tensor, v: Tensor) -> Tensor:
    """``a @ v`` over leading batch axes (one world: the plain product)."""
    return a @ v if v.dim() == 1 else (a @ v[..., None])[..., 0]


def _mat2(a, b, c, d) -> Tensor:
    """``[[a, b], [c, d]]`` over the entries' batch axes."""
    return torch.stack([torch.stack([a, b], -1), torch.stack([c, d], -1)],
                       -2)


def update(state: EkfState, observation: LandmarkScan,
           odometry: OdometryReading, config: EkfConfig
           ) -> tuple[EkfState, EkfOutputs]:
    """One EKF update (prediction, then one correction per observation
    lane) of a single world, or of every world of a fleet (leading
    ``[W]`` axes on ``state``, ``observation`` and the odometry)."""
    d = config.dim
    n = config.num_landmarks
    dev = state.mean.device
    batch = state.mean.shape[:-1]
    eye = torch.eye(d, dtype=torch.float32, device=dev)

    # ---- prediction
    g, gx = _motion_prediction(state.mean, odometry)
    mu = state.mean
    mu = torch.cat([mu[..., 0:2] + g[..., 0:2],
                    m.wrap_angle(mu[..., 2] + g[..., 2])[..., None],
                    mu[..., 3:]], -1)
    big_g = eye.expand(*batch, d, d).clone()
    big_g[..., 0:3, 0:3] = gx
    sigma = big_g @ state.cov @ big_g.transpose(-1, -2)
    for i, var in enumerate((config.motion_std_x ** 2,
                             config.motion_std_y ** 2,
                             _var_deg(config.motion_std_theta_deg))):
        sigma[..., i, i] += float(np.float32(var))
    obs_var = (float(np.float32(config.obs_std_distance ** 2)),
               _var_deg(config.obs_std_angle_deg))

    # ---- correction: one observation lane at a time
    trace.device_counter("ekf.corrections", dev).add_(
        observation.valid.sum(dtype=torch.int32))
    seen = state.seen
    for lane in range(observation.num_lanes):
        angle = observation.angles[..., lane]
        dist = observation.distances[..., lane]
        valid = observation.valid[..., lane]
        idx = torch.clamp(observation.association[..., lane], 0,
                          n - 1).long()[..., None]
        rows = torch.cat([3 + 2 * idx, 4 + 2 * idx], -1)  # landmark x, y

        # first sighting: initialize at the expected position
        seen_i = seen.gather(-1, idx)
        first = valid[..., None] & ~seen_i
        init = torch.stack([mu[..., 0] + dist * torch.cos(mu[..., 2] + angle),
                            mu[..., 1] + dist * torch.sin(mu[..., 2] + angle)],
                           -1)
        mu = mu.scatter(-1, rows, torch.where(first, init,
                                              mu.gather(-1, rows)))
        seen = seen.scatter(-1, idx, seen_i | valid[..., None])

        lm = mu.gather(-1, rows)
        dx = lm[..., 0] - mu[..., 0]
        dy = lm[..., 1] - mu[..., 1]
        q = dx * dx + dy * dy
        sqrt_q = torch.sqrt(q)
        z_bar = torch.stack([sqrt_q, torch.atan2(dy, dx) - mu[..., 2]], -1)
        z = torch.stack([dist, angle], -1)

        # H = h_low lifted to [2, D]; scale 1/q (textbook) or 1 (reference)
        scale = 1.0 if config.reference_jacobian else 1.0 / q
        zero = torch.zeros_like(q)
        h = torch.cat([
            torch.stack([torch.stack([scale * -sqrt_q * dx,
                                      scale * -sqrt_q * dy, zero], -1),
                         torch.stack([scale * dy, scale * -dx,
                                      scale * -q], -1)], -2),
            torch.zeros((*batch, 2, d - 3), dtype=torch.float32,
                        device=dev)], dim=-1)
        h_lm = _mat2(scale * sqrt_q * dx, scale * sqrt_q * dy,
                     scale * -dy, scale * dx)
        h = h.scatter(-1, rows[..., None, :].expand(*batch, 2, 2), h_lm)

        h_t = h.transpose(-1, -2)
        s_mat = h @ sigma @ h_t
        s_mat[..., 0, 0] += obs_var[0]
        s_mat[..., 1, 1] += obs_var[1]
        det = s_mat[..., 0, 0] * s_mat[..., 1, 1] \
            - s_mat[..., 0, 1] * s_mat[..., 1, 0]
        inv = _mat2(s_mat[..., 1, 1], -s_mat[..., 0, 1],
                    -s_mat[..., 1, 0], s_mat[..., 0, 0]) / det[..., None, None]
        k = sigma @ h_t @ inv  # [D, 2]

        diff = z - z_bar
        diff = torch.stack([diff[..., 0], m.wrap_angle(diff[..., 1])], -1)
        mu_new = mu + _matvec(k, diff)
        mu_new = torch.cat([mu_new[..., 0:2],
                            m.wrap_angle(mu_new[..., 2])[..., None],
                            mu_new[..., 3:]], -1)
        sigma_new = (eye - k @ h) @ sigma

        mu = torch.where(valid[..., None], mu_new, mu)
        sigma = torch.where(valid[..., None, None], sigma_new, sigma)

    lm_rows = 3 + 2 * torch.arange(n, device=dev)
    lm_covs = _mat2(sigma[..., lm_rows, lm_rows],
                    sigma[..., lm_rows, lm_rows + 1],
                    sigma[..., lm_rows + 1, lm_rows],
                    sigma[..., lm_rows + 1, lm_rows + 1])
    return EkfState(mean=mu, cov=sigma, seen=seen), EkfOutputs(
        pose=mu[..., 0:3], landmark_means=mu[..., 3:].reshape(*batch, n, 2),
        landmark_covs=lm_covs, seen=seen)
