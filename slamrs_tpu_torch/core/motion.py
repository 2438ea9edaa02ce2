"""Differential-drive odometry motion model.

Counterpart of ``slamrs_tpu/core/motion.py``; the noise law is the same:

* ``delta_center = (l + r) / 2``, ``delta_theta = (r - l) / wheel_base``;
* ``center_std = (0.01 + |delta_center| * 0.05) / 2``;
* ``theta_std = radians(5) + 0.1 * |delta_theta|``;
* ``sample`` draws theta first, then advances along the new heading;
* ``log_prob`` scores the unsigned displacement and the angle difference.

Every function broadcasts over leading batch axes.
"""

from __future__ import annotations

import torch

from slamrs_tpu_torch.core import math as m

Tensor = torch.Tensor

_MIN_CENTER_STD = 0.01
_CENTER_STD_RATE = 0.05
_THETA_STD_BASE = 5.0 * 3.141592653589793 / 180.0
_THETA_STD_RATE = 0.1


def deltas(distance_left, distance_right, wheel_base):
    """(delta_center, delta_theta)."""
    delta_center = (distance_left + distance_right) * 0.5
    delta_theta = (distance_right - distance_left) / wheel_base
    return delta_center, delta_theta


def stds(delta_center: Tensor, delta_theta: Tensor):
    """(center_std, theta_std)."""
    center_std = (_MIN_CENTER_STD
                  + torch.abs(delta_center) * _CENTER_STD_RATE) * 0.5
    theta_std = _THETA_STD_BASE + _THETA_STD_RATE * torch.abs(delta_theta)
    return center_std, theta_std


def sample(pose: Tensor, distance_left, distance_right, wheel_base,
           eps: tuple[Tensor, Tensor] | None = None,
           generator: torch.Generator | None = None) -> Tensor:
    """Draw a successor pose per batch element.

    ``eps`` supplies the two standard-normal draws ``(eps_c, eps_t)``;
    without it they come from ``generator`` (on the pose's device).
    """
    dc, dt = deltas(distance_left, distance_right, wheel_base)
    c_std, t_std = stds(dc, dt)
    batch = torch.broadcast_shapes(pose.shape[:-1], torch.as_tensor(dc).shape)
    if eps is None:
        if generator is None:
            raise ValueError("sample needs eps or a generator")
        eps_c = torch.randn(batch, generator=generator, device=pose.device)
        eps_t = torch.randn(batch, generator=generator, device=pose.device)
    else:
        eps_c, eps_t = (
            torch.broadcast_to(torch.as_tensor(e, device=pose.device),
                               batch).to(pose.dtype)
            for e in eps)
    center = dc + c_std * eps_c
    theta = pose[..., 2] + dt + t_std * eps_t
    x = pose[..., 0] + torch.cos(theta) * center
    y = pose[..., 1] + torch.sin(theta) * center
    return torch.stack([x, y, theta], dim=-1)


def log_prob(initial_pose: Tensor, new_pose: Tensor, distance_left,
             distance_right, wheel_base) -> Tensor:
    """Log pdf product of a transition (center and angle factors)."""
    dc, dt = deltas(distance_left, distance_right, wheel_base)
    c_std, t_std = stds(dc, dt)
    center_distance = torch.sqrt(
        (initial_pose[..., 0] - new_pose[..., 0]) ** 2
        + (initial_pose[..., 1] - new_pose[..., 1]) ** 2)
    angle_distance = m.angle_diff(initial_pose[..., 2], new_pose[..., 2])
    return (m.normal_logpdf(center_distance, dc, c_std)
            + m.normal_logpdf(angle_distance, dt, t_std))


def integrate_exact(pose: Tensor, sl, sr, wheel_base) -> Tensor:
    """Noise-free kinematic update: turn first, then advance along the new
    heading by the mean wheel travel.  The simulator kernel
    (``models/simulator.sim_frame``) repeats it on the card."""
    sbar = (sr + sl) * 0.5
    theta = pose[..., 2] + (sr - sl) / wheel_base
    x = pose[..., 0] + sbar * torch.cos(theta)
    y = pose[..., 1] + sbar * torch.sin(theta)
    return torch.stack([x, y, theta], dim=-1)
