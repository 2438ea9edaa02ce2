"""Probability algebra, angle math and the Gaussian log-density.

Counterpart of ``slamrs_tpu/core/math.py`` (``prob_to_log_odds``,
``log_odds_to_prob``, ``log_prob_mul``, ``log_prob_add``, ``angle_diff``,
``wrap_angle``, ``normal_logpdf``).  Python-float constants meet float32
tensors, so they round to float32 exactly as JAX's weakly typed
constants do.
"""

from __future__ import annotations

import math as _pymath

import torch

Tensor = torch.Tensor

_LOG_SQRT_2PI = 0.5 * _pymath.log(2.0 * _pymath.pi)


def prob_to_log_odds(p: Tensor) -> Tensor:
    """``log(p / (1 - p))``."""
    p = torch.as_tensor(p)
    return torch.log(p) - torch.log1p(-p)


def log_odds_to_prob(lo: Tensor) -> Tensor:
    """Inverse of :func:`prob_to_log_odds`: ``1 - 1 / (1 + exp(lo))``."""
    lo = torch.as_tensor(lo)
    return 1.0 - 1.0 / (1.0 + torch.exp(lo))


def log_prob_mul(a: Tensor, b: Tensor) -> Tensor:
    """Product of probabilities in log space."""
    return a + b


def log_prob_add(a: Tensor, b: Tensor) -> Tensor:
    """Sum of probabilities in log space."""
    return torch.logaddexp(torch.as_tensor(a), torch.as_tensor(b))


def angle_diff(alpha: Tensor, beta: Tensor) -> Tensor:
    """Shortest signed angular distance ``beta - alpha`` in [-pi, pi).

    ``torch.remainder`` is the floored remainder (sign of the divisor),
    like ``jnp.mod``; the ``< -pi`` fixup is kept for exactness at -pi.
    """
    two_pi = 2.0 * _pymath.pi
    diff = torch.remainder(beta - alpha + _pymath.pi, two_pi) - _pymath.pi
    return torch.where(diff < -_pymath.pi, diff + two_pi, diff)


def wrap_angle(theta: Tensor) -> Tensor:
    """``theta`` wrapped to [-pi, pi)."""
    return angle_diff(0.0, theta)


def normal_logpdf(x: Tensor, mean: Tensor, std: Tensor) -> Tensor:
    """Gaussian log-density, elementwise."""
    z = (x - mean) / std
    return -0.5 * z * z - torch.log(std) - _LOG_SQRT_2PI
