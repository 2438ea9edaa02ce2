"""The selection step of one grid SLAM update, one kernel launch on the card.

After the map kernel (K1, K3, or the dda and dense likelihood) a
single-world update carries the weights (``log(prev) + log_lik +
log_motion``), normalizes them, takes the argmax and N_eff, draws the
N_eff-gated systematic resample and gathers the poses.  :func:`slam_select`
does all of it.  On a CPU tensor it runs :func:`slam_select_reference`,
the ATen chain as ``update`` called it (:func:`weigh_and_select`, then
``index_select`` and the gather); on a CUDA tensor it launches the
hand-written kernel ``csrc/slam_select.cu`` once into fresh outputs on the
current stream (so a CUDA graph captures it), counted in
``slam_select.launches``, or raises.  The kernel repeats the chain's
roundings and the card's ATen sum and CUB scan orders, so on the card the
two give the same bits.

Fleets (``models/gridslam.update_fleet`` and the mesh blocks) keep
:func:`weigh_and_select` over ``[W, P]``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from slamrs_tpu_torch.ops import resample as _resample

Tensor = torch.Tensor

# one CTA, a thread a particle (csrc/slam_select.cu's kMaxParticles)
MAX_PARTICLES = 1024


class Selection(NamedTuple):
    """One update's selection: the carried or reset weights, the pending
    ancestors, the best particle and its pose, N_eff, whether the
    resample fired, and the sampled poses gathered by the ancestors (None
    where not asked for)."""

    weights: Tensor  # f32[P]
    ancestors: Tensor  # i32[P]
    best_idx: Tensor  # i32[]
    n_eff: Tensor  # f32[]
    do_resample: Tensor  # bool[]
    best_pose: Tensor  # f32[3]
    poses: Tensor | None  # f32[P, 3]


def weigh_and_select(log_lik: Tensor, log_motion: Tensor,
                     prev_weights: Tensor, frac: float, p: int,
                     u01: Tensor):
    """Weight carry, normalization, argmax, N_eff, and the N_eff-gated
    systematic resample (identity ancestors when it does not fire), per
    world over any leading worlds axes: ``(weights, ancestors, best_idx,
    n_eff, do_resample)``."""
    log_w = torch.log(prev_weights) + log_lik + log_motion
    weights = _resample.normalize_log_weights(log_w)
    best_idx = torch.argmax(weights, dim=-1).to(torch.int32)
    n_eff = _resample.effective_particles(weights)
    do_resample = n_eff <= frac * p
    ancestors = _resample.systematic_resample(weights, u01=u01)
    identity = torch.arange(p, dtype=torch.int32, device=weights.device)
    fire = do_resample[..., None]
    ancestors = torch.where(fire, ancestors, identity)
    weights = torch.where(fire, torch.full_like(weights, 1.0 / p), weights)
    return weights, ancestors, best_idx, n_eff, do_resample


def slam_select_reference(prev_weights: Tensor, log_lik: Tensor,
                          log_motion: Tensor, u01: Tensor, poses: Tensor,
                          frac: float, gather: bool = True) -> Selection:
    """:func:`slam_select` in plain PyTorch, on any device."""
    p = poses.shape[0]
    weights, ancestors, best_idx, n_eff, fired = weigh_and_select(
        log_lik, log_motion, prev_weights, frac, p, u01)
    # index_select: indexing by a 0-dim tensor would read it on the host
    best_pose = poses.index_select(0, best_idx.reshape(1))[0]
    return Selection(weights, ancestors, best_idx, n_eff, fired, best_pose,
                     poses[ancestors.long()] if gather else None)


def slam_select(prev_weights: Tensor, log_lik: Tensor, log_motion: Tensor,
                u01: Tensor, poses: Tensor, frac: float,
                gather: bool = True) -> Selection:
    """The selection of a single-world update of ``P`` particles from the
    last weights, the scan's and the motion's log-likelihoods (f32[P]
    each), the resample offset ``u01`` (one value, cast to float32 as the
    chain casts it) and the sampled ``poses`` (f32[P, 3]); ``gather`` asks
    for the poses gathered by the ancestors.  CPU tensors run :func:`slam_select_reference`; CUDA tensors launch
    ``slam_select_kernel`` once or raise (``P`` past
    :data:`MAX_PARTICLES` among the reasons)."""
    if poses.device.type == "cpu":
        return slam_select_reference(prev_weights, log_lik, log_motion, u01,
                                     poses, frac, gather)
    return _select_on_card(prev_weights, log_lik, log_motion, u01, poses,
                           frac, gather)


slam_select.launches = 0


class _Params(ctypes.Structure):
    """``csrc/slam_select.cu``'s ``SlamSelectParams``."""

    _fields_ = [("particles", ctypes.c_int), ("gather", ctypes.c_int),
                ("gate", ctypes.c_float), ("inv_n", ctypes.c_float),
                ("uniform", ctypes.c_float)]


def _ptr(t: Tensor | None) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _check(prev_weights: Tensor, log_lik: Tensor, log_motion: Tensor,
           u01: Tensor, poses: Tensor) -> int:
    """The card route's shapes, dtypes and plan; returns ``P``."""
    if poses.dim() != 2 or poses.shape[1] != 3 or poses.shape[0] == 0 \
            or poses.dtype != torch.float32:
        raise ValueError(f"slam_select takes one world's f32[P, 3] poses, "
                         f"got {poses.dtype}{list(poses.shape)}")
    p = poses.shape[0]
    if p > MAX_PARTICLES:
        raise ValueError(f"slam_select plans one CTA of at most "
                         f"{MAX_PARTICLES} particles, got poses "
                         f"{list(poses.shape)}")
    rows = {"prev_weights": prev_weights, "log_lik": log_lik,
            "log_motion": log_motion}
    for name, t in rows.items():
        if tuple(t.shape) != (p,) or t.dtype != torch.float32 \
                or t.device != poses.device:
            raise ValueError(f"slam_select: {name} must be f32[{p}] on "
                             f"{poses.device}, got {t.dtype}{list(t.shape)} "
                             f"on {t.device}")
    if u01.numel() != 1:
        raise ValueError(f"slam_select: u01 must be one value, got "
                         f"{list(u01.shape)}")
    return p


def _select_on_card(prev_weights: Tensor, log_lik: Tensor,
                    log_motion: Tensor, u01: Tensor, poses: Tensor,
                    frac: float, gather: bool) -> Selection:
    """:func:`slam_select` off the CPU: checks, then one launch of
    ``slam_select_kernel`` on the current stream into fresh outputs."""
    # systematic_resample's cast of the offset
    u01 = torch.as_tensor(u01, device=poses.device).to(torch.float32)
    p = _check(prev_weights, log_lik, log_motion, u01, poses)
    dev = poses.device
    if dev.type != "cuda":
        raise ValueError(f"slam_select runs on cuda or cpu, not {dev}")
    prm = _Params(particles=p, gather=int(gather),
                  # the comparison with a host scalar casts it to float32
                  gate=np.float32(frac * p),
                  # the division of a tensor by a host int multiplies by the
                  # float32 reciprocal; torch.full_like casts the double
                  inv_n=np.float32(1) / np.float32(p),
                  uniform=np.float32(1.0 / p))
    inputs = [t.contiguous() for t in
              (prev_weights, log_lik, log_motion, u01, poses)]
    f32 = dict(dtype=torch.float32, device=dev)
    weights = torch.empty(p, **f32)
    ancestors = torch.empty(p, dtype=torch.int32, device=dev)
    best_idx = torch.empty((), dtype=torch.int32, device=dev)
    n_eff = torch.empty((), **f32)
    fired = torch.empty((), dtype=torch.bool, device=dev)
    best_pose = torch.empty(3, **f32)
    gathered = torch.empty((p, 3), **f32) if gather else None

    from slamrs_tpu_torch import kernels

    lib = kernels.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.slamrs_slam_select(
            *map(_ptr, inputs), ctypes.byref(prm),
            *map(_ptr, (weights, ancestors, best_idx, n_eff, fired,
                        best_pose, gathered)),
            ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(
            f"slam_select kernel launch failed: CUDA error {rc} (poses "
            f"{list(poses.shape)})")
    slam_select.launches += 1
    return Selection(weights, ancestors, best_idx, n_eff, fired, best_pose,
                     gathered)
