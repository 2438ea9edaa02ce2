"""The proposal of one grid SLAM update, one kernel launch on the card.

Before the fused kernel (K1, or K3 on a tile pool) a single-world update
samples each particle's successor pose from the odometry model
(``core/motion.sample``), scores the transition
(``core/motion.log_prob``) and prepares the kernel's inputs at the
sampled poses (``ops/fused.prepare``: ``pp``, ``r0`` and the beam
table).  :func:`slam_propose` does all of it.  On a CPU tensor it runs
:func:`slam_propose_reference`, those calls as they are; on a CUDA
tensor it launches the hand-written kernel ``csrc/slam_propose.cu`` once
into fresh outputs on the current stream (so a CUDA graph captures it),
counted in ``slam_propose.launches``, or raises.  The kernel repeats the
plain chain's roundings as the card's ATen kernels make them, so on the
card the two give the same bits.

Fleets (``models/gridslam.update_fleet``) and the dda and dense
integrators keep the plain chain.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from slamrs_tpu_torch.core import math as _math
from slamrs_tpu_torch.core import motion
from slamrs_tpu_torch.core.types import OdometryReading, Scan
from slamrs_tpu_torch.ops.fused import (BEAM_PAD, Prepared, check_geometry,
                                        pack3_quantum, prepare,
                                        prepared_window_rows)
from slamrs_tpu_torch.ops.grid import GridSpec2D

Tensor = torch.Tensor


class Proposal(NamedTuple):
    """One update's sampled poses, their motion log-probability, and the
    fused kernel's inputs at those poses."""

    poses: Tensor  # f32[P, 3]
    log_motion: Tensor  # f32[P]
    prep: Prepared


def beam_spacing(scan: Scan, static: float | None, device):
    """The beam spacing the fused kernel takes: ``static`` (the config's
    ``beam_spacing``) where given, else the scan's first angle step, or
    2*pi for a one-beam scan."""
    if static is not None:
        return static
    if scan.angles.shape[-1] > 1:
        return scan.angles[1] - scan.angles[0]
    return torch.tensor(2.0 * torch.pi, dtype=torch.float32, device=device)


def slam_propose_reference(poses: Tensor, odometry: OdometryReading,
                           eps: tuple[Tensor, Tensor], scan: Scan,
                           spec: GridSpec2D, max_range_m: float,
                           static_spacing: float | None, rows: int,
                           cols: int) -> Proposal:
    """:func:`slam_propose` in plain PyTorch, on any device: the sample,
    the log-probability and the preparation for maps of ``rows`` x
    ``cols``, one call each."""
    dl, dr, wb = odometry
    new_poses = motion.sample(poses, dl, dr, wb, eps=eps)
    log_motion = motion.log_prob(poses, new_poses, dl, dr, wb)
    prep = prepare(rows, cols, new_poses, scan.angles[0], scan.distances,
                   scan.valid, scan.present, spec, scan.angles.shape[-1],
                   max_range_m,
                   beam_spacing(scan, static_spacing, poses.device))
    return Proposal(new_poses, log_motion, prep)


def slam_propose(poses: Tensor, odometry: OdometryReading,
                 eps: tuple[Tensor, Tensor], scan: Scan, spec: GridSpec2D,
                 max_range_m: float, static_spacing: float | None,
                 rows: int, cols: int) -> Proposal:
    """The proposal of a single-world update with draws ``eps = (eps_c,
    eps_t)`` from ``poses`` f32[P, 3], for maps of ``rows`` x ``cols``
    (a dense map set's own; a tile pool's bands times their rows) and a
    ``[B]`` scan.  CPU tensors run :func:`slam_propose_reference`; CUDA
    tensors launch ``slam_propose_kernel`` once or raise."""
    if poses.device.type == "cpu":
        return slam_propose_reference(poses, odometry, eps, scan, spec,
                                      max_range_m, static_spacing, rows,
                                      cols)
    return _propose_on_card(poses, odometry, eps, scan, spec, max_range_m,
                            static_spacing, rows, cols)


slam_propose.launches = 0


class _Params(ctypes.Structure):
    """``csrc/slam_propose.cu``'s ``SlamProposeParams``."""

    _fields_ = [(name, ctypes.c_int) for name in (
        "particles", "num_beams", "rows", "wr", "quantize", "static_bins")
    ] + [(name, ctypes.c_float) for name in (
        "inv_wheel_base", "min_center_std", "center_std_rate",
        "theta_std_base", "theta_std_rate", "log_sqrt_2pi", "pi", "two_pi",
        "position_x", "position_y", "inv_resolution", "dphi", "inv_binu",
        "qu", "inv_qu")]


def _ptr(t: Tensor | None) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _f32(v) -> float:
    """``v`` rounded to float32, as ATen takes a host scalar."""
    return float(np.float32(v))


def _reading(name: str, v, dev) -> Tensor:
    if not isinstance(v, Tensor) or v.dtype != torch.float32 \
            or v.numel() != 1 or v.device != dev:
        raise ValueError(f"slam_propose: the odometry's {name} must be one "
                         f"float32 on {dev}, got {v!r}")
    return v


def _propose_on_card(poses: Tensor, odometry: OdometryReading,
                     eps: tuple[Tensor, Tensor], scan: Scan,
                     spec: GridSpec2D, max_range_m: float,
                     static_spacing: float | None, rows: int,
                     cols: int) -> Proposal:
    """:func:`slam_propose` off the CPU: checks, then one launch of
    ``slam_propose_kernel`` on the current stream into fresh outputs."""
    dev = poses.device
    if dev.type != "cuda":
        raise ValueError(f"slam_propose runs on cuda or cpu, not {dev}")
    if poses.dim() != 2 or poses.shape[1] != 3 or poses.shape[0] == 0 \
            or poses.dtype != torch.float32:
        raise ValueError(f"slam_propose takes one world's f32[P, 3] poses, "
                         f"got {poses.dtype}{list(poses.shape)}")
    p = poses.shape[0]
    nb = scan.angles.shape[-1]
    if scan.angles.dim() != 1 or nb == 0:
        raise ValueError(f"slam_propose takes one [B] scan, got angles "
                         f"{list(scan.angles.shape)}")
    check_geometry(cols, nb)
    lanes = {"angles": (scan.angles, torch.float32),
             "distances": (scan.distances, torch.float32),
             "valid": (scan.valid, torch.bool),
             "present": (scan.present, torch.bool)}
    for name, (t, dtype) in lanes.items():
        if t.shape != (nb,) or t.dtype != dtype or t.device != dev:
            raise ValueError(f"slam_propose: the scan's {name} must be "
                             f"{dtype}[{nb}] on {dev}, got "
                             f"{t.dtype}{list(t.shape)} on {t.device}")
    dl = _reading("distance_left", odometry.distance_left, dev)
    dr = _reading("distance_right", odometry.distance_right, dev)
    wb = odometry.wheel_base
    wb_t = _reading("wheel_base", wb, dev) if isinstance(wb, Tensor) else None
    # motion.sample's broadcast and cast of the draws
    eps_c, eps_t = (torch.broadcast_to(torch.as_tensor(e, device=dev), (p,))
                    .to(torch.float32).contiguous() for e in eps)
    static = static_spacing is not None
    qu = pack3_quantum(max_range_m / spec.resolution)
    wr = prepared_window_rows(spec, max_range_m, rows)
    prm = _Params(
        particles=p, num_beams=nb, rows=rows, wr=wr,
        quantize=int(nb <= 381), static_bins=int(static),
        inv_wheel_base=(0.0 if wb_t is not None
                        else np.float32(1) / np.float32(wb)),
        min_center_std=_f32(motion._MIN_CENTER_STD),
        center_std_rate=_f32(motion._CENTER_STD_RATE),
        theta_std_base=_f32(motion._THETA_STD_BASE),
        theta_std_rate=_f32(motion._THETA_STD_RATE),
        log_sqrt_2pi=_f32(_math._LOG_SQRT_2PI), pi=_f32(np.pi),
        two_pi=_f32(2.0 * np.pi), position_x=_f32(spec.position_x),
        position_y=_f32(spec.position_y),
        inv_resolution=np.float32(1) / np.float32(spec.resolution),
        # the spacing as beam_spacing gives it, in float32: the static one,
        # the one-beam 2*pi, or (0 here) the scan's step read on the card
        dphi=(_f32(static_spacing) if static
              else _f32(2.0 * np.pi) if nb == 1 else 0.0),
        inv_binu=_f32(1.0 / static_spacing) if static else 0.0,
        qu=_f32(qu), inv_qu=np.float32(1) / np.float32(qu))
    contiguous = [t.contiguous() for t in
                  (poses, scan.distances, scan.valid, scan.present)]
    new_poses = torch.empty((p, 3), dtype=torch.float32, device=dev)
    log_motion = torch.empty(p, dtype=torch.float32, device=dev)
    pp = torch.empty((p, 8), dtype=torch.float32, device=dev)
    r0 = torch.empty(p, dtype=torch.int32, device=dev)
    table = torch.empty((8, BEAM_PAD), dtype=torch.float32, device=dev)
    angle1 = scan.angles[1] if not static and nb > 1 else None

    from slamrs_tpu_torch import kernels

    lib = kernels.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.slamrs_slam_propose(
            _ptr(contiguous[0]), _ptr(eps_c), _ptr(eps_t), _ptr(dl),
            _ptr(dr), _ptr(wb_t), _ptr(scan.angles[0]), _ptr(angle1),
            *map(_ptr, contiguous[1:]), ctypes.byref(prm), _ptr(new_poses),
            _ptr(log_motion), _ptr(pp), _ptr(r0), _ptr(table),
            ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(
            f"slam_propose kernel launch failed: CUDA error {rc}")
    slam_propose.launches += 1
    return Proposal(new_poses, log_motion,
                    Prepared(pp, r0, table, wr,
                             float(static_spacing) if static else None))
