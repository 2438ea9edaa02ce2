"""Differential-drive robot scene, 360-beam lidar and landmark sensor.

Counterpart of ``slamrs_tpu/models/simulator.py`` (``SimParams.make``,
``Scene.build``, ``SimState``, ``SimOutputs``, ``lidar_scan``,
``landmark_scan``, ``tick``).  The lidar casts one
beam per whole degree; a beam that hits nothing is absent (``present``
false), and a hit beyond the scanner range is clamped to the range and
marked invalid.  The landmark sensor sees every scene landmark whose
*squared* distance is within the scanner range (the reference compares
the squared distance with the range; kept verbatim), with Gaussian
bearing and range noise and the landmark's index as its association.

``tick`` keeps the scan timer a float32-exact host value, so the host
knows which ticks fire without waiting for the device: a tick that does
not fire integrates the motion only, and its outputs carry no scan.

:func:`sim_frame` is the simulator's device work for a run of ticks: the
motion of each tick, then, on a tick that scans, the lidar scan from the
last pose.  On a CPU tensor it runs :func:`sim_frame_reference`, the
plain PyTorch version (``core/motion.integrate_exact`` a tick, then
:func:`lidar_scan`); on a CUDA tensor it launches the hand-written CUDA
kernel ``csrc/sim_frame.cu``, one launch a call with a CTA a world, or
raises.  The kernel repeats the plain version's roundings as the card's
ATen kernels make them, so on the card the two give the same bits.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from slamrs_tpu_torch.core import motion
from slamrs_tpu_torch.core.types import (Command, LandmarkScan,
                                         OdometryReading, Scan)
from slamrs_tpu_torch.ops import raycast as _raycast

Tensor = torch.Tensor

DEFAULT_DT = 1.0 / 30.0
NUM_BEAMS = 360


def _f32(v) -> float:
    """A Python float holding the float32 rounding of ``v``."""
    return float(np.float32(v))


class SimParams(NamedTuple):
    """Simulator parameters, held as float32-exact Python floats (the JAX
    package holds them as float32 scalars)."""

    wheel_base: float  # m
    update_period: float  # s between scans
    scanner_range: float  # m
    angle_uncertainty: float  # rad (landmark sensor)
    distance_uncertainty: float  # m (landmark sensor)

    @staticmethod
    def make(wheel_base=0.1, update_period=0.2, scanner_range=1.0,
             angle_uncertainty=0.03, distance_uncertainty=0.02) -> "SimParams":
        return SimParams(_f32(wheel_base), _f32(update_period),
                         _f32(scanner_range), _f32(angle_uncertainty),
                         _f32(distance_uncertainty))


def _padded(rows, width, device) -> tuple[Tensor, Tensor]:
    """``rows`` as f32[max(len, 1), width] plus the mask of real rows."""
    cap = max(len(rows), 1)
    arr = np.zeros((cap, width), np.float32)
    if rows:
        arr[:len(rows)] = np.asarray(rows, np.float32)
    return (torch.from_numpy(arr).to(device),
            torch.arange(cap, device=device) < len(rows))


class Scene(NamedTuple):
    """Padded geometry: line segments f32[S, 4] ``(x1, y1, x2, y2)`` and
    point landmarks f32[L, 2], each with a validity mask."""

    segments: Tensor
    segment_mask: Tensor
    landmarks: Tensor
    landmark_mask: Tensor

    @staticmethod
    def build(lines=(), rects=(), landmarks=(), device=None) -> "Scene":
        """lines: (x1, y1, x2, y2); rects: (x, y, w, h), each four
        segments; landmarks: (x, y)."""
        segs = [tuple(map(float, l)) for l in lines]
        for (x, y, w, h) in rects:
            segs += [(x, y, x + w, y), (x + w, y, x + w, y + h),
                     (x + w, y + h, x, y + h), (x, y + h, x, y)]
        lms = [tuple(map(float, l)) for l in landmarks]
        segments, segment_mask = _padded(segs, 4, device)
        lm, lm_mask = _padded(lms, 2, device)
        return Scene(segments=segments, segment_mask=segment_mask,
                     landmarks=lm, landmark_mask=lm_mask)


def lidar_scan(pose: Tensor, scene: Scene, scanner_range: float,
               num_beams: int = NUM_BEAMS) -> Scan:
    """One full revolution from ``pose`` (f32[..., 3])."""
    dev = pose.device
    rel_angles = torch.deg2rad(torch.arange(num_beams, dtype=torch.float32,
                                            device=dev))
    batch = pose.shape[:-1]
    rel = torch.broadcast_to(rel_angles, (*batch, num_beams))
    world_angles = pose[..., 2:3] + rel
    dist, hit = _raycast.raycast(pose[..., 0:2], world_angles, scene.segments,
                                 scene.segment_mask)
    rng = torch.full_like(dist, scanner_range)
    valid = hit & (dist < rng)
    distances = torch.where(valid, dist, rng)
    distances = torch.where(hit, distances, 0.0)
    return Scan(angles=rel, distances=distances,
                strengths=hit.to(torch.float32), valid=valid, present=hit)


def landmark_scan(pose: Tensor, scene: Scene, params: SimParams,
                  generator: torch.Generator | None = None,
                  noise_a: Tensor | None = None,
                  noise_d: Tensor | None = None) -> LandmarkScan:
    """Noisy range/bearing observations of every scene landmark from
    ``pose`` (f32[..., 3]).  The bearing noise, then the range noise, are
    standard normal draws from ``generator``, or ``noise_a``/``noise_d``
    (f32[..., L]) when given (tests inject the JAX package's draws)."""
    lx = scene.landmarks[..., 0]
    ly = scene.landmarks[..., 1]
    dx = lx - pose[..., 0:1]
    dy = ly - pose[..., 1:2]
    dist_sq = dx * dx + dy * dy
    in_range = dist_sq <= params.scanner_range
    angle = torch.atan2(dy, dx)
    n_lanes = scene.landmarks.shape[-2]
    shape = (*pose.shape[:-1], n_lanes)
    if noise_a is None:
        noise_a = torch.randn(shape, generator=generator, device=pose.device)
    if noise_d is None:
        noise_d = torch.randn(shape, generator=generator, device=pose.device)
    return LandmarkScan(
        angles=angle - pose[..., 2:3] + noise_a * params.angle_uncertainty,
        distances=torch.sqrt(dist_sq)
        + noise_d * params.distance_uncertainty,
        association=torch.broadcast_to(
            torch.arange(n_lanes, dtype=torch.int32, device=pose.device),
            shape),
        valid=in_range & scene.landmark_mask)


class SimState(NamedTuple):
    pose: Tensor  # f32[..., 3] ground-truth pose
    scan_timer: float  # float32-exact host timer
    scan_counter: int
    wheel_accum_left: Tensor  # f32[...] wheel travel since the last scan
    wheel_accum_right: Tensor  # f32[...]

    @staticmethod
    def init(device, batch_shape=()) -> "SimState":
        z = torch.zeros(batch_shape, dtype=torch.float32, device=device)
        return SimState(
            pose=torch.zeros((*batch_shape, 3), dtype=torch.float32,
                             device=device),
            scan_timer=0.0, scan_counter=0, wheel_accum_left=z,
            wheel_accum_right=z.clone())


class SimOutputs(NamedTuple):
    """What one tick publishes.  ``fired`` is a host bool; ``scan`` and
    ``landmarks`` are None on a tick that does not fire, and
    ``odometry`` is the wheel travel since the last scan, up to and
    including this tick."""

    fired: bool
    pose: Tensor  # f32[..., 3] ground-truth pose
    scan: Scan | None
    odometry: OdometryReading
    landmarks: LandmarkScan | None
    scan_id: int  # the scan counter before this tick


class SimFrame(NamedTuple):
    """What :func:`sim_frame` gives: the pose and the wheel-travel
    accumulators after the last tick (on a scan tick, the odometry
    reading), and the lidar scan from that pose, or None."""

    pose: Tensor  # f32[..., 3]
    accum_left: Tensor  # f32[...]
    accum_right: Tensor  # f32[...]
    scan: Scan | None


def sim_frame(pose: Tensor, accum_left: Tensor, accum_right: Tensor,
              speeds: Command, params: SimParams, dt: float = DEFAULT_DT,
              scene: Scene | None = None,
              num_beams: int = NUM_BEAMS) -> SimFrame:
    """The ticks of exact diff-drive motion at ``speeds`` (f32[n] wheel
    speeds, one a tick, the same for every world of a batch) from
    ``pose`` (f32[..., 3]) and the accumulators (f32[...]), then, with
    ``scene``, the lidar scan from the last pose.  CPU tensors run
    :func:`sim_frame_reference`; CUDA tensors launch ``sim_frame_kernel``
    once, counted in ``sim_frame.launches``, or raise.  Without ticks or
    a scene nothing runs and the inputs are returned."""
    if speeds.speed_left.dim() != 1 \
            or speeds.speed_right.shape != speeds.speed_left.shape:
        raise ValueError(f"sim_frame takes f32[n] speeds, got "
                         f"{list(speeds.speed_left.shape)} and "
                         f"{list(speeds.speed_right.shape)}")
    if speeds.speed_left.shape[0] == 0 and scene is None:
        return SimFrame(pose, accum_left, accum_right, None)
    if pose.device.type == "cpu":
        return sim_frame_reference(pose, accum_left, accum_right, speeds,
                                   params, dt, scene, num_beams)
    return _sim_frame_on_card(pose, accum_left, accum_right, speeds, params,
                              dt, scene, num_beams)


sim_frame.launches = 0


def sim_frame_reference(pose: Tensor, accum_left: Tensor,
                        accum_right: Tensor, speeds: Command,
                        params: SimParams, dt: float = DEFAULT_DT,
                        scene: Scene | None = None,
                        num_beams: int = NUM_BEAMS) -> SimFrame:
    """:func:`sim_frame` in plain PyTorch, on any device: each tick's
    travel ``speed * float32(dt)``, ``motion.integrate_exact`` and the
    accumulators' sums, then :func:`lidar_scan`."""
    dt32 = float(np.float32(dt))
    sl = speeds.speed_left * dt32
    sr = speeds.speed_right * dt32
    for i in range(sl.shape[0]):
        pose = motion.integrate_exact(pose, sl[i], sr[i], params.wheel_base)
        accum_left, accum_right = accum_left + sl[i], accum_right + sr[i]
    scan = (None if scene is None
            else lidar_scan(pose, scene, params.scanner_range, num_beams))
    return SimFrame(pose, accum_left, accum_right, scan)


def _ptr(t: Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _sim_frame_on_card(pose: Tensor, accum_left: Tensor,
                       accum_right: Tensor, speeds: Command,
                       params: SimParams, dt: float, scene: Scene | None,
                       num_beams: int) -> SimFrame:
    """:func:`sim_frame` off the CPU: checks, then one launch of
    ``sim_frame_kernel`` (``csrc/sim_frame.cu``) on the current stream
    into fresh outputs."""
    from slamrs_tpu_torch import kernels

    batch = pose.shape[:-1]
    tensors = [("the pose", pose), ("accum_left", accum_left),
               ("accum_right", accum_right),
               ("speed_left", speeds.speed_left),
               ("speed_right", speeds.speed_right)]
    if scene is not None:
        tensors.append(("the segments", scene.segments))
    for name, t in tensors:
        if t.dtype != torch.float32 or t.device != pose.device:
            raise ValueError(f"sim_frame: {name} must be f32 on "
                             f"{pose.device}, got {t.dtype} on {t.device}")
    if pose.shape[-1:] != (3,) or accum_left.shape != batch \
            or accum_right.shape != batch:
        raise ValueError(f"sim_frame takes a pose f32[..., 3] and "
                         f"accumulators of its batch shape, got "
                         f"{list(pose.shape)}, {list(accum_left.shape)} and "
                         f"{list(accum_right.shape)}")
    if scene is not None:
        segs, mask = scene.segments, scene.segment_mask
        if segs.dim() != 2 or segs.shape[1] != 4 or not segs.is_contiguous() \
                or segs.data_ptr() % 16 or mask.dtype != torch.bool \
                or mask.shape != segs.shape[:1] or not mask.is_contiguous() \
                or mask.device != pose.device:
            raise ValueError(f"sim_frame takes contiguous, 16-byte-aligned "
                             f"f32[S, 4] segments and a bool[S] mask on "
                             f"{pose.device}, got {list(segs.shape)} and "
                             f"{mask.dtype}{list(mask.shape)} on "
                             f"{mask.device}")
    lib = kernels.library()
    if pose.device.type != "cuda":
        raise ValueError(f"sim_frame runs on cuda or cpu, not {pose.device}")
    pose = pose.contiguous()
    accum_left = accum_left.contiguous()
    accum_right = accum_right.contiguous()
    new_pose = torch.empty_like(pose)
    new_left = torch.empty_like(accum_left)
    new_right = torch.empty_like(accum_right)
    scan = None
    null = ctypes.c_void_p(None)
    scan_ptrs = [null] * 5
    segments = mask = null
    n_segments = 0
    if scene is not None:
        shape = (*batch, num_beams)
        angles = torch.empty(num_beams, dtype=torch.float32,
                             device=pose.device)
        scan = Scan(angles=torch.broadcast_to(angles, shape),
                    distances=pose.new_empty(shape),
                    strengths=pose.new_empty(shape),
                    valid=torch.empty(shape, dtype=torch.bool,
                                      device=pose.device),
                    present=torch.empty(shape, dtype=torch.bool,
                                        device=pose.device))
        scan_ptrs = [_ptr(angles), _ptr(scan.distances),
                     _ptr(scan.strengths), _ptr(scan.valid),
                     _ptr(scan.present)]
        segments, mask = _ptr(scene.segments), _ptr(scene.segment_mask)
        n_segments = scene.segments.shape[0]
    inv_wheel_base = np.float32(1.0) / np.float32(params.wheel_base)
    with torch.cuda.device(pose.device):
        stream = torch.cuda.current_stream(pose.device).cuda_stream
        rc = lib.slamrs_sim_frame(
            _ptr(pose), _ptr(accum_left), _ptr(accum_right),
            _ptr(speeds.speed_left), _ptr(speeds.speed_right),
            speeds.speed_left.stride(0), speeds.speed_right.stride(0),
            speeds.speed_left.shape[0], ctypes.c_float(np.float32(dt)),
            ctypes.c_float(inv_wheel_base), segments, mask, n_segments,
            ctypes.c_float(params.scanner_range), num_beams, _ptr(new_pose),
            _ptr(new_left), _ptr(new_right), *scan_ptrs,
            pose.numel() // 3, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"sim_frame kernel launch failed: CUDA error {rc}")
    sim_frame.launches += 1
    return SimFrame(new_pose, new_left, new_right, scan)


def timer_step(scan_timer: float, params: SimParams,
               dt: float = DEFAULT_DT) -> tuple[float, bool]:
    """The scan timer of one tick, on the host: the float32 timer
    advanced by ``dt``, and whether it fires (then the period is taken
    off, carrying the remainder)."""
    period = np.float32(params.update_period)
    timer = np.float32(np.float32(scan_timer) + np.float32(dt))
    fired = bool(timer > period)
    if fired:
        timer = np.float32(timer - period)
    return float(timer), fired


def tick(state: SimState, cmd: Command, params: SimParams, scene: Scene,
         dt: float = DEFAULT_DT, num_beams: int = NUM_BEAMS,
         generator: torch.Generator | None = None,
         landmark_noise: tuple[Tensor, Tensor] | None = None
         ) -> tuple[SimState, SimOutputs]:
    """One fixed-timestep tick: the motion under ``cmd`` (0-dim f32 speed
    tensors) and the host timer (:func:`timer_step`), one
    :func:`sim_frame` call; on a tick that fires, that call's lidar scan
    and the landmark scan (its draws from ``generator``, or
    ``landmark_noise`` = ``(noise_a, noise_d)``)."""
    timer, fired = timer_step(state.scan_timer, params, dt)
    moved = sim_frame(state.pose, state.wheel_accum_left,
                      state.wheel_accum_right,
                      Command(cmd.speed_left.reshape(1),
                              cmd.speed_right.reshape(1)),
                      params, dt, scene if fired else None, num_beams)
    pose, accum_l, accum_r = moved.pose, moved.accum_left, moved.accum_right
    odometry = OdometryReading(accum_l, accum_r, params.wheel_base)
    landmarks = None
    if fired:
        noise_a, noise_d = landmark_noise or (None, None)
        landmarks = landmark_scan(pose, scene, params, generator=generator,
                                  noise_a=noise_a, noise_d=noise_d)
        accum_l = torch.zeros_like(accum_l)
        accum_r = torch.zeros_like(accum_r)
    new_state = SimState(pose=pose, scan_timer=timer,
                         scan_counter=state.scan_counter + int(fired),
                         wheel_accum_left=accum_l, wheel_accum_right=accum_r)
    return new_state, SimOutputs(fired=fired, pose=pose, scan=moved.scan,
                                 odometry=odometry, landmarks=landmarks,
                                 scan_id=state.scan_counter)
