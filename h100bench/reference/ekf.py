"""EKF landmark SLAM in plain PyTorch: the simulator's landmark sensor and
antbern/slamrs's ``EKFLandmarkSlam`` (slam/src/landmark/ekf.rs:17-244),
followed over a cadence rollout call from a given state on the simulated
world of ``reference/world.py`` (its motion and scan timer).

A frozen copy of the port's plain paths (``models/simulator.
landmark_scan``, ``models/ekf.update``), one world or a ``[W]`` fleet, in
float32, reading the landmarks and the parameters from the benchmark's
own copy of the configuration.  TF32 is off, so every float32 product is
a float32 product.

The filter, as ekf.rs has it: the state ``[x, y, theta, l1x, l1y, ...,
lNx, lNy]`` with a zero pose block and ``1000 I`` on the landmarks; the
velocity motion model with its straight-line branch; motion noise
(0.02 m, 0.02 m, 5 deg) on the pose block; then one sequential Kalman
correction per observation lane with known association: a first
sighting puts the landmark at its expected position, the 2 x D
measurement Jacobian, observation noise (0.03 m, 3 deg), the innovation's
bearing and theta wrapped to [-pi, pi).

Departures from the Rust reference, each the port's too:

* the Jacobian is the textbook one, scaled by ``1 / q``; ekf.rs leaves
  it unnormalized, which diverges within a few updates on this scene
  (the JAX package's ``models/ekf.py``, ``reference_jacobian``);
* the state holds a fixed number of landmarks (10) and every lane is
  computed, an invalid lane's correction discarded by a ``where``; the
  Rust filter corrects only the observations it receives;
* the 2 x 2 innovation covariance is inverted in closed form (its
  adjugate over its determinant) where ekf.rs calls nalgebra's
  ``try_inverse``;
* the sensor's range gate compares the squared distance with the range
  (the simulator's own test, ``dist_sq <= range``: the same at 1 m).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from h100bench.reference import slam as ref_slam
from h100bench.reference import world as ref_world

Tensor = torch.Tensor

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


class EkfConfig(NamedTuple):
    num_landmarks: int
    motion_var: tuple  # float32 variances of x, y and theta
    obs_var: tuple  # float32 variances of range and bearing


class EkfWorld(NamedTuple):
    """The fields ``reference/world.py``'s ``tick`` reads, the landmark
    sensor's and the filter's settings."""

    landmarks: Tensor  # f32[L, 2]
    landmark_mask: Tensor  # bool[L]
    wheel_base: float
    update_period: float
    scanner_range: float
    angle_uncertainty: float
    distance_uncertainty: float
    ekf: EkfConfig


class EkfState(NamedTuple):
    mean: Tensor  # f32[.., D]
    cov: Tensor  # f32[.., D, D]
    seen: Tensor  # bool[.., N]


def _var_deg(std_deg: float) -> float:
    """float32 ``deg2rad(std)**2``."""
    rad = np.float32(std_deg) * np.float32(np.pi / 180.0)
    return float(np.float32(rad * rad))


def ekf_config(node: dict) -> EkfConfig:
    """The ``!EKFLandmarkSlam`` node's settings (ekf.rs's defaults where
    the node gives none); the Rust reference's unnormalized Jacobian is
    refused."""
    c = dict(num_landmarks=10, motion_std_x=0.02, motion_std_y=0.02,
             motion_std_theta_deg=5.0, obs_std_distance=0.03,
             obs_std_angle_deg=3.0, reference_jacobian=False)
    c.update(node.get("config") or {})
    if c["reference_jacobian"]:
        raise NotImplementedError("the reference keeps the textbook "
                                  "Jacobian")
    return EkfConfig(
        num_landmarks=int(c["num_landmarks"]),
        motion_var=(float(np.float32(c["motion_std_x"] ** 2)),
                    float(np.float32(c["motion_std_y"] ** 2)),
                    _var_deg(c["motion_std_theta_deg"])),
        obs_var=(float(np.float32(c["obs_std_distance"] ** 2)),
                 _var_deg(c["obs_std_angle_deg"])))


def build_world(graph: dict, device) -> EkfWorld:
    """The simulator's landmarks and parameters and the filter's settings
    of a node graph."""
    sim = ref_world.node(graph, "Simulator")
    marks = [(float(lm["x"]), float(lm["y"]))
             for lm in sim.get("landmarks") or []]
    arr = np.zeros((max(len(marks), 1), 2), np.float32)
    arr[:len(marks)] = np.asarray(marks, np.float32).reshape(-1, 2)
    params = dict(wheel_base=0.1, update_period=0.2, scanner_range=1.0,
                  angle_uncertainty=0.03, distance_uncertainty=0.02)
    params.update(sim.get("parameters") or {})
    f32 = ref_world._f32
    return EkfWorld(
        landmarks=torch.from_numpy(arr).to(device),
        landmark_mask=torch.arange(arr.shape[0], device=device) < len(marks),
        wheel_base=f32(params["wheel_base"]),
        update_period=f32(params["update_period"]),
        scanner_range=f32(params["scanner_range"]),
        angle_uncertainty=f32(params["angle_uncertainty"]),
        distance_uncertainty=f32(params["distance_uncertainty"]),
        ekf=ekf_config(ref_world.node(graph, "EKFLandmarkSlam")))


# --- the landmark sensor -----------------------------------------------------

class Landmarks(NamedTuple):
    angles: Tensor  # f32[.., L]
    distances: Tensor  # f32[.., L]
    association: Tensor  # i32[.., L]
    valid: Tensor  # bool[.., L]


def landmark_scan(pose: Tensor, world: EkfWorld, noise_a: Tensor,
                  noise_d: Tensor) -> Landmarks:
    """Range and bearing of every landmark from ``pose`` (f32[.., 3]) with
    the standard normal draws ``noise_a`` (bearing) and ``noise_d``
    (range), f32[.., L]; a landmark is seen within the sensor's range."""
    lx = world.landmarks[..., 0]
    ly = world.landmarks[..., 1]
    dx = lx - pose[..., 0:1]
    dy = ly - pose[..., 1:2]
    dist_sq = dx * dx + dy * dy
    in_range = dist_sq <= world.scanner_range
    angle = torch.atan2(dy, dx)
    n = world.landmarks.shape[-2]
    shape = (*pose.shape[:-1], n)
    return Landmarks(
        angles=angle - pose[..., 2:3] + noise_a * world.angle_uncertainty,
        distances=torch.sqrt(dist_sq) + noise_d * world.distance_uncertainty,
        association=torch.broadcast_to(
            torch.arange(n, dtype=torch.int32, device=pose.device), shape),
        valid=in_range & world.landmark_mask)


# --- the filter --------------------------------------------------------------

def _wrap(theta: Tensor) -> Tensor:
    return ref_slam._angle_diff(0.0, theta)


def matrix_product(a: Tensor, b: Tensor) -> Tensor:
    return a @ b


def _mat2(a, b, c, d) -> Tensor:
    return torch.stack([torch.stack([a, b], -1), torch.stack([c, d], -1)],
                       -2)


def _motion_prediction(mean: Tensor, dl: Tensor, dr: Tensor,
                       wheel_base: float):
    """``(delta_mean [.., 3], Jacobian [.., 3, 3])`` of the velocity motion
    model from ``mean``'s pose (ekf.rs's prediction)."""
    omega_dt = (dr - dl) / wheel_base
    v_dt = (dl + dr) * 0.5
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


def update(state: EkfState, obs: Landmarks, odometry, config: EkfConfig,
           product=matrix_product, quantize=None) -> EkfState:
    """One update, prediction then one correction per observation lane, of
    one world or of every world of a fleet (leading ``[W]`` axes).
    ``odometry`` is ``(left, right, wheel_base)``, the wheel travel since
    the last update.  ``product`` computes each matrix product (the
    controls sum it in another order); ``quantize`` holds the filter's
    mean and covariance in that dtype between updates (the control)."""
    dl, dr, wheel_base = odometry
    d = 3 + 2 * config.num_landmarks
    n = config.num_landmarks
    dev = state.mean.device
    batch = state.mean.shape[:-1]
    eye = torch.eye(d, dtype=torch.float32, device=dev)

    def matvec(a, v):
        return product(a, v) if v.dim() == 1 else product(a, v[..., None])[
            ..., 0]

    # ---- prediction
    g, gx = _motion_prediction(state.mean, dl, dr, wheel_base)
    mu = state.mean
    mu = torch.cat([mu[..., 0:2] + g[..., 0:2],
                    _wrap(mu[..., 2] + g[..., 2])[..., None],
                    mu[..., 3:]], -1)
    big_g = eye.expand(*batch, d, d).clone()
    big_g[..., 0:3, 0:3] = gx
    sigma = product(product(big_g, state.cov), big_g.transpose(-1, -2))
    for i, var in enumerate(config.motion_var):
        sigma[..., i, i] += var

    # ---- correction: one observation lane at a time
    seen = state.seen
    for lane in range(obs.angles.shape[-1]):
        angle = obs.angles[..., lane]
        dist = obs.distances[..., lane]
        valid = obs.valid[..., lane]
        idx = torch.clamp(obs.association[..., lane], 0,
                          n - 1).long()[..., None]
        rows = torch.cat([3 + 2 * idx, 4 + 2 * idx], -1)

        # first sighting: the landmark at its expected position
        seen_i = seen.gather(-1, idx)
        first = valid[..., None] & ~seen_i
        init_xy = torch.stack(
            [mu[..., 0] + dist * torch.cos(mu[..., 2] + angle),
             mu[..., 1] + dist * torch.sin(mu[..., 2] + angle)], -1)
        mu = mu.scatter(-1, rows, torch.where(first, init_xy,
                                              mu.gather(-1, rows)))
        seen = seen.scatter(-1, idx, seen_i | valid[..., None])

        lm = mu.gather(-1, rows)
        dx = lm[..., 0] - mu[..., 0]
        dy = lm[..., 1] - mu[..., 1]
        q = dx * dx + dy * dy
        sqrt_q = torch.sqrt(q)
        z_bar = torch.stack([sqrt_q, torch.atan2(dy, dx) - mu[..., 2]], -1)
        z = torch.stack([dist, angle], -1)

        # the textbook Jacobian: h_low / q lifted to [2, D]
        scale = 1.0 / q
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
        s_mat = product(product(h, sigma), h_t)
        s_mat[..., 0, 0] += config.obs_var[0]
        s_mat[..., 1, 1] += config.obs_var[1]
        det = s_mat[..., 0, 0] * s_mat[..., 1, 1] \
            - s_mat[..., 0, 1] * s_mat[..., 1, 0]
        inv = _mat2(s_mat[..., 1, 1], -s_mat[..., 0, 1],
                    -s_mat[..., 1, 0], s_mat[..., 0, 0]) / det[..., None, None]
        k = product(product(sigma, h_t), inv)  # [D, 2]

        diff = z - z_bar
        diff = torch.stack([diff[..., 0], _wrap(diff[..., 1])], -1)
        mu_new = mu + matvec(k, diff)
        mu_new = torch.cat([mu_new[..., 0:2],
                            _wrap(mu_new[..., 2])[..., None],
                            mu_new[..., 3:]], -1)
        sigma_new = product(eye - product(k, h), sigma)

        mu = torch.where(valid[..., None], mu_new, mu)
        sigma = torch.where(valid[..., None, None], sigma_new, sigma)

    if quantize is not None:
        mu = mu.to(quantize).float()
        sigma = sigma.to(quantize).float()
    return EkfState(mu, sigma, seen)


def reordered_product(a: Tensor, b: Tensor) -> Tensor:
    """``a @ b`` summed in another order than the library's product: the
    elementwise products reduced along the inner axis by ``sum``."""
    if b.dim() == 1:
        return (a * b).sum(-1)
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def tf32(x: Tensor) -> Tensor:
    """float32 ``x`` rounded to TF32 (10 of its 23 mantissa bits, to the
    nearest, ties away from zero), as the tensor cores' TF32 products
    round their operands."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_product(a: Tensor, b: Tensor) -> Tensor:
    """``a @ b`` of the operands rounded to TF32, summed in float32: a
    TF32 product.  (cuBLAS keeps float32 kernels at the filter's small
    shapes even where TF32 is allowed, so the flag alone changes no
    bit here.)"""
    return tf32(a) @ tf32(b)


# --- a cadence rollout call --------------------------------------------------

class CallOutputs(NamedTuple):
    pose: Tensor  # [F, .., 3] the true pose at each scan
    ekf_pose: Tensor  # [F, .., 3] the filter's pose after each update


def follow_call(sim: ref_world.SimState, ekf: EkfState, world: EkfWorld,
                left: float, right: float, n_steps: int, draws,
                product=matrix_product, quantize=None):
    """One cadence rollout call of ``n_steps`` ticks at constant wheel
    speeds from ``(sim, ekf)``: frames of idle ticks, each ending in a
    scan tick whose landmark scan, with frame ``f``'s ``draws``
    (``(noise_a [F, .., L], noise_d [F, .., L])``), updates the filter,
    then the idle ticks after the last scan.  Returns ``(sim, ekf,
    outputs)``."""
    dev = sim.pose.device
    f32 = ref_world._f32
    speed_l = torch.full((), f32(left), dtype=torch.float32, device=dev)
    speed_r = torch.full((), f32(right), dtype=torch.float32, device=dev)
    fired, timer = ref_world.fire_schedule(n_steps, sim.timer,
                                           world.update_period)
    scans = {i: f for f, i in enumerate(fired)}
    poses, ekf_poses = [], []
    for i in range(n_steps):
        sim, _ = ref_world.tick(sim, speed_l, speed_r, world,
                                force_fire=i in scans)
        if i in scans:
            f = scans[i]
            obs = landmark_scan(sim.pose, world, draws[0][f], draws[1][f])
            ekf = update(ekf, obs, (sim.accum_left, sim.accum_right,
                                    world.wheel_base), world.ekf, product,
                         quantize)
            sim = sim._replace(accum_left=torch.zeros_like(sim.accum_left),
                               accum_right=torch.zeros_like(sim.accum_right))
            poses.append(sim.pose)
            ekf_poses.append(ekf.mean[..., 0:3])
    return (sim._replace(timer=timer), ekf,
            CallOutputs(torch.stack(poses), torch.stack(ekf_poses)))


def valid_lanes(pose: Tensor, world: EkfWorld) -> Tensor:
    """The observation lanes the sensor sees from ``pose`` (bool[.., L]),
    as :func:`landmark_scan` gates them."""
    dx = world.landmarks[..., 0] - pose[..., 0:1]
    dy = world.landmarks[..., 1] - pose[..., 1:2]
    return (dx * dx + dy * dy <= world.scanner_range) & world.landmark_mask

