"""Shared helpers of the tests that hold ``slamrs_tpu_torch`` against
``slamrs_tpu``: the JAX package's random draws rebuilt from its key
chains, as numpy, for injection into the port (JAX threefry and torch
Philox never agree), and the comparison gates.

* :func:`rollout_landmark_noise` / :func:`rollout_grid_noise`: the draws
  of ``FusedWorld.rollout_cadence`` (one key per tick,
  ``split(seed, n_steps)``, kept on the ticks that fire);
* :func:`node_grid_noise`: ``GridMapSlamNode``'s chain, ``key, sub =
  split(key)`` each update, then ``derive_noise(sub, P)``;
* :func:`node_landmark_noise`: ``SimulatorNode``'s chain, ``key, sub =
  split(key)`` each tick, then the bearing and range keys
  ``split(sub)``.
"""

from __future__ import annotations

import jax
import numpy as np

from slamrs_tpu.models import gridslam as jgs


def fire_ticks(dt, period, n_steps: int, timer=0.0) -> np.ndarray:
    """Indices of the ticks that fire, by the float32 host timer."""
    dt, period = np.float32(dt), np.float32(period)
    timer = np.float32(timer)
    fire = []
    for i in range(n_steps):
        timer = np.float32(timer + dt)
        if timer > period:
            fire.append(i)
            timer = np.float32(timer - period)
    return np.array(fire, dtype=np.int64)


def world_fire_ticks(jw, n_steps: int, timer=0.0) -> np.ndarray:
    return fire_ticks(jw.dt, jw.params.update_period, n_steps, timer)


def _landmark_normals(key, lanes: int):
    k1, k2 = jax.random.split(key)
    return (jax.random.normal(k1, (lanes,)), jax.random.normal(k2, (lanes,)))


def rollout_grid_noise(jw, state, n_steps: int, seed: int, timer=0.0):
    """The per-frame grid draws of JAX's ``rollout_cadence``."""
    keys = jax.random.split(jax.random.key(seed), n_steps)[
        world_fire_ticks(jw, n_steps, timer)]
    return tuple(np.asarray(x) for x in jw._grid_noise(keys, state))


def rollout_landmark_noise(jw, n_steps: int, seed: int, timer=0.0):
    """The landmark draws of JAX's ``rollout_cadence`` (``k_lm`` of each
    scan tick's key, split into bearing and range keys)."""
    keys = jax.random.split(jax.random.key(seed), n_steps)[
        world_fire_ticks(jw, n_steps, timer)]
    lanes = jw.scene.landmarks.shape[0]
    one = lambda key: _landmark_normals(jax.random.split(key)[0], lanes)
    return tuple(np.array(x) for x in jax.vmap(one)(keys))


def node_grid_noise(seed: int, p: int, n_updates: int) -> list:
    """``GridMapSlamNode``'s draws for its first ``n_updates`` updates,
    each ``(eps_c, eps_t, u01)`` as numpy."""
    key = jax.random.key(seed)
    out = []
    for _ in range(n_updates):
        key, sub = jax.random.split(key)
        out.append(tuple(np.array(x) for x in jgs.derive_noise(sub, p)))
    return out


def node_landmark_noise(seed: int, lanes: int, n_ticks: int) -> list:
    """``SimulatorNode``'s landmark draws for its first ``n_ticks`` ticks
    (every tick splits its key, fired or not), each ``(noise_a,
    noise_d)`` as numpy."""
    key = jax.random.key(seed)
    subs = []
    for _ in range(n_ticks):
        key, sub = jax.random.split(key)
        subs.append(sub)
    na, nd = jax.vmap(lambda k: _landmark_normals(k, lanes))(
        jax.numpy.stack(subs))
    return list(zip(np.array(na), np.array(nd)))


def flip_fraction(a, b, tol: float = 0.01) -> float:
    """Share of cells of two maps that differ by more than ``tol``."""
    return float((np.abs(np.asarray(a, np.float32)
                         - np.asarray(b, np.float32)) > tol).mean())
