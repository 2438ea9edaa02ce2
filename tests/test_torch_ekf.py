"""slamrs_tpu_torch EKF landmark SLAM and landmark sensor against slamrs_tpu.

The landmark sensor gets the JAX package's normal draws injected and
must give the same scan (bearing and range within 1e-6: float32 atan2
and sqrt of the two libraries may differ by an ulp).

The EKF runs the 12-step trajectory of ``tests/test_parity.py:218-238``
with either Jacobian.  Every step starts the port from the JAX
package's state, carried over by ``slamrs_tpu_torch.convert``: mean
within 1e-5 and covariance within rtol 1e-4 plus 1e-4 of the largest
entry before or after the step.  That floor is float32 cancellation: a
first sighting turns a 1,000 prior into ~0.01 through ``(I - K H)
Sigma``, which leaves ~1e-4 of absolute rounding whichever order the
products are summed in.  The same rounding makes the free-running filter
chaotic: the JAX package alone moves its mean by 1.5e-3 when its
covariance is scaled by 1 + 1e-7 (measured on the CPU), so the
free-running trajectories are held to the reference's own EKF gate of
2e-3 (``tests/test_parity.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from slamrs_tpu.core.types import LandmarkScan as JLandmarks  # noqa: E402
from slamrs_tpu.core.types import OdometryReading as JOdo  # noqa: E402
from slamrs_tpu.models import ekf as jekf  # noqa: E402
from slamrs_tpu.models import simulator as jsim  # noqa: E402
from slamrs_tpu_torch import convert  # noqa: E402
from slamrs_tpu_torch.core.types import LandmarkScan, OdometryReading  # noqa
from slamrs_tpu_torch.models import ekf as tekf  # noqa: E402
from slamrs_tpu_torch.models import simulator as tsim  # noqa: E402

LANDMARKS = [(-1.0, -1.0), (1.0, 1.0), (-0.1, -0.4), (-0.6, 0.4),
             (-0.6, -0.4), (0.6, 0.4), (0.6, -0.4)]


@pytest.mark.parametrize("pose", [(0.0, 0.0, 0.0), (0.3, -0.2, 2.5),
                                  (-0.5, 0.1, -1.0)])
def test_landmark_scan_with_injected_draws_matches_jax(pose):
    jscene = jsim.Scene.build(landmarks=LANDMARKS, landmark_capacity=8)
    tscene = convert.scene_from_numpy(  # with the JAX scene's 8 lanes
        *(np.asarray(x) for x in jscene), "cpu")
    params = jsim.SimParams.make()
    key = jax.random.key(7)
    ref = jsim.landmark_scan(key, jnp.asarray(pose, jnp.float32), jscene,
                             params)
    k1, k2 = jax.random.split(key)
    noise_a = np.array(jax.random.normal(k1, (8,)))
    noise_d = np.array(jax.random.normal(k2, (8,)))
    ours = tsim.landmark_scan(torch.tensor(pose, dtype=torch.float32),
                              tscene, tsim.SimParams.make(),
                              noise_a=torch.from_numpy(noise_a),
                              noise_d=torch.from_numpy(noise_d))
    np.testing.assert_array_equal(ours.valid.numpy(), np.asarray(ref.valid))
    assert ours.valid.any() and not ours.valid.all()  # the range gate bites
    np.testing.assert_array_equal(ours.association.numpy(),
                                  np.asarray(ref.association))
    np.testing.assert_allclose(ours.angles.numpy(), np.asarray(ref.angles),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(ours.distances.numpy(),
                               np.asarray(ref.distances), atol=1e-6, rtol=0)


def test_landmark_scan_draws_from_the_generator():
    scene = tsim.Scene.build(landmarks=LANDMARKS, device="cpu")
    pose = torch.zeros(3)
    a = tsim.landmark_scan(pose, scene, tsim.SimParams.make(),
                           generator=torch.Generator().manual_seed(3))
    gen = torch.Generator().manual_seed(3)
    noise_a = torch.randn(7, generator=gen)
    noise_d = torch.randn(7, generator=gen)
    b = tsim.landmark_scan(pose, scene, tsim.SimParams.make(),
                           noise_a=noise_a, noise_d=noise_d)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def _trajectory():
    """tests/test_parity.py:218-238: 12 steps, 4 landmarks, as numpy."""
    true_lm = np.array([[1.0, 0.5], [-0.8, 1.2], [0.3, -1.0], [-1.1, -0.7]])
    pose = np.zeros(3)
    rng = np.random.default_rng(2)
    steps = []
    for _ in range(12):
        dl, dr = 0.02, 0.026
        th = pose[2] + (dr - dl) / 0.1
        s = (dl + dr) / 2
        pose = np.array([pose[0] + np.cos(th) * s,
                         pose[1] + np.sin(th) * s, th])
        obs = []
        for j, lm in enumerate(true_lm):
            d = np.hypot(*(lm - pose[:2])) + rng.normal(0, 0.01)
            a = np.arctan2(lm[1] - pose[1], lm[0] - pose[0]) - pose[2]
            obs.append((d, a, j))
        valid = np.ones(4, bool)
        valid[len(steps) % 4] = len(steps) % 3 != 0  # some lanes drop out
        steps.append((np.array([a for _, a, _ in obs], np.float32),
                      np.array([d for d, _, _ in obs], np.float32),
                      np.arange(4, dtype=np.int32), valid,
                      (np.float32(dl), np.float32(dr), np.float32(0.1))))
    return steps


def _assert_ekf(ts, js, cov_before=None):
    np.testing.assert_allclose(ts.mean.numpy(), np.asarray(js.mean),
                               atol=1e-5, rtol=0)
    jc = np.asarray(js.cov)
    scale = np.abs(jc).max() if cov_before is None else max(
        np.abs(jc).max(), np.abs(np.asarray(cov_before)).max())
    np.testing.assert_allclose(ts.cov.numpy(), jc, rtol=1e-4,
                               atol=1e-4 * scale)
    np.testing.assert_array_equal(ts.seen.numpy(), np.asarray(js.seen))


@pytest.mark.parametrize("reference_jacobian", [True, False],
                         ids=["reference_jacobian", "textbook_jacobian"])
def test_ekf_update_matches_jax(reference_jacobian):
    kw = dict(num_landmarks=4, reference_jacobian=reference_jacobian)
    jcfg, tcfg = jekf.EkfConfig(**kw), tekf.EkfConfig(**kw)
    js = jekf.EkfState.init(jcfg)
    free = tekf.EkfState.init(tcfg, "cpu")
    _assert_ekf(free, js)
    jupd = jax.jit(lambda s, o, od: jekf.update(s, o, od, jcfg))
    for angles, dists, assoc, valid, odo in _trajectory():
        obs = LandmarkScan(*(torch.from_numpy(x) for x in
                             (angles, dists, assoc, valid)))
        todo = OdometryReading(*(torch.tensor(x) for x in odo))
        carried = convert.ekf_state_from_numpy(
            np.asarray(js.mean), np.asarray(js.cov), np.asarray(js.seen),
            "cpu")
        before = js.cov
        js, jout = jupd(js, JLandmarks(*(jnp.asarray(x) for x in
                                         (angles, dists, assoc, valid))),
                        JOdo(*(jnp.asarray(x) for x in odo)))
        ts, tout = tekf.update(carried, obs, todo, tcfg)
        _assert_ekf(ts, js, before)
        free, _ = tekf.update(free, obs, todo, tcfg)
        np.testing.assert_allclose(free.mean.numpy(), np.asarray(js.mean),
                                   atol=2e-3, rtol=0)
    np.testing.assert_allclose(tout.landmark_means.numpy(),
                               np.asarray(jout.landmark_means), atol=1e-5)
    jc = np.asarray(jout.landmark_covs)
    np.testing.assert_allclose(tout.landmark_covs.numpy(), jc, rtol=1e-4,
                               atol=1e-4 * np.abs(jc).max())
    assert bool(tout.seen.all())


def test_ekf_straight_line_motion_matches_jax():
    """omega == 0 takes the straight-line branch of the motion model."""
    cfg_j, cfg_t = jekf.EkfConfig(num_landmarks=2), \
        tekf.EkfConfig(num_landmarks=2)
    obs = (np.array([0.4, -1.1], np.float32), np.array([0.8, 0.6], np.float32),
           np.array([0, 1], np.int32), np.array([True, False]))
    odo = (np.float32(0.02), np.float32(0.02), np.float32(0.1))
    js, _ = jekf.update(jekf.EkfState.init(cfg_j),
                        JLandmarks(*(jnp.asarray(x) for x in obs)),
                        JOdo(*(jnp.asarray(x) for x in odo)), cfg_j)
    ts, _ = tekf.update(tekf.EkfState.init(cfg_t, "cpu"),
                        LandmarkScan(*(torch.from_numpy(x) for x in obs)),
                        OdometryReading.make(*odo), cfg_t)
    _assert_ekf(ts, js)
