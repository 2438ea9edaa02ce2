"""slamrs_tpu_torch.core against slamrs_tpu.core on the same inputs.

Inputs are made with numpy from a seed and handed to both packages.
Tolerance: atol 1e-6 — both compute in float32 with the same operation
order; the last-ulp differences come from the two libraries' cos, sin,
log and remainder implementations.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from slamrs_tpu.core import math as jm  # noqa: E402
from slamrs_tpu.core import motion as jmotion  # noqa: E402
from slamrs_tpu_torch.core import math as tm  # noqa: E402
from slamrs_tpu_torch.core import motion as tmotion  # noqa: E402
from slamrs_tpu.core import types as jtypes  # noqa: E402
from slamrs_tpu_torch.core import types as ttypes  # noqa: E402
from slamrs_tpu_torch.core.types import Pose2  # noqa: E402

ATOL = 1e-6
N = 257


def _rng(seed=0):
    return np.random.default_rng(seed)


def _poses(rng):
    return np.stack([rng.uniform(-2, 2, N), rng.uniform(-2, 2, N),
                     rng.uniform(-4, 4, N)], -1).astype(np.float32)


def _wheels(rng):
    # per-scan wheel travel of the reference cadence (~0.01 m) and larger
    return (rng.uniform(-0.05, 0.05, N).astype(np.float32),
            rng.uniform(-0.05, 0.05, N).astype(np.float32))


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(jax_out, torch_out, rtol=0.0):
    np.testing.assert_allclose(np.asarray(torch_out), np.asarray(jax_out),
                               rtol=rtol, atol=ATOL)


def test_angle_diff():
    rng = _rng(1)
    a = rng.uniform(-10, 10, N).astype(np.float32)
    b = rng.uniform(-10, 10, N).astype(np.float32)
    # boundaries: equal angles, half turns, whole turns
    pi = np.float32(np.pi)
    a[:6] = [0, 0, pi, -pi, 0, 2 * pi]
    b[:6] = [0, pi, -pi, pi, -pi, 0]
    _close(jm.angle_diff(a, b), tm.angle_diff(_t(a), _t(b)))


def test_normal_logpdf():
    rng = _rng(2)
    x, mean = (rng.normal(size=N).astype(np.float32) for _ in range(2))
    std = rng.uniform(0.01, 2.0, N).astype(np.float32)
    _close(jm.normal_logpdf(x, mean, std),
           tm.normal_logpdf(_t(x), _t(mean), _t(std)))


def test_integrate_exact():
    rng = _rng(3)
    pose = _poses(rng)
    sl, sr = _wheels(rng)
    _close(jmotion.integrate_exact(pose, sl, sr, np.float32(0.1)),
           tmotion.integrate_exact(_t(pose), _t(sl), _t(sr), 0.1))


def test_sample_with_injected_eps():
    rng = _rng(4)
    pose = _poses(rng)
    dl, dr = _wheels(rng)
    eps_c, eps_t = (rng.normal(size=N).astype(np.float32) for _ in range(2))
    j = jmotion.sample(None, jnp.asarray(pose), dl, dr, np.float32(0.1),
                       eps=(eps_c, eps_t))
    t = tmotion.sample(_t(pose), _t(dl), _t(dr), 0.1,
                       eps=(_t(eps_c), _t(eps_t)))
    _close(j, t)


def test_sample_needs_a_source_of_noise():
    with pytest.raises(ValueError):
        tmotion.sample(torch.zeros(2, 3), torch.zeros(()), torch.zeros(()),
                       0.1)


def test_sample_from_generator_is_seeded():
    pose = torch.zeros(64, 3)
    draws = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(5)
        draws.append(tmotion.sample(pose, torch.tensor(0.01),
                                    torch.tensor(0.02), 0.1, generator=gen))
    assert torch.equal(draws[0], draws[1])
    assert float(draws[0][:, 2].std()) > 0.0


def test_log_prob():
    rng = _rng(6)
    p0 = _poses(rng)
    p1 = p0 + rng.normal(scale=0.02, size=p0.shape).astype(np.float32)
    dl, dr = _wheels(rng)
    # log-probabilities reach ~-50, where one float32 ulp is ~4e-6: the
    # libraries' log/sqrt may differ by that ulp, hence rtol 1e-6 on top
    _close(jmotion.log_prob(p0, p1, dl, dr, np.float32(0.1)),
           tmotion.log_prob(_t(p0), _t(p1), _t(dl), _t(dr), 0.1), rtol=1e-6)


def test_pose2_helpers():
    p = Pose2.make(1.0, 2.0, 0.5)
    assert p.dtype == torch.float32 and p.shape == (3,)
    assert float(Pose2.x(p)) == 1.0 and float(Pose2.theta(p)) == 0.5
    assert Pose2.xy(p).tolist() == [1.0, 2.0]
    assert Pose2.identity((4,)).shape == (4, 3)


@pytest.mark.parametrize("fn", ["prob_to_log_odds", "log_odds_to_prob",
                                "log_prob_mul", "log_prob_add"])
def test_probability_algebra(fn):
    rng = _rng(11)
    if fn == "prob_to_log_odds":
        args = (rng.uniform(1e-4, 1 - 1e-4, N).astype(np.float32),)
    else:
        args = tuple(rng.normal(0, 4, N).astype(np.float32)
                     for _ in range(1 if fn == "log_odds_to_prob" else 2))
    want = np.asarray(getattr(jm, fn)(*(jnp.asarray(a) for a in args)))
    got = getattr(tm, fn)(*(torch.from_numpy(a) for a in args))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=ATOL)


def _same_arrays(jax_tuple, torch_tuple):
    for name in jax_tuple._fields:
        j = np.asarray(getattr(jax_tuple, name))
        t = getattr(torch_tuple, name)
        assert t.device.type == "cpu", name
        assert t.numpy().dtype == j.dtype and t.shape == j.shape, name
        np.testing.assert_array_equal(t.numpy(), j, err_msg=name)


@pytest.mark.parametrize("beams,batch", [(360, ()), (90, (3,)), (1, (2, 4))])
def test_scan_empty(beams, batch):
    _same_arrays(jtypes.Scan.empty(beams, batch),
                 ttypes.Scan.empty(beams, batch, device="cpu"))
    scan = ttypes.Scan.empty(beams, batch, device="cpu")
    assert scan.num_beams == beams
    scan.distances.add_(1.0)  # the fields are tensors of their own
    assert float(scan.strengths.abs().sum()) == 0.0


@pytest.mark.parametrize("lanes,batch", [(7, ()), (3, (2,))])
def test_landmark_scan_empty(lanes, batch):
    _same_arrays(jtypes.LandmarkScan.empty(lanes, batch),
                 ttypes.LandmarkScan.empty(lanes, batch, device="cpu"))
