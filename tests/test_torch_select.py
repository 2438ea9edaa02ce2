"""The selection step of one grid SLAM update (``ops/select.py``) on the CPU.

On the CPU ``slam_select`` runs its plain version: the weight carry,
normalization, argmax, N_eff and the N_eff-gated systematic resample
(``weigh_and_select``), then the best pose and the pose gather, as
``update`` called them before they were one launch on the card.  Gates:
that chain against the JAX package's ``_weigh_and_select`` and
``systematic_resample`` under injected offsets (weights and N_eff within
rtol 1e-6, the sums running in another order; argmax, gate and
ancestors equal); the wrapper's CPU route bit for bit the plain version,
with and without the gather; the card route's checks (a particle count
past the kernel's one-CTA plan, dtypes and shapes) raising before any
launch; ``update`` selecting once a single-world update, under every
integrator, and never in a fleet update.  The kernel itself is held to
the plain version bit for bit on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from slamrs_tpu.models import gridslam as jgs  # noqa: E402
from slamrs_tpu.ops import resample as jres  # noqa: E402
from slamrs_tpu_torch.core.types import OdometryReading, Scan  # noqa: E402
from slamrs_tpu_torch.models import gridslam as gs  # noqa: E402
from slamrs_tpu_torch.ops import select  # noqa: E402

P = 64


def _rows(kind, seed, p=P):
    """``(prev_weights, log_lik, log_motion, poses)`` as float32 numpy:
    broad, peaked (a few particles dominate) or with exact zero previous
    weights and -inf log-likelihoods."""
    rng = np.random.default_rng(seed)
    prev = rng.random(p) + 0.05
    lik = rng.normal(scale=2.0, size=p)
    if kind == "peaked":
        lik = rng.normal(scale=40.0, size=p)
    if kind == "zeros":
        prev[rng.random(p) < 0.2] = 0.0
        prev[0] = 1.0
        lik[rng.random(p) < 0.2] = -np.inf
        lik[0] = 0.0
    prev = prev / prev.sum()
    motion = rng.normal(scale=0.5, size=p)
    poses = rng.normal(size=(p, 3))
    return tuple(a.astype(np.float32) for a in (prev, lik, motion, poses))


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("kind", ["broad", "peaked", "zeros"])
@pytest.mark.parametrize("u01", [0.0, 0.37, float(np.nextafter(
    np.float32(1), np.float32(0)))], ids=["u0", "u037", "u_below_1"])
@pytest.mark.parametrize("frac", [1.0, 0.3])
def test_reference_matches_jax_weigh_and_select(kind, u01, frac):
    """``slam_select_reference`` against the JAX package's
    ``_weigh_and_select`` on the same rows and the same injected offset:
    weights and N_eff within rtol 1e-6, the argmax, the gate and the
    ancestors equal; the best and gathered poses are the JAX indices'."""
    prev, lik, motion, poses = _rows(kind, 7)
    u = np.asarray([u01], np.float32)
    jw, janc, jbest, jneff, jfired = (np.asarray(x) for x in
                                      jgs._weigh_and_select(
                                          lik, motion, prev, None, frac, P,
                                          u01=u))
    sel = select.slam_select_reference(*_t(prev, lik, motion, u, poses),
                                       frac)
    np.testing.assert_allclose(sel.weights.numpy(), jw, rtol=1e-6, atol=0)
    np.testing.assert_allclose(float(sel.n_eff), float(jneff), rtol=1e-6)
    assert int(sel.best_idx) == int(jbest)
    assert bool(sel.do_resample) == bool(jfired)
    assert sel.ancestors.dtype == torch.int32
    np.testing.assert_array_equal(sel.ancestors.numpy(), janc)
    np.testing.assert_array_equal(sel.best_pose.numpy(), poses[int(jbest)])
    np.testing.assert_array_equal(sel.poses.numpy(), poses[janc])


@pytest.mark.parametrize("u01", [0.0, 0.5, 0.999])
def test_resample_of_the_reference_weights_matches_jax(u01):
    """The port's normalized weights through the JAX package's
    ``systematic_resample`` with the same offset give the reference's
    ancestors (the count is a function of the values alone)."""
    prev, lik, motion, poses = _rows("peaked", 3)
    u = np.asarray([u01], np.float32)
    sel = select.slam_select_reference(*_t(prev, lik, motion, u, poses),
                                       1.0)
    assert bool(sel.do_resample)
    w = select.weigh_and_select(*_t(lik, motion, prev), 0.0, P,
                                torch.from_numpy(u))[0]
    janc = np.asarray(jres.systematic_resample(None, w.numpy(), u01=u))
    np.testing.assert_array_equal(sel.ancestors.numpy(), janc)


@pytest.mark.parametrize("p", [1, 10, 64, 1024])
def test_cpu_route_is_the_plain_version(p):
    """``slam_select`` on CPU tensors is ``slam_select_reference``, bit for
    bit, which is ``weigh_and_select`` then ``index_select`` and the
    gather; without the gather no poses come back."""
    prev, lik, motion, poses = _rows("broad", 11 + p, p)
    args = _t(prev, lik, motion, np.asarray([0.25], np.float32), poses)
    for gather in (True, False):
        got = select.slam_select(*args, 0.5, gather=gather)
        want = select.slam_select_reference(*args, 0.5, gather=gather)
        for a, b in zip(got, want):
            assert (a is None and b is None) or torch.equal(a, b)
        assert (got.poses is None) is not gather
    weights, anc, best, n_eff, fired = select.weigh_and_select(
        args[1], args[2], args[0], 0.5, p, args[3])
    assert torch.equal(got.weights, weights) and torch.equal(got.ancestors,
                                                             anc)
    assert torch.equal(got.best_pose, args[4][int(best)])
    assert float(got.n_eff) == float(n_eff) and bool(got.do_resample) \
        == bool(fired)


def _meta(p=P, **override):
    rows = dict(prev_weights=torch.empty(p), log_lik=torch.empty(p),
                log_motion=torch.empty(p), u01=torch.empty(1),
                poses=torch.empty(p, 3))
    rows.update(override)
    return {k: v.to("meta") for k, v in rows.items()}


@pytest.mark.parametrize("override, match", [
    (dict(poses=torch.empty(1025, 3), prev_weights=torch.empty(1025),
          log_lik=torch.empty(1025), log_motion=torch.empty(1025)),
     r"at most 1024 particles, got poses \[1025, 3\]"),
    (dict(log_lik=torch.empty(P, dtype=torch.float64)), "log_lik must be"),
    (dict(log_motion=torch.empty(P, 1)), "log_motion must be"),
    (dict(prev_weights=torch.empty(P + 1)), "prev_weights must be"),
    (dict(poses=torch.empty(P, 2)), "f32\\[P, 3\\] poses"),
    (dict(poses=torch.empty(P, 3, dtype=torch.float64)), "f32\\[P, 3\\]"),
    (dict(u01=torch.empty(2)), "u01 must be one value"),
    ({}, "cuda or cpu")],
    ids=["past_the_plan", "dtype", "shape", "length", "pose_width",
         "pose_dtype", "u01", "meta_device"])
def test_card_route_checks_raise_before_a_launch(override, match):
    """The card route refuses a particle count past the one-CTA plan
    (naming the shape), wrong dtypes and shapes, and a device other than
    the CPU or CUDA, before it builds or launches anything."""
    rows = _meta(**override)
    with pytest.raises(ValueError, match=match):
        select.slam_select(rows["prev_weights"], rows["log_lik"],
                           rows["log_motion"], rows["u01"], rows["poses"],
                           1.0)


class _Spy:
    def __init__(self, monkeypatch):
        self.calls = 0
        self.fn = select.slam_select
        monkeypatch.setattr(gs, "slam_select", self)

    def __call__(self, *args, **kw):
        self.calls += 1
        return self.fn(*args, **kw)


def _config(**kw):
    return gs.GridSlamConfig(**{
        **dict(position_x=-2.0, position_y=-2.0, width=4.0, height=4.0,
               resolution=0.05, n_particles=8, max_scan_range=1.0,
               integrate="fused", resample_neff_frac=0.9,
               grid_dtype="bfloat16"), **kw})


def _inputs(w=None):
    g = torch.Generator().manual_seed(3)
    nb = 360
    angles = torch.deg2rad(torch.arange(nb, dtype=torch.float32))
    scan = Scan(angles, 0.1 + torch.rand(nb, generator=g), torch.ones(nb),
                torch.rand(nb, generator=g) < 0.8, torch.ones(nb, dtype=bool))
    odo = OdometryReading(torch.tensor(0.011), torch.tensor(0.017), 0.1)
    noise = gs.UpdateNoise(torch.randn(8, generator=g),
                           torch.randn(8, generator=g),
                           torch.rand(1, generator=g))
    if w is None:
        return scan, odo, noise
    return (Scan(*(x.expand(w, -1) for x in scan)),
            OdometryReading(odo.distance_left.expand(w),
                            odo.distance_right.expand(w), 0.1),
            gs.UpdateNoise(*(x.expand(w, -1) for x in noise)))


@pytest.mark.parametrize("route, want", [
    ("deferred", 1), ("cow", 1), ("gather", 1), ("tiled", 1), ("dda", 1),
    ("dense", 1), ("fleet_cow", 0), ("fleet_gather", 0), ("fleet_dda", 0),
    ("fleet_tiled", 2)])
def test_update_selects_once_per_single_world_update(monkeypatch, route,
                                                     want):
    """A single-world update selects once whatever its integrator and
    mechanism; ``update_fleet``'s world-axis routes keep the ATen chain
    over ``[W, P]`` and never call it; a tiled fleet runs ``update`` once
    per world (two here), each selecting once."""
    kw = {"deferred": {}, "cow": dict(resample_cow=True,
                                      fused_resident=False),
          "gather": dict(resample_cow=False, fused_resident=False),
          "tiled": dict(resample_cow="tiled"),
          "dda": dict(integrate="dda", grid_dtype="float32"),
          "dense": dict(integrate="dense", grid_dtype="float32")}
    spy = _Spy(monkeypatch)
    name = route.split("_")[-1]
    config = _config(**kw[name])
    if route.startswith("fleet"):
        if name == "gather":
            config = dataclasses.replace(config, fleet_resample="gather")
        scan, odo, noise = _inputs(2)
        gs.update_fleet(gs.GridSlamState.init(config, "cpu", (2,)), scan,
                        odo, config, noise=noise)
    else:
        scan, odo, noise = _inputs()
        gs.update(gs.GridSlamState.init(config, "cpu"), scan, odo, config,
                  noise=noise)
    assert spy.calls == want
