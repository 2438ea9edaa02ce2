"""slamrs_tpu_torch raycast and lidar simulator against slamrs_tpu.

The scene is the one of ``configs/grid_slam_fused.yaml``, built by both
packages.  Tolerances: distances atol 1e-5 m (float32 intersection math;
cos/sin of the beam angles may differ by an ulp between the libraries,
which moves a hit up to ~1e-6 m at the 1 m range); ``present``/``valid``
must be identical.

``sim_frame`` (a run of ticks and the lidar scan from the last pose):
its CPU route bitwise the sequence the port ran before it (the idle
ticks' loop, the scan tick's motion, ``lidar_scan``), against the JAX
package's ``tick`` at the same gates (poses atol 1e-5 m: float32
kinematics, cos/sin an ulp apart), and off the CPU the kernel or an
error, never the plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from slamrs_tpu.core import types as jtypes  # noqa: E402
from slamrs_tpu.models import simulator as jsim  # noqa: E402
from slamrs_tpu.ops import raycast as jray  # noqa: E402
from slamrs_tpu_torch import kernels  # noqa: E402
from slamrs_tpu_torch.core import motion as tmotion  # noqa: E402
from slamrs_tpu_torch.core.types import Command  # noqa: E402
from slamrs_tpu_torch.models import simulator as tsim  # noqa: E402
from slamrs_tpu_torch.ops import raycast as tray  # noqa: E402

RECTS = [(-1.0, -1.0, 2.0, 2.0), (-0.1, -0.4, 0.5, 0.1), (-0.6, 0.4, 0.2, 0.5)]
LINES = [(-0.6, -0.4, 0.2, 0.4)]
DIST_ATOL = 1e-5


def _scenes():
    j = jsim.Scene.build(lines=LINES, rects=RECTS)
    t = tsim.Scene.build(lines=LINES, rects=RECTS, device="cpu")
    return j, t


def test_scene_build():
    j, t = _scenes()
    np.testing.assert_array_equal(t.segments.numpy(), np.asarray(j.segments))
    np.testing.assert_array_equal(t.segment_mask.numpy(),
                                  np.asarray(j.segment_mask))


def test_sim_params_are_float32():
    j = jsim.SimParams.make(wheel_base=0.1, update_period=0.2,
                            scanner_range=1.0)
    t = tsim.SimParams.make(wheel_base=0.1, update_period=0.2,
                            scanner_range=1.0)
    for name in t._fields:
        assert np.float32(getattr(t, name)) == np.asarray(getattr(j, name))


@pytest.mark.parametrize("pose", [
    (0.0, 0.0, 0.0), (0.3, -0.2, 1.0), (-0.5, 0.7, -2.5),
    (0.8, 0.8, 3.1), (-0.35, 0.0, 0.78)])
def test_lidar_scan(pose):
    js, ts = _scenes()
    pose = np.asarray(pose, np.float32)
    j = jsim.lidar_scan(jnp.asarray(pose), js, np.float32(1.0))
    t = tsim.lidar_scan(torch.from_numpy(pose), ts, 1.0)
    np.testing.assert_array_equal(t.present.numpy(), np.asarray(j.present))
    np.testing.assert_array_equal(t.valid.numpy(), np.asarray(j.valid))
    np.testing.assert_allclose(t.distances.numpy(), np.asarray(j.distances),
                               rtol=0, atol=DIST_ATOL)
    np.testing.assert_array_equal(t.angles.numpy(), np.asarray(j.angles))
    np.testing.assert_array_equal(t.strengths.numpy(),
                                  np.asarray(j.strengths))


def test_raycast_random_fans():
    rng = np.random.default_rng(3)
    segs = rng.uniform(-2, 2, (40, 4)).astype(np.float32)
    mask = rng.uniform(size=40) < 0.8
    origins = rng.uniform(-1, 1, (8, 2)).astype(np.float32)
    angles = rng.uniform(-4, 4, (8, 64)).astype(np.float32)
    jd, jh = jray.raycast(origins, angles, segs, mask)
    td, th = tray.raycast(torch.from_numpy(origins), torch.from_numpy(angles),
                          torch.from_numpy(segs), torch.from_numpy(mask))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    hit = np.asarray(jh)
    np.testing.assert_allclose(td.numpy()[hit], np.asarray(jd)[hit],
                               rtol=1e-5, atol=DIST_ATOL)


POSES = np.asarray([(0.0, 0.0, 0.0), (0.3, -0.2, 1.0), (-0.5, 0.7, -2.5),
                    (0.8, 0.8, 3.1), (-0.35, 0.0, 0.78)], np.float32)


def _frame_inputs(k, worlds, seed=0):
    """Poses (one, or ``worlds`` rows of :data:`POSES`), accumulators as a
    frame leaves them and ``k + 1`` ticks of wheel speeds, numpy."""
    rng = np.random.default_rng(seed + k)
    pose = POSES[0] if worlds is None else POSES[:worlds]
    accum = rng.uniform(-0.01, 0.01, (2, *pose.shape[:-1])).astype(np.float32)
    speeds = rng.uniform(-0.3, 0.3, (2, k + 1)).astype(np.float32)
    return pose, accum, speeds


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.parametrize("scan", [False, True], ids=["motion", "scan"])
@pytest.mark.parametrize("worlds", [None, 5], ids=["one", "fleet"])
@pytest.mark.parametrize("k", [0, 1, 5])
def test_sim_frame_plain_route_is_the_sequence_it_replaced(k, worlds, scan):
    """On the CPU, ``sim_frame`` gives the bits of what the world ran
    before it: the idle ticks' loop (the travel as one product, each tick
    ``integrate_exact`` and the sums), the scan tick's ``advance`` (the
    travel of 0-dim speeds), then ``lidar_scan``."""
    _, ts = _scenes()
    params = tsim.SimParams.make()
    pose, accum, speeds = (torch.from_numpy(np.asarray(x)) for x in
                           _frame_inputs(k, worlds))
    got = tsim.sim_frame(pose, accum[0], accum[1],
                         Command(speeds[0], speeds[1]), params, scene=(
                             ts if scan else None))

    dt32 = float(np.float32(tsim.DEFAULT_DT))
    wb = params.wheel_base
    sl, sr = speeds[:, :-1] * dt32
    p, al, ar = pose, accum[0], accum[1]
    for i in range(k):  # FusedWorld.idle
        p = tmotion.integrate_exact(p, sl[i], sr[i], wb)
        al, ar = al + sl[i], ar + sr[i]
    sl, sr = speeds[0, -1] * dt32, speeds[1, -1] * dt32  # advance
    p = tmotion.integrate_exact(p, sl, sr, wb)
    al, ar = al + sl, ar + sr
    for a, b in ((got.pose, p), (got.accum_left, al),
                 (got.accum_right, ar)):
        assert torch.equal(_bits(a), _bits(b))
    if not scan:
        assert got.scan is None
        return
    want = tsim.lidar_scan(p, ts, params.scanner_range)
    for name in want._fields:
        assert torch.equal(_bits(getattr(got.scan, name)),
                           _bits(getattr(want, name))), name


@pytest.mark.parametrize("worlds", [None, 5], ids=["one", "fleet"])
@pytest.mark.parametrize("k", [0, 1, 5])
def test_sim_frame_matches_jax_ticks(k, worlds):
    """``sim_frame`` against ``k + 1`` ticks of the JAX package's
    ``tick``, the last firing: the pose, the odometry reading and the
    scan."""
    js, ts = _scenes()
    pose, accum, speeds = _frame_inputs(k, worlds, seed=7)
    jparams = jsim.SimParams.make(wheel_base=0.1, update_period=0.2,
                                  scanner_range=1.0)
    jst = jsim.SimState(pose=jnp.asarray(pose), scan_timer=jnp.float32(0.0),
                        scan_counter=jnp.int32(0),
                        wheel_accum_left=jnp.asarray(accum[0]),
                        wheel_accum_right=jnp.asarray(accum[1]))
    key = jax.random.key(0)
    for i in range(k + 1):
        if i == k:  # the last tick fires
            jst = jst._replace(scan_timer=jparams.update_period)
        jst, jout = jsim.tick(jst, jtypes.Command(jnp.float32(speeds[0, i]),
                                                  jnp.float32(speeds[1, i])),
                              key, jparams, js)
    assert bool(jout.fired)
    got = tsim.sim_frame(*(torch.from_numpy(np.asarray(x))
                           for x in (pose, *accum)),
                         Command(*torch.from_numpy(speeds)),
                         tsim.SimParams.make(), scene=ts)
    np.testing.assert_allclose(got.pose.numpy(), np.asarray(jout.pose),
                               atol=1e-5, rtol=0)
    for a, b in ((got.accum_left, jout.odometry.distance_left),
                 (got.accum_right, jout.odometry.distance_right)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-7,
                                   rtol=0)
    np.testing.assert_array_equal(got.scan.present.numpy(),
                                  np.asarray(jout.scan.present))
    np.testing.assert_array_equal(got.scan.valid.numpy(),
                                  np.asarray(jout.scan.valid))
    np.testing.assert_allclose(got.scan.distances.numpy(),
                               np.asarray(jout.scan.distances), rtol=0,
                               atol=DIST_ATOL)
    np.testing.assert_array_equal(got.scan.angles.numpy(),
                                  np.asarray(jout.scan.angles))


def test_sim_frame_off_the_cpu_goes_to_the_kernel_or_raises(monkeypatch):
    """A call on a device other than the CPU never runs the plain
    version: it checks its inputs, then loads the kernel library, and
    where there is none (no ``nvcc``) it raises."""
    _, ts = _scenes()

    def plain(*args, **kw):
        raise AssertionError("the plain version ran off the CPU")

    def no_library():
        raise RuntimeError("no kernel library")

    monkeypatch.setattr(tsim, "sim_frame_reference", plain)
    monkeypatch.setattr(kernels, "library", no_library)
    meta = dict(device="meta")
    scene = tsim.Scene(*(x.to("meta") for x in ts))
    speeds = Command(torch.zeros(6, **meta), torch.zeros(6, **meta))
    before = tsim.sim_frame.launches
    for sc in (None, scene):
        with pytest.raises(RuntimeError, match="no kernel library"):
            tsim.sim_frame(torch.zeros(4, 3, **meta), torch.zeros(4, **meta),
                           torch.zeros(4, **meta), speeds,
                           tsim.SimParams.make(), scene=sc)
    assert tsim.sim_frame.launches == before


def test_sim_frame_checks_its_inputs_and_counts_no_cpu_launch():
    """The wrapper's checks raise on what the kernel does not take, before
    it loads the library; on CPU tensors nothing is counted, and a call
    with no tick and no scene returns its inputs."""
    _, ts = _scenes()
    pose, al, ar = torch.zeros(2, 3), torch.zeros(2), torch.zeros(2)
    speeds = Command(torch.zeros(3), torch.zeros(3))
    params = tsim.SimParams.make()
    before = tsim.sim_frame.launches
    tsim.sim_frame(pose, al, ar, speeds, params, scene=ts)
    assert tsim.sim_frame.launches == before
    none = Command(torch.zeros(0), torch.zeros(0))
    out = tsim.sim_frame(pose, al, ar, none, params)
    assert out.pose is pose and out.accum_left is al and out.scan is None
    with pytest.raises(ValueError, match="f32"):
        tsim.sim_frame(pose, al, ar, Command(torch.zeros(()),
                                             torch.zeros(())), params)
    meta = {"device": "meta"}
    bad = [((torch.zeros(2, 3, **meta), torch.zeros(3, **meta),
             torch.zeros(2, **meta)), ts),
           ((torch.zeros(2, 3, **meta, dtype=torch.float64),
             torch.zeros(2, **meta), torch.zeros(2, **meta)), ts),
           ((torch.zeros(2, 3, **meta), torch.zeros(2, **meta),
             torch.zeros(2, **meta)), ts)]  # the scene on the CPU
    for args, scene in bad:
        with pytest.raises(ValueError):
            tsim.sim_frame(*args, Command(torch.zeros(3, **meta),
                                          torch.zeros(3, **meta)),
                           params, scene=scene)
