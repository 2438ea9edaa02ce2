"""slamrs_tpu_torch.ops.cow against slamrs_tpu.ops.cow.

The copy plan must equal the JAX package's exactly (src, dst and the copy
count), and the copies and the resample must equal the JAX package's
Pallas kernel (interpret mode) slot by slot: the plans are equal, so this
is stronger than the JAX package's own multiset check.  Also the
copy-on-write mechanism of ``gs.update`` against the JAX package's, slot
by slot, under injected draws.  The CUDA kernel itself runs only on a
GPU (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from slamrs_tpu.models import gridslam as jgs  # noqa: E402
from slamrs_tpu.ops import cow as jcow  # noqa: E402
from slamrs_tpu_torch.models import gridslam as tgs  # noqa: E402
from slamrs_tpu_torch.ops import cow as tcow  # noqa: E402

P = 32


def _lineage(kind, p=P, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "random":  # systematic-resample output is sorted
        return np.sort(rng.integers(0, p, p)).astype(np.int32)
    if kind == "unsorted":
        return rng.integers(0, p, p).astype(np.int32)
    if kind == "peaked":
        anc = np.full(p, 3, np.int32)
        anc[p // 2:] = 20
        return anc
    if kind == "identity":
        return np.arange(p, dtype=np.int32)
    return np.full(p, p - 1, np.int32)  # all one ancestor


KINDS = ["random", "unsorted", "peaked", "identity", "all_one"]


@pytest.mark.parametrize("kind", KINDS)
def test_cow_plan_matches_jax(kind):
    anc = _lineage(kind)
    js, jd, jn = map(np.asarray, jcow.cow_plan(jnp.asarray(anc)))
    ts, td, tn = tcow.cow_plan(torch.from_numpy(anc))
    assert ts.dtype == td.dtype == tn.dtype == torch.int32
    assert tn.shape == ()
    np.testing.assert_array_equal(ts.numpy(), js)
    np.testing.assert_array_equal(td.numpy(), jd)
    assert int(tn) == int(jn)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cow_copy_and_resample_match_jax_slot_by_slot(kind, dtype):
    rng = np.random.default_rng(1)
    anc = _lineage(kind, seed=2)
    grids = rng.normal(size=(P, 8, 128)).astype(np.float32)
    poses = rng.normal(size=(P, 3)).astype(np.float32)
    jg = jnp.asarray(grids).astype(dtype)
    tg = torch.from_numpy(grids).to(getattr(torch, dtype))

    src, dst, n = jcow.cow_plan(jnp.asarray(anc))
    j_copied = np.asarray(jcow.cow_copy(jg, src, dst, n, interpret=True)
                          .astype(jnp.float32))
    t_copied = tcow.cow_copy(tg.clone(), *tcow.cow_plan(torch.from_numpy(anc)))
    np.testing.assert_array_equal(t_copied.float().numpy(), j_copied)

    jp, jgr = jcow.cow_resample(jg, jnp.asarray(poses), jnp.asarray(anc),
                                interpret=True)
    tp, tgr = tcow.cow_resample(tg, torch.from_numpy(poses),
                                torch.from_numpy(anc))
    assert tgr.data_ptr() == tg.data_ptr()  # in place
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tgr.float().numpy(),
                                  np.asarray(jgr.astype(jnp.float32)))
    # the resampled multiset is the gather's
    take = grids[anc].reshape(P, -1).sum(1)
    got = tgr.float().numpy().reshape(P, -1).sum(1)
    if dtype == "float32":
        np.testing.assert_array_equal(np.sort(got), np.sort(take))


def test_cow_copy_rejects_bad_plans_before_any_launch():
    """The wrapper's checks run before the device check, so a call that
    would reach a kernel fails on its inputs first."""
    grids = torch.zeros(4, 8, 128, device="meta")
    src, dst, n = (torch.zeros(4, dtype=torch.int32, device="meta"),
                   torch.zeros(4, dtype=torch.int32, device="meta"),
                   torch.zeros((), dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="src"):
        tcow.cow_copy(grids, src.long(), dst, n)
    with pytest.raises(ValueError, match="dst"):
        tcow.cow_copy(grids, src, dst[:3], n)
    with pytest.raises(ValueError, match="n_copies"):
        tcow.cow_copy(grids, src, dst, n.float())
    with pytest.raises(ValueError, match="16-byte"):
        tcow.cow_copy(torch.zeros(4, 3, 5, device="meta"), src, dst, n)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tcow.cow_copy(grids, src, dst, n)


# gs.update under the copy-on-write and whole-set-gather mechanisms,
# port against the JAX package with the JAX package's draws injected

WIDE = dict(position_x=-12.8, position_y=-6.4, width=25.6, height=12.8)
SPEC = dict(position_x=-3.2, position_y=-6.4, width=6.4, height=12.8)
B = 360
P8 = 8
ODO = (np.float32(0.02), np.float32(0.03), np.float32(0.2))


def _config(cls, geom, frac, **kw):
    return cls(**geom, resolution=0.05, n_particles=P8, max_scan_range=1.0,
               integrate="fused", grid_dtype="bfloat16",
               resample_neff_frac=frac, **kw)


def _scan(seed):
    rng = np.random.default_rng(seed)
    dist = rng.uniform(0.1, 1.0, B).astype(np.float32)
    valid = rng.uniform(size=B) < 0.8
    present = np.ones(B, bool)
    present[350:] = False
    angles = (np.arange(B) * (2 * np.pi / B)).astype(np.float32)
    return angles, dist, np.ones(B, np.float32), valid, present


def run_both(jcfg, tcfg, steps=3, seed=0):
    """``steps`` updates in both packages from fresh states, asserting
    slot-by-slot agreement after each; returns the final states."""
    from slamrs_tpu.core.types import OdometryReading as JOdo
    from slamrs_tpu.core.types import Scan as JScan
    from slamrs_tpu_torch.core.types import OdometryReading, Scan

    jst = jgs.GridSlamState.init(jcfg)
    tst = tgs.GridSlamState.init(tcfg, "cpu")
    for step in range(steps):
        scan = _scan(300 + 31 * seed + step)
        noise = jgs.derive_noise(jax.random.key(700 + 31 * seed + step), P8)
        jst, jout = jgs.update(jst, JScan(*scan), JOdo(*ODO), None, jcfg,
                               noise=noise)
        tst, tout = tgs.update(
            tst, Scan(*(torch.from_numpy(np.array(x)) for x in scan)),
            OdometryReading(*(torch.tensor(v) for v in ODO)), tcfg,
            noise=tgs.UpdateNoise(*(torch.from_numpy(np.array(x))
                                    for x in noise)))
        np.testing.assert_allclose(tst.poses.numpy(), np.asarray(jst.poses),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(tst.weights.numpy(),
                                   np.asarray(jst.weights), rtol=1e-4,
                                   atol=1e-7)
        np.testing.assert_allclose(tout.pose.numpy(), np.asarray(jout.pose),
                                   rtol=0, atol=1e-6)
        np.testing.assert_array_equal(tst.ancestors.numpy(),
                                      np.asarray(jst.ancestors))
    return jst, tst


def _flip(t, j):
    a = t.float().numpy()
    b = np.asarray(jnp.asarray(j, jnp.float32))
    return float((np.abs(a - b) > 0.01).mean())


@pytest.mark.parametrize("frac", [1.0, 0.0])
def test_gridslam_cow_matches_jax(frac):
    """``resample_cow=True`` with ``fused_resident=False`` on the wide
    geometry: copy on write in both packages, slot-exact."""
    jcfg = _config(jgs.GridSlamConfig, WIDE, frac, resample_cow=True,
                   fused_resident=False)
    tcfg = _config(tgs.GridSlamConfig, WIDE, frac, resample_cow=True,
                   fused_resident=False)
    st = tgs.GridSlamState.init(tcfg, "cpu")
    assert tgs.resample_mechanism(tcfg, st) == "cow"
    jst, tst = run_both(jcfg, tcfg, seed=int(frac))
    assert _flip(tst.grids, jst.grids) < 1e-4


@pytest.mark.parametrize("frac", [1.0, 0.0])
def test_gridslam_gather_matches_jax(frac):
    """``resample_cow=False`` with ``fused_resident=False``: the whole-set
    gather in both packages."""
    jcfg = _config(jgs.GridSlamConfig, SPEC, frac, resample_cow=False,
                   fused_resident=False)
    tcfg = _config(tgs.GridSlamConfig, SPEC, frac, resample_cow=False,
                   fused_resident=False)
    st = tgs.GridSlamState.init(tcfg, "cpu")
    assert tgs.resample_mechanism(tcfg, st) == "gather"
    jst, tst = run_both(jcfg, tcfg, seed=2 + int(frac))
    assert _flip(tst.grids, jst.grids) < 1e-4
