"""slamrs_tpu_torch ICP (ops/icp.py, models/icp_mapper.py) against slamrs_tpu.

Inputs come from numpy seeds and go through both packages.  K4's plain
version must give the JAX package's indices exactly: it does the Pallas
kernel's per-pair arithmetic, and the XLA form agrees with that kernel
on these inputs (``tests/test_icp.py``).  Normals within 1e-6 (float32
division and square root), the 3x3 solve within rtol 1e-5, ICP poses
within 1e-5 and chi within rtol 1e-4 (the normal equations are sums of
360 products taken in another order), the mapper's points and pose
within 1e-5 m and its count equal: over five scans the solves' sum
order moves the pose by up to ~2e-6 m (measured on the CPU), still far
inside the reference's own ICP parity gate of 1e-3 m
(``tests/test_parity.py:176``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from slamrs_tpu.core import motion as jmotion  # noqa: E402
from slamrs_tpu.models import icp_mapper as jmap  # noqa: E402
from slamrs_tpu.models import simulator as jsim  # noqa: E402
from slamrs_tpu.ops import icp as jicp  # noqa: E402
from slamrs_tpu_torch.core.types import Scan  # noqa: E402
from slamrs_tpu_torch.models import icp_mapper as tmap  # noqa: E402
from slamrs_tpu_torch.ops import icp as ticp  # noqa: E402

DT = np.float32(1.0 / 30.0)


def _t(a):
    return torch.from_numpy(np.array(a))


def _nn_case(name):
    """(p [B, Np, 2], q [B, Nq, 2], q_count [B]) as numpy."""
    rng = np.random.default_rng(0)
    p = rng.normal(size=(16, 360, 2)).astype(np.float32)
    q = rng.normal(size=(16, 360, 2)).astype(np.float32)
    if name == "counts_360_128_10":  # tests/test_icp.py:111-114
        qc = np.array([360] * 14 + [128, 10], np.int32)
    elif name == "count_0":
        qc = np.array([360] * 8 + [0] * 8, np.int32)
    else:  # duplicated points: each q repeated, ties go to the first
        q = np.repeat(q[:, :180], 2, axis=1)
        q[:, 300:] = q[:, :60]
        qc = np.full(16, 360, np.int32)
    return p, q, qc


@pytest.mark.parametrize("case", ["counts_360_128_10", "count_0",
                                  "duplicates"])
def test_nn_reference_matches_jax(case):
    p, q, qc = _nn_case(case)
    jp, jq, jqc = jnp.asarray(p), jnp.asarray(q), jnp.asarray(qc)
    xla = np.asarray(jax.vmap(jicp.nearest_neighbors)(jp, jq, jqc))
    pallas = np.asarray(jicp.nearest_neighbors_fused(jp, jq, jqc,
                                                     interpret=True))
    ours = ticp.nearest_neighbors_reference(_t(p), _t(q), _t(qc)).numpy()
    assert ours.dtype == np.int32
    np.testing.assert_array_equal(ours, pallas)
    live = qc > 0  # the XLA form gives lane 0 there too, by its argmin
    np.testing.assert_array_equal(ours[live], xla[live])
    np.testing.assert_array_equal(ours[~live], 0)
    if case == "duplicates":  # a duplicate's second copy never wins
        assert not np.any(ours % 2 == 1)


NQ_SPLIT = 300


def _split_case(name, chunk):
    """(p [6, 40, 2], q [6, NQ_SPLIT, 2], q_count [6]) as numpy, with
    q_count 0, 1, chunk - 1, chunk + 1, chunk and Nq (clipped to
    [0, Nq]).  ``duplicates``: q is 60 points five times over, so every
    point's copies lie in other chunks (exact ties across chunk edges) and
    p holds some of them; ``negative``: p ten times farther out than q,
    so d2 = q2 - 2 p.q is negative; ``signed_zero``: q and p with +-0.0
    and 1.0 coordinates, so many lanes tie at d2 = +0 (q2 >= +0 makes a
    -0 distance impossible; the zeros' signs still reach the products);
    ``far``: the cloud 1,000 / 2,000 m from the origin."""
    rng = np.random.default_rng(11)
    p = rng.uniform(-1, 1, (6, 40, 2)).astype(np.float32)
    q = rng.uniform(-1, 1, (6, NQ_SPLIT, 2)).astype(np.float32)
    if name == "duplicates":
        q = np.tile(q[:, :60], (1, 5, 1))
        p[:, ::2] = q[:, 7:27]
    elif name == "negative":
        p = p * np.float32(10.0)
    elif name == "signed_zero":
        vals = np.array([0.0, -0.0, 1.0, -1.0], np.float32)
        q = vals[rng.integers(0, 4, q.shape)]
        p = vals[rng.integers(0, 4, p.shape)]
    elif name == "far":
        off = np.array([1000.0, -2000.0], np.float32)
        p, q = p + off, q + off
    qc = np.clip([0, 1, chunk - 1, chunk + 1, chunk, NQ_SPLIT], 0, NQ_SPLIT)
    return p, q, qc.astype(np.int32)


@pytest.mark.parametrize("chunk", [1, 7, 256, NQ_SPLIT - 1, NQ_SPLIT],
                         ids=["1", "7", "256", "nq-1", "nq"])
@pytest.mark.parametrize("case", ["duplicates", "negative", "signed_zero",
                                  "far"])
def test_nn_chunked_merge_matches_plain(case, chunk):
    """K4's split of the q axis and in-order merge (the spec the kernel
    follows) gives the plain version's indices bit for bit."""
    p, q, qc = (_t(x) for x in _split_case(case, chunk))
    want = ticp.nearest_neighbors_reference(p, q, qc)
    got = ticp.nearest_neighbors_chunked_reference(p, q, qc, chunk)
    assert got.dtype == torch.int32
    assert torch.equal(got, want)
    assert not got[0].any()  # q_count 0
    if case == "negative":
        pq = (p[:, :, None, :] * q[:, None, :, :]).sum(-1)
        assert float(((q * q).sum(-1)[:, None, :] - 2 * pq).min()) < 0.0
    if case == "duplicates":  # the first copy wins across chunk edges
        live = qc[:, None].expand_as(got) > 60
        assert bool((got[live] < 60).all())


@pytest.mark.parametrize("shape", [(2048, 360, 360), (1, 360, 16384),
                                   (8, 360, 4096), (4, 360, 384),
                                   (2, 1, 50), (2, 33, 50), (2, 361, 50)],
                         ids=["bench", "mapper", "far", "duplicates",
                              "np1", "np33", "np361"])
def test_nn_plan_fills_the_card_and_splits_exactly(shape):
    """The launch shape fits the kernel's limits and fills 132 SMs; the
    q split it gives (each problem's filled lanes in ``C`` chunks of
    ``ceil(q_count / C)``) merges to the plain version's indices."""
    b, n_p, nq = shape
    threads, groups, chunks = ticp.nn_plan(b, n_p, nq)
    tile = threads * 4
    tiles = b * -(-n_p // tile)
    smem = -(-nq // chunks) * 16 + tile * 8 * groups
    assert threads % 32 == 0 and threads * groups <= 1024
    assert smem <= 48 * 1024 and 1 <= chunks <= min(nq, 65535)
    assert tiles * chunks >= min(132, tiles * nq)  # one q lane a CTA at least
    if shape[0] == 2048:
        assert (threads, groups, chunks) == (96, 2, 1)  # no chunk merge
    if shape == (1, 360, 16384):
        assert tiles * chunks == 132
    rng = np.random.default_rng(12)
    b = min(b, 4)  # the split is per problem
    p = _t(rng.uniform(-1, 1, (b, n_p, 2)).astype(np.float32))
    q = _t(rng.uniform(-1, 1, (b, nq, 2)).astype(np.float32))
    for qc in {0, 1, chunks - 1, chunks + 1, nq // 3, nq}:
        qcs = torch.full((b,), max(qc, 0), dtype=torch.int32)
        chunk = max(1, -(-max(qc, 0) // chunks))
        torch.testing.assert_close(
            ticp.nearest_neighbors_chunked_reference(p, q, qcs, chunk),
            ticp.nearest_neighbors_reference(p, q, qcs), rtol=0, atol=0)


def test_nn_plan_takes_the_sm_count():
    """The plan reads the card's SM count; 132 (an H100 SXM) gives the
    plans the kernel had before the count was read, and an ICP fleet of
    ``b`` worlds splits the q axis by it."""
    for shape in ((2048, 360, 360), (1, 360, 16384), (8, 360, 4096),
                  (4, 360, 384), (2, 1, 50), (256, 360, 16384)):
        assert ticp.nn_plan(*shape, 132) == ticp.nn_plan(*shape)
    assert ticp.nn_plan(2048, 360, 360, 132) == (96, 2, 1)
    assert ticp.nn_plan(1, 360, 16384, 132) == (32, 8, 44)
    assert ticp.nn_plan(1, 360, 16384, 66) == (32, 8, 22)
    assert ticp.nn_plan(8, 360, 16384, 132) == (32, 8, 8)
    assert ticp.nn_plan(16, 360, 2048, 132) == (32, 8, 3)


@pytest.mark.parametrize("batch", [(), (2, 3)], ids=["single", "batch2x3"])
def test_nearest_neighbors_over_leading_dims(batch):
    rng = np.random.default_rng(1)
    p = rng.normal(size=(*batch, 40, 2)).astype(np.float32)
    q = rng.normal(size=(*batch, 64, 2)).astype(np.float32)
    qc = rng.integers(0, 65, size=batch).astype(np.int32)
    ref = np.asarray(jicp.nearest_neighbors(jnp.asarray(p), jnp.asarray(q),
                                            jnp.asarray(qc)))
    ours = ticp.nearest_neighbors(_t(p), _t(q), _t(qc)).numpy()
    assert ours.shape == (*batch, 40)
    live = np.broadcast_to((qc > 0)[..., None], ours.shape)
    np.testing.assert_array_equal(ours[live], ref[live])


def test_nn_wrapper_counts_only_kernel_launches():
    """On CPU tensors the wrapper runs the plain version and counts no
    launch; the kernel's input checks raise on what it does not take."""
    p, q, qc = (_t(x) for x in _nn_case("counts_360_128_10"))
    before = ticp.nearest_neighbors_fused.launches
    torch.testing.assert_close(ticp.nearest_neighbors_fused(p, q, qc),
                               ticp.nearest_neighbors_reference(p, q, qc))
    assert ticp.nearest_neighbors_fused.launches == before
    ticp.check_inputs(p, q, qc)
    bad = [(p[:, :, :1], q, qc), (p, q[:, :0], qc), (p.double(), q, qc),
           (p, q, qc.long()), (p, q[:4], qc), (p, q.transpose(1, 2)
                                               .contiguous().transpose(1, 2),
                                               qc)]
    for args in bad:
        with pytest.raises(ValueError):
            ticp.check_inputs(*args)


@pytest.mark.parametrize("count", [0, 1, 2, 3, 180])
def test_compute_normals_matches_jax(count):
    rng = np.random.default_rng(2)
    ang = np.sort(rng.uniform(0, 2 * np.pi, 200))
    q = (np.stack([np.cos(ang), np.sin(ang)], -1)
         * rng.uniform(0.5, 1.0, (200, 1))).astype(np.float32)
    ref = np.asarray(jicp.compute_normals(jnp.asarray(q), jnp.int32(count)))
    ours = ticp.normals_at(_t(q), torch.tensor(count, dtype=torch.int32),
                           torch.arange(q.shape[0]))
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-6, rtol=0)


@pytest.mark.parametrize("rank", [3, 2, 1, 0])
def test_pinv_solve_matches_jax(rank):
    rng = np.random.default_rng(3 + rank)
    a = rng.normal(size=(32, 3, 3)).astype(np.float32)
    a[:, :, rank:] = 0.0  # rank-deficient: h = a a^T has rank `rank`
    h = (a @ a.transpose(0, 2, 1)).astype(np.float32)
    b = rng.normal(size=(32, 3)).astype(np.float32)
    ref = np.asarray(jicp._pinv_solve(jnp.asarray(h), jnp.asarray(b)))
    ours = ticp._pinv_solve(_t(h), _t(b)).numpy()
    assert np.isfinite(ours).all()
    np.testing.assert_allclose(ours, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max() + 1e-30)


def _ring(n=180):
    """tests/test_parity.py:162-168's ring and its moved copy."""
    rng = np.random.default_rng(5)
    ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
    q = (np.stack([np.cos(ang), np.sin(ang)], -1)
         * rng.uniform(0.6, 1.0, (n, 1))).astype(np.float32)
    c, s = np.cos(0.05), np.sin(0.05)
    p = q @ np.array([[c, s], [-s, c]], np.float32) + np.array(
        [0.03, -0.02], np.float32)
    return p.astype(np.float32), q


def _bench_batch(batch=16, beams=360):
    """bench.py's ICP problems (bench.py:122-132) at a small batch."""
    rng = np.random.default_rng(0)
    ang = np.linspace(0, 2 * np.pi, beams, endpoint=False)
    q = np.stack([np.cos(ang), np.sin(ang)], -1).astype(np.float32)
    q = q * rng.uniform(0.5, 1.0, (beams, 1)).astype(np.float32)
    qb = np.tile(q[None], (batch, 1, 1))
    dx = rng.uniform(-0.05, 0.05, (batch, 1, 2)).astype(np.float32)
    return (q[None] + dx).astype(np.float32), qb


def _pallas_nn(p, q, q_count):
    """The JAX package's correspondence through its Pallas kernel (in
    interpret mode), over leading batch dims: the route K4 replaces."""
    batch = p.shape[:-2]
    out = jicp.nearest_neighbors_fused(
        p.reshape(-1, *p.shape[-2:]), q.reshape(-1, *q.shape[-2:]),
        jnp.asarray(q_count).reshape(-1), interpret=True)
    return out.reshape(*batch, p.shape[-2])


@pytest.mark.parametrize("case", ["ring_uniform", "ring_step0.1",
                                  "bench_batch16"])
def test_icp_point_to_normal_matches_jax(case, monkeypatch):
    """The final pose against the JAX package's default (XLA) route, and
    pose, points and per-iteration chi against its Pallas-kernel route.
    bench.py's tiled ring has near-equal neighbours, where the XLA form's
    rounding picks another index in an early iteration than the Pallas
    arithmetic K4 repeats; the iterations then converge to the same pose,
    but that iteration's chi differs."""
    if case.startswith("ring"):
        p, q = _ring()
        thr = None if case == "ring_uniform" else 0.1
        mask = np.ones(p.shape[:-1], bool)
        qc = np.int32(q.shape[0])
        x0 = np.zeros(3, np.float32)
    else:
        p, q = _bench_batch()
        thr = None
        mask = np.ones(p.shape[:-1], bool)
        mask[:, 350:] = False
        qc = np.full(p.shape[0], q.shape[1], np.int32)
        qc[-1] = 200
        x0 = np.zeros((p.shape[0], 3), np.float32)
    args = tuple(jnp.asarray(a) for a in (p, mask, q, qc, x0))
    xla = jicp.icp_point_to_normal(*args, iterations=10, step_threshold=thr)
    monkeypatch.setattr(jicp, "nearest_neighbors", _pallas_nn)
    ref = jicp.icp_point_to_normal(*args, iterations=10, step_threshold=thr)
    ours = ticp.icp_point_to_normal(_t(p), _t(mask), _t(q), _t(qc), _t(x0),
                                    iterations=10, step_threshold=thr)
    for r in (xla, ref):
        np.testing.assert_allclose(ours.transformation.numpy(),
                                   np.asarray(r.transformation), atol=1e-5)
    np.testing.assert_allclose(ours.transformed_points.numpy(),
                               np.asarray(ref.transformed_points), atol=1e-5)
    np.testing.assert_allclose(ours.chi_values.numpy(),
                               np.asarray(ref.chi_values), rtol=1e-4,
                               atol=1e-9)


def _scans(n_scans=5, ticks=6):
    """Lidar scans (numpy) along a curving drive in the default scene."""
    scene = jsim.Scene.build(
        rects=[(-1.0, -1.0, 2.0, 2.0), (-0.1, -0.4, 0.5, 0.1),
               (-0.6, 0.4, 0.2, 0.5)], lines=[(-0.6, -0.4, 0.2, 0.4)])
    pose = jnp.zeros(3, jnp.float32)
    sl, sr = np.float32(0.05) * DT, np.float32(0.08) * DT
    scans = []
    for _ in range(n_scans):
        for _ in range(ticks):
            pose = jmotion.integrate_exact(pose, sl, sr, np.float32(0.1))
        scans.append(tuple(np.asarray(x) for x in
                           jsim.lidar_scan(pose, scene, np.float32(1.0))))
    return scans


def _assert_map_state(ts, js):
    np.testing.assert_allclose(ts.points.numpy(), np.asarray(js.points),
                               atol=1e-5, rtol=0)
    assert int(ts.count) == int(js.count)
    np.testing.assert_allclose(ts.pose.numpy(), np.asarray(js.pose),
                               atol=1e-5, rtol=0)
    assert bool(ts.initialized) == bool(js.initialized)
    np.testing.assert_array_equal(ts.voxel_bitmap.numpy(),
                                  np.asarray(js.voxel_bitmap))


@pytest.mark.parametrize("kw", [dict(capacity=2048),
                                dict(capacity=2048, voxel_size=0.05),
                                dict(capacity=512)],
                         ids=["append_all", "voxel_gate", "overflow_512"])
def test_icp_mapper_update_matches_jax(kw):
    jcfg = jmap.IcpMapConfig(step_threshold=0.05, **kw)
    tcfg = tmap.IcpMapConfig(step_threshold=0.05, **kw)
    js = jmap.IcpMapState.init(jcfg)
    ts = tmap.IcpMapState.init(tcfg, "cpu")
    jupd = jax.jit(lambda s, sc: jmap.update(s, sc, jcfg))
    for scan in _scans():
        from slamrs_tpu.core.types import Scan as JScan
        js, jout = jupd(js, JScan(*(jnp.asarray(x) for x in scan)))
        ts, tout = tmap.update(ts, Scan(*(_t(x) for x in scan)), tcfg)
        _assert_map_state(ts, js)
        assert int(tout.appended) == int(jout.appended)
        np.testing.assert_allclose(tout.chi.numpy(), np.asarray(jout.chi),
                                   rtol=1e-4, atol=1e-9)
    if kw["capacity"] == 512:
        assert int(ts.count) == 512 and int(tout.appended) == 0
    else:
        assert int(ts.count) < kw["capacity"]
    if "voxel_size" in kw:
        assert int(ts.count) < 5 * 300  # the gate dropped repeat visits


# --- the ICP solve step: the plain version of icp_solve_kernel ---------------

NQ_NORMALS = 256


@pytest.mark.parametrize("count", [0, 1, 2, 3, 200, NQ_NORMALS],
                         ids=["0", "1", "2", "3", "200", "nq"])
def test_normals_at_are_compute_normals_gathered(count):
    """The kernel's normals, computed only at the lanes it reads, are
    the whole-map ``compute_normals`` of the plain path before the solve
    kernel (``h100bench/reference/icp.py``) gathered there bit for bit: at
    lane 0, at ``q_count - 1``, past ``q_count``, at the wrapping ends,
    and at random lanes, over a leading batch of three problems."""
    rng = np.random.default_rng(20 + count)
    ang = np.sort(rng.uniform(0, 2 * np.pi, (3, NQ_NORMALS)), axis=-1)
    q = _t((np.stack([np.cos(ang), np.sin(ang)], -1)
            * rng.uniform(0.5, 1.0, (3, NQ_NORMALS, 1))).astype(np.float32))
    q[1, 5] = q[1, 7]  # a zero difference: a zero normal at lane 6
    qc = torch.full((3,), count, dtype=torch.int32)
    fixed = [0, 1, max(count - 2, 0), max(count - 1, 0),
             min(count, NQ_NORMALS - 1), NQ_NORMALS - 2, NQ_NORMALS - 1, 6]
    idx = torch.cat([torch.tensor(fixed).expand(3, -1),
                     torch.from_numpy(rng.integers(0, NQ_NORMALS, (3, 40)))],
                    -1)
    from h100bench.reference import icp as ref_icp

    got = ticp.normals_at(q, qc, idx)
    want = torch.gather(ref_icp.compute_normals(q, qc), -2,
                        idx[..., None].expand(*idx.shape, 2))
    assert torch.equal(got, want)
    if count <= 2:
        assert not got.any()


@pytest.mark.parametrize("threshold", [None, 0.05], ids=["uniform", "step"])
@pytest.mark.parametrize("batch", [(), (3,)], ids=["single", "batch3"])
def test_plain_icp_is_the_frozen_plain_path(threshold, batch):
    """On CPU tensors ``icp_point_to_normal`` (K4's plain version and
    ``solve_step_reference`` per iteration) gives the benchmark's frozen
    copy of the plain path before the solve kernel
    (``h100bench/reference/icp.py``) bit for bit, masked lanes and a short
    map included: the arithmetic is unchanged."""
    from h100bench.reference import icp as ref_icp

    rng = np.random.default_rng(31)
    n = int(np.prod(batch, dtype=int))
    ps, qs = [], []
    for _ in range(n):
        p, q = _ring()
        ps.append(p + rng.normal(0, 0.002, p.shape).astype(np.float32))
        qs.append(q)
    p = _t(np.stack(ps).reshape(*batch, *ps[0].shape))
    q = _t(np.stack(qs).reshape(*batch, *qs[0].shape))
    mask = _t(rng.uniform(size=p.shape[:-1]) < 0.8)
    qc = torch.full(batch, q.shape[-2], dtype=torch.int32)
    if batch:
        qc[-1] = 97
    x0 = _t(rng.normal(0, 0.01, (*batch, 3)).astype(np.float32))
    ours = ticp.icp_point_to_normal(p, mask, q, qc, x0, iterations=10,
                                    step_threshold=threshold)
    pose, moved = ref_icp.icp_point_to_normal(
        p, mask, q, qc, x0, ref_icp.IcpConfig(16384, 10, threshold))
    assert torch.equal(ours.transformation, pose)
    assert torch.equal(ours.transformed_points, moved)
    assert ours.chi_values.shape == (*batch, 10)


def test_solve_wrapper_checks_inputs():
    """``icp_solve_kernel``'s input checks raise on what it does not take,
    before any kernel is loaded."""
    p, q, qc = (_t(x) for x in _nn_case("counts_360_128_10"))
    mask = torch.ones(p.shape[:2], dtype=torch.bool)
    x = torch.zeros(p.shape[0], 3)
    ticp.check_solve_inputs(p, mask, q, qc, x)
    bad = [(p, mask.float(), q, qc, x), (p, mask[:, :-1], q, qc, x),
           (p, mask.t().contiguous().t(), q, qc, x),
           (p, mask, q, qc, x.double()), (p, mask, q, qc, x[:, :2]),
           (p, mask, q, qc, x.t().contiguous().t()),
           (p, mask, q, qc.long(), x), (p, mask, q[:4], qc, x)]
    for args in bad:
        with pytest.raises(ValueError):
            ticp.check_solve_inputs(*args)
    p_t, chi = torch.empty_like(p), torch.empty(p.shape[0], 10)
    corr = torch.zeros(p.shape[:2], dtype=torch.int32)
    for k, c, out in ((10, corr, p_t), (0, corr.long(), p_t),
                      (0, corr[:, 1:], p_t), (0, corr, p_t[:, 1:])):
        with pytest.raises(ValueError):
            ticp.icp_solve(p, mask, q, qc, c, x, x, out, chi, k, 0.05)
