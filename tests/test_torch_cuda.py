"""The CUDA kernels of slamrs_tpu_torch against their plain PyTorch versions.

These tests need an NVIDIA GPU with the CUDA toolkit (the kernel is built
with nvcc at first use); without one they skip.  Run them on the card:

    python -m pytest tests/test_torch_cuda.py -q

Both versions run on the card on the same inputs.  Gates as in
chip_smoke.py: for the fused updates (K1, K3) maps equal by value (max
abs difference 0: the kernels compute only the scan disc's bounding box,
whose cells get the plain version's bits, and leave or copy the rest; the
cases include beams past the range and poses on the grid's edges) and
the likelihood within rtol 1e-5 / atol 1e-4 (the block reduction sums
in another order than torch.sum); the copy
(K2) bitwise; K3 bitwise against K1 on the materialized maps (they run
the same device code) for every particle whose two windows start on the
same row; the nearest-neighbour indices (K4) bitwise (the
same float32 arithmetic per pair, nvcc with ``--fmad=false``).  The ICP
solve kernel against its plain version on the card at the ICP mapper's,
an 8-world fleet's and bench.py's shapes (one iteration: pose within
1e-5, chi within rtol 1e-5; a whole call against the CPU within 1e-4),
bitwise the benchmark's plain reference at the mapper's shape, once an
iteration and once before, and bitwise reproducible eager and
replayed.  One ICP mapper update on the card against the same on the
CPU: pose and points within 1e-5 m (the normal equations' sums run in
another order).  The dda
and dense grid integrators (plain PyTorch, no kernel) on the card against
the CPU at ``tests/test_parity.py``'s map gate, the DDA walk bitwise, the
dda scatter bitwise reproducible on the card.  Fleets: K1 with the world
axis (a beam table per world, one launch for every world) against its
plain version at the same gates, a one-world call bitwise the
single-world call; K2 on a flattened fleet plan bitwise, every copy
inside its world; ``update_fleet`` launching K1 once a call.  Sharded
fleets on an 8-entry mesh of the one card: bitwise the one-device fleet
(``"gather"``, the world-only copy on write, the tiled loop) or its
per-world multiset (``"local"``), K1 once per block a frame; the
local-first resample on the card slot for slot its CPU result.  Host mode
(the App): K1 once per SLAM update and K4 ten times per ICP update, and
an App run on the card against the same on the CPU under injected draws;
the App's node programs as CUDA graphs bitwise the op-by-op App on every
preset and the replay, and two firing ticks in one frame publishing a
scan each.  Captured rollouts: meshes and the tick rollout bitwise the
eager loops; the world program kept across calls of either rollout
(every frame and tick a replay once its keys are met) and shared by
cadence and tick calls on one carried state.
Robot I/O: the FileLoader's Scan on the card, K4 ten times per ICP
update of a short ``neato_replay.yaml`` replay, and the virtual robot's
card scans within 1 mm of its CPU scans on fewer than 1e-3 of the beams.
The simulator kernel (a frame's ticks and its lidar scan) bitwise its
plain version on the card on the three benchmark scenes, at one world
and 256, with the roundings it repeats (cos and sin, ``deg2rad``, the
division by the wheel base) bitwise ATen's, one launch a frame.
"""

import functools
import importlib.util
import math
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from slamrs_tpu_torch.ops import cow, fused, icp, tiles  # noqa: E402
from slamrs_tpu_torch.ops.grid import GridSpec2D  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _case(dev, spec, p, num_beams, static, dtype, seed=0, scan="within"):
    """Random maps, poses, lineage and scan on the card.  ``far``: a third
    of the beams out to 5 m (past the 1 m range and the quantizer's cap)
    and six poses on the grid's column and row edges."""
    g = torch.Generator(device=dev).manual_seed(seed)
    rows, cols = spec.rows, (spec.cols + 127) // 128 * 128
    grids = torch.randn(p, rows, cols, generator=g, device=dev) * 1.5
    grids[torch.rand(p, rows, cols, generator=g, device=dev) < 0.3] = 0.0
    lo = torch.tensor([-1.3, -1.3, -math.pi], device=dev)
    hi = torch.tensor([1.3, 1.3, math.pi], device=dev)
    poses = lo + (hi - lo) * torch.rand(p, 3, generator=g, device=dev)
    anc = torch.randint(0, p, (p,), generator=g, device=dev,
                        dtype=torch.int32)
    dist = 0.1 + 0.9 * torch.rand(num_beams, generator=g, device=dev)
    valid = torch.rand(num_beams, generator=g, device=dev) < 0.8
    present = torch.rand(num_beams, generator=g, device=dev) < 0.9
    if scan == "far":
        dist[::3] = 1.0 + 4.0 * torch.rand(dist[::3].shape, generator=g,
                                           device=dev)
        _edge_poses(poses, spec)
    dphi = math.radians(1.0) if static else torch.tensor(
        math.radians(1.0), device=dev)
    args = (grids.to(dtype), poses, torch.tensor(0.1, device=dev), dist,
            valid, present, spec, num_beams, 1.0)
    return args, dict(ancestors=anc, dphi=dphi)


def _edge_poses(poses, spec):
    """Six poses on the grid's column and row edges and corners."""
    x0, y0 = spec.position_x + 0.01, spec.position_y + 0.01
    x1 = spec.position_x + spec.width - 0.01
    y1 = spec.position_y + spec.height - 0.01
    poses[0, 0], poses[1, 0], poses[2, 1], poses[3, 1] = x0, x1, y0, y1
    poses[4, 0], poses[4, 1], poses[5, 0], poses[5, 1] = x0, y0, x1, y1


def _max_diff(a, b):
    return float((a.float() - b.float()).abs().max())


@pytest.mark.parametrize("scan", ["within", "far"])
@pytest.mark.parametrize("height", [4.0, 3.9])  # 80 rows, and 78 (rows % 8)
@pytest.mark.parametrize("num_beams", [360, 90])
@pytest.mark.parametrize("static", [True, False], ids=["static", "traced"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_kernel_matches_plain(dev, height, num_beams, static, dtype, scan):
    spec = GridSpec2D(-2.0, -2.0, 4.0, height, 0.05)
    args, kw = _case(dev, spec, 64, num_beams, static, dtype, scan=scan)
    before = fused.fused_update.launches
    g_k, l_k = fused.fused_update(*args, **kw)
    torch.cuda.synchronize()
    assert fused.fused_update.launches == before + 1
    g_p, l_p = fused.fused_update_reference(*args, **kw)
    assert g_k.dtype == dtype and g_k.shape == args[0].shape
    assert _max_diff(g_k, g_p) == 0.0
    torch.testing.assert_close(l_k, l_p, rtol=1e-5, atol=1e-4)


def test_wrapper_checks_inputs(dev):
    spec = GridSpec2D(-2.0, -2.0, 4.0, 4.0, 0.05)
    args, kw = _case(dev, spec, 8, 360, True, torch.float32)
    with pytest.raises(TypeError):
        fused.fused_update(args[0].half(), *args[1:], **kw)
    with pytest.raises(ValueError, match="contiguous"):
        fused.fused_update(args[0].transpose(1, 2).contiguous().transpose(1, 2),
                           *args[1:], **kw)
    with pytest.raises(ValueError, match="ancestors"):
        fused.fused_update(*args, ancestors=kw["ancestors"].long(),
                           dphi=kw["dphi"])
    with pytest.raises(ValueError, match="on cpu"):
        fused.fused_update(args[0], args[1].cpu(), *args[2:], **kw)


@pytest.mark.parametrize("scan", ["within", "far"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_in_place_matches_plain_and_lineage_mode(dev, dtype, scan):
    spec = GridSpec2D(-2.0, -2.0, 4.0, 3.9, 0.05)
    args, kw = _case(dev, spec, 64, 360, True, dtype, scan=scan)
    g_lin, l_lin = fused.fused_update(*args, dphi=kw["dphi"])
    g_plain, l_plain = fused.fused_update_reference(
        args[0].clone(), *args[1:], dphi=kw["dphi"], in_place=True)
    grids = args[0].clone()
    before = fused.fused_update.in_place_launches
    g_in, l_in = fused.fused_update(grids, *args[1:], dphi=kw["dphi"],
                                    in_place=True)
    torch.cuda.synchronize()
    assert fused.fused_update.in_place_launches == before + 1
    assert g_in.data_ptr() == grids.data_ptr()
    assert torch.equal(g_in, g_lin) and torch.equal(l_in, l_lin)
    assert _max_diff(g_in, g_plain) == 0.0
    torch.testing.assert_close(l_in, l_plain, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("plan", ["random", "peaked", "identity"])
def test_cow_copy_matches_plain(dev, plan):
    p = 64
    g = torch.Generator(device=dev).manual_seed(1)
    grids = torch.randn(p, 80, 128, generator=g, device=dev).to(torch.bfloat16)
    if plan == "random":
        anc = torch.sort(torch.randint(0, p, (p,), generator=g, device=dev))[0]
    elif plan == "peaked":
        anc = torch.full((p,), 5, device=dev)
        anc[p // 2:] = 40
    else:
        anc = torch.arange(p, device=dev)
    src, dst, n = cow.cow_plan(anc.to(torch.int32))
    want = cow.cow_copy_reference(grids.clone(), src, dst, n)
    before = cow.cow_copy.launches
    got = cow.cow_copy(grids, src, dst, n)
    torch.cuda.synchronize()
    assert cow.cow_copy.launches == before + 1
    assert torch.equal(got, want)


# 256 x 128 (2-band span), 256 x 512 (wide), 96 x 256 (3-band span)
TILED_SPECS = {"2band": GridSpec2D(-3.2, -6.4, 6.4, 12.8, 0.05),
               "wide": GridSpec2D(-12.8, -6.4, 25.6, 12.8, 0.05),
               "kspan": GridSpec2D(-6.4, -2.4, 12.8, 4.8, 0.05)}


def _random_pool(dev, spec, p, g):
    """A tiled state with random log-odds (~30 % zeros, zero column tail)
    and a random table that shares tiles."""
    pool, table = tiles.init_tiled(p, spec, 1.0, device=dev)
    pool.copy_(torch.randn(pool.shape, generator=g, device=dev) * 1.5)
    pool[torch.rand(pool.shape, generator=g, device=dev) < 0.3] = 0.0
    pool[:, :, spec.cols:] = 0.0
    table.copy_(torch.randint(0, table.numel(), table.shape, generator=g,
                              device=dev, dtype=torch.int32))
    return pool, table


@pytest.mark.parametrize("scan", ["within", "far"])
@pytest.mark.parametrize("geom", list(TILED_SPECS))
@pytest.mark.parametrize("static", [True, False], ids=["static", "traced"])
def test_tiled_matches_plain_and_dense(dev, geom, static, scan):
    spec = TILED_SPECS[geom]
    p = 64
    g = torch.Generator(device=dev).manual_seed(2)
    pool_k, table = _random_pool(dev, spec, p, g)
    pool_p = pool_k.clone()
    table_k = table_p = table
    for step in range(3):
        args, kw = _case(dev, spec, p, 360, static, torch.bfloat16,
                         seed=10 + step, scan=scan)
        _, poses, a0, dist, valid, present = args[:6]
        lo = torch.tensor([spec.position_x, spec.position_y], device=dev)
        span = torch.tensor([spec.width, spec.height], device=dev)
        poses[:, :2] = lo + span * torch.rand(p, 2, generator=g, device=dev)
        poses[0, 1] = spec.position_y + 0.01
        poses[1, 1] = spec.position_y + spec.height - 0.01
        if scan == "far":
            _edge_poses(poses, spec)
        anc = torch.sort(torch.randint(0, p, (p,), generator=g, device=dev,
                                       dtype=torch.int32))[0]
        rest = (poses, a0, dist, valid, present, spec, 360, 1.0)
        dense = tiles.materialize(pool_k, table_k, spec).contiguous()
        g_d, l_d = fused.fused_update(dense, *rest, ancestors=anc,
                                      dphi=kw["dphi"])
        # K1 is K3 wherever both windows start on the same row: always
        # within the range, and past it (far) off the top edge, where the
        # tiled origin clips into the band padding
        same = fused.prepare(spec.rows, dense.shape[2], *rest[:5], spec, 360,
                             1.0, kw["dphi"]).r0 == tiles.plan_step(
            pool_k, table_k, *rest, dphi=kw["dphi"], ancestors=anc).prep.r0
        if scan == "within":
            same[:] = True
        before = tiles.fused_update_tiled.launches
        _, table_k, l_k = tiles.fused_update_tiled(
            pool_k, table_k, *rest, dphi=kw["dphi"], ancestors=anc)
        torch.cuda.synchronize()
        assert tiles.fused_update_tiled.launches == before + 1
        step_p = tiles.plan_step(pool_p, table_p, *rest, dphi=kw["dphi"],
                                 ancestors=anc)
        l_p = tiles.fused_update_tiled_reference(
            pool_p, step_p.src, step_p.dst, step_p.woff, step_p.prep, spec,
            360)
        table_p = step_p.new_table
        assert torch.equal(table_k, table_p)
        m_k = tiles.materialize(pool_k, table_k, spec)
        assert _max_diff(m_k, tiles.materialize(pool_p, table_p, spec)) == 0
        torch.testing.assert_close(l_k, l_p, rtol=1e-5, atol=1e-4)
        assert torch.equal(m_k[same], g_d[same])
        assert torch.equal(l_k[same], l_d[same])
        assert not m_k[:, :, spec.cols:].any()


def test_new_wrappers_check_inputs(dev):
    spec = TILED_SPECS["2band"]
    pool, table = tiles.init_tiled(8, spec, 1.0, device=dev)
    poses = torch.zeros(8, 3, device=dev)
    scan = (0.0, torch.ones(360, device=dev),
            torch.ones(360, dtype=torch.bool, device=dev),
            torch.ones(360, dtype=torch.bool, device=dev), spec, 360, 1.0)
    with pytest.raises(TypeError):
        tiles.fused_update_tiled(pool.half(), table, poses, *scan)
    with pytest.raises(ValueError, match="table"):
        tiles.fused_update_tiled(pool, table.long(), poses, *scan)
    with pytest.raises(ValueError, match="poses"):
        tiles.fused_update_tiled(pool, table, poses[:4], *scan)
    grids = torch.zeros(8, 80, 128, device=dev)
    src, dst, n = cow.cow_plan(torch.arange(8, dtype=torch.int32, device=dev))
    with pytest.raises(ValueError, match="src"):
        cow.cow_copy(grids, src.long(), dst, n)
    with pytest.raises(ValueError, match="n_copies"):
        cow.cow_copy(grids, src, dst, n.long())
    with pytest.raises(ValueError, match="on cpu"):
        cow.cow_copy(grids, src.cpu(), dst, n)


def _nn_inputs(dev, case):
    """chip_smoke.py's K4 input sets, smaller where they were large."""
    g = torch.Generator(device=dev).manual_seed(3)
    if case == "bench":
        ang = torch.linspace(0, 2 * math.pi, 361, device=dev)[:360]
        r = 0.5 + 0.5 * torch.rand(360, 1, generator=g, device=dev)
        q = (torch.stack([torch.cos(ang), torch.sin(ang)], -1) * r)
        q = q.expand(64, 360, 2).contiguous()
        p = (q + (torch.rand(64, 1, 2, generator=g, device=dev) - 0.5)
             * 0.1).contiguous()
        return p, q, torch.full((64,), 360, dtype=torch.int32, device=dev)
    if case.startswith("mapper"):
        p = torch.rand(1, 360, 2, generator=g, device=dev) * 2 - 1
        q = torch.rand(1, 16384, 2, generator=g, device=dev) * 2 - 1
        qc = int(case.split("_")[1])
        return p, q, torch.full((1,), qc, dtype=torch.int32, device=dev)
    if case == "duplicates":
        q = (torch.rand(4, 96, 2, generator=g, device=dev) * 2 - 1
             ).repeat_interleave(4, dim=1)
        p = torch.rand(4, 360, 2, generator=g, device=dev) * 2 - 1
        return p, q, torch.full((4,), 384, dtype=torch.int32, device=dev)
    if case == "ties_across_chunks":  # 512 points 32 times over
        q = (torch.rand(1, 512, 2, generator=g, device=dev) * 2 - 1
             ).repeat(1, 32, 1)
        p = torch.rand(1, 360, 2, generator=g, device=dev) * 2 - 1
        p[:, ::3] = q[:, 5:125]
        return p, q, torch.full((1,), 16384, dtype=torch.int32, device=dev)
    if case in ("negative", "signed_zero", "tiny"):
        p = torch.rand(4, 360, 2, generator=g, device=dev) * 2 - 1
        q = torch.rand(4, 1000, 2, generator=g, device=dev) * 2 - 1
        if case == "negative":  # d2 = q2 - 2 p.q below zero
            p = p * 10.0
        elif case == "tiny":  # subnormal products
            p, q = p * 1e-20, q * 1e-20
        else:  # many lanes tie at d2 = +0
            vals = torch.tensor([0.0, -0.0, 1.0, -1.0], device=dev)
            p = vals[torch.randint(0, 4, p.shape, generator=g, device=dev)]
            q = vals[torch.randint(0, 4, q.shape, generator=g, device=dev)]
        return p, q, torch.tensor([1000, 999, 37, 1], dtype=torch.int32,
                                  device=dev)
    if case.startswith("np"):  # p lanes not a multiple of 4 x 32
        n_p = int(case[2:])
        return (torch.rand(4, n_p, 2, generator=g, device=dev) * 2 - 1,
                torch.rand(4, 1000, 2, generator=g, device=dev) * 2 - 1,
                torch.tensor([1000, 500, 3, 0], dtype=torch.int32,
                             device=dev))
    far = torch.tensor([1000.0, -2000.0], device=dev)
    return (far + torch.rand(8, 360, 2, generator=g, device=dev),
            far + torch.rand(8, 4096, 2, generator=g, device=dev),
            torch.tensor([4096, 4000, 3000, 2048, 1000, 100, 7, 4096],
                         dtype=torch.int32, device=dev))


# the mapper's q split is 44 chunks of ceil(q_count / 44) lanes (at most
# 373): counts around both edges
@pytest.mark.parametrize("case", ["bench", "mapper_0", "mapper_1",
                                  "mapper_43", "mapper_44", "mapper_45",
                                  "mapper_360", "mapper_372", "mapper_373",
                                  "mapper_374", "mapper_10000",
                                  "mapper_16384", "duplicates",
                                  "ties_across_chunks", "negative",
                                  "signed_zero", "tiny", "np1", "np33",
                                  "np361", "far"])
def test_nn_argmin_matches_plain(dev, case):
    p, q, qc = _nn_inputs(dev, case)
    before = icp.nearest_neighbors_fused.launches
    got = icp.nearest_neighbors_fused(p, q, qc)
    torch.cuda.synchronize()
    assert icp.nearest_neighbors_fused.launches == before + 1
    assert got.dtype == torch.int32 and got.shape == p.shape[:2]
    assert torch.equal(got, icp.nearest_neighbors_reference(p, q, qc))
    if case == "duplicates":
        assert bool((got % 4 == 0).all())  # ties go to the first copy
    if case == "ties_across_chunks":
        assert bool((got < 512).all())
    if case == "mapper_0":
        assert not got.any()


@pytest.mark.parametrize("case", ["bench", "mapper_10000"])
def test_nn_argmin_is_one_launch(dev, case):
    """One CUDA kernel and no memset per K4 call, under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    p, q, qc = _nn_inputs(dev, case)
    if case == "bench":  # bench.py's batch of 2,048 problems
        p, q = (x[:1].expand(2048, *x.shape[1:]).contiguous() for x in (p, q))
        qc = torch.full((2048,), 360, dtype=torch.int32, device=dev)
    icp.nearest_neighbors_fused(p, q, qc)  # counters allocated once
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        icp.nearest_neighbors_fused(p, q, qc)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type.name == "CUDA"]
    assert sum(e.count for e in events) == 1, [e.key for e in events]
    assert "nn_argmin" in events[0].key


def test_nn_argmin_checks_inputs(dev):
    p, q, qc = _nn_inputs(dev, "duplicates")
    with pytest.raises(ValueError, match="q_count"):
        icp.nearest_neighbors_fused(p, q, qc.long())
    with pytest.raises(ValueError, match="contiguous f32"):
        icp.nearest_neighbors_fused(p.double(), q, qc)
    with pytest.raises(ValueError, match="on cpu"):
        icp.nearest_neighbors_fused(p, q, qc.cpu())


# the ICP solve kernel's cases: (worlds, map points, q_count per world or
# one for all, Step threshold): icp_odometry's mapper, an 8-world fleet
# with short maps, and bench.py's batch.  Every filled map spans its whole
# curve: a map of a few points or of a short arc gives normal equations
# of rank 1 or 2, whose solve (the floor 1e-8 x trace) turns the sums'
# rounding into the step, in any order of the sums
ICP_SOLVE_CASES = {
    "mapper": (1, 16384, [16384], 0.05),
    "fleet8": (8, 16384, [16384, 16000, 9000, 4096, 1000, 360, 2, 0], 0.05),
    "bench": (2048, 360, [360], None),
}


def _icp_problems(dev, case, seed=0):
    """ICP problems on the card: per world a map of ``q_count`` ordered
    points round a closed curve, its lanes past ``q_count`` far away
    (K4 and the normals must not read them), and 360 of the map's points
    seen from a pose off by up to 3 cm and 0.05 rad with 1 mm of noise,
    ~12 % of the lanes masked.  Returns ``(p, mask, q, q_count, x0,
    threshold)``."""
    worlds, n_map, counts, thr = ICP_SOLVE_CASES[case]
    g = torch.Generator().manual_seed(seed)
    qc = torch.tensor(counts * (worlds // len(counts)), dtype=torch.int32)
    filled = torch.arange(n_map)[None, :] < qc[:, None]
    ang = torch.rand(worlds, n_map, generator=g) * 2 * math.pi
    ang = torch.sort(torch.where(filled, ang, 10.0), dim=-1)[0]
    r = 0.8 + 0.15 * torch.sin(3 * ang) + 0.05 * torch.cos(7 * ang)
    q = torch.stack([r * torch.cos(ang), r * torch.sin(ang)], -1)
    q = torch.where(filled[..., None], q, 1e3)
    lanes = (torch.arange(360)[None, :] * qc.clamp_min(1)[:, None]) // 360
    p = torch.gather(q, 1, lanes[..., None].expand(-1, -1, 2))
    p = torch.where(qc[:, None, None] > 0, p, 0.5)
    off = (torch.rand(worlds, 3, generator=g) * 2 - 1) \
        * torch.tensor([0.03, 0.03, 0.05])
    c, s = torch.cos(off[:, 2]), torch.sin(off[:, 2])
    rot = torch.stack([torch.stack([c, s], -1), torch.stack([-s, c], -1)],
                      -2)
    p = (p - off[:, None, :2]) @ rot.transpose(-1, -2) \
        + torch.randn(p.shape, generator=g) * 1e-3
    mask = torch.rand(worlds, 360, generator=g) > 0.12
    x0 = torch.zeros(worlds, 3)
    return (*(t.contiguous().to(dev) for t in (p, mask, q, qc, x0)), thr)


@pytest.mark.parametrize("case", sorted(ICP_SOLVE_CASES))
def test_icp_solve_step_matches_plain(dev, case):
    """One iteration of ``icp_solve_kernel`` against its plain version on
    the same pose, source and K4 indices, both on the card: the pose
    within 1e-5 (m, rad), the source under it within 2e-5 m and chi within
    rtol 1e-5 (the kernel sums in the order cuBLAS takes for one
    unbatched problem; batched, cuBLAS may take others); then a whole 10-iteration call against the plain path on
    the CPU (its first 64 problems), the pose within the benchmark's 1e-4
    (an index K4 picks differently on a near-tie moves an intermediate
    iterate, not the fixed point)."""
    p, mask, q, qc, x0, thr = _icp_problems(dev, case)
    x0 = x0 + torch.tensor([0.01, -0.02, 0.03], device=dev)
    p_t = icp.transform_points(p, x0)
    corr = icp.nearest_neighbors(p_t, q, qc)
    want = icp.solve_step_reference(p, mask, q, qc, x0, p_t, corr, thr)
    x, got_pt, chi = x0.clone(), p_t.clone(), torch.empty(p.shape[0], 1,
                                                          device=dev)
    before = icp.icp_solve.launches
    icp.icp_solve(p, mask, q, qc, corr, x, x, got_pt, chi, 0, thr)
    torch.cuda.synchronize()
    assert icp.icp_solve.launches == before + 1
    torch.testing.assert_close(x, want[0], atol=1e-5, rtol=0)
    torch.testing.assert_close(got_pt, want[1], atol=2e-5, rtol=0)
    torch.testing.assert_close(chi[:, 0], want[2], atol=1e-9, rtol=1e-5)
    if case == "fleet8":  # q_count 2 and 0: no normals, no residual
        assert not chi[-2:].any()

    card = icp.icp_point_to_normal(p, mask, q, qc, x0, iterations=10,
                                   step_threshold=thr)
    n = min(p.shape[0], 64)  # the problems are independent
    cpu = icp.icp_point_to_normal(
        *(t[:n].cpu() for t in (p, mask, q, qc, x0)), iterations=10,
        step_threshold=thr)
    torch.testing.assert_close(card.transformation[:n].cpu(),
                               cpu.transformation, atol=1e-4, rtol=0)
    assert card.chi_values.shape == (p.shape[0], 10)
    assert bool(torch.isfinite(card.transformed_points).all())


@pytest.mark.parametrize("iterations", [1, 10])
def test_icp_solve_gives_the_references_bits_at_the_mappers_shape(
        dev, iterations):
    """At the ICP mapper's shape (one problem of 360 lanes against 16,384
    map points, Step 0.05) the kernel rounds and sums as cuBLAS computes
    the plain reference's products there (``csrc/icp_solve.cu``), so a
    call gives the pose and the source of the benchmark's plain reference
    (``h100bench/reference/icp.py``, unbatched, as ``icp.rollout``'s
    comparison runs it) bit for bit, after one iteration and after ten."""
    from h100bench.reference import icp as ref_icp

    p, mask, q, qc, x0, thr = _icp_problems(dev, "mapper", seed=5)
    x0 = x0 + torch.tensor([0.01, -0.02, 0.03], device=dev)
    ours = icp.icp_point_to_normal(p, mask, q, qc, x0, iterations=iterations,
                                   step_threshold=thr)
    pose, moved = ref_icp.icp_point_to_normal(
        p[0], mask[0], q[0], qc[0], x0[0],
        ref_icp.IcpConfig(16384, iterations, thr))
    assert torch.equal(ours.transformation[0], pose)
    assert torch.equal(ours.transformed_points[0], moved)


def test_icp_is_iterations_plus_one_solve_launches(dev):
    """A call launches ``icp_solve_kernel`` once an iteration and once
    before (the prologue) and K4 once an iteration, and nothing else of
    the ICP loop: by the wrappers' counts and by the profiler's kernel
    names."""
    from torch.profiler import ProfilerActivity, profile

    from slamrs_tpu_torch.utils import trace

    p, mask, q, qc, x0, thr = _icp_problems(dev, "mapper")
    icp.icp_point_to_normal(p, mask, q, qc, x0, iterations=7,
                            step_threshold=thr)  # K4's counters made
    torch.cuda.synchronize()
    solves, k4 = icp.icp_solve.launches, icp.nearest_neighbors_fused.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        icp.icp_point_to_normal(p, mask, q, qc, x0, iterations=7,
                                step_threshold=thr)
        torch.cuda.synchronize()
    assert icp.icp_solve.launches - solves == 8
    assert icp.nearest_neighbors_fused.launches - k4 == 7
    names = [e.key for e in prof.key_averages()
             if e.device_type.name == "CUDA" for _ in range(e.count)]
    assert sum("icp_solve_kernel" in n for n in names) == 8, names
    assert sum("nn_argmin_kernel" in n for n in names) == 7, names
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trace.device_counter("k4.pairs", dev).add_(qc.sum(), alpha=7 * 360)
        torch.cuda.synchronize()
    counter = sum(e.count for e in prof.key_averages()
                  if e.device_type.name == "CUDA")
    assert len(names) == 8 + 7 + counter, names  # and the counter's add


def test_icp_solve_is_deterministic_eager_and_replayed(dev):
    """Two eager calls and a captured call replayed twice give the same
    bits: the kernel reduces in a fixed order, with no atomics."""
    p, mask, q, qc, x0, thr = _icp_problems(dev, "fleet8", seed=3)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):  # K4's counters for this stream
        runs = [icp.icp_point_to_normal(p, mask, q, qc, x0,
                                        step_threshold=thr)
                for _ in range(2)]
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out = icp.icp_point_to_normal(p, mask, q, qc, x0, step_threshold=thr)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        runs.append(tuple(t.clone() for t in out))
    for run in runs[1:]:
        for a, b in zip(runs[0], run):
            assert torch.equal(a, b)


def test_icp_mapper_update_matches_cpu(dev):
    from slamrs_tpu_torch.models import icp_mapper
    from slamrs_tpu_torch.models.simulator import Scene, lidar_scan

    scene = Scene.build(rects=[(-1.0, -1.0, 2.0, 2.0),
                               (-0.1, -0.4, 0.5, 0.1)],
                        lines=[(-0.6, -0.4, 0.2, 0.4)], device="cpu")
    cfg = icp_mapper.IcpMapConfig(step_threshold=0.05)
    states = {d: icp_mapper.IcpMapState.init(cfg, d) for d in ("cpu", dev)}
    for k in range(3):
        pose = torch.tensor([0.02 * k, 0.01 * k, 0.05 * k])
        scan = lidar_scan(pose, scene, 1.0)
        for d in states:
            states[d], _ = icp_mapper.update(
                states[d], type(scan)(*(x.to(d) for x in scan)), cfg)
    card, cpu = states[dev], states["cpu"]
    assert int(card.count) == int(cpu.count) > 0
    torch.testing.assert_close(card.pose.cpu(), cpu.pose, atol=1e-5, rtol=0)
    torch.testing.assert_close(card.points.cpu(), cpu.points, atol=1e-5,
                               rtol=0)


def _grid_inputs(spec, p, seed):
    """Maps (~30 % nonzero), poses across the map and a 360-beam scan out
    to 1.2 m, made on the CPU."""
    g = torch.Generator().manual_seed(seed)
    grids = torch.randn(p, spec.rows, spec.cols, generator=g) * 2.0
    grids[torch.rand(grids.shape, generator=g) > 0.3] = 0.0
    lo = torch.tensor([spec.position_x + 0.2, spec.position_y + 0.2,
                       -math.pi])
    ext = torch.tensor([spec.width - 0.4, spec.height - 0.4, 2 * math.pi])
    poses = lo + ext * torch.rand(p, 3, generator=g)
    angles = 0.1 + torch.deg2rad(torch.arange(360, dtype=torch.float32))
    dist = 0.05 + 1.15 * torch.rand(360, generator=g)
    valid = torch.rand(360, generator=g) < 0.8
    present = torch.rand(360, generator=g) < 0.95
    return grids, poses, (angles, dist, valid, present)


@pytest.mark.parametrize("integrate", ["dda", "dense"])
def test_grid_integrators_match_cpu(dev, integrate):
    """The dda and dense integrators and the endpoint likelihood on the
    card against the CPU (plain PyTorch on both): maps on >= 99.9 % of
    cells within 5e-3 (cos, sin and atan2 a few ulps apart), likelihood
    rtol 1e-5 / atol 1e-4 on >= 99.9 % of particles; the DDA walk on
    identical grid coordinates and the dda scatter on the card bitwise
    reproducible."""
    from slamrs_tpu_torch.ops import grid as G

    spec = GridSpec2D(-2.0, -2.0, 4.0, 4.0, 0.05)
    grids, poses, scan = _grid_inputs(spec, 256, 3)
    if integrate == "dda":
        fn, extra = G.grid_integrate, spec.max_ray_steps(1.0)
    else:
        fn, extra = G.grid_integrate_dense, G.dense_window_for(spec, 1.0)
    on_card = (grids.to(dev), spec, poses.to(dev),
               *(t.to(dev) for t in scan))
    got = fn(*on_card, extra)
    want = fn(grids, spec, poses, *scan, extra)
    assert float(((got.cpu() - want).abs() <= 5e-3).float().mean()) >= 0.999
    assert torch.equal(got, fn(*on_card, extra))
    lik = G.grid_log_likelihood(*on_card).cpu()
    lik_cpu = G.grid_log_likelihood(grids, spec, poses, *scan)
    close = (lik - lik_cpu).abs() <= 1e-4 + 1e-5 * lik_cpu.abs()
    assert float(close.float().mean()) >= 0.999
    if integrate == "dda":
        start = spec.world_to_grid(poses[:, :2])
        ends = spec.world_to_grid(G.scan_endpoints(poses, *scan[:2]))
        ray = (start[:, 0:1], start[:, 1:2], ends[..., 0], ends[..., 1])
        args = (spec.cols, spec.rows, extra)
        for a, b in zip(G.traverse_ray(*ray, *args),
                        G.traverse_ray(*(t.to(dev) for t in ray), *args)):
            assert torch.equal(a, b.cpu())


@functools.cache
def _smoke():
    """``chip_smoke.py`` as a module."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    mod = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(mod)
    mod.loader.exec_module(smoke)
    return smoke


def _fleet_k1_case(spec, worlds, p, static, dtype, seed=0):
    """``chip_smoke.py``'s fleet inputs for K1 (per-world scans from the
    simulator, a quarter of the worlds with beams past the range, edge
    poses, block-diagonal lineage) at ``dtype``."""
    args, kw = _smoke().fleet_kernel_case(torch, spec, worlds, p, seed,
                                          static)
    return (args[0].to(dtype), *args[1:]), kw


@pytest.mark.parametrize("mode", ["lineage", "in_place"])
@pytest.mark.parametrize("static", [True, False], ids=["static", "traced"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_k1_world_axis_matches_plain(dev, mode, static, dtype):
    spec = GridSpec2D(-2.0, -2.0, 4.0, 4.0, 0.05)
    args, kw = _fleet_k1_case(spec, 8, 16, static, dtype)
    if mode == "in_place":
        kw = dict(dphi=kw["dphi"], in_place=True)
        want_g, want_l = fused.fused_update_reference(args[0].clone(),
                                                      *args[1:], **kw)
    else:
        want_g, want_l = fused.fused_update_reference(*args, **kw)
    before = fused.fused_update.launches
    got_g, got_l = fused.fused_update(*args, **kw)
    torch.cuda.synchronize()
    assert fused.fused_update.launches == before + 1  # the whole fleet
    assert _max_diff(got_g, want_g) == 0.0
    torch.testing.assert_close(got_l, want_l, rtol=1e-5, atol=1e-4)


def test_k1_one_world_is_the_single_world_call(dev):
    spec = GridSpec2D(-2.0, -2.0, 4.0, 4.0, 0.05)
    args, kw = _fleet_k1_case(spec, 1, 64, True, torch.bfloat16, seed=4)
    grids, poses, a0, dist, valid, present = args[:6]
    one = fused.fused_update(*args, **kw)
    single = fused.fused_update(grids, poses, a0[0], dist[0], valid[0],
                                present[0], *args[6:], **kw)
    assert torch.equal(one[0], single[0]) and torch.equal(one[1], single[1])


def test_cow_copy_on_a_flattened_fleet_plan(dev):
    from slamrs_tpu_torch.ops import resample

    worlds, p = 64, 10
    g = torch.Generator(device=dev).manual_seed(6)
    w = torch.softmax(torch.randn(worlds, p, generator=g, device=dev) * 3, -1)
    anc = resample.systematic_resample(
        w, torch.rand(worlds, 1, generator=g, device=dev))
    flat = (anc + p * torch.arange(worlds, dtype=torch.int32,
                                   device=dev)[:, None]).reshape(-1)
    src, dst, n = cow.cow_plan(flat)
    live = torch.arange(worlds * p, device=dev) < n
    assert torch.equal((src // p)[live], (dst // p)[live])
    grids = torch.randn(worlds * p, 200, 256, generator=g,
                        device=dev).to(torch.bfloat16)
    want = cow.cow_copy_reference(grids.clone(), src, dst, n)
    before = cow.cow_copy.launches
    got = cow.cow_copy(grids, src, dst, n)
    torch.cuda.synchronize()
    assert cow.cow_copy.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("change", [{}, {"fleet_resample": "gather"},
                                    {"fused_resident": True}],
                         ids=["cow", "gather", "deferred"])
def test_update_fleet_launches_k1_once(dev, change):
    from slamrs_tpu_torch.core.types import OdometryReading
    from slamrs_tpu_torch.models import gridslam as gs
    from slamrs_tpu_torch.models.simulator import Scene, lidar_scan

    cfg = gs.GridSlamConfig(resolution=0.05, n_particles=10,
                            integrate="fused", resample_neff_frac=1.0,
                            grid_dtype="bfloat16", **change)
    worlds = 16
    st = gs.GridSlamState.init(cfg, dev, (worlds,))
    scene = Scene.build(rects=[(-1.0, -1.0, 2.0, 2.0)], device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    odo = OdometryReading(torch.full((worlds,), 0.01, device=dev),
                          torch.full((worlds,), 0.012, device=dev), 0.1)
    for k in range(2):
        pose = torch.zeros(worlds, 3, device=dev)
        pose[:, 0] = 0.01 * k + 0.02 * torch.arange(worlds, device=dev) / 16
        scan = lidar_scan(pose, scene, 1.0, 360)
        k1, k2 = fused.fused_update.launches, cow.cow_copy.launches
        st, out = gs.update_fleet(st, scan, odo, cfg, generator=gen)
        torch.cuda.synchronize()
        assert fused.fused_update.launches == k1 + 1
        assert cow.cow_copy.launches == k2 + int(not change)
    assert bool(torch.isfinite(out.pose).all())
    torch.testing.assert_close(st.weights.sum(-1),
                               torch.ones(worlds, device=dev))


# mesh -> (particle axis, fleet_resample, worlds, tiled)
MESH_CASES = {"gather_2x4": (4, "gather", 4, False),
              "local_2x4": (4, "local", 4, False),
              "cow_8x1": (1, "local", 8, False),
              "tiled_2x1": (1, "local", 2, True)}


@pytest.mark.parametrize("case", list(MESH_CASES))
def test_sharded_fleet_rollout_on_the_card(dev, case):
    """A fleet on an 8-entry mesh of the one card against the one-device
    fleet under the same seed, 40 ticks (six scan frames): ``"gather"``,
    the world-only copy on write and the tiled loop bitwise, ``"local"``
    the same per-world multiset after its first frame; K1 once per
    block a frame (once per world shard on the copy-on-write route, K2
    at most as often), K3 once per world a frame."""
    from slamrs_tpu_torch.graph.compile import make_fused
    from slamrs_tpu_torch.models.gridslam import GridSlamConfig
    from slamrs_tpu_torch.parallel import fleet

    axis, mode, worlds, tiled = MESH_CASES[case]
    kw = dict(resolution=0.05, n_particles=8, integrate="fused",
              grid_dtype="bfloat16", resample_neff_frac=1.0,
              fleet_resample=mode)
    if tiled:
        kw.update(position_x=-3.2, position_y=-6.4, width=6.4, height=12.8,
                  resample_cow="tiled")
    mesh = fleet.make_mesh(8 if not tiled else 2, particle_axis=axis,
                           devices=[dev] * 8)
    plain = make_fused(grid_config=GridSlamConfig(**kw), device=dev)
    sharded = make_fused(grid_config=GridSlamConfig(**kw), device=dev,
                         mesh=mesh)
    ticks = 8 if case == "local_2x4" else 40
    s0, o0 = plain.rollout_cadence(plain.init((worlds,)), ticks, seed=4)
    counts = (fused.fused_update.launches, cow.cow_copy.launches,
              tiles.fused_update_tiled.launches)
    s1, o1 = sharded.rollout_cadence(plain.init((worlds,)), ticks, seed=4)
    torch.cuda.synchronize()
    k1, k2, k3 = (now - before for now, before in zip(
        (fused.fused_update.launches, cow.cow_copy.launches,
         tiles.fused_update_tiled.launches), counts))
    frames = int(o1.fired.shape[0])
    blocks = mesh.devices.size
    whole = fleet.unshard_world_state(s1)
    if tiled:
        assert (k1, k2, k3) == (0, 0, worlds * frames)
    elif case == "cow_8x1":
        assert k1 == blocks * frames and k2 <= blocks * frames
    else:
        assert (k1, k2) == (blocks * frames, 0)
    if case == "local_2x4":
        for w in range(worlds):
            a = torch.cat([whole.grid.poses[w].flatten(1), whole.grid.grids[w]
                           .float().flatten(1)], 1).cpu().numpy()
            b = torch.cat([s0.grid.poses[w].flatten(1), s0.grid.grids[w]
                           .float().flatten(1)], 1).cpu().numpy()
            assert sorted(map(bytes, a)) == sorted(map(bytes, b))
        return
    for x, y in zip(fleet.tree_leaves(whole), fleet.tree_leaves(s0)):
        assert torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
    assert torch.equal(o1.grid_pose, o0.grid_pose)


def test_resample_fleet_card_equals_cpu(dev):
    """The local-first relabel and its overflow fallback on a 2 x 4 mesh of
    the card, slot for slot the same on the CPU."""
    from slamrs_tpu_torch.ops import resample
    from slamrs_tpu_torch.parallel import fleet
    from slamrs_tpu_torch.parallel import resample as pres

    g = torch.Generator().manual_seed(2)
    grids = torch.randn(2, 64, 8, 128, generator=g)
    poses = torch.randn(2, 64, 3, generator=g)
    anc = resample.systematic_resample(
        torch.softmax(torch.randn(2, 64, generator=g) * 2, -1),
        torch.rand(2, 1, generator=g))
    wp = fleet.WORLD_PARTICLE
    for cap in (8, 1):
        out = []
        for d in (torch.device("cpu"), dev):
            mesh = fleet.make_mesh(8, particle_axis=4, devices=[d] * 8)
            got = pres.resample_fleet(
                fleet.Sharded.place(grids.to(d), mesh, wp),
                fleet.Sharded.place(poses.to(d), mesh, wp), anc.to(d), mesh,
                spill_cap=cap)
            out.append([x.full().cpu() for x in got])
        for a, b in zip(*out):
            assert torch.equal(a, b)


def _preset(name, particles=None):
    text = (Path(__file__).resolve().parents[1] / "configs" / name)\
        .read_text()
    if particles is not None:
        text = text.replace("n_particles: 1024", f"n_particles: {particles}")
    return text


def test_app_launch_counts(dev):
    """Host mode: K1 once per SLAM update of ``grid_slam_fused.yaml``
    (lineage mode, K2-K4 never), K4 ten times per ICP update of
    ``icp_test.yaml``."""
    from slamrs_tpu_torch.graph.app import App
    from slamrs_tpu_torch.graph.nodes.slam import (GridMapSlamNode,
                                                   IcpPointMapperNode)

    app = App.from_yaml(_preset("grid_slam_fused.yaml", 64), device=dev)
    counters = [(fused.fused_update, "launches"),
                (fused.fused_update, "in_place_launches"),
                (cow.cow_copy, "launches"),
                (tiles.fused_update_tiled, "launches"),
                (icp.nearest_neighbors_fused, "launches")]
    for fn, attr in counters:
        setattr(fn, attr, 0)
    app.run(frames=30)
    node = app.node(GridMapSlamNode)
    assert node.updates >= 4
    assert [getattr(fn, attr) for fn, attr in counters] == \
        [node.updates, 0, 0, 0, 0]

    app = App.from_yaml(_preset("icp_test.yaml"), device=dev)
    icp.nearest_neighbors_fused.launches = 0
    app.run(frames=30)
    node = app.node(IcpPointMapperNode)
    assert node.updates >= 4
    assert icp.nearest_neighbors_fused.launches == 10 * node.updates


def test_app_update_matches_cpu(dev):
    """``grid_slam_fused.yaml`` at 16 particles through the App on the
    card and on the CPU under the same numpy draws: ground truth within
    1e-5 m, the published best poses within 0.04 m RMSE (the card's
    cos, sin and atan2 are a few ulps from the CPU's)."""
    import numpy as np

    from slamrs_tpu_torch.graph.app import App
    from slamrs_tpu_torch.graph.nodes.sim import SimulatorNode
    from slamrs_tpu_torch.graph.nodes.slam import GridMapSlamNode
    from slamrs_tpu_torch.models.gridslam import UpdateNoise

    rng = np.random.default_rng(4)
    draws = [(rng.standard_normal(16).astype(np.float32),
              rng.standard_normal(16).astype(np.float32),
              rng.random(1).astype(np.float32)) for _ in range(8)]
    runs = []
    for device in (dev, torch.device("cpu")):
        app = App.from_yaml(_preset("grid_slam_fused.yaml", 16),
                            device=device)
        node = app.node(GridMapSlamNode)
        node.noise_for_update = lambda i, d=device: UpdateNoise(
            *(torch.from_numpy(x).to(d) for x in draws[i]))
        sub = app.pubsub.subscribe("robot/pose")
        app.run(frames=45)
        runs.append((app.node(SimulatorNode).get_pose(),
                     np.array([m.pose for m in sub.drain()])))
    (truth_card, card), (truth_cpu, cpu) = runs
    np.testing.assert_allclose(truth_card, truth_cpu, atol=1e-5, rtol=0)
    assert card.shape == cpu.shape == (7, 3)
    assert np.sqrt(((card - cpu)[:, :2] ** 2).mean()) <= 0.04


ROBOT_RECTS = [(-2.0, -2.0, 4.0, 4.0), (-0.1, -0.4, 0.5, 0.1)]
ROBOT_LINES = [(-0.6, -0.4, 0.2, 0.4)]


def _robot_frames(device, seconds, start=(-1.0, -1.2, 0.0)):
    """The port's virtual robot on ``device`` in ``cmd_robot``'s scene,
    driven forward with every revolution sent: its ScanFrames."""
    import numpy as np

    from slamrs_tpu_torch.io import message as msg
    from slamrs_tpu_torch.io.virtual_robot import VirtualRobot
    from slamrs_tpu_torch.models.simulator import Scene

    robot = VirtualRobot(scene=Scene.build(rects=ROBOT_RECTS,
                                           lines=ROBOT_LINES),
                         scanner_range=5.0, device=device)
    robot.pose = np.array(start)
    robot.connect()
    for m in (msg.CommandMessage.neato_on(),
              msg.CommandMessage.set_downsampling(0),
              msg.CommandMessage.drive(0.10, 0.12)):
        robot.handle_command(m)
    for _ in range(int(round(seconds / 0.05))):
        robot.step(0.05)
    return [msg.RobotMessage.decode(raw)[0].scan_frame
            for raw in robot.outbox if raw[:1] == b"\x00"]


def test_virtual_robot_card_scan_within_1mm_of_cpu(dev):
    """The same drive on a card robot and a CPU robot: odometry and rpm
    bitwise, valid masks equal, distances within 1 mm on fewer than 1e-3
    of the beams."""
    import numpy as np

    from slamrs_tpu_torch.io.neato import parse_frame

    card, cpu = _robot_frames(dev, 6.05), _robot_frames("cpu", 6.05)
    assert len(card) == len(cpu) == 30
    beams = off = 0
    for a, b in zip(card, cpu):
        assert (a.odometry, a.rpm) == (b.odometry, b.rpm)
        fa, fb = parse_frame(a.scan_data), parse_frame(b.scan_data)
        assert np.array_equal(fa.valid, fb.valid)
        d = np.abs(fa.distance.astype(int) - fb.distance.astype(int))
        assert d.max() <= 1
        beams += d.size
        off += int((d > 0).sum())
    assert off < 1e-3 * beams


def _replay_app(dev, tmp_path, seconds):
    frames = _robot_frames("cpu", seconds)
    path = tmp_path / "robot.bin"
    path.write_bytes(b"".join(f.scan_data for f in frames))
    from slamrs_tpu_torch.graph.app import App

    text = _preset("neato_replay.yaml").replace("path: null",
                                                f"path: {path}")
    return App.from_yaml(text, device=dev), len(frames)


def test_file_loader_scan_is_on_the_card(dev, tmp_path):
    from slamrs_tpu_torch.graph.nodes.robot import FileLoaderNode

    app, revs = _replay_app(dev, tmp_path, 2.05)
    sub = app.pubsub.subscribe("robot/observation")
    app.frame()
    scan = sub.latest()
    assert app.node(FileLoaderNode).frames and revs == 10
    for t in scan:
        assert t.device.type == "cuda" and t.shape == (360,)
    assert scan.valid.dtype == torch.bool
    assert int(scan.valid.sum()) > 300


def test_replay_launches_k4_ten_times_an_update(dev, tmp_path):
    from slamrs_tpu_torch.graph.nodes.robot import FileLoaderNode
    from slamrs_tpu_torch.graph.nodes.slam import IcpPointMapperNode

    app, revs = _replay_app(dev, tmp_path, 2.05)
    loader, node = app.node(FileLoaderNode), app.node(IcpPointMapperNode)
    icp.nearest_neighbors_fused.launches = 0
    fused.fused_update.launches = 0
    while not loader.done:
        app.frame()
    app.run(frames=2)
    assert node.updates == revs - 1 == 9
    assert icp.nearest_neighbors_fused.launches == 10 * node.updates
    assert fused.fused_update.launches == 0


def _app_run(dev, text, frames, capture_, draws=None, log=None):
    """An App on the card, captured or op by op, for ``frames`` frames
    (a replay: until its loader is done, and two more); ``draws`` (numpy
    grid draws, [updates, ...] each) go through the grid node's seam.
    Returns the app, every message of its topics as tensors or arrays,
    and the launch counts of the run."""
    import numpy as np

    from slamrs_tpu_torch.graph import capture
    from slamrs_tpu_torch.graph.app import App
    from slamrs_tpu_torch.graph.nodes.robot import FileLoaderNode
    from slamrs_tpu_torch.graph.nodes.slam import GridMapSlamNode
    from slamrs_tpu_torch.models.gridslam import UpdateNoise

    app = App.from_yaml(text, device=dev, capture=capture_)
    grid = app.node(GridMapSlamNode)
    if draws is not None and grid is not None:
        on_card = [torch.from_numpy(x).to(dev) for x in draws]
        grid.noise_for_update = lambda i: UpdateNoise(
            *(x[i] for x in on_card))
    subs = {t: app.pubsub.subscribe(t) for t in
            ("robot/pose", "slam/pose", "slam/map",
             "robot/observation_odometry", "robot/observation")}
    before = capture.launch_counts()
    loader = app.node(FileLoaderNode)
    if loader is not None:
        while not loader.done:
            app.frame()
        frames = 2
    app.run(frames=frames)
    torch.cuda.synchronize()
    after = capture.launch_counts()
    msgs = {}
    for t, s in subs.items():
        got = []
        for m in s.drain():
            for name in ("pose", "data", "points", "means", "covariances",
                         "seen", "scan", "landmarks", "odometry"):
                v = getattr(m, name, None)
                if v is not None:
                    got += [np.asarray(x.cpu() if torch.is_tensor(x) else x)
                            for x in (v if isinstance(v, tuple) else (v,))]
        msgs[t] = got
    return app, msgs, {k: after[k] - before[k] for k in after}


def _same_app_runs(a, b):
    import numpy as np

    from slamrs_tpu_torch.graph import capture

    (app_a, msgs_a, counts_a), (app_b, msgs_b, counts_b) = a, b
    assert counts_a == counts_b
    for t in msgs_a:
        assert len(msgs_a[t]) == len(msgs_b[t]), t
        for x, y in zip(msgs_a[t], msgs_b[t]):
            np.testing.assert_array_equal(x, y)
    for na, nb in zip(app_a.nodes, app_b.nodes):
        if isinstance(getattr(na, "state", None), tuple):
            for x, y in zip(capture._tensor_leaves(na.state),
                            capture._tensor_leaves(nb.state)):
                assert torch.equal(x, y)


# preset, particles, frames (each SLAM node updates and replays)
APP_CASES = [("grid_slam.yaml", None, 200), ("grid_slam_fused.yaml", 64, 60),
             ("icp_test.yaml", None, 60), ("landmarks.yaml", None, 60)]


@pytest.mark.parametrize("draws", ["seed", "injected"])
@pytest.mark.parametrize("name,particles,frames", APP_CASES)
def test_app_captured_equals_op_by_op(dev, name, particles, frames, draws):
    """The App's node programs as CUDA graphs against the op-by-op App on
    the card: every message, every node state and every launch count
    bitwise, every programmed node replaying its graphs."""
    import numpy as np

    text = _preset(name, particles)
    noise = None
    if draws == "injected" and "GridMapSlam" in text:
        p = particles or 10
        rng = np.random.default_rng(3)
        noise = (rng.standard_normal((frames, p), np.float32),
                 rng.standard_normal((frames, p), np.float32),
                 rng.random((frames, 1), np.float32))
    eager = _app_run(dev, text, frames, False, noise)
    captured = _app_run(dev, text, frames, True, noise)
    _same_app_runs(eager, captured)
    stats = captured[0].program_stats()
    assert eager[0].program_stats() == {} and "SimulatorNode" in stats
    for node, s in stats.items():
        assert s.graphs >= 1 and s.replays >= 1, node
        assert s.eager == s.graphs  # the first call of each graph


def test_replay_captured_equals_op_by_op(dev, tmp_path):
    frames = _robot_frames("cpu", 2.05)
    path = tmp_path / "log.bin"
    path.write_bytes(b"".join(f.scan_data for f in frames))
    yaml = _preset("neato_replay.yaml").replace("path: null",
                                                f"path: {path}")
    eager = _app_run(dev, yaml, 0, False)
    captured = _app_run(dev, yaml, 0, True)
    _same_app_runs(eager, captured)
    s = captured[0].program_stats()["IcpPointMapperNode"]
    assert (s.eager, s.replays) == (1, 8)
    assert captured[2]["nn_argmin"] == 10 * 9


def test_two_firing_ticks_in_one_frame_on_the_card(dev):
    """Two replays of the firing graph in one ``advance``: two messages,
    each with its own scan."""
    from slamrs_tpu_torch.core.types import Command
    from slamrs_tpu_torch.graph import capture
    from slamrs_tpu_torch.graph.nodes.sim import SimulatorNodeConfig
    from slamrs_tpu_torch.graph.pubsub import PubSub

    ps = PubSub()
    node = SimulatorNodeConfig(
        topic_command="cmd", topic_observation_scanner="scan",
        scene=[("Line", {"x1": -2.0, "y1": -2.0, "x2": 2.0, "y2": -2.0})],
        parameters={"update_period": 0.0, "scanner_range": 5.0},
    ).instantiate(ps, dev)
    node.use_programs(graphs=True)
    sub = ps.subscribe("scan")
    ps.publish("cmd", Command).publish(Command.make(0.3, 0.2, device=dev))
    ps.tick()
    with capture.on_capture_stream(dev):
        node.advance(4 * node.dt + 1e-6)  # eager, then three replays
    ps.tick()
    msgs = sub.drain()
    torch.cuda.synchronize()
    assert len(msgs) == 4 and node.program.stats.replays == 3
    d = [m.scan.distances for m in msgs]
    assert len({x.data_ptr() for x in d}) == 4
    assert all(not torch.equal(a, b) for a, b in zip(d, d[1:]))


def test_robot_process_exits_0_at_sigint_on_the_card(dev):
    """``python -m slamrs_tpu_torch robot`` with its lidar on the card: two
    hosts connect, take lidar frames and close; at SIGINT the process ends
    with exit code 0 (it once aborted with -6 there)."""
    from torch_robot_process import connect_close_sigint

    code, lines = connect_close_sigint("cuda", cycles=2, limit_s=120.0)
    assert code == 0, lines


# ---- sharded frames and the tick rollout as CUDA graphs -------------------


def _split_keys(stats) -> list:
    """The graph keys of runs cut at the overflow read: ``(key, part)``."""
    return [k for k in stats.launches
            if isinstance(k, tuple) and k[1] in ("head", "tail", "row")]


def _run_counted(fn):
    """``fn()`` with the device synchronized after; returns its result and
    the wrappers' launches it made."""
    from slamrs_tpu_torch.graph import capture

    before = capture.launch_counts()
    out = fn()
    torch.cuda.synchronize()
    after = capture.launch_counts()
    return out, {k: after[k] - before[k] for k in after}


@pytest.mark.parametrize("draws", ["seed", "injected"])
@pytest.mark.parametrize("route", ["world_only_cow_8x1", "gather_2x4",
                                   "local_2x4", "local_2x4_overflow",
                                   "tiled_2x1", "dda_4x2", "icp_4x1",
                                   "ekf_4x1"])
def test_mesh_captured_equals_eager_on_the_card(route, draws, dev,
                                                monkeypatch):
    """A mesh whose entries are all the card, ``capture=True`` against the
    eager mesh loop: state and outputs bitwise, the same launches; the
    local relabel reads its overflow flags once a frame."""
    from test_torch_capture import _trailing
    from test_torch_mesh_capture import (MESH_ROUTES, _assert_same_run,
                                         _draws, _mesh, _Reads, _spill_cap,
                                         _world)

    kind, grid, n, axis, w, cap = MESH_ROUTES[route]
    _spill_cap(monkeypatch, cap)
    fw = _world(kind, grid, _mesh(n, axis, dev), dev)
    ticks = 90
    kw = _draws(fw, (w,), ticks, 5) if draws == "injected" else {}
    eager, eager_counts = _run_counted(lambda: fw.rollout_cadence(
        fw.init((w,)), ticks, seed=3, capture=False, **kw))
    reads = _Reads(monkeypatch)
    captured, counts = _run_counted(lambda: fw.rollout_cadence(
        fw.init((w,)), ticks, seed=3, capture=True, **kw))
    _assert_same_run(eager, captured)
    assert counts == eager_counts
    stats = fw.capture_stats
    frames = int(eager[1].fired.shape[0])
    assert stats.replays >= 1 and stats.replays + stats.eager \
        == frames + _trailing(fw, ticks, 0.0)
    split = _split_keys(stats)
    assert reads.reads == (frames if "local" in route else 0)
    assert bool(split) == ("local" in route)


@pytest.mark.parametrize("draws", ["seed", "injected"])
@pytest.mark.parametrize("route", ["fused", "dda", "icp", "ekf", "local_2x4"])
def test_tick_capture_equals_eager_on_the_card(route, draws, dev):
    """``FusedWorld.rollout(capture=True)`` (an idle and a scan graph)
    against the eager tick loop, bitwise, the same launches."""
    from test_torch_mesh_capture import (TICK_ROUTES, _assert_same_run,
                                         _draws, _mesh, _world)

    kind, grid, mesh, worlds = TICK_ROUTES[route]
    fw = _world(kind, grid, None if mesh is None else _mesh(*mesh, dev), dev)
    ticks = 120 if kind == "dda_yaml" else 60
    kw = _draws(fw, worlds, ticks, 8) if draws == "injected" else {}
    eager, eager_counts = _run_counted(lambda: fw.rollout(
        fw.init(worlds), ticks, seed=2, capture=False, **kw))
    captured, counts = _run_counted(lambda: fw.rollout(
        fw.init(worlds), ticks, seed=2, capture=True, **kw))
    _assert_same_run(eager, captured)
    assert counts == eager_counts
    stats = fw.capture_stats
    # a "local" mesh's scan tick is cut at its overflow read: (key, part)
    assert {k[1] if k[0] == "tick" else k[0][1] for k in stats.launches} \
        == {"idle", "scan"}
    assert stats.replays + stats.eager == ticks and stats.replays > 0


# ---- the frame program kept across rollout calls --------------------------


def _kept_calls(fw, fresh, worlds, ticks, injected, seeds,
                method="rollout_cadence"):
    """Carried ``method`` calls on ``fw`` (its kept program), each held
    bitwise to ``fresh`` (a world whose program is built anew every call)
    run on a copy of the same input state with the same seed and draws.
    Yields each call's ``CaptureStats``, whether it ran on the kept
    program, and its runs: its frames (or ticks) and the trailing idle
    ticks' one run."""
    from slamrs_tpu_torch.graph import capture
    from slamrs_tpu_torch.utils import trace
    from test_torch_capture import _assert_same_run, _draws, _trailing

    state = fw.init(worlds)
    frames = ticks if method == "rollout" else capture._frames_max(fw, ticks)
    for seed in seeds:
        kw = (_draws(fw, worlds, ticks, 30 + seed, frames=frames)
              if injected else {})
        given = capture._map_tensors(lambda x: x.clone(), state)
        trailing = (0 if method == "rollout"
                    else _trailing(fw, ticks, state.scan_timer))
        state, out = getattr(fw, method)(state, ticks, seed=seed, **kw)
        reused = trace.calls()[-1]["counts"].get(capture.REUSED) == 1
        stats = fw.capture_stats
        _assert_same_run(getattr(fresh, method)(given, ticks, seed=seed, **kw),
                         (state, out))
        assert fresh.capture_stats.eager >= 1  # the lead on a new program
        yield stats, reused, stats.frames + trailing


@pytest.mark.parametrize("draws", ["seed", "injected"])
@pytest.mark.parametrize("route", ["lineage", "tiled", "cow", "gather",
                                   "dense", "dda", "icp_ekf", "fleet"])
def test_kept_frame_program_replays_every_frame_on_the_card(route, draws,
                                                             dev):
    """From the second carried call on, every frame and trailing tick is
    a replay (no eager run, no capture), and each call gives the bits of
    a fresh program on the same input state and seed, seeded draws
    included (the kept generator re-seeded)."""
    from test_torch_capture import _ticks, _world

    fw, worlds = _world(route, dev)
    fresh, _ = _world(route, dev)
    calls = _kept_calls(fw, fresh, worlds, _ticks(route, card=True),
                        draws == "injected", (3, 8, 5, 1))
    for call, (stats, reused, runs) in enumerate(calls):
        assert reused == (call > 0)
        assert stats.replays + stats.eager == runs
        if call >= 2:
            assert stats.eager == 0 and stats.capture_seconds == 0
            assert stats.replays == runs and stats.ticks is None


@pytest.mark.parametrize("draws", ["seed", "injected"])
def test_kept_local_mesh_program_replays_on_the_card(draws, dev,
                                                     monkeypatch):
    """The same on a one-card ``"local"`` 2 x 4 mesh, whose frames are cut
    at the overflow read (a head, each row's branch, a tail): the row
    graphs are kept with the program; a later call captures only a
    branch no earlier call took."""
    from test_torch_mesh_capture import MESH_ROUTES, _mesh, _world

    kind, grid, n, axis, w, _ = MESH_ROUTES["local_2x4"]
    fw = _world(kind, grid, _mesh(n, axis, dev), dev)
    fresh = _world(kind, grid, _mesh(n, axis, dev), dev)
    graphs = 0
    calls = _kept_calls(fw, fresh, (w,), 90, draws == "injected",
                        (3, 8, 5, 1))
    for call, (stats, reused, runs) in enumerate(calls):
        assert reused == (call > 0)
        assert _split_keys(stats)
        if call >= 2:
            assert stats.eager == 0 and stats.replays == runs
            assert (stats.capture_seconds == 0) \
                == (len(stats.launches) == graphs)
        graphs = len(stats.launches)


@pytest.mark.parametrize("draws", ["seed", "injected"])
@pytest.mark.parametrize("route", ["fused", "dda", "icp", "ekf", "local_2x4"])
def test_kept_tick_program_replays_every_tick_on_the_card(route, draws, dev):
    """The tick rollout keeps its program as the cadence rollout does:
    from the second carried call on, every tick is a replay (no eager
    tick, no capture), each call the bits of a fresh program on the same
    input state and seed."""
    from test_torch_mesh_capture import TICK_ROUTES, _mesh, _world

    kind, grid, mesh, worlds = TICK_ROUTES[route]
    fw, fresh = (_world(kind, grid, None if mesh is None
                        else _mesh(*mesh, dev), dev) for _ in range(2))
    ticks = 120 if kind == "dda_yaml" else 60
    calls = _kept_calls(fw, fresh, worlds, ticks, draws == "injected",
                        (3, 8, 5), method="rollout")
    for call, (stats, reused, runs) in enumerate(calls):
        assert reused == (call > 0)
        assert stats.replays + stats.eager == runs == ticks
        if call >= 1:
            assert stats.eager == 0 and stats.capture_seconds == 0


@pytest.mark.parametrize("route", ["fused", "icp", "ekf", "local_2x4"])
def test_cadence_and_tick_calls_share_the_kept_program_on_the_card(route,
                                                                    dev):
    """Cadence, tick and cadence calls on one carried state, captured:
    each the bits of the eager loops continued; the last cadence call
    runs on the program the tick call built."""
    from test_torch_mesh_capture import (TICK_ROUTES, _interleaved, _mesh,
                                         _world)

    kind, grid, mesh, worlds = TICK_ROUTES[route]
    fw = _world(kind, grid, None if mesh is None else _mesh(*mesh, dev), dev)

    def run(method, state, ticks, seed):
        return getattr(fw, method)(state, ticks, seed=seed, capture=True)

    assert _interleaved(fw, worlds, 60, run) == [False, False, True]


def test_kept_fleet_program_holds_its_memory_on_the_card(dev):
    """Five carried fleet calls reach no higher a peak of allocated
    memory than the first alone."""
    from test_torch_capture import _world

    fw, worlds = _world("fleet", dev)
    state = fw.init(worlds)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    peaks = []
    for seed in range(5):
        state, out = fw.rollout_cadence(state, 90, seed=seed)
        del out
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated(dev))
    assert peaks[-1] <= peaks[0], peaks


# --- the simulator kernel (csrc/sim_frame.cu) against its plain version ---

@pytest.mark.parametrize("scan", [False, True], ids=["motion", "scan"])
@pytest.mark.parametrize("k", [0, 1, 5])
@pytest.mark.parametrize("worlds", [None, 256], ids=["one", "fleet256"])
@pytest.mark.parametrize("preset", _smoke().SIM_PRESETS)
def test_sim_frame_matches_plain_bitwise(dev, preset, worlds, k, scan):
    """``sim_frame_kernel`` against ``sim_frame_reference`` on the card:
    every output bit for bit (pose, accumulators, distances, strengths,
    valid, present, the beam table), one launch a call; one world at each
    of ``chip_smoke.py``'s edge poses, standing still (a beam along a
    wall, beams through segment ends, hits past the range, poses outside
    the room) and at a random pose, moving, or 256 worlds holding them and
    random poses, moving; ``k`` idle ticks before the last."""
    smoke = _smoke()
    fw = smoke.preset_world(torch, preset)
    reps = len(smoke.SIM_EDGE_POSES) + 1 if worlds is None else 1
    for seed in range(reps):
        pose, al, ar, speeds = smoke.sim_frame_case(torch, worlds, k, seed)
        got, want = smoke.sim_frame_pair(torch, fw, pose, al, ar, speeds,
                                         scan)
        assert smoke.sim_frame_same(torch, got, want) == [], seed
        assert (got.scan is None) == (not scan)


def test_sim_frame_cos_and_sin_are_atens(dev):
    """The kernel's ``cosf``/``sinf`` (nvcc, ``--fmad=false``) give
    ``torch.cos``/``torch.sin``'s float32 bits on the card."""
    assert _smoke().sim_cos_sin_mismatches(torch) == 0


def test_sim_frame_beam_table_is_deg2rad(dev):
    """The kernel's beam angles are ``torch.deg2rad`` of the beam index,
    the product with the double pi / 180 cast to float32, bit for bit."""
    assert _smoke().sim_deg2rad_mismatches(torch) == 0


def test_sim_frame_divides_by_the_wheel_base_as_aten(dev):
    """ATen's card division of a tensor by a Python float multiplies by
    the float32 reciprocal, and the kernel's turn gives its bits."""
    assert _smoke().sim_division_mismatches(torch) == 0


def test_sim_frame_launches_once_a_frame(dev):
    """An eager cadence rollout of ``icp_test.yaml`` launches the
    simulator kernel once a scan frame and once for its trailing idle
    ticks, and a tick rollout once a tick."""
    from slamrs_tpu_torch.models import simulator

    fw = _smoke().preset_world(torch, "icp_test.yaml")
    before = simulator.sim_frame.launches
    _, outs = fw.rollout_cadence(fw.init(), 62, capture=False)
    assert outs.fired.shape[0] == 10
    assert simulator.sim_frame.launches - before == 11
    before = simulator.sim_frame.launches
    fw.rollout(fw.init(), 13, capture=False)
    assert simulator.sim_frame.launches - before == 13
