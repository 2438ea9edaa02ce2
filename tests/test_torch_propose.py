"""The proposal of one grid SLAM update (``ops/propose.py``) on the CPU.

On the CPU ``slam_propose`` runs its plain version, the motion sample,
the motion log-probability and ``ops/fused.prepare`` as ``update`` called
them before they were one launch on the card.  Gates: a single-world
fused ``update`` under every resample mechanism (deferred lineage, copy
on write, whole-set gather, tile pool), with the static and the traced
beam spacing, gives the bits of that chain written out here; K1's and
K3's wrappers given the prepared inputs give the bits of preparing them
themselves; ``update`` proposes once a fused update, and never in a
fleet update or on the dda and dense integrators; the wrapper raises off
the CPU and CUDA.  The kernel itself is held to the plain version bit for
bit on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from slamrs_tpu_torch.core import motion  # noqa: E402
from slamrs_tpu_torch.core.types import OdometryReading, Scan  # noqa: E402
from slamrs_tpu_torch.models import gridslam as gs  # noqa: E402
from slamrs_tpu_torch.ops import fused, propose, select, tiles  # noqa: E402

P = 8
MECHANISMS = {"deferred": {}, "cow": dict(resample_cow=True,
                                          fused_resident=False),
              "gather": dict(resample_cow=False, fused_resident=False),
              "tiled": dict(resample_cow="tiled")}


def _config(mechanism, static, frac=0.9, **kw):
    return gs.GridSlamConfig(
        position_x=-2.0, position_y=-2.0, width=4.0, height=4.0,
        resolution=0.05, n_particles=P, max_scan_range=1.0,
        integrate="fused", resample_neff_frac=frac, grid_dtype="bfloat16",
        beam_spacing=math.radians(1.0) if static else None,
        **MECHANISMS.get(mechanism, {}), **kw)


def _scan(g, nb=360):
    """A 1-degree scan with invalid, absent, zero and over-range beams."""
    dist = 0.1 + 1.2 * torch.rand(nb, generator=g)
    dist[::17] = 0.0
    valid = torch.rand(nb, generator=g) < 0.8
    present = torch.rand(nb, generator=g) < 0.9
    angles = torch.deg2rad(torch.arange(nb, dtype=torch.float32))
    return Scan(angles, dist, torch.ones(nb), valid, present)


def _inputs(seed, zero=False):
    g = torch.Generator().manual_seed(seed)
    odo = OdometryReading(torch.tensor(0.0 if zero else 0.011),
                          torch.tensor(0.0 if zero else 0.017), 0.1)
    noise = gs.UpdateNoise(torch.randn(P, generator=g),
                           torch.randn(P, generator=g),
                           torch.rand(1, generator=g))
    return _scan(g), odo, noise


def _spacing(scan, config):
    """``update``'s beam spacing before the proposal was one call."""
    if config.beam_spacing is not None:
        return config.beam_spacing
    return scan.angles[1] - scan.angles[0]


def _chain_update(state, scan, odo, config, noise):
    """``update`` on the fused path as it read before ``slam_propose``:
    the sample, the fused kernel's wrapper preparing its own inputs, the
    motion log-probability, then the weights and the resample."""
    mechanism = gs.resample_mechanism(config, state)
    new_poses = motion.sample(state.poses, *odo,
                              eps=(noise.eps_c, noise.eps_t))
    args = (new_poses, scan.angles[0], scan.distances, scan.valid,
            scan.present, config.grid_spec, scan.angles.shape[-1],
            config.max_scan_range)
    dphi = _spacing(scan, config)
    tile_table = None
    if mechanism == "tiled":
        grids, tile_table, log_lik = tiles.fused_update_tiled(
            state.grids, state.tile_table, *args, dphi=dphi,
            ancestors=state.ancestors)
    elif mechanism == "deferred":
        grids, log_lik = fused.fused_update(state.grids, *args, dphi=dphi,
                                            ancestors=state.ancestors)
    else:
        grids, log_lik = fused.fused_update(state.grids, *args, dphi=dphi,
                                            in_place=True)
    log_motion = motion.log_prob(state.poses, new_poses, *odo)
    weights, ancestors, best_idx, n_eff, fired = select.weigh_and_select(
        log_lik, log_motion, state.weights, config.resample_neff_frac, P,
        noise.u01)
    best_pose = new_poses.index_select(0, best_idx.reshape(1))[0]
    identity = torch.arange(P, dtype=torch.int32)
    pending = ancestors
    if mechanism == "cow":
        new_poses, grids = gs.cow_resample(grids, new_poses, ancestors)
        pending = identity
    elif mechanism == "gather":
        new_poses = new_poses[ancestors.long()]
        grids = grids.index_select(0, ancestors.long())
        pending = identity
    else:
        new_poses = new_poses[ancestors.long()]
    return gs.GridSlamState(new_poses, grids, weights, best_pose, best_idx,
                            pending, tile_table), (best_pose, n_eff, fired)


def _same(a, b):
    if a is None or b is None:
        return a is None and b is None
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
        b.view(torch.int16) if b.dtype == torch.bfloat16 else b)


@pytest.mark.parametrize("static", [True, False], ids=["static", "traced"])
@pytest.mark.parametrize("mechanism", list(MECHANISMS))
def test_update_is_the_chain_it_replaced(mechanism, static):
    """Three updates through the proposal's plain version give the bits
    of the chain it replaced, state and outputs, under ``mechanism``; the
    first from rest (zero odometry)."""
    config = _config(mechanism, static)
    state = chain = gs.GridSlamState.init(config, "cpu")
    assert gs.resample_mechanism(config, state) == mechanism
    for step in range(3):
        scan, odo, noise = _inputs(10 * step + int(static), zero=step == 0)
        chain, want = _chain_update(
            chain._replace(grids=chain.grids.clone()), scan,
            odo, config, noise)
        state, out = gs.update(state, scan, odo, config, noise=noise)
        for name in ("poses", "grids", "weights", "best_pose", "best_idx",
                     "ancestors", "tile_table"):
            assert _same(getattr(state, name), getattr(chain, name)), \
                (step, name)
        for got, exp in zip(out, want):
            assert _same(got, exp), step


@pytest.mark.parametrize("static", [True, False], ids=["static", "traced"])
def test_plain_proposal_is_sample_log_prob_and_prepare(static):
    """``slam_propose`` on the CPU returns ``motion.sample``,
    ``motion.log_prob`` and ``prepare`` at the sampled poses, for a dense
    map set's rows and a tile pool's."""
    config = _config("deferred", static)
    scan, odo, noise = _inputs(3)
    poses = torch.randn(P, 3) * 0.5
    eps = (noise.eps_c, noise.eps_t)
    new = motion.sample(poses, *odo, eps=eps)
    for rows in (80, 2 * 48):
        got = propose.slam_propose(poses, odo, eps, scan, config.grid_spec,
                                   1.0, config.beam_spacing, rows, 128)
        prep = fused.prepare(rows, 128, new, scan.angles[0], scan.distances,
                             scan.valid, scan.present, config.grid_spec, 360,
                             1.0, _spacing(scan, config))
        assert torch.equal(got.poses, new)
        assert torch.equal(got.log_motion,
                           motion.log_prob(poses, new, *odo))
        for a, b in zip(got.prep, prep):
            assert (torch.equal(a, b) if isinstance(a, torch.Tensor)
                    else a == b)


def test_one_beam_scan_takes_two_pi():
    """A one-beam scan with no static spacing is spaced 2*pi, as
    ``update`` spaced it before."""
    scan = _scan(torch.Generator().manual_seed(1), nb=1)
    sp = propose.beam_spacing(scan, None, "cpu")
    assert sp.dtype == torch.float32 and float(sp) == float(
        torch.tensor(2.0 * math.pi, dtype=torch.float32))
    assert propose.beam_spacing(scan, 0.5, "cpu") == 0.5


@pytest.mark.parametrize("static", [True, False], ids=["static", "traced"])
def test_kernels_take_the_prepared_inputs(static):
    """K1's wrapper (lineage and in place) and K3's given ``prepare``'s
    result give the bits of preparing it themselves."""
    config = _config("deferred", static)
    scan, odo, noise = _inputs(4)
    spec = config.grid_spec
    poses = motion.sample(torch.randn(P, 3) * 0.5, *odo,
                          eps=(noise.eps_c, noise.eps_t))
    args = (poses, scan.angles[0], scan.distances, scan.valid, scan.present,
            spec, 360, 1.0)
    dphi = _spacing(scan, config)
    grids = torch.randn(P, 80, 128).to(torch.bfloat16)
    prep = fused.prepare(80, 128, *args[:5], spec, 360, 1.0, dphi)
    anc = torch.randint(0, P, (P,), dtype=torch.int32)
    for kw in (dict(ancestors=anc), dict(in_place=True)):
        want = fused.fused_update(grids.clone(), *args, dphi=dphi, **kw)
        got = fused.fused_update(grids.clone(), *args, dphi=dphi, prep=prep,
                                 **kw)
        assert all(_same(a, b) for a, b in zip(got, want)), kw
    pool, table = tiles.init_tiled(P, spec, 1.0, device="cpu")
    rows = table.shape[1] * pool.shape[1]
    tprep = fused.prepare(rows, 128, *args[:5], spec, 360, 1.0, dphi)
    want = tiles.fused_update_tiled(pool.clone(), table, *args, dphi=dphi)
    got = tiles.fused_update_tiled(pool.clone(), table, *args, prep=tprep)
    assert all(_same(a, b) for a, b in zip(got, want))


class _Spy:
    def __init__(self, monkeypatch):
        self.calls = 0
        self.fn = propose.slam_propose
        monkeypatch.setattr(gs, "slam_propose", self)

    def __call__(self, *args, **kw):
        self.calls += 1
        return self.fn(*args, **kw)


def test_fused_update_proposes_once(monkeypatch):
    spy = _Spy(monkeypatch)
    for mechanism in MECHANISMS:
        config = _config(mechanism, False)
        scan, odo, noise = _inputs(5)
        before = spy.calls
        gs.update(gs.GridSlamState.init(config, "cpu"), scan, odo, config,
                  noise=noise)
        assert spy.calls - before == 1, mechanism


@pytest.mark.parametrize("route", ["dda", "dense", "fleet_deferred",
                                   "fleet_cow", "fleet_gather",
                                   "fleet_tiled"])
def test_fleets_and_other_integrators_never_propose(monkeypatch, route):
    """``update_fleet``'s fused routes over the world axis and the dda and
    dense integrators keep the plain chain: the proposal is never called.
    A tiled fleet runs ``update`` once per world, each a one-world update
    that proposes once."""
    spy = _Spy(monkeypatch)
    scan, odo, noise = _inputs(6)
    if route in ("dda", "dense"):
        config = dataclasses.replace(_config("gather", False),
                                     integrate=route, grid_dtype="float32")
        gs.update(gs.GridSlamState.init(config, "cpu"), scan, odo, config,
                  noise=noise)
    else:
        w = 2
        mechanism = route.split("_")[1]
        config = _config(mechanism, False,
                         fleet_resample="gather" if mechanism == "gather"
                         else "local")
        fleet = OdometryReading(odo.distance_left.expand(w),
                                odo.distance_right.expand(w), 0.1)
        gs.update_fleet(gs.GridSlamState.init(config, "cpu", (w,)),
                        Scan(*(x.expand(w, -1) for x in scan)), fleet,
                        config, noise=gs.UpdateNoise(
                            *(x.expand(w, -1) for x in noise)))
        if mechanism == "tiled":
            assert spy.calls == w
            return
    assert spy.calls == 0


def test_wrapper_raises_off_cpu_and_cuda():
    config = _config("deferred", True)
    scan, odo, noise = _inputs(7)
    with pytest.raises(ValueError, match="cuda or cpu"):
        propose.slam_propose(torch.zeros(P, 3, device="meta"), odo,
                             (noise.eps_c, noise.eps_t), scan,
                             config.grid_spec, 1.0, config.beam_spacing,
                             80, 128)
