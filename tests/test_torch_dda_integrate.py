"""The dda integrator's routes (``ops/grid.py``) and the two readers of
the dda integrate kernel (``csrc/dda_integrate.cu``) on the CPU.

On CPU tensors ``grid_integrate`` runs ``grid_integrate_reference``,
the ATen walk and scatter, which gives the bits of the benchmark's own
plain version (``h100bench/reference/dda.py``); on the card it launches
``dda_integrate_kernel`` or raises, and on any other device it raises.
The endpoints' grid coordinates that the kernel route and the likelihood
take without a ``torch.stack`` are the stacked ones' values.  The readers
``dda_integrate_launches_per_frame`` and
``dda_integrate_device_us_per_frame`` on fixture records, and nothing
where the kernel did not run.  The kernel itself is checked on the card
(``tests/test_torch_cuda.py -k dda``).
"""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
# one thread: ATen's CPU cos and sin round a lane by the vector or the
# scalar path, and the split between threads moves which lanes take which
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from h100bench import harness  # noqa: E402
from slamrs_tpu_torch.ops import grid as G  # noqa: E402

SPEC = G.GridSpec2D(-1.0, -1.0, 2.0, 2.0, 0.05)
STEPS = SPEC.max_ray_steps(1.0)
NAMES = ("dda_integrate_launches_per_frame",
         "dda_integrate_device_us_per_frame")
KERNEL = ("(anonymous namespace)::dda_integrate_kernel(float const*, "
          "float const*, float const*, float const*, float const*, "
          "float const*, unsigned char const*, unsigned char const*, "
          "float*, unsigned long long*, DdaIntegrateParams)")


def _inputs(seed, p=12, rows=False, reach=1.2):
    """Maps, poses over the map and past it, and a 360-beam scan ([B], or
    [P, B] rows) of beams to ``reach`` m with zero-length, invalid and
    absent beams."""
    g = torch.Generator().manual_seed(seed)
    grids = torch.randn(p, SPEC.rows, SPEC.cols, generator=g)
    poses = torch.rand(p, 3, generator=g) * torch.tensor([2.4, 2.4, 6.0]) \
        - torch.tensor([1.2, 1.2, 3.0])
    b = 360
    n = p if rows else 1
    angles = torch.deg2rad(torch.arange(b, dtype=torch.float32)).expand(n, b)
    dist = torch.rand(n, b, generator=g) * reach
    dist[:, ::13] = 0.0
    valid = torch.rand(n, b, generator=g) < 0.8
    present = torch.rand(n, b, generator=g) < 0.9
    lanes = [t.contiguous() for t in (angles, dist, valid, present)]
    return grids, poses, tuple(t if rows else t[0] for t in lanes)


@pytest.mark.parametrize("rows", [False, True], ids=["B", "PxB"])
def test_cpu_tensors_run_the_reference_with_its_bits(rows):
    """On CPU tensors ``grid_integrate`` launches no kernel and gives, bit
    for bit, the maps of ``h100bench/reference/dda.integrate`` (written
    from the Rust reference, not from the port) on beams within the
    range, and adds the lanes it scatters to ``dda.cells``."""
    from h100bench.reference import dda as ref_dda
    from h100bench.reference.fused import Spec
    from slamrs_tpu_torch.utils import trace

    grids, poses, scan = _inputs(3, rows=rows, reach=1.0)
    counter = trace.device_counter("dda.cells", "cpu")
    launches, before = G.grid_integrate.launches, int(counter)
    got = G.grid_integrate(grids, SPEC, poses, *scan, STEPS)
    want = ref_dda.integrate(grids, Spec(*dataclasses.astuple(SPEC)), poses,
                             *scan, STEPS)
    assert G.grid_integrate.launches == launches
    assert not torch.equal(got, grids)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert int(counter) > before


def test_other_devices_raise():
    """Maps on a device that is neither the CPU nor a card raise: the
    kernel runs only on CUDA tensors and the reference only on the CPU."""
    grids, poses, scan = _inputs(4)
    meta = [t.to("meta") for t in (grids, poses, *scan)]
    launches = G.grid_integrate.launches
    with pytest.raises(ValueError, match="cuda or cpu"):
        G.grid_integrate(meta[0], SPEC, meta[1], *meta[2:], STEPS)
    assert G.grid_integrate.launches == launches


@pytest.mark.parametrize("rows", [False, True], ids=["B", "PxB"])
def test_endpoint_cells_are_the_stacked_coordinates(rows):
    """``endpoint_cells`` gives ``world_to_grid(scan_endpoints(...))``'s
    bits, and the likelihood taking them the value it took from the
    stacked ones."""
    grids, poses, scan = _inputs(5, rows=rows)
    gx, gy = G.endpoint_cells(SPEC, poses, scan[0], scan[1])
    ends = SPEC.world_to_grid(G.scan_endpoints(poses, scan[0], scan[1]))
    assert torch.equal(gx.view(torch.int32), ends[..., 0].view(torch.int32))
    assert torch.equal(gy.view(torch.int32), ends[..., 1].view(torch.int32))
    lik = G.grid_log_likelihood(grids, SPEC, poses, *scan)
    inside = (ends[..., 0] >= 0.0) & (ends[..., 1] >= 0.0) \
        & (ends[..., 0] < SPEC.cols) & (ends[..., 1] < SPEC.rows)
    assert bool((scan[2] & scan[3] & inside).any())
    assert torch.isfinite(lik).all()


# --- the readers -----------------------------------------------------------

def _reader(name):
    return harness.load_module(ROOT / "h100bench" / "metrics" / f"{name}.py",
                               f"test_dda_integrate_metric_{name}")


def _record(kernels, frames=15):
    return {"trace": {"window_s": 0.02, "busy_s": 0.008, "frames": frames,
                      "kernels": kernels}}


@pytest.mark.parametrize("launches,seconds,want", [
    (15, 15 * 153e-6, (1.0, 153.0)), (30, 15 * 300e-6, (2.0, 300.0))])
def test_dda_integrate_readers_per_profiled_frame(launches, seconds, want):
    rec = _record({KERNEL: {"count": launches, "seconds": seconds},
                   "sim_frame_kernel": {"count": 15, "seconds": 15 * 6e-6},
                   "void at::native::vectorized_gather_kernel<16, long>":
                   {"count": 30, "seconds": 15 * 12e-6}})
    assert _reader(NAMES[0]).read(rec) == pytest.approx(want[0])
    assert _reader(NAMES[1]).read(rec) == pytest.approx(want[1])


@pytest.mark.parametrize("rec", [
    _record({"void (anonymous namespace)::indexing_backward_kernel_stride_1"
             "<float>(...)": {"count": 15, "seconds": 15 * 2.9e-3},
             "DeviceRadixSortOnesweepKernel": {"count": 45,
                                               "seconds": 15 * 5e-4}}),
    _record({"fused_update_kernel": {"count": 15, "seconds": 3.5e-4}}),
    _record({KERNEL: {"count": 15, "seconds": 1e-3}}, frames=0),
    {"trace": None}, {}],
    ids=["parent_tree", "fused_world", "no_frames", "untraced", "empty"])
def test_dda_integrate_readers_say_nothing_without_the_kernel(rec):
    for name in NAMES:
        assert _reader(name).read(rec) is None, name
