"""The plain reference against the port at tiny sizes on the CPU, and
whole runs of the tiny cells through the harness."""

import json

import pytest
import torch

from h100bench import compare, harness
from h100bench.reference import fused as ref_fused
from h100bench.reference import slam as ref_slam
from h100bench.reference import world as ref_world
from fixture_bench import CELLS, FIXTURES


def kernel_loop_sum(row):
    """K1's reduction spelled out thread by thread (``csrc/
    fused_common.cuh::block_likelihood``)."""
    acc = [0.0] * 256
    f = torch.float32
    for t in range(256):
        a = torch.tensor(0.0, dtype=f)
        for b in (t, t + 256):
            a = a + row[b]
        acc[t] = a
    warps = []
    for w in range(8):
        lanes = acc[32 * w:32 * w + 32]
        o = 16
        while o:
            lanes = [lanes[i] + lanes[i ^ o] for i in range(32)]
            o //= 2
        warps.append(lanes[0])
    s = torch.tensor(0.0, dtype=f)
    for v in warps:
        s = s + v
    return s


def test_kernel_order_sum_is_the_kernels_order():
    g = torch.Generator().manual_seed(3)
    terms = torch.randn(3, 512, generator=g) * 10
    terms[:, 360:] = 0.0
    got = ref_fused.kernel_order_sum(terms)
    for i in range(3):
        assert got[i].item() == kernel_loop_sum(terms[i]).item()


def _world(name):
    from slamrs_tpu_torch.graph.compile import compile_world
    from slamrs_tpu_torch.graph.config import parse_config

    text = (FIXTURES / "configs" / f"{name}.yaml").read_text()
    return (compile_world(parse_config(text), device="cpu"),
            compare.reference_world(text, {}, "cpu"))


@pytest.mark.parametrize("config,worlds", [("tiny_fused", ()),
                                           ("tiny_fleet", (3,))])
def test_updates_equal_the_ports(config, worlds):
    from slamrs_tpu_torch.core.types import OdometryReading
    from slamrs_tpu_torch.models import gridslam as gs
    from slamrs_tpu_torch.models import simulator as sim

    fw, world = _world(config)
    state = fw.init(worlds).grid
    p = fw.grid_config.n_particles
    g = torch.Generator().manual_seed(7)
    for _ in range(6):
        pose = torch.randn(*worlds, 3, generator=g) * 0.2
        al = torch.rand(worlds, generator=g) * 0.01
        ar = torch.rand(worlds, generator=g) * 0.01
        noise = gs.UpdateNoise(torch.randn(*worlds, p, generator=g),
                               torch.randn(*worlds, p, generator=g),
                               torch.rand(*worlds, 1, generator=g))
        mine = ref_slam.SlamState(*(getattr(state, n).clone()
                                    for n in ref_slam.SlamState._fields))
        scan = sim.lidar_scan(pose, fw.scene, fw.params.scanner_range, 360)
        ref_scan = ref_world.lidar_scan(pose, world)
        assert torch.equal(scan.distances, ref_scan[1])
        update = gs.update_fleet if worlds else gs.update
        state, out = update(state, scan,
                            OdometryReading(al, ar, fw.params.wheel_base),
                            fw.grid_config, noise=noise)
        ref_update = ref_slam.update_fleet if worlds else ref_slam.update
        mine, ref_out = ref_update(mine, ref_scan, (al, ar, world.wheel_base),
                                   world.slam, tuple(noise))
        assert torch.equal(state.grids, mine.grids)
        assert torch.equal(state.poses, mine.poses)
        assert torch.equal(state.ancestors, mine.ancestors)
        # the port's plain likelihood sums in another order than K1
        assert compare.gap(state.weights, mine.weights) < 1e-6
        assert torch.equal(out.pose, ref_out.pose)


@pytest.mark.parametrize("cell", sorted(CELLS))
@pytest.mark.parametrize("trace", [False, True])
def test_tiny_cells_run_correct_on_the_cpu(bench_root, cell, trace):
    result = harness.run_cell(bench_root, cell, 2 ** 31 + 11, 0.5, trace,
                              device="cpu")
    assert result["correct"], result["compared"]
    assert list(result)[-1] == "compared"
    assert result["attempted"] > 0 and result["failed"] == 0
    json.dumps(result)
    if not trace:
        assert "setup_s" in result["metrics"] and len(result["metrics"]) >= 2
