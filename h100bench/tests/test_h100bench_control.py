"""The control, the reference computed one precision below the
configuration's maps and put in the program's place, comes out as not
correct; the program itself comes out correct.  On the CPU at the tiny
sizes, and on the card (``cuda``) at the same sizes."""

import pytest

from h100bench import control


def limits(bench, cell):
    return bench.workload_params(cell)["limits"]


@pytest.mark.parametrize("cell", ["tiny.rollout", "tiny.fleet",
                                  "tiny.scan30hz"])
def test_control_is_not_correct_cpu(bench_root, cell):
    got = control.readings(bench_root, cell, 2 ** 32 + 5, 0.2, True,
                           device="cpu")
    lim = limits(bench_root, cell)
    assert all(got["sound"][k] <= v for k, v in lim.items()), got
    assert any(got["control"][k] > v for k, v in lim.items()), got


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["tiny.rollout", "tiny.fleet"])
def test_control_is_not_correct_cuda(bench_root, cuda_device, cell):
    got = control.readings(bench_root, cell, 2 ** 32 + 5, 0.2, True,
                           device=cuda_device)
    lim = limits(bench_root, cell)
    assert all(got["sound"][k] <= v for k, v in lim.items()), got
    assert any(got["control"][k] > v for k, v in lim.items()), got
