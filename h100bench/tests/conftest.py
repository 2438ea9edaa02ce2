"""Tests of the benchmark itself.  Run from the repository's root:

    python -m pytest h100bench/tests -q              # the CPU tests
    python -m pytest h100bench/tests -q -m cuda      # on an H100

Tests marked ``cuda`` need a card; each decides inside its fixture, so
every worker collects the same tests."""

import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
for p in (str(HERE), str(HERE.parents[1])):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    import torch

    config.addinivalue_line("markers",
                            "cuda: needs a CUDA device (an H100)")
    # the tiny cells' tensors are small: one thread a worker is fastest
    torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the H100 machine")
    return "cuda"


@pytest.fixture
def bench_root(tmp_path):
    """A benchmark root holding the tiny CPU cells of ``fixtures/``."""
    import fixture_bench

    from h100bench import harness

    return harness.Bench(fixture_bench.make_root(tmp_path))
