"""The long-horizon gate for the port (``tests/torch_longrun.py``): 500
grid-SLAM updates for dda (float32) and fused (bfloat16) through the
grid node's update program, under the JAX package's seed-7 draws, held
to ``tests/test_longrun.py::test_longrun_fused_vs_dda_500_updates``'s
gates: dda tail drift <= 0.10 m, fused <= 0.15 m, path RMSE <= 0.10 m,
occupancy agreement >= 0.80.  The numbers print beside the JAX run's.

The 500-update run sits behind ``SLAMRS_LONGRUN`` as the JAX module
does (``SLAMRS_LONGRUN=1 python -m pytest tests/test_torch_longrun.py
-q -s``); ``chip_smoke.py``'s ``longrun_fused_vs_dda_500`` runs it on the
card, captured.  The committed draws are checked against the JAX key
chain on every run.  The JAX file's two ``out.bin``/``out2.bin`` tests
read reference recordings that are not in the repository and have no
counterpart here.
"""

from __future__ import annotations

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import torch_longrun  # noqa: E402


def test_committed_draws_are_the_jax_chain():
    from torch_compare import node_grid_noise

    want = node_grid_noise(7, torch_longrun.PARTICLES, torch_longrun.UPDATES)
    for got, field in zip(torch_longrun.load_draws(), zip(*want)):
        np.testing.assert_array_equal(got, np.stack(field))


@pytest.mark.skipif(
    not os.environ.get("SLAMRS_LONGRUN"),
    reason="long-horizon gates: set SLAMRS_LONGRUN=1 (as make longrun)")
def test_longrun_fused_vs_dda_500_updates():
    numbers, nodes = torch_longrun.run("cpu", graphs=False)
    print("longrun 500 (port, CPU):",
          ", ".join(f"{k} {v:.4f} (JAX {torch_longrun.JAX_CPU[k]})"
                    for k, v in numbers.items()))
    for node in nodes.values():
        assert node.program.stats.eager == torch_longrun.UPDATES + 1
    assert not torch_longrun.failed_gates(numbers), numbers
