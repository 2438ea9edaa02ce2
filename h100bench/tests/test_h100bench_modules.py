"""The run's look at ``sys.modules``: whole top-level names, so that the
port passes and JAX and the JAX package do not."""

import sys
import types

import pytest

from h100bench import harness


@pytest.mark.parametrize("name,refused", [
    ("jax", True), ("jax.numpy", True), ("jaxlib", True), ("flax", True),
    ("slamrs_tpu", True), ("slamrs_tpu.ops.fused", True),
    ("slamrs_tpu_torch", False), ("slamrs_tpu_torch.ops.fused", False),
    ("jaxtyping", False)])
def test_top_level_names_compared_whole(monkeypatch, name, refused):
    present = set(harness.foreign_modules())
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    found = set(harness.foreign_modules()) - present
    assert bool(found) == refused
