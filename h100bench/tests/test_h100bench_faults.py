"""The check refuses a broken timed path: each fault a cell can have is
planted in the port underneath a whole run of a tiny cell on the CPU
(the harness's look for a chip skipped), and ``correct`` comes out
false.  One chip runs each cell, so no exchange between chips can be
left out."""


import pytest
import torch

from h100bench import harness


def state_unchanged(gs, monkeypatch):
    """The SLAM update returns the state it was given."""
    for name in ("update", "update_fleet"):
        real = getattr(gs, name)

        def same(state, *a, _real=real, **k):
            copy = type(state)(*(v.clone() if isinstance(v, torch.Tensor)
                                 else v for v in state))
            _, out = _real(state, *a, **k)
            return copy, out
        monkeypatch.setattr(gs, name, same)


def half_left_out(gs, monkeypatch):
    """The fused update integrates only the first half of the particles'
    maps (the rest keep the maps they read)."""
    real = gs.fused_update

    def half(grids, *a, **k):
        ancestors = k.get("ancestors")
        before = (grids.clone() if ancestors is None
                  else grids[ancestors.long()])
        out, lik = real(grids, *a, **k)
        n = out.shape[0] // 2
        out[n:] = before[n:]
        return out, lik
    monkeypatch.setattr(gs, "fused_update", half)


def answer_altered(gs, monkeypatch):
    """The update's published pose is moved by a millimetre."""
    for name in ("update", "update_fleet"):
        real = getattr(gs, name)

        def moved(*a, _real=real, **k):
            state, out = _real(*a, **k)
            return state, out._replace(pose=out.pose + 1e-3)
        monkeypatch.setattr(gs, name, moved)


@pytest.mark.parametrize("cell", ["tiny.rollout", "tiny.fleet"])
@pytest.mark.parametrize("fault", [state_unchanged, half_left_out,
                                   answer_altered])
def test_fault_makes_correct_false(bench_root, monkeypatch, cell, fault):
    from slamrs_tpu_torch.models import gridslam as gs

    fault(gs, monkeypatch)
    result = harness.run_cell(bench_root, cell, 2 ** 33 + 1, 0.3, False,
                              device="cpu")
    assert not result["correct"], result["compared"]
