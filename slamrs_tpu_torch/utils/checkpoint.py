"""Checkpoint and resume of rollout state, in the JAX package's layout.

Counterpart of ``slamrs_tpu/utils/checkpoint.py``.  A state (a named
tuple of tensors, nested named tuples, host scalars and ``None``s, such
as ``WorldState`` or ``GridSlamState``) goes into one ``.npz`` file:

* ``leaf_i`` is the i-th leaf in field order, depth first, with ``None``
  fields skipped: the order of ``jax.tree.flatten`` on the JAX package's
  state, whose fields the port's states keep in the same order;
* bfloat16 tensors are stored widened to float32 (exact; npz has no
  bf16) and cast back on load;
* a host scalar (the world's float32 scan timer, its scan counter) is a
  0-dim float32 or int32 array, as the JAX package's 0-dim leaves are.

So a file written by ``python -m slamrs_tpu rollout --save-state``
resumes here, and :func:`load` refuses a file whose leaf count or leaf
shapes differ from the template's, as the JAX package's does.

A sharded state (``parallel.shard_world_state``) is saved in the
one-device layout, the leaves of saving ``unshard_world_state(state)``,
and a sharded template places each loaded leaf on its mesh, as the JAX
package's ``load`` does (``checkpoint.py:96-98``).
"""

from __future__ import annotations

import warnings
from typing import Any

import numpy as np
import torch

from slamrs_tpu_torch.parallel.fleet import Sharded


def _is_node(x) -> bool:
    return isinstance(x, (tuple, list))


def leaves(state: Any) -> list:
    """The leaves of ``state`` in checkpoint order (``None`` skipped)."""
    if state is None:
        return []
    if _is_node(state):
        return [leaf for child in state for leaf in leaves(child)]
    return [state]


def _rebuild(like: Any, it) -> Any:
    if like is None:
        return None
    if _is_node(like):
        children = [_rebuild(child, it) for child in like]
        if hasattr(like, "_fields"):  # a named tuple
            return type(like)(*children)
        return type(like)(children)
    return next(it)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, Sharded):
        leaf = leaf.full()
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.float()
        return leaf.detach().cpu().numpy()
    if isinstance(leaf, bool):
        return np.asarray(leaf)
    if isinstance(leaf, int):
        return np.asarray(leaf, np.int32)
    if isinstance(leaf, float):
        return np.asarray(leaf, np.float32)
    return np.asarray(leaf)


def save(path: str, state: Any) -> None:
    """Write ``state`` to ``path`` (.npz, compressed)."""
    arrays = {f"leaf_{i}": _to_numpy(leaf)
              for i, leaf in enumerate(leaves(state))}
    np.savez_compressed(path, **arrays)


def _shape(leaf) -> tuple:
    if isinstance(leaf, (torch.Tensor, Sharded)):
        return tuple(leaf.shape)
    return tuple(np.shape(leaf))


def _warn_narrowing(i: int, saved: np.dtype, target_bytes: int,
                    bf16: bool) -> None:
    # bf16 leaves are saved widened to f32 (a lossless round trip); any
    # other narrowing cast means the template differs from the saved state
    if saved.itemsize > target_bytes and not (bf16 and saved == np.float32):
        warnings.warn(f"checkpoint leaf {i}: narrowing {saved} on load "
                      "(template dtype differs from the saved state)",
                      stacklevel=3)


def load(path: str, like: Any) -> Any:
    """Restore a state written by :func:`save` (or by the JAX package's
    ``save``) onto the structure, dtypes and devices of ``like`` (build
    it with the same config), sharded as ``like`` is."""
    tmpl = leaves(like)
    with np.load(path) as data:
        n = sum(1 for k in data.files if k.startswith("leaf_"))
        if n != len(tmpl):
            raise ValueError(f"checkpoint has {n} leaves, template has "
                             f"{len(tmpl)} — config mismatch")
        out = []
        for i, t in enumerate(tmpl):
            arr = data[f"leaf_{i}"]
            if tuple(arr.shape) != _shape(t):
                raise ValueError(f"leaf {i}: checkpoint shape {arr.shape} "
                                 f"!= template {_shape(t)}")
            if isinstance(t, (torch.Tensor, Sharded)):
                _warn_narrowing(i, arr.dtype, t.dtype.itemsize,
                                t.dtype == torch.bfloat16)
                leaf = torch.from_numpy(np.array(arr)).to(device=t.device,
                                                          dtype=t.dtype)
                out.append(Sharded.place(leaf, t.mesh, t.spec)
                           if isinstance(t, Sharded) else leaf)
            elif isinstance(t, bool):
                out.append(bool(arr))
            elif isinstance(t, int):
                out.append(int(arr))
            elif isinstance(t, float):
                out.append(float(np.float32(arr)))
            else:
                out.append(np.asarray(arr, np.asarray(t).dtype))
    return _rebuild(like, iter(out))
