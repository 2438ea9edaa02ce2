"""Copy-on-write particle resampling: move only duplicated maps.

Counterpart of ``slamrs_tpu/ops/cow.py``.  After a systematic resample an
ancestor with at least one child keeps its map in its own slot, ancestors
with no children free their slots, and each extra child takes a freed
slot: only those maps are copied (``grids[dst] <- grids[src]``).  The
resampled particle set is the multiset of ``take(..., ancestors)`` in
another slot order; identity ancestors (an N_eff skip) give an empty copy
list with no branching.

:func:`cow_plan` builds the plan on the device without a host sync (the
copy count stays a 0-dim tensor).  :func:`cow_copy` is the wrapper of the
hand-written CUDA kernel ``csrc/cow_copy.cu``, which replaces the Pallas
kernel ``slamrs_tpu/ops/cow.py::cow_copy``: on a CPU tensor it runs
:func:`cow_copy_reference`, the plain PyTorch version; on a CUDA tensor
it launches the kernel or raises.  The TPU's ``_cow_groups`` staging
metadata, its DMA depth and its ``ppb`` batching exist for VMEM and DMA
semaphores and are not ported.
"""

from __future__ import annotations

import ctypes

import torch

from slamrs_tpu_torch.utils import trace

Tensor = torch.Tensor


def cow_plan(ancestors: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    """Slot-preserving copy plan from ancestor indices (``cow.py:46``).

    ancestors: i32[P].  Returns ``(src, dst, n_copies)``: padded i32[P]
    copy lists (copies ``j < n_copies`` move map ``src[j]`` into freed
    slot ``dst[j]``; padding entries are self-writes on the surviving
    slot ``ancestors[0]``) and the 0-dim i32 copy count.  The JAX
    package's dropped scatter (``.at[].set(mode="drop")``) is a scatter
    into a ``P + 1`` buffer whose last slot is thrown away; the child
    count is an ``index_add_`` (``bincount`` would sync to size its
    output).
    """
    p = ancestors.shape[-1]
    dev = ancestors.device
    i32 = torch.int32
    j = torch.arange(p, dtype=i32, device=dev)
    counts = torch.zeros(p, dtype=i32, device=dev).index_add_(
        0, ancestors.long(), torch.ones(p, dtype=i32, device=dev))
    extra = torch.clamp_min(counts - 1, 0)
    bounds = torch.cumsum(extra, 0, dtype=i32)
    n_copies = bounds[-1]
    # copy j's source: the ancestor whose extra-children range covers j
    src = torch.searchsorted(bounds, j, right=True).to(i32)
    src = torch.clamp(src, 0, p - 1)
    # copy j's destination: the j-th freed slot, ascending
    is_free = counts == 0
    rank = torch.cumsum(is_free, 0, dtype=i32) - 1
    free_sorted = torch.zeros(p + 1, dtype=i32, device=dev).scatter_(
        0, torch.where(is_free, rank, p).long(), j)[:p]
    pad = ancestors[0].to(i32)
    live = j < n_copies
    src = torch.where(live, src, pad)
    dst = torch.where(live, free_sorted, pad)
    return src, dst, n_copies


def cow_copy_reference(grids: Tensor, src: Tensor, dst: Tensor,
                       n_copies: Tensor) -> Tensor:
    """Plain PyTorch version of :func:`cow_copy`: ``grids[dst[j]] =
    grids[src[j]]`` for ``j < n_copies``, in place; returns ``grids``."""
    n = int(n_copies)
    grids[dst[:n].long()] = grids[src[:n].long()]
    return grids


def _ptr(t: Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def check_inputs(grids: Tensor, src: Tensor, dst: Tensor,
                 n_copies: Tensor) -> None:
    """What the kernel takes: contiguous 16-byte-aligned maps of a whole
    number of 16-byte words, i32[P] plans and one i32 count, all on the
    maps' device.  Raises otherwise."""
    if grids.dim() < 2 or grids.shape[0] == 0:
        raise ValueError(f"grids must be [P, ...] with P > 0, got "
                         f"{list(grids.shape)}")
    p = grids.shape[0]
    map_bytes = grids[0].numel() * grids.element_size()
    if not grids.is_contiguous() or map_bytes % 16:
        raise ValueError("grids must be contiguous with a whole number of "
                         f"16-byte words per map, got {map_bytes} bytes")
    for name, t in (("src", src), ("dst", dst)):
        if t.shape != (p,) or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous i32[{p}], got "
                             f"{t.dtype}{list(t.shape)}")
    if n_copies.numel() != 1 or n_copies.dtype != torch.int32:
        raise ValueError(f"n_copies must be one i32, got "
                         f"{n_copies.dtype}{list(n_copies.shape)}")
    for name, t in (("src", src), ("dst", dst), ("n_copies", n_copies)):
        if t.device != grids.device:
            raise ValueError(f"{name} is on {t.device}, grids on "
                             f"{grids.device}")


def cow_copy(grids: Tensor, src: Tensor, dst: Tensor,
             n_copies: Tensor) -> Tensor:
    """Apply the copy plan in place: ``grids[dst[j]] = grids[src[j]]``
    for ``j < n_copies``.  grids [P, ...] of any dtype; returns ``grids``.
    On CUDA the kernel reads ``n_copies`` on the device, so the host
    never waits for the plan."""
    if grids.device.type == "cpu":
        return cow_copy_reference(grids, src, dst, n_copies)
    check_inputs(grids, src, dst, n_copies)
    if grids.device.type != "cuda":
        raise ValueError(f"cow_copy runs on cuda or cpu, not {grids.device}")
    if grids.data_ptr() % 16:
        raise ValueError("grids must be 16-byte aligned")
    return launch_kernel(grids, src, dst, n_copies)


def launch_kernel(grids: Tensor, src: Tensor, dst: Tensor,
                  n_copies: Tensor) -> Tensor:
    """Launch the CUDA kernel on validated inputs (see :func:`cow_copy`)
    on the current stream; counts the launch in ``cow_copy.launches``."""
    from slamrs_tpu_torch import kernels

    lib = kernels.library()
    dev = grids.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.slamrs_cow_copy(
            _ptr(grids), _ptr(src), _ptr(dst), _ptr(n_copies),
            grids.shape[0], grids[0].numel() * grids.element_size(),
            ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"cow_copy kernel launch failed: CUDA error {rc}")
    cow_copy.launches += 1
    return grids


cow_copy.launches = 0


def cow_resample(grids: Tensor, poses: Tensor, ancestors: Tensor
                 ) -> tuple[Tensor, Tensor]:
    """Slot-preserving resample of (poses [P, 3], grids [P, ...])
    (``cow.py:240``): the multiset of ``take(..., ancestors)`` in another
    slot order, moving only duplicated maps.  ``grids`` is updated in
    place; ``poses`` is not.  The maps copied are added on the device to
    the counter ``k2.maps_copied`` (``utils/trace.device_counter``)."""
    src, dst, n_copies = cow_plan(ancestors)
    trace.device_counter("k2.maps_copied", grids.device).add_(n_copies)
    grids = cow_copy(grids, src, dst, n_copies)
    poses = poses.index_copy(0, dst.long(), poses[src.long()])
    return poses, grids
