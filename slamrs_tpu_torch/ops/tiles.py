"""Tile-pool particle maps: resampling relabels a band table instead of
moving map bytes.

Counterpart of ``slamrs_tpu/ops/tiles.py``.  The map set is a pool
``[n_phys, hb, cols]`` of full-width row bands plus a per-particle band
table ``i32[P, nb]`` (logical band ``b`` of particle ``i`` lives in pool
tile ``table[i, b]``).  A resample relabels the table,
``table <- table[ancestors]``: zero map bytes move.  Each update touches
``kspan`` consecutive bands per particle (2 when bands are at least the
window high, more for the 0.02 m-class geometry whose bands are half a
window).  A touched band whose tile is shared gets a fresh tile, and the
update copies the band into it (copy on write); an exclusively owned
tile is written in place.  :func:`tiled_plan` computes the allocation
from refcounts and cumsum ranks; ``n_phys = P*nb + kspan*P`` tiles make
it never fail.

:func:`fused_update_tiled` is the wrapper of the hand-written CUDA kernel
``csrc/fused_update_tiled.cu``, which replaces the Pallas kernel
``slamrs_tpu/ops/tiles.py::fused_update_tiled`` (both span geometries).
On a CPU tensor it runs :func:`fused_update_tiled_reference`, the plain
PyTorch version; on a CUDA tensor it launches the kernel or raises.  Both
update the pool in place.

The result is that of the full-width window, as the port's dense
kernel gives it (both kernels compute only the scan disc's bounding box,
``ops/fused.py::cell_pass_box``, the cells that can change).  The TPU's
shared-window cache (``_window_groups``,
``shared_window_plan``, ``merge_segment_windows``), its crop128 lane
roll with ``u0`` quantization, and the ``SLAMRS_TILES_NOBANDS`` ablation
exist for VMEM and 128-lane views; none changes the materialized maps of
a full-width computation, and none is ported.  Without the window merge
the k-span geometry may privatize other bands than the JAX package does
(its tables differ; the maps do not).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from slamrs_tpu_torch.ops.fused import (_TWO_PI, Prepared, _ptr, disc_half,
                                        prepare, update_window, window_cols,
                                        window_rows)
from slamrs_tpu_torch.ops.grid import GridSpec2D
from slamrs_tpu_torch.utils import trace

Tensor = torch.Tensor


def tile_geometry(spec: GridSpec2D, max_range_m: float,
                  band_rows: int | None = None) -> tuple[int, int, int]:
    """(band_rows, n_bands, padded_cols) for a tiled map at this spec.

    ``band_rows`` defaults to the window height ``wr``, the smallest band
    any window fits in a 2-band span (needs ``wr <= band_rows + 1``)."""
    hb = band_rows if band_rows is not None else window_rows(spec,
                                                             max_range_m)
    if hb % 8:
        raise ValueError(f"band rows must be a multiple of 8, got {hb}")
    if span_of(spec, max_range_m, hb) == 2:
        nb = max(-(-spec.rows // hb), 2)  # the window always spans 2 bands
    else:
        nb = span_geometry(spec, max_range_m, hb)[2]
    cols = (spec.cols + 127) // 128 * 128
    return hb, nb, cols


def span_geometry(spec: GridSpec2D, max_range_m: float,
                  hb: int) -> tuple[int, int, int]:
    """(wr, kspan, nb) for bands narrower than the window: the window of
    ``wr`` rows starts at an 8-aligned in-span offset ``woff <= hb - 8``
    of a ``kspan``-band span, and ``nb`` grows until a window clipped
    into the band padding still fits."""
    if hb % 8:
        raise ValueError(f"band rows must be a multiple of 8, got {hb}")
    wr = window_rows(spec, max_range_m)
    if wr > spec.rows:
        raise ValueError(f"window rows {wr} exceed the grid's {spec.rows}")
    kspan = -(-(hb - 8 + wr) // hb)
    nb = -(-spec.rows // hb)
    while ((nb * hb - wr) // 8 * 8) // hb + kspan > nb:
        nb += 1
    return wr, kspan, nb


def auto_band_rows(spec: GridSpec2D, max_range_m: float,
                   dtype=torch.bfloat16) -> int | None:
    """Band height for the k-band span when that geometry pays, else None
    (the ``wr``-band 2-span default).  Copied from the JAX package so
    that both packages lay out the same pool: half-window bands when
    windows cover most rows (``2*wr > rows``) and the TPU's k-span kernel
    could run there (full-width window, a crop128-able disc, bf16)."""
    wr = window_rows(spec, max_range_m)
    if 2 * wr <= spec.rows or dtype != torch.bfloat16:
        return None
    cols = (spec.cols + 127) // 128 * 128
    wc = window_cols(spec, max_range_m, cols)
    crop128 = wc >= 256 and 2 * disc_half(spec, max_range_m) + 1 + 8 <= 128
    if wc != cols or not crop128:
        return None
    hb = max(16, (wr // 2) // 8 * 8)
    return hb if wr > hb + 1 else None


def span_of(spec: GridSpec2D, max_range_m: float, hb: int) -> int:
    """Bands a window spans: 2, or the k-band span's ``kspan``."""
    if window_rows(spec, max_range_m) <= hb + 1:
        return 2
    return span_geometry(spec, max_range_m, hb)[1]


def init_tiled(p: int, spec: GridSpec2D, max_range_m: float,
               dtype=torch.bfloat16, band_rows: int | None = None,
               n_phys: int | None = None, *, device
               ) -> tuple[Tensor, Tensor]:
    """Fresh (pool, table): every band of every particle references the
    one all-zero tile 0 (log-odds prior 0).  ``device="meta"`` gives the
    shapes without allocating."""
    if band_rows is None:
        band_rows = auto_band_rows(spec, max_range_m, dtype)
    hb, nb, cols = tile_geometry(spec, max_range_m, band_rows)
    if n_phys is None:
        n_phys = p * nb + span_of(spec, max_range_m, hb) * p
    pool = torch.zeros((n_phys, hb, cols), dtype=dtype, device=device)
    table = torch.zeros((p, nb), dtype=torch.int32, device=device)
    return pool, table


def materialize(pool: Tensor, table: Tensor,
                spec: GridSpec2D | None = None) -> Tensor:
    """[P, nb*hb, cols] dense maps (tests and read-out, not the hot path).
    With ``spec``, rows are sliced to the logical grid."""
    p, nb = table.shape
    _, hb, cols = pool.shape
    dense = pool[table.long()].reshape(p, nb * hb, cols)
    return dense[:, :spec.rows] if spec is not None else dense


def materialize_one(pool: Tensor, row: Tensor) -> Tensor:
    """One particle's dense map from its table row (``nb`` tiles)."""
    _, hb, cols = pool.shape
    return pool[row.long()].reshape(-1, cols)


def tiled_plan(table: Tensor, t0: Tensor, n_phys: int, kspan: int = 2
               ) -> tuple[Tensor, Tensor, Tensor]:
    """Copy-on-write plan for one update (``tiles.py:197``).

    table: i32[P, nb]; t0: i32[P] first touched band (the window spans
    bands ``t0 .. t0+kspan-1``).  Returns (src i32[P, kspan], dst
    i32[P, kspan], new_table i32[P, nb]): ``dst == src`` where the tile is
    exclusively owned (refcount 1), distinct fresh tiles otherwise.  The
    free list is the JAX package's dropped scatter written as a scatter
    into a buffer with one sink slot; nothing syncs with the host.  The
    bands privatized (fresh tiles handed out) are added on the device to
    the counter ``k3.tiles_copied`` (``utils/trace.device_counter``)."""
    p, nb = table.shape
    if n_phys < p * nb + kspan * p:
        raise ValueError(f"pool of {n_phys} tiles is too small for {p} "
                         f"particles x {nb} bands + {kspan}x{p} fresh tiles")
    dev = table.device
    i32 = torch.int32
    bidx = t0[:, None] + torch.arange(kspan, dtype=i32, device=dev)[None, :]
    src = torch.gather(table, 1, bidx.long())
    flat = table.reshape(-1).long()
    rc = torch.zeros(n_phys, dtype=i32, device=dev).index_add_(
        0, flat, torch.ones(flat.shape[0], dtype=i32, device=dev))
    fresh = rc[src.long()] != 1  # shared (or the self-shared zero tile)
    n_fresh = torch.cumsum(fresh.reshape(-1), 0, dtype=i32)
    trace.device_counter("k3.tiles_copied", dev).add_(n_fresh[-1])
    rank = n_fresh - 1
    fmask = rc == 0
    fpos = torch.cumsum(fmask, 0, dtype=i32) - 1
    sink = kspan * p
    slot = torch.where(fmask & (fpos < sink), fpos, sink).long()
    free_idx = torch.zeros(sink + 1, dtype=i32, device=dev).scatter_(
        0, slot, torch.arange(n_phys, dtype=i32, device=dev))
    dst = torch.where(fresh, free_idx[rank.clamp_min(0).reshape(p, kspan)
                                      .long()], src)
    off = torch.arange(nb, dtype=i32, device=dev)[None, :] - t0[:, None]
    dstb = torch.gather(dst, 1, off.clamp(0, kspan - 1).long())
    new_table = torch.where((off >= 0) & (off < kspan), dstb, table)
    return src, dst, new_table


def fused_update_tiled_reference(pool: Tensor, src: Tensor, dst: Tensor,
                                 woff: Tensor, prep: Prepared,
                                 spec: GridSpec2D, num_beams: int) -> Tensor:
    """Plain PyTorch version of the tiled update on a prepared plan:
    gather each particle's ``kspan`` source tiles into a
    ``[P, kspan*hb, cols]`` span, run :func:`update_window` on its window
    at in-span offset ``woff``, and write every spanned band to its
    ``dst`` tile (in place).  Returns the likelihood ``f32[P]``."""
    p, kspan = src.shape
    _, hb, cols = pool.shape
    dev = pool.device
    span = pool[src.long()].reshape(p, kspan * hb, cols)
    pidx = torch.arange(p, device=dev)[:, None]
    rows = woff.long()[:, None] + torch.arange(prep.wr, device=dev)[None, :]
    win, lik = update_window(span[pidx, rows], prep, spec, num_beams)
    span[pidx, rows] = win
    pool[dst.reshape(-1).long()] = span.reshape(p * kspan, hb, cols)
    return lik


def check_inputs(pool: Tensor, table: Tensor, poses: Tensor,
                 ancestors: Tensor | None) -> None:
    """What the kernel takes: a contiguous 16-byte-aligned f32 or bf16
    pool ``[n_phys, hb, cols]``, an i32 table ``[P, nb]``, f32 poses
    ``[P, 3]`` and i32 ancestors ``[P]``, all on the pool's device.
    Raises otherwise."""
    if pool.dim() != 3 or table.dim() != 2 or table.shape[0] == 0:
        raise ValueError(f"pool must be [n_phys, hb, cols] and table "
                         f"[P, nb], got {list(pool.shape)}, "
                         f"{list(table.shape)}")
    if pool.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"pool must be float32 or bfloat16, got {pool.dtype}")
    if not pool.is_contiguous():
        raise ValueError("pool must be contiguous")
    p = table.shape[0]
    if table.dtype != torch.int32:
        raise ValueError(f"table must be i32, got {table.dtype}")
    if poses.shape != (p, 3) or poses.dtype != torch.float32:
        raise ValueError(f"poses must be f32[{p}, 3], got "
                         f"{poses.dtype}{list(poses.shape)}")
    if ancestors is not None and (ancestors.shape != (p,)
                                  or ancestors.dtype != torch.int32):
        raise ValueError(f"ancestors must be i32[{p}], got "
                         f"{ancestors.dtype}{list(ancestors.shape)}")
    for name, t in (("table", table), ("poses", poses),
                    ("ancestors", ancestors)):
        if t is not None and t.device != pool.device:
            raise ValueError(f"{name} is on {t.device}, pool on "
                             f"{pool.device}")


class TiledStep(NamedTuple):
    """One tiled update's host-side preparation and copy-on-write plan."""

    prep: Prepared  # pp, r0 (tiled construction), beam table, wr, binu
    woff: Tensor  # i32[P] window row origin inside the span
    src: Tensor  # i32[P, kspan] tiles read
    dst: Tensor  # i32[P, kspan] tiles written
    new_table: Tensor  # i32[P, nb]


def plan_step(pool: Tensor, table: Tensor, poses: Tensor, angles0,
              distances: Tensor, valid: Tensor, present: Tensor,
              spec: GridSpec2D, num_beams: int, max_range_m: float,
              dphi=None, ancestors: Tensor | None = None,
              prep: Prepared | None = None) -> TiledStep:
    """Relabel ``table[ancestors]``, prepare the kernel's inputs (or take
    ``prep``, the caller's :func:`prepare` of them for ``nb*hb`` rows),
    and plan the copy on write (``tiles.py:553-614``, ``:683-740``).

    The window row origin is the tiled construction: ``round(cy) -
    wr//2`` clipped to ``nb*hb - wr`` (into the band padding, whose rows
    are masked), then floored to 8; the span starts at band ``t0 =
    r0 // hb``, clipped to ``nb - 2`` for the 2-band span."""
    if ancestors is not None:
        table = table.index_select(0, ancestors.long())
    n_phys, hb, cols = pool.shape
    nb = table.shape[1]
    wr = window_rows(spec, max_range_m)
    kspan = span_of(spec, max_range_m, hb)
    if kspan > 2 and nb < span_geometry(spec, max_range_m, hb)[2]:
        raise ValueError(f"{nb} bands are too few for a {kspan}-band span")
    if distances.dim() != 1:
        raise ValueError("the tiled update takes one world's [B] scan (a "
                         "tiled fleet runs it once per world)")
    if prep is None:
        prep = prepare(nb * hb, cols, poses, angles0, distances, valid,
                       present, spec, num_beams, max_range_m, dphi)
    if prep.wr != wr:
        raise ValueError(f"{nb} bands of {hb} rows hold no {wr}-row window")
    t0 = torch.div(prep.r0, hb, rounding_mode="floor")
    if kspan == 2:
        t0 = torch.clamp(t0, 0, nb - 2)
    woff = (prep.r0 - t0 * hb).to(torch.int32)
    src, dst, new_table = tiled_plan(table, t0.to(torch.int32), n_phys,
                                     kspan)
    return TiledStep(prep, woff.contiguous(), src.contiguous(),
                     dst.contiguous(), new_table)


def fused_update_tiled(pool: Tensor, table: Tensor, poses: Tensor, angles0,
                       distances: Tensor, valid: Tensor, present: Tensor,
                       spec: GridSpec2D, num_beams: int, max_range_m: float,
                       dphi=None, ancestors: Tensor | None = None,
                       prep: Prepared | None = None
                       ) -> tuple[Tensor, Tensor, Tensor]:
    """One RBPF grid update over tiled maps.

    Same observable result as the dense ``fused_update`` on the
    materialized maps (likelihood on the pre-update window, full-width
    cell pass), with copy-on-write band privatization.  ``ancestors`` is
    the pending resample lineage (i32[P]), applied as the table relabel;
    ``prep`` as in :func:`plan_step`.  Updates ``pool`` in place and
    returns ``(pool, new_table, lik f32[P])``.
    """
    if pool.device.type != "cpu":
        check_inputs(pool, table, poses, ancestors)
        if pool.device.type != "cuda":
            raise ValueError(f"fused_update_tiled runs on cuda or cpu, not "
                             f"{pool.device}")
        if pool.data_ptr() % 16:
            raise ValueError("pool must be 16-byte aligned")
    step = plan_step(pool, table, poses, angles0, distances, valid, present,
                     spec, num_beams, max_range_m, dphi, ancestors, prep)
    if pool.device.type == "cpu":
        lik = fused_update_tiled_reference(pool, step.src, step.dst,
                                           step.woff, step.prep, spec,
                                           num_beams)
    else:
        lik = launch_kernel(pool, step, spec, num_beams)
    return pool, step.new_table, lik


def launch_kernel(pool: Tensor, step: TiledStep, spec: GridSpec2D,
                  num_beams: int) -> Tensor:
    """Launch the CUDA kernel on a validated plan (see
    :func:`fused_update_tiled`) on the current stream; updates ``pool`` in
    place, returns the likelihood and counts the launch in
    ``fused_update_tiled.launches``."""
    n_phys, hb, cols = pool.shape
    p, kspan = step.src.shape
    dev = pool.device
    prep = step.prep
    lik = torch.empty(p, dtype=torch.float32, device=dev)
    binu = prep.binu
    nbf = _TWO_PI / binu if binu is not None else 0.0

    from slamrs_tpu_torch import kernels

    lib = kernels.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.slamrs_fused_update_tiled(
            _ptr(pool), _ptr(step.src), _ptr(step.dst), _ptr(prep.r0),
            _ptr(step.woff), _ptr(prep.pp), _ptr(prep.table), _ptr(lik),
            p, hb, kspan, cols, prep.wr, spec.rows, spec.cols, num_beams,
            int(pool.dtype == torch.bfloat16), int(binu is not None),
            (1.0 / binu) if binu is not None else 0.0, nbf,
            (1.0 / nbf) if binu is not None else 0.0,
            ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(
            f"fused_update_tiled kernel launch failed: CUDA error {rc}")
    fused_update_tiled.launches += 1
    return lik


fused_update_tiled.launches = 0
