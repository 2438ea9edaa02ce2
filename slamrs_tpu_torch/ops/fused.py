"""Fused RBPF grid-SLAM update: likelihood + integrate in one kernel.

Counterpart of ``slamrs_tpu/ops/fused.py``.  Per particle ``i``, reading
map ``grids[ancestors[i]]`` (the pending resample lineage):

1. the exact endpoint log-likelihood of the scan on the pre-update map
   (Z_HIT mixture, ``1/SENSOR_MAXDIST`` for untouched cells);
2. the dense inverse-sensor-model integrate over a ``[wr, cols]`` row
   window around the pose: per cell, atan2 picks the covering beam from
   the quantized beam table, and the free/occupied increment is scaled
   by the beams-per-cell density near the robot.

:func:`fused_update` is the wrapper of the hand-written CUDA kernel
(``csrc/fused_update.cu``, which replaces the Pallas kernel
``slamrs_tpu/ops/fused.py::fused_update``).  On a CPU tensor it runs
:func:`fused_update_reference`, the plain PyTorch version of the same
math; on a CUDA tensor it launches the kernel or raises.  It has two
modes: lineage (reads ``grids[ancestors[i]]``, writes a fresh buffer:
the deferred-lineage resample) and in place (identity lineage, the
window rows of ``grids`` updated where they lie: the copy-on-write and
whole-set-gather resamples).  :func:`update_window` is the window-level
plain update that the tiled plain version (``ops/tiles.py``) reuses.
A fleet of worlds is one call over its flattened maps with one scan per
world (a beam table per world, :func:`prepare`), one kernel launch for
the whole fleet.

The kernel computes the increment only over the scan disc's bounding
box (:func:`cell_pass_box`, found on the card from the beam table), the
one part of the window whose cells can change; the plain version
computes the whole window, whose other cells gain exactly 0.  What bounds
it on the H100: in place, the box's per-cell arithmetic (an atan2, a
sqrt, a divide); in lineage mode, the bytes of the fresh output maps (the
21 MB headline map set read and written once, about 13 us at 3.35 TB/s).
Both are small next to the launch and host overheads of the rollout
around it.

Documented deviations kept from the JAX package: beam distances snap to
the static quantum of :func:`pack3_quantum` in the cell pass, and a valid
beam whose endpoint lies outside the window adds nothing to the
likelihood.  The scan is a uniform angle table starting at ``angles0``
with spacing ``dphi``; ``num_beams`` must be at most 383.
"""

from __future__ import annotations

import ctypes
import math as pymath
from typing import NamedTuple

import torch

from slamrs_tpu_torch.ops.grid import (ADDITIONAL_STEPS, GridSpec2D, L_FREE,
                                       L_OCCUPIED, SENSOR_MAXDIST,
                                       TOLERANCE_CELLS, Z_HIT, _f32_scalar)

Tensor = torch.Tensor

BEAM_PAD = 512  # beam-table lanes
_TWO_PI = 2.0 * pymath.pi


def fits_vmem_resident(grid_bytes: int) -> bool:
    """The JAX package's residency predicate (``fused.py:137-143``): a
    map set of ``grid_bytes`` counts as "resident" when twice it plus
    8 MiB fits in 120 MiB.

    The port keeps it only because it fixes the resample mechanism, and
    with it the slot order after a resample (see
    ``models/gridslam.resample_mechanism``): it says nothing about memory
    on the H100, where no map set is held on chip.
    """
    return 2 * grid_bytes + 8 * 2**20 <= 120 * 1024 * 1024


def supports_deferred_hbm(spec: GridSpec2D, max_range_m: float,
                          rows: int, cols: int) -> bool:
    """The JAX package's geometry predicate for its deferred-lineage HBM
    kernel (``fused.py:154-166``): full-width windows (padded ``cols``
    at most 256, or a disc wider than 128 lanes) and a window tall
    enough that the two out-of-window row bands are disjoint.

    Like :func:`fits_vmem_resident` the port keeps it only because it
    fixes the resample mechanism and so the slot order; it says nothing
    about the H100, whose kernel always gives the full-width result.
    """
    wr = window_rows(spec, max_range_m)
    wr = min(wr, rows - rows % 8 if rows % 8 else rows)
    return window_cols(spec, max_range_m, cols) == cols and rows - wr <= wr


def disc_half(spec: GridSpec2D, max_range_m: float) -> int:
    """Half-width in cells of the scan disc: range + overshoot + 1."""
    return (int(pymath.ceil(max_range_m / spec.resolution))
            + ADDITIONAL_STEPS + 1)


def window_rows(spec: GridSpec2D, max_range_m: float) -> int:
    """Static window row count: scan disc + 8-row alignment slack."""
    disc = 2 * disc_half(spec, max_range_m) + 1
    wr = ((disc + 8) + 7) // 8 * 8
    return min(wr, (spec.rows + 7) // 8 * 8)


def window_cols(spec: GridSpec2D, max_range_m: float, cols: int) -> int:
    """The JAX package's window column count for padded ``cols``: all of
    them up to 256 or for a disc wider than 128 lanes, else a 256-column
    crop.  The port always gives the result over all ``cols``; this only
    feeds the JAX package's geometry predicates."""
    return cols if (cols <= 256 or disc_half(spec, max_range_m) > 64) else 256


def pack3_quantum(max_range_cells: float) -> float:
    """Static power-of-two distance quantum: 511 units must cover max
    range + overshoot + tolerance (1/8 cell at the reference ranges)."""
    qu = 0.125
    while (max_range_cells + ADDITIONAL_STEPS + 2.0) / qu > 511.0:
        qu *= 2.0
    return qu


def quantize_d_enc(enc: Tensor, qu: float) -> Tensor:
    """|d| snapped to ``qu`` units (clamped to [1, 511] units), sign and
    +-0 preserved."""
    dq = torch.clamp(torch.round(torch.abs(enc) / qu), 1.0, 511.0) * qu
    return torch.where(enc == 0.0, enc, torch.where(enc > 0.0, dq, -dq))


def encode_beam_table(distances_cells: Tensor, valid: Tensor, present: Tensor,
                      angles0=None, dphi=None) -> Tensor:
    """[..., B] beam lanes -> [..., 8, BEAM_PAD] f32 table, one table per
    leading index (a fleet's per-world scans).

    Row 0: ``d_enc`` = +d (valid hit), -d (present, invalid), -0.0
    (absent or padding).  With ``angles0``/``dphi`` (scalars, or one per
    world) rows 1-4 carry the endpoint-likelihood lanes: distance of
    valid beams, cos and sin of ``angles0 + b * dphi``, and the use flag.
    Rows 5-7 are zero (the TPU's packed row is not used here).
    """
    batch, b = distances_cells.shape[:-1], distances_cells.shape[-1]
    dev = distances_cells.device
    f32 = torch.float32
    d = torch.abs(distances_cells).to(f32)
    neg_zero = torch.full_like(d, -0.0)
    enc = torch.where(valid, d, -d)
    enc = torch.where(present, enc, neg_zero)
    enc = torch.where(valid & present & (d == 0.0), torch.full_like(d, 1e-6),
                      enc)
    row = torch.cat([enc, torch.full((*batch, BEAM_PAD - b), -0.0, dtype=f32,
                                     device=dev)], dim=-1)
    if angles0 is None:
        return row.unsqueeze(-2).expand(*batch, 8, BEAM_PAD).clone()
    lane = torch.arange(BEAM_PAD, dtype=f32, device=dev)
    ang = (_f32_scalar(angles0, dev)[..., None]
           + lane * _f32_scalar(dphi, dev)[..., None])
    use = torch.zeros((*batch, BEAM_PAD), dtype=torch.bool, device=dev)
    use[..., :b] = valid & present
    zero = torch.zeros((*batch, BEAM_PAD), dtype=f32, device=dev)
    d_lik = zero.clone()
    d_lik[..., :b] = d
    d_lik = torch.where(use, d_lik, zero)
    ca = torch.where(use, torch.cos(ang), zero)
    sa = torch.where(use, torch.sin(ang), zero)
    return torch.stack([row, d_lik, ca, sa, use.to(f32), zero, zero, zero],
                       dim=-2)


def static_dphi(dphi) -> float | None:
    """The beam spacing as a Python float when the caller gave one (the
    static bin-units pipeline), else None (a tensor: the traced one)."""
    if isinstance(dphi, (int, float)):
        return float(dphi)
    return None


class Prepared(NamedTuple):
    """Host-side inputs shared by the kernel and its plain version."""

    pp: Tensor  # [N, 8] f32: cx, cy, theta, ta-or-T, cos, sin, dphi, 1/dphi
    r0: Tensor  # [N] i32 window row offsets (8-aligned, clamped)
    # [8, BEAM_PAD] f32 (one scan), or [W, 8, BEAM_PAD] (one per world,
    # particles N / W per world in order); row 0 already quantized
    table: Tensor
    wr: int  # window rows
    binu: float | None  # static spacing (static pipeline) or None


def worlds_of(prep: Prepared) -> int:
    """Number of scans (worlds) the prepared inputs hold."""
    return 1 if prep.table.dim() == 2 else prep.table.shape[0]


def particle_tables(prep: Prepared) -> Tensor:
    """[N, 8, BEAM_PAD]: each particle's beam table, the table of its
    world (a view for one scan, a copy for several)."""
    n = prep.pp.shape[0]
    if prep.table.dim() == 2:
        return prep.table.expand(n, 8, BEAM_PAD)
    w = prep.table.shape[0]
    return prep.table[:, None].expand(w, n // w, 8, BEAM_PAD).reshape(
        n, 8, BEAM_PAD)


def check_geometry(cols: int, num_beams: int) -> None:
    """Raise unless the kernels take maps of ``cols`` padded columns and a
    scan of ``num_beams`` beams."""
    if cols % 128:
        raise ValueError(f"grid column axis must be padded to 128, got {cols}")
    if num_beams > 383:
        raise ValueError(f"num_beams must be <= 383, got {num_beams}")


def prepared_window_rows(spec: GridSpec2D, max_range_m: float,
                         rows: int) -> int:
    """The window rows of :func:`prepare` for maps of ``rows`` rows."""
    return min(window_rows(spec, max_range_m),
               rows - rows % 8 if rows % 8 else rows)


def prepare(rows: int, cols: int, poses: Tensor, angles0, distances: Tensor,
            valid: Tensor, present: Tensor, spec: GridSpec2D, num_beams: int,
            max_range_m: float, dphi) -> Prepared:
    """Everything the JAX package computes outside its kernel, in the same
    order and precision (``slamrs_tpu/ops/fused.py:1646-1683``,
    ``_pp_table``, the beam table with its quantized row 0).

    One scan (``distances [B]``, scalar ``angles0`` and ``dphi``) serves
    every particle; a fleet's scans (``distances [W, B]``, ``angles0
    [W]``, ``dphi`` a float, a scalar or ``[W]``) serve ``N / W``
    consecutive particles each, as the JAX package's kernel vmapped over
    worlds (``slamrs_tpu/parallel/shard.py:61-68``)."""
    check_geometry(cols, num_beams)
    dev = poses.device
    p = poses.shape[0]
    if distances.dim() not in (1, 2):
        raise ValueError(f"distances must be [B] or [W, B], got "
                         f"{list(distances.shape)}")
    worlds = distances.shape[0] if distances.dim() == 2 else 1
    if worlds == 0 or p % worlds:
        raise ValueError(f"{p} particles do not split into {worlds} worlds")
    if dphi is None:
        dphi = _TWO_PI / num_beams
    binu = static_dphi(dphi)
    dphi_t = _f32_scalar(dphi, dev)
    a0_t = _f32_scalar(angles0, dev)

    def per_particle(v):  # a scalar broadcasts, one value a world repeats
        if v.dim() == 0:
            return v.expand(p)
        return v[:, None].expand(worlds, p // worlds).reshape(p)

    wr = prepared_window_rows(spec, max_range_m, rows)

    # per-column Python offsets (float32 when they meet the f32 poses):
    # the same values as subtracting a [2] tensor, without a host copy
    cx = (poses[:, 0] - spec.position_x) / spec.resolution
    cy = (poses[:, 1] - spec.position_y) / spec.resolution
    theta = poses[:, 2]
    r0 = torch.round(cy).to(torch.int32) - wr // 2
    r0 = torch.clamp(r0, 0, max(rows - wr, 0))
    r0 = torch.div(r0, 8, rounding_mode="floor") * 8

    ta = theta + (a0_t if a0_t.dim() == 0 else per_particle(a0_t))
    if binu is not None:
        ta = ta * (1.0 / binu) - 0.5
    pp = torch.stack([cx, cy, theta, ta,
                      torch.cos(theta), torch.sin(theta),
                      per_particle(dphi_t), per_particle(1.0 / dphi_t)],
                     dim=-1)

    table = encode_beam_table(distances / spec.resolution, valid, present,
                              a0_t, dphi_t)
    if num_beams <= 381:
        table[..., 0, :] = quantize_d_enc(
            table[..., 0, :], pack3_quantum(max_range_m / spec.resolution))
    return Prepared(pp.contiguous(), r0.to(torch.int32).contiguous(),
                    table.contiguous(), wr, binu)


def update_window(win: Tensor, prep: Prepared, spec: GridSpec2D,
                  num_beams: int) -> tuple[Tensor, Tensor]:
    """The plain fused update of one ``[P, wr, cols]`` window per
    particle, whose first row is grid row ``prep.r0``.  Returns
    ``(window', lik)``: the updated window in ``win``'s dtype and the
    endpoint log-likelihood on the pre-update window."""
    p, wr, cols = win.shape
    dev = win.device
    f32 = torch.float32
    pp, r0, _, _, binu = prep
    cx, cy, theta, ta, ct, st, dphi, inv_dphi = pp.unbind(-1)
    pidx = torch.arange(p, device=dev)[:, None]
    w32 = win.to(f32)
    table = particle_tables(prep)  # [P, 8, BEAM_PAD]

    # 1) exact endpoint likelihood on the pre-update window
    d_b, ca, sa = table[:, 1], table[:, 2], table[:, 3]
    use = table[:, 4] > 0.5
    ex = cx[:, None] + (ct[:, None] * ca - st[:, None] * sa) * d_b
    ey = cy[:, None] + (st[:, None] * ca + ct[:, None] * sa) * d_b
    use = (use & (ex >= 0.0) & (ey >= 0.0) & (ex < float(spec.cols))
           & (ey < float(spec.rows)))
    xi = torch.floor(ex).to(torch.int32)
    yi = torch.floor(ey).to(torch.int32) - r0[:, None]
    use = use & (yi >= 0) & (yi < wr) & (xi >= 0) & (xi < cols)
    xi = torch.where(use, xi, 0).long()
    yi = torch.where(use, yi, 0).long()
    odds = w32[pidx, yi, xi]
    p_end = 1.0 - 1.0 / (1.0 + torch.exp(odds))
    mix = Z_HIT * p_end + (1.0 - Z_HIT) / SENSOR_MAXDIST
    factor = torch.where(odds == 0.0,
                         torch.full_like(odds, 1.0 / SENSOR_MAXDIST), mix)
    lik = torch.sum(torch.where(use, torch.log(factor), 0.0), dim=-1)

    # 2) dense inverse-sensor-model pass, folded window offsets
    def per_p(v):
        return v[:, None, None]

    wyl = torch.arange(wr, dtype=f32, device=dev)[:, None]
    wxl = torch.arange(cols, dtype=f32, device=dev)[None, :]
    r0f = per_p(r0.to(f32))
    dx = wxl + per_p(0.5 - cx)
    dy = wyl + (r0f + per_p(0.5 - cy))
    r2 = dx * dx + dy * dy
    r = torch.sqrt(r2)
    phi = torch.atan2(dy, dx)
    if binu is not None:
        # static bin units: T = ta/dphi - 0.5 makes round() a floor and
        # the wrap to [0, nbf] closes the circle
        nbf = _TWO_PI / binu
        b0 = phi * (1.0 / binu) - per_p(ta)
        b0 = b0 - nbf * torch.floor(b0 * (1.0 / nbf))
        bins = torch.floor(b0)
    else:
        # traced spacing: round, map the closing half bin onto beam 0,
        # and send bins past the table to an absent lane
        nb_f = per_p(_TWO_PI * inv_dphi)
        b0 = phi * per_p(inv_dphi) - per_p(ta * inv_dphi)
        b0 = b0 - nb_f * torch.floor(b0 * per_p(dphi * (1.0 / _TWO_PI)))
        bins = torch.round(b0)
        wrap = bins >= nb_f - 0.5
        absent = (bins > num_beams - 1) & ~wrap
        bins = torch.where(wrap, 0.0, bins)
        bins = torch.where(absent, float(num_beams), bins)
    # the clamp only guards memory: every bin above lies in [0, 383]
    bins = torch.clamp(bins.long(), 0, BEAM_PAD - 1)
    d_enc = torch.gather(table[:, 0], 1, bins.reshape(p, -1)).reshape(
        bins.shape)
    was_hit = d_enc > 0.0
    pres = d_enc != 0.0  # -0.0 is absent too
    d = torch.abs(d_enc)
    half = TOLERANCE_CELLS / 2.0
    dm = torch.clamp_min(d - half, 0.0)
    a_sq = torch.where(was_hit, dm * dm, d * d)
    dp = d + half
    b_sq = torch.where(was_hit, dp * dp, -1.0)
    inc = torch.where(r2 < a_sq, L_FREE,
                      torch.where(r2 <= b_sq, L_OCCUPIED, 0.0))
    dens = torch.clamp_min(1.0 / (torch.clamp_min(r, 0.5) * per_p(dphi)), 1.0)
    in_b = (wyl < float(spec.rows) - r0f) & (wxl < float(spec.cols))
    inc = torch.where(pres & in_b, inc * dens, 0.0)
    return (w32 + inc).to(win.dtype), lik


def cell_pass_box(prep: Prepared, cols: int, align: int = 1
                  ) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """Per particle, the window cells the kernels' cell pass visits: rows
    ``[y0, y1)`` and columns ``[x0, x1)`` of the ``[wr, cols]`` window,
    i32[P] each.

    The box holds the cells with ``|dx| < dmax + 2`` and ``|dy| < dmax +
    2`` (``dx``, ``dy`` the cell offsets of :func:`update_window`, ``dmax``
    the largest ``|d_enc|`` in row 0 of the particle's world's beam table,
    a NaN lane ignored), clipped to the window, its columns widened to
    multiples of ``align`` cells (the kernels use 16 bytes: 8 bf16 or 4
    f32 cells).  No
    cell outside it gains a nonzero increment: that needs ``r^2`` at most
    ``(|d| + 1)^2`` for its beam, and the extra cell covers the float32
    rounding of ``r^2``.  It follows the scan, not ``max_range_m``, so a
    beam past the range widens it.  The float32 steps are those of
    ``csrc/fused_common.cuh::cell_box``, so both give the same box; the
    tests and ``chip_smoke.py`` use it, the main path does not."""
    d = torch.abs(particle_tables(prep)[:, 0])
    e = torch.where(torch.isnan(d), 0.0, d).amax(dim=-1) + 2.0
    cx, cy = prep.pp[:, 0], prep.pp[:, 1]
    r0 = prep.r0.to(torch.float32)

    def clip(v, hi):
        return torch.clamp(v, 0.0, float(hi)).to(torch.int32)

    x0 = clip(torch.floor(cx - e), cols) // align * align
    x1 = (clip(torch.ceil(cx + e), cols) + align - 1) // align * align
    return (clip(torch.floor(cy - e) - r0, prep.wr),
            clip(torch.ceil(cy + e) - r0, prep.wr), x0, x1)


def plain_update(maps: Tensor, prep: Prepared, spec: GridSpec2D,
                 num_beams: int) -> tuple[Tensor, Tensor]:
    """The fused update on maps already gathered by lineage; writes the
    window rows of ``maps`` in place and returns ``(maps, lik)``."""
    p = maps.shape[0]
    dev = maps.device
    pidx = torch.arange(p, device=dev)[:, None]
    row_idx = (prep.r0.long()[:, None]
               + torch.arange(prep.wr, device=dev)[None, :])
    win, lik = update_window(maps[pidx, row_idx], prep, spec, num_beams)
    maps[pidx, row_idx] = win
    return maps, lik


def fused_update_reference(grids: Tensor, poses: Tensor, angles0,
                           distances: Tensor, valid: Tensor, present: Tensor,
                           spec: GridSpec2D, num_beams: int,
                           max_range_m: float, dphi=None,
                           ancestors: Tensor | None = None,
                           in_place: bool = False,
                           prep: Prepared | None = None
                           ) -> tuple[Tensor, Tensor]:
    """Plain PyTorch version of the fused update (counterpart of the JAX
    ``fused_update_reference``, ``fused.py:1915``, with lineage: the maps
    are gathered by ``ancestors`` first).  Returns ``(grids', lik [P])``;
    leaves ``grids`` untouched unless ``in_place``, where ``grids'`` is
    ``grids`` with its window rows updated.  ``prep``: :func:`prepare`'s
    result for these inputs, made by the caller."""
    _check_in_place(in_place, ancestors)
    p, rows, cols = grids.shape
    if prep is None:
        prep = prepare(rows, cols, poses, angles0, distances, valid, present,
                       spec, num_beams, max_range_m, dphi)
    if in_place:
        maps = grids
    else:
        maps = grids[ancestors.long()] if ancestors is not None \
            else grids.clone()
    return plain_update(maps, prep, spec, num_beams)


def _check_in_place(in_place: bool, ancestors) -> None:
    if in_place and ancestors is not None:
        raise ValueError("in_place=True takes no ancestors: the in-place "
                         "update keeps every particle's map in its slot")


def _ptr(t: Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def fused_update(grids: Tensor, poses: Tensor, angles0, distances: Tensor,
                 valid: Tensor, present: Tensor, spec: GridSpec2D,
                 num_beams: int, max_range_m: float,
                 ancestors: Tensor | None = None, dphi=None,
                 in_place: bool = False, prep: Prepared | None = None
                 ) -> tuple[Tensor, Tensor]:
    """One RBPF grid update for all particles.

    grids: [P, H, Wp] f32 or bf16 log-odds, ``Wp % 128 == 0``; poses:
    [P, 3] sampled poses; angles0: first beam angle; distances/valid/
    present: [B] scan; ancestors: i32[P] pending lineage in [0, P)
    (particle ``i`` reads ``grids[ancestors[i]]``; values are not checked
    on the device, the resample clamps them); dphi: beam spacing, a
    Python float (static pipeline) or a tensor (traced pipeline), default
    2*pi/B; in_place: update the window rows of ``grids`` where they lie
    (identity lineage: ``ancestors`` must be None); prep: the
    :func:`prepare` of these inputs where the caller made it (one world's
    proposal, ``ops/propose.py``), else it is made here.

    A fleet of ``W`` worlds is one call: ``grids``/``poses`` flattened to
    ``[W*P, ...]`` world by world, one scan per world (``distances``,
    ``valid``, ``present`` ``[W, B]``, ``angles0 [W]``, ``dphi`` a float,
    a scalar or ``[W]``), and ``ancestors`` block-diagonal (world ``w``'s
    entries in ``[w*P, (w+1)*P)``).  The kernel launches once for the
    whole fleet.
    Returns ``(grids' [P, H, Wp], log_lik f32[P])``.  Without
    ``in_place`` ``grids`` is not modified (the kernel writes a fresh
    buffer); with it ``grids'`` is ``grids``.
    """
    _check_in_place(in_place, ancestors)
    if grids.device.type == "cpu":
        return fused_update_reference(grids, poses, angles0, distances, valid,
                                      present, spec, num_beams, max_range_m,
                                      dphi=dphi, ancestors=ancestors,
                                      in_place=in_place, prep=prep)
    if grids.device.type != "cuda":
        raise ValueError(
            f"fused_update runs on cuda or cpu, not {grids.device}")
    p, rows, cols = grids.shape
    dev = grids.device
    if p == 0:
        raise ValueError("fused_update needs at least one particle")
    if grids.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"grids must be float32 or bfloat16, got {grids.dtype}")
    if not grids.is_contiguous() or grids.data_ptr() % 16:
        raise ValueError("grids must be contiguous and 16-byte aligned")
    if poses.shape != (p, 3) or poses.dtype != torch.float32:
        raise ValueError(f"poses must be f32[{p}, 3], got "
                         f"{poses.dtype}{list(poses.shape)}")
    if ancestors is None and not in_place:
        ancestors = torch.arange(p, dtype=torch.int32, device=dev)
    if ancestors is not None and (
            ancestors.shape != (p,) or ancestors.dtype != torch.int32
            or not ancestors.is_contiguous()):
        raise ValueError(f"ancestors must be contiguous i32[{p}]")
    for name, t in (("poses", poses), ("ancestors", ancestors),
                    ("distances", distances), ("valid", valid),
                    ("present", present)):
        if t is not None and t.device != dev:
            raise ValueError(f"{name} is on {t.device}, grids on {dev}")
    for name, t in (("valid", valid), ("present", present)):
        if t.shape != distances.shape:
            raise ValueError(f"{name} must be shaped as distances "
                             f"{list(distances.shape)}, got {list(t.shape)}")
    if prep is None:
        prep = prepare(rows, cols, poses, angles0, distances, valid, present,
                       spec, num_beams, max_range_m, dphi)
    return launch_kernel(grids, ancestors, prep, spec, num_beams)


def launch_kernel(grids: Tensor, ancestors: Tensor | None, prep: Prepared,
                  spec: GridSpec2D, num_beams: int) -> tuple[Tensor, Tensor]:
    """Launch the CUDA kernel on validated inputs (see :func:`fused_update`)
    on the current stream, once for all worlds; counts the launch in
    ``fused_update.launches`` (and an in-place one also in
    ``fused_update.in_place_launches``).  ``ancestors=None`` is the
    in-place mode: the output is ``grids``."""
    p, rows, cols = grids.shape
    per_world = p // worlds_of(prep)
    dev = grids.device
    in_place = ancestors is None
    out = grids if in_place else torch.empty_like(grids)
    lik = torch.empty(p, dtype=torch.float32, device=dev)
    binu = prep.binu
    nbf = _TWO_PI / binu if binu is not None else 0.0

    from slamrs_tpu_torch import kernels

    lib = kernels.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.slamrs_fused_update(
            _ptr(grids), _ptr(out),
            None if in_place else _ptr(ancestors), _ptr(prep.pp),
            _ptr(prep.r0), _ptr(prep.table), _ptr(lik),
            p, per_world, rows, cols, prep.wr, spec.rows, spec.cols,
            num_beams,
            int(grids.dtype == torch.bfloat16), int(binu is not None),
            (1.0 / binu) if binu is not None else 0.0, nbf,
            (1.0 / nbf) if binu is not None else 0.0,
            ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(
            f"fused_update kernel launch failed: CUDA error {rc}")
    fused_update.launches += 1
    fused_update.in_place_launches += int(in_place)
    return out, lik


fused_update.launches = 0
fused_update.in_place_launches = 0
