"""The fused grid update in plain PyTorch: the endpoint likelihood of a
scan on each particle's map, then the inverse-sensor-model integrate of
the scan into that map.

A frozen copy of the port's plain version (``prepare``, ``update_window``,
``plain_update`` of the port's ``ops/fused.py``), so that the benchmark's
yardstick does not move when the port does.  One change: the likelihood
is summed over the beam lanes in the order in which K1 sums it (two lanes
a thread, a butterfly over each warp, then the eight warps one after the
other), so that with the same inputs both give the same bits and a
particle filter followed for a whole call does not part on a rounding.

``quantize`` rounds the updated maps through a narrower float type: the
benchmark's control (the reference computed one precision below the
configuration's, ``compare.py``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

Tensor = torch.Tensor

# the inverse sensor model (the port's ops/grid.py)
P_FREE = 0.30
P_OCCUPIED = 0.9
Z_HIT = 0.9
SENSOR_MAXDIST = 1.0
TOLERANCE_CELLS = 2.0
ADDITIONAL_STEPS = 2
L_FREE = math.log(P_FREE / (1.0 - P_FREE))
L_OCCUPIED = math.log(P_OCCUPIED / (1.0 - P_OCCUPIED))

BEAM_PAD = 512
TWO_PI = 2.0 * math.pi
THREADS = 256  # K1's threads a particle: two beam lanes each
WARP = 32


class Spec(NamedTuple):
    """A grid: lower-left corner, extent and cell size in metres."""

    position_x: float
    position_y: float
    width: float
    height: float
    resolution: float

    @property
    def cols(self) -> int:
        return int(math.ceil(self.width / self.resolution))

    @property
    def rows(self) -> int:
        return int(math.ceil(self.height / self.resolution))

    @property
    def padded_cols(self) -> int:
        return (self.cols + 127) // 128 * 128


def f32(v, device) -> Tensor:
    """``v`` as a 0-dim float32 tensor on ``device`` (a fill)."""
    if isinstance(v, Tensor):
        return v.to(device=device, dtype=torch.float32)
    return torch.full((), float(v), dtype=torch.float32, device=device)


def disc_half(spec: Spec, max_range_m: float) -> int:
    return int(math.ceil(max_range_m / spec.resolution)) + ADDITIONAL_STEPS + 1


def window_rows(spec: Spec, max_range_m: float) -> int:
    disc = 2 * disc_half(spec, max_range_m) + 1
    wr = ((disc + 8) + 7) // 8 * 8
    return min(wr, (spec.rows + 7) // 8 * 8)


def pack3_quantum(max_range_cells: float) -> float:
    qu = 0.125
    while (max_range_cells + ADDITIONAL_STEPS + 2.0) / qu > 511.0:
        qu *= 2.0
    return qu


def quantize_d_enc(enc: Tensor, qu: float) -> Tensor:
    dq = torch.clamp(torch.round(torch.abs(enc) / qu), 1.0, 511.0) * qu
    return torch.where(enc == 0.0, enc, torch.where(enc > 0.0, dq, -dq))


def encode_beam_table(distances_cells, valid, present, angles0, dphi):
    """[..., B] beams -> [..., 8, BEAM_PAD]: row 0 the signed distance
    (+d hit, -d out of range, -0.0 absent), rows 1-4 the likelihood's
    distance, cos, sin and use flag."""
    batch, b = distances_cells.shape[:-1], distances_cells.shape[-1]
    dev = distances_cells.device
    d = torch.abs(distances_cells).to(torch.float32)
    enc = torch.where(valid, d, -d)
    enc = torch.where(present, enc, torch.full_like(d, -0.0))
    enc = torch.where(valid & present & (d == 0.0), torch.full_like(d, 1e-6),
                      enc)
    row = torch.cat([enc, torch.full((*batch, BEAM_PAD - b), -0.0,
                                     dtype=torch.float32, device=dev)], dim=-1)
    lane = torch.arange(BEAM_PAD, dtype=torch.float32, device=dev)
    ang = (f32(angles0, dev)[..., None] + lane * f32(dphi, dev)[..., None])
    use = torch.zeros((*batch, BEAM_PAD), dtype=torch.bool, device=dev)
    use[..., :b] = valid & present
    zero = torch.zeros((*batch, BEAM_PAD), dtype=torch.float32, device=dev)
    d_lik = zero.clone()
    d_lik[..., :b] = d
    d_lik = torch.where(use, d_lik, zero)
    ca = torch.where(use, torch.cos(ang), zero)
    sa = torch.where(use, torch.sin(ang), zero)
    return torch.stack([row, d_lik, ca, sa, use.to(torch.float32), zero, zero,
                        zero], dim=-2)


class Prepared(NamedTuple):
    pp: Tensor  # [N, 8] cx, cy, theta, ta-or-T, cos, sin, dphi, 1/dphi
    r0: Tensor  # [N] i32 window row offsets
    table: Tensor  # [8, BEAM_PAD] or [W, 8, BEAM_PAD]
    wr: int
    binu: float | None  # a static beam spacing, or None (traced)


def prepare(rows: int, cols: int, poses: Tensor, angles0, distances: Tensor,
            valid: Tensor, present: Tensor, spec: Spec, num_beams: int,
            max_range_m: float, dphi) -> Prepared:
    """One scan for every particle, or one per world (``distances
    [W, B]``) for ``N / W`` consecutive particles each."""
    dev = poses.device
    p = poses.shape[0]
    worlds = distances.shape[0] if distances.dim() == 2 else 1
    binu = float(dphi) if isinstance(dphi, (int, float)) else None
    dphi_t = f32(dphi, dev)
    a0_t = f32(angles0, dev)

    def per_particle(v):
        if v.dim() == 0:
            return v.expand(p)
        return v[:, None].expand(worlds, p // worlds).reshape(p)

    wr = min(window_rows(spec, max_range_m),
             rows - rows % 8 if rows % 8 else rows)
    cx = (poses[:, 0] - spec.position_x) / spec.resolution
    cy = (poses[:, 1] - spec.position_y) / spec.resolution
    theta = poses[:, 2]
    r0 = torch.round(cy).to(torch.int32) - wr // 2
    r0 = torch.clamp(r0, 0, max(rows - wr, 0))
    r0 = torch.div(r0, 8, rounding_mode="floor") * 8
    ta = theta + (a0_t if a0_t.dim() == 0 else per_particle(a0_t))
    if binu is not None:
        ta = ta * (1.0 / binu) - 0.5
    pp = torch.stack([cx, cy, theta, ta, torch.cos(theta), torch.sin(theta),
                      per_particle(dphi_t), per_particle(1.0 / dphi_t)],
                     dim=-1)
    table = encode_beam_table(distances / spec.resolution, valid, present,
                              a0_t, dphi_t)
    if num_beams <= 381:
        table[..., 0, :] = quantize_d_enc(
            table[..., 0, :], pack3_quantum(max_range_m / spec.resolution))
    return Prepared(pp.contiguous(), r0.to(torch.int32).contiguous(),
                    table.contiguous(), wr, binu)


def particle_tables(prep: Prepared) -> Tensor:
    n = prep.pp.shape[0]
    if prep.table.dim() == 2:
        return prep.table.expand(n, 8, BEAM_PAD)
    w = prep.table.shape[0]
    return prep.table[:, None].expand(w, n // w, 8, BEAM_PAD).reshape(
        n, 8, BEAM_PAD)


def kernel_order_sum(terms: Tensor) -> Tensor:
    """``terms [N, 512]`` summed per row in K1's order: thread ``t`` adds
    lanes ``t`` and ``t + 256``, each warp folds its 32 threads by a
    butterfly (16, 8, 4, 2, 1 apart), then the warps' sums are added in
    order.  Float addition commutes, so lane 0's butterfly is this halving
    fold."""
    acc = terms[:, :THREADS] + terms[:, THREADS:]
    x = acc.reshape(-1, THREADS // WARP, WARP)
    half = WARP // 2
    while half >= 1:
        x = x[..., :half] + x[..., half:2 * half]
        half //= 2
    warps = x[..., 0]
    total = warps[:, 0]
    for w in range(1, THREADS // WARP):
        total = total + warps[:, w]
    return total


def update_window(win: Tensor, prep: Prepared, spec: Spec, num_beams: int,
                  quantize: torch.dtype | None = None):
    """The update of one ``[P, wr, cols]`` window a particle, whose first
    row is grid row ``prep.r0``: ``(window', lik)``."""
    p, wr, cols = win.shape
    dev = win.device
    f = torch.float32
    pp, r0, _, _, binu = prep
    cx, cy, theta, ta, ct, st, dphi, inv_dphi = pp.unbind(-1)
    pidx = torch.arange(p, device=dev)[:, None]
    w32 = win.to(f)
    table = particle_tables(prep)

    # 1) endpoint likelihood on the pre-update window
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
    lik = kernel_order_sum(torch.where(use, torch.log(factor), 0.0))

    # 2) the inverse-sensor-model pass over the window
    def per_p(v):
        return v[:, None, None]

    wyl = torch.arange(wr, dtype=f, device=dev)[:, None]
    wxl = torch.arange(cols, dtype=f, device=dev)[None, :]
    r0f = per_p(r0.to(f))
    dx = wxl + per_p(0.5 - cx)
    dy = wyl + (r0f + per_p(0.5 - cy))
    r2 = dx * dx + dy * dy
    r = torch.sqrt(r2)
    phi = torch.atan2(dy, dx)
    if binu is not None:
        nbf = TWO_PI / binu
        b0 = phi * (1.0 / binu) - per_p(ta)
        b0 = b0 - nbf * torch.floor(b0 * (1.0 / nbf))
        bins = torch.floor(b0)
    else:
        nb_f = per_p(TWO_PI * inv_dphi)
        b0 = phi * per_p(inv_dphi) - per_p(ta * inv_dphi)
        b0 = b0 - nb_f * torch.floor(b0 * per_p(dphi * (1.0 / TWO_PI)))
        bins = torch.round(b0)
        wrap = bins >= nb_f - 0.5
        absent = (bins > num_beams - 1) & ~wrap
        bins = torch.where(wrap, 0.0, bins)
        bins = torch.where(absent, float(num_beams), bins)
    bins = torch.clamp(bins.long(), 0, BEAM_PAD - 1)
    d_enc = torch.gather(table[:, 0], 1, bins.reshape(p, -1)).reshape(
        bins.shape)
    was_hit = d_enc > 0.0
    pres = d_enc != 0.0
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
    new = (w32 + inc).to(win.dtype)
    if quantize is not None:  # saturating: float8 holds no infinity
        top = torch.finfo(quantize).max
        new = new.float().clamp(-top, top).to(quantize).to(win.dtype)
    return new, lik


def plain_update(maps: Tensor, prep: Prepared, spec: Spec, num_beams: int,
                 quantize: torch.dtype | None = None, rows_per_block=None):
    """The update written into the window rows of ``maps`` in place, in
    blocks of particles so that the window's temporaries fit; returns
    ``(maps, lik)``."""
    p = maps.shape[0]
    dev = maps.device
    block = p if rows_per_block is None else rows_per_block
    liks = []
    for s in range(0, p, block):
        e = min(p, s + block)
        part = Prepared(prep.pp[s:e], prep.r0[s:e],
                        prep.table if prep.table.dim() == 2
                        else _table_rows(prep, p, s, e), prep.wr, prep.binu)
        pidx = torch.arange(s, e, device=dev)[:, None]
        row_idx = (part.r0.long()[:, None]
                   + torch.arange(prep.wr, device=dev)[None, :])
        win, lik = update_window(maps[pidx, row_idx], part, spec, num_beams,
                                 quantize)
        maps[pidx, row_idx] = win
        liks.append(lik)
    return maps, torch.cat(liks)


def _table_rows(prep: Prepared, p: int, s: int, e: int) -> Tensor:
    """Each particle of ``[s, e)`` with its world's beam table, as a
    ``[e - s, 8, BEAM_PAD]`` table of one world a particle."""
    return particle_tables(prep)[s:e]
