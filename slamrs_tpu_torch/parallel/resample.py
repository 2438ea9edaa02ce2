"""Sharded fleet resampling without gathering every map everywhere.

Counterpart of ``slamrs_tpu/parallel/resample.py``.  A resampled particle
set is a multiset of survivors (slot order is free), so each particle
shard may relabel its slots to keep maps where they are:

* each shard keeps copies of its own surviving ancestors in its own
  slots (a gather inside the shard);
* a shard whose ancestors have more children than it has slots spills
  the extra copies; systematic-resample ancestors are sorted, so those
  form a suffix of the shard's range, and the shard publishes at most
  ``spill_cap`` unique maps into a pool that every shard of the world
  receives;
* shards with free slots fill them from the pool, by a plan that every
  shard computes alike from the ancestors (:func:`_plan`, replicated
  integer math on ``[P]`` ancestors);
* if some shard would publish more than ``spill_cap`` unique maps, the
  world shard falls back to the exact gather in slot order.

The plan is the JAX package's, line for line, so the relabel is its slot
for slot.  The pool's all-gather is one copy of each shard's spill window
onto each receiving shard's device (a no-op where they share a device);
nothing is staged through the host.
"""

from __future__ import annotations

import contextlib

import torch

from slamrs_tpu_torch.parallel.fleet import (Mesh, Sharded, WORLD_PARTICLE,
                                             world_part)

Tensor = torch.Tensor


def _searchsorted(sorted_rows: Tensor, values: Tensor) -> Tensor:
    """``jnp.searchsorted(side="right")`` per row, as int32: the number of
    entries of each sorted row ``<= value`` (``torch.searchsorted`` on
    contiguous rows of one dtype)."""
    return torch.searchsorted(sorted_rows.contiguous(),
                              values.to(sorted_rows.dtype).contiguous(),
                              right=True, out_int32=True)


def _plan(ancestors: Tensor, n_shards: int, p_loc: int, spill_cap: int):
    """The replicated plan of ``resample.py:46-119`` over leading world
    axes.  ``ancestors``: i32[..., P], sorted per world (identity when
    the resample did not fire).  Returns, each over the world axes:

    - ``local_src`` i32[S, p_loc]: the in-shard (local) ancestor of a slot;
    - ``use_pool`` bool[S, p_loc]: the slot is filled from the pool;
    - ``pool_sel`` i32[S, p_loc]: its flat pool index (``shard * cap + k``);
    - ``pool_base`` i32[S]: the first local ancestor each shard publishes;
    - ``overflow`` bool[]: some shard spills more than ``spill_cap``
      unique maps."""
    batch = ancestors.shape[:-1]
    p = ancestors.shape[-1]
    s = n_shards
    dev = ancestors.device
    i32 = torch.int32
    # counts = zeros.at[ancestors].add(1), one world after another
    n_worlds = ancestors[..., 0].numel()
    flat = (ancestors.reshape(n_worlds, p).long()
            + p * torch.arange(n_worlds, device=dev)[:, None]).reshape(-1)
    counts = torch.zeros(n_worlds * p, dtype=i32, device=dev).index_add_(
        0, flat, torch.ones_like(flat, dtype=i32)).reshape(*batch, s, p_loc)
    cum_sh = torch.cumsum(counts, dim=-1, dtype=i32)  # inclusive, per shard
    total = cum_sh[..., -1]  # children per shard [..., S]

    # local fill: slot j of shard t copies the t-local ancestor whose
    # cumulative-children range covers j (sorted fill order)
    slot = torch.arange(p_loc, dtype=i32, device=dev)
    local_src = _searchsorted(cum_sh, slot.expand(*batch, s, p_loc))
    local_src = torch.clamp(local_src, 0, p_loc - 1)
    fill_n = torch.clamp(total, max=p_loc)

    # spill: fill positions [p_loc, total) of a surplus shard; sorted
    # fill => the spilled ancestors are the suffix [base, last]
    spill_copies = torch.clamp(total - p_loc, min=0)
    base = _searchsorted(cum_sh, torch.full((*batch, s, 1), p_loc,
                                            dtype=i32, device=dev))[..., 0]
    last = _searchsorted(cum_sh, torch.clamp(total - 1, min=0)[..., None]
                         )[..., 0]
    uniq = torch.where(spill_copies > 0, last - base + 1,
                       torch.zeros_like(last))
    overflow = torch.any(uniq > spill_cap, dim=-1)
    # publish window start, clamped so the fixed-size window stays inside
    pool_base = torch.clamp(base, 0, max(p_loc - min(spill_cap, p_loc), 0))

    # deficit fill: global spill order = (shard asc, fill position asc);
    # shard t's free slots take global spill positions from
    # deficit_start[t]; position g belongs to source shard src_t at
    # in-shard spill offset off, whose ancestor covers fill position
    # p_loc + off in src_t's cumulative counts
    deficit = p_loc - fill_n
    deficit_start = torch.cumsum(deficit, dim=-1, dtype=i32) - deficit
    spill_cum = torch.cumsum(spill_copies, dim=-1, dtype=i32)
    use = slot >= fill_n[..., None]  # [..., S, p_loc]
    g = deficit_start[..., None] + slot - fill_n[..., None]
    g = torch.where(use, g, torch.zeros_like(g))
    src_t = _searchsorted(spill_cum[..., None, :].expand(*batch, s, s), g)
    src_t = torch.clamp(src_t, 0, s - 1)
    prev = torch.gather(spill_cum, -1, torch.clamp(src_t - 1, min=0).reshape(
        *batch, s * p_loc).long()).reshape(*batch, s, p_loc)
    off = g - torch.where(src_t > 0, prev, torch.zeros_like(prev))
    rows = torch.gather(cum_sh, -2, src_t.reshape(*batch, s * p_loc, 1).long()
                        .expand(*batch, s * p_loc, p_loc))
    anc = _searchsorted(rows, (p_loc + off).reshape(*batch, s * p_loc, 1)
                        ).reshape(*batch, s, p_loc)
    anc = torch.clamp(anc, 0, p_loc - 1)
    base_src = torch.gather(pool_base, -1, src_t.reshape(
        *batch, s * p_loc).long()).reshape(*batch, s, p_loc)
    k = torch.clamp(anc - base_src, 0, spill_cap - 1)
    pool_sel = src_t * spill_cap + k
    return local_src, use, pool_sel.to(i32), pool_base, overflow


def _read_overflow(flags: Tensor) -> list:
    """The counterpart of ``lax.cond`` on the overflow
    (``resample.py:177``): the one host read of a particle-sharded
    resample, every world shard's flag (``flags``, bool ``[n_rows]``) at
    once.  Running both branches and selecting would do the full gather
    every time."""
    return flags.tolist()


# the frame program's handler of the overflow read (graph/capture.py),
# set around its body by split_at_overflow
_SPLIT = None


@contextlib.contextmanager
def split_at_overflow(handler):
    """Within the block, :func:`resample_fleet` hands its overflow flags
    and its per-row branch to ``handler(flags, branch, n_rows)`` instead
    of reading the flags and running the branches itself; ``branch(r,
    fallback)`` writes world shard ``r``'s resample in place."""
    global _SPLIT
    prev, _SPLIT = _SPLIT, handler
    try:
        yield
    finally:
        _SPLIT = prev


def _take_rows(x: Tensor, idx: Tensor, out: Tensor | None = None
               ) -> Tensor:
    """``x[w, idx[w, j]]`` for ``x [W, N, ...]``, ``idx [W, K]``; written
    into ``out`` (``[W, K, ...]``, contiguous) when given."""
    w, n = x.shape[:2]
    flat = (idx.long() + n * torch.arange(w, device=idx.device)[:, None])
    rows = x.reshape(w * n, *x.shape[2:])
    if out is None:
        return rows.index_select(0, flat.reshape(-1)).reshape(
            w, idx.shape[1], *x.shape[2:])
    torch.index_select(rows, 0, flat.reshape(-1),
                       out=out.view(w * idx.shape[1], *x.shape[2:]))
    return out


def gather_row(blocks: list, ancestors: Tensor, devices) -> list:
    """The slot-exact cross-shard take of one world shard (the fallback,
    the ``"gather"`` route and the dda/dense resample), written in place
    into ``blocks``, the row's ``[W_loc, P_loc, ...]`` blocks: slot ``j``
    of shard ``t`` takes particle ``ancestors[w, t * p_loc + j]`` of its
    world.  The whole row is gathered once onto each distinct device
    before any block is written."""
    p_loc = blocks[0].shape[1]
    full = {}
    for dev in devices:
        if dev not in full:
            full[dev] = torch.cat([b.to(dev, non_blocking=True)
                                   for b in blocks], dim=1)
    out = []
    for t, dev in enumerate(devices):
        sel = ancestors[:, t * p_loc:(t + 1) * p_loc].to(dev,
                                                         non_blocking=True)
        out.append(_take_rows(full[dev], sel, blocks[t]))
    return out


def _local_first_row(g_blocks, q_blocks, devices, plan, n_shards, p_loc,
                     spill_cap):
    """One world shard's local-first relabel (``resample.py:138-165``),
    written into the row's blocks: each shard publishes its spill window,
    every shard receives the ``[W_loc, S * cap]`` pool and picks each
    slot from its own block or from the pool."""
    local_src, use_pool, pool_sel, pool_base, _ = plan
    wl = g_blocks[0].shape[0]
    window = (pool_base[..., None]
              + torch.arange(spill_cap, dtype=torch.int32,
                             device=pool_base.device))  # [W_loc, S, cap]
    n_pool = n_shards * spill_cap
    outs = []
    for blocks in (g_blocks, q_blocks):
        mine = [_take_rows(b, window[:, t].to(b.device, non_blocking=True))
                for t, b in enumerate(blocks)]
        pools = {}  # the all-gather: one pool per receiving device
        new = []
        for t, dev in enumerate(devices):
            if dev not in pools:
                pools[dev] = torch.stack(
                    [m.to(dev, non_blocking=True) for m in mine],
                    dim=1).reshape(wl, n_pool, *mine[0].shape[2:])
            # the slot's row in [own block; pool], per world
            src = torch.where(use_pool[:, t], p_loc + pool_sel[:, t],
                              local_src[:, t]).to(dev, non_blocking=True)
            new.append(_take_rows(torch.cat([blocks[t], pools[dev]], dim=1),
                                  src, blocks[t]))
        outs.append(new)
    return outs[0], outs[1]


def resample_fleet(grids: Sharded, poses: Sharded, ancestors, mesh: Mesh,
                   spill_cap: int | None = None) -> tuple[Sharded, Sharded]:
    """The mesh-sharded fleet resample (``resample.py:180-216``).

    ``grids`` ``[W, P, H, C]`` and ``poses`` ``[W, P, 3]`` cut over
    ``("world", "particle")``; ``ancestors`` ``[W, P]`` (sorted per world;
    identity where the resample did not fire), a one-device tensor or cut
    over worlds.  Returns the resampled grids and poses, written in place
    into the blocks of ``grids`` and ``poses``: per world the multiset of
    ``take(ancestors)``, relabeled local-first so only spilled unique maps
    cross shards, slot for slot the JAX package's.

    Every world shard's plan is made first; their overflow flags are read
    on the host once (:func:`_read_overflow`), then each world shard takes
    the relabel or, on overflow, the exact gather."""
    n_rows, n_shards = mesh.devices.shape
    p = grids.shape[1]
    if p % n_shards:
        raise ValueError(f"{p} particles do not split over {n_shards} "
                         "particle shards")
    p_loc = p // n_shards
    if spill_cap is None:
        spill_cap = max(1, min(p_loc, 8))
    spill_cap = min(spill_cap, p_loc)
    ancs = [world_part(ancestors, mesh, r) for r in range(n_rows)]

    def branch(r: int, fallback: bool) -> None:
        devices = list(mesh.devices[r])
        g_blocks, q_blocks = grids.blocks[r], poses.blocks[r]
        if fallback:
            gather_row(g_blocks, ancs[r], devices)
            gather_row(q_blocks, ancs[r], devices)
        else:
            _local_first_row(g_blocks, q_blocks, devices, plans[r],
                             n_shards, p_loc, spill_cap)

    if n_shards == 1:  # one shard: a plain take, nothing to decide
        plans = None
        for r in range(n_rows):
            branch(r, True)
    else:
        plans = [_plan(anc, n_shards, p_loc, spill_cap) for anc in ancs]
        dev0 = mesh.first_device
        flags = torch.stack([plan[4].any().to(dev0, non_blocking=True)
                             for plan in plans])
        if _SPLIT is not None:
            _SPLIT(flags, branch, n_rows)
        else:
            for r, fallback in enumerate(_read_overflow(flags)):
                branch(r, fallback)
    return (Sharded(mesh, WORLD_PARTICLE, [list(row) for row in grids.blocks]),
            Sharded(mesh, WORLD_PARTICLE, [list(row) for row in poses.blocks]))
