"""Sharded fleets: a ``(world, particle)`` device mesh and fleet states cut
over it.

Counterpart of ``slamrs_tpu/parallel/fleet.py``.  The JAX package's mesh
is an array of devices that one process drives; so is this one.  Its
entries may repeat: ``[torch.device("cuda:0")] * 8`` is an 8-entry mesh on
one card, and ``[torch.device("cpu")] * 8`` one on the CPU (the tests);
on a host with several cards the entries are ``cuda:0`` .. ``cuda:n-1``.

* the world axis is data parallel: worlds never talk to each other;
* the particle axis cuts each world's particle set: the weights'
  normalization and the resample's choice are made per world on the
  world shard's first device, and the maps move between the particle
  shards only in the resample (``parallel/resample.py``).

A sharded state has the structure of the one-device state, with every
tensor leaf a :class:`Sharded` placed by :func:`fleet_shardings`:
per-particle grid leaves are ``[W_loc, P_loc, ...]`` blocks, one on each
mesh entry's device; leaves sharded by world only live once per world
shard, on that row's first device; the host timer and counter are
replicated Python values.  :func:`unshard_world_state` rebuilds the
one-device state.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

Tensor = torch.Tensor

WORLD = ("world",)
WORLD_PARTICLE = ("world", "particle")
REPLICATED = ()


def canonical_device(dev) -> torch.device:
    """``dev`` as a ``torch.device``, ``cuda`` with its index."""
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """A ``[world, particle]`` array of ``torch.device`` s with the axis
    names ``("world", "particle")``."""

    def __init__(self, devices, axis_names=("world", "particle")):
        rows = [list(row) for row in devices]
        self.devices = np.empty((len(rows), len(rows[0]) if rows else 0),
                                dtype=object)
        for r, row in enumerate(rows):
            for t, dev in enumerate(row):
                self.devices[r, t] = canonical_device(dev)
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def device(self, r: int, t: int = 0) -> torch.device:
        return self.devices[r, t]

    @property
    def first_device(self) -> torch.device:
        return self.devices[0, 0]

    def __eq__(self, other) -> bool:
        return (isinstance(other, Mesh)
                and self.axis_names == other.axis_names
                and self.devices.shape == other.devices.shape
                and all(a == b for a, b in zip(self.devices.flat,
                                               other.devices.flat)))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {self.devices.tolist()})"


def make_mesh(n_devices: Optional[int] = None, particle_axis: int = 1,
              devices=None) -> Mesh:
    """A ``(world, particle)`` mesh over the first ``n_devices`` of
    ``devices`` (default: every visible CUDA device; without one it
    raises, it never falls back to the CPU).  ``particle_axis`` entries of
    each row shard the particles; ``particle_axis=1`` gives a mesh over
    worlds only."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device is visible; pass "
                               "devices= (e.g. [torch.device('cpu')] * 8)")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [canonical_device(d) for d in devices]
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    if n % particle_axis != 0:
        raise ValueError(f"{n} devices not divisible by particle_axis="
                         f"{particle_axis}")
    return Mesh([devices[i:i + particle_axis]
                 for i in range(0, n, particle_axis)])


class Sharded:
    """One fleet tensor cut over a mesh by ``spec``: ``("world",)`` holds a
    ``[W_loc, ...]`` block per world shard on that row's first device
    (``blocks[r] == [tensor]``); ``("world", "particle")`` a ``[W_loc,
    P_loc, ...]`` block per mesh entry (``blocks[r][t]`` on entry ``(r,
    t)``'s device)."""

    __slots__ = ("mesh", "spec", "blocks")

    def __init__(self, mesh: Mesh, spec: tuple, blocks: list):
        self.mesh, self.spec, self.blocks = mesh, spec, blocks

    @staticmethod
    def place(t: Tensor, mesh: Mesh, spec: tuple) -> "Sharded":
        """Copy ``t`` (a one-device ``[W, ...]`` or ``[W, P, ...]``) into
        blocks on the mesh."""
        n_rows, n_cols = mesh.devices.shape
        if spec not in (WORLD, WORLD_PARTICLE):
            raise ValueError(f"no placement for spec {spec}")
        if t.shape[0] % n_rows:
            raise ValueError(f"{t.shape[0]} worlds do not split over "
                             f"{n_rows} world shards")
        wl = t.shape[0] // n_rows

        def copy(x, dev):
            return x.to(dev, copy=True, memory_format=torch.contiguous_format)

        if spec == WORLD:
            return Sharded(mesh, spec, [
                [copy(t[r * wl:(r + 1) * wl], mesh.device(r))]
                for r in range(n_rows)])
        if t.shape[1] % n_cols:
            raise ValueError(f"{t.shape[1]} particles do not split over "
                             f"{n_cols} particle shards")
        pl = t.shape[1] // n_cols
        return Sharded(mesh, spec, [
            [copy(t[r * wl:(r + 1) * wl, c * pl:(c + 1) * pl],
                  mesh.device(r, c)) for c in range(n_cols)]
            for r in range(n_rows)])

    def row(self, r: int) -> Tensor:
        """World shard ``r``'s ``[W_loc, ...]`` block (one particle shard)."""
        if len(self.blocks[r]) != 1:
            raise ValueError("row() of a leaf cut over particles")
        return self.blocks[r][0]

    def full(self, device=None) -> Tensor:
        """The one-device tensor, on ``device`` (default the mesh's first
        device)."""
        dev = self.mesh.first_device if device is None else device
        rows = [[b.to(dev, non_blocking=True) for b in row]
                for row in self.blocks]
        return torch.cat([torch.cat(row, dim=1) if len(row) > 1 else row[0]
                          for row in rows], dim=0)

    @property
    def shape(self) -> tuple:
        first = self.blocks[0][0]
        w = sum(row[0].shape[0] for row in self.blocks)
        if self.spec == WORLD:
            return (w, *first.shape[1:])
        return (w, sum(b.shape[1] for b in self.blocks[0]),
                *first.shape[2:])

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks[0][0].dtype

    @property
    def device(self) -> torch.device:
        return self.mesh.first_device

    def __repr__(self) -> str:
        return (f"Sharded({list(self.shape)}, {self.dtype}, "
                f"spec={self.spec}, mesh={self.mesh.shape})")


def _is_node(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_map(fn, tree, *others):
    """``fn`` over the leaves of named tuples (``None`` fields stay)."""
    if tree is None:
        return None
    if _is_node(tree):
        return type(tree)(*(tree_map(fn, *children)
                            for children in zip(tree, *others)))
    return fn(tree, *others)


def tree_leaves(tree) -> list:
    if tree is None:
        return []
    if _is_node(tree):
        return [leaf for child in tree for leaf in tree_leaves(child)]
    return [tree]


def mesh_of(tree) -> Optional[Mesh]:
    """The mesh of a sharded state (None for a one-device state)."""
    for leaf in tree_leaves(tree):
        if isinstance(leaf, Sharded):
            return leaf.mesh
    return None


def grid_shardings(grid) -> Any:
    """The specs of a fleet's ``GridSlamState`` (``fleet.py:64-86``): a
    tiled state's pool ``[W, n_phys, hb, C]`` is cut over worlds only, its
    band table over worlds and particles."""
    ws, wp = WORLD, WORLD_PARTICLE
    tiled = grid.tile_table is not None
    return type(grid)(poses=wp, grids=ws if tiled else wp, weights=wp,
                      best_pose=ws, best_idx=ws, ancestors=wp,
                      tile_table=wp if tiled else None)


def fleet_shardings(state, mesh: Mesh, worlds: int):
    """The spec of every leaf of a fleet's ``WorldState``, leaf for leaf
    the JAX package's ``PartitionSpec`` s as tuples: the worlds axis ->
    ``"world"``, the particle filter's particle axis -> ``"particle"``,
    the shared timer and counter replicated ``()``."""
    del mesh, worlds  # the structure, not the shapes, fixes the specs

    def world_only(sub):
        return None if sub is None else tree_map(lambda _: WORLD, sub)

    return type(state)(
        pose=WORLD, accum_left=WORLD, accum_right=WORLD,
        scan_timer=REPLICATED, scan_counter=REPLICATED,
        grid=None if state.grid is None else grid_shardings(state.grid),
        icp=world_only(state.icp), ekf=world_only(state.ekf))


def place(tree, mesh: Mesh, specs):
    """Every tensor leaf of ``tree`` placed on ``mesh`` by its spec; host
    values (the replicated timer and counter) stay."""
    return tree_map(lambda leaf, spec: Sharded.place(leaf, mesh, spec)
                    if isinstance(leaf, Tensor) else leaf, tree, specs)


def shard_world_state(state, mesh: Mesh, worlds: int):
    """Place a one-device fleet ``WorldState`` of ``worlds`` worlds onto
    ``mesh`` (copies; the state passed in is left as it was)."""
    if state.pose.shape[0] != worlds:
        raise ValueError(f"the state holds {state.pose.shape[0]} worlds, "
                         f"not {worlds}")
    return place(state, mesh, fleet_shardings(state, mesh, worlds))


def unshard_world_state(sharded, device=None):
    """The one-device state of a sharded one, on ``device`` (default the
    mesh's first device): the counterpart of reading a sharded array."""
    return tree_map(lambda leaf: leaf.full(device)
                    if isinstance(leaf, Sharded) else leaf, sharded)


def rows_of(tree, r: int):
    """World shard ``r`` of a state cut over worlds only: a one-device
    fleet of ``W_loc`` worlds on that row's first device."""
    return tree_map(lambda leaf: leaf.row(r) if isinstance(leaf, Sharded)
                    else leaf, tree)


def from_rows(mesh: Mesh, rows: list, specs):
    """The sharded state whose world shard ``r`` is ``rows[r]`` (one-device
    fleets on each row's first device; a mesh over worlds only)."""
    def leaf(spec, *parts):
        if not isinstance(parts[0], Tensor):
            return parts[0]
        return Sharded(mesh, spec, [[p] for p in parts])
    return tree_map(leaf, specs, *rows)


def world_part(x, mesh: Mesh, r: int, device=None):
    """World shard ``r``'s part of ``x`` on ``device`` (default that row's
    first device): a ``Sharded`` leaf's row block, the rows of a
    one-device ``[W, ...]`` tensor, a 0-dim tensor whole, a Python
    number as it is."""
    dev = mesh.device(r) if device is None else device
    if isinstance(x, Sharded):
        x = x.row(r)
    elif isinstance(x, Tensor) and x.dim():
        wl = x.shape[0] // mesh.devices.shape[0]
        x = x[r * wl:(r + 1) * wl]
    return x.to(dev, non_blocking=True) if isinstance(x, Tensor) else x


def block_part(x, mesh: Mesh, r: int, t: int):
    """Mesh entry ``(r, t)``'s part of ``x`` on its device: a ``Sharded``
    leaf's block, or the world rows and particle columns of a one-device
    ``[W, P, ...]`` tensor."""
    dev = mesh.device(r, t)
    if isinstance(x, Sharded):
        return x.blocks[r][t].to(dev, non_blocking=True)
    n_rows, n_cols = mesh.devices.shape
    wl, pl = x.shape[0] // n_rows, x.shape[1] // n_cols
    return x[r * wl:(r + 1) * wl, t * pl:(t + 1) * pl].to(dev,
                                                          non_blocking=True)


def by_rows(fn, mesh: Mesh, *xs) -> Sharded:
    """``fn`` of each world shard's parts of ``xs`` (see
    :func:`world_part`), cut over worlds."""
    return Sharded(mesh, WORLD, [
        [fn(*(world_part(x, mesh, r) for x in xs))]
        for r in range(mesh.devices.shape[0])])
