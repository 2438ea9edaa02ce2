"""Rao-Blackwellized particle-filter occupancy-grid SLAM.

Counterpart of ``slamrs_tpu/models/gridslam.py``.  Per update: sample a
successor pose per particle from the odometry model, weight it by the
scan's endpoint likelihood on its map and integrate the scan into that
map, add the motion log-probability, then normalize, take the argmax pose
and N_eff, and resample systematically when N_eff falls to
``resample_neff_frac * P``.  Three integrators, as in the JAX package:

- ``fused`` (the throughput path): likelihood and integrate in one kernel
  (:func:`slamrs_tpu_torch.ops.fused.fused_update`), maps ``[P, H, Wp]``
  with 128-padded columns, f32 or bf16; before it, one world's sample,
  motion log-probability and kernel inputs are one more launch
  (:func:`slamrs_tpu_torch.ops.propose.slam_propose`);
- ``dda`` (the default, the fidelity path held against the reference's
  line-by-line oracle) and ``dense``: the likelihood on the old maps at
  the sampled poses (:func:`~slamrs_tpu_torch.ops.grid.grid_log_likelihood`),
  then the DDA walk with its scatter-add
  (:func:`~slamrs_tpu_torch.ops.grid.grid_integrate`) or the windowed
  polar update (:func:`~slamrs_tpu_torch.ops.grid.grid_integrate_dense`)
  of the old maps at the same poses; maps ``f32[P, H, W]`` unpadded,
  whatever ``grid_dtype`` says.  Plain PyTorch: the JAX package computes
  these in plain ``jnp``.

A single-world update on any integrator then weighs and selects in one
more launch (:func:`slamrs_tpu_torch.ops.select.slam_select`: the weight
carry, normalization, argmax, N_eff, the gated systematic resample and
the pose gathers); fleets keep that chain in ATen over ``[W, P]``.

The resample is applied by one of four mechanisms, picked exactly as the
JAX package picks them (:func:`resample_mechanism`):

- ``tiled``: the maps are a tile pool (``resample_cow="tiled"``, or a map
  set over ``_AUTO_TILED_BYTES``); the tiled kernel relabels the band table
  by the pending ``ancestors`` and privatizes touched bands copy on write;
- ``deferred``: the state carries ``ancestors`` pending and the next
  update's kernel reads particle ``i``'s map from ``grids[ancestors[i]]``
  into a fresh buffer;
- ``cow``: the kernel updates the maps in place, then only duplicated
  maps are copied into freed slots (``ops/cow.py``);
- ``gather``: the maps are updated (the fused kernel in place, the dda
  and dense integrators into new tensors), then the whole set is
  gathered by ``ancestors`` (``resample_cow=False``, and every dda and
  dense update).

The mechanism decides the slot order after a resample (copy on write puts
duplicated maps into freed slots), and the injected draws are indexed by
slot, so the port copies the JAX package's choice even where its reasons
(TPU VMEM residency, the TPU's column-cropped windows) mean nothing on the
H100.  In the fused path's ``tiled``, ``cow`` and ``gather`` mechanisms
the update writes the input state's map storage in place: the old state
must not be used again.

Fleets (batched worlds, :func:`update_fleet`): a state with a leading
worlds axis, ``[W, P, ...]``, one scan and odometry reading per world,
on one device, routed as the JAX package's ``update_fleet(mesh=None)``
routes them: the fused integrator updates all ``W*P`` maps with one
kernel launch, then resamples by one copy on write over the flattened
maps (block-diagonal ancestors, world ``w``'s offset by ``w*P``), or by
the whole-set gather or the deferred lineage where the config asks for
the JAX package's slot-exact fallback; the dda and dense integrators run
as one batched call over ``W*P`` particles; tiled pools run the tiled
update once per world, as the JAX package does.

Sharded fleets (``update_fleet(mesh=...)``, ``parallel/``): a fleet cut
over a ``(world, particle)`` mesh, routed as the JAX package's
``update_fleet(mesh=)``.  On a mesh over worlds only, each world shard
runs the one-device fleet update on its own worlds (the flattened copy
on write, or the tiled loop); otherwise every mesh block samples its
particles and runs K1 (or the dda or dense update) on its own maps, each
world shard weighs and selects its worlds on its first device, and the
maps move by the local-first relabel (``fleet_resample="local"``,
``parallel/resample.py``) or the slot-exact gather.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from slamrs_tpu_torch.core import motion
from slamrs_tpu_torch.core.types import OdometryReading, Scan
from slamrs_tpu_torch.ops.cow import cow_resample
from slamrs_tpu_torch.ops.fused import (fits_vmem_resident, fused_update,
                                        supports_deferred_hbm)
from slamrs_tpu_torch.ops.grid import (GridSpec2D, dense_window_for,
                                       grid_integrate, grid_integrate_dense,
                                       grid_log_likelihood)
from slamrs_tpu_torch.ops.propose import Proposal, slam_propose
from slamrs_tpu_torch.ops.select import slam_select, weigh_and_select
from slamrs_tpu_torch.ops.tiles import (fused_update_tiled, init_tiled,
                                        materialize_one)
from slamrs_tpu_torch.parallel import fleet as pf
from slamrs_tpu_torch.parallel.resample import gather_row, resample_fleet
from slamrs_tpu_torch.parallel.shard import fused_update_batched

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class GridSlamConfig:
    """Same fields and defaults as the JAX package's ``GridSlamConfig``.

    ``integrate`` is ``"dda"``, ``"dense"`` or ``"fused"``; another
    value raises ``ValueError``.  ``resample_cow``
    takes ``None`` (auto), ``True``, ``False``, ``"staged"`` and
    ``"tiled"``; ``"deferred"`` (the JAX package's non-aliased band
    kernel, a recorded dead end) raises ``ValueError``.
    ``fused_resident`` picks TPU VMEM residency, which has no counterpart
    here, but it still selects the resample mechanism and so the slot
    order (:func:`resample_mechanism`).  ``fleet_resample`` applies to
    batched worlds (:func:`update_fleet`): ``"gather"`` asks for the
    slot-exact whole-set gather; any other value for the flattened copy
    on write on one device or a mesh over worlds only, and for the
    local-first relabel (``parallel/resample.py``) on a mesh that cuts
    the particles.
    """

    position_x: float = -2.0
    position_y: float = -2.0
    width: float = 4.0
    height: float = 4.0
    resolution: float = 0.02
    n_particles: int = 10
    max_scan_range: float = 1.0
    resample_neff_frac: float = 1.0  # 1.0 == always resample
    integrate: str = "dda"
    grid_dtype: str = "float32"  # or "bfloat16"
    fused_resident: bool | None = None
    resample_cow: bool | str | None = None
    # static beam spacing (radians) of the scan's uniform angle table, or
    # None to derive it from scan.angles (the traced bin pipeline)
    beam_spacing: float | None = None
    fleet_resample: str = "local"

    @property
    def padded_cols(self) -> int:
        c = self.grid_spec.cols
        return (c + 127) // 128 * 128

    @property
    def grid_spec(self) -> GridSpec2D:
        return GridSpec2D(self.position_x, self.position_y, self.width,
                          self.height, self.resolution)

    @property
    def max_ray_steps(self) -> int:
        return self.grid_spec.max_ray_steps(self.max_scan_range)

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.grid_dtype == "bfloat16" \
            else torch.float32


def check_supported(config: GridSlamConfig) -> None:
    """Raise for configuration values the port does not run."""
    if config.integrate not in ("dda", "dense", "fused"):
        raise ValueError(f"integrate must be 'dda', 'dense' or 'fused', got "
                         f"{config.integrate!r}")
    if config.resample_cow == "deferred":
        raise ValueError(
            "resample_cow='deferred' (the JAX package's non-aliased band "
            "kernel, a recorded dead end) is not ported (ROADMAP.md, "
            "'Port coverage'); use None or 'staged'")
    if config.resample_cow not in (None, True, False, "staged", "tiled"):
        raise ValueError(f"resample_cow must be None, True, False, 'staged' "
                         f"or 'tiled', got {config.resample_cow!r} "
                         "(ROADMAP.md, 'Port coverage')")
    if config.grid_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"grid_dtype must be float32 or bfloat16, got "
                         f"{config.grid_dtype!r}")


_AUTO_TILED_BYTES = 1 << 30  # see auto_tiled (module-level for tests)


def auto_tiled(config: GridSlamConfig) -> bool:
    """The JAX package's storage rule (``gridslam.py:134-153``): tile-pool
    maps when the map set is over ``_AUTO_TILED_BYTES`` and
    ``resample_cow`` is left to auto."""
    if config.integrate != "fused" or config.resample_cow is not None:
        return False
    spec = config.grid_spec
    itemsize = 2 if config.grid_dtype == "bfloat16" else 4
    set_bytes = config.n_particles * spec.rows * config.padded_cols \
        * itemsize
    return set_bytes > _AUTO_TILED_BYTES


class GridSlamState(NamedTuple):
    """One world's filter, or a fleet's with a leading ``[W]`` axis on
    every field (a tiled fleet holds one pool and table per world)."""

    poses: Tensor  # f32[P, 3]
    # log-odds: fused [P, H, Wp] f32 or bf16; dda and dense f32[P, H, W]
    grids: Tensor
    weights: Tensor  # f32[P] normalized
    best_pose: Tensor  # f32[3] argmax-weight particle pose
    best_idx: Tensor  # i32[] (0-dim), as the JAX state's
    # pending resample lineage: particle i's map is grids[ancestors[i]]
    # (tiled: tile_table[ancestors[i]]); identity after cow and gather
    ancestors: Tensor  # i32[P]
    # tiled maps only: logical band b of particle i lives in pool tile
    # tile_table[i, b], and ``grids`` is the tile pool [n_phys, hb, Wp]
    tile_table: Tensor | None = None  # i32[P, nb]

    @staticmethod
    def init(config: GridSlamConfig, device,
             worlds: tuple[int, ...] = ()) -> "GridSlamState":
        """A fresh state; ``worlds=(W,)`` gives a fleet of W worlds."""
        check_supported(config)
        w = tuple(worlds)
        p = config.n_particles
        spec = config.grid_spec
        f32 = torch.float32
        tile_table = None
        if config.integrate != "fused":
            grids = torch.zeros((*w, p, spec.rows, spec.cols), dtype=f32,
                                device=device)
        elif config.resample_cow == "tiled" or auto_tiled(config):
            grids, tile_table = init_tiled(p, spec, config.max_scan_range,
                                           config.torch_dtype, device=device)
            # one pool and table per world (gridslam.py:185-191)
            grids = grids.expand(*w, *grids.shape).contiguous()
            tile_table = tile_table.expand(*w, *tile_table.shape).contiguous()
        else:
            grids = torch.zeros((*w, p, spec.rows, config.padded_cols),
                                dtype=config.torch_dtype, device=device)
        return GridSlamState(
            poses=torch.zeros((*w, p, 3), dtype=f32, device=device),
            grids=grids,
            weights=torch.full((*w, p), 1.0 / p, dtype=f32, device=device),
            best_pose=torch.zeros((*w, 3), dtype=f32, device=device),
            best_idx=torch.zeros(w, dtype=torch.int32, device=device),
            ancestors=torch.arange(p, dtype=torch.int32, device=device)
            .expand(*w, p).contiguous(),
            tile_table=tile_table)


class GridSlamOutputs(NamedTuple):
    pose: Tensor  # f32[3] estimated pose
    n_eff: Tensor  # f32[] effective particle count
    resampled: Tensor  # bool[]


class UpdateNoise(NamedTuple):
    """Pre-drawn randomness for one :func:`update` call (a fleet's:
    ``[W, P]``, ``[W, P]`` and ``[W, 1]``)."""

    eps_c: Tensor  # f32[P] motion center draws (standard normal)
    eps_t: Tensor  # f32[P] motion theta draws
    u01: Tensor  # f32[1] systematic-resample offset, U[0, 1)


def draw_noise(generator: torch.Generator, p: int, device,
               worlds: tuple[int, ...] = ()) -> UpdateNoise:
    """One update's draws from ``generator`` (on ``device``), in this
    order: ``eps_c``, ``eps_t``, ``u01``, each over ``worlds``."""
    eps_c = torch.randn((*worlds, p), generator=generator, device=device)
    eps_t = torch.randn((*worlds, p), generator=generator, device=device)
    u01 = torch.rand((*worlds, 1), generator=generator, device=device)
    return UpdateNoise(eps_c, eps_t, u01)


def resample_mechanism(config: GridSlamConfig, state: GridSlamState) -> str:
    """``"tiled"``, ``"deferred"``, ``"cow"`` or ``"gather"``: the JAX
    package's choice for this config and state (``gridslam.py:320-385``,
    ``:439-441``, ``:471-478``), line for line, with its errors.  The dda
    and dense integrators always gather."""
    if state.tile_table is not None and (
            config.integrate != "fused"
            or config.resample_cow not in (None, "tiled")):
        raise ValueError("state has a tile_table but the config does not "
                         "accept tiled maps (integrate='fused' with "
                         "resample_cow None or 'tiled')")
    if config.resample_cow == "tiled" and state.tile_table is None:
        raise ValueError("config pins resample_cow='tiled' but the state has "
                         "no tile pool: init with the same config")
    if state.tile_table is not None:
        return "tiled"
    if config.integrate != "fused":
        return "gather"
    rows, cols = state.grids.shape[-2:]
    grid_bytes = state.grids.numel() * state.grids.element_size()
    resident = (config.fused_resident if config.fused_resident is not None
                else fits_vmem_resident(grid_bytes))
    hbm_ok = supports_deferred_hbm(config.grid_spec, config.max_scan_range,
                                   rows, cols)
    if config.resample_cow == "staged" and not resident and not hbm_ok:
        raise ValueError("resample_cow='staged' pinned but the geometry does "
                         "not support the lineage kernel (needs full-width "
                         "windows and wr >= rows - wr)")
    if resident or (config.resample_cow in (None, "staged") and hbm_ok):
        return "deferred"
    return "gather" if config.resample_cow is False else "cow"


def _propose(state: GridSlamState, scan: Scan, odometry: OdometryReading,
             config: GridSlamConfig, noise: UpdateNoise) -> Proposal:
    """The fused path's sampled poses, motion log-probability and kernel
    inputs (one launch on the card, :func:`~slamrs_tpu_torch.ops.propose.
    slam_propose`), for the rows the kernel clamps its windows to: the
    maps', or a tile pool's bands times their rows."""
    rows, cols = state.grids.shape[-2:]
    if state.tile_table is not None:
        rows *= state.tile_table.shape[-1]
    return slam_propose(state.poses, odometry, (noise.eps_c, noise.eps_t),
                        scan, config.grid_spec, config.max_scan_range,
                        config.beam_spacing, rows, cols)


def _fused_integrate(state: GridSlamState, proposal: Proposal, scan: Scan,
                     config: GridSlamConfig, mechanism: str):
    """The fused kernel under ``mechanism`` on the proposal's prepared
    inputs: ``(grids, tile_table, log_lik)``."""
    args = (proposal.poses, scan.angles[0], scan.distances, scan.valid,
            scan.present, config.grid_spec, scan.angles.shape[-1],
            config.max_scan_range)
    if mechanism == "tiled":
        return fused_update_tiled(state.grids, state.tile_table, *args,
                                  ancestors=state.ancestors,
                                  prep=proposal.prep)
    if mechanism == "deferred":
        grids, log_lik = fused_update(state.grids, *args,
                                      ancestors=state.ancestors,
                                      prep=proposal.prep)
    else:
        grids, log_lik = fused_update(state.grids, *args, in_place=True,
                                      prep=proposal.prep)
    return grids, None, log_lik


def update(state: GridSlamState, scan: Scan, odometry: OdometryReading,
           config: GridSlamConfig, generator: torch.Generator | None = None,
           noise: UpdateNoise | None = None
           ) -> tuple[GridSlamState, GridSlamOutputs]:
    """One SLAM update.  Randomness comes from ``noise`` (tests inject the
    JAX package's draws) or else from ``generator``.  On the fused path
    the ``tiled``, ``cow`` and ``gather`` mechanisms update ``state``'s
    map storage in place (see the module docstring)."""
    check_supported(config)
    mechanism = resample_mechanism(config, state)
    p = config.n_particles
    dev = state.poses.device
    if noise is None:
        if generator is None:
            raise ValueError("update needs noise or a generator")
        noise = draw_noise(generator, p, dev)

    tile_table = None
    if config.integrate == "fused":
        proposal = _propose(state, scan, odometry, config, noise)
        new_poses, log_motion = proposal.poses, proposal.log_motion
        grids, tile_table, log_lik = _fused_integrate(state, proposal, scan,
                                                      config, mechanism)
    else:
        new_poses = motion.sample(state.poses, odometry.distance_left,
                                  odometry.distance_right,
                                  odometry.wheel_base,
                                  eps=(noise.eps_c, noise.eps_t))
        # the likelihood on the old maps at the sampled poses, then the
        # old maps integrated at the same poses (gridslam.py:401-416);
        # dense takes its beam spacing from scan.angles
        spec = config.grid_spec
        lik_args = (spec, new_poses, scan.angles, scan.distances,
                    scan.valid, scan.present)
        log_lik = grid_log_likelihood(state.grids, *lik_args)
        if config.integrate == "dense":
            grids = grid_integrate_dense(
                state.grids, *lik_args,
                dense_window_for(spec, config.max_scan_range))
        else:
            grids = grid_integrate(state.grids, *lik_args,
                                   config.max_ray_steps)
        log_motion = motion.log_prob(state.poses, new_poses,
                                     odometry.distance_left,
                                     odometry.distance_right,
                                     odometry.wheel_base)

    # one launch on the card (ops/select.py); cow takes the poses ungathered
    sel = slam_select(state.weights, log_lik, log_motion, noise.u01,
                      new_poses, config.resample_neff_frac,
                      gather=mechanism != "cow")
    pending = sel.ancestors
    if mechanism == "cow":
        # slot-preserving copy on write: only duplicated maps move
        new_poses, grids = cow_resample(grids, new_poses, sel.ancestors)
        pending = torch.arange(p, dtype=torch.int32, device=dev)
    elif mechanism == "gather":
        # always gathered: identity ancestors give the same values, and a
        # host branch on do_resample would wait for the device
        new_poses = sel.poses
        grids = grids.index_select(0, sel.ancestors.long())
        pending = torch.arange(p, dtype=torch.int32, device=dev)
    else:  # tiled, deferred: applied by the next update's kernel
        new_poses = sel.poses
    new_state = GridSlamState(
        poses=new_poses, grids=grids, weights=sel.weights,
        best_pose=sel.best_pose, best_idx=sel.best_idx, ancestors=pending,
        tile_table=tile_table)
    return new_state, GridSlamOutputs(pose=sel.best_pose, n_eff=sel.n_eff,
                                      resampled=sel.do_resample)


def _per_world(v):
    """An odometry field of a fleet as ``[W, 1]`` (a world's value for
    each of its particles); a scalar stays."""
    return v[:, None] if isinstance(v, Tensor) and v.dim() else v


def _world(tup, i: int):
    """World ``i`` of a fleet's named tuple (a scalar field is shared)."""
    return type(tup)(*(v[i] if isinstance(v, Tensor) and v.dim() else v
                       for v in tup))


def _take_particles(poses: Tensor, idx: Tensor) -> Tensor:
    """``poses[w, idx[w, ...]]`` for ``poses [W, P, 3]``, ``idx [W, K]``."""
    return torch.gather(poses, 1, idx.long()[..., None].expand(
        *idx.shape, poses.shape[-1]))


def update_fleet(state: GridSlamState, scan: Scan,
                 odometry: OdometryReading, config: GridSlamConfig,
                 generator: torch.Generator | None = None,
                 noise: UpdateNoise | None = None, mesh=None
                 ) -> tuple[GridSlamState, GridSlamOutputs]:
    """One SLAM update of every world of a fleet on one device
    (``slamrs_tpu/models/gridslam.py:493-652`` with ``mesh=None``).

    ``state`` holds ``W`` worlds (:meth:`GridSlamState.init` with
    ``worlds=(W,)``); ``scan`` is ``[W, B]``, one per world; odometry
    ``[W]`` (or a scalar shared by every world).  Randomness comes from
    ``noise`` (``[W, P]``, ``[W, P]``, ``[W, 1]``; tests inject the JAX
    package's per-world draws) or else from ``generator``
    (:func:`draw_noise`).  The routes, as the JAX package's:

    - tiled pools: the tiled update once per world (its copy-on-write
      plan is per pool);
    - dda and dense: one call over the ``W*P`` particles, each world's
      scan repeated for its particles, then the whole-set gather;
    - fused with ``resample_cow=False``, ``fused_resident=True`` or
      ``fleet_resample="gather"``: the JAX package's slot-exact fallback
      (``resample_cow=False``, ``fused_resident`` False unless set): one
      in-place kernel launch and the whole-set gather, or with
      ``fused_resident=True`` the deferred lineage, read by the next
      update's launch through the flattened block-diagonal ancestors;
    - fused otherwise: one in-place kernel launch over the ``W*P`` maps,
      then one copy on write over them (``cow_plan`` keeps every copy's
      source and destination in one world block).

    The fused launch covers the whole fleet; on a CUDA tensor it launches
    or raises.  The fused and tiled routes update ``state``'s map storage
    in place, as :func:`update` does.

    A sharded state (``parallel.shard_world_state``), or a ``mesh`` (the
    state is then placed on it first), takes the mesh routes of
    :func:`_update_fleet_sharded`; the draws are made as above on the
    mesh's first device and sliced to the blocks, so a seed draws what it
    draws unsharded.  The outputs come back whole on the mesh's first
    device."""
    check_supported(config)
    state_mesh = pf.mesh_of(state)
    if mesh is not None and state_mesh is not None and mesh != state_mesh:
        raise ValueError("update_fleet: the state lies on another mesh")
    mesh = mesh if mesh is not None else state_mesh
    w, p = state.poses.shape[0], config.n_particles
    dev = state.poses.device
    if tuple(state.poses.shape) != (w, p, 3):
        raise ValueError(f"a fleet state has poses [W, {p}, 3], got "
                         f"{list(state.poses.shape)}")
    if noise is None:
        if generator is None:
            raise ValueError("update_fleet needs noise or a generator")
        noise = draw_noise(generator, p, dev, worlds=(w,))
    if mesh is not None:
        if state_mesh is None:
            state = pf.place(state, mesh, pf.grid_shardings(state))
        return _update_fleet_sharded(state, scan, odometry, config, noise,
                                     mesh)
    if state.tile_table is not None:
        return _update_fleet_tiled(state, scan, odometry, config, noise)
    if config.integrate != "fused":
        cfg = config
    elif (config.resample_cow is False or config.fused_resident is True
            or config.fleet_resample == "gather"):
        cfg = dataclasses.replace(
            config, resample_cow=False,
            fused_resident=(False if config.fused_resident is None
                            else config.fused_resident))
    else:
        cfg = dataclasses.replace(config, resample_cow=True,
                                  fused_resident=False)
    # the JAX package decides per world (vmap traces one world's slice)
    mechanism = resample_mechanism(cfg, state._replace(grids=state.grids[0]))

    def flat(t):
        return t.reshape(w * p, *t.shape[2:])

    new_poses = motion.sample(
        state.poses, _per_world(odometry.distance_left),
        _per_world(odometry.distance_right), _per_world(odometry.wheel_base),
        eps=(noise.eps_c, noise.eps_t))
    offsets = (p * torch.arange(w, dtype=torch.int32, device=dev))[:, None]
    grids = flat(state.grids)
    nb = scan.angles.shape[-1]
    if config.integrate == "fused":
        if config.beam_spacing is not None:
            dphi = config.beam_spacing
        elif nb > 1:
            dphi = scan.angles[:, 1] - scan.angles[:, 0]
        else:
            dphi = torch.full((), 2.0 * torch.pi, dtype=torch.float32,
                              device=dev)
        args = (flat(new_poses), scan.angles[:, 0], scan.distances,
                scan.valid, scan.present, config.grid_spec, nb,
                config.max_scan_range)
        if mechanism == "deferred":
            grids, log_lik = fused_update(
                grids, *args, dphi=dphi,
                ancestors=flat(state.ancestors + offsets))
        else:
            grids, log_lik = fused_update(grids, *args, dphi=dphi,
                                          in_place=True)
    else:
        spec = config.grid_spec

        def rows(t):  # each world's scan, once per particle
            return flat(t[:, None].expand(w, p, *t.shape[1:]))

        lik_args = (spec, flat(new_poses), rows(scan.angles),
                    rows(scan.distances), rows(scan.valid),
                    rows(scan.present))
        log_lik = grid_log_likelihood(grids, *lik_args)
        if config.integrate == "dense":
            grids = grid_integrate_dense(
                grids, *lik_args,
                dense_window_for(spec, config.max_scan_range))
        else:
            grids = grid_integrate(grids, *lik_args, config.max_ray_steps)
    log_motion = motion.log_prob(
        state.poses, new_poses, _per_world(odometry.distance_left),
        _per_world(odometry.distance_right), _per_world(odometry.wheel_base))

    weights, ancestors, best_idx, n_eff, do_resample = weigh_and_select(
        log_lik.reshape(w, p), log_motion, state.weights,
        config.resample_neff_frac, p, noise.u01)
    best_pose = _take_particles(new_poses, best_idx[:, None])[:, 0]
    identity = torch.arange(p, dtype=torch.int32, device=dev).expand(w, p)
    pending = identity
    if mechanism == "cow":
        # one slot-preserving copy on write over the flattened maps
        poses, grids = cow_resample(grids, flat(new_poses),
                                    flat(ancestors + offsets))
        new_poses = poses.reshape(w, p, 3)
    elif mechanism == "gather":
        new_poses = _take_particles(new_poses, ancestors)
        grids = grids.index_select(0, flat(ancestors + offsets).long())
    else:  # deferred: applied by the next update's launch
        new_poses = _take_particles(new_poses, ancestors)
        pending = ancestors
    new_state = GridSlamState(
        poses=new_poses, grids=grids.reshape(state.grids.shape),
        weights=weights, best_pose=best_pose, best_idx=best_idx,
        ancestors=pending.contiguous())
    return new_state, GridSlamOutputs(pose=best_pose, n_eff=n_eff,
                                      resampled=do_resample)


def _parts(tup, part):
    """A named tuple's fields through ``part`` (None stays)."""
    return type(tup)(*(None if v is None else part(v) for v in tup))


def _whole(outs: list, device) -> GridSlamOutputs:
    """Per-world-shard outputs joined on ``device``."""
    return GridSlamOutputs(*(torch.cat([o[i].to(device, non_blocking=True)
                                        for o in outs])
                             for i in range(len(GridSlamOutputs._fields))))


def _update_fleet_sharded(state: GridSlamState, scan: Scan,
                          odometry: OdometryReading, config: GridSlamConfig,
                          noise: UpdateNoise, mesh
                          ) -> tuple[GridSlamState, GridSlamOutputs]:
    """A sharded fleet's update (``gridslam.py:515-593``, ``:668-676``).
    ``noise`` is whole on the mesh's first device; ``scan`` and
    ``odometry`` are whole or cut over worlds.

    - tiled pools, on a mesh over worlds only: the tiled loop once per
      world inside each world shard (K3); with particle shards it raises,
      as the JAX package does;
    - fused on a mesh over worlds only, unless ``resample_cow=False``,
      ``fused_resident=True`` or ``fleet_resample="gather"``: the
      one-device fleet update (K1 in place, then K2) on each world
      shard's worlds; ``cow_plan`` keeps every copy in its world, so the
      slots are the unsharded fleet's;
    - otherwise (fused, dda, dense) :func:`_update_fleet_blocks`."""
    n_rows, n_cols = mesh.devices.shape
    if state.tile_table is not None and n_cols != 1:
        raise ValueError("tiled fleets shard over worlds only (the tile "
                         "pool and its CoW plan are per-world)")
    if state.tile_table is None and not (
            config.integrate == "fused" and n_cols == 1
            and config.resample_cow is not False
            and config.fused_resident is not True
            and config.fleet_resample != "gather"):
        return _update_fleet_blocks(state, scan, odometry, config, noise,
                                    mesh)
    rows, outs = [], []
    for r in range(n_rows):
        def part(x):
            return pf.world_part(x, mesh, r)

        st, out = update_fleet(pf.rows_of(state, r), _parts(scan, part),
                               _parts(odometry, part), config,
                               noise=_parts(noise, part))
        rows.append(st)
        outs.append(out)
    return (pf.from_rows(mesh, rows, pf.grid_shardings(state)),
            _whole(outs, mesh.first_device))


def _update_fleet_blocks(state: GridSlamState, scan: Scan,
                         odometry: OdometryReading, config: GridSlamConfig,
                         noise: UpdateNoise, mesh
                         ) -> tuple[GridSlamState, GridSlamOutputs]:
    """The mesh route over particle blocks (``gridslam.py:538-593``):
    each block samples its particles' poses, runs K1 in place on its
    maps (:func:`~slamrs_tpu_torch.parallel.shard.fused_update_batched`),
    or the dda or dense likelihood and integrate, and the motion
    log-probability; each world shard gathers its ``[W_loc, P]``
    likelihoods on its first device and weighs and selects there, over
    the whole particle set; the maps are resampled by the local-first
    relabel (fused, ``"local"``, more than one particle shard) or by the
    slot-exact gather across the shards (dda and dense always: the JAX
    package runs them as ``vmap(update)``)."""
    n_rows, n_cols = mesh.devices.shape
    p = config.n_particles
    spec = config.grid_spec
    wp = pf.WORLD_PARTICLE

    def blocks(fn):
        return pf.Sharded(mesh, wp, [[fn(r, t) for t in range(n_cols)]
                                     for r in range(n_rows)])

    def odo(r, t):
        return [_per_world(pf.world_part(v, mesh, r, mesh.device(r, t)))
                for v in odometry]

    new_poses = blocks(lambda r, t: motion.sample(
        state.poses.blocks[r][t], *odo(r, t),
        eps=(pf.block_part(noise.eps_c, mesh, r, t),
             pf.block_part(noise.eps_t, mesh, r, t))))
    log_motion = blocks(lambda r, t: motion.log_prob(
        state.poses.blocks[r][t], new_poses.blocks[r][t], *odo(r, t)))
    nb = scan.angles.shape[-1]
    if config.integrate == "fused":
        dphi = (pf.by_rows(lambda a: a[:, 1] - a[:, 0], mesh, scan.angles)
                if nb > 1 else torch.full((), 2.0 * torch.pi,
                                          dtype=torch.float32,
                                          device=mesh.first_device))
        grids, log_lik = fused_update_batched(
            state.grids, new_poses, pf.by_rows(lambda a: a[:, 0], mesh,
                                               scan.angles),
            scan.distances, scan.valid, scan.present, spec, nb,
            config.max_scan_range, dphi, mesh=mesh,
            dphi_static=config.beam_spacing)
    else:
        maps, liks = [], []
        for r in range(n_rows):
            maps.append([])
            liks.append([])
            for t in range(n_cols):
                g = state.grids.blocks[r][t]
                wl, pl = g.shape[:2]

                def rows(x):  # each world's scan, once per particle
                    x = pf.world_part(x, mesh, r, g.device)
                    return x[:, None].expand(wl, pl, *x.shape[1:]).reshape(
                        wl * pl, *x.shape[1:])

                flat = g.reshape(wl * pl, *g.shape[2:])
                args = (spec, new_poses.blocks[r][t].reshape(wl * pl, 3),
                        rows(scan.angles), rows(scan.distances),
                        rows(scan.valid), rows(scan.present))
                liks[r].append(grid_log_likelihood(flat, *args)
                               .reshape(wl, pl))
                if config.integrate == "dense":
                    new = grid_integrate_dense(
                        flat, *args,
                        dense_window_for(spec, config.max_scan_range))
                else:
                    new = grid_integrate(flat, *args, config.max_ray_steps)
                maps[r].append(new.reshape(g.shape))
        grids, log_lik = pf.Sharded(mesh, wp, maps), pf.Sharded(mesh, wp, liks)

    weights, ancestors, best_pose, best_idx, outs = [], [], [], [], []
    for r in range(n_rows):
        dev0 = mesh.device(r)

        def joined(x):  # the world shard's [W_loc, P, ...] on dev0
            return torch.cat([b.to(dev0, non_blocking=True)
                              for b in x.blocks[r]], dim=1)

        w_r, anc, idx, n_eff, fired = weigh_and_select(
            joined(log_lik), joined(log_motion), joined(state.weights),
            config.resample_neff_frac, p,
            pf.world_part(noise.u01, mesh, r))
        pl = p // n_cols
        weights.append([w_r[:, t * pl:(t + 1) * pl].to(
            mesh.device(r, t), non_blocking=True).contiguous()
            for t in range(n_cols)])
        ancestors.append(anc)
        best_idx.append([idx])
        best_pose.append([_take_particles(joined(new_poses),
                                          idx[:, None])[:, 0]])
        outs.append(GridSlamOutputs(best_pose[-1][0], n_eff, fired))

    if (config.integrate == "fused" and config.fleet_resample == "local"
            and n_cols > 1):
        grids, new_poses = resample_fleet(
            grids, new_poses,
            pf.Sharded(mesh, pf.WORLD, [[a] for a in ancestors]), mesh)
    else:
        grids, new_poses = (
            pf.Sharded(mesh, wp, [gather_row(x.blocks[r], ancestors[r],
                                             list(mesh.devices[r]))
                                  for r in range(n_rows)])
            for x in (grids, new_poses))
    pl = p // n_cols
    identity = blocks(lambda r, t: torch.arange(
        t * pl, (t + 1) * pl, dtype=torch.int32, device=mesh.device(r, t))
        .expand(state.poses.blocks[r][t].shape[0], pl).contiguous())
    new_state = GridSlamState(
        poses=new_poses, grids=grids, weights=pf.Sharded(mesh, wp, weights),
        best_pose=pf.Sharded(mesh, pf.WORLD, best_pose),
        best_idx=pf.Sharded(mesh, pf.WORLD, best_idx), ancestors=identity)
    return new_state, _whole(outs, mesh.first_device)


def _update_fleet_tiled(state: GridSlamState, scan: Scan,
                        odometry: OdometryReading, config: GridSlamConfig,
                        noise: UpdateNoise
                        ) -> tuple[GridSlamState, GridSlamOutputs]:
    """A tiled fleet: :func:`update` once per world, as the JAX package's
    world loop (``gridslam.py:655-694``).  Each world's update writes its
    pool, a view into ``state.grids``, in place."""
    states, outs = [], []
    for i in range(state.poses.shape[0]):
        st, out = update(_world(state, i), _world(scan, i),
                         _world(odometry, i), config,
                         noise=_world(noise, i))
        states.append(st)
        outs.append(out)
    stacked = GridSlamState(*(
        state.grids if name == "grids"
        else torch.stack([getattr(st, name) for st in states])
        for name in GridSlamState._fields))
    return stacked, GridSlamOutputs(
        *(torch.stack(v) for v in zip(*outs)))


def estimated_probability_grid(state: GridSlamState,
                               config: GridSlamConfig | None = None
                               ) -> Tensor:
    """Occupancy probabilities of the best particle's map
    (``gridslam.py:697-727``), ``[W, H, W]`` for a fleet.  A tiled state
    gathers one map's tiles through the pending lineage,
    ``tile_table[ancestors[best_idx]]``.  With ``config`` the padded rows
    and columns are sliced off."""
    if state.best_idx.dim():  # a fleet: each world's best map
        return torch.stack([estimated_probability_grid(_world(state, i),
                                                       config)
                            for i in range(state.best_idx.shape[0])])
    best = state.best_idx.reshape(1)
    if state.tile_table is not None:
        slot = state.ancestors.index_select(0, best).long()
        grid = materialize_one(state.grids,
                               state.tile_table.index_select(0, slot)[0])
    else:
        grid = state.grids.index_select(0, best)[0]
    if config is not None:
        grid = grid[:config.grid_spec.rows, :config.grid_spec.cols]
    return 1.0 - 1.0 / (1.0 + torch.exp(grid.float()))
