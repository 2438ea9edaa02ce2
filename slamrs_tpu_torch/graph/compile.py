"""The fused world: simulator + SLAM filters stepped tick by tick.

Counterpart of ``slamrs_tpu/graph/compile.py`` (``FusedWorld``,
``make_fused``, ``compile_world``) for a single world with any
combination of grid SLAM, the ICP point mapper and EKF landmark SLAM.
The simulator's scan and landmark topics feed the filters directly
(``!Splitter`` outputs are aliases of them).  The scan timer is a host
float32 scalar, so the tick loop knows on the host which ticks fire and
never waits for the device.  On a scan tick the lidar scan feeds grid
SLAM and then the ICP mapper, and the landmark scan feeds the EKF; on
the other ticks each filter's previous estimate is carried.  A frame's
ticks (its idle ticks and the scan tick's motion and lidar), a trailing
run of idle ticks and a single tick are each one
``models/simulator.sim_frame`` call a world shard: on the card one
launch of the simulator kernel.

Randomness: one ``torch.Generator`` on the world's device, seeded from
``seed``, gives each scan tick its draws in this order: grid SLAM's
motion and resample draws (``models/gridslam.update``), then the
landmark sensor's bearing noise, then its range noise
(``models/simulator.landmark_scan``).  ICP draws nothing.  So
:meth:`FusedWorld.rollout` and :meth:`FusedWorld.rollout_cadence` draw
the same numbers for the same seed.  On one CUDA device, or on a mesh
whose entries are all one CUDA device, :meth:`FusedWorld.rollout_cadence`
replays each scan frame from captured CUDA graphs and
:meth:`FusedWorld.rollout` each tick (``graph/capture.py``), which draw,
and compute, what the eager loops do.

Fleets: :meth:`FusedWorld.init` with ``worlds=(W,)`` gives ``W`` worlds
on one device, every state field with a leading ``[W]`` axis, as the JAX
package's.  The scan timer stays one shared host scalar and every world
gets the same command, so all worlds scan on the same ticks.  A fleet's
scan tick draws, from the one generator and in this order: grid SLAM's
``eps_c [W, P]``, ``eps_t [W, P]`` and ``u01 [W, 1]``
(``models/gridslam.update_fleet``), then the landmark bearing noise
``[W, L]``, then the range noise ``[W, L]``.  The ``noise=`` and
``landmark_noise=`` arguments take the same shapes behind a leading
frame axis.  Grid SLAM runs through ``update_fleet`` (one fused kernel
launch for the fleet); ICP and the EKF take the worlds as a batch axis.

Sharded fleets (``mesh``, ``parallel/``): :meth:`FusedWorld.step`,
:meth:`~FusedWorld.rollout` and :meth:`~FusedWorld.rollout_cadence`
take a state placed by ``parallel.shard_world_state`` (a FusedWorld with
a mesh places a one-device state on it first).  Each world shard's
simulator, raycast, ICP (K4 at ``b = W_loc``) and EKF run on its row's
first device; grid SLAM goes through ``update_fleet`` on the mesh.  The
draws are made once per frame at the full ``[W, P]`` (and ``[W, L]``)
from the one generator, on the mesh's first device, in the order above,
then sliced to the shards: a seed draws what it draws unsharded.  The
outputs are whole, on the mesh's first device.
"""

from __future__ import annotations

import dataclasses
import math as pymath
from typing import NamedTuple, Optional

import numpy as np
import torch

from slamrs_tpu_torch.core.types import Command, OdometryReading
from slamrs_tpu_torch.graph.config import (Config, ControlsNodeConfig,
                                           EKFLandmarkSlamNodeConfig,
                                           GridMapSlamNodeConfig,
                                           IcpPointMapperNodeConfig,
                                           SimulatorNodeConfig,
                                           SplitterNodeConfig)
from slamrs_tpu_torch.models import ekf as ekf_model
from slamrs_tpu_torch.models import gridslam as gs_model
from slamrs_tpu_torch.models import icp_mapper as icp_model
from slamrs_tpu_torch.models import simulator as sim_model
from slamrs_tpu_torch.parallel import fleet as pf

Tensor = torch.Tensor


class WorldState(NamedTuple):
    """One world's state, or a fleet's with a leading ``[W]`` axis on
    every tensor (the timer and scan counter are shared)."""

    pose: Tensor  # f32[3] ground-truth robot pose
    accum_left: Tensor  # f32[] wheel travel since the last scan
    accum_right: Tensor  # f32[]
    scan_timer: float  # float32-exact host timer
    scan_counter: int
    grid: Optional[gs_model.GridSlamState]
    icp: Optional[icp_model.IcpMapState] = None
    ekf: Optional[ekf_model.EkfState] = None


class WorldOutputs(NamedTuple):
    """Per-tick (:meth:`FusedWorld.rollout`) or per-scan-frame
    (:meth:`FusedWorld.rollout_cadence`) outputs, stacked on dim 0 (a
    fleet's: ``[T, W, ...]``); a filter's field is None when the world
    does not run it."""

    fired: Tensor  # bool[T]
    pose: Tensor  # f32[T, 3] ground truth
    grid_pose: Optional[Tensor]  # f32[T, 3] best-particle pose
    icp_pose: Optional[Tensor]  # f32[T, 3] ICP mapper estimate
    ekf_pose: Optional[Tensor]  # f32[T, 3] EKF mean pose
    n_eff: Optional[Tensor]  # f32[T] (0 on ticks without a scan)


class _Row(NamedTuple):
    fired: bool
    pose: Tensor
    grid_pose: Optional[Tensor]
    icp_pose: Optional[Tensor]
    ekf_pose: Optional[Tensor]
    n_eff: Tensor


def device_draws(noise, landmark_noise, device) -> tuple:
    """Injected draws of every scan frame (arrays with a leading frame
    axis) moved to ``device`` once: grid SLAM's as ``UpdateNoise`` and
    the landmark sensor's ``(noise_a, noise_d)``; None stays None."""
    def moved(draws):
        return None if draws is None else tuple(
            torch.from_numpy(np.array(x)).to(device) for x in draws)

    noise = moved(noise)
    return (None if noise is None else gs_model.UpdateNoise(*noise),
            moved(landmark_noise))


def frame_draws(draws, f: int):
    """Scan frame ``f``'s draws of :func:`device_draws`' ``noise`` or
    ``landmark_noise``, of the same type; None without draws or past
    their last frame."""
    if draws is None or f >= len(draws[0]):
        return None
    picked = [x[f] for x in draws]
    return (gs_model.UpdateNoise(*picked)
            if isinstance(draws, gs_model.UpdateNoise) else tuple(picked))


def _stack_outputs(rows: list, device) -> WorldOutputs:
    def stacked(name):
        vals = [getattr(r, name) for r in rows]
        return None if vals[0] is None else torch.stack(vals)

    has_grid = rows[0].grid_pose is not None
    return WorldOutputs(
        fired=torch.tensor([r.fired for r in rows], dtype=torch.bool,
                           device=device),
        pose=stacked("pose"), grid_pose=stacked("grid_pose"),
        icp_pose=stacked("icp_pose"), ekf_pose=stacked("ekf_pose"),
        n_eff=stacked("n_eff") if has_grid else None)


@dataclasses.dataclass
class FusedWorld:
    """A simulator(+SLAM filters) pipeline on one device.  Build with
    :func:`make_fused` or :func:`compile_world`."""

    scene: sim_model.Scene
    params: sim_model.SimParams
    dt: float
    grid_config: Optional[gs_model.GridSlamConfig]
    control_script: list  # [[until_t, left, right], ...]
    device: torch.device
    num_beams: int = 360
    icp_config: Optional[icp_model.IcpMapConfig] = None
    ekf_config: Optional[ekf_model.EkfConfig] = None
    # a (world, particle) device mesh (parallel/fleet.Mesh) that fleet
    # states run sharded on; None runs a state where it lies
    mesh: Optional[pf.Mesh] = None
    # the last frame-program rollout's graph_capture.CaptureStats
    capture_stats: object = dataclasses.field(default=None, repr=False,
                                              compare=False)
    # the captured rollouts' graph_capture.FrameProgram, kept for the
    # next call on the state the last one returned; not copied by replace()
    frame_program: object = dataclasses.field(default=None, init=False,
                                              repr=False, compare=False)

    def init(self, worlds: tuple[int, ...] = ()) -> WorldState:
        """A fresh state; ``worlds=(W,)`` gives a fleet of W worlds."""
        w = tuple(worlds)
        z = torch.zeros(w, dtype=torch.float32, device=self.device)
        return WorldState(
            pose=torch.zeros((*w, 3), dtype=torch.float32,
                             device=self.device),
            accum_left=z, accum_right=z.clone(), scan_timer=0.0,
            scan_counter=0,
            grid=(gs_model.GridSlamState.init(self.grid_config, self.device,
                                              w)
                  if self.grid_config else None),
            icp=(icp_model.IcpMapState.init(self.icp_config, self.device, w)
                 if self.icp_config else None),
            ekf=(ekf_model.EkfState.init(self.ekf_config, self.device, w)
                 if self.ekf_config else None))

    def _scan_update(self, state: WorldState, scans: list, generator,
                     noise, landmark_noise):
        """The scan tick on ``state`` (pose and odometry already
        advanced): the lidar scan (``scans``, one a world shard, made
        with the motion by ``sim_frame``) feeds grid SLAM, then the ICP
        mapper; the landmark sensor feeds the EKF.  Returns the filters'
        new states and ``(grid_pose, icp_pose, ekf_pose, n_eff)``."""
        mesh = pf.mesh_of(state)
        if mesh is not None:
            return self._scan_update_sharded(state, scans, mesh, generator,
                                             noise, landmark_noise)
        odometry = OdometryReading(state.accum_left, state.accum_right,
                                   self.params.wheel_base)
        grid, icp, ekf = state.grid, state.icp, state.ekf
        grid_pose = icp_pose = ekf_pose = n_eff = None
        scan = scans[0]
        if grid is not None:
            upd = gs_model.update_fleet if state.pose.dim() > 1 \
                else gs_model.update
            grid, gout = upd(grid, scan, odometry, self.grid_config,
                             generator=generator, noise=noise)
            grid_pose, n_eff = gout.pose, gout.n_eff
        if icp is not None:
            icp, iout = icp_model.update(icp, scan, self.icp_config)
            icp_pose = iout.pose
        if ekf is not None:
            noise_a, noise_d = landmark_noise or (None, None)
            landmarks = sim_model.landmark_scan(
                state.pose, self.scene, self.params, generator=generator,
                noise_a=noise_a, noise_d=noise_d)
            ekf, eout = ekf_model.update(ekf, landmarks, odometry,
                                         self.ekf_config)
            ekf_pose = eout.pose
        return grid, icp, ekf, (grid_pose, icp_pose, ekf_pose, n_eff)

    def _scan_update_sharded(self, state: WorldState, scans: list, mesh,
                             generator, noise, landmark_noise):
        """:meth:`_scan_update` of a sharded state: each world shard's
        ICP and EKF on its row's first device, where its lidar scan was
        made, grid SLAM through ``update_fleet`` on the mesh, the landmark
        draws whole on the mesh's first device (after grid SLAM's, in
        ``update_fleet``)."""
        n_rows = mesh.devices.shape[0]
        dev0 = mesh.first_device
        poses = [state.pose.row(r) for r in range(n_rows)]
        grid, icp, ekf = state.grid, state.icp, state.ekf
        grid_pose = icp_pose = ekf_pose = n_eff = None

        def whole(rows):
            return torch.cat([x.to(dev0, non_blocking=True) for x in rows])

        def sharded(rows):
            return pf.from_rows(mesh, rows,
                                pf.tree_map(lambda _: pf.WORLD, rows[0]))

        if grid is not None:
            grid, gout = gs_model.update_fleet(
                grid, sharded(scans),
                OdometryReading(state.accum_left, state.accum_right,
                                self.params.wheel_base),
                self.grid_config, generator=generator, noise=noise)
            grid_pose, n_eff = gout.pose, gout.n_eff
        if icp is not None:
            done = [icp_model.update(pf.rows_of(icp, r), scans[r],
                                     self.icp_config)
                    for r in range(n_rows)]
            icp = sharded([st for st, _ in done])
            icp_pose = whole([out.pose for _, out in done])
        if ekf is not None:
            if landmark_noise is None:  # landmark_scan's draws, whole
                shape = (state.pose.shape[0],
                         self.scene.landmarks.shape[-2])
                landmark_noise = tuple(
                    torch.randn(shape, generator=generator, device=dev0)
                    for _ in range(2))
            done = []
            for r in range(n_rows):
                landmarks = sim_model.landmark_scan(
                    poses[r], self._scene_on(poses[r].device), self.params,
                    noise_a=pf.world_part(landmark_noise[0], mesh, r),
                    noise_d=pf.world_part(landmark_noise[1], mesh, r))
                odometry = OdometryReading(state.accum_left.row(r),
                                           state.accum_right.row(r),
                                           self.params.wheel_base)
                done.append(ekf_model.update(pf.rows_of(ekf, r), landmarks,
                                             odometry, self.ekf_config))
            ekf = sharded([st for st, _ in done])
            ekf_pose = whole([out.pose for _, out in done])
        return grid, icp, ekf, (grid_pose, icp_pose, ekf_pose, n_eff)

    def _scene_on(self, device) -> sim_model.Scene:
        if device == self.scene.segments.device:
            return self.scene
        return sim_model.Scene(*(x.to(device) for x in self.scene))

    def _placed(self, state: WorldState):
        """``(state, mesh)``: the state on the mesh it runs on (this
        world's mesh places a one-device fleet on it), or on one
        device with ``mesh`` None."""
        mesh = pf.mesh_of(state)
        if self.mesh is None or mesh == self.mesh:
            return state, mesh
        if mesh is not None:
            raise ValueError("the state lies on another mesh than the "
                             "FusedWorld's")
        return (pf.shard_world_state(state, self.mesh, state.pose.shape[0]),
                self.mesh)

    def _out_device(self, mesh):
        return self.device if mesh is None else mesh.first_device

    def step(self, state: WorldState, cmd: Command,
             generator: torch.Generator | None = None,
             force_fire: bool = False,
             noise: gs_model.UpdateNoise | None = None,
             landmark_noise: tuple[Tensor, Tensor] | None = None):
        """One dt tick: motion always; the scan tick's filter updates when
        the timer fires (or ``force_fire``).  ``cmd`` holds 0-dim speed
        tensors, the same for every world of a fleet; ``noise`` and
        ``landmark_noise`` (``(noise_a, noise_d)``) replace the
        generator's draws for grid SLAM and the landmark sensor.  Returns
        ``(state, row)`` with ``row`` the tick's ``(fired, pose,
        grid_pose, icp_pose, ekf_pose, n_eff)``.  A sharded state (see the
        module docstring) stays sharded; the row's tensors are whole."""
        return self._ticks(state, Command(cmd.speed_left.reshape(1),
                                          cmd.speed_right.reshape(1)),
                           generator, force_fire, noise, landmark_noise)

    def _ticks(self, state: WorldState, speeds: Command, generator,
               force_fire: bool, noise, landmark_noise):
        """The ticks at ``speeds`` (f32[n] wheel speeds): motion only but
        for the last, which is :meth:`step`'s tick; one
        :func:`~slamrs_tpu_torch.models.simulator.sim_frame` call a world
        shard moves the worlds and, where the last tick fires in a world
        with grid SLAM or ICP, scans the lidar."""
        state, mesh = self._placed(state)
        timer, fired = sim_model.timer_step(state.scan_timer, self.params,
                                            self.dt)
        fired = fired or force_fire or self.params.update_period == 0.0
        lidar = fired and (state.grid is not None or state.icp is not None)
        moved = self._move(state, speeds, mesh, lidar)
        pose, accum_l, accum_r = (_join(mesh, [m[i] for m in moved])
                                  for i in range(3))
        state = state._replace(pose=pose, accum_left=accum_l,
                               accum_right=accum_r)
        grid, icp, ekf = state.grid, state.icp, state.ekf
        if fired:
            grid, icp, ekf, (grid_pose, icp_pose, ekf_pose, n_eff) = \
                self._scan_update(state, [m.scan for m in moved], generator,
                                  noise, landmark_noise)
            accum_l = _join(mesh, [torch.zeros_like(m.accum_left)
                                   for m in moved])
            accum_r = _join(mesh, [torch.zeros_like(m.accum_right)
                                   for m in moved])
        else:  # carry each filter's previous estimate
            grid_pose = _whole(grid.best_pose) if grid is not None else None
            icp_pose = _whole(icp.pose) if icp is not None else None
            ekf_pose = (_whole(ekf.mean)[..., 0:3] if ekf is not None
                        else None)
            n_eff = None
        if n_eff is None:
            n_eff = torch.zeros(pose.shape[:-1], dtype=torch.float32,
                                device=self._out_device(mesh))
        new_state = WorldState(pose=pose, accum_left=accum_l,
                               accum_right=accum_r, scan_timer=timer,
                               scan_counter=state.scan_counter + int(fired),
                               grid=grid, icp=icp, ekf=ekf)
        return new_state, _Row(fired, _whole(pose), grid_pose, icp_pose,
                               ekf_pose, n_eff)

    def _move(self, state: WorldState, speeds: Command, mesh,
              lidar: bool) -> list:
        """:func:`~slamrs_tpu_torch.models.simulator.sim_frame` on each
        world shard's device: the ticks at ``speeds`` and, with
        ``lidar``, the scan from the last pose."""
        moved = []
        for pose, al, ar in _sim_rows(state, mesh):
            dev = pose.device
            moved.append(sim_model.sim_frame(
                pose, al, ar,
                Command(*(c.to(dev, non_blocking=True) for c in speeds)),
                self.params, self.dt,
                self._scene_on(dev) if lidar else None, self.num_beams))
        return moved

    def commands_for(self, n_steps: int) -> Command:
        """The Controls script as per-tick f32 speed tensors: row
        ``[until_t, left, right]`` is active while sim time <= until_t
        (rows sorted by until_t)."""
        left = np.zeros(n_steps, np.float32)
        right = np.zeros(n_steps, np.float32)
        t = (np.arange(n_steps) + 1) * self.dt
        script = sorted(self.control_script, key=lambda row: float(row[0]))
        cur_l = cur_r = 0.0
        for i in range(n_steps):
            for until, l, r in script:
                if t[i] <= until:
                    cur_l, cur_r = float(l), float(r)
                    break
            left[i], right[i] = cur_l, cur_r
        return Command(torch.from_numpy(left).to(self.device),
                       torch.from_numpy(right).to(self.device))

    def _generator(self, seed: int, mesh) -> torch.Generator:
        gen = torch.Generator(device=self._out_device(mesh))
        gen.manual_seed(seed)
        return gen

    def rollout(self, state: WorldState, n_steps: int, seed: int = 0,
                commands: Optional[Command] = None,
                landmark_noise: Optional[tuple] = None,
                noise: Optional[gs_model.UpdateNoise] = None,
                capture: Optional[bool] = None
                ) -> tuple[WorldState, WorldOutputs]:
        """Tick by tick; outputs stacked along the time axis.
        ``noise`` (tests) holds each scan frame's pre-drawn grid-SLAM
        draws and ``landmark_noise`` each scan frame's ``(noise_a,
        noise_d)``, with a leading frame axis, in place of the
        generator's.

        ``capture`` as :meth:`rollout_cadence`'s: where it captures, each
        tick is one replay of an idle tick's or a scan tick's CUDA graph
        (``graph/capture.run_ticks``, the counterpart of
        ``jax.jit(fw.rollout)``), bitwise the eager loop, on the world
        program that the cadence rollout keeps too
        (:attr:`frame_program`); a state handed to it is consumed, as
        there."""
        if self._graphs_for(state, capture, "rollout"):
            from slamrs_tpu_torch.graph import capture as graph_capture

            return graph_capture.run_ticks(self, state, n_steps, seed,
                                           commands, noise, landmark_noise,
                                           graphs=True)
        if commands is None:
            commands = self.commands_for(n_steps)
        state, mesh = self._placed(state)
        gen = self._generator(seed, mesh)
        noise, landmark_noise = device_draws(noise, landmark_noise,
                                             self._out_device(mesh))
        rows = []
        frame = 0
        for i in range(n_steps):
            # the next scan frame's draws (None past the last one)
            state, row = self.step(
                state, Command(commands.speed_left[i], commands.speed_right[i]),
                generator=gen, noise=frame_draws(noise, frame),
                landmark_noise=frame_draws(landmark_noise, frame))
            frame += int(row.fired)
            rows.append(row)
        return state, _stack_outputs(rows, self._out_device(mesh))

    def _graphs_for(self, state: WorldState, capture: Optional[bool],
                    what: str) -> bool:
        """Whether a rollout of ``state`` runs as captured graphs:
        ``capture=None`` where the state lies on one CUDA device or on a
        mesh whose entries are all one CUDA device; True there, raising
        elsewhere (``graph/capture.check_graphs``: a mesh over several
        distinct devices, the CPU); False never."""
        if capture is False:
            return False
        from slamrs_tpu_torch.graph import capture as graph_capture

        mesh = pf.mesh_of(state) if self.mesh is None else self.mesh
        dev = state.pose.device if mesh is None else mesh.first_device
        try:
            graph_capture.check_graphs(mesh, dev, f"{what}(capture=True)")
        except (NotImplementedError, ValueError):
            if capture is True:
                raise
            return False
        return True

    def fire_schedule(self, n_steps: int, timer: float
                      ) -> tuple[np.ndarray, float]:
        """``(fire_idx, timer)``: the ticks of ``n_steps`` that fire from
        the float32 host ``timer``, and the timer after the last tick."""
        dt = np.float32(self.dt)
        period = np.float32(self.params.update_period)
        timer = np.float32(timer)
        fired = np.zeros(n_steps, bool)
        for i in range(n_steps):
            timer = np.float32(timer + dt)
            if timer > period:
                fired[i] = True
                timer = np.float32(timer - period)
        return np.flatnonzero(fired), float(timer)

    def rollout_cadence(self, state: WorldState, n_steps: int, seed: int = 0,
                        commands: Optional[Command] = None,
                        initial_timer: Optional[float] = None,
                        noise: Optional[gs_model.UpdateNoise] = None,
                        landmark_noise: Optional[tuple] = None,
                        capture: Optional[bool] = None
                        ) -> tuple[WorldState, WorldOutputs]:
        """The same ticks as :meth:`rollout`, grouped into frames of idle
        ticks (motion only) followed by one scan tick; outputs are per
        frame (the scan ticks).

        ``noise`` (tests) holds each frame's pre-drawn grid-SLAM draws
        and ``landmark_noise`` each frame's ``(noise_a, noise_d)``, with a
        leading frame axis, in place of the seeded generator's.

        ``capture``: None replays each frame from a captured CUDA graph
        (``graph/capture.py``) when the state lies on one CUDA device or
        on a mesh whose entries are all one CUDA device (a particle-sharded
        ``"local"`` frame is cut at its one overflow read: a head graph,
        each world row's branch graph, a tail graph), and runs the eager
        frame loop on the CPU and on a mesh over several distinct devices;
        False runs the eager loop on any device; True captures, and raises
        on a mesh over several distinct devices (``NotImplementedError``:
        not captured yet) and on the CPU (``ValueError``).  A capture or
        replay that fails raises.  Both draw the same numbers and give the
        same bits.

        The captured route keeps its world program on the world
        (:attr:`frame_program`, which :meth:`rollout` shares): a call
        handed the state the last call returned replays every frame on
        it, with no eager frame and no capture of a graph it holds.  A
        state handed to a captured rollout is consumed, as the fused
        path's in-place updates consume theirs (``models/gridslam.py``):
        the state returned shares its storage, and the old state must not
        be used again.
        """
        if self._graphs_for(state, capture, "rollout_cadence"):
            from slamrs_tpu_torch.graph import capture as graph_capture

            return graph_capture.run_program(
                self, state, n_steps, seed, commands, initial_timer, noise,
                landmark_noise, graphs=True)
        if commands is None:
            commands = self.commands_for(n_steps)
        fire_idx, timer = self.fire_schedule(
            n_steps, state.scan_timer if initial_timer is None
            else initial_timer)
        if fire_idx.size == 0:
            return self.rollout(state, n_steps, seed, commands,
                                capture=False)

        state, mesh = self._placed(state)
        gen = self._generator(seed, mesh)
        noise, landmark_noise = device_draws(noise, landmark_noise,
                                             self._out_device(mesh))
        speeds = torch.stack([commands.speed_left, commands.speed_right])
        rows = []
        start = 0
        for f, e in enumerate(fire_idx):
            state, row = self.frame(
                state, speeds[:, start:e + 1], gen, frame_draws(noise, f),
                frame_draws(landmark_noise, f))
            rows.append(row)
            start = e + 1
        state = self.idle(state, speeds[:, start:], mesh)
        state = state._replace(scan_timer=timer)
        return state, _stack_outputs(rows, self._out_device(mesh))

    def frame(self, state: WorldState, speeds: Tensor,
              generator: torch.Generator | None = None,
              noise: gs_model.UpdateNoise | None = None,
              landmark_noise: tuple[Tensor, Tensor] | None = None
              ) -> tuple[WorldState, _Row]:
        """One frame of :meth:`rollout_cadence`: the idle ticks
        ``speeds[:, :-1]`` (motion only), then the scan tick at
        ``speeds[:, -1]`` with the timer forced to fire, the motion and
        the lidar in one ``sim_frame`` call.  ``speeds`` is f32[2, k + 1],
        the left and right wheel speeds of the frame's ticks.  Returns
        ``(state, row)`` as :meth:`step` does; this is the program that
        ``graph/capture.py`` captures."""
        state = state._replace(
            scan_timer=float(np.float32(self.params.update_period)))
        return self._ticks(state, Command(speeds[0], speeds[1]), generator,
                           True, noise, landmark_noise)

    def idle(self, state: WorldState, speeds: Tensor, mesh=None
             ) -> WorldState:
        """Ticks of motion only, one per column of ``speeds`` (f32[2, k]
        wheel speeds), on each world shard's device: one ``sim_frame``
        call a shard."""
        moved = self._move(state, Command(speeds[0], speeds[1]), mesh, False)
        pose, al, ar = (_join(mesh, [m[i] for m in moved]) for i in range(3))
        return state._replace(pose=pose, accum_left=al, accum_right=ar)


def _sim_rows(state: WorldState, mesh) -> list:
    """``(pose, accum_left, accum_right)`` of each world shard (one row
    for a one-device state)."""
    if mesh is None:
        return [(state.pose, state.accum_left, state.accum_right)]
    return [(state.pose.row(r), state.accum_left.row(r),
             state.accum_right.row(r))
            for r in range(mesh.devices.shape[0])]


def _join(mesh, rows: list):
    """The inverse of :func:`_sim_rows` for one field."""
    if mesh is None:
        return rows[0]
    return pf.Sharded(mesh, pf.WORLD, [[x] for x in rows])


def _whole(x):
    return x.full() if isinstance(x, pf.Sharded) else x


def make_fused(scene: Optional[sim_model.Scene] = None,
               params: Optional[sim_model.SimParams] = None,
               grid_config: Optional[gs_model.GridSlamConfig] = None,
               icp_config: Optional[icp_model.IcpMapConfig] = None,
               ekf_config: Optional[ekf_model.EkfConfig] = None,
               control_script: Optional[list] = None,
               num_beams: int = 360, dt: float = sim_model.DEFAULT_DT,
               mesh: Optional[pf.Mesh] = None, *, device) -> FusedWorld:
    """Programmatic FusedWorld builder (benchmarks, entry points).  The
    default scene is the JAX package's: three rectangles, a line and
    seven landmarks.  With ``mesh``, fleets run sharded over it, and
    ``device`` must be its first device.

    Gives a fused grid config the simulator's static 1-degree beam
    spacing, which selects the static bin-units pipeline of the kernel.
    """
    device = torch.device(device)
    if mesh is not None and pf.canonical_device(device) != mesh.first_device:
        raise ValueError(f"make_fused: device {device} is not the mesh's "
                         f"first device {mesh.first_device}")
    if scene is None:
        scene = sim_model.Scene.build(
            rects=[(-1.0, -1.0, 2.0, 2.0), (-0.1, -0.4, 0.5, 0.1),
                   (-0.6, 0.4, 0.2, 0.5)],
            lines=[(-0.6, -0.4, 0.2, 0.4)],
            landmarks=[(-1.0, -1.0), (1.0, 1.0), (-0.1, -0.4), (-0.6, 0.4),
                       (-0.6, -0.4), (0.6, 0.4), (0.6, -0.4)],
            device=device)
    if params is None:
        params = sim_model.SimParams.make()
    if (grid_config is not None and grid_config.integrate == "fused"
            and grid_config.beam_spacing is None):
        grid_config = dataclasses.replace(grid_config,
                                          beam_spacing=pymath.radians(1.0))
    return FusedWorld(scene=scene, params=params, dt=dt,
                      grid_config=grid_config,
                      control_script=control_script or [[1e9, 0.05, 0.08]],
                      device=device, num_beams=num_beams,
                      icp_config=icp_config, ekf_config=ekf_config,
                      mesh=mesh)


def _scan_topic_aliases(config: Config, source_topic: Optional[str],
                        field: str) -> set[str]:
    """The source topic plus every Splitter output derived from it."""
    aliases = set()
    if source_topic is None:
        return aliases
    aliases.add(source_topic)
    for _, node in config.nodes:
        if isinstance(node, SplitterNodeConfig):
            for s in node.splits:
                _, fields = s if isinstance(s, tuple) else (s.get("_tag"), s)
                if fields.get("input") in aliases and fields.get(field):
                    aliases.add(fields[field])
    return aliases


def compile_world(config: Config, *, device) -> FusedWorld:
    """Resolve the node graph into a FusedWorld on ``device``.

    Unlike :func:`make_fused` this leaves ``beam_spacing`` unset, so the
    kernel derives the spacing from the scan (traced bin pipeline), as the
    JAX package's ``compile_world`` does.
    """
    sim_cfg = None
    script: list = []
    for _, node in config.nodes:
        if isinstance(node, SimulatorNodeConfig):
            sim_cfg = node
        elif isinstance(node, ControlsNodeConfig):
            script = node.script or []
    if sim_cfg is None:
        raise ValueError("fused compilation requires a !Simulator node")

    scan_aliases = _scan_topic_aliases(
        config, sim_cfg.topic_observation_scanner, "scanner")
    lm_aliases = _scan_topic_aliases(
        config, sim_cfg.topic_observation_landmarks, "landmark")
    grid_cfg = icp_cfg = ekf_cfg = None
    for _, node in config.nodes:
        if isinstance(node, GridMapSlamNodeConfig):
            if node.topic_observation_odometry in scan_aliases:
                grid_cfg = node.slam_config()
        elif isinstance(node, IcpPointMapperNodeConfig):
            if node.topic_observation in scan_aliases:
                icp_cfg = node.mapper_config()
        elif isinstance(node, EKFLandmarkSlamNodeConfig):
            if node.topic_observation_landmark in lm_aliases:
                ekf_cfg = node.ekf_config()

    device = torch.device(device)
    return FusedWorld(scene=sim_cfg.build_scene(device),
                      params=sim_model.SimParams.make(**sim_cfg.parameters),
                      dt=sim_model.DEFAULT_DT, grid_config=grid_cfg,
                      control_script=script, device=device,
                      icp_config=icp_cfg, ekf_config=ekf_cfg)
