"""The cadence rollout as captured CUDA graphs, one replay a frame.

Counterpart of the JAX package's compiled rollout: ``jax.jit`` over a
``lax.scan`` of frames in ``FusedWorld.rollout_cadence``
(``slamrs_tpu/graph/compile.py:313-432``).  The eager loop issues some
50 host launches a grid tick and 200 an ICP tick; here each scan frame
(``FusedWorld.frame``: ``k`` idle ticks, then the scan tick with K1-K4
inside) is one ``torch.cuda.CUDAGraph`` replay.

The frame program (:class:`FrameProgram`) is ``FusedWorld.frame`` on
static buffers:

* the world state: every tensor leaf of ``WorldState``.  The first frame
  runs eagerly on the caller's state and its result becomes the static
  state.  A leaf that a frame writes as a fresh tensor (K1's lineage
  maps, the dda and dense maps, poses, weights, the ICP map) is copied
  back into its static leaf by the program's last nodes; a leaf that the
  route updates in place (K1 in place, K2, K3's tile pool, a fleet's
  maps) is not copied;
* the frame's wheel speeds, ``f32[2, k + 1]``, filled with ``copy_``
  before each replay;
* injected draws (``noise=``, ``landmark_noise=``): every frame's moved
  to the device once, the frame's copied into the static draw buffers
  before each replay;
* the outputs ``[F, ...]``, written at a frame index held on the device
  and advanced by the program.

The host resolves the timer before the loop (``FusedWorld.
fire_schedule``), so a frame holds no data-dependent control flow.  A
graph is captured for each idle count ``k`` that occurs again later in
the rollout; the first frame (on the caller's state) and, after it, the
first frame with a given ``k`` run eagerly on the capture stream.  That
warm-up is a real frame of the rollout, run by the very program that is
then captured: it consumes the run's own draws, and the capture itself
draws nothing.  The graphs share one memory pool and live for one call; the
state returned holds ordinary tensors (the static buffers).  Trailing
idle ticks after the last scan run eagerly.

Draws: the world's ``torch.Generator`` is registered with every graph,
so a replay draws what the eager frame would (the generator's offset
advances by the graph's whole increment).  Seeded and injected runs
give the eager loop's bits.

The rollout runs on one side stream per device (:func:`capture_stream`),
after the caller's stream's work, and the caller's stream waits for it
at the end.

Launch counters: the kernel wrappers count in Python, so a capture
would count once and a replay never.  Each graph keeps the counts its
capture made (:func:`launch_counts`), the counters are put back after
capture, and every replay adds them: the counters keep meaning kernels
run on the card.  K4's arrival counters are per ``(device, stream)``
(``ops/icp.py``); the first frame runs on the capture stream and makes
that stream's set, which the kernel leaves at zero, so every replay
starts clean.

No fallback: a capture or replay that fails raises.  ``graphs=False``
runs the same program without capturing it (the CPU tests).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from slamrs_tpu_torch.models import gridslam as gs_model
from slamrs_tpu_torch.parallel import fleet as pf

Tensor = torch.Tensor

_OUT_FIELDS = ("pose", "grid_pose", "icp_pose", "ekf_pose", "n_eff")


def launch_counters() -> dict:
    """The launch counter of every kernel wrapper, by name:
    ``(function, attribute)``."""
    from slamrs_tpu_torch.ops import cow, fused, icp, tiles

    return {"fused_update": (fused.fused_update, "launches"),
            "fused_update_in_place": (fused.fused_update,
                                      "in_place_launches"),
            "cow_copy": (cow.cow_copy, "launches"),
            "fused_update_tiled": (tiles.fused_update_tiled, "launches"),
            "nn_argmin": (icp.nearest_neighbors_fused, "launches")}


def launch_counts() -> dict:
    """Every wrapper's launch count, by name."""
    return {name: getattr(fn, attr)
            for name, (fn, attr) in launch_counters().items()}


def _add_counts(delta: dict, sign: int = 1) -> None:
    for name, (fn, attr) in launch_counters().items():
        setattr(fn, attr, getattr(fn, attr) + sign * delta[name])


@dataclasses.dataclass
class CaptureStats:
    """What one captured rollout did (``FusedWorld.capture_stats``)."""

    frames: int = 0
    eager_frames: int = 0  # frame 0 and the first of each idle count
    replays: int = 0
    capture_seconds: float = 0.0
    # per graph, by idle count k: wrapper launches a replay adds, and
    # the bytes its program copies back into the static state a frame
    launches: dict = dataclasses.field(default_factory=dict)
    copy_back_bytes: dict = dataclasses.field(default_factory=dict)

    @property
    def graphs(self) -> int:
        return len(self.launches)


def _tensor_leaves(tree) -> list:
    """The tensors of a state of nested named tuples, in field order."""
    return [x for x in pf.tree_leaves(tree) if isinstance(x, Tensor)]


def _storage(t: Tensor) -> int:
    return t.untyped_storage().data_ptr()


class FrameProgram:
    """The static buffers of a captured rollout and the frame program
    over them; :meth:`run` is what a graph captures."""

    def __init__(self, fw, first_state, first_row, caller_state, frames: int,
                 generator, draws, landmark_draws, graphs: bool):
        self.fw = fw
        self.generator = generator
        self.stats = CaptureStats(frames=frames, eager_frames=1)  # frame 0
        # the static state: the first frame's result, each storage once
        seen: set[int] = set()

        def own(x):
            if not isinstance(x, Tensor):
                return x
            if _storage(x) in seen:
                x = x.clone()
            seen.add(_storage(x))
            return x

        self.state = pf.tree_map(own, first_state)
        self._caller = {_storage(t) for t in _tensor_leaves(caller_state)}
        dev = first_state.pose.device
        self.index = torch.zeros(1, dtype=torch.int64, device=dev)
        self.outputs = {
            name: torch.empty((frames, *v.shape), dtype=v.dtype, device=dev)
            for name in _OUT_FIELDS
            if (v := getattr(first_row, name)) is not None
            and (name != "n_eff" or first_row.grid_pose is not None)}
        self.draws = draws  # [F, ...] on the device, or None
        self.landmark_draws = landmark_draws
        self.noise = None if draws is None else gs_model.UpdateNoise(
            *(torch.empty_like(x[0]) for x in draws))
        self.landmark_noise = None if landmark_draws is None else tuple(
            torch.empty_like(x[0]) for x in landmark_draws)
        self.speeds: dict[int, Tensor] = {}
        self._graphs: dict[int, torch.cuda.CUDAGraph] = {}
        self._pool = torch.cuda.graph_pool_handle() if graphs else None
        self._copied = 0
        self._write_row(first_row)

    def _write_row(self, row) -> None:
        for name, buf in self.outputs.items():
            buf.index_copy_(0, self.index, getattr(row, name).unsqueeze(0))
        self.index.add_(1)

    def _copy_back(self, new_state) -> None:
        """Copy each leaf the frame wrote as a fresh tensor into its
        static leaf; in-place leaves are left alone."""
        self._copied = 0
        for s, n in zip(_tensor_leaves(self.state),
                        _tensor_leaves(new_state), strict=True):
            if n.data_ptr() == s.data_ptr():
                continue
            if n.shape != s.shape or n.dtype != s.dtype:
                raise RuntimeError(
                    f"frame program: a state leaf changed from {s.dtype}"
                    f"{list(s.shape)} to {n.dtype}{list(n.shape)}")
            if _storage(s) in self._caller:
                raise RuntimeError("frame program: a fresh leaf would be "
                                   "copied into the caller's state")
            s.copy_(n)
            self._copied += s.numel() * s.element_size()

    def run(self, k: int) -> None:
        """The frame program of ``k`` idle ticks on the static buffers."""
        new_state, row = self.fw.frame(self.state, self.speeds[k],
                                       self.generator, self.noise,
                                       self.landmark_noise)
        self._write_row(row)
        self._copy_back(new_state)

    def _fill(self, k: int, speeds: Tensor, f: int) -> None:
        if k not in self.speeds:
            self.speeds[k] = torch.empty_like(speeds)
        self.speeds[k].copy_(speeds)
        if self.draws is not None:
            for buf, x in zip(self.noise, self.draws):
                buf.copy_(x[f])
        if self.landmark_draws is not None:
            for buf, x in zip(self.landmark_noise, self.landmark_draws):
                buf.copy_(x[f])

    def frame(self, k: int, speeds: Tensor, f: int,
              capture_after: bool) -> None:
        """Frame ``f`` (``k`` idle ticks at ``speeds``): a replay of k's
        graph, or else the program run eagerly, then captured when
        ``capture_after``."""
        self._fill(k, speeds, f)
        graph = self._graphs.get(k)
        if graph is not None:
            graph.replay()
            _add_counts(self.stats.launches[k])
            self.stats.replays += 1
            return
        self.run(k)
        self.stats.eager_frames += 1
        if capture_after:
            self.capture(k)

    def capture(self, k: int) -> None:
        """Capture the program of ``k`` idle ticks into a graph (nothing
        runs, nothing is drawn); its launches are kept for the replays
        and taken off the counters."""
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.generator)
        before = launch_counts()
        t0 = time.perf_counter()
        # on the current (capture) stream, after the eager frames queued
        # there; unlike torch.cuda.graph, no device sync and no
        # empty_cache, which would free and re-allocate the caller's pool
        graph.capture_begin(pool=self._pool,
                            capture_error_mode="thread_local")
        try:
            self.run(k)
        finally:
            graph.capture_end()
        self.stats.capture_seconds += time.perf_counter() - t0
        after = launch_counts()
        delta = {name: after[name] - before[name] for name in after}
        _add_counts(delta, -1)
        self.stats.launches[k] = delta
        self.stats.copy_back_bytes[k] = self._copied
        self._graphs[k] = graph


_STREAMS: dict[int, torch.cuda.Stream] = {}


def capture_stream(device: torch.device) -> torch.cuda.Stream:
    """The side stream that captured rollouts on ``device`` run on, one
    per device for the process, so that the per-stream state made by the
    first frame (cuBLAS's workspace, K4's arrival counters) is made
    once."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    if index not in _STREAMS:
        _STREAMS[index] = torch.cuda.Stream(index)
    return _STREAMS[index]


def _device_draws(draws, device):
    """Per-frame numpy draws, every frame's moved to ``device`` once."""
    if draws is None:
        return None
    return tuple(torch.from_numpy(np.array(x)).to(device) for x in draws)


def run_program(fw, state, n_steps: int, seed: int = 0, commands=None,
                initial_timer: Optional[float] = None, noise=None,
                landmark_noise=None, graphs: bool = True):
    """``fw.rollout_cadence`` of a one-device ``state`` through the frame
    program: with ``graphs`` each frame after the first of its idle count
    is a CUDA graph replay (on CUDA only); without, the program runs
    eagerly on any device (the CPU tests hold it to the eager loop).
    Sets ``fw.capture_stats``."""
    from slamrs_tpu_torch.graph.compile import WorldOutputs

    if pf.mesh_of(state) is not None or fw.mesh is not None:
        raise NotImplementedError("the frame program runs one-device states")
    dev = state.pose.device
    if graphs and dev.type != "cuda":
        raise ValueError(f"CUDA graphs need a CUDA state, got {dev}")
    if commands is None:
        commands = fw.commands_for(n_steps)
    fire_idx, timer = fw.fire_schedule(
        n_steps, state.scan_timer if initial_timer is None else initial_timer)
    if fire_idx.size == 0:
        return fw.rollout(state, n_steps, seed, commands)
    gen = fw._generator(seed, None)
    speeds = torch.stack([commands.speed_left,
                          commands.speed_right]).to(dev)
    draws = _device_draws(noise, dev)
    landmark_draws = _device_draws(landmark_noise, dev)
    idle = np.diff(fire_idx, prepend=-1) - 1  # idle ticks before each scan
    later = collections.Counter(idle[1:].tolist())

    main = torch.cuda.current_stream(dev) if graphs else None
    stream = capture_stream(dev) if graphs else None
    if graphs:
        stream.wait_stream(main)
    with torch.cuda.stream(stream) if graphs else contextlib.nullcontext():
        first, row = fw.frame(
            state, speeds[:, :fire_idx[0] + 1], gen,
            None if draws is None else gs_model.UpdateNoise(
                *(x[0] for x in draws)),
            None if landmark_draws is None else tuple(
                x[0] for x in landmark_draws))
        prog = FrameProgram(fw, first, row, state, len(fire_idx), gen, draws,
                            landmark_draws, graphs)
        for f in range(1, len(fire_idx)):
            k = int(idle[f])
            later[k] -= 1
            e = int(fire_idx[f])
            prog.frame(k, speeds[:, e - k:e + 1], f,
                       capture_after=graphs and later[k] > 0)
        last = prog.state
        last = fw.idle(last, speeds[:, int(fire_idx[-1]) + 1:])
        last = last._replace(
            scan_timer=timer,
            scan_counter=state.scan_counter + len(fire_idx))
        outs = prog.outputs
        result = WorldOutputs(
            fired=torch.ones(len(fire_idx), dtype=torch.bool, device=dev),
            pose=outs["pose"], grid_pose=outs.get("grid_pose"),
            icp_pose=outs.get("icp_pose"), ekf_pose=outs.get("ekf_pose"),
            n_eff=outs.get("n_eff"))
    if graphs:
        main.wait_stream(stream)
        # made on the capture stream, used on the caller's from here on
        for t in _tensor_leaves(last) + _tensor_leaves(result):
            t.record_stream(main)
    fw.capture_stats = prog.stats
    return last, result
