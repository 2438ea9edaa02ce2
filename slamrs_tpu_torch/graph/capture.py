"""Device work as captured CUDA graphs: the cadence rollout, one replay a
frame, and the App's node updates, one replay an update.

Counterpart of the JAX package's compiled programs: ``jax.jit`` over a
``lax.scan`` of frames in ``FusedWorld.rollout_cadence``
(``slamrs_tpu/graph/compile.py:313-432``), and the ``jax.jit`` of each
node's update (``slamrs_tpu/graph/nodes/sim.py:94``,
``slamrs_tpu/graph/nodes/slam.py:65,71,137,173``).  Issued op by op, a
grid tick takes some 50 host launches and an ICP tick 200; here each is
one ``torch.cuda.CUDAGraph`` replay.

:class:`Program` holds what every captured call needs: a static state,
copy-back of the leaves the work writes fresh, static input buffers, the
generator registered with each graph, one graph pool, and the launch
counters and statistics of each graph.  :class:`FrameProgram` is the
rollout's; the nodes of ``graph/nodes/`` hold one each
(``App(capture=...)``).

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
import gc
import inspect
import time
import weakref
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
class ProgramStats:
    """What a :class:`Program` did: its runs made eagerly (the first of
    each key, or every run without graphs), its graph replays, the
    seconds spent capturing, and per graph (by key) the wrapper launches
    a replay adds and the bytes its program copies back into the static
    state."""

    eager: int = 0
    replays: int = 0
    capture_seconds: float = 0.0
    launches: dict = dataclasses.field(default_factory=dict)
    copy_back_bytes: dict = dataclasses.field(default_factory=dict)

    @property
    def graphs(self) -> int:
        return len(self.launches)


@dataclasses.dataclass
class CaptureStats(ProgramStats):
    """What one captured rollout did (``FusedWorld.capture_stats``); its
    graphs are keyed by idle count k."""

    frames: int = 0

    @property
    def eager_frames(self) -> int:
        """Frame 0 and the first frame of each idle count."""
        return self.eager


def _tensor_leaves(tree) -> list:
    """The tensors of a state of nested named tuples, in field order."""
    return [x for x in pf.tree_leaves(tree) if isinstance(x, Tensor)]


def _storage(t: Tensor) -> int:
    return t.untyped_storage().data_ptr()


def _check_leaf(static: Tensor, new: Tensor, what: str) -> None:
    if new.shape != static.shape or new.dtype != static.dtype:
        raise RuntimeError(
            f"{what} changed from {static.dtype}{list(static.shape)} to "
            f"{new.dtype}{list(new.shape)}")


class Program:
    """Device work on static buffers (``state`` and ``inputs``), run
    eagerly the first time for each key and, with ``graphs``, captured
    into a CUDA graph right after and replayed from then on.

    ``body(key)`` is the work (a bound method is held weakly, so the
    program frees with its owner): it reads ``state`` and ``inputs``, hands a
    new state to :meth:`copy_back` and returns its outputs.  Outputs of a
    replay are the tensors the capture made, in the graph's pool: a
    caller copies what it keeps before the program's next replay.  The
    state and the input buffers live outside the pool.

    The program owns one graph pool, registers ``generator`` (if any)
    with each graph, so a replay draws what the eager run would, and
    keeps each graph's launch counts (taken off the counters at capture
    and added back on every replay).  It captures on the current stream,
    which must be a side stream (:func:`on_capture_stream`), without a
    device sync or ``empty_cache``.  A capture or a replay that fails
    raises; nothing falls back to the eager run.
    """

    def __init__(self, body, device, graphs: bool, generator=None,
                 stats: Optional[ProgramStats] = None):
        self.device = torch.device(device)
        if graphs and self.device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, got "
                             f"{self.device}")
        # a bound method of the program's owner is held weakly: a cycle
        # through it would leave the program and its graphs to the cyclic
        # collector, which may run inside a later capture, where
        # destroying a graph invalidates that capture
        self._body_fn = (weakref.WeakMethod(body) if inspect.ismethod(body)
                         else lambda: body)
        self.graphs = graphs
        self.generator = generator
        self.stats = ProgramStats() if stats is None else stats
        self.state = None
        self.inputs: dict = {}  # name -> the static form of a filled value
        self._buffers: dict = {}
        self._caller: set[int] = set()
        self._graphs: dict = {}
        self._outputs: dict = {}
        self._given: dict = {}
        self._pool = torch.cuda.graph_pool_handle() if graphs else None
        self._copied = 0

    def own(self, state, caller=None) -> None:
        """Take ``state`` as the static state, each storage owned once; a
        leaf of ``caller`` (a state the caller keeps) is never written."""
        seen: set[int] = set()

        def own(x):
            if not isinstance(x, Tensor):
                return x
            if _storage(x) in seen:
                x = x.clone()
            seen.add(_storage(x))
            return x

        self.state = pf.tree_map(own, state)
        self._caller = {_storage(t) for t in _tensor_leaves(caller)}

    def load(self, state) -> None:
        """Make the static state hold ``state``: on first use a copy of
        each of its tensors; after that each tensor that is not already
        the static leaf is copied into it (a state set from outside).
        Host values are taken as they are."""
        if self.state is None:
            self.own(pf.tree_map(
                lambda x: x.clone() if isinstance(x, Tensor) else x, state))
            return

        def into(s, n):
            if not isinstance(s, Tensor):
                return n
            if n is not s:
                _check_leaf(s, n, "a loaded state leaf")
                s.copy_(n)
            return s

        self.state = pf.tree_map(into, self.state, state)

    def fill(self, name, value) -> tuple:
        """Copy ``value`` (a tensor or a named tuple of them) into the
        static input buffers ``name``, made on first use; ``inputs[name]``
        is its static form.  Returns the non-tensor leaves, which a
        capture holds as constants: they belong in the caller's key."""
        consts: list = []
        self.inputs[name] = self._static((name,), value, consts)
        return tuple(consts)

    def _static(self, path: tuple, v, consts: list):
        if isinstance(v, tuple):
            items = [self._static((*path, i), x, consts)
                     for i, x in enumerate(v)]
            return type(v)(*items) if hasattr(v, "_fields") else tuple(items)
        if not isinstance(v, Tensor):
            consts.append(v)
            return v
        buf = self._buffers.get(path)
        if buf is None:
            buf = self._buffers[path] = torch.empty(
                v.shape, dtype=v.dtype, device=self.device)
        _check_leaf(buf, v, f"input {path}")
        buf.copy_(v)
        return buf

    def copy_back(self, new_state) -> None:
        """Copy each leaf the body wrote as a fresh tensor into its static
        leaf; leaves updated in place are left alone."""
        for s, n in zip(_tensor_leaves(self.state),
                        _tensor_leaves(new_state), strict=True):
            if n.data_ptr() == s.data_ptr():
                continue
            _check_leaf(s, n, "a state leaf")
            if _storage(s) in self._caller:
                raise RuntimeError("program: a fresh leaf would be copied "
                                   "into the caller's state")
            s.copy_(n)
            self._copied += s.numel() * s.element_size()

    def __call__(self, kind, state, **inputs):
        """One call: ``state`` loaded (:meth:`load`), each input that is
        not None filled (:meth:`fill`), then the program keyed by
        ``kind``, the names filled and their constants (:meth:`run`).  The
        body reads this call's inputs with :meth:`given`.  With
        ``graphs`` the call runs on the capture stream
        (:func:`on_capture_stream`)."""
        with on_capture_stream(self.device) if self.graphs \
                else contextlib.nullcontext():
            self.load(state)
            self._given = {name: self.fill(name, v)
                           for name, v in inputs.items() if v is not None}
            return self.run((kind, tuple(self._given.items())))

    def given(self, name):
        """The static form of input ``name`` when this call filled it,
        else None."""
        return self.inputs[name] if name in self._given else None

    def _body(self, key):
        self._copied = 0
        return self._body_fn()(key)

    def run(self, key, capture_after: bool = True):
        """The program of ``key``: a replay of its graph, or else the body
        run eagerly, then captured when ``graphs`` and
        ``capture_after``.  Returns the body's outputs."""
        graph = self._graphs.get(key)
        if graph is not None:
            graph.replay()
            _add_counts(self.stats.launches[key])
            self.stats.replays += 1
            return self._outputs[key]
        out = self._body(key)
        self.stats.eager += 1
        if self.graphs and capture_after:
            self.capture(key)
        return out

    def capture(self, key) -> None:
        """Capture the program of ``key`` into a graph (nothing runs,
        nothing is drawn); its launches are kept for the replays and
        taken off the counters."""
        graph = torch.cuda.CUDAGraph()
        if self.generator is not None:
            graph.register_generator_state(self.generator)
        before = launch_counts()
        t0 = time.perf_counter()
        # on the current (capture) stream, after the eager runs queued
        # there; unlike torch.cuda.graph, no device sync and no
        # empty_cache, which would free and re-allocate the caller's pool
        # no cyclic collection inside the capture either: it could free a
        # graph or an event of other work, which a capture does not permit
        collecting = gc.isenabled()
        gc.disable()
        try:
            graph.capture_begin(pool=self._pool,
                                capture_error_mode="thread_local")
            try:
                out = self._body(key)
            finally:
                graph.capture_end()
        finally:
            if collecting:
                gc.enable()
        self.stats.capture_seconds += time.perf_counter() - t0
        after = launch_counts()
        delta = {name: after[name] - before[name] for name in after}
        _add_counts(delta, -1)
        self.stats.launches[key] = delta
        self.stats.copy_back_bytes[key] = self._copied
        self._graphs[key] = graph
        self._outputs[key] = out


class FrameProgram(Program):
    """The static buffers of a captured rollout and the frame program
    over them, keyed by idle count k."""

    def __init__(self, fw, first_state, first_row, caller_state, frames: int,
                 generator, draws, landmark_draws, graphs: bool):
        dev = first_state.pose.device
        super().__init__(self._frame, dev, graphs, generator,
                         CaptureStats(frames=frames, eager=1))  # frame 0
        self.fw = fw
        self.own(first_state, caller_state)
        self.index = torch.zeros(1, dtype=torch.int64, device=dev)
        self.outputs = {
            name: torch.empty((frames, *v.shape), dtype=v.dtype, device=dev)
            for name in _OUT_FIELDS
            if (v := getattr(first_row, name)) is not None
            and (name != "n_eff" or first_row.grid_pose is not None)}
        self.draws = draws  # [F, ...] on the device, or None
        self.landmark_draws = landmark_draws
        self._write_row(first_row)

    def _write_row(self, row) -> None:
        for name, buf in self.outputs.items():
            buf.index_copy_(0, self.index, getattr(row, name).unsqueeze(0))
        self.index.add_(1)

    def _frame(self, k: int) -> None:
        """The frame program of ``k`` idle ticks on the static buffers."""
        new_state, row = self.fw.frame(
            self.state, self.inputs[("speeds", k)], self.generator,
            self.inputs.get("noise"), self.inputs.get("landmark_noise"))
        self._write_row(row)
        self.copy_back(new_state)

    def frame(self, k: int, speeds: Tensor, f: int,
              capture_after: bool) -> None:
        """Frame ``f`` (``k`` idle ticks at ``speeds``): a replay of k's
        graph, or else the program run eagerly, then captured when
        ``capture_after``."""
        self.fill(("speeds", k), speeds)
        if self.draws is not None:
            self.fill("noise", gs_model.UpdateNoise(
                *(x[f] for x in self.draws)))
        if self.landmark_draws is not None:
            self.fill("landmark_noise",
                      tuple(x[f] for x in self.landmark_draws))
        self.run(k, capture_after)


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


@contextlib.contextmanager
def on_capture_stream(device):
    """Run the block on ``device``'s capture stream, after the work
    queued on the current stream, which waits for the block's work at
    the end; already on it, or on the CPU, nothing changes.  Memory
    allocated on the capture stream is reused only by later work there,
    which starts after this wait, so tensors handed to the caller need
    no ``record_stream``."""
    device = torch.device(device)
    if device.type != "cuda":
        yield
        return
    stream = capture_stream(device)
    main = torch.cuda.current_stream(device)
    if main == stream:
        yield
        return
    stream.wait_stream(main)
    try:
        with torch.cuda.stream(stream):
            yield
    finally:
        main.wait_stream(stream)


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
