"""Device work as captured CUDA graphs: the cadence rollout, one replay a
frame, on one device or on a mesh whose entries are all one device; the
tick-by-tick rollout, one replay a tick; and the App's node updates, one
replay an update.

Counterpart of the JAX package's compiled programs: ``jax.jit`` over a
``lax.scan`` of frames in ``FusedWorld.rollout_cadence``
(``slamrs_tpu/graph/compile.py:313-432``), sharded states included
(``:85-89,167-171``), ``jax.jit(fw.rollout)`` (``:296-311``), and the
``jax.jit`` of each
node's update (``slamrs_tpu/graph/nodes/sim.py:94``,
``slamrs_tpu/graph/nodes/slam.py:65,71,137,173``).  Issued op by op, a
grid tick takes some 50 host launches and an ICP tick 200; here each is
one ``torch.cuda.CUDAGraph`` replay.

:class:`Program` holds what every captured call needs: a static state,
copy-back of the leaves the work writes fresh, static input buffers, the
generator registered with each graph, one graph pool, and the launch
counters and statistics of each graph.  :class:`FrameProgram` is the
cadence rollout's (:func:`run_program`), :class:`TickProgram` the tick
rollout's (:func:`run_ticks`); the nodes of ``graph/nodes/`` hold one
each (``App(capture=...)``).

The frame program (:class:`FrameProgram`) is ``FusedWorld.frame`` on
static buffers:

* the world state: every tensor leaf of ``WorldState`` (every block of a
  sharded leaf, ``parallel.Sharded``).  The first frame of the call that
  builds the program runs eagerly on the caller's state and its result
  becomes the static state.  A leaf that a frame writes as a fresh
  tensor (K1's lineage maps, the dda and dense maps, poses, weights, the
  ICP map) is copied back into its static leaf by the program's last
  nodes; a leaf that the route updates in place (K1 in place, K2, K3's
  tile pool, a fleet's maps) is not copied;
* the frame's wheel speeds, ``f32[2, k + 1]``, filled with ``copy_``
  before each replay;
* injected draws (``noise=``, ``landmark_noise=``): every frame's moved
  to the device once a call, the frame's copied into the static draw
  buffers before each replay;
* the outputs ``[F_max, ...]`` (the most frames the call's ticks can
  fire), written at a frame index held on the device and advanced by
  the program; the caller gets a copy of the call's rows.

The host resolves the timer before the loop (``FusedWorld.
fire_schedule``), so a frame holds no data-dependent control flow.  The
first frame with a given idle count ``k`` runs eagerly on the capture
stream and is then captured; later frames of that ``k`` replay its
graph.  That warm-up is a real frame of the rollout, run by the very
program that is then captured: it consumes the run's own draws, and the
capture itself draws nothing.  The graphs share one memory pool.

The program outlives the call: it is kept on the world
(``FusedWorld.frame_program``, one a world; it holds the world weakly)
with its graphs, its pool, its static buffers and its trailing-tick
program.  A later call handed the state the last call returned (its
static state, carried) runs on it (:meth:`FrameProgram.takes`): the
generator re-seeded, the frame index reset, every frame a replay, frame
0 included, except the first frame of an idle count the program has not
met, which runs eagerly and is captured.  Any other state (a fresh
``init()``, a checkpoint) builds a new program, which replaces the
kept one.  The state returned is the static buffers: a state handed to
a captured rollout is consumed, the state returned shares its storage,
and the old state must not be used again.  Trailing idle ticks after
the last scan run through the kept tick program's idle graph, and a
call in which no scan fires through the tick rollout's programs
(:func:`run_ticks`, built for the call).

Meshes (``parallel/``): a sharded state runs when every entry of its
mesh is the same CUDA device (a mesh over several distinct devices is
not captured yet, :func:`check_graphs`); all its work is on one stream.
A world-only, ``"gather"``, tiled or dda mesh frame reads nothing on the
host: one graph a frame.  A particle-sharded ``"local"`` frame decides
per world shard between the relabel and the exact gather, which the JAX
package does on the device (``slamrs_tpu/parallel/resample.py:177``);
here the program cuts the frame there (:class:`_Split`): a head graph
up to every row's plan writes the rows' overflow flags into one static
buffer, the host reads it once, each row replays the graph of its branch
(both write the row's blocks in place), and a tail graph holds the rest.

The tick programs (:class:`TickProgram`): an idle tick (motion, each
filter's estimate carried) and a scan tick (motion and the scan update),
picked by the host timer before the loop; each tick's output row goes
into static ``[n_steps, ...]`` buffers.

Draws: the program's ``torch.Generator`` is registered with every graph,
so a replay draws what the eager frame would (the generator's offset
advances by the graph's whole increment); each call seeds it anew.
Seeded and injected runs give the eager loop's bits.

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
import weakref
from typing import Optional

import numpy as np
import torch

from slamrs_tpu_torch.core.types import Command
from slamrs_tpu_torch.models import gridslam as gs_model
from slamrs_tpu_torch.parallel import fleet as pf
from slamrs_tpu_torch.parallel import resample as pres
from slamrs_tpu_torch.utils import trace

Tensor = torch.Tensor

_OUT_FIELDS = ("pose", "grid_pose", "icp_pose", "ekf_pose", "n_eff")


_COUNTERS: Optional[dict] = None


def _counter_table() -> dict:
    """The launch counters' table, built once a process (a replay adds
    its counts through it)."""
    global _COUNTERS
    if _COUNTERS is None:
        from slamrs_tpu_torch.ops import cow, fused, icp, tiles

        _COUNTERS = {
            "fused_update": (fused.fused_update, "launches"),
            "fused_update_in_place": (fused.fused_update,
                                      "in_place_launches"),
            "cow_copy": (cow.cow_copy, "launches"),
            "fused_update_tiled": (tiles.fused_update_tiled, "launches"),
            "nn_argmin": (icp.nearest_neighbors_fused, "launches"),
            "icp_solve": (icp.icp_solve, "launches")}
    return _COUNTERS


def launch_counters() -> dict:
    """The launch counter of every kernel wrapper, by name:
    ``(function, attribute)``."""
    return dict(_counter_table())


def launch_counts() -> dict:
    """Every wrapper's launch count, by name."""
    return {name: getattr(fn, attr)
            for name, (fn, attr) in _counter_table().items()}


def _add_counts(delta: dict, sign: int = 1) -> None:
    table = _counter_table()
    for name, n in delta.items():
        if n:
            fn, attr = table[name]
            setattr(fn, attr, getattr(fn, attr) + sign * n)


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
    # host reads of the local-first resample's overflow flags
    overflow_reads: int = 0

    @property
    def graphs(self) -> int:
        return len(self.launches)


@dataclasses.dataclass
class CaptureStats(ProgramStats):
    """What one captured rollout did (``FusedWorld.capture_stats``): the
    cadence rollout's graphs are keyed by idle count k (a frame cut at
    the overflow read by ``(k, part)``), the tick rollout's by ``"idle"``
    and ``"scan"``; ``frames`` counts frames or ticks, and ``ticks``
    holds the stats of the trailing idle ticks' program.  The per-graph
    tables (``launches``, ``copy_back_bytes``) are the program's, which
    a kept frame program carries from call to call."""

    frames: int = 0
    ticks: Optional[ProgramStats] = None

    @property
    def eager_frames(self) -> int:
        """The call's frames run eagerly: frame 0 of a call that builds
        the program, and the first frame of each idle count the program
        had not met."""
        return self.eager


def _tensor_leaves(tree) -> list:
    """The tensors of a state of nested named tuples, in field order; a
    sharded leaf gives its blocks, row by row."""
    out = []
    for x in pf.tree_leaves(tree):
        if isinstance(x, pf.Sharded):
            out.extend(b for row in x.blocks for b in row)
        elif isinstance(x, Tensor):
            out.append(x)
    return out


def _map_tensors(fn, tree, *others):
    """``fn`` over the tensors of ``tree`` (a sharded leaf's blocks, with
    the same blocks of ``others``); a host value becomes the last of
    ``others``' (``tree``'s own without others)."""
    def leaf(x, *o):
        if isinstance(x, pf.Sharded):
            return pf.Sharded(x.mesh, x.spec, [
                [fn(b, *(y.blocks[r][t] for y in o))
                 for t, b in enumerate(row)]
                for r, row in enumerate(x.blocks)])
        if isinstance(x, Tensor):
            return fn(x, *o)
        return o[-1] if o else x
    return pf.tree_map(leaf, tree, *others)


def _storage(t: Tensor) -> int:
    return t.untyped_storage().data_ptr()


def _check_leaf(static: Tensor, new: Tensor, what: str) -> None:
    if new.shape != static.shape or new.dtype != static.dtype:
        raise RuntimeError(
            f"{what} changed from {static.dtype}{list(static.shape)} to "
            f"{new.dtype}{list(new.shape)}")


class _Split:
    """A key's program cut at the local-first resample's overflow read:
    ``head`` up to and including the flags, then per world row the graph
    of the branch the flags pick (captured the first time it is taken,
    into the program's row pool), then ``tail``.  ``branch(r, fallback)``
    is the resample's, holding the head's tensors it reads."""

    __slots__ = ("head", "tail", "branch", "rows")

    def __init__(self, head, tail, branch):
        self.head, self.tail, self.branch = head, tail, branch
        self.rows: dict = {}


class Program:
    """Device work on static buffers (``state`` and ``inputs``), run
    eagerly the first time for each key and, with ``graphs``, captured
    into a CUDA graph right after and replayed from then on.

    ``body(key)`` is the work (a bound method is held weakly, so the
    program frees with its owner): it reads ``state`` and ``inputs``, hands a
    new state to :meth:`copy_back` and returns its outputs.  Outputs of a
    replay are the tensors the capture made, in the graph's pool: a
    caller copies what it keeps before the program's next replay.  The
    state and the input buffers live outside the pool.  The state may be
    sharded over a mesh whose entries are all one device
    (``parallel.Sharded`` leaves: each block is a static buffer).

    The program owns one graph pool, registers ``generator`` (if any)
    with each graph, so a replay draws what the eager run would, and
    keeps each graph's launch counts (taken off the counters at capture
    and added back on every replay).  It captures on the current stream,
    which must be a side stream (:func:`on_capture_stream`), without a
    device sync or ``empty_cache``.  A capture or a replay that fails
    raises; nothing falls back to the eager run.

    A body that reaches the local-first resample of a particle-sharded
    mesh (``parallel/resample.py``) writes every world row's overflow
    flag into one static bool buffer, which the host reads once a run
    (:attr:`ProgramStats.overflow_reads`); the row's branch follows.  So
    its capture is cut there (:class:`_Split`): a head graph, the branch
    graphs of each row, each captured when first taken, into a second
    pool that no head or tail tensor lives in, and a tail graph.
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
        self._static: set[int] = set()
        self._graphs: dict = {}
        self._outputs: dict = {}
        self._given: dict = {}
        self._pool = torch.cuda.graph_pool_handle() if graphs else None
        self._row_pool = None
        self._copied = 0
        self._flags = None  # the overflow flags' static buffer
        self._open = None  # the capture in progress: (graph, counts)
        self._cut = None  # its head and branch once cut at the flags

    def own(self, state, caller=None) -> None:
        """Take ``state`` as the static state, each storage owned once; a
        leaf of ``caller`` (a state the caller keeps) is never written."""
        seen: set[int] = set()

        def own(x):
            if _storage(x) in seen:
                x = x.clone()
            seen.add(_storage(x))
            return x

        self.state = _map_tensors(own, state)
        self._static = seen
        self._caller = {_storage(t) for t in _tensor_leaves(caller)}

    def restart(self, stats: ProgramStats) -> None:
        """A new call's statistics, ``stats``, which take over the
        program's per-graph tables that the replays add from."""
        stats.launches = self.stats.launches
        stats.copy_back_bytes = self.stats.copy_back_bytes
        self.stats = stats

    def load(self, state) -> None:
        """Make the static state hold ``state``: on first use a copy of
        each of its tensors; after that each tensor that is not already
        the static leaf is copied into it (a state set from outside).
        Host values are taken as they are."""
        if self.state is None:
            self.own(_map_tensors(lambda x: x.clone(), state))
            return

        def into(s, n):
            if n is not s:
                _check_leaf(s, n, "a loaded state leaf")
                s.copy_(n)
            return s

        self.state = _map_tensors(into, self.state, state)

    def fill(self, name, value) -> tuple:
        """Copy ``value`` (a tensor or a named tuple of them) into the
        static input buffers ``name``, made on first use; ``inputs[name]``
        is its static form.  Returns the non-tensor leaves, which a
        capture holds as constants: they belong in the caller's key."""
        consts: list = []
        self.inputs[name] = self._static_input((name,), value, consts)
        return tuple(consts)

    def _static_input(self, path: tuple, v, consts: list):
        if isinstance(v, tuple):
            items = [self._static_input((*path, i), x, consts)
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
        leaf; leaves updated in place are left alone.  A fresh leaf that
        is a view of some static storage would alias two leaves: it
        raises."""
        for s, n in zip(_tensor_leaves(self.state),
                        _tensor_leaves(new_state), strict=True):
            if n.data_ptr() == s.data_ptr():
                continue
            _check_leaf(s, n, "a state leaf")
            if _storage(s) in self._caller:
                raise RuntimeError("program: a fresh leaf would be copied "
                                   "into the caller's state")
            if _storage(n) in self._static:
                raise RuntimeError("program: a new leaf is a view of "
                                   "another static leaf")
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
        with pres.split_at_overflow(self._at_overflow):
            return self._body_fn()(key)

    def _read_flags(self) -> list:
        self.stats.overflow_reads += 1
        return pres._read_overflow(self._flags)

    def _at_overflow(self, flags: Tensor, branch, n_rows: int) -> None:
        """The resample's overflow read inside the body: run eagerly, the
        flags are read and each row's branch taken now; in a capture, the
        head graph ends after the flags are written and the tail's
        capture begins (the rows are captured when first taken)."""
        if self._open is None:
            if self._flags is None:  # eager runs come before any capture
                self._flags = torch.empty_like(flags)
            self._flags.copy_(flags)
            for r, fallback in enumerate(self._read_flags()):
                branch(r, fallback)
            return
        if self._cut is not None:
            raise RuntimeError("program: a second overflow read in one run")
        self._flags.copy_(flags)
        self._cut = (*self._finish(*self._open), branch)
        self._open = self._start(self._pool)

    def run(self, key, capture_after: bool = True):
        """The program of ``key``: a replay of its graph, or else the body
        run eagerly, then captured when ``graphs`` and
        ``capture_after``.  Returns the body's outputs."""
        graph = self._graphs.get(key)
        if graph is not None:
            if isinstance(graph, _Split):
                self._replay_split(key, graph)
            else:
                self._replay(graph, key)
            self.stats.replays += 1
            return self._outputs[key]
        with trace.span("frame.eager"):
            out = self._body(key)
        self.stats.eager += 1
        if self.graphs and capture_after:
            self.capture(key)
        return out

    def _replay(self, graph, key) -> None:
        with trace.span("graph.launch"):
            graph.replay()
            _add_counts(self.stats.launches[key])

    def _replay_split(self, key, split: _Split) -> None:
        self._replay(split.head, (key, "head"))
        for r, fallback in enumerate(self._read_flags()):
            rk = (key, "row", r, "gather" if fallback else "local")
            graph = split.rows.get(rk)
            if graph is None:
                graph = split.rows[rk] = self._capture_row(split.branch, r,
                                                           fallback, rk)
            self._replay(graph, rk)
        self._replay(split.tail, (key, "tail"))

    def _start(self, pool):
        """A graph's capture begun on the current (capture) stream, after
        the work queued there; unlike torch.cuda.graph, no device sync
        and no empty_cache, which would free and re-allocate the caller's
        pool.  Returns ``(graph, launch counts before)``."""
        graph = torch.cuda.CUDAGraph()
        if self.generator is not None:
            graph.register_generator_state(self.generator)
        before = launch_counts()
        graph.capture_begin(pool=pool, capture_error_mode="thread_local")
        return graph, before

    @staticmethod
    def _finish(graph, before) -> tuple:
        """End a capture; its launches are taken off the counters and
        returned with the graph."""
        graph.capture_end()
        after = launch_counts()
        delta = {name: after[name] - before[name] for name in after}
        _add_counts(delta, -1)
        return graph, delta

    @contextlib.contextmanager
    def _capturing(self):
        """The block as a ``frame.capture`` span, whose time
        ``capture_seconds`` adds, with no cyclic collection inside: it
        could free a graph or an event of other work, which a capture
        does not permit."""
        collecting = gc.isenabled()
        gc.disable()
        timer = trace.span("frame.capture")
        try:
            with timer:
                yield
        finally:
            if collecting:
                gc.enable()
            self.stats.capture_seconds += timer.seconds

    def capture(self, key) -> None:
        """Capture the program of ``key`` into a graph (nothing runs,
        nothing is drawn), or into a :class:`_Split` when the body reaches
        the overflow read; its launches are kept for the replays and
        taken off the counters."""
        with self._capturing():
            self._open, self._cut = self._start(self._pool), None
            try:
                out = self._body(key)
            finally:
                graph, delta = self._finish(*self._open)
                self._open = None
        self.stats.copy_back_bytes[key] = self._copied
        if self._cut is None:
            self._graphs[key] = graph
            self.stats.launches[key] = delta
        else:
            head, head_delta, branch = self._cut
            self._cut = None
            self._graphs[key] = _Split(head, graph, branch)
            self.stats.launches[(key, "head")] = head_delta
            self.stats.launches[(key, "tail")] = delta
        self._outputs[key] = out

    def _capture_row(self, branch, r: int, fallback: bool, rk):
        """World row ``r``'s branch captured into the row pool: the head
        and tail graphs' tensors that live from one to the other were
        freed into the main pool after their capture, so a graph captured
        there now could be handed their memory."""
        if self._row_pool is None:
            self._row_pool = torch.cuda.graph_pool_handle()
        with self._capturing():
            graph, before = self._start(self._row_pool)
            try:
                branch(r, fallback)
            finally:
                graph, delta = self._finish(graph, before)
        self.stats.launches[rk] = delta
        return graph


class WorldProgram(Program):
    """The static buffers of a captured rollout of a ``FusedWorld``: the
    world state (one device, or sharded over a one-card mesh), the
    injected draws of every scan frame moved to the device once, and the
    output rows ``[rows, ...]`` written at a frame index held on the
    device and advanced by the program.  The world is held weakly: the
    world keeps its frame program (``FusedWorld.frame_program``), and a
    cycle would leave both to the cyclic collector (:class:`Program`)."""

    def __init__(self, body, fw, first_state, first_rows, caller_state,
                 rows: int, generator, draws, landmark_draws, graphs: bool,
                 mesh, stats):
        dev = first_state.pose.device
        super().__init__(body, dev, graphs, generator, stats)
        self._fw, self.mesh = weakref.ref(fw), mesh
        self.own(first_state, caller_state)
        self.index = torch.zeros(1, dtype=torch.int64, device=dev)
        first_rows = first_rows or []
        row = first_rows[0] if first_rows else None
        self.outputs = {} if row is None else {
            name: torch.empty((rows, *v.shape), dtype=v.dtype, device=dev)
            for name in _OUT_FIELDS
            if (v := getattr(row, name)) is not None
            and (name != "n_eff" or row.grid_pose is not None)}
        self.draws = draws  # [F, ...] on the device, or None
        self.landmark_draws = landmark_draws
        for row in first_rows:
            self._write_row(row)

    @property
    def fw(self):
        return self._fw()

    def _write_row(self, row) -> None:
        if not self.outputs:
            return
        for name, buf in self.outputs.items():
            buf.index_copy_(0, self.index, getattr(row, name).unsqueeze(0))
        self.index.add_(1)

    def _fill_draws(self, f: int) -> None:
        """Frame ``f``'s injected draws into the static draw buffers."""
        if self.draws is not None:
            self.fill("noise", gs_model.UpdateNoise(
                *(x[f] for x in self.draws)))
        if self.landmark_draws is not None:
            self.fill("landmark_noise",
                      tuple(x[f] for x in self.landmark_draws))

    def outputs_as(self, fired: Tensor, copy: bool = False):
        """The outputs of the ``len(fired)`` rows written; ``copy``: a
        copy of them, which later replays leave alone."""
        from slamrs_tpu_torch.graph.compile import WorldOutputs

        n = fired.shape[0]
        outs = {name: buf[:n].clone() if copy else buf[:n]
                for name, buf in self.outputs.items()}
        return WorldOutputs(
            fired=fired, pose=outs["pose"], grid_pose=outs.get("grid_pose"),
            icp_pose=outs.get("icp_pose"), ekf_pose=outs.get("ekf_pose"),
            n_eff=outs.get("n_eff"))


def _world_parts(fw) -> tuple:
    """What a frame program bakes in of its world besides the state."""
    return (fw.scene, fw.params, fw.dt, fw.grid_config, fw.icp_config,
            fw.ekf_config, fw.num_beams)


class FrameProgram(WorldProgram):
    """The cadence rollout's frame program, keyed by idle count k, with
    output rows for ``rows`` frames.  Kept on the world after the call
    (``FusedWorld.frame_program``): a later call on its static state
    runs on it (:meth:`takes`, :meth:`start`), and so does its tick
    program for the trailing idle ticks (:meth:`idle_ticks`)."""

    def __init__(self, fw, first_state, first_row, caller_state, rows: int,
                 frames: int, generator, draws, landmark_draws,
                 graphs: bool, mesh=None):
        super().__init__(self._frame, fw, first_state, [first_row],
                         caller_state, rows, generator, draws,
                         landmark_draws, graphs, mesh,
                         CaptureStats(frames=frames, eager=1))  # frame 0
        self.rows = rows
        self.injected = (draws is not None, landmark_draws is not None)
        self.world = _world_parts(fw)
        self.ticks: Optional[TickProgram] = None

    def takes(self, state, mesh, graphs: bool, draws, landmark_draws,
              frames: int) -> bool:
        """Whether a call of ``frames`` frames on ``state`` (placed on
        ``mesh``) runs on this program: every tensor leaf of the state
        (every block of a sharded leaf) is the static leaf, on the same
        mesh, with or without graphs and injected draws as the program
        was built, for a world unchanged, and the frames fit the output
        rows."""
        leaves = _tensor_leaves(state)
        static = _tensor_leaves(self.state)
        return (len(leaves) == len(static)
                and all(a is b for a, b in zip(leaves, static))
                and mesh == self.mesh and graphs == self.graphs
                and self.injected == (draws is not None,
                                      landmark_draws is not None)
                and all(a is b for a, b in zip(_world_parts(self.fw),
                                               self.world))
                and frames <= self.rows)

    def start(self, seed: int, frames: int, draws, landmark_draws) -> None:
        """A call of ``frames`` frames on the kept program: the generator
        seeded with ``seed``, as a fresh program's would be, the call's
        draws taken, the frame index back at 0, statistics of its own."""
        self.generator.manual_seed(seed)
        self.draws, self.landmark_draws = draws, landmark_draws
        self.index.zero_()
        self.restart(CaptureStats(frames=frames))

    def _frame(self, k: int) -> None:
        """The frame program of ``k`` idle ticks on the static buffers."""
        new_state, row = self.fw.frame(
            self.state, self.inputs[("speeds", k)], self.generator,
            self.inputs.get("noise"), self.inputs.get("landmark_noise"),
            self.mesh)
        self._write_row(row)
        self.copy_back(new_state)

    def frame(self, k: int, speeds: Tensor, f: int) -> None:
        """Frame ``f`` (``k`` idle ticks at ``speeds``): a replay of k's
        graph, or else the program run eagerly, then captured."""
        with trace.span("frame.fill"):
            self.fill(("speeds", k), speeds)
            self._fill_draws(f)
        self.run(k)

    def idle_ticks(self, speeds: Tensor):
        """The idle ticks at ``speeds`` (f32[2, n]) through the tick
        program's idle graph (the program made on first use, over this
        program's static state); returns its state, whose leaves are this
        program's static leaves."""
        if self.ticks is None:
            self.ticks = TickProgram(self.fw, self.state, None, None, 0,
                                     self.generator, None, None, self.graphs,
                                     self.mesh, eager=0)
            self.ticks._caller = self._caller
        n = speeds.shape[1]
        self.ticks.restart(CaptureStats(frames=n))
        for j in range(n):
            self.ticks.tick("idle", speeds[:, j], 0, capture_after=True)
        self.stats.ticks = self.ticks.stats
        return self.ticks.state


class TickProgram(WorldProgram):
    """The tick rollout's programs (``FusedWorld.rollout``): ``"idle"``,
    motion only with each filter's previous estimate carried, and
    ``"scan"``, motion and the scan update.  The host timer picks the
    kind before the loop; the static state's timer is not kept (the
    caller sets it).  ``first_rows`` are the rows of the ticks run before
    the program; without them no output is written (the cadence
    rollout's trailing idle ticks)."""

    def __init__(self, fw, first_state, first_rows, caller_state,
                 ticks: int, generator, draws, landmark_draws, graphs: bool,
                 mesh=None, eager: int = 1):
        super().__init__(self._tick, fw, first_state, first_rows,
                         caller_state, ticks, generator, draws,
                         landmark_draws, graphs, mesh,
                         CaptureStats(frames=ticks, eager=eager))

    def _tick(self, kind: str) -> None:
        """One tick of ``kind`` on the static buffers; the timer is
        forced so that only a scan tick fires."""
        speed = self.inputs["speed"]
        scan = kind == "scan"
        new_state, row = self.fw.step(
            self.state._replace(scan_timer=0.0), Command(speed[0], speed[1]),
            self.generator, force_fire=scan,
            noise=self.inputs.get("noise") if scan else None,
            landmark_noise=self.inputs.get("landmark_noise") if scan
            else None)
        if row.fired != scan:
            raise RuntimeError("tick program: an idle tick fired (the "
                               "period is shorter than a tick)")
        self._write_row(row)
        self.copy_back(new_state)

    def tick(self, kind: str, speed: Tensor, f: int,
             capture_after: bool) -> None:
        """One tick of ``kind`` at ``speed`` (f32[2]); a scan tick takes
        scan frame ``f``'s injected draws."""
        with trace.span("frame.fill"):
            self.fill("speed", speed)
            if kind == "scan":
                self._fill_draws(f)
        self.run(kind, capture_after)


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
    with trace.span("rollout.draws_upload"):
        return tuple(torch.from_numpy(np.array(x)).to(device) for x in draws)


def check_graphs(mesh, device, what: str) -> None:
    """Raise unless a rollout on ``device`` (a mesh's first device) can be
    captured: a mesh over several distinct devices is not captured yet
    (``NotImplementedError``), and CUDA graphs need a CUDA device
    (``ValueError``)."""
    if mesh is not None and len({str(d) for d in mesh.devices.flat}) > 1:
        raise NotImplementedError(
            f"{what}: a mesh over several distinct devices is not captured "
            "yet; it runs the eager loop (capture=None or False)")
    if torch.device(device).type != "cuda":
        raise ValueError(f"{what} needs a state on a CUDA device, got "
                         f"{device}")


@contextlib.contextmanager
def _program_stream(dev, graphs: bool):
    """The block on ``dev``'s capture stream (with ``graphs``), after the
    caller's stream's work; the caller's stream waits for it after."""
    if not graphs:
        yield None
        return
    main = torch.cuda.current_stream(dev)
    stream = capture_stream(dev)
    stream.wait_stream(main)
    with torch.cuda.stream(stream):
        yield main
    main.wait_stream(stream)


def _hand_over(main, *trees) -> None:
    """Tensors made on the capture stream, used on the caller's stream
    from here on."""
    if main is not None:
        with trace.span("rollout.hand_over"):
            for tree in trees:
                for t in _tensor_leaves(tree):
                    t.record_stream(main)


# the host counter of a rollout call that ran on a kept frame program
REUSED = "rollout.program_reused"


def _frames_max(fw, n_steps: int) -> int:
    """The most scan frames ``n_steps`` ticks can fire from a timer at
    most one period: one a period, one more for the timer's start and
    one for float32 rounding; every tick without a period."""
    period = float(np.float32(fw.params.update_period))
    if period <= 0.0:
        return n_steps
    return min(n_steps, int(n_steps * fw.dt / period) + 2)


def run_program(fw, state, n_steps: int, seed: int = 0, commands=None,
                initial_timer: Optional[float] = None, noise=None,
                landmark_noise=None, graphs: bool = True):
    """``fw.rollout_cadence`` through the frame program, on one device or
    on a mesh whose entries are all one device: with ``graphs`` each
    frame after the first of its idle count is a CUDA graph replay (on
    CUDA only); without, the program runs eagerly on any device (the CPU
    tests hold it to the eager loop).  A call handed the state the last
    call on ``fw`` returned runs on the kept program
    (``fw.frame_program``); any other state builds one, frame 0 run
    eagerly on it, which replaces the kept one.  ``state`` is consumed:
    the state returned shares its storage.  The trailing idle ticks after
    the last scan run through the kept program's tick program, and a
    call in which no scan fires through the tick programs
    (:func:`run_ticks`).  Sets ``fw.capture_stats``, the call's own.

    Traced as the call ``rollout_cadence`` (``utils/trace.py``): spans
    ``rollout.draws_upload``, ``frame.eager``, ``frame.capture``,
    ``frame.fill``, ``graph.launch``, ``rollout.ticks`` and
    ``rollout.hand_over``, the counter ``rollout.frames``, and
    :data:`REUSED` (1) in a call on the kept program."""
    with trace.call("rollout_cadence"):
        state, mesh = fw._placed(state)
        dev = state.pose.device
        if graphs:
            check_graphs(mesh, dev, "the frame program")
        if commands is None:
            commands = fw.commands_for(n_steps)
        fire_idx, timer = fw.fire_schedule(
            n_steps,
            state.scan_timer if initial_timer is None else initial_timer)
        if fire_idx.size == 0:
            return run_ticks(fw, state, n_steps, seed, commands,
                             graphs=graphs)
        frames = len(fire_idx)
        trace.count("rollout.frames", frames)
        speeds = torch.stack([commands.speed_left,
                              commands.speed_right]).to(dev)
        draws = _device_draws(noise, dev)
        landmark_draws = _device_draws(landmark_noise, dev)
        idle = np.diff(fire_idx, prepend=-1) - 1  # idle ticks before each scan

        with _program_stream(dev, graphs) as main:
            prog = fw.frame_program
            if prog is not None and prog.takes(state, mesh, graphs, draws,
                                               landmark_draws, frames):
                trace.count(REUSED, 1)
                prog.start(seed, frames, draws, landmark_draws)
                first = 0
            else:
                # the kept program's pool and buffers go before the build
                fw.frame_program = None
                gen = fw._generator(seed, mesh)
                with trace.span("frame.eager"):
                    built, row = fw.frame(
                        state, speeds[:, :fire_idx[0] + 1], gen,
                        None if draws is None else gs_model.UpdateNoise(
                            *(x[0] for x in draws)),
                        None if landmark_draws is None else tuple(
                            x[0] for x in landmark_draws), mesh)
                prog = fw.frame_program = FrameProgram(
                    fw, built, row, state,
                    max(frames, _frames_max(fw, n_steps)), frames, gen, draws,
                    landmark_draws, graphs, mesh)
                first = 1
            for f in range(first, frames):
                k = int(idle[f])
                e = int(fire_idx[f])
                prog.frame(k, speeds[:, e - k:e + 1], f)
            last = prog.state
            trailing = n_steps - 1 - int(fire_idx[-1])
            if trailing:  # idle ticks: the tick rollout's idle program
                with trace.span("rollout.ticks"):
                    last = prog.idle_ticks(speeds[:, n_steps - trailing:])
            prog.draws = prog.landmark_draws = None  # the call's own
            last = last._replace(
                scan_timer=timer,
                scan_counter=state.scan_counter + frames)
            result = prog.outputs_as(
                torch.ones(frames, dtype=torch.bool, device=dev), copy=True)
            _hand_over(main, last, result)
        fw.capture_stats = prog.stats
        return last, result


def run_ticks(fw, state, n_steps: int, seed: int = 0, commands=None,
              noise=None, landmark_noise=None, graphs: bool = True):
    """``fw.rollout`` through the tick programs, on one device or on a
    mesh whose entries are all one device: the host timer gives each
    tick's kind before the loop.  The ticks up to the first scan tick run
    eagerly on ``state``; after them each tick is a replay of its kind's
    graph (with ``graphs``, on CUDA only; the first of each kind runs
    eagerly, then is captured).  ``noise`` and ``landmark_noise`` hold
    each scan frame's draws.  Sets ``fw.capture_stats``.

    Traced as the call ``rollout`` (inside ``rollout_cadence``, a span of
    it), with :func:`run_program`'s spans and ``rollout.frames`` counting
    ticks."""
    with trace.call("rollout"):
        state, mesh = fw._placed(state)
        dev = state.pose.device
        if graphs:
            check_graphs(mesh, dev, "the tick program")
        if commands is None:
            commands = fw.commands_for(n_steps)
        fire_idx, timer = fw.fire_schedule(n_steps, state.scan_timer)
        fired = np.zeros(n_steps, bool)
        fired[fire_idx] = True
        kinds = ["scan" if x else "idle" for x in fired]
        trace.count("rollout.frames", n_steps)
        gen = fw._generator(seed, mesh)
        speeds = torch.stack([commands.speed_left,
                              commands.speed_right]).to(dev)
        draws = _device_draws(noise, dev)
        landmark_draws = _device_draws(landmark_noise, dev)
        for given in (draws, landmark_draws):
            if given is not None and len(given[0]) < fire_idx.size:
                raise ValueError(f"injected draws for {len(given[0])} scan "
                                 f"frames, the rollout scans {fire_idx.size} "
                                 "times")

        def frame_draws(all_draws, f):
            if all_draws is None or f >= len(all_draws[0]):
                return None
            return tuple(x[f] for x in all_draws)

        # eager up to the first scan tick: from then on no leaf of the
        # caller's state is in the static state where a tick writes afresh
        lead = int(fire_idx[0]) + 1 if fire_idx.size else 1
        later = collections.Counter(kinds[lead:])
        with _program_stream(dev, graphs) as main:
            first, rows = state, []
            for i in range(lead):
                grid_noise = frame_draws(draws, 0) if fired[i] else None
                with trace.span("frame.eager"):
                    first, row = fw.step(
                        first, Command(speeds[0, i], speeds[1, i]), gen,
                        noise=None if grid_noise is None
                        else gs_model.UpdateNoise(*grid_noise),
                        landmark_noise=frame_draws(landmark_draws, 0)
                        if fired[i] else None)
                rows.append(row)
            prog = TickProgram(fw, first, rows, state, n_steps, gen, draws,
                               landmark_draws, graphs, mesh, eager=lead)
            f = int(fired[:lead].sum())
            for i in range(lead, n_steps):
                later[kinds[i]] -= 1
                prog.tick(kinds[i], speeds[:, i], f,
                          capture_after=graphs and later[kinds[i]] > 0)
                f += int(fired[i])
            last = prog.state._replace(
                scan_timer=timer, scan_counter=state.scan_counter + int(f))
            result = prog.outputs_as(torch.from_numpy(fired).to(dev))
            _hand_over(main, last, result)
        fw.capture_stats = prog.stats
        return last, result
