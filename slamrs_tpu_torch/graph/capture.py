"""Device work as captured CUDA graphs: the cadence rollout, one replay a
frame, and the tick-by-tick rollout, one replay a tick, on one device or
on a mesh whose entries are all one device; and the App's node updates,
one replay an update.

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
counters and statistics of each graph.  :class:`FrameProgram`, the world
program, serves both rollouts (:func:`run_program`, :func:`run_ticks`),
keyed by the work it runs (a scan frame, the trailing idle ticks, an
idle or a scan tick); the nodes of ``graph/nodes/`` hold one each
(``App(capture=...)``).  The world program's buffers:

* the world state: every tensor leaf of ``WorldState`` (every block of a
  sharded leaf, ``parallel.Sharded``).  The call that builds the program
  runs its work up to and including the first scan tick eagerly on the
  caller's state (the cadence rollout's frame 0, the tick rollout's lead
  ticks), and the result becomes the static state: from then on no leaf
  of the caller's state is in the static state where a scan writes
  afresh.  A leaf that the work writes as a fresh tensor (K1's lineage
  maps, the dda and dense maps, poses, weights, the ICP map) is copied
  back into its static leaf by the program's last nodes; a leaf that the
  route updates in place (K1 in place, K2, K3's tile pool, a fleet's
  maps) is not copied;
* each run's wheel speeds, ``f32[2, ticks]``, filled before each replay;
* injected draws (``noise=``, ``landmark_noise=``): every scan frame's
  moved to the device once a call, the frame's copied into the static
  draw buffers before each replay;
* the output rows ``[rows, ...]``, written at a frame index held on the
  device and advanced by the program; the caller gets a copy of the
  call's rows.

The host resolves the timer before the loop (``FusedWorld.
fire_schedule``), so a run holds no data-dependent control flow.  The
first run of a key runs eagerly on the capture stream and is then
captured; later runs replay its graph.  That warm-up is real work of the
rollout: it consumes the run's own draws, and the capture itself draws
nothing.  The graphs share one memory pool.

The program outlives the call, kept on the world
(``FusedWorld.frame_program``; it holds the world weakly).  A later call
of either rollout handed the state the last call returned runs on it
(:meth:`FrameProgram.takes`): the generator re-seeded, the frame index
reset, every run a replay but the first of a key the program has not
met.  Any other state (a fresh ``init()``, a checkpoint), or a call that
needs more output rows than the program holds, builds a new program,
which replaces the kept one.  A state handed to a captured rollout is
consumed: the state returned is the static buffers, and the old state
must not be used again.

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

Draws: the program's ``torch.Generator`` is registered with every graph,
so a replay draws what the eager run would (the generator's offset
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
(``ops/icp.py``); the first run is on the capture stream and makes
that stream's set, which the kernel leaves at zero, so every replay
starts clean.

No fallback: a capture or replay that fails raises.  ``graphs=False``
runs the same program without capturing it (the CPU tests).
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import inspect
import weakref
from typing import Optional

import numpy as np
import torch

from slamrs_tpu_torch.core.types import Command
from slamrs_tpu_torch.graph import compile as world_compile
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
        from slamrs_tpu_torch.models import simulator
        from slamrs_tpu_torch.ops import cow, fused, icp, tiles

        _COUNTERS = {
            "fused_update": (fused.fused_update, "launches"),
            "fused_update_in_place": (fused.fused_update,
                                      "in_place_launches"),
            "cow_copy": (cow.cow_copy, "launches"),
            "fused_update_tiled": (tiles.fused_update_tiled, "launches"),
            "nn_argmin": (icp.nearest_neighbors_fused, "launches"),
            "icp_solve": (icp.icp_solve, "launches"),
            "sim_frame": (simulator.sim_frame, "launches")}
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
    """What one captured rollout call did (``FusedWorld.capture_stats``):
    ``frames`` counts its scan frames (the tick rollout's: its ticks),
    ``eager`` and ``replays`` its runs, the trailing idle ticks' one run
    included.  The graphs are keyed as :class:`FrameProgram`'s (a run
    cut at the overflow read by ``(key, part)``); the per-graph tables
    (``launches``, ``copy_back_bytes``) are the program's, which a kept
    program carries from call to call.  ``ticks`` is always None."""

    frames: int = 0
    ticks: Optional[ProgramStats] = None


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

    def run(self, key):
        """The program of ``key``: a replay of its graph, or else the body
        run eagerly, then captured when ``graphs``.  Returns the body's
        outputs."""
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
        if self.graphs:
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




def _world_parts(fw) -> tuple:
    """What a world program bakes in of its world besides the state."""
    return (fw.scene, fw.params, fw.dt, fw.grid_config, fw.icp_config,
            fw.ekf_config, fw.num_beams)


class FrameProgram(Program):
    """A ``FusedWorld``'s program for both captured rollouts, kept on the
    world (``FusedWorld.frame_program``), with output rows for ``rows``
    frames or ticks.  Its keys:

    * ``k``: a scan frame of ``k`` idle ticks (``fw.frame``,
      :meth:`frame`), which writes a row;
    * ``("idle", n)``: the cadence rollout's ``n`` trailing idle ticks
      (``fw.idle``, :meth:`idle`), which writes none;
    * ``("tick", "idle")`` and ``("tick", "scan")``: one tick of the tick
      rollout (``fw.step`` with the timer forced so that only a scan tick
      fires, :meth:`tick`), which writes a row.

    ``first_rows`` are the rows of the eager work the program is built
    from.  A later call on its static state runs on it (:meth:`takes`,
    :meth:`start`).  The world is held weakly: the world keeps its
    program, and a cycle would leave both to the cyclic collector
    (:class:`Program`)."""

    def __init__(self, fw, first_state, first_rows, caller_state, rows: int,
                 generator, draws, landmark_draws, graphs: bool, mesh,
                 stats: CaptureStats):
        dev = first_state.pose.device
        super().__init__(self._work, dev, graphs, generator, stats)
        self._fw, self.mesh = weakref.ref(fw), mesh
        self.world = _world_parts(fw)
        self.rows = rows
        self.injected = (draws is not None, landmark_draws is not None)
        self.draws, self.landmark_draws = draws, landmark_draws
        self.own(first_state, caller_state)
        self.index = torch.zeros(1, dtype=torch.int64, device=dev)
        row = first_rows[0]
        self.outputs = {
            name: torch.empty((rows, *v.shape), dtype=v.dtype, device=dev)
            for name in _OUT_FIELDS
            if (v := getattr(row, name)) is not None
            and (name != "n_eff" or row.grid_pose is not None)}
        for row in first_rows:
            self._write_row(row)

    @property
    def fw(self):
        return self._fw()

    def takes(self, state, mesh, graphs: bool, draws, landmark_draws,
              rows: int) -> bool:
        """Whether a call on ``state`` (placed on ``mesh``) that writes
        ``rows`` output rows runs on this program: every tensor leaf of
        the state (every block of a sharded leaf) is the static leaf, on
        the same mesh, with or without graphs and injected draws as the
        program was built, for a world unchanged, and the rows fit."""
        leaves = _tensor_leaves(state)
        static = _tensor_leaves(self.state)
        return (len(leaves) == len(static)
                and all(a is b for a, b in zip(leaves, static))
                and mesh == self.mesh and graphs == self.graphs
                and self.injected == (draws is not None,
                                      landmark_draws is not None)
                and all(a is b for a, b in zip(_world_parts(self.fw),
                                               self.world))
                and rows <= self.rows)

    def start(self, seed: int, draws, landmark_draws,
              stats: CaptureStats) -> None:
        """A call on the kept program: the generator seeded with
        ``seed``, as a fresh program's would be, the call's draws taken,
        the frame index back at 0, the call's own ``stats``."""
        self.generator.manual_seed(seed)
        self.draws, self.landmark_draws = draws, landmark_draws
        self.index.zero_()
        self.restart(stats)

    def _write_row(self, row) -> None:
        for name, buf in self.outputs.items():
            buf.index_copy_(0, self.index, getattr(row, name).unsqueeze(0))
        self.index.add_(1)

    def _work(self, key) -> None:
        """The work of ``key`` on the static buffers."""
        speeds = self.inputs[("speeds", key)]
        noise = self.inputs.get("noise")
        landmark_noise = self.inputs.get("landmark_noise")
        if isinstance(key, int):
            new_state, row = self.fw.frame(self.state, speeds, self.generator,
                                           noise, landmark_noise)
        elif key[0] == "idle":
            new_state, row = self.fw.idle(self.state, speeds, self.mesh), None
        else:
            scan = key[1] == "scan"
            new_state, row = self.fw.step(
                self.state._replace(scan_timer=0.0),
                Command(speeds[0, 0], speeds[1, 0]), self.generator,
                force_fire=scan, noise=noise if scan else None,
                landmark_noise=landmark_noise if scan else None)
            if row.fired != scan:
                raise RuntimeError("world program: an idle tick fired (the "
                                   "period is shorter than a tick)")
        if row is not None:
            self._write_row(row)
        self.copy_back(new_state)

    def _run(self, key, speeds: Tensor, f: Optional[int]) -> None:
        """The run of ``key`` at ``speeds``, with scan frame ``f``'s
        injected draws (None: no scan): a replay of its graph, or else
        the program run eagerly, then captured."""
        with trace.span("frame.fill"):
            self.fill(("speeds", key), speeds)
            if f is not None:
                for name, draws in (("noise", self.draws),
                                    ("landmark_noise", self.landmark_draws)):
                    if draws is not None:
                        self.fill(name, world_compile.frame_draws(draws, f))
        self.run(key)

    def frame(self, k: int, speeds: Tensor, f: int) -> None:
        """Scan frame ``f`` of ``k`` idle ticks at ``speeds``
        (f32[2, k + 1])."""
        self._run(k, speeds, f)

    def idle(self, speeds: Tensor) -> None:
        """The idle ticks at ``speeds`` (f32[2, n]) as one run."""
        self._run(("idle", speeds.shape[1]), speeds, None)

    def tick(self, kind: str, speeds: Tensor, f: int) -> None:
        """One tick of ``kind`` at ``speeds`` (f32[2, 1]); a scan tick
        takes scan frame ``f``'s injected draws."""
        self._run(("tick", kind), speeds, f if kind == "scan" else None)

    def outputs_as(self, fired: Tensor):
        """A copy of the ``len(fired)`` rows written, which later runs
        leave alone."""
        n = fired.shape[0]
        outs = {name: buf[:n].clone() for name, buf in self.outputs.items()}
        return world_compile.WorldOutputs(
            fired=fired, pose=outs["pose"], grid_pose=outs.get("grid_pose"),
            icp_pose=outs.get("icp_pose"), ekf_pose=outs.get("ekf_pose"),
            n_eff=outs.get("n_eff"))


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


def _hand_over(main, *trees) -> None:
    """Tensors made on the capture stream, used on the caller's stream
    from here on."""
    if main is not None:
        with trace.span("rollout.hand_over"):
            for tree in trees:
                for t in _tensor_leaves(tree):
                    t.record_stream(main)


# the host counter of a rollout call that ran on a kept program
REUSED = "rollout.program_reused"


def _frames_max(fw, n_steps: int) -> int:
    """The most scan frames ``n_steps`` ticks can fire from a timer at
    most one period: one a period, one more for the timer's start and
    one for float32 rounding; every tick without a period."""
    period = float(np.float32(fw.params.update_period))
    if period <= 0.0:
        return n_steps
    return min(n_steps, int(n_steps * fw.dt / period) + 2)


class _Call:
    """What a captured rollout call starts from: the state placed
    (``mesh``), its device and, with graphs, the caller's stream
    ``main``, the commands as ``speeds`` (f32[2, n_steps]), the scan
    ticks ``fire_idx`` and the timer after the call; then (:meth:`upload`)
    the injected draws of every scan frame on the device."""

    def __init__(self, fw, state, n_steps: int, commands, timer,
                 graphs: bool, what: str):
        self.state, self.mesh = fw._placed(state)
        self.dev = self.state.pose.device
        self.main = None
        if graphs:
            check_graphs(self.mesh, self.dev, what)
            self.main = torch.cuda.current_stream(self.dev)
        if commands is None:
            commands = fw.commands_for(n_steps)
        self.speeds = torch.stack([commands.speed_left,
                                   commands.speed_right]).to(self.dev)
        self.fire_idx, self.timer = fw.fire_schedule(
            n_steps, self.state.scan_timer if timer is None else timer)

    def upload(self, noise, landmark_noise) -> None:
        """The injected draws, which must cover the call's scan frames."""
        for given in (noise, landmark_noise):
            if given is not None and len(given[0]) < self.fire_idx.size:
                raise ValueError(f"injected draws for {len(given[0])} scan "
                                 f"frames, the rollout scans "
                                 f"{self.fire_idx.size} times")
        with trace.span("rollout.draws_upload"):
            self.draws, self.landmark_draws = world_compile.device_draws(
                noise, landmark_noise, self.dev)

    def scan_draws(self, f: int) -> tuple:
        """Scan frame ``f``'s injected draws: ``(noise, landmark_noise)``."""
        return (world_compile.frame_draws(self.draws, f),
                world_compile.frame_draws(self.landmark_draws, f))

    def on_stream(self):
        """The block on the capture stream, with graphs."""
        return contextlib.nullcontext() if self.main is None \
            else on_capture_stream(self.dev)

    def finish(self, prog: FrameProgram, scans: int, fired: Tensor):
        """The call's returned state and outputs, handed to the caller's
        stream; the call's draws let go."""
        prog.draws = prog.landmark_draws = None
        last = prog.state._replace(
            scan_timer=self.timer,
            scan_counter=self.state.scan_counter + scans)
        result = prog.outputs_as(fired)
        _hand_over(self.main, last, result)
        return last, result


def _program_for(fw, call: _Call, seed: int, n_steps: int, rows: int,
                 graphs: bool, stats: CaptureStats, lead):
    """``(program, runs)``: the program a call that writes ``rows`` output
    rows runs on, and how many of its frames or ticks are done.  The
    kept program (``fw.frame_program``) when it takes the call (counted
    as :data:`REUSED`), restarted, with none done; else a new program
    built from ``lead(generator)``, the eager run of the call's work up
    to and including its first scan tick, which returns the state after
    it and its rows.  The kept program goes before the build (its pool
    and buffers would stack on the new one's); the new one is kept when
    its lead held a scan tick, after which no leaf of the caller's
    state is in the static state where a scan writes afresh."""
    prog = fw.frame_program
    if prog is not None and prog.takes(call.state, call.mesh, graphs,
                                       call.draws, call.landmark_draws,
                                       rows):
        trace.count(REUSED, 1)
        prog.start(seed, call.draws, call.landmark_draws, stats)
        return prog, 0
    fw.frame_program = None
    gen = fw._generator(seed, call.mesh)
    first, first_rows = lead(gen)
    stats.eager = len(first_rows)
    prog = FrameProgram(fw, first, first_rows, call.state,
                        max(rows, _frames_max(fw, n_steps)), gen, call.draws,
                        call.landmark_draws, graphs, call.mesh, stats)
    if any(row.fired for row in first_rows):
        fw.frame_program = prog
    return prog, len(first_rows)


def run_program(fw, state, n_steps: int, seed: int = 0, commands=None,
                initial_timer: Optional[float] = None, noise=None,
                landmark_noise=None, graphs: bool = True):
    """``fw.rollout_cadence`` through the world program, on one device or
    on a mesh whose entries are all one device: with ``graphs`` each
    run after the first of its key is a CUDA graph replay (on CUDA
    only); without, the program runs eagerly on any device (the CPU
    tests hold it to the eager loop).  A call handed the state the last
    call on ``fw`` returned runs on the kept program
    (``fw.frame_program``); any other state builds one, frame 0 run
    eagerly on it, which replaces the kept one.  ``state`` is consumed:
    the state returned shares its storage.  The trailing idle ticks after
    the last scan are one run; a call in which no scan fires is the tick
    rollout's (:func:`run_ticks`).  Sets ``fw.capture_stats``, the call's
    own.

    Traced as the call ``rollout_cadence`` (``utils/trace.py``): spans
    ``rollout.draws_upload``, ``frame.eager``, ``frame.capture``,
    ``frame.fill``, ``graph.launch``, ``rollout.ticks`` and
    ``rollout.hand_over``, the counter ``rollout.frames``, and
    :data:`REUSED` (1) in a call on the kept program."""
    with trace.call("rollout_cadence"):
        call = _Call(fw, state, n_steps, commands, initial_timer, graphs,
                     "the frame program")
        fire_idx, speeds = call.fire_idx, call.speeds
        if fire_idx.size == 0:
            return run_ticks(fw, state, n_steps, seed, commands,
                             graphs=graphs)
        call.upload(noise, landmark_noise)
        frames = len(fire_idx)
        trace.count("rollout.frames", frames)
        idle = np.diff(fire_idx, prepend=-1) - 1  # idle ticks before each scan

        def frame_0(gen):
            with trace.span("frame.eager"):
                built, row = fw.frame(
                    call.state, speeds[:, :fire_idx[0] + 1], gen,
                    *call.scan_draws(0))
            return built, [row]

        with call.on_stream():
            prog, done = _program_for(fw, call, seed, n_steps, frames,
                                      graphs, CaptureStats(frames=frames),
                                      frame_0)
            for f in range(done, frames):
                k = int(idle[f])
                e = int(fire_idx[f])
                prog.frame(k, speeds[:, e - k:e + 1], f)
            trailing = n_steps - 1 - int(fire_idx[-1])
            if trailing:
                with trace.span("rollout.ticks"):
                    prog.idle(speeds[:, n_steps - trailing:])
            out = call.finish(prog, frames, torch.ones(
                frames, dtype=torch.bool, device=call.dev))
        fw.capture_stats = prog.stats
        return out


def run_ticks(fw, state, n_steps: int, seed: int = 0, commands=None,
              noise=None, landmark_noise=None, graphs: bool = True):
    """``fw.rollout`` through the world program, on one device or on a
    mesh whose entries are all one device: the host timer gives each
    tick's kind before the loop, and each tick is a run of its kind
    (with ``graphs`` a replay after the first, on CUDA only).  The
    program is kept and taken as :func:`run_program`'s is; a call that
    builds one runs its ticks up to and including the first scan tick
    eagerly on ``state``.  ``state`` is consumed: the state returned
    shares its storage.  ``noise`` and ``landmark_noise`` hold each scan
    frame's draws.  Sets ``fw.capture_stats``.

    Traced as the call ``rollout`` (inside ``rollout_cadence``, a span of
    it), with :func:`run_program`'s spans and ``rollout.frames`` counting
    ticks."""
    with trace.call("rollout"):
        call = _Call(fw, state, n_steps, commands, None, graphs,
                     "the tick program")
        call.upload(noise, landmark_noise)
        fire_idx, speeds = call.fire_idx, call.speeds
        fired = np.zeros(n_steps, bool)
        fired[fire_idx] = True
        trace.count("rollout.frames", n_steps)
        lead = int(fire_idx[0]) + 1 if fire_idx.size else n_steps

        def lead_ticks(gen):
            first, rows = call.state, []
            for i in range(lead):
                noise, landmark_noise = (call.scan_draws(0) if fired[i]
                                         else (None, None))
                with trace.span("frame.eager"):
                    first, row = fw.step(
                        first, Command(speeds[0, i], speeds[1, i]), gen,
                        noise=noise, landmark_noise=landmark_noise)
                rows.append(row)
            return first, rows

        with call.on_stream():
            prog, done = _program_for(fw, call, seed, n_steps, n_steps,
                                      graphs, CaptureStats(frames=n_steps),
                                      lead_ticks)
            f = int(fired[:done].sum())
            for i in range(done, n_steps):
                prog.tick("scan" if fired[i] else "idle", speeds[:, i:i + 1],
                          f)
                f += int(fired[i])
            out = call.finish(prog, int(fire_idx.size),
                              torch.from_numpy(fired).to(call.dev))
        fw.capture_stats = prog.stats
        return out
