"""Named spans, calls and counters of the port's host work.

Counterpart of ``slamrs_tpu/utils/trace.py``: a process-global registry
of named statistics and a ``span`` context manager that logs each span's
duration when it closes.  Here the registry also keeps each span's
**self time**, and a call into the program keeps a record of its own:

* :class:`span` measures host time (``time.perf_counter_ns``; it does not
  wait for the device) and keeps the stack of open spans, so each close
  adds its count, total and self time (its duration less the time of the
  spans opened directly inside it) to :func:`stats`.  While a
  ``torch.profiler`` records, the span is also a
  ``torch.profiler.record_function`` range, so it lies on the trace's
  timeline beside the kernels it launched; with no profiler recording it
  opens none.
* :class:`call` is the root span of one request into the program.  When
  it closes it appends a record to :func:`calls` (the last
  :data:`MAX_CALLS`): its duration and self time, each span opened under
  it by name, the host counters counted under it and what each device
  counter gained.  A span with no call open only adds to the registry; a
  call opened inside another is a span of the outer one.
* :func:`count` is a host counter: a process total and the open call's.
* :func:`device_counter` is a 0-dim int64 tensor that device work adds
  into, so the host never waits; it is read (``.item()``) only by whoever
  asks for it after the work (:func:`device_counts`).
* :data:`replay_stride` samples the device's idle on a rollout call's
  graph replays, with the profiler off: timed device events (points)
  recorded around every ``n``-th frame of the call's loop and at the
  call's ends, each beside the host's ``perf_counter_ns`` stamp of the
  same moment, and put on the host's clock once they have completed
  (see "Device idle" below).

Span names do not start with ``cu`` and hold none of ``LaunchKernel``,
``GraphLaunch``, ``Memcpy`` and ``Memset``: a profile's readers count the
host's CUDA calls by those names.

Device idle
-----------
A rollout call that replays graphs (``graph/capture.py``) records points:
its head (:func:`replays_open`, before its first device work), the end
of its loop's first two replays and of every ``n``-th loop frame's
replay after them and the next frame's (:func:`replay_sample`; the
first sampled frame moves by one a call), the loop's end
(:func:`replay_loop_end`), the end of the trailing ticks' replay and the
call's close.  A point is a timed event recorded on the
stream the call's work runs on (:func:`replays_stream`), beside the
host's ``perf_counter_ns`` stamp taken just before it.

*One clock.*  An event fires no earlier than the host enqueued it, and
at once when the device is waiting.  So a call's device times (its
events' elapsed time since its head) are put on the host clock at the
largest ``host stamp - device time`` over its points and the next
call's head (through the elapsed time between the two calls): exact
wherever the device waited, which is where idle is read.

*Idle.*  From each point the device has finished all work enqueued
before it; the next work is enqueued by the next point.  So the stretch
from a point's device time to the next point's host stamp, where it is
positive, is idle (the next call's head closes a call's last stretch).
The small copies a fill, the clones of the outputs or the caller enqueue
between two points count in the idle around them, and so does any part
of a replay the device runs before ``graph.replay()`` returns.  A sampled
cycle (a sampled frame's replay's end to the next frame's) is split over
the next frame's ``frame.fill`` and ``graph.launch`` spans, the rest
being the loop's own Python; the unsampled frames' stretches are not
read.  The call's ends are its stretches before its loop's second
replay's end (the first frame's cycle starts on a device that has
drained at the call's head, so it is read whole and not sampled; in a
call that builds its program, the eager and captured frames before it
too) and after its loop: each is split over the
:class:`end_span` spans it overlaps (the draws' upload, the lead's eager
frame, the trailing ticks, the hand-over), the rest being ``call`` (the
call's own Python outside its loop) or, after its close, ``outside``.

A call is *profiled* where a span opened, or the call opened or closed,
while a ``torch.profiler`` recorded: the profiler's cost then lies in
the whole call, not only in the frames it recorded (after ``stop()``
the host runs slower for a while).  Events come
from a pool, and a call's points are resolved (their ``elapsed_time``
read) when :func:`calls` is read, once they and the next call's head
have completed: the host never waits for them, and a run that reads no
record pays no ``elapsed_time``.  The record of such a call gains ``replays`` (see
:func:`calls`).
"""

from __future__ import annotations

import collections
import logging
import math
import threading
import time
from typing import Optional

import torch

from slamrs_tpu_torch.utils.perf import PerfStats

logger = logging.getLogger("slamrs_tpu_torch")

MAX_CALLS = 4096
# the profiler's names of the host's CUDA calls, which no span may match
_CUDA_CALL_NAMES = ("LaunchKernel", "GraphLaunch", "Memcpy", "Memset")
_profiling = torch.autograd._profiler_enabled
_clock = time.perf_counter_ns


class SpanStats:
    """A span's statistics, kept in integer nanoseconds as spans close
    (:meth:`span.__exit__`) and read as :class:`~slamrs_tpu_torch.utils.perf.PerfStats` reads
    (``mean``, ``std``, ``min``, ``max``, ``latest`` in milliseconds,
    ``sample_count``), with its total and self seconds."""

    __slots__ = ("sample_count", "total_ns", "self_ns", "square_ns",
                 "min_ns", "max_ns", "latest_ns")

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.sample_count = self.total_ns = self.self_ns = 0
        self.square_ns = self.latest_ns = 0
        self.min_ns, self.max_ns = math.inf, -math.inf

    @property
    def total_seconds(self) -> float:
        return self.total_ns * 1e-9

    @property
    def self_seconds(self) -> float:
        return self.self_ns * 1e-9

    @property
    def mean(self) -> float:
        n = self.sample_count
        return self.total_ns / n * 1e-6 if n else 0.0

    @property
    def std(self) -> float:
        n = self.sample_count
        if not n:
            return 0.0
        mean = self.total_ns / n
        return math.sqrt(max(self.square_ns / n - mean * mean, 0.0)) * 1e-6

    @property
    def min(self) -> float:
        return self.min_ns * 1e-6

    @property
    def max(self) -> float:
        return self.max_ns * 1e-6

    @property
    def latest(self) -> float:
        return self.latest_ns * 1e-6

    def latest_fps(self) -> float:
        return 1e9 / self.latest_ns if self.latest_ns > 0 else math.inf

    __str__ = PerfStats.__str__


class _Thread(threading.local):
    def __init__(self):
        self.stack: list = []  # the open spans, innermost last
        self.call = None  # the open root call


_THREAD = _Thread()
_REGISTRY: dict[str, SpanStats] = {}
_COUNTS: dict[str, int] = {}
_CALLS: collections.deque = collections.deque(maxlen=MAX_CALLS)
_DEVICE: dict[tuple, torch.Tensor] = {}  # (name, device) -> the counter
_TAKEN: dict[tuple, torch.Tensor] = {}  # its copy at the last call's close


def _check_name(name: str) -> None:
    """Raise if a profile's readers would count span ``name`` as a host
    CUDA call."""
    if name.startswith("cu") or any(c in name for c in _CUDA_CALL_NAMES):
        raise ValueError(f"span name {name!r} reads as a host CUDA call")


def stats(name: str) -> SpanStats:
    s = _REGISTRY.get(name)
    if s is None:
        _check_name(name)
        s = _REGISTRY[name] = SpanStats()
    return s


def all_stats() -> dict[str, SpanStats]:
    return dict(_REGISTRY)


def calls() -> list[dict]:
    """The records of the last :data:`MAX_CALLS` calls, oldest first.

    A call whose replays were sampled (module docstring, "Device idle")
    has, once its points have completed, ``replays``: ``every`` (the
    stride), ``cycles`` (its loop's runs after the second), ``loop_s``
    (their host seconds: the second replay's end to the loop's end),
    ``samples`` (per sampled cycle
    the seconds of idle under ``fill``, ``launch`` and ``loop``,
    ``host``, its host seconds, and ``device``, its two replays' ends on
    the host clock in seconds after the call's head), ``profiled``
    (a profiler recorded during the call),
    ``ends`` (seconds of idle at the call's ends by span, ``call`` and
    ``outside``; no ``outside`` while no later call has opened),
    ``head_ns`` (the head's host stamp) and ``wall_s`` (head to the next
    call's head; while no later call has opened, to the call's close).
    """
    _resolve_pending()
    return list(_CALLS)


def counts() -> dict[str, int]:
    """Every host counter's process total."""
    return dict(_COUNTS)


def reset() -> None:
    """Forget every span, call record and host count; device counters are
    zeroed in place (a captured graph may add into them)."""
    global _opened
    _REGISTRY.clear()
    _COUNTS.clear()
    _CALLS.clear()
    _TAKEN.clear()
    _PENDING.clear()
    _opened = 0
    for t in _DEVICE.values():
        t.zero_()


class span:
    """A timed block (see the module's docstring), logged at debug level
    when it closes; after it closes, ``seconds`` and ``self_seconds``
    hold its duration and self time."""

    __slots__ = ("name", "ns", "self_ns", "_t0", "_inner", "_range")

    def __init__(self, name: str):
        self.name = name
        self.ns = self.self_ns = 0

    @property
    def seconds(self) -> float:
        return self.ns * 1e-9

    @property
    def self_seconds(self) -> float:
        return self.self_ns * 1e-9

    def __enter__(self):
        if _profiling():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
            _profiled()
        else:
            self._range = None
        self._inner = 0
        _THREAD.stack.append(self)
        self._t0 = _clock()
        return self

    def __exit__(self, typ, value, tb):
        ns = _clock() - self._t0
        th = _THREAD
        stack = th.stack
        stack.pop()
        if stack:
            stack[-1]._inner += ns
        self.ns = ns
        self.self_ns = self_ns = ns - self._inner
        if self._range is not None:
            self._range.__exit__(typ, value, tb)
        st = _REGISTRY.get(self.name) or stats(self.name)
        st.sample_count += 1
        st.total_ns += ns
        st.self_ns += self_ns
        st.square_ns += ns * ns
        st.latest_ns = ns
        if ns < st.min_ns:
            st.min_ns = ns
        if ns > st.max_ns:
            st.max_ns = ns
        c = th.call
        if c is not None and c is not self:
            s = c._spans.get(self.name)
            if s is None:
                c._spans[self.name] = [1, ns, self_ns]
            else:
                s[0] += 1
                s[1] += ns
                s[2] += self_ns
        if logger.isEnabledFor(logging.DEBUG):
            logger.debug("span %s closed: %.3f ms", self.name, ns * 1e-6)
        return False


class call(span):
    """The root span of one request into the program: on close, a record
    in :func:`calls` (see the module's docstring).  Opened inside another
    call it is a span of that call."""

    __slots__ = ("_spans", "_counts", "_replays")

    def __enter__(self):
        th = _THREAD
        if th.call is None:
            th.call = self
            self._spans, self._counts = {}, {}
            self._replays = None
        return super().__enter__()

    def __exit__(self, typ, value, tb):
        th = _THREAD
        replays = self._replays if th.call is self else None
        if replays is not None:
            replays.mark(OUTSIDE)
            replays.profiled |= _profiling()
        super().__exit__(typ, value, tb)
        if th.call is self:
            th.call = None
            record = {
                "name": self.name, "seconds": self.seconds,
                "self_seconds": self.self_seconds,
                "spans": {n: {"count": c, "seconds": t * 1e-9,
                              "self_seconds": s * 1e-9}
                          for n, (c, t, s) in self._spans.items()},
                "counts": self._counts, "device": _device_gains()}
            _CALLS.append(record)
            if replays is not None:
                replays.record = record
                _PENDING.append(replays)
        return False


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to host counter ``name``: its process total and the open
    call's."""
    _COUNTS[name] = _COUNTS.get(name, 0) + n
    c = _THREAD.call
    if c is not None:
        c._counts[name] = c._counts.get(name, 0) + n


def device_counter(name: str, device) -> torch.Tensor:
    """Device counter ``name`` on ``device``: a 0-dim int64 tensor that
    device work adds into (``counter.add_(n)``), made on first use, which
    must not fall inside a CUDA graph capture (a captured add needs the
    counter to exist before it)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = (name, str(device))
    t = _DEVICE.get(key)
    if t is None:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"device counter {name!r} is first used "
                               "inside a CUDA graph capture; use it once "
                               "before capturing")
        t = _DEVICE[key] = torch.zeros((), dtype=torch.int64, device=device)
    return t


def device_counts() -> dict[str, int]:
    """Every device counter's value, summed over devices (reads each on
    the host, so it waits for the work that adds into it)."""
    out: dict[str, int] = {}
    for (name, _), t in _DEVICE.items():
        out[name] = out.get(name, 0) + int(t.item())
    return out


def _device_gains() -> dict[str, list]:
    """What each device counter gained since the last call closed, as
    0-dim tensors on its device (one per device): a copy of the counter
    taken on the current stream, read by nobody until asked."""
    gains: dict[str, list] = {}
    for key, t in _DEVICE.items():
        now = t.clone()
        before = _TAKEN.get(key)
        _TAKEN[key] = now
        gains.setdefault(key[0], []).append(
            now if before is None else now - before)
    return gains


# --- device idle on a rollout call's replays -------------------------------

#: every ``replay_stride``-th frame of a rollout call's loop is sampled,
#: with the call's ends; 0: off (no event is made or recorded, nothing is
#: added to a call's record).  The default's cost is within the noise of
#: the headline cells' rate on the card (PERF.md §6)
replay_stride = 64
# a point's phase names the stretch after it: the loop's points (SAMPLE,
# a sampled cycle's; GAP, the others) are read through the cycles, the
# rest as the call's ends
SAMPLE, GAP = "sample", "gap"
CALL, OUTSIDE = "call", "outside"
# closed calls' points, not yet resolved (with their records, the oldest
# are dropped)
_PENDING: collections.deque = collections.deque(maxlen=MAX_CALLS)
_opened = 0  # calls whose points were recorded, since reset()


class CudaTimer:
    """Device timestamps from timed CUDA events.  Another timer (a
    test's) has the same ``event()`` (a new event, with
    ``record(stream)``, ``query()`` and ``elapsed_time(end)`` in
    milliseconds) and ``free``."""

    def __init__(self):
        self.free: list = []  # resolved events, to be recorded again

    @staticmethod
    def event():
        return torch.cuda.Event(enable_timing=True)


_TIMER = CudaTimer()


class _Replays:
    """One call's points (``(event, host ns, phase)`` in order), its
    sampled cycles and where its loop stands."""

    __slots__ = ("stream", "every", "offset", "points", "samples", "open",
                 "loop", "runs", "loop_ns", "spans", "profiled", "record",
                 "next")

    def __init__(self, stream, offset: int):
        self.stream = stream  # the stream the call's work runs on now
        self.every, self.offset = replay_stride, offset
        self.points: list = []
        self.samples: list = []
        self.open = None  # the cycle that waits for its second replay
        self.loop = False
        self.runs = 0
        self.loop_ns = [None, None]  # its second replay's end, its end
        self.spans: list = []  # the ends' spans: (name, host ns, host ns)
        self.profiled = _profiling()
        self.record = None
        self.next = None  # the next call's head: (event, host ns)

    def mark(self, phase) -> int:
        """A point: the host's stamp, then an event recorded on the
        call's current stream."""
        free = _TIMER.free
        ev = free.pop() if free else _TIMER.event()
        ns = _clock()
        ev.record(self.stream)
        self.points.append((ev, ns, phase))
        return len(self.points) - 1


class _Cycle:
    """A sampled cycle: from the end of a sampled frame's replay to the
    end of the next frame's, with that frame's ``frame.fill`` span and
    its launch's host interval."""

    __slots__ = ("first", "last", "fill", "launch")

    def __init__(self, first: int):
        self.first = first
        self.last = self.fill = self.launch = None


class _Sample:
    """A loop frame's run: a sampled frame's, whose replay's end opens a
    cycle, or the next frame's, which closes it; or (``sampled`` None) a
    run at the call's ends, whose replay's end is a point.  A run that
    replays nothing (eager, then captured) neither closes nor opens
    one."""

    __slots__ = ("replays", "sampled", "cycle", "fill", "before")

    def __init__(self, replays: _Replays, sampled: bool, fill: span):
        self.replays, self.sampled, self.fill = replays, sampled, fill
        self.cycle = replays.open
        replays.open = None

    def replaying(self) -> None:
        """Before the run's launch (its replays and, in a split program,
        its reads between them)."""
        self.before = _clock()

    def replayed(self) -> None:
        """After its launch: the cycle that ends here is closed, with the
        launch's host interval, and a sampled frame opens one."""
        r = self.replays
        if self.sampled is None:
            r.mark(CALL)
            return
        point = r.mark(SAMPLE if self.sampled else GAP)
        if r.loop_ns[0] is None:
            r.loop_ns[0] = r.points[point][1]
        c = self.cycle
        if c is not None:
            c.last, c.fill = point, self.fill
            c.launch = (self.before, r.points[point][1])
            r.samples.append(c)
        if self.sampled:
            r.open = _Cycle(point)


def _replays() -> Optional[_Replays]:
    c = _THREAD.call
    return None if c is None else c._replays


def _profiled() -> None:
    """A profiler records in the open call."""
    r = _replays()
    if r is not None:
        r.profiled = True


def replays_open(stream) -> None:
    """The open call's head, right before its first device work, which
    runs on ``stream``: with replays sampled, the call's first point; it
    also closes the last call's ends."""
    global _opened
    c = _THREAD.call
    if not replay_stride or c is None or c._replays is not None:
        return
    r = c._replays = _Replays(stream, _opened % replay_stride)
    _opened += 1
    r.mark(CALL)
    if _PENDING and _PENDING[-1].next is None:
        _PENDING[-1].next = r.points[0][:2]


def replays_stream(stream) -> None:
    """The open call's work runs on ``stream`` from here on."""
    r = _replays()
    if r is not None:
        r.stream = stream


def replay_loop_start() -> None:
    """The open call's frame loop starts."""
    r = _replays()
    if r is not None:
        r.loop = True


def replay_sample(fill: span) -> Optional[_Sample]:
    """At a run's start, before its fill (``fill``, the ``frame.fill``
    span about to open): the run, where its replay's end is a point, else
    None.  The loop's first two runs end the call's head; after them a
    run is sampled every ``replay_stride``-th from the call's offset
    (which moves by one a call, so that over calls every place in the
    loop is sampled alike), and the run after a sampled one closes its
    cycle.  After the loop (the trailing ticks), the run ends the call's
    tail."""
    r = _replays()
    if r is None:
        return None
    if not r.loop:
        return _Sample(r, None, fill)
    i = r.runs
    r.runs += 1
    if i == 0:
        return _Sample(r, None, fill)
    sampled = (i - 1) % r.every == r.offset
    if i > 1 and r.open is None and not sampled:
        return None
    return _Sample(r, sampled, fill)


def replay_loop_end() -> None:
    """The open call's frame loop has ended: a point, where the call's
    tail starts (a cycle still open has no second replay and is not
    read)."""
    r = _replays()
    if r is not None:
        r.loop, r.open = False, None
        r.mark(CALL)
        r.loop_ns[1] = r.points[-1][1]


class end_span(span):
    """A span at a rollout call's ends (outside its frame loop): with the
    call's replays sampled, the device's idle in it is put down to its
    name."""

    __slots__ = ()

    def __exit__(self, typ, value, tb):
        super().__exit__(typ, value, tb)
        r = _replays()
        if r is not None and not r.loop:
            r.spans.append((self.name, self._t0, self._t0 + self.ns))
        return False


def _resolve_pending() -> None:
    """Resolve each closed call whose points and the next call's head
    have completed, or, where no later call has opened yet, whose own
    points have (it then reads no ``outside``)."""
    keep = []
    for r in _PENDING:
        last = r.points[-1] if r.next is None else r.next
        if last[0].query():
            _resolve(r)
        else:
            keep.append(r)
    _PENDING.clear()
    _PENDING.extend(keep)


def _overlap(lo: int, hi: int, t0: int, t1: int) -> int:
    return max(0, min(hi, t1) - max(lo, t0))


def _resolve(r: _Replays) -> None:
    """Put ``r``'s points on the host clock, read the idle and add
    ``replays`` to its call's record; the events go back to the pool."""
    points = r.points
    head = points[0][0]
    # the next call's head, on this call's clock through the elapsed
    # time from this call's head: its device waits there after a caller
    # that copied the outputs to the host
    chain = points if r.next is None else [*points, (*r.next, OUTSIDE)]
    host = [ns for _, ns, _ in chain]
    since = [0] + [round(head.elapsed_time(ev) * 1e6)
                   for ev, _, _ in chain[1:]]
    offset = max(h - d for h, d in zip(host, since))
    dev = [offset + d for d in since]
    ends = {name: 0.0 for name, _, _ in r.spans}
    for i, (_, _, phase) in enumerate(points):
        if phase in (SAMPLE, GAP) or i + 1 == len(chain):
            continue
        lo, hi = dev[i], host[i + 1]
        rest = max(0, hi - lo)
        for name, t0, t1 in r.spans:  # they do not overlap each other
            if (o := _overlap(lo, hi, t0, t1)):
                ends[name] += o * 1e-9
                rest -= o
        ends[phase] = ends.get(phase, 0.0) + rest * 1e-9
    samples = []
    for c in r.samples:
        lo, hi = dev[c.first], host[c.last]
        fill = _overlap(lo, hi, c.fill._t0, c.fill._t0 + c.fill.ns)
        launch = _overlap(lo, hi, *c.launch)
        samples.append({
            "fill": fill * 1e-9, "launch": launch * 1e-9,
            "loop": (max(0, hi - lo) - fill - launch) * 1e-9,
            "host": (host[c.last] - host[c.first]) * 1e-9,
            "device": ((dev[c.first] - host[0]) * 1e-9,
                       (dev[c.last] - host[0]) * 1e-9)})
    start, end = r.loop_ns
    looped = start is not None and end is not None
    r.record["replays"] = {
        "every": r.every, "cycles": r.runs - 2 if looped else 0,
        "samples": samples, "profiled": r.profiled,
        "loop_s": (end - start) * 1e-9 if looped else 0.0,
        "ends": ends, "head_ns": host[0], "wall_s": (host[-1] - host[0]) * 1e-9}
    _TIMER.free.extend(ev for ev, _, _ in points)


def report() -> str:
    """Formatted dump of every span's statistics."""
    lines = [f"{name:40s} {st}" for name, st in sorted(_REGISTRY.items())]
    return "\n".join(lines)
