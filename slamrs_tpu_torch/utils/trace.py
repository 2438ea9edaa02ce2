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

Span names do not start with ``cu`` and hold none of ``LaunchKernel``,
``GraphLaunch``, ``Memcpy`` and ``Memset``: a profile's readers count the
host's CUDA calls by those names.
"""

from __future__ import annotations

import collections
import logging
import math
import threading
import time

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
    """The records of the last :data:`MAX_CALLS` calls, oldest first."""
    return list(_CALLS)


def counts() -> dict[str, int]:
    """Every host counter's process total."""
    return dict(_COUNTS)


def reset() -> None:
    """Forget every span, call record and host count; device counters are
    zeroed in place (a captured graph may add into them)."""
    _REGISTRY.clear()
    _COUNTS.clear()
    _CALLS.clear()
    _TAKEN.clear()
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

    __slots__ = ("_spans", "_counts")

    def __enter__(self):
        th = _THREAD
        if th.call is None:
            th.call = self
            self._spans, self._counts = {}, {}
        return super().__enter__()

    def __exit__(self, typ, value, tb):
        super().__exit__(typ, value, tb)
        th = _THREAD
        if th.call is self:
            th.call = None
            _CALLS.append({
                "name": self.name, "seconds": self.seconds,
                "self_seconds": self.self_seconds,
                "spans": {n: {"count": c, "seconds": t * 1e-9,
                              "self_seconds": s * 1e-9}
                          for n, (c, t, s) in self._spans.items()},
                "counts": self._counts, "device": _device_gains()})
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


def report() -> str:
    """Formatted dump of every span's statistics."""
    lines = [f"{name:40s} {st}" for name, st in sorted(_REGISTRY.items())]
    return "\n".join(lines)
