"""Named spans with timing statistics.

Counterpart of ``slamrs_tpu/utils/trace.py``: a process-global registry
of named :class:`~slamrs_tpu_torch.utils.perf.PerfStats`, a ``span``
context manager that logs each span's duration when it closes, and the
``instrument`` decorator.  Each span is also a
``torch.profiler.record_function`` range, so it shows in a
``torch.profiler`` trace beside the device's kernels.  The recorded
duration is host time: the span does not wait for the device.
"""

from __future__ import annotations

import contextlib
import functools
import logging
import time
from typing import Optional

import torch

from slamrs_tpu_torch.utils.perf import PerfStats

logger = logging.getLogger("slamrs_tpu_torch")

_REGISTRY: dict[str, PerfStats] = {}


def stats(name: str) -> PerfStats:
    s = _REGISTRY.get(name)
    if s is None:
        s = _REGISTRY[name] = PerfStats()
    return s


def all_stats() -> dict[str, PerfStats]:
    return dict(_REGISTRY)


def reset() -> None:
    _REGISTRY.clear()


@contextlib.contextmanager
def span(name: str, log_close: bool = True):
    """Timed span, logged at debug level when it closes."""
    t0 = time.perf_counter()
    with torch.profiler.record_function(name):
        yield
    dt = time.perf_counter() - t0
    stats(name).update(dt)
    if log_close:
        logger.debug("span %s closed: %.3f ms", name, dt * 1000.0)


def instrument(name: Optional[str] = None):
    """Decorator form of :func:`span` (named after the function)."""

    def wrap(fn):
        label = name or fn.__qualname__

        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(label):
                return fn(*args, **kwargs)

        return inner

    return wrap


def report() -> str:
    """Formatted dump of every span's statistics."""
    lines = [f"{name:40s} {st}" for name, st in sorted(_REGISTRY.items())]
    return "\n".join(lines)
