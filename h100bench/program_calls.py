"""The port's own records of a run's window calls, for the per-layer
readers of spans and counters inside the program.

The port keeps a record of each call into it (``slamrs_tpu_torch/utils/
trace.py``: ``trace.calls()``, the last 4,096): the call's duration and
self time, the count, total and self seconds of each span opened under
it, the host counters counted under it and what each device counter
gained.  A rollout cell's window calls are the last ``record["calls"]``
records named ``rollout_cadence``, profiled or not.  A port that keeps no
such records gives nothing to read: the readers return None.
"""

from __future__ import annotations

import statistics

CALL = "rollout_cadence"


def window_calls(record: dict) -> list[dict]:
    """The window's call records, oldest first ([] where there are none)."""
    n = record.get("calls")
    if not n:
        return []
    from slamrs_tpu_torch.utils import trace

    calls = getattr(trace, "calls", None)
    if calls is None:
        return []
    return [c for c in calls() if c["name"] == CALL][-n:]


def span(call: dict, name: str) -> tuple[int, float]:
    """``(count, total seconds)`` of span ``name`` in one call record."""
    s = call["spans"].get(name)
    return (0, 0.0) if s is None else (s["count"], s["seconds"])


def median_over_calls(record: dict, value) -> float | None:
    """The median of ``value(call)`` over the window's calls, leaving out
    calls where it is None; None where no call gives one."""
    values = [v for c in window_calls(record)
              if (v := value(c)) is not None]
    return statistics.median(values) if values else None


def per_replay(call: dict, name: str) -> float | None:
    """Span ``name``'s total seconds in a call over the call's graph
    replays (the count of ``graph.launch``); None without replays."""
    replays, _ = span(call, "graph.launch")
    return span(call, name)[1] / replays if replays else None
