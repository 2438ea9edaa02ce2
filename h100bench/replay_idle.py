"""The port's own reading of the device's idle in a run's window calls,
taken with the profiler off.

Where the port samples its replays (``slamrs_tpu_torch/utils/trace.py``,
``replay_stride``), each ``rollout_cadence`` call's record holds
``replays``: per sampled frame the seconds the device waited under the
frame's fill (``fill``), its graph launch (``launch``) and the call's
own Python between replays (``loop``); whether a profiler recorded
during the call (``profiled``); the seconds it waited at the call's ends by span
(``ends``: the draws' upload, the lead's eager frame, the trailing
ticks, the hand-over, the call's own Python outside the loop and the
time outside the call, up to the next call's head; the idle up to the
end of the loop's second replay is among them); ``cycles`` (the loop's
runs after its second), ``loop_s`` (their host seconds), each sample's ``host`` (its
cycle's host seconds) and ``wall_s`` (head to the next call's head).
The window's last call, which no call has followed when the records are
read, ends at its own close: its ends have no ``outside``.
A sample is a cycle: from the end of a sampled frame's replay to the end
of the next frame's, its idle split over the next frame's fill, its
launch and the loop's Python before it.

The readers leave out the calls a profiler recorded in (its cost lies
in the whole call, not only in the frames it recorded), scale the
sampled frames' idle and host time to the call's frames and take the
median over the window's other calls.  A traced window whose only call
is profiled, a port or a call with no such record (the CPU, the parent
of this reading) gives None.
"""

from __future__ import annotations

from h100bench.program_calls import median_over_calls

PHASES = ("fill", "launch", "loop")


def unprofiled(call: dict) -> dict | None:
    """The call's ``replays``, where no profiler recorded during it."""
    r = call.get("replays")
    return None if not r or r["profiled"] else r


def samples(call: dict) -> list | None:
    """The sampled frames of a call that no profiler recorded in."""
    r = unprofiled(call)
    return (r["samples"] or None) if r else None


def per_replay(call: dict, phase: str) -> float | None:
    """Seconds of idle under ``phase`` a sampled replay (the mean)."""
    got = samples(call)
    return None if got is None else sum(s[phase] for s in got) / len(got)


def loop_idle(call: dict) -> float | None:
    """Seconds of idle in the call's frame loop after its second replay:
    the sampled cycles' idle, every phase, scaled to the loop's."""
    got = samples(call)
    if got is None:
        return None
    per = sum(s[p] for s in got for p in PHASES) / len(got)
    return per * call["replays"]["cycles"]


def ends_idle(call: dict) -> float | None:
    """Seconds of idle up to the end of the call's second replay and
    after its last, up to the next call's head (the last call's, its
    close)."""
    r = unprofiled(call)
    return sum(r["ends"].values()) if r else None


def host_wait_share(call: dict) -> float | None:
    """The share of the call's wall time in which the device waited: the
    loop's idle and host time scaled from the sampled frames, the ends'
    as they were."""
    loop, ends = loop_idle(call), ends_idle(call)
    if loop is None or ends is None:
        return None
    r = call["replays"]
    got = samples(call)
    frames = sum(s["host"] for s in got) / len(got) * r["cycles"]
    return (loop + ends) / (r["wall_s"] - r["loop_s"] + frames)


def median_per_replay_us(record: dict, phase: str) -> float | None:
    return median_over_calls(
        record, lambda c: (v * 1e6 if (v := per_replay(c, phase))
                           is not None else None))
