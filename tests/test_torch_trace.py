"""The port's spans, calls and counters (``slamrs_tpu_torch/utils/trace.py``)
and where the captured rollout opens them (``graph/capture.py``,
``ops/cow.py``).

A span's self time is its duration less its children's; a call closes
into a bounded record of the spans and counts under it; a span opens a
``record_function`` range only while a profiler records.  On the CPU the
frame program (``run_program(graphs=False)``) makes a record whose eager
frames and frames agree with its ``ProgramStats``, and a fleet's device
counter of the maps K2 copies agrees with the copy plans' ancestors.  The
sampled device idle (``trace.replay_stride``) runs on a fake device
timer: a queue on a fake host clock that starts each piece of work and
fires each event when it reaches it, driving the frame program's own
``_run`` and ``run`` over fake graphs; its readings equal the fake
device's true idle under each host span.  The ``cuda`` case (a device
counter first used inside a capture raises) runs on the card:

    python -m pytest tests/test_torch_trace.py -q --noconftest -m cuda
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from slamrs_tpu_torch.graph import capture  # noqa: E402
from slamrs_tpu_torch.graph import compile as tcompile  # noqa: E402
from slamrs_tpu_torch.models.gridslam import GridSlamConfig  # noqa: E402
from slamrs_tpu_torch.models.simulator import Scene, SimParams  # noqa: E402
from slamrs_tpu_torch.ops import cow  # noqa: E402
from slamrs_tpu_torch.utils import trace  # noqa: E402

SCRIPT = [[4.0, 0.05, 0.08], [8.0, 0.08, 0.05], [999.0, 0.06, 0.06]]


@pytest.fixture(autouse=True)
def fresh_trace():
    trace.reset()
    yield
    trace.reset()


def _closes(record) -> float:
    """A call's duration less its self time and every span's self time:
    0 when every span's time is accounted for once."""
    return record["seconds"] - record["self_seconds"] - sum(
        s["self_seconds"] for s in record["spans"].values())


def test_self_time_is_the_duration_less_the_children():
    with trace.span("t/parent") as parent:
        time.sleep(0.002)
        with trace.span("t/child") as a:
            time.sleep(0.003)
            with trace.span("t/grandchild") as g:
                time.sleep(0.001)
        with trace.span("t/child") as b:
            time.sleep(0.001)
    assert parent.self_seconds + a.seconds + b.seconds == pytest.approx(
        parent.seconds, abs=1e-9)
    assert a.self_seconds + g.seconds == pytest.approx(a.seconds, abs=1e-9)
    assert g.self_seconds == g.seconds >= 0.001
    assert parent.self_seconds >= 0.002
    st = trace.all_stats()
    assert st["t/child"].sample_count == 2
    assert st["t/child"].total_seconds == pytest.approx(a.seconds
                                                        + b.seconds)
    assert st["t/child"].self_seconds == pytest.approx(
        a.seconds + b.seconds - g.seconds)
    assert st["t/parent"].mean == pytest.approx(parent.seconds * 1e3)


def test_calls_make_bounded_records_and_spans_outside_make_none():
    with trace.span("t/outside"):
        trace.count("t/outside_count", 3)
    assert trace.calls() == []
    assert trace.counts() == {"t/outside_count": 3}
    with trace.call("t/call") as c:
        with trace.span("t/a"):
            trace.count("t/frames", 2)
            with trace.call("t/inner"):  # a span of the open call
                with trace.span("t/a"):
                    pass
        trace.count("t/frames")
    (rec,) = trace.calls()
    assert rec["name"] == "t/call" and rec["seconds"] == c.seconds
    assert rec["self_seconds"] == c.self_seconds
    assert rec["counts"] == {"t/frames": 3}
    assert trace.counts() == {"t/outside_count": 3, "t/frames": 3}
    assert {n: s["count"] for n, s in rec["spans"].items()} == {
        "t/a": 2, "t/inner": 1}
    assert abs(_closes(rec)) < 1e-9
    for _ in range(trace.MAX_CALLS + 3):
        with trace.call("t/many"):
            pass
    recs = trace.calls()
    assert len(recs) == trace.MAX_CALLS
    assert all(r["name"] == "t/many" for r in recs)


def test_a_span_opens_a_profiler_range_only_while_one_records(monkeypatch):
    opened = []
    real = torch.profiler.record_function

    def counting(name):
        opened.append(name)
        return real(name)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    with trace.span("t/quiet"):
        torch.ones(3).sum()
    assert opened == []
    with torch.profiler.profile() as prof:
        with trace.call("t/profiled_call"):
            with trace.span("t/profiled"):
                torch.ones(3).sum()
    assert opened == ["t/profiled_call", "t/profiled"]
    keys = {e.key for e in prof.key_averages()}
    assert {"t/profiled_call", "t/profiled"} <= keys


@pytest.mark.parametrize("name", ["cudaLaunchKernel", "cuGraphLaunch",
                                  "frame.GraphLaunch", "x.Memcpy",
                                  "x.MemsetAsync", "my.LaunchKernel"])
def test_span_names_that_read_as_host_cuda_calls_raise(name):
    with pytest.raises(ValueError, match="host CUDA call"):
        with trace.span(name):
            pass


def test_device_counters_add_on_the_device_and_reset_in_place():
    c = trace.device_counter("t/dev", "cpu")
    c.add_(torch.tensor(4, dtype=torch.int32))
    assert trace.device_counter("t/dev", torch.device("cpu")) is c
    with trace.call("t/one"):
        c.add_(3)
    with trace.call("t/two"):
        c.add_(5)
    gains = [int(r["device"]["t/dev"][0]) for r in trace.calls()]
    assert gains == [7, 5]  # the first call's counts what came before it
    assert trace.device_counts()["t/dev"] == 12
    trace.reset()
    assert trace.device_counter("t/dev", "cpu") is c and int(c) == 0


def _world(device="cpu", worlds=(), **grid):
    cfg = GridSlamConfig(position_x=-2.0, position_y=-2.0, width=4.0,
                         height=4.0, resolution=0.05, n_particles=8,
                         max_scan_range=1.0, integrate="fused",
                         resample_neff_frac=0.5, grid_dtype="bfloat16")
    cfg = dataclasses.replace(cfg, **grid)
    rects = [(-1.0, -1.0, 2.0, 2.0), (-0.1, -0.4, 0.5, 0.1),
             (-0.6, 0.4, 0.2, 0.5)]
    fw = tcompile.make_fused(
        scene=Scene.build(rects=rects, lines=[(-0.6, -0.4, 0.2, 0.4)],
                          device=device),
        params=SimParams.make(wheel_base=0.1, update_period=0.2,
                              scanner_range=1.0),
        grid_config=cfg, control_script=SCRIPT, device=device)
    return fw, fw.init(worlds)


@pytest.mark.parametrize("ticks", [40, 43])  # 40 ends on idle ticks
def test_frame_program_record_agrees_with_its_stats(ticks):
    fw, state = _world()
    _, outs = capture.run_program(fw, state, ticks, seed=2, graphs=False)
    (rec,) = trace.calls()
    stats = fw.capture_stats
    frames = int(outs.fired.shape[0])
    trailing = int(ticks == 40)  # the trailing idle ticks' one run
    assert rec["name"] == "rollout_cadence"
    assert rec["counts"] == {"rollout.frames": frames}
    spans = rec["spans"]
    assert spans["frame.eager"]["count"] == stats.eager
    assert stats.eager == frames + trailing  # without graphs every run
    assert spans["frame.fill"]["count"] == frames - 1 + trailing
    assert ("rollout.ticks" in spans) == bool(trailing)
    assert stats.ticks is None
    assert "graph.launch" not in spans and "frame.capture" not in spans
    assert abs(_closes(rec)) <= 1e-6 * rec["seconds"]
    assert rec["self_seconds"] > 0


def test_tick_program_record_counts_ticks():
    fw, state = _world()
    capture.run_ticks(fw, state, 20, seed=2, graphs=False)
    (rec,) = trace.calls()
    stats = fw.capture_stats
    assert rec["name"] == "rollout"
    assert rec["counts"] == {"rollout.frames": 20}
    assert rec["spans"]["frame.eager"]["count"] == stats.eager
    assert abs(_closes(rec)) <= 1e-6 * rec["seconds"]


def test_k2_counter_counts_the_maps_each_plan_copies(monkeypatch):
    ancestors = []
    real = cow.cow_plan

    def plan(anc):
        ancestors.append(anc.clone())
        return real(anc)

    monkeypatch.setattr(cow, "cow_plan", plan)
    fw, state = _world(worlds=(3,), n_particles=6, resample_cow=True,
                       fused_resident=False)
    for seed in (1, 2):
        state, _ = capture.run_program(fw, state, 60, seed=seed,
                                       graphs=False)
    assert ancestors
    # a plan copies every child after an ancestor's first
    want = sum(a.numel() - np.unique(a.numpy()).size for a in ancestors)
    assert want > 0
    assert trace.device_counts()["k2.maps_copied"] == want
    gains = [sum(int(t) for t in r["device"]["k2.maps_copied"])
             for r in trace.calls()]
    assert sum(gains) == want and all(g >= 0 for g in gains)


# --- device idle on the replays, on a fake device timer -------------------


class FakeCard:
    """A host clock (ns) and a device queue on it: work starts when the
    device is free and the host has enqueued it; an event fires when
    the device reaches it.  Records the device's busy intervals and the
    host's spans, so a test can take the true idle under each."""

    def __init__(self):
        self.now = 10_000_000
        self.free_at = 0
        self.free: list = []  # the trace's event pool
        self.made = 0
        self.busy: list = []
        self.spans: dict = {}  # phase -> host intervals

    def __call__(self) -> int:  # the host clock
        return self.now

    def run(self, ns: int, phase=None) -> None:
        if phase is not None:
            self.spans.setdefault(phase, []).append((self.now,
                                                     self.now + ns))
        self.now += ns

    def work(self, ns: int) -> None:
        start = max(self.now, self.free_at)
        self.free_at = start + ns
        self.busy.append((start, start + ns))

    def event(self):
        self.made += 1
        return FakeEvent(self)

    def idle(self, intervals) -> float:
        """Seconds of ``intervals`` in which the device was not busy."""
        total = 0
        for t0, t1 in intervals:
            total += t1 - t0 - sum(max(0, min(t1, b1) - max(t0, b0))
                                   for b0, b1 in self.busy)
        return total * 1e-9


class FakeEvent:
    def __init__(self, card):
        self.card, self.at = card, None

    def record(self, stream):
        self.at = max(self.card.now, self.card.free_at)
        self.card.free_at = self.at

    def query(self) -> bool:
        return self.at is not None and self.at <= self.card.now

    def elapsed_time(self, end) -> float:
        assert self.query() and end.query(), "read before it completed"
        return (end.at - self.at) * 1e-6


class FakeGraph:
    """A replay that holds the host ``launch_ns`` and submits its
    ``device_ns`` of work as it returns."""

    def __init__(self, card, launch_ns, device_ns):
        self.card, self.launch_ns, self.device_ns = card, launch_ns, device_ns

    def replay(self):
        self.card.run(self.launch_ns)
        self.card.work(self.device_ns)


@pytest.fixture
def card(monkeypatch):
    """The fake card as the trace's clock and device timer; a test sets
    ``trace.replay_stride``, restored after it."""
    c = FakeCard()
    trace.reset()
    monkeypatch.setattr(trace, "_clock", c)
    monkeypatch.setattr(trace, "_TIMER", c)
    monkeypatch.setattr(trace, "replay_stride", trace.replay_stride)
    yield c
    trace.reset()


def _program(card, graph_ns, launch_ns=6_000, fill_ns=40_000):
    """A frame program whose runs replay fake graphs: each run's fill
    takes ``fill_ns`` of host time (no copies), its launch span
    ``launch_ns`` around ``replay()``."""
    prog = capture.Program(lambda key: None, "cpu", graphs=False)
    prog.draws = prog.landmark_draws = None
    prog.fill = lambda name, v: card.run(fill_ns, "fill")
    prog._replay = lambda graph, key: (
        card.spans.setdefault("launch", []).append(
            (card.now, card.now + graph.launch_ns)), graph.replay())
    for key in (5, ("idle", 4)):
        prog._graphs[key] = FakeGraph(card, launch_ns, graph_ns)
        prog.stats.launches[key] = {}
        prog._outputs[key] = None
    return prog


def _call(card, prog, frames, loop_ns=20_000, trailing=True,
          upload_ns=300_000, caller_ns=500_000, work_at_head=0):
    """One rollout call as ``run_program`` makes it, on the fake card:
    the head, the draws' upload, the frame loop (each frame's loop
    Python ``loop_ns``), the trailing run, the hand-over; then the
    caller's ``caller_ns``.  Returns the call's start.  The first two
    frames' fill and launch and the first frame's loop Python are logged
    as the call's (its head ends with its second replay), the last
    frame's loop Python as ``unread``."""
    speeds = torch.zeros(2, 6)
    with trace.call("rollout_cadence"):
        card.work(work_at_head)  # the last call's work, still queued
        start = card.now
        trace.replays_open("main")
        card.run(7_000, "call")
        with trace.end_span("rollout.draws_upload"):
            card.run(upload_ns, "rollout.draws_upload")
        card.run(9_000, "call")
        trace.replay_loop_start()
        for f in range(frames):
            capture.FrameProgram._run(prog, 5, speeds, None)
            if f <= 1:
                card.spans.setdefault("call", []).extend(
                    [card.spans["fill"][-1], card.spans["launch"][-1]])
            card.run(loop_ns, "unread" if f == frames - 1
                     else "call" if f == 0 else None)
        trace.replay_loop_end()
        if trailing:
            t0 = card.now
            with trace.end_span("rollout.ticks"):
                capture.FrameProgram._run(prog, ("idle", 4), speeds, None)
            card.spans.setdefault("rollout.ticks", []).append(
                (t0, card.now))
        card.run(11_000, "call")
        with trace.end_span("rollout.hand_over"):
            card.run(13_000, "rollout.hand_over")
        card.run(3_000, "call")
    card.run(caller_ns, "outside")
    return start


def _loop_truth(card, start, end):
    """The true idle under the loop's phases between host times."""
    def within(phase):
        return [(max(t0, start), min(t1, end))
                for t0, t1 in card.spans.get(phase, [])
                if t1 > start and t0 < end]
    fill, launch = within("fill"), within("launch")
    total = card.idle([(start, end)])
    f, la = card.idle(fill), card.idle(launch)
    return {"fill": f, "launch": la, "loop": total - f - la}


@pytest.mark.parametrize("graph_us", [15, 45, 120])
def test_sampled_frames_read_the_true_idle_under_each_span(card, graph_us):
    trace.replay_stride = 1
    prog = _program(card, graph_us * 1000)
    _call(card, prog, frames=6)
    _call(card, prog, frames=6)
    rec = trace.calls()[0]["replays"]
    assert rec["every"] == 1 and rec["cycles"] == 4
    assert len(rec["samples"]) == 4
    # each cycle spans a replay's end to the next one's, from the second
    ends = [t1 for _, t1 in card.spans["launch"]][:6]
    for s, lo, hi in zip(rec["samples"], ends[1:], ends[2:]):
        want = _loop_truth(card, lo, hi)
        for phase in ("fill", "launch", "loop"):
            assert s[phase] == pytest.approx(want[phase], abs=1e-12), phase
    assert not rec["profiled"]
    # a graph shorter than the loop's Python leaves the device waiting
    # through the fill and the launch; one longer than a frame's host
    # time keeps it busy (behind the host: no idle)
    s = rec["samples"][3]
    if graph_us == 15:
        assert s["fill"] == pytest.approx(40e-6)
        assert s["launch"] == pytest.approx(6e-6)
        assert s["loop"] == pytest.approx(5e-6)
    if graph_us == 120:
        assert s["fill"] == s["launch"] == s["loop"] == 0


def test_the_replays_device_interval_is_on_the_host_clock(card):
    trace.replay_stride = 2
    prog = _program(card, 30_000)
    _call(card, prog, frames=5)
    _call(card, prog, frames=5)
    rec = trace.calls()[0]["replays"]
    head = rec["head_ns"]
    graphs = [b for b in card.busy if b[1] - b[0] == 30_000]
    # frames 1 and 3 sampled (frame 0 ends the call's head)
    assert rec["cycles"] == 3 and len(rec["samples"]) == 2
    for s, f in zip(rec["samples"], (1, 3)):
        # each point fires as the replay before it ends
        assert s["device"] == pytest.approx(((graphs[f][1] - head) * 1e-9,
                                             (graphs[f + 1][1] - head) * 1e-9))


@pytest.mark.parametrize("behind_us", [0, 200, 2_000])
def test_the_clock_rule_where_the_device_is_idle_or_behind(card, behind_us):
    """A call whose head finds the device waiting, or still running the
    last call's work for 0.2 ms (into the upload) or 2 ms (past the
    whole call, 0.7 ms), reads the true idle: its clock is set by the
    points where the device waited, the next call's head among them
    (the caller waits for the outputs); behind the host, no idle."""
    trace.replay_stride = 1
    prog = _program(card, 15_000)
    start = _call(card, prog, frames=4, work_at_head=behind_us * 1000)
    card.run(3_000_000)  # the caller waits for its outputs
    nxt = _call(card, prog, frames=4)
    r = trace.calls()[0]["replays"]
    upload = card.spans["fill"][0][0] - 9_000 - 300_000
    want = card.idle([(upload, upload + 300_000)])
    assert r["ends"]["rollout.draws_upload"] == pytest.approx(want,
                                                              abs=1e-12)
    assert want == pytest.approx(
        {0: 300e-6, 200: 107e-6, 2_000: 0.0}[behind_us], abs=1e-12)
    per_frame = sum(s[p] for s in r["samples"]
                    for p in ("fill", "launch", "loop")) / len(r["samples"])
    total = sum(r["ends"].values()) + per_frame * r["cycles"]
    assert total == pytest.approx(card.idle([(start, nxt)])
                                  - card.idle(card.spans["unread"][:1]),
                                  abs=1e-12)
    if behind_us == 2_000:
        assert all(s[p] == 0 for s in r["samples"]
                   for p in ("fill", "launch", "loop"))


def test_idle_at_the_calls_ends_goes_to_each_span(card):
    trace.replay_stride = 4
    prog = _program(card, 15_000)
    _call(card, prog, frames=9, caller_ns=500_000)
    marks = {p: list(v) for p, v in card.spans.items()}
    _call(card, prog, frames=9)
    ends = trace.calls()[0]["replays"]["ends"]
    assert set(ends) == {"call", "rollout.draws_upload", "rollout.ticks",
                         "rollout.hand_over", "outside"}
    for phase, got in ends.items():
        assert got == pytest.approx(card.idle(marks[phase]), abs=1e-12), \
            phase
    # the device waits through the upload, the head's Python, the first
    # frame's fill and launch, the first frame's loop Python after its
    # graph (15 µs) and the second frame's fill and launch, and the
    # caller; the trailing graph (15 µs, submitted at its launch's end)
    # runs 11 µs of the tail's Python and 4 µs into the hand-over
    assert ends["call"] == pytest.approx(
        (7 + 9 + 40 + 6 + 5 + 40 + 6 + 3) * 1e-6)
    assert ends["rollout.draws_upload"] == pytest.approx(300e-6)
    assert ends["outside"] == pytest.approx(500e-6)
    assert ends["rollout.hand_over"] == pytest.approx(9e-6)
    assert ends["rollout.ticks"] == pytest.approx((40 + 6) * 1e-6)


@pytest.mark.parametrize("every", [1, 3])
def test_the_phases_sum_to_the_calls_idle(card, every):
    """Every cycle's phases (stride 1), or the sampled cycles scaled to
    the loop's (stride 3, all alike), plus the ends, is the device's idle
    from the call's head to the next call's, less the last frame's loop
    Python (between two points neither read)."""
    trace.replay_stride = every
    prog = _program(card, 15_000)
    starts = [_call(card, prog, frames=9) for _ in range(3)]
    unread = card.spans["unread"]
    # at stride 3 the first sampled frame moves by one a call: 1, 2, 3
    counts = {1: [7, 7, 7], 3: [3, 2, 2]}[every]
    for rec, lo, hi, lost, n in zip(trace.calls(), starts, starts[1:],
                                    unread, counts):
        r = rec["replays"]
        assert r["wall_s"] == pytest.approx((hi - lo) * 1e-9)
        samples = r["samples"]
        assert len(samples) == n
        per_frame = sum(s[p] for s in samples
                        for p in ("fill", "launch", "loop")) / len(samples)
        total = per_frame * r["cycles"] + sum(r["ends"].values())
        assert total == pytest.approx(
            card.idle([(lo, hi)]) - card.idle([lost]), abs=1e-12)
        # the loop's host time but its last Python, the cycles' scaled
        host = sum(s["host"] for s in samples) / len(samples) * r["cycles"]
        assert host == pytest.approx(r["loop_s"] - (lost[1] - lost[0]) * 1e-9,
                                     abs=1e-12)
        assert 0 < r["loop_s"] < r["wall_s"]
    # the last call, which no call follows, ends at its close
    last = trace.calls()[-1]["replays"]
    close = card.spans["outside"][-1][0]
    assert "outside" not in last["ends"]
    assert last["wall_s"] == pytest.approx((close - starts[-1]) * 1e-9)
    per_frame = sum(s[p] for s in last["samples"]
                    for p in ("fill", "launch", "loop")) / len(last["samples"])
    total = per_frame * last["cycles"] + sum(last["ends"].values())
    assert total == pytest.approx(card.idle([(starts[-1], close)])
                                  - card.idle([unread[-1]]), abs=1e-12)


def test_stride_0_makes_no_event_and_adds_nothing_to_a_record(card):
    trace.replay_stride = 0
    prog = _program(card, 15_000)
    _call(card, prog, frames=5)
    _call(card, prog, frames=5)
    assert card.made == 0
    for rec in trace.calls():
        assert set(rec) == {"name", "seconds", "self_seconds", "spans",
                            "counts", "device"}
    trace.replay_stride = 1
    _call(card, prog, frames=5)
    assert card.made > 0 and card.free == []  # its points still pending
    (rec,) = [r for r in trace.calls() if "replays" in r]
    assert len(card.free) == card.made  # resolved, back in the pool
    made = card.made
    _call(card, prog, frames=5)
    trace.calls()
    assert card.made == made  # the pool's events recorded again


def test_points_are_read_only_once_they_have_completed(card):
    trace.replay_stride = 2
    prog = _program(card, 15_000)
    card.work(5_000_000)  # the device is 5 ms behind for a while
    _call(card, prog, frames=4, caller_ns=1_000)
    assert trace.calls()[0].get("replays") is None  # not yet fired
    card.run(6_000_000)
    assert trace.calls()[0]["replays"]["cycles"] == 2


def test_points_are_resolved_only_when_the_records_are_read(card):
    """No call's head reads the last calls' points: a run that reads no
    record pays no ``elapsed_time``."""
    trace.replay_stride = 2
    prog = _program(card, 15_000)
    for _ in range(3):
        _call(card, prog, frames=5)
    assert len(trace._PENDING) == 3 and card.free == []
    assert all("replays" in rec for rec in trace.calls())
    assert not trace._PENDING and len(card.free) == card.made


def test_the_sampled_frames_move_by_one_a_call(card):
    """At stride 4 the first sampled loop frame after the head's two is
    frame 1, 2, 3, 4, then 1 again: over calls every place in the loop
    is sampled alike."""
    trace.replay_stride = 4
    prog = _program(card, 15_000)
    for _ in range(5):
        _call(card, prog, frames=10)
    launches = [t1 for _, t1 in card.spans["launch"]]
    for k, rec in enumerate(trace.calls()):
        r = rec["replays"]
        ends = launches[11 * k:11 * k + 10]  # the loop's; then the trailing
        # a sampled frame's point fires as its 15 µs graph ends
        got = [min(range(10), key=lambda f: abs(
            ends[f] + 15_000 - r["head_ns"] - s["device"][0] * 1e9))
            for s in r["samples"]]
        first = k % 4 + 1
        assert got == [first, first + 4], k


def test_samples_a_profiler_recorded_in_are_marked(card, monkeypatch):
    """A profiler that records over frames 5 to 8 of a call marks the
    call: its cost lies outside those frames too.  The next call, which
    no profiler recorded in, is not marked."""
    trace.replay_stride = 1
    prog = _program(card, 15_000)
    frame = {"i": -1}
    real = capture.FrameProgram._run

    def run(self, key, speeds, f):
        frame["i"] += 1
        return real(self, key, speeds, f)

    monkeypatch.setattr(capture.FrameProgram, "_run", run)
    monkeypatch.setattr(trace, "_profiling",
                        lambda: 5 <= frame["i"] < 9)
    _call(card, prog, frames=12, trailing=False)
    _call(card, prog, frames=12, trailing=False)
    _call(card, prog, frames=12, trailing=False)
    first, second, _ = (c["replays"] for c in trace.calls())
    assert first["profiled"] and not second["profiled"]
    assert len(first["samples"]) == len(second["samples"]) == 10
    assert all("profiled" not in s for s in first["samples"])


def test_a_split_program_is_one_interval_over_its_replays(card):
    trace.replay_stride = 1
    prog = _program(card, 10_000)
    head, tail = (FakeGraph(card, 6_000, 10_000) for _ in range(2))
    prog._graphs[5] = capture._Split(head, tail, None)
    for part in ("head", "tail"):
        prog.stats.launches[(5, part)] = {}
    prog._read_flags = lambda: card.run(30_000) or []  # the host read
    _call(card, prog, frames=3, trailing=False)
    _call(card, prog, frames=3, trailing=False)
    s = trace.calls()[0]["replays"]["samples"][0]  # frame 1's end to 2's
    # the read (30 µs) and both launches (12 µs) are one launch interval:
    # the device waits through it, and the head's 10 µs of work between
    # its two points count in it, as any work between two points
    assert s["launch"] == pytest.approx((30 + 12) * 1e-6)


# --- on the card --------------------------------------------------------


@pytest.mark.cuda
def test_device_counter_first_used_inside_a_capture_raises():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    made = trace.device_counter("t/made_before", dev)
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        graph = torch.cuda.CUDAGraph()
        graph.capture_begin()
        try:
            made.add_(1)
            with pytest.raises(RuntimeError, match="inside a CUDA graph"):
                trace.device_counter("t/made_inside", dev)
        finally:
            graph.capture_end()
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    assert int(made) == 3
