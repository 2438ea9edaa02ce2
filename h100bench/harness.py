"""The benchmark's machinery, driven by the names in ``BENCHMARK.json``.

One run of one cell: the cell's workload file names its configuration and
its driver; the driver sets the system up, warms every shape the cell
uses, runs the measured window and, after it, holds what the program
produced against the plain reference (``reference/``).  Each metric is a
reader of its own (``metrics/<name>.py``) that takes its number from the
run's record, or returns None when the cell gives it nothing to read.

Every file of a configuration, a cell, a driver or a metric is found by
its name, so a later change adds a cell or a metric by adding files:

* ``configs/<config>.json``: the deployment's settings and its source;
* ``workloads/<cell>.json``: the configuration, the driver, the traffic
  parameters and the limits of the correctness check;
* ``drivers/<driver>.py``: a ``Driver`` class (see ``drivers/rollout.py``);
* ``metrics/<metric>.py``: ``read(record) -> float | None``.
"""

from __future__ import annotations

import bisect
import collections
import importlib.util
import json
import os
import statistics
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import Optional

BENCH_DIR = "h100bench"
# runtime calls by which the host puts work on the card
HOST_LAUNCH_CALLS = ("LaunchKernel", "GraphLaunch", "Memcpy", "Memset")
# top-level module names that no run may load: JAX, and the JAX package
# with the older TPU benchmark beside it
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "slamrs_tpu", "bench",
                     "benchmarks")


class Bench:
    """``BENCHMARK.json`` at ``root`` and the files it names."""

    def __init__(self, root: Path):
        self.root = Path(root)
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())

    def _entry(self, key: str, name: str) -> dict:
        for e in self.spec[key]:
            if e["name"] == name:
                return e
        raise KeyError(f"BENCHMARK.json has no {key} entry {name!r}")

    def cell(self, name: str) -> dict:
        return self._entry("workloads", name)

    def config(self, name: str) -> dict:
        return self._entry("configs", name)

    def path(self, *parts: str) -> Path:
        return self.root / BENCH_DIR / Path(*parts)

    def workload_params(self, cell: str) -> dict:
        return json.loads(self.path("workloads", f"{cell}.json").read_text())

    def config_params(self, config: str) -> dict:
        return json.loads((self.root / self.config(config)["file"])
                          .read_text())

    def metrics(self, kind: str, cell: str) -> list[dict]:
        """The ``end_to_end`` or ``per_layer`` metrics that ``cell``
        reports: those that list it, and those that list no cell."""
        return [m for m in self.spec[kind]
                if "workloads" not in m or cell in m["workloads"]]

    def module(self, folder: str, name: str) -> ModuleType:
        return load_module(self.path(folder, f"{name}.py"),
                           f"{BENCH_DIR}_{folder}_{name}")


def load_module(path: Path, name: str) -> ModuleType:
    """A Python file loaded by its path, once per process."""
    key = name.replace(".", "_").replace("-", "_")
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def process_age() -> float:
    """Seconds since this process started (Linux ``/proc``)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start


def log(msg: str) -> None:
    """A line on standard error, stamped with the process's age."""
    print(f"[{process_age():8.2f} s] {msg}", file=sys.stderr, flush=True)


def cache_env(root: Path) -> dict:
    """Fixed cache directories inside the checkout for every compiler
    cache the run could touch (the port builds its kernels into its own
    ``build/slamrs_tpu_torch/``)."""
    base = Path(root) / "build" / BENCH_DIR
    return {"TRITON_CACHE_DIR": str(base / "triton"),
            "TORCH_EXTENSIONS_DIR": str(base / "torch_extensions"),
            "TORCHINDUCTOR_CACHE_DIR": str(base / "inductor"),
            "CUDA_CACHE_PATH": str(base / "cuda_cache"),
            "USE_FLAX": "0"}


def foreign_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is one that
    no run may load."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN_MODULES))


# --- statistics -------------------------------------------------------

def describe(values, scale: float = 1.0, unit: str = "") -> str:
    """``n``, minimum, quartiles and maximum of ``values`` times
    ``scale``, for a log line."""
    xs = sorted(v * scale for v in values)
    if len(xs) < 2:
        return f"n={len(xs)} {xs} {unit}"
    q = statistics.quantiles(xs, n=4)
    return (f"n={len(xs)} min {xs[0]:.4g} q1 {q[0]:.4g} median {q[1]:.4g} "
            f"q3 {q[2]:.4g} max {xs[-1]:.4g} {unit}")


# --- the profiled window ------------------------------------------------

class Profile:
    """A ``torch.profiler`` session over a short window, and what it
    read: device busy time (the union of the device's operations),
    kernels by name, the host's launch calls, the longest device
    operations and the idle gaps by what the host was doing."""

    def __init__(self, torch, trace_path: Optional[Path] = None):
        self.torch = torch
        self.trace_path = trace_path
        self.summary = None
        self._prof = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
            self.torch.cuda.synchronize()
        self._prof = profile(activities=acts)
        self._prof.start()
        self._t0 = time.perf_counter()

    def stop(self, **counts) -> dict:
        """End the window (after a synchronize); ``counts`` (frames,
        ticks, ...) go into the summary as they are."""
        if self.torch.cuda.is_available():
            self.torch.cuda.synchronize()
        seconds = time.perf_counter() - self._t0
        self._prof.stop()
        self.summary = summarize(self._prof, seconds)
        self.summary.update(counts)
        if self.trace_path is not None:
            self.trace_path.parent.mkdir(parents=True, exist_ok=True)
            self._prof.export_chrome_trace(str(self.trace_path))
        self._prof = None
        return self.summary


def _is_device(e) -> bool:
    return getattr(e.device_type, "name", str(e.device_type)) == "CUDA"


def summarize(prof, seconds: float, top: int = 10) -> dict:
    """What a profile read over ``seconds`` of wall time."""
    events = list(prof.events())
    host = [e for e in events if not _is_device(e)]
    # the device timeline also carries the host's annotated ranges (the
    # port's spans): they are no device work
    host_names = {e.name for e in host}
    device = [e for e in events if _is_device(e)
              and e.name not in host_names]
    spans = sorted((e.time_range.start, e.time_range.end) for e in device)
    merged = []
    for s, t in spans:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    busy_us = sum(t - s for s, t in merged)
    kernels = collections.defaultdict(lambda: [0, 0.0])
    for e in device:
        k = kernels[e.name]
        k[0] += 1
        k[1] += (e.time_range.end - e.time_range.start) / 1e6
    host_calls = sum(1 for e in host if e.name.startswith("cu")
                     and any(c in e.name for c in HOST_LAUNCH_CALLS))
    # idle gaps between device work, named by the host operation that
    # had started most recently at the gap's middle
    starts = sorted((e.time_range.start, e.name) for e in host)
    keys = [s for s, _ in starts]
    gaps = collections.Counter()
    for (_, end), (nxt, _) in zip(merged, merged[1:]):
        mid = (end + nxt) / 2
        i = bisect.bisect_right(keys, mid) - 1
        gaps[starts[i][1] if i >= 0 else "(none)"] += (nxt - end) / 1e6
    by_time = sorted(((n, v[1]) for n, v in kernels.items()),
                     key=lambda x: -x[1])
    return {"window_s": seconds, "busy_s": busy_us / 1e6,
            "host_calls": host_calls,
            "kernels": {n: {"count": v[0], "seconds": v[1]}
                        for n, v in kernels.items()},
            "device_ops": [[n, s] for n, s in by_time[:top]],
            "idle_gaps": [[n, s] for n, s in gaps.most_common(top)]}


def kernel_time(summary: dict, fragment: str) -> tuple[int, float]:
    """``(launches, seconds)`` of the kernels whose name holds
    ``fragment``."""
    n, s = 0, 0.0
    for name, k in summary["kernels"].items():
        if fragment in name:
            n += k["count"]
            s += k["seconds"]
    return n, s


# --- one run --------------------------------------------------------------

class Context:
    """What a driver is given: the bench, its cell and configuration (the
    entries and their files' contents), the seed and the device."""

    def __init__(self, bench: Bench, cell: str, seed: int, device: str):
        self.bench = bench
        self.cell = bench.cell(cell)
        self.workload = bench.workload_params(cell)
        self.config_name = self.workload["config"]
        if self.config_name != self.cell["config"]:
            raise ValueError(f"workloads/{cell}.json names configuration "
                             f"{self.config_name}, BENCHMARK.json "
                             f"{self.cell['config']}")
        self.config = bench.config_params(self.config_name)
        self.seed = seed
        self.device = device

    def config_file(self, key: str) -> Path:
        """A file that the configuration's file names beside itself."""
        base = (self.bench.root
                / self.bench.config(self.config_name)["file"]).parent
        return base / self.config[key]


def run_cell(bench: Bench, cell: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda") -> dict:
    """One run of ``cell``: set-up and warm-up, the measured window, then
    the check against the reference.  Returns the result's fields."""
    import torch

    ctx = Context(bench, cell, seed, device)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    driver = bench.module("drivers", ctx.workload["driver"]).Driver(ctx)
    driver.setup()
    record = {"setup_s": process_age()}
    log("set-up done; the window starts")
    profile = None
    if trace:
        profile = Profile(torch, bench.root / "build" / BENCH_DIR
                          / f"trace_{cell}.json")
    record.update(driver.window(seconds, profile))
    if on_card:
        torch.cuda.synchronize()
        record["peak_bytes"] = torch.cuda.max_memory_allocated()
    if profile is not None and profile.summary is not None:
        record["trace"] = profile.summary
    driver.release()
    log("window closed; the reference follows")
    compared = driver.check()
    log("check done")
    correct = all(v["value"] <= v["limit"] for v in compared.values())

    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in bench.metrics(kind, cell):
        value = bench.module("metrics", m["name"]).read(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": correct, "attempted": record["attempted"],
              "failed": record["failed"], "metrics": metrics,
              "device": device_info(torch, device, record)}
    if trace and "trace" in record:
        result["breakdown"] = {"device_ops": record["trace"]["device_ops"],
                               "idle_gaps": record["trace"]["idle_gaps"]}
    result["compared"] = compared
    return result


def device_info(torch, device: str, record: dict) -> dict:
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1, "memory_peak_bytes": record["peak_bytes"]}
    if "trace" in record:
        info["busy_s"] = record["trace"]["busy_s"]
        info["window_s"] = record["trace"]["window_s"]
    return info
