"""Host calls that put work on the card (the profiler's CPU events whose
name holds LaunchKernel, GraphLaunch, Memcpy or Memset) per scan frame
of a captured rollout, in the profiled frames."""


def read(record):
    t = record.get("trace")
    if not t or t["busy_s"] <= 0 or "calls" not in record or not t.get("frames"):
        return None
    return t["host_calls"] / t["frames"]
