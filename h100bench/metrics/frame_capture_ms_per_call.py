"""Milliseconds a rollout call spends capturing its CUDA graphs (the
frame program's and the trailing ticks' ``capture_seconds``, the
program's own counters), averaged over the window's calls."""


def read(record):
    s = record.get("capture_s_per_call")
    if not s:
        return None
    return sum(s) / len(s) * 1e3
