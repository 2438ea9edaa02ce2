"""1 - the device's busy time (the union of its operations in the
profiler's trace) over the profiled window's wall time."""


def read(record):
    t = record.get("trace")
    if not t or t["busy_s"] <= 0:
        return None
    return 1.0 - t["busy_s"] / t["window_s"]
