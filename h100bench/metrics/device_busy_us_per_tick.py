"""The device's busy time in the profiled window per world-tick in it,
in microseconds."""


def read(record):
    t = record.get("trace")
    if not t or t["busy_s"] <= 0 or not t.get("world_ticks"):
        return None
    return t["busy_s"] / t["world_ticks"] * 1e6
