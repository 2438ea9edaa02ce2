"""Worlds x simulated ticks completed in the window over its wall time;
the window ends on a synchronize with every output of its calls on the
host.  One App frame is one tick of one world."""


def read(record):
    if "world_ticks" not in record:
        return None
    return record["world_ticks"] / record["window_s"]
