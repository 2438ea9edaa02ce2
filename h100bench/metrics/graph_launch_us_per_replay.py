"""Microseconds of host time a graph replay takes to launch (the port's
``graph.launch`` span: ``CUDAGraph.replay()`` and the launch counts it
adds), median over the window's calls."""

from h100bench.program_calls import median_over_calls, per_replay


def read(record):
    return median_over_calls(
        record, lambda c: (v * 1e6 if (v := per_replay(c, "graph.launch"))
                           is not None else None))
