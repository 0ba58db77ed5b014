"""decode_gap_ms.warm (ms): inside the profiled sub-window, the mean time
of a ``serve.decode`` span in which the device ran nothing
(``forkbench/spans.py``): the host's share of a decode step, profiler
included."""
from forkbench import spans


def read(run):
    return spans.readings(run).get("decode_gap_ms")
