"""wire_read_s.coldstart (s): per traced fork, the summed
``net.read_pages`` spans (``forkbench/spans.py``): the owner's gather and
the copy of the wire payload to host memory, ending in its sync."""
from forkbench import spans


def read(run):
    return spans.readings(run).get("wire_read_s")
