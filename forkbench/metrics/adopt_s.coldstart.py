"""adopt_s.coldstart (s): per traced fork, the summed ``instance.adopt``
spans (``forkbench/spans.py``): the child's alloc, the upload of the host
payload and ``cow_scatter(_runs)``, ending in the upload's sync."""
from forkbench import spans


def read(run):
    return spans.readings(run).get("adopt_s")
