"""staged_gb.coldstart (GB): per traced fork, the bytes the program
copied through host memory in both directions (its ``stage.*``
counters; ``forkbench/spans.py``), in 1e9.  A fork that stages every
page down and up once reads twice its state's pages."""
from forkbench import spans


def read(run):
    return spans.readings(run).get("staged_gb")
