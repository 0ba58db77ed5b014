"""resume_s.coldstart (s): the mean ``fork.resume`` span of the traced
window's forks (``forkbench/spans.py``): the host's work on the child's
side before any page moves (auth, descriptor, child page tables)."""
from forkbench import spans


def read(run):
    return spans.readings(run).get("resume_s")
