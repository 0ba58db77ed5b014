"""moe_useful_pct.warm-long (%): the rows routed to experts over the rows
the experts computed (the program's ``moe.routed_rows`` and
``moe.expert_rows`` counters, which the sigmoid router counts as the
softmax one does; ``forkbench/spans.py``): the share of the expert
layer's work that a token asked for."""
from forkbench import spans


def read(run):
    return spans.readings(run).get("moe_useful_pct")
