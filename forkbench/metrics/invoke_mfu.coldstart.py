"""invoke_mfu.coldstart (%): the whole invocation's share of the card's
peaks: the least time of the work each invocation needs (a fork's state
read and written once, the prefill, each decode step: the larger of its
FLOPs over 67 TFLOP/s and its bytes over 3.35 TB/s; ``roofline.py``),
summed over the window's invocations, over their measured spans, each
from the call to ``invoke`` to the child's release (the traced window's
own time also holds the profiler's stop)."""
from forkbench import roofline


def read(run):
    need = spent = 0.0
    for v in run.ok:
        need += roofline.serve_least_s(run.model, v.prompt_len, len(v.tokens))
        if v.forked:
            need += roofline.fork_least_s(run.model)
        spent += v.end - v.start
    return 100.0 * need / spent if spent else None
