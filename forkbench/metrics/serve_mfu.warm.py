"""serve_mfu.warm (%): serving's share of the card's peaks: the least
time of each request's prefill and decode steps (``roofline.py``), summed
over the window's invocations, over their measured serve spans."""
from forkbench import roofline


def read(run):
    need = spent = 0.0
    for v in run.ok:
        need += roofline.serve_least_s(run.model, v.prompt_len, len(v.tokens))
        spent += v.answer - v.submit
    return 100.0 * need / spent if spent else None
