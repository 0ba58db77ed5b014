"""paged_attention_roofline.warm (%): ``paged_attention``'s share of its
roofline over the traced invocations: every decode step's K/V context,
queries and output (from the requests' lengths) over 3.35 TB/s, over the
device time of the kernels named ``paged_attention``."""
from forkbench import roofline


def read(run):
    need = spent = 0.0
    for v in run.ok:
        row = run.trace.get("invocations", {}).get(v.index, {})
        t = row.get("serve", {}).get("attention_kernels", 0.0)
        if t > 0:
            need += roofline.attention_bytes(run.model, v.prompt_len,
                                             len(v.tokens)) / roofline.PEAK_BYTES
            spent += t
    return 100.0 * need / spent if spent else None
