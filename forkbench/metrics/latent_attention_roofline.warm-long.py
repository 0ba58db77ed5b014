"""latent_attention_roofline.warm-long (%): the latent attention kernel's
share of its roofline over the traced invocations: every decode step's
latent rows, absorbed queries and latent outputs (from the requests'
lengths, the architecture's ``attention_bytes``) over 3.35 TB/s, over the
device time of the kernels named ``latent_attention`` (the split kernel
and its combine) in each invocation's serve span."""
from forkbench import roofline


def read(run):
    need = spent = 0.0
    for v in run.ok:
        row = run.trace.get("invocations", {}).get(v.index, {})
        t = row.get("serve", {}).get("latent_kernels", 0.0)
        if t > 0:
            need += roofline.attention_bytes(run.model, v.prompt_len,
                                             len(v.tokens))
            spent += t
    return 100.0 * need / roofline.PEAK_BYTES / spent if spent else None
