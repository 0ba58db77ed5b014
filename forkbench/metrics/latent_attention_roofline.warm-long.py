"""latent_attention_roofline.warm-long (%): the latent attention kernel's
share of its roofline over the profiled sub-window: the bytes it needs
(the program's ``mla.latent_bytes`` counter: every cached row in range,
the absorbed queries and the latent outputs, each once) over 3.35 TB/s,
over the device time of the kernels named ``latent_attention`` (the
split kernel and its combine)."""
from forkbench import roofline


def read(run):
    need = run.counters.get("mla.latent_bytes")
    if not need or not run.device_events or run.profiled is None:
        return None
    lo, hi = run.profiled
    spent = sum(e - s for s, e, name in run.device_events
                if "latent_attention" in name and lo <= s <= hi) / 1e9
    return 100.0 * need / roofline.PEAK_BYTES / spent if spent else None
