"""peak_device_gb (GB): ``torch.cuda.max_memory_allocated()`` over the
window (reset as it opens), in 1e9 bytes: what the card holds for the
seed's machine (its tensors and its page pool) and one child's (its pool
and its materialized tree), with the KV cache and the activations.  Two
machines of a deployment summed on one card, not one machine's memory."""


def read(run):
    return run.peak_bytes / 1e9 if run.peak_bytes else None
