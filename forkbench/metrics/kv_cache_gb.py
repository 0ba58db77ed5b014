"""kv_cache_gb (GB): inside the profiled sub-window, the bytes of paged
cache an invocation allocates, in 1e9 (the program's ``kv.page_bytes``
counter over the sub-window's ``invoke`` spans): K and V pages of a GQA
model, the latent rows of a latent-attention one, each page counted once
whatever share of it is filled."""


def read(run):
    roots = sum(1 for s in run.spans if s.name == "invoke" and s.parent == -1)
    n = run.counters.get("kv.page_bytes")
    return n / roots / 1e9 if n and roots else None
