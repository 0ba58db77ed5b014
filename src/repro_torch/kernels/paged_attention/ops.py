"""Public wrapper for paged decode attention, routed through
kernels/dispatch.py like the paging kernels (metered as
``kernel.paged_attention.{cuda|torch}``)."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.paged_attention import kernel
from repro_torch.kernels.paged_attention.ref import paged_attention_ref


def _table(x, device, num_frames=None) -> torch.Tensor:
    """An int32 table on ``device``; host page tables are range-checked
    here (the kernel would read out of bounds where indexing raises)."""
    if not isinstance(x, torch.Tensor):
        a = np.asarray(x, np.int64)
        if num_frames is not None and a.size and (a.min() < 0 or
                                                  a.max() >= num_frames):
            raise IndexError(f"page table entries out of [0, {num_frames})")
        x = torch.from_numpy(a.astype(np.int32))
    return x.to(device=device, dtype=torch.int32).contiguous()


def paged_attention(q, kv_pages_k, kv_pages_v, page_table, lengths, *,
                    v_page_table=None, starts=None, backend: str = "auto"):
    """Decode attention over paged KV (GQA).

    q: (B, K, G, hd) — G = query heads per kv head.
    kv_pages_*: (F, Tp, K, hd) pool frames; page_table: (B, P); lengths:
    (B,); starts: optional (B,) lower bound (sliding windows).  Tokens
    outside ``[starts[b], lengths[b])`` are masked.  A sequence with no
    token in that range gets the unweighted mean of V over all ``P * Tp``
    slots of its table, padded columns included, from the kernel and the
    plain version alike, as from the reference's.
    """
    if q.dim() != 4:
        raise ValueError(f"q must be (B,K,G,hd), got {tuple(q.shape)}")
    if kv_pages_k.shape != kv_pages_v.shape:
        raise ValueError("k/v page pools must match")
    impl = dispatch.resolve_backend(backend, kernel_name="paged_attention",
                                    device=q.device)
    dev = q.device
    F = kv_pages_k.shape[0]
    kt = _table(page_table, dev, F)
    vt = kt if v_page_table is None else _table(v_page_table, dev, F)
    lens = _table(lengths, dev)
    st = None if starts is None else _table(starts, dev)
    if impl == dispatch.IMPL_TORCH:
        return paged_attention_ref(q, kv_pages_k, kv_pages_v, kt, lens, st,
                                   vt)
    return kernel.paged_attention(q.contiguous(), kv_pages_k.contiguous(),
                                  kv_pages_v.contiguous(), kt, vt, lens, st)
