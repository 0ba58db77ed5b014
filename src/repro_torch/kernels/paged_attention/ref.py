"""Plain PyTorch version of paged decode attention (GQA)."""
from __future__ import annotations

import torch

from repro_torch.kernels.paged_attention.kernel import NEG_INF


def paged_attention_ref(q, kv_pages_k, kv_pages_v, page_table, lengths,
                        starts=None, v_page_table=None):
    """q: (B, K, G, hd); kv pages: (F, Tp, K, hd); page_table: (B, P) int;
    lengths: (B,) int; starts: optional (B,) window lower bound.
    Returns (B, K, G, hd) in q's dtype.

    Slot t of sequence b lives at page page_table[b, t // Tp], row t % Tp.
    """
    B, K, G, hd = q.shape
    F, Tp, _, _ = kv_pages_k.shape
    P = page_table.shape[1]
    if starts is None:
        starts = torch.zeros_like(lengths)
    if v_page_table is None:
        v_page_table = page_table
    k = kv_pages_k[page_table.to(torch.long)].reshape(B, P * Tp, K, hd)
    v = kv_pages_v[v_page_table.to(torch.long)].reshape(B, P * Tp, K, hd)
    scores = torch.einsum("bkgh,bskh->bkgs", q.float(), k.float()) \
        * (hd ** -0.5)
    t = torch.arange(P * Tp, device=q.device)[None, :]
    mask = (t < lengths[:, None]) & (t >= starts[:, None])      # (B, S)
    scores = torch.where(mask[:, None, None, :], scores,
                         torch.full_like(scores, NEG_INF))
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bkgs,bskh->bkgh", w, v.float()).to(q.dtype)
