"""Paged decode attention over a latent cache (multi-head latent
attention): the wrapper, its plain PyTorch version and the launcher of
``csrc/latent_attention.cu``.

It replaces no TPU kernel (the JAX package has no latent attention).  A
latent row ``[c, k_pe]`` of ``R`` floats per token and layer is every
head's key and, in its first ``dv`` columns, every head's value; the
kernel reads each row once for all heads, which is its whole design: the
work is bound by bytes.  Each sequence is split across blocks by
``plan.split_plan`` (as ``paged_attention``, one "KV head"), with a
combine pass when there is more than one split.  One call is one count in
``dispatch``.  The launches go on PyTorch's current stream and do not
synchronise.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, dispatch
from repro_torch.kernels.paged_attention import plan
from repro_torch.kernels.paged_attention.kernel import NEG_INF, sm_count
from repro_torch.kernels.paged_attention.ops import _table

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
MAX_HEADS = 16      # csrc: kMaxH
MAX_ROW = 1024      # csrc: kMaxR (a multiple of 4)
MAX_DV = 512        # csrc: kMaxDv


def latent_attention_ref(q, pool, page_table, lengths, dv: int,
                         scale: float):
    """q (B, H, R); pool (F, Tp, R) rows; page_table (B, P) int; lengths
    (B,) int -> (B, H, dv) in q's dtype, computed in fp32: the softmax of
    ``(q . row_t) * scale`` over the tokens ``t < lengths[b]`` (slot ``t %
    Tp`` of frame ``page_table[b, t // Tp]``) weighting ``row_t[:dv]``;
    zeros for a sequence with no token."""
    B, H, R = q.shape
    F, Tp = pool.shape[:2]
    P = page_table.shape[1]
    rows = pool.reshape(F, Tp, R)[page_table.to(torch.long)]
    rows = rows.reshape(B, P * Tp, R).float()
    s = torch.einsum("bhr,bsr->bhs", q.float(), rows) * scale
    valid = (torch.arange(P * Tp, device=q.device)[None, :]
             < lengths[:, None])[:, None, :]
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - s.amax(-1, keepdim=True)) * valid
    o = torch.einsum("bhs,bsc->bhc", p, rows[..., :dv])
    return (o / torch.clamp(p.sum(-1, keepdim=True), min=1e-30)).to(q.dtype)


def latent_bytes(lengths, H: int, R: int, dv: int, itemsize: int = 4) -> int:
    """Bytes one call needs from and to device memory, from host
    ``lengths``: every cached row in range read once, the queries read and
    the outputs written."""
    tokens = int(sum(int(n) for n in lengths))
    return itemsize * (tokens * R + len(lengths) * H * (R + dv))


def _launch(q, pool, page_table, lengths, dv: int, scale: float):
    B, H, R = q.shape
    F, Tp = pool.shape[:2]
    P = page_table.shape[1]
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"latent_attention kernel needs CUDA tensors, got "
                         f"{dev}")
    if q.dtype != torch.float32 or pool.dtype != torch.float32:
        raise ValueError("latent_attention kernel takes float32 only")
    if not 1 <= H <= MAX_HEADS or R % 4 or not 4 <= R <= MAX_ROW:
        raise ValueError(f"kernel supports heads <= {MAX_HEADS} and rows of "
                         f"a multiple of 4 up to {MAX_ROW}, got H={H} R={R}")
    if dv % 4 or not 4 <= dv <= min(R, MAX_DV):
        raise ValueError(f"value width must be a multiple of 4, at most "
                         f"{MAX_DV} and the row's, got {dv}")
    if pool.shape[-1] != R or pool.numel() != F * Tp * R or P < 1:
        raise ValueError("pool must be (F, Tp, R) rows of q's width and the "
                         "page table at least one column")
    for t in (q, pool):
        if t.device != dev or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("q and the pool must be contiguous, 16-byte "
                             "aligned and on one device")
    for t, shape in ((page_table, (B, P)), (lengths, (B,))):
        if (t.device != dev or t.dtype != torch.int32
                or not t.is_contiguous() or tuple(t.shape) != shape):
            raise ValueError(f"tables must be contiguous int32 {shape} on "
                             f"{dev}")
    out = torch.empty((B, H, dv), dtype=torch.float32, device=dev)
    splits, cols = plan.split_plan(B, 1, P, sm_count(dev))
    ws = (torch.empty(B * splits * H * (dv + 2) + 4, dtype=torch.float32,
                      device=dev) if splits > 1 else None)
    fn = build.function("latent_attention", "latent_attention",
                        [_P] * 6 + [_I] * 9 + [_F, _P])
    dispatch.count_launch("latent_attention")
    err = fn(q.data_ptr(), pool.data_ptr(), page_table.data_ptr(),
             lengths.data_ptr(), out.data_ptr(),
             None if ws is None else ws.data_ptr(), B, H, R, dv, Tp, P,
             splits, cols, plan.tile_tokens(Tp), scale, build.stream(dev))
    build.check(err, "latent_attention")
    return out


def latent_attention(q, pool, page_table, lengths, *, dv: int, scale: float,
                     backend: str = "auto"):
    """Decode attention of ``q`` (B, H, R) over the latent rows of ``pool``
    ((F, Tp, R), or (F, Tp, 1, R) as ``PagedKV`` views a latent pool)
    through ``page_table`` (B, P) up to ``lengths`` (B,): (B, H, dv), the
    kernel on CUDA tensors, the plain version on CPU ones (``backend`` as
    ``dispatch.resolve_backend`` takes it)."""
    if q.dim() != 3:
        raise ValueError(f"q must be (B, H, R), got {tuple(q.shape)}")
    impl = dispatch.resolve_backend(backend, kernel_name="latent_attention",
                                    device=q.device)
    F, Tp = pool.shape[:2]
    pool = pool.reshape(F, Tp, q.shape[-1])
    pt = _table(page_table, q.device, F)
    lens = _table(lengths, q.device)
    if impl == dispatch.IMPL_TORCH:
        return latent_attention_ref(q, pool, pt, lens, dv, scale)
    return _launch(q.contiguous(), pool.contiguous(), pt, lens, dv, scale)
