"""Paged KV cache on top of the MITOSIS PagePool.

One page = `page_tokens` KV slots of one layer (K heads x head_dim), for K or
V.  Sequences hold per-layer page tables; `fork_sequence` shares pages
copy-on-write with refcounts — the serving-side realization of the paper's
zero-serialization state transfer (children fork the parent's prefix pages
and append privately).

The pool is a DEVICE pool: the attention kernel reads the frames tensor
in place (``frames_view`` is a view, no copy), and prefill writes and
copy-on-write go through the page kernels.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import _dtypes
from repro_torch.memory.pool import PagePool


@dataclasses.dataclass
class SeqKV:
    seq_id: int
    length: int
    # page tables: (L, P) int32 frame ids for K and V
    k_pages: np.ndarray
    v_pages: np.ndarray
    # copy-on-write: pages shared with an ancestor are read-only
    shared_mask: np.ndarray       # (P,) bool — True = shared (not writable)


class PagedKV:
    def __init__(self, num_layers: int, kv_heads: int, head_dim: int,
                 page_tokens: int = 16, dtype=torch.bfloat16,
                 pool: Optional[PagePool] = None, device="cuda",
                 kernel_backend: str = "auto", meter=None):
        self.L = num_layers
        self.K = kv_heads
        self.hd = head_dim
        self.Tp = page_tokens
        self.dtype = _dtypes.name(dtype)
        self.page_elems = page_tokens * kv_heads * head_dim
        self.pool = pool or PagePool(page_elems=self.page_elems,
                                     device=device,
                                     kernel_backend=kernel_backend,
                                     meter=meter)
        assert self.pool.page_elems == self.page_elems
        if self.pool.device is None:
            raise ValueError("PagedKV needs a device pool")
        self.refcount: Dict[int, int] = {}
        self.seqs: Dict[int, SeqKV] = {}
        self._next = 0

    # -- frames view for the attention kernel ---------------------------------

    def frames_view(self) -> torch.Tensor:
        f = self.pool.frames_array(self.dtype)
        return f.view(f.shape[0], self.Tp, self.K, self.hd)

    # -- sequence lifecycle ----------------------------------------------------

    def new_seq(self) -> int:
        sid = self._next
        self._next += 1
        self.seqs[sid] = SeqKV(sid, 0,
                               np.zeros((self.L, 0), np.int32),
                               np.zeros((self.L, 0), np.int32),
                               np.zeros((0,), bool))
        return sid

    def _alloc_column(self, seq: SeqKV) -> None:
        """Append one page per layer for K and V."""
        kf = self.pool.alloc(self.dtype, self.L)
        vf = self.pool.alloc(self.dtype, self.L)
        for f in list(kf) + list(vf):
            self.refcount[int(f)] = 1
        seq.k_pages = np.concatenate([seq.k_pages, kf[:, None]], axis=1)
        seq.v_pages = np.concatenate([seq.v_pages, vf[:, None]], axis=1)
        seq.shared_mask = np.concatenate([seq.shared_mask, [False]])

    def _cow_column(self, seq: SeqKV, col: int) -> None:
        """Privatize a shared page column before writing (COW)."""
        old_k, old_v = seq.k_pages[:, col].copy(), seq.v_pages[:, col].copy()
        kf = self.pool.alloc(self.dtype, self.L)
        vf = self.pool.alloc(self.dtype, self.L)
        self.pool.write_pages(self.dtype, kf,
                              self.pool.read_pages(self.dtype, old_k))
        self.pool.write_pages(self.dtype, vf,
                              self.pool.read_pages(self.dtype, old_v))
        for f in list(kf) + list(vf):
            self.refcount[int(f)] = 1
        for f in list(old_k) + list(old_v):
            self._unref(int(f))
        seq.k_pages[:, col] = kf
        seq.v_pages[:, col] = vf
        seq.shared_mask[col] = False

    def ensure_writable_slot(self, sid: int) -> tuple:
        """Returns (col, slot) where the next token goes; allocates/COWs."""
        seq = self.seqs[sid]
        col, slot = divmod(seq.length, self.Tp)
        if col >= seq.k_pages.shape[1]:
            self._alloc_column(seq)
        elif seq.shared_mask[col]:
            self._cow_column(seq, col)
        return col, slot

    def append_token(self, sid: int, k_rows, v_rows) -> None:
        """k_rows/v_rows: (L, K, hd) for the new token."""
        seq = self.seqs[sid]
        col, slot = self.ensure_writable_slot(sid)
        row = self.K * self.hd
        slots = [slot] * self.L
        self.pool.write_rows(self.dtype, seq.k_pages[:, col], slots,
                             k_rows.reshape(self.L, -1), row)
        self.pool.write_rows(self.dtype, seq.v_pages[:, col], slots,
                             v_rows.reshape(self.L, -1), row)
        seq.length += 1

    def write_prefill(self, sid: int, k, v) -> None:
        """k/v: (L, S, K, hd) — bulk-write a prefilled prefix."""
        L, S = k.shape[0], k.shape[1]
        seq = self.seqs[sid]
        assert seq.length == 0
        ncols = -(-S // self.Tp)
        for _ in range(ncols):
            self._alloc_column(seq)
        pad = ncols * self.Tp - S
        if pad:
            k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
            v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        k = k.reshape(L, ncols, self.Tp, self.K, self.hd)
        v = v.reshape(L, ncols, self.Tp, self.K, self.hd)
        for c in range(ncols):
            self.pool.write_pages(self.dtype, seq.k_pages[:, c],
                                  k[:, c].reshape(L, -1))
            self.pool.write_pages(self.dtype, seq.v_pages[:, c],
                                  v[:, c].reshape(L, -1))
        seq.length = S

    # -- fork (the paper's state transfer) ---------------------------------------

    def fork_sequence(self, sid: int) -> int:
        """COW-fork: child shares every existing page read-only."""
        src = self.seqs[sid]
        child = self.new_seq()
        dst = self.seqs[child]
        dst.length = src.length
        dst.k_pages = src.k_pages.copy()
        dst.v_pages = src.v_pages.copy()
        dst.shared_mask = np.ones(src.k_pages.shape[1], bool)
        src.shared_mask = np.ones(src.k_pages.shape[1], bool)  # parent too
        for f in list(src.k_pages.ravel()) + list(src.v_pages.ravel()):
            self.refcount[int(f)] = self.refcount.get(int(f), 1) + 1
        return child

    def _unref(self, frame: int) -> None:
        self.refcount[frame] = self.refcount.get(frame, 1) - 1
        if self.refcount[frame] <= 0:
            self.pool.free(self.dtype, [frame])
            del self.refcount[frame]

    def free_seq(self, sid: int) -> None:
        seq = self.seqs.pop(sid, None)
        if seq is None:
            return
        for f in list(seq.k_pages.ravel()) + list(seq.v_pages.ravel()):
            self._unref(int(f))

    # -- batched views for attention ----------------------------------------------

    def batch_tables(self, sids: List[int]):
        """Pad page tables to a common length: returns host (k_pt, v_pt,
        lengths) with shape (B, L, P); padded columns point at frame 0."""
        P = max(self.seqs[s].k_pages.shape[1] for s in sids)
        B = len(sids)
        k_pt = np.zeros((B, self.L, P), np.int32)
        v_pt = np.zeros((B, self.L, P), np.int32)
        lens = np.zeros((B,), np.int32)
        for i, s in enumerate(sids):
            seq = self.seqs[s]
            p = seq.k_pages.shape[1]
            k_pt[i, :, :p] = seq.k_pages
            v_pt[i, :, :p] = seq.v_pages
            lens[i] = seq.length
        return k_pt, v_pt, lens

    def bytes_in_use(self) -> int:
        return self.pool.bytes_allocated()
