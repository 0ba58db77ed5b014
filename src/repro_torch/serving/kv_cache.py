"""Paged KV cache on top of the MITOSIS PagePool.

One page = `page_tokens` KV slots of one layer (K heads x head_dim), for K or
V.  Sequences hold per-layer page tables; `fork_sequence` shares pages
copy-on-write with refcounts — the serving-side realization of the paper's
zero-serialization state transfer (children fork the parent's prefix pages
and append privately).

A latent cache (``latent=True``, for latent attention) holds one row of
``head_dim`` per token and layer (one "KV head": the latent and the shared
rotary key, models/mla.py), in the K pages alone: it has no V pages, and
its V tables are None.

The pool is a DEVICE pool: the attention kernel reads the frames tensor
in place (``frames_view`` is a view, no copy), and prefill writes and
copy-on-write go through the page kernels.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import _dtypes, tracing
from repro_torch.memory.pool import PagePool


@dataclasses.dataclass
class SeqKV:
    seq_id: int
    length: int
    # page tables: (L, P) int32 frame ids for K and V (a latent cache's
    # v_pages is None)
    k_pages: np.ndarray
    v_pages: Optional[np.ndarray]
    # copy-on-write: pages shared with an ancestor are read-only
    shared_mask: np.ndarray       # (P,) bool — True = shared (not writable)


class PagedKV:
    def __init__(self, num_layers: int, kv_heads: int, head_dim: int,
                 page_tokens: int = 16, dtype=torch.bfloat16,
                 pool: Optional[PagePool] = None, device="cuda",
                 kernel_backend: str = "auto", latent: bool = False):
        if latent and kv_heads != 1:
            raise ValueError("a latent cache holds one row per token")
        self.latent = latent
        # the page tables of a sequence, by field of SeqKV
        self.tables = ("k_pages",) if latent else ("k_pages", "v_pages")
        self.L = num_layers
        self.K = kv_heads
        self.hd = head_dim
        self.Tp = page_tokens
        self.dtype = _dtypes.name(dtype)
        self.page_elems = page_tokens * kv_heads * head_dim
        self.pool = pool or PagePool(page_elems=self.page_elems,
                                     device=device,
                                     kernel_backend=kernel_backend)
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
        empty = np.zeros((self.L, 0), np.int32)
        self.seqs[sid] = SeqKV(sid, 0, empty,
                               None if self.latent else empty.copy(),
                               np.zeros((0,), bool))
        return sid

    def _frames(self, seq: SeqKV) -> list:
        """Every frame of ``seq``'s tables."""
        return [int(f) for t in self.tables
                for f in getattr(seq, t).ravel()]

    def _new_frames(self) -> list:
        """One new page per layer for each table (K, then V), counted in
        ``kv.page_bytes``."""
        out = [self.pool.alloc(self.dtype, self.L) for _ in self.tables]
        for frames in out:
            for f in frames:
                self.refcount[int(f)] = 1
        if tracing.enabled():
            tracing.count("kv.page_bytes", len(out) * self.L * self.page_elems
                          * _dtypes.torch_dtype(self.dtype).itemsize)
        return out

    def _alloc_column(self, seq: SeqKV) -> None:
        """Append one page per layer for K and V (a latent cache's rows)."""
        for t, frames in zip(self.tables, self._new_frames()):
            setattr(seq, t, np.concatenate([getattr(seq, t),
                                            frames[:, None]], axis=1))
        seq.shared_mask = np.concatenate([seq.shared_mask, [False]])

    def _cow_column(self, seq: SeqKV, col: int) -> None:
        """Privatize a shared page column before writing (COW)."""
        olds = [getattr(seq, t)[:, col].copy() for t in self.tables]
        for t, old, new in zip(self.tables, olds, self._new_frames()):
            self.pool.write_pages(self.dtype, new,
                                  self.pool.read_pages(self.dtype, old))
            getattr(seq, t)[:, col] = new
        for old in olds:
            for f in old:
                self._unref(int(f))
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
        """k_rows/v_rows: (L, K, hd) for the new token (v_rows None in a
        latent cache)."""
        seq = self.seqs[sid]
        col, slot = self.ensure_writable_slot(sid)
        row = self.K * self.hd
        slots = [slot] * self.L
        for t, rows in zip(self.tables, (k_rows, v_rows)):
            self.pool.write_rows(self.dtype, getattr(seq, t)[:, col], slots,
                                 rows.reshape(self.L, -1), row)
        seq.length += 1

    def write_prefill(self, sid: int, k, v) -> None:
        """k/v: (L, S, K, hd) — bulk-write a prefilled prefix (v None in a
        latent cache)."""
        L, S = k.shape[0], k.shape[1]
        seq = self.seqs[sid]
        assert seq.length == 0
        ncols = -(-S // self.Tp)
        for _ in range(ncols):
            self._alloc_column(seq)
        pad = ncols * self.Tp - S
        parts = []
        for x in (k, v)[:len(self.tables)]:
            if pad:
                x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
            parts.append(x.reshape(L, ncols, self.Tp, self.K, self.hd))
        for c in range(ncols):
            for t, x in zip(self.tables, parts):
                self.pool.write_pages(self.dtype, getattr(seq, t)[:, c],
                                      x[:, c].reshape(L, -1))
        seq.length = S

    # -- fork (the paper's state transfer) ---------------------------------------

    def fork_sequence(self, sid: int) -> int:
        """COW-fork: child shares every existing page read-only."""
        src = self.seqs[sid]
        child = self.new_seq()
        dst = self.seqs[child]
        dst.length = src.length
        for t in self.tables:
            setattr(dst, t, getattr(src, t).copy())
        dst.shared_mask = np.ones(src.k_pages.shape[1], bool)
        src.shared_mask = np.ones(src.k_pages.shape[1], bool)  # parent too
        for f in self._frames(src):
            self.refcount[f] = self.refcount.get(f, 1) + 1
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
        for f in self._frames(seq):
            self._unref(f)

    # -- batched views for attention ----------------------------------------------

    def batch_tables(self, sids: List[int], width: Optional[int] = None):
        """Pad page tables to a common length, the longest table's or
        ``width``: returns host (k_pt, v_pt, lengths) with shape (B, L, P);
        padded columns point at frame 0 (a latent cache's v_pt is None)."""
        P = max([self.seqs[s].k_pages.shape[1] for s in sids]
                + [width or 0])
        B = len(sids)
        pts = [np.zeros((B, self.L, P), np.int32) for _ in self.tables]
        lens = np.zeros((B,), np.int32)
        for i, s in enumerate(sids):
            seq = self.seqs[s]
            p = seq.k_pages.shape[1]
            for t, pt in zip(self.tables, pts):
                pt[i, :, :p] = getattr(seq, t)
            lens[i] = seq.length
        return pts[0], pts[1] if len(pts) > 1 else None, lens

    def bytes_in_use(self) -> int:
        return self.pool.bytes_allocated()
