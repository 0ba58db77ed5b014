"""Page tables with remote/owner-hop bits — the extended PTE of §5.4/5.5.

Each tensor of an instance is one VMA.  Per page we track:
  owner_hop : 0 = local frame, h>0 = frame lives on the h-th ancestor
              (4-bit field, <= 15 hops, exactly the paper's PTE encoding)
  frame     : frame index in the owner's PagePool
  flags     : PRESENT | DIRTY
A VMA also carries its DC keys (connection-based access control, §5.4):
one key per ancestor hop, since after partial COW a VMA can mix pages owned
by several ancestors (§5.5) — plus its ROUTE (repro_torch.placement): a per-VMA
owner chain and transport name, so one child's VMAs can page in from
different parent replicas over different fabrics.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch import _dtypes

MAX_HOPS = 15          # 4 bits in the PTE's ignored bits (paper §5.5)

F_PRESENT = 0x1        # local copy materialized
F_DIRTY = 0x2          # locally modified (COW'd)


@dataclasses.dataclass
class VMA:
    name: str
    shape: Tuple[int, ...]
    dtype: str
    npages: int
    owner_hop: np.ndarray        # (npages,) uint8
    frames: np.ndarray           # (npages,) int32, index into owner pool
    flags: np.ndarray            # (npages,) uint8
    dc_keys: Dict[int, int] = dataclasses.field(default_factory=dict)
                                 # hop -> DC key at that ancestor
    version: int = 0             # bumped on every residency/content change;
                                 # lets callers cache assembled tensors and
                                 # reassemble only when pages actually moved
    page_version: Optional[np.ndarray] = None
                                 # (npages,) int64 — the VMA version at which
                                 # each page last changed (residency or
                                 # dirty).  Lets the assembler patch exactly
                                 # the pages that moved since a cached
                                 # snapshot instead of rebuilding the tensor
    # -- route (repro_torch.placement): per-VMA owner chain + transport ----------
    ancestry: List[str] = dataclasses.field(default_factory=list)
                                 # hop h reads from ancestry[h-1]; empty =
                                 # fall back to the instance-level chain
    transport: Optional[str] = None
                                 # page-fetch transport for THIS VMA; None =
                                 # the instance/policy default

    def __post_init__(self):
        if self.page_version is None:
            self.page_version = np.zeros(self.npages, np.int64)

    @classmethod
    def new_local(cls, name, shape, dtype, frames):
        n = len(frames)
        return cls(
            name=name, shape=tuple(shape), dtype=_dtypes.name(dtype), npages=n,
            owner_hop=np.zeros(n, np.uint8),
            frames=np.asarray(frames, np.int32),
            flags=np.full(n, F_PRESENT, np.uint8),
        )

    def child_view(self, parent_key: int, parent_node: Optional[str] = None,
                   default_ancestry=()) -> "VMA":
        """Fork: child's pages point one hop further up; nothing resident.

        Pages the parent owned (hop 0) become hop 1, guarded by the freshly
        assigned `parent_key`; pages the parent itself still reads from
        ancestors shift one hop up and keep their ancestors' keys.

        ``parent_node`` stamps the child VMA's own owner chain (route):
        hop 1 is the parent, deeper hops are the parent's chain (its own
        per-VMA ancestry, or ``default_ancestry`` — the descriptor's
        instance-level chain — when it has none).  The route transport is
        inherited: a VMA pinned to e.g. ``shared_fs`` stays there across
        generations until a placement policy re-routes it.
        """
        hop = self.owner_hop.astype(np.int32)
        # Pages the parent had not COW'd still belong to the same ancestor:
        # hop h>0 stays pointing at that ancestor, renumbered h+1 in the
        # child's chain. Hop-0 pages become hop 1 (the parent).
        new_hop = hop + 1
        if new_hop.max(initial=0) > MAX_HOPS:
            raise OverflowError(
                f"fork depth exceeds {MAX_HOPS} hops (paper §5.5 PTE encoding)")
        keys = {h + 1: k for h, k in self.dc_keys.items()}
        keys[1] = parent_key
        chain = []
        if parent_node is not None:
            chain = [parent_node] + list(self.ancestry or default_ancestry)
        return VMA(
            name=self.name, shape=self.shape, dtype=self.dtype,
            npages=self.npages,
            owner_hop=new_hop.astype(np.uint8),
            frames=self.frames.copy(),
            flags=np.zeros(self.npages, np.uint8),
            dc_keys=keys,
            ancestry=chain,
            transport=self.transport,
        )

    def owner_at(self, hop: int, default_ancestry=()) -> str:
        """Node id serving this VMA's pages at ``hop`` (>= 1), resolved
        against the VMA's own route chain, falling back to the instance
        chain the caller passes."""
        chain = self.ancestry or default_ancestry
        return chain[hop - 1]

    # -- queries -------------------------------------------------------------

    def resident_mask(self) -> np.ndarray:
        return (self.flags & F_PRESENT) != 0

    def missing_mask(self) -> np.ndarray:
        return (self.flags & F_PRESENT) == 0

    def missing_pages(self) -> np.ndarray:
        return np.nonzero(self.missing_mask())[0].astype(np.int32)

    def request_mask(self, pages) -> np.ndarray:
        """Bool mask over this VMA's pages for a requested page list:
        out-of-range indices are silently dropped.  The one clipping/
        validation site for the fault path and the prefetch engine."""
        mask = np.zeros(self.npages, bool)
        req = np.atleast_1d(np.asarray(pages, np.int64)).ravel()
        mask[req[(req >= 0) & (req < self.npages)]] = True
        return mask

    def want_mask(self, pages, prefetch: int = 0) -> np.ndarray:
        """Bool mask of missing pages a fault on ``pages`` should fetch:
        the missing requested pages, plus up to ``prefetch`` pages of
        lookahead window behind each missing requested page.

        Pure numpy mask ops — the prefetch window is an interval union
        built with a difference array (one cumsum), so cost is
        O(npages + len(pages)) regardless of the window size, not the
        quadratic per-page expansion loop this replaces."""
        miss = self.missing_mask()
        want = self.request_mask(pages) & miss
        if prefetch > 0:
            # windows extend only behind *missing* requested pages — a
            # resident touch is not a fault and must not trigger pulls
            faulted = np.nonzero(want)[0]
            if faulted.size:
                diff = np.zeros(self.npages + 1, np.int32)
                starts = np.minimum(faulted + 1, self.npages)
                ends = np.minimum(faulted + 1 + prefetch, self.npages)
                np.add.at(diff, starts, 1)
                np.add.at(diff, ends, -1)
                window = np.cumsum(diff[:-1]) > 0
                want |= window & miss
        return want

    def nbytes(self) -> int:
        return int(np.prod(self.shape)) * _dtypes.itemsize(self.dtype)

    # -- updates -------------------------------------------------------------

    def mark_resident(self, pages, local_frames):
        self.owner_hop[pages] = 0
        self.frames[pages] = local_frames
        self.flags[pages] |= F_PRESENT
        self.version += 1
        self.page_version[pages] = self.version

    def mark_dirty(self, pages):
        self.flags[pages] |= F_DIRTY
        self.version += 1
        self.page_version[pages] = self.version

    def changed_since(self, version: int) -> np.ndarray:
        """Pages whose residency/content changed after VMA version
        ``version`` — the incremental-reassembly work list."""
        return np.nonzero(self.page_version > version)[0].astype(np.int32)

    def table_dict(self) -> dict:
        return {
            "name": self.name, "shape": list(self.shape), "dtype": self.dtype,
            "npages": self.npages,
            "owner_hop": self.owner_hop.tobytes(),
            "frames": self.frames.tobytes(),
            "dc_keys": {int(h): int(k) for h, k in self.dc_keys.items()},
            "ancestry": list(self.ancestry),
            "transport": self.transport,
        }

    @classmethod
    def from_table_dict(cls, d) -> "VMA":
        n = d["npages"]
        return cls(
            name=d["name"], shape=tuple(d["shape"]), dtype=d["dtype"], npages=n,
            owner_hop=np.frombuffer(d["owner_hop"], np.uint8).copy(),
            frames=np.frombuffer(d["frames"], np.int32).copy(),
            flags=np.zeros(n, np.uint8),
            dc_keys={int(h): int(k) for h, k in d["dc_keys"].items()},
            ancestry=list(d.get("ancestry") or []),
            transport=d.get("transport"),
        )


AddressSpace = Dict[str, VMA]
