"""NodeRuntime — one "machine" (kernel) in the MITOSIS cluster.

Hosts the page pool, prepared seeds, the DC-target pool (pooled, refilled in
the background per §5.4), the sibling page cache, the fallback daemon, and
swap-out (the VA->PA-change corner case that exercises connection-based
access control).
"""
from __future__ import annotations

import itertools
import math
import secrets
import time
from collections import Counter, OrderedDict
from typing import Dict, Optional

import numpy as np

from repro_torch import _dtypes
from repro_torch.memory.pool import PAGE_ELEMS, PagePool
from repro_torch.net import AccessRevoked, AuthError, LeaseExpired, SeedGone

DEFAULT_PAGE_CACHE_CAP = 65536     # sibling-cache entries (pages), LRU-bounded


class SeedEntry:
    def __init__(self, descriptor, blob, auth_key, instance, keys, created,
                 lease_deadline: float = math.inf,
                 lease_duration: Optional[float] = None, generation: int = 0,
                 desc_key: int = -1):
        self.descriptor = descriptor
        self.blob = blob
        self.auth_key = auth_key
        self.instance = instance
        self.keys = keys                  # vma name -> DC key
        self.desc_key = desc_key          # DC key guarding the blob itself
        self.created = created
        self.lease_deadline = lease_deadline   # absolute (this node's clock)
        self.lease_duration = lease_duration   # seconds; None = unbounded
        self.generation = generation           # bumped by revoke_seed
        self.forks = 0


class NodeRuntime:
    def __init__(self, node_id: str, network, page_elems: int = PAGE_ELEMS,
                 cache_enabled: bool = False,
                 clock=time.monotonic,  # sim-ok: wall-clock -- host default; replays pass SimClock

                 page_cache_cap: int = DEFAULT_PAGE_CACHE_CAP,
                 page_cache_cap_bytes: Optional[int] = None,
                 pool_frames: int = 0, device_pool: bool = False,
                 kernel_backend: str = "auto", device="cuda"):
        self.node_id = node_id
        self.network = network
        # pool_frames pre-reserves physical-frame capacity (lazily zeroed),
        # so replay clusters that churn thousands of containers never pay
        # pool-growth copies mid-run.  device_pool=True holds frames on
        # ``device`` and routes the pool's data plane through the
        # page_gather/cow_scatter kernels (kernel_backend selects the impl
        # via kernels.dispatch; the chosen impl surfaces in network.meter).
        self.pool = PagePool(page_elems, initial_frames=pool_frames,
                             device=device if device_pool else None,
                             kernel_backend=kernel_backend,
                             meter=network.meter)
        self.clock = clock
        self.instances: Dict[int, "object"] = {}
        self.seeds: Dict[int, SeedEntry] = {}
        self.cache_enabled = cache_enabled
        self._page_cache: "OrderedDict[tuple, int]" = OrderedDict()
        # reverse index (dtype, local_frame) -> cache key, so freeing an
        # instance invalidates its frames in O(frames), not O(cache)
        self._page_cache_rev: Dict[tuple, tuple] = {}
        self._page_cache_bytes = 0
        self.page_cache_cap = page_cache_cap
        self.page_cache_cap_bytes = page_cache_cap_bytes  # None = unbounded
        self.page_cache_stats = {"hits": 0, "misses": 0, "evictions": 0}
        # per-node lease telemetry (renewals/expiries/revocations), rolled
        # up per-function by Coordinator.gc()
        self.lease_stats = Counter()
        self._dc_pool: list = []
        self._swapped: Dict[tuple, np.ndarray] = {}
        self._iid = itertools.count()
        self._hid = itertools.count(1)
        self.alive = True
        network.register(self)

    def new_instance_id(self) -> int:
        return next(self._iid)

    # -- DC target pooling (§5.4: creation amortized via pooling) -------------

    def refill_dc_pool(self, n: int) -> None:
        for _ in range(n):
            self._dc_pool.append(self.network.create_dc_target(self.node_id))

    def take_dc_target(self) -> int:
        if self._dc_pool:
            return self._dc_pool.pop()
        return self.network.create_dc_target(self.node_id)

    # -- seed registry ---------------------------------------------------------

    def prepare_fork(self, instance, lease: Optional[float] = None):
        """Prepare ``instance`` as a seed and mint its leased capability
        (``ForkHandle``).  ``lease`` is a duration in seconds; None means
        unbounded.  The handle is a context manager (reclaim on exit)."""
        from repro_torch.fork.handle import prepare_fork as _prepare
        return _prepare(self, instance, lease=lease)

    def register_seed(self, handler_id: int, entry: SeedEntry) -> None:
        san = self.network.sanitizer
        if san is not None:
            san.lease_register(self.node_id, handler_id)
        self.seeds[handler_id] = entry

    def auth_seed(self, handler_id: int, auth_key: int,
                  generation: int = 0) -> dict:
        """Authentication RPC (§5.2 + rFaaS leases): validates the id/key,
        the handle's revocation generation and the lease deadline, then
        returns the descriptor's size and DC key for the follow-up read."""
        e = self.seeds.get(handler_id)
        if e is None or e.auth_key != auth_key:
            raise AuthError(f"bad seed credentials for {handler_id}")
        if generation != e.generation:
            raise AccessRevoked(
                f"seed {handler_id}: handle generation {generation} revoked "
                f"(current {e.generation})")
        if self.clock() >= e.lease_deadline:
            self.lease_stats["expiries"] += 1
            raise LeaseExpired(
                f"seed {handler_id}: lease expired at {e.lease_deadline:.3f}")
        e.forks += 1
        return {"nbytes": len(e.blob), "desc_key": e.desc_key}

    def renew_seed(self, handler_id: int,
                   extend: Optional[float] = None) -> float:
        """Extend a seed's lease by ``extend`` seconds (default: its
        original lease duration) and refresh its creation stamp (renewal is
        a keepalive).  Returns the new absolute deadline."""
        if extend is not None and extend <= 0:
            raise ValueError(
                f"extend must be positive seconds or None, got {extend!r}")
        e = self.seeds.get(handler_id)
        if e is None:
            raise SeedGone(f"seed {handler_id} is not registered "
                           "(already reclaimed?)")
        duration = extend if extend is not None else e.lease_duration
        now = self.clock()
        e.created = now
        e.lease_deadline = math.inf if duration is None else now + duration
        self.lease_stats["renewals"] += 1
        san = self.network.sanitizer
        if san is not None:
            san.lease_renew(self.node_id, handler_id)
        return e.lease_deadline

    def revoke_seed(self, handler_id: int) -> int:
        """Bump the seed's revocation generation: every outstanding handle
        dies at the next auth.  The descriptor's DC key is rotated too, so
        a revoked holder who learned it at an earlier auth can no longer
        read the blob (and harvest the VMA keys inside) — the fresh
        generation re-learns the new key at auth.  Returns the new
        generation."""
        e = self.seeds[handler_id]
        e.generation += 1
        self.network.destroy_dc_target(self.node_id, e.desc_key)
        e.desc_key = self.take_dc_target()
        self.lease_stats["revocations"] += 1
        san = self.network.sanitizer
        if san is not None:
            san.lease_revoke(self.node_id, handler_id)
        return e.generation

    def reclaim_seed(self, handler_id: int,
                     free_instance: bool = False) -> None:
        """Destroy the seed's DC targets and unregister it (idempotent);
        in-flight children fall back to the RPC daemon while pages live."""
        entry = self.seeds.pop(handler_id, None)
        if entry is None:
            return
        san = self.network.sanitizer
        if san is not None:
            san.lease_reclaim(self.node_id, handler_id)
        for key in entry.keys.values():
            self.network.destroy_dc_target(self.node_id, key)
        self.network.destroy_dc_target(self.node_id, entry.desc_key)
        if free_instance and entry.instance is not None:
            entry.instance.free()

    def seed_blob(self, handler_id: int,
                  desc_key: Optional[int] = None) -> bytes:
        """Serve a seed's descriptor blob.  The daemon enforces the blob's
        DC key like the RNIC does for one-sided reads, so a reclaimed
        seed's descriptor raises AccessRevoked over two-sided fabrics too."""
        e = self.seeds.get(handler_id)
        if e is None:
            raise AccessRevoked(f"seed {handler_id} reclaimed; descriptor gone")
        if desc_key is not None \
                and not self.network.target_valid(self.node_id, desc_key):
            raise AccessRevoked(
                f"descriptor DC target {desc_key}@{self.node_id} destroyed")
        return e.blob

    # -- fallback daemon (§5.4) -------------------------------------------------

    def fallback_serve(self, dtype, frames):
        """RPC handler: load pages on behalf of a child (swapped or live).
        One pool gather serves every live frame; swapped-out frames are
        overlaid from "disk" — no per-frame read/stack loop."""
        dt = _dtypes.name(dtype)
        idx = np.asarray(frames, np.int32).ravel()
        live = np.asarray([(dt, int(f)) not in self._swapped
                           for f in idx.tolist()], bool)
        out = np.zeros((idx.size, self.pool.page_elems),
                       dtype=_dtypes.numpy_dtype(dt))
        if live.all() and idx.size:
            # common case (nothing swapped): run-coalesced gather straight
            # into the reply buffer, no intermediate copy
            self.pool.read_pages_host(dtype, idx, out=out)
        elif live.any():
            out[live] = self.pool.read_pages_host(dtype, idx[live])
        for i in np.nonzero(~live)[0]:
            out[i] = self._swapped[(dt, int(idx[i]))]
        return out

    # -- swap-out: the VA->PA change corner case ---------------------------------

    def swap_out_vma(self, instance, name: str) -> None:
        """Move a VMA's pages to "disk" and destroy its DC targets, so
        children's one-sided reads are rejected and take the fallback path."""
        vma = instance.aspace[name]
        dt = _dtypes.name(vma.dtype)
        data = self.pool.read_pages_host(vma.dtype, vma.frames)
        for i, f in enumerate(vma.frames.tolist()):
            self._swapped[(dt, int(f))] = data[i]
        for e in self.seeds.values():
            if e.instance is instance and name in e.keys:
                self.network.destroy_dc_target(self.node_id, e.keys[name])

    # -- sibling page cache (MITOSIS+cache, §5.4 optimizations) -------------------
    # LRU-bounded at page_cache_cap entries AND (optionally) at
    # page_cache_cap_bytes — eviction runs on whichever limit trips first,
    # so multi-dtype workloads with fat pages can't blow past a byte budget
    # that the entry cap alone would allow.  Evictions only forget the
    # mapping (the frames stay owned by whichever instance fetched them).

    def _page_cache_entry_bytes(self, key: tuple) -> int:
        return self.pool.page_elems * _dtypes.itemsize(key[1])

    def page_cache_bytes(self) -> int:
        return self._page_cache_bytes

    def page_cache_get(self, owner: str, dtype: str, frame: int) -> Optional[int]:
        if not self.cache_enabled:
            return None
        key = (owner, _dtypes.name(dtype), int(frame))
        local = self._page_cache.get(key)
        if local is None:
            self.page_cache_stats["misses"] += 1
            return None
        self._page_cache.move_to_end(key)
        self.page_cache_stats["hits"] += 1
        return local

    def page_cache_get_many(self, owner: str, dtype: str,
                            frames) -> np.ndarray:
        """Batched probe: int32 array of local frames, -1 per miss.  One
        call per fault instead of one per page — the dict walk stays, the
        per-page Python call/stat churn goes."""
        idx = np.asarray(frames, np.int64).ravel()
        out = np.full(idx.size, -1, np.int32)
        if not self.cache_enabled:
            return out
        dt = _dtypes.name(dtype)
        cache = self._page_cache
        for i, f in enumerate(idx.tolist()):
            key = (owner, dt, int(f))
            local = cache.get(key)
            if local is not None:
                cache.move_to_end(key)
                out[i] = local
        hits = int((out >= 0).sum())
        self.page_cache_stats["hits"] += hits
        self.page_cache_stats["misses"] += idx.size - hits
        return out

    def page_cache_put_many(self, owner: str, dtype: str, frames,
                            locals_) -> None:
        """Batched insert: one call per fault; eviction policy unchanged."""
        if not self.cache_enabled:
            return
        for f, lf in zip(np.asarray(frames).tolist(),
                         np.asarray(locals_).tolist()):
            self.page_cache_put(owner, dtype, int(f), int(lf))

    def page_cache_put(self, owner: str, dtype: str, frame: int, local: int) -> None:
        if not self.cache_enabled:
            return
        key = (owner, _dtypes.name(dtype), int(frame))
        old_local = self._page_cache.get(key)
        if old_local is None:
            self._page_cache_bytes += self._page_cache_entry_bytes(key)
        else:
            self._page_cache_rev.pop((key[1], old_local), None)
        rev_key = (key[1], int(local))
        shadowed = self._page_cache_rev.get(rev_key)
        if shadowed is not None:
            # another entry already maps this local frame; evict it rather
            # than leave it un-invalidatable when the frame is freed
            del self._page_cache[shadowed]
            self._page_cache_bytes -= self._page_cache_entry_bytes(shadowed)
            self.page_cache_stats["evictions"] += 1
        self._page_cache[key] = local
        self._page_cache_rev[rev_key] = key
        self._page_cache.move_to_end(key)
        while len(self._page_cache) > self.page_cache_cap or (
                self.page_cache_cap_bytes is not None
                and self._page_cache_bytes > self.page_cache_cap_bytes):
            old_key, old_local = self._page_cache.popitem(last=False)
            self._page_cache_rev.pop((old_key[1], old_local), None)
            self._page_cache_bytes -= self._page_cache_entry_bytes(old_key)
            self.page_cache_stats["evictions"] += 1

    def page_cache_invalidate_frames(self, dtype: str, frames) -> None:
        """Drop cache entries whose LOCAL frame is being returned to the
        pool (the fetching instance freed it) — a later alloc may reuse the
        frame index for unrelated data, so serving it would be silent
        corruption."""
        dt = _dtypes.name(dtype)
        for f in frames:
            key = self._page_cache_rev.pop((dt, int(f)), None)
            if key is not None:
                del self._page_cache[key]
                self._page_cache_bytes -= self._page_cache_entry_bytes(key)

    def page_cache_drop_owner_frames(self, owner: str, dtype: str,
                                     frames) -> None:
        """Drop cache entries keyed on the OWNER's frames — broadcast by the
        network when the owner frees them, since a reused owner frame would
        make the (owner, dtype, frame) key serve a different seed's data."""
        dt = _dtypes.name(dtype)
        for f in frames:
            key = (owner, dt, int(f))
            local = self._page_cache.pop(key, None)
            if local is not None:
                self._page_cache_rev.pop((dt, local), None)
                self._page_cache_bytes -= self._page_cache_entry_bytes(key)

    def clear_page_cache(self) -> None:
        self._page_cache.clear()
        self._page_cache_rev.clear()
        self._page_cache_bytes = 0

    def page_cache_drop_owner(self, owner: str) -> None:
        """Drop EVERY cache entry keyed on ``owner`` (any dtype, any
        frame) — the fleet-wide forget when a peer fail-stops.  Its frame
        namespace died with it, and a restarted incarnation reusing the
        same frame indices must never be served another seed's bytes."""
        for key in [k for k in self._page_cache if k[0] == owner]:
            local = self._page_cache.pop(key)
            self._page_cache_rev.pop((key[1], local), None)
            self._page_cache_bytes -= self._page_cache_entry_bytes(key)

    # -- failure ------------------------------------------------------------------

    def crash(self) -> None:
        """Fail-stop this node.  The machine's memory dies with it, and so
        must every piece of distributed state that references it:

        * hosted instances become husks (their pool pages are gone; they
          are NOT ``free()``d — free would broadcast invalidations and
          return frames as if the machine were still up) and each one's
          connection refcounts are released;
        * the seed registry empties: outstanding ForkHandles read
          ``alive == False`` and coordinators count the parent as lost;
        * ``network.unregister`` destroys the DC targets and — via
          ``ConnManager.drop_node`` — evicts every QP/DC context with a
          slot here from BOTH endpoints' pools, so peers re-pay setup;
        * every surviving peer drops its sibling page-cache entries keyed
          on this node (``page_cache_drop_owner``).

        Idempotent: a second crash of a dead node is a no-op."""
        if not self.alive:
            return
        self.alive = False
        net = self.network
        if net.sanitizer is not None:
            net.sanitizer.node_crashed(self.node_id)
        for inst in list(self.instances.values()):
            net.conn_release_user(inst._conn_user)
            if inst.prefetch_engine is not None:
                inst.prefetch_engine.discard()
                inst.prefetch_engine = None
            inst._owned_frames.clear()
            inst._tensors.clear()
            inst._tensor_versions.clear()
            inst.aspace = {}
        self.instances.clear()
        self.seeds.clear()
        self.clear_page_cache()
        self._swapped.clear()
        self._dc_pool.clear()
        net.unregister(self.node_id)
        for peer in net.nodes.values():
            drop = getattr(peer, "page_cache_drop_owner", None)
            if drop is not None:
                drop(self.node_id)

    def memory_bytes(self) -> int:
        return 0 if not self.alive else self.pool.bytes_allocated()


def make_auth_key() -> int:
    # sim-ok: unseeded-random -- auth keys are opaque capabilities compared
    # only for equality; they never reach the event log, meters or digests
    return secrets.randbits(62)
