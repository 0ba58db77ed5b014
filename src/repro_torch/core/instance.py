"""ModelInstance — the "container" of the MITOSIS port.

An instance's state (weights / KV pages / optimizer state) lives in its
node's PagePool behind per-tensor VMAs.  Children created by fork hold page
tables pointing at ancestor frames; the *fault handler* (`fetch_pages`)
materializes pages on demand over one-sided reads, with prefetch, sibling
page caching (MITOSIS+cache) and RPC fallback; writes are copy-on-write.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch import _dtypes
from repro_torch.core import descriptor as desc_mod
from repro_torch.core.pagetable import VMA, AddressSpace
from repro_torch.core.prefetch import PrefetchEngine
from repro_torch.kernels.cow_scatter import ops as cow_ops
from repro_torch.memory import paging
from repro_torch.net import AccessRevoked, RecoveryFailed, TransportError


class ModelInstance:
    def __init__(self, node, arch: str, kind: str, aspace: AddressSpace,
                 leaf_paths: List[List[Any]], leaf_names: List[str],
                 ancestry: List[str], registers: Dict[str, Any]):
        self.node = node
        self.arch = arch
        self.kind = kind
        self.aspace = aspace
        self.leaf_paths = leaf_paths
        self.leaf_names = leaf_names
        self.ancestry = ancestry            # hop h -> ancestry[h-1]
        self.registers = registers
        self._tensors: Dict[str, torch.Tensor] = {}
        # VMA.version at which each cached tensor was assembled: assembly
        # re-runs only on actual residency/content change, not on every
        # cache invalidation
        self._tensor_versions: Dict[str, int] = {}
        self._owned_frames: Dict[str, list] = {}
        self.instance_id = node.new_instance_id()
        # connection-pool identity: reads take a refcount on their
        # (src, dst) connection under this name, so siblings landed on
        # one node share a warm slot and free() releases exactly ours
        self._conn_user = f"{node.node_id}/{self.instance_id}"
        # page-fetch transport name (repro_torch.net registry); None = the
        # network's default backend.  Set from ForkPolicy.page_fetch; a
        # routed VMA's own `VMA.transport` takes precedence per VMA.
        self.page_transport: Optional[str] = None
        # ForkPolicy.prefetch: pages pulled per fault when the caller
        # doesn't pass an explicit prefetch
        self.default_prefetch = 0
        # ForkPolicy.async_prefetch: background lookahead engine (None = off)
        self.prefetch_engine: Optional[PrefetchEngine] = None
        # repro_torch.placement.Router: dynamic hot-spot re-routing, attached by
        # the sharded resume when ForkPolicy.reroute_backlog is set (None =
        # static routes).  Consulted by _hop_groups before hop-1 reads.
        self.router = None
        # coordinator recovery hook: called as hook(inst, vma, lost_owner)
        # when a remote read fails past transport retries AND the Router
        # (if any) could not move the plan to a live sibling.  Returns
        # True after re-stamping the VMA's missing pages from a fresh
        # (possibly re-replicated) seed so the fetch can be retried.
        self.recover_owner = None
        # True once this instance's frame table traveled in a descriptor
        # (prepare_fork): only then can other nodes hold cache entries
        # keyed on our frames, so only then must free() broadcast
        self.frames_published = False
        # stats keys are historical: "pages_rdma" counts pages served by the
        # (possibly two-sided) page transport, "pages_rpc" the fallback daemon
        self.stats = {"faults": 0, "pages_rdma": 0, "pages_rpc": 0,
                      "pages_cached": 0, "pages_local": 0, "cow_pages": 0,
                      "prefetch_issued": 0, "prefetch_used": 0,
                      "prefetch_wasted": 0,
                      "assemble_full": 0, "assemble_patch_pages": 0}
        node.instances[self.instance_id] = self

    # ------------------------------------------------------------------
    # construction from a concrete pytree (the "running container")
    # ------------------------------------------------------------------

    @classmethod
    def create(cls, node, arch: str, pytree, kind: str = "weights",
               registers: Optional[dict] = None):
        names, paths, leaves = desc_mod.flatten_with_names(pytree)
        inst = cls(node, arch, kind, {}, paths, names, [], registers or {"step": 0})
        for name, leaf in zip(names, leaves):
            # host (numpy) leaves stay host-side: packing is memory layout,
            # and ensure_tensor materializes on demand
            if not isinstance(leaf, (np.ndarray, torch.Tensor)):
                leaf = torch.as_tensor(leaf)
            dt = _dtypes.name(leaf.dtype)
            pages = paging.to_pages(leaf, node.pool.page_elems)
            frames = node.pool.alloc(dt, pages.shape[0])
            node.pool.write_pages(dt, frames, pages)
            inst._owned_frames.setdefault(dt, []).extend(frames.tolist())
            inst.aspace[name] = VMA.new_local(name, tuple(leaf.shape), dt,
                                              frames)
            inst._tensors[name] = leaf
            inst._tensor_versions[name] = inst.aspace[name].version
        return inst

    # ------------------------------------------------------------------
    # the fault handler (§5.4 Table 2)
    # ------------------------------------------------------------------

    def fetch_pages(self, name: str, pages: np.ndarray,
                    prefetch: Optional[int] = None) -> None:
        """Materialize the given (missing) pages of a VMA, plus `prefetch`
        adjacent pages per fault — the RDMA-aware page-fault handler.
        ``prefetch=None`` falls back to the policy's ``default_prefetch``.

        The whole fault is vectorized: page selection and the prefetch
        window are numpy mask ops (``VMA.want_mask``), cache probes are one
        batched call, and each by-hop group goes to the transport as ONE
        gather whose contiguous frame runs ride a doorbell-batched op.
        With an async engine attached, in-flight lookahead is landed first
        and a fresh window is issued behind the fault."""
        if prefetch is None:
            prefetch = self.default_prefetch
        vma = self.aspace[name]
        pages = np.atleast_1d(np.asarray(pages))
        engine = self.prefetch_engine
        if engine is not None:
            engine.drain(name, pages)   # land lookahead; wait only if needed
        want_mask = vma.want_mask(pages, prefetch)
        if engine is not None:
            want_mask &= ~engine.pending_mask(name)   # in flight: never refetch
        want = np.nonzero(want_mask)[0]
        if want.size == 0:
            if engine is not None:
                # readahead cursor: keep the window full past the touch
                # point even when the touch itself was served from flight
                engine.issue_ahead(name, pages)
            return
        self.stats["faults"] += 1
        self._fetch_now(vma, want)
        if engine is not None:
            engine.issue_ahead(name, want)

    def _hop_groups(self, vma: VMA, want: np.ndarray):
        """Group ``want`` pages by owner hop and serve sibling-cache hits;
        yields (owner, dc_key, pages, remote_frames) for what is left to
        read off-node.  Hop-0 entries (swapped-out locals) are served via
        the fallback daemon here.  Shared by the synchronous fault path
        and the async PrefetchEngine so probe/adopt semantics can't drift.

        Owners resolve per VMA: a routed VMA (sharded seed / placement
        plan) carries its own ancestry chain; unrouted VMAs fall back to
        the instance-level chain."""
        hops = vma.owner_hop[want]
        for hop in np.unique(hops):
            plist = want[hops == hop]
            if hop == 0:
                # local frames that lost PRESENT (swapped out): fallback path
                self._fallback_fetch(vma, self.node.node_id, plist)
                continue
            if hop == 1 and self.router is not None:
                # hot-spot (or lost-owner) re-routing: the Router may move
                # this VMA's plan to a cooler sibling replica and re-stamp
                # its frames/key/ancestry before we resolve the owner
                self.router.sync(vma)
            owner = vma.owner_at(int(hop), self.ancestry)
            key = vma.dc_keys.get(int(hop), -1)
            remote_frames = vma.frames[plist]

            # sibling page cache (MITOSIS+cache): hits are COPIED into frames
            # this instance owns — sharing the fetcher's frames would leave
            # our page table dangling once the fetcher frees them
            cached = self.node.page_cache_get_many(owner, vma.dtype,
                                                   remote_frames)
            hit = cached >= 0
            if hit.any():
                data = self.node.pool.read_pages_host(vma.dtype, cached[hit])
                self._adopt_pages(vma, plist[hit], data)
                self.stats["pages_cached"] += int(hit.sum())

            plist, remote_frames = plist[~hit], remote_frames[~hit]
            if plist.size:
                yield owner, key, plist, remote_frames

    def _fetch_now(self, vma: VMA, want: np.ndarray) -> None:
        """Synchronously materialize ``want`` (missing) pages, grouped by
        owner hop, with batched cache probes and run-coalesced reads."""
        for owner, key, plist, remote_frames in self._hop_groups(vma, want):
            self._read_group(vma, owner, key, plist, remote_frames)

    def _read_group(self, vma: VMA, owner: str, key: int, plist,
                    remote_frames, depth: int = 0) -> None:
        """One grouped remote read, with the §6.2-style failure ladder:
        revoked access degrades to the owner's RPC daemon; a transport
        failure (owner crashed, NIC flapped, retries exhausted) enters the
        recovery chain (sibling replica -> coordinator re-seed -> typed
        :class:`RecoveryFailed` that callers degrade to a coldstart)."""
        net = self.node.network
        try:
            data = net.read_pages(
                self.node.node_id, owner, vma.dtype, remote_frames, key,
                transport=vma.transport or self.page_transport,
                user=self._conn_user)
            self.stats["pages_rdma"] += int(plist.size)
        except AccessRevoked:
            # VA->PA changed at the owner (swap, reclaim): RPC fallback —
            # which itself rides the fabric, so its failure recovers too
            try:
                self._fallback_fetch(vma, owner, plist)
            except TransportError as err:
                self._recover_group(vma, owner, plist, err, depth)
            return
        except TransportError as err:
            self._recover_group(vma, owner, plist, err, depth)
            return
        local = self._adopt_pages(vma, plist, data)
        self.node.page_cache_put_many(owner, vma.dtype, remote_frames,
                                      local)

    def _recover_group(self, vma: VMA, owner: str, plist, err: Exception,
                       depth: int) -> None:
        """Recover ``plist`` after ``owner`` became unreachable.  Each rung
        re-resolves owners and re-reads only the still-missing subset, so a
        half-materialized retry adopts every page at most once (no
        double-charged pagetable, no COW corruption — dirty pages are
        resident and never re-stamped)."""
        net = self.node.network
        if depth >= 2:
            raise RecoveryFailed(
                f"recovery exhausted for {int(np.size(plist))} page(s) of "
                f"{vma.name} owned by {owner}") from err
        if owner not in net.nodes:
            # fail-stop owner: its frame namespace is gone — local cache
            # entries keyed on it must never serve a future probe
            self.node.page_cache_drop_owner(owner)
        if depth == 0 and self.router is not None:
            before = vma.ancestry[0] if vma.ancestry else None
            self.router.sync(vma)
            now = vma.ancestry[0] if vma.ancestry else None
            if now is not None and now != before and now != owner:
                # rung 1: the Router re-stamped the plan onto a live
                # sibling replica (lost-owner re-route from PR 5)
                net.meter["recovery.sibling"] += 1
                self._refetch(vma, plist, depth + 1)
                return
        hook = self.recover_owner
        if hook is not None and hook(self, vma, owner):
            # rung 2: the coordinator re-stamped us from a fresh (possibly
            # just re-replicated) seed
            net.meter["recovery.reseed"] += 1
            self._refetch(vma, plist, depth + 1)
            return
        raise RecoveryFailed(
            f"no recovery path for {int(np.size(plist))} page(s) of "
            f"{vma.name} owned by {owner}") from err

    def _refetch(self, vma: VMA, plist, depth: int) -> None:
        """Re-issue the still-missing subset of a failed group through the
        normal grouped path (owners/keys re-resolved from the re-stamped
        page table); the recovered bytes are metered separately."""
        plist = np.atleast_1d(np.asarray(plist))
        still = plist[vma.missing_mask()[plist]]
        if still.size == 0:
            return
        net = self.node.network
        net.meter["recovery.pages"] += int(still.size)
        net.meter["recovery.bytes"] += (int(still.size)
                                        * self.node.pool.page_elems
                                        * _dtypes.itemsize(vma.dtype))
        for owner, key, sub, rframes in self._hop_groups(vma, still):
            self._read_group(vma, owner, key, sub, rframes, depth)

    def _fallback_fetch(self, vma: VMA, owner: str, plist) -> None:
        # the fallback daemon is inherently two-sided: always the rpc backend
        net = self.node.network
        target = net.require_node(owner)    # typed NodeDown if it crashed
        frames = vma.frames[plist]
        data = net.rpc(self.node.node_id, owner,
                       len(frames) * self.node.pool.page_elems
                       * _dtypes.itemsize(vma.dtype),
                       target.fallback_serve, vma.dtype, frames,
                       transport="rpc")
        net.meter["page_pages_moved"] += len(frames)
        self._adopt_pages(vma, plist, data)
        self.stats["pages_rpc"] += len(frames)

    # ------------------------------------------------------------------
    # tensor-level API
    # ------------------------------------------------------------------

    def touch_pages(self, name: str, pages,
                    prefetch: Optional[int] = None) -> None:
        self.fetch_pages(name, np.asarray(pages), prefetch)

    def ensure_tensor(self, name: str,
                      prefetch: Optional[int] = None) -> torch.Tensor:
        vma = self.aspace[name]
        t = self._tensors.get(name)
        v0 = self._tensor_versions.get(name)
        if t is not None and v0 == vma.version:
            # the version gate: residency/content unchanged since assembly
            # (e.g. only disjoint VMAs faulted) — skip the full-pool gather
            return t
        if self.prefetch_engine is not None:
            self.prefetch_engine.drain(name)    # full assembly needs them all
        miss = vma.missing_pages()
        if miss.size:
            self.fetch_pages(name, miss, prefetch)
        pool = self.node.pool
        changed = vma.changed_since(v0) if (t is not None and
                                            v0 is not None) else None
        if changed is not None and changed.size * 2 <= vma.npages:
            # incremental reassembly: a version bump stamps exactly the
            # pages that moved (VMA.page_version), so patch those into the
            # cached tensor instead of re-gathering the whole VMA
            rows = pool.read_pages(vma.dtype, vma.frames[changed])
            t = cow_ops.scatter_patch(t, changed, rows,
                                      page_elems=pool.page_elems)
            self.stats["assemble_patch_pages"] += int(changed.size)
        else:
            # fused gather->reassemble: pages land directly in the
            # destination layout, no intermediate page-list concatenate
            t = pool.assemble(vma.dtype, vma.frames, vma.shape)
            self.stats["assemble_full"] += 1
        self._tensors[name] = t
        self._tensor_versions[name] = vma.version
        return t

    def ensure_all(self, prefetch: Optional[int] = None) -> None:
        """Materialize every tensor.  With an async engine attached this
        pipelines: while tensor i assembles, tensor i+1's pages are already
        in flight on the channel (the §6.2-style overlap of descriptor/page
        pulls with execution)."""
        engine = self.prefetch_engine
        if engine is None:
            for name in self.leaf_names:
                self.ensure_tensor(name, prefetch)
            return
        names = list(self.leaf_names)
        if names:
            engine.issue_window(names[0])
        for i, name in enumerate(names):
            if i + 1 < len(names):
                engine.issue_window(names[i + 1])
            self.ensure_tensor(name, prefetch)

    def materialize_pytree(self):
        self.ensure_all()       # pipelined when an async engine is attached
        leaves = [self.ensure_tensor(n) for n in self.leaf_names]
        return desc_mod.unflatten_from_paths(self.leaf_paths, leaves)

    def _adopt_pages(self, vma: VMA, pages, data) -> np.ndarray:
        """Copy ``data`` into freshly allocated local frames this instance
        OWNS (recorded for free-time invalidation) and mark ``pages``
        resident there.  The single ownership-bookkeeping site for every
        materialization path (transport fetch, cache hit, fallback, COW)."""
        san = self.node.network.sanitizer
        if san is not None:
            san.adopt_payload(
                data, rows=len(pages),
                row_bytes=self.node.pool.page_elems
                * _dtypes.itemsize(vma.dtype),
                op=f"adopt {vma.name}@{self.node.node_id}")
        local = self.node.pool.alloc(vma.dtype, len(pages))
        self.node.pool.write_pages(vma.dtype, local, data)
        self._owned_frames.setdefault(vma.dtype, []).extend(local.tolist())
        vma.mark_resident(pages, local)
        return local

    def write_pages(self, name: str, pages, data) -> None:
        """COW write: dirty pages land in freshly allocated local frames;
        ancestor frames are never touched."""
        vma = self.aspace[name]
        pages = np.atleast_1d(np.asarray(pages))
        self._adopt_pages(vma, pages, data)
        vma.mark_dirty(pages)
        self.stats["cow_pages"] += len(pages)

    def add_tensor(self, name: str, arr) -> None:
        """Pre-materialize new state into the instance (workflow globals,
        KV pages): creates a fresh local VMA — what downstream forks read."""
        arr = torch.as_tensor(arr)
        dt = _dtypes.name(arr.dtype)
        pages = paging.to_pages(arr, self.node.pool.page_elems)
        frames = self.node.pool.alloc(dt, pages.shape[0])
        self.node.pool.write_pages(dt, frames, pages)
        self._owned_frames.setdefault(dt, []).extend(frames.tolist())
        self.aspace[name] = VMA.new_local(name, tuple(arr.shape), dt, frames)
        if name not in self.leaf_names:
            self.leaf_names.append(name)
            self.leaf_paths.append([name])
        self._tensors[name] = arr
        self._tensor_versions[name] = self.aspace[name].version

    def write_tensor(self, name: str, arr) -> None:
        arr = torch.as_tensor(arr)
        vma = self.aspace[name]
        assert tuple(arr.shape) == vma.shape, (arr.shape, vma.shape)
        pages = paging.to_pages(arr, self.node.pool.page_elems)
        self.write_pages(name, np.arange(vma.npages), pages)
        self._tensors[name] = arr
        self._tensor_versions[name] = vma.version

    # ------------------------------------------------------------------
    # accounting / lifecycle
    # ------------------------------------------------------------------

    def total_bytes(self) -> int:
        return sum(v.nbytes() for v in self.aspace.values())

    def resident_bytes(self) -> int:
        pe = self.node.pool.page_elems
        tot = 0
        for v in self.aspace.values():
            tot += int(v.resident_mask().sum()) * pe * _dtypes.itemsize(v.dtype)
        return tot

    def resident_fraction(self) -> float:
        npages = sum(v.npages for v in self.aspace.values())
        res = sum(int(v.resident_mask().sum()) for v in self.aspace.values())
        return res / max(npages, 1)

    def free(self) -> None:
        if self.prefetch_engine is not None:
            self.prefetch_engine.discard()
            self.prefetch_engine = None
        for dt, frames in self._owned_frames.items():
            self.node.page_cache_invalidate_frames(dt, frames)
            if self.frames_published:
                self.node.network.drop_cached_frames(self.node.node_id, dt,
                                                     frames)
            self.node.pool.free(dt, frames)
        self._owned_frames.clear()
        self._tensors.clear()
        self._tensor_versions.clear()
        self.aspace = {}
        # drop our connection refcounts: shared slots stay warm for
        # surviving siblings but become LRU-evictable once unreferenced
        self.node.network.conn_release_user(self._conn_user)
        self.node.instances.pop(self.instance_id, None)
