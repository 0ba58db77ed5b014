"""PrefetchEngine — asynchronous demand-paging lookahead (rFaaS-style).

The fault handler's synchronous prefetch widens each blocking read; this
engine instead *issues* the policy's lookahead window as background
fetches that ride the (child, owner) channel while the function keeps
executing.  The sim's channel busy-time accounting (repro_torch.net) makes the
overlap honest: an async read occupies its channel without advancing the
clock, and the clock only waits (``Network.wait_until``) when execution
actually touches a page whose transfer has not completed yet.

One ``PrefetchEngine`` hangs off a ``ModelInstance`` when the child was
resumed with ``ForkPolicy(async_prefetch=N)``:

* ``issue(name, pages)``    — background-fetch missing pages (cache hits
  are adopted immediately; swapped/hop-0 pages are left to the sync
  fallback path; ``AccessRevoked`` aborts the issue, the sync path will
  degrade to the RPC daemon as usual).
* ``issue_ahead(name, faulted)`` — queue the next ``window`` missing
  pages beyond the highest page the current fault served.
* ``drain(name, pages)``    — adopt in-flight fetches: entries covering
  ``pages`` are waited for; unrelated entries land only if their
  transfer already completed.  ``pages=None`` waits for everything.

Pages in flight are excluded from both re-issue and the synchronous
fault path, so every page moves over the wire exactly once — async and
sync sweeps are byte-identical, only their clocks differ.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from repro_torch.net import AccessRevoked, TransportError


@dataclasses.dataclass
class _Pending:
    pages: np.ndarray        # VMA page indices covered by this transfer
    data: np.ndarray         # fetched page payload, (len(pages), page_elems)
    complete_at: float       # absolute sim time the transfer finishes
    owner: str               # node the pages were read from
    remote_frames: np.ndarray  # owner-pool frames (sibling-cache keys)
    dc_key: int              # the VMA's DC key at issue time (revalidated
                             # before republishing to the sibling cache)


class PrefetchEngine:
    """Issues and lands background page fetches for one ModelInstance."""

    def __init__(self, inst, window: int):
        if window < 1:
            raise ValueError(f"async prefetch window must be >= 1, got {window}")
        self.inst = inst
        self.window = window
        self._pending: Dict[str, List[_Pending]] = {}

    # -- introspection ------------------------------------------------------

    def pending_mask(self, name: str) -> np.ndarray:
        """Bool mask over the VMA's pages currently in flight."""
        vma = self.inst.aspace[name]
        mask = np.zeros(vma.npages, bool)
        for entry in self._pending.get(name, ()):
            mask[entry.pages] = True
        return mask

    def pending_count(self) -> int:
        return sum(len(e.pages) for lst in self._pending.values() for e in lst)

    # -- issue --------------------------------------------------------------

    def issue(self, name: str, pages) -> int:
        """Background-fetch the missing, not-already-pending subset of
        ``pages``.  Returns the number of pages put in flight."""
        inst = self.inst
        vma = inst.aspace[name]
        want = vma.request_mask(pages)
        want &= vma.missing_mask() & ~self.pending_mask(name)
        # hop-0 misses are swapped-out locals: inherently two-sided, leave
        # them to the synchronous fallback daemon
        want &= vma.owner_hop > 0
        plist = np.nonzero(want)[0]
        if plist.size == 0:
            return 0
        node = inst.node
        net = node.network
        issued = 0
        # _hop_groups serves sibling-cache hits inline (local copies, zero
        # wire cost) and yields only what must be read off-node
        for owner, key, sub, rframes in inst._hop_groups(vma, plist):
            try:
                data = net.read_pages(node.node_id, owner, vma.dtype,
                                      rframes, key,
                                      transport=vma.transport
                                      or inst.page_transport,
                                      async_read=True,
                                      user=inst._conn_user)
            except AccessRevoked:
                continue            # sync path will take the RPC fallback
            except TransportError:
                # owner unreachable (crash/flap/retries exhausted): leave
                # the pages missing — the sync fault path runs the full
                # recovery chain when they are actually touched
                continue
            self._pending.setdefault(name, []).append(_Pending(
                pages=sub.astype(np.int64),
                data=np.asarray(data),
                complete_at=net.channel_busy(node.node_id, owner),
                owner=owner,
                remote_frames=np.asarray(rframes),
                dc_key=key))
            issued += int(sub.size)
        inst.stats["prefetch_issued"] += issued
        return issued

    def issue_window(self, name: str) -> int:
        """Put up to the window's remaining budget of this VMA's missing
        pages in flight (lowest pages first) — the pipelined-ensure_all
        entry point; like issue_ahead it respects the TOTAL in-flight
        bound, never the whole VMA at once."""
        room = self.window - self.pending_count()
        if room <= 0:
            return 0
        vma = self.inst.aspace[name]
        ahead = np.nonzero(vma.missing_mask() & ~self.pending_mask(name))[0]
        return self.issue(name, ahead[:room])

    def issue_ahead(self, name: str, faulted) -> int:
        """Queue the next ``window`` missing pages beyond the highest page
        the current fault served — the policy's lookahead, off-clock."""
        vma = self.inst.aspace[name]
        faulted = np.atleast_1d(np.asarray(faulted, np.int64))
        if faulted.size == 0:
            return 0
        hi = int(faulted.max())
        # the window bounds TOTAL in-flight depth across VMAs, not
        # per-touch (or per-tensor) issuance
        room = self.window - self.pending_count()
        if room <= 0:
            return 0
        ahead = np.nonzero(vma.missing_mask() & ~self.pending_mask(name))[0]
        ahead = ahead[ahead > hi][:room]
        return self.issue(name, ahead)

    # -- land ---------------------------------------------------------------

    def drain(self, name: str, pages: Optional[np.ndarray] = None) -> int:
        """Adopt pending fetches for ``name``.  Entries overlapping
        ``pages`` are *needed now*: the clock waits for their completion.
        Other entries adopt free iff their transfer already finished.
        ``pages=None`` means everything is needed.  Returns pages landed."""
        lst = self._pending.get(name)
        if not lst:
            return 0
        inst = self.inst
        vma = inst.aspace[name]
        net = inst.node.network
        needed = None
        if pages is not None:
            # only still-missing requests force a wait: a COW-won page is
            # already resident, so its in-flight payload is just dropped
            needed = vma.request_mask(pages) & vma.missing_mask()
        keep, landed = [], 0
        for entry in lst:
            # a page may have been COW-written while in flight: the local
            # copy wins, and a fully-stale payload is dropped WITHOUT
            # blocking the clock — nobody needs its bytes
            still = vma.missing_mask()[entry.pages]
            if not still.any():
                inst.stats["prefetch_wasted"] += len(entry.pages)
                continue
            want_now = needed is None or bool(needed[entry.pages].any())
            if want_now:
                net.wait_until(entry.complete_at)
            elif entry.complete_at > net.sim_time:
                keep.append(entry)
                continue
            # full landings (the common case) adopt the payload buffer as
            # is — the fancy-index copy only happens when a COW raced a
            # page out of the entry
            payload = entry.data if still.all() else entry.data[still]
            local = inst._adopt_pages(vma, entry.pages[still], payload)
            # publish to the sibling cache like the sync path — but only
            # if the owner's DC target is still live.  A free/reclaim
            # between issue and drain broadcasts a cache drop; putting
            # the entry back AFTER that broadcast would let a reused
            # owner frame serve another seed's bytes.
            if net.target_valid(entry.owner, entry.dc_key):
                inst.node.page_cache_put_many(entry.owner, vma.dtype,
                                              entry.remote_frames[still],
                                              local)
            n = int(still.sum())
            landed += n
            inst.stats["prefetch_used"] += n
            inst.stats["pages_rdma"] += n       # served by the page transport
            inst.stats["prefetch_wasted"] += int((~still).sum())
        if keep:
            self._pending[name] = keep
        else:
            self._pending.pop(name, None)
        return landed

    def drain_all(self) -> int:
        return sum(self.drain(name) for name in list(self._pending))

    def discard(self) -> None:
        """Forget in-flight transfers (instance teardown)."""
        for lst in self._pending.values():
            self.inst.stats["prefetch_wasted"] += sum(
                len(e.pages) for e in lst)
        self._pending.clear()


def issue_fan_in(children) -> int:
    """Put every child's missing working set in flight as K *concurrent*
    children would: round-robin across the children, each child's
    per-owner VMA groups rotated by its index.

    The link clock (``NetModel.node_links``) reserves lanes FCFS in issue
    order, so child-major sequential issuing — child 0's entire set, then
    child 1's — would stamp one child's reads onto every parent link
    before the next child exists, serializing the whole fleet even when S
    replicas could serve in parallel.  Interleaving the issue order is
    what a real concurrent fan-out looks like to the fabric; the benchmark
    and property-test fan-ins both drive it through here.  Children must
    have a PrefetchEngine attached.  Returns total pages issued."""
    plans = []
    for i, child in enumerate(children):
        by_owner: Dict[str, list] = {}
        for name in child.leaf_names:
            vma = child.aspace[name]
            owner = vma.ancestry[0] if vma.ancestry else child.ancestry[0]
            by_owner.setdefault(owner, []).append(name)
        owners = sorted(by_owner)
        r = i % len(owners)
        plans.append((child, [by_owner[o] for o in owners[r:] + owners[:r]]))
    issued = 0
    for rnd in range(max((len(g) for _, g in plans), default=0)):
        for child, groups in plans:
            if rnd < len(groups):
                for name in groups[rnd]:
                    issued += child.prefetch_engine.issue(
                        name, np.arange(child.aspace[name].npages))
    return issued
