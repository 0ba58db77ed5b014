"""ShardedSeed — one logical seed backed by S parent replicas.

MITOSIS forks 10k containers in a second only because no single machine
sits on the data path; a seed prepared on ONE parent still funnels every
child's first-touch reads through that parent's NIC.  A ``ShardedSeed``
wraps S :class:`~repro_torch.fork.ForkHandle` replicas (each a fully
materialized copy of the seed, created over the ordinary fork path) and
routes every child's VMAs *across* the replica set per its placement
policy — fan-out read bandwidth scales with S instead of one NIC.

The sharded resume fetches one KB-sized descriptor per live replica (each
parent's own frame table), plans routes over the live set, assembles the
child address space VMA-by-VMA from the routed replica's page table, and
hands off to the same ``instantiate_child`` tail as a single-parent
resume.  A replica that died between planning and fetch is dropped and its
VMAs re-routed over the survivors (``lost_parents`` records the victims
for the coordinator's lease telemetry); the coordinator re-replicates back
to ``target_replicas`` during ``gc()``.

The handle-compatible surface (``parent_node``, ``lease_deadline``,
``expired`` / ``alive`` / ``remaining``, ``renew`` / ``revoke`` /
``reclaim``, ``resume_on``) lets the coordinator's seed store hold plain
handles and sharded seeds interchangeably.
"""
from __future__ import annotations

import math
from collections import Counter
from typing import List, Optional, Sequence

import numpy as np

from repro_torch import _dtypes
from repro_torch.core.pagetable import VMA
from repro_torch.fork.handle import ForkHandle, instantiate_child
from repro_torch.fork.policy import ForkPolicy
from repro_torch.fork.tree import build_fork_tree
from repro_torch.net import (AccessRevoked, LeaseExpired, SeedUnavailable,
                             TransportError)
from repro_torch.placement.policy import PlacementPolicy, SpreadPolicy
from repro_torch.placement.route import ReplicaSource, Router


class ShardedSeed:
    """S fork-handle replicas behind one logical seed record."""

    def __init__(self, handles: Sequence[ForkHandle],
                 placement: Optional[PlacementPolicy] = None,
                 target_replicas: Optional[int] = None):
        if not handles:
            raise ValueError("a ShardedSeed needs at least one replica handle")
        self.handles: List[ForkHandle] = list(handles)
        self.placement = placement or SpreadPolicy()
        self.target_replicas = target_replicas or len(self.handles)
        # per-parent VMA routes served (fan-out balance introspection)
        self.serve_counts: Counter = Counter()
        # parents purged because they left the network (drained into the
        # coordinator's per-function lease telemetry as "parent_lost")
        self.lost_parents: List[str] = []
        self._rotation = 0

    # -- introspection -------------------------------------------------------

    @property
    def replicas(self) -> int:
        return len(self.handles)

    @property
    def parent_nodes(self) -> List[str]:
        return [h.parent_node for h in self.handles]

    def __repr__(self) -> str:
        return (f"ShardedSeed(replicas={self.replicas}/{self.target_replicas},"
                f" parents={self.parent_nodes})")

    # -- handle-compatible surface ------------------------------------------

    @property
    def parent_node(self) -> str:
        return self.handles[0].parent_node

    @property
    def handler_id(self) -> int:
        return self.handles[0].handler_id

    @property
    def lease_deadline(self) -> float:
        return min((h.lease_deadline for h in self.handles), default=math.inf)

    def remaining(self, now: Optional[float] = None) -> float:
        # a fully purged seed has nothing left to serve: report it expired
        return max((h.remaining(now) for h in self.handles),
                   default=-math.inf)

    @property
    def expired(self) -> bool:
        return all(h.expired for h in self.handles)

    @property
    def alive(self) -> bool:
        return any(h.alive for h in self.handles)

    def renew(self, extend: Optional[float] = None) -> "ShardedSeed":
        for h in self.handles:
            if h.alive:
                h.renew(extend)
        return self

    def revoke(self) -> "ShardedSeed":
        """Bump every replica's generation; this seed keeps serving through
        the refreshed handles."""
        self.handles = [h.revoke() if h.alive else h for h in self.handles]
        return self

    def reclaim(self, free_instance: bool = False) -> None:
        for h in self.handles:
            h.reclaim(free_instance=free_instance)

    def __enter__(self) -> "ShardedSeed":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.reclaim()

    # -- membership ----------------------------------------------------------

    def purge_lost(self, live_nodes) -> List[str]:
        """Drop replicas whose parent left the network; returns the lost
        parent ids (also appended to ``lost_parents`` for telemetry)."""
        lost = [h.parent_node for h in self.handles
                if h.parent_node not in live_nodes]
        if lost:
            self.handles = [h for h in self.handles
                            if h.parent_node in live_nodes]
            self.lost_parents.extend(lost)
        return lost

    def drain_lost(self) -> List[str]:
        lost, self.lost_parents = self.lost_parents, []
        return lost

    def add_replica(self, handle: ForkHandle) -> None:
        self.handles.append(handle)

    def live_handles(self) -> List[ForkHandle]:
        """Replicas that can still serve a fork right now."""
        return [h for h in self.handles if h.alive and not h.expired]

    # -- the sharded resume --------------------------------------------------

    def _live_descriptors(self, child_node, policy: ForkPolicy):
        """(handle, descriptor) per usable replica.  A parent that left the
        network is purged (and telemetered); one that refuses the fork
        (revoked/expired/reclaimed underneath us) is skipped for this
        resume but kept for the coordinator to sort out."""
        net = child_node.network
        pairs = []
        for h in list(self.handles):
            if h.parent_node not in net.nodes:
                self.handles.remove(h)
                self.lost_parents.append(h.parent_node)
                continue
            try:
                pairs.append((h, h.fetch_descriptor(child_node, policy)))
            except (TransportError, AccessRevoked, LeaseExpired,
                    PermissionError):
                continue
        return pairs

    def resume_on(self, child_node,
                  policy: Optional[ForkPolicy] = None) -> "object":
        """Fork a child whose VMAs page in from across the replica set.

        Each usable replica contributes its own descriptor (its frames, DC
        keys and prepared keys); the placement policy assigns every VMA an
        owner replica + transport, and the child's page tables are built
        from the routed replica's tables — so first-touch reads fan out
        over S parent NICs instead of one.
        """
        policy = ForkPolicy.coerce(policy)
        pairs = self._live_descriptors(child_node, policy)
        if not pairs:
            raise SeedUnavailable(
                f"sharded seed {self.parent_nodes or '[]'}: no live replicas")
        primary, desc = pairs[self._rotation % len(pairs)]
        by_parent = {h.parent_node: (h, d) for h, d in pairs}
        plan = self.placement.plan_for(desc, list(by_parent),
                                       offset=self._rotation)
        self._rotation += 1

        tables = {h.parent_node: {v["name"]: v for v in d.vmas}
                  for h, d in pairs}
        aspace = {}
        for vd in desc.vmas:
            route = plan[vd["name"]]
            owner, d = route.owner, by_parent[route.owner][1]
            vma = VMA.from_table_dict(tables[owner][vd["name"]])
            vma = vma.child_view(d.extra["prepared_keys"][vd["name"]],
                                 parent_node=owner,
                                 default_ancestry=d.ancestry)
            vma.transport = route.transport or vma.transport
            aspace[vma.name] = vma
            self.serve_counts[owner] += 1
        ancestry = [primary.parent_node] + list(desc.ancestry)
        inst = instantiate_child(child_node, policy, desc, aspace, ancestry)
        if policy.reroute_backlog is not None and len(pairs) > 1:
            # every replica's descriptor is already in hand: keep the
            # alternate frame tables + keys so the child's fault handler can
            # divert hop-1 reads off a hot (or lost) parent link
            inst.router = Router(child_node.network, plan,
                                 self._route_sources(pairs),
                                 threshold=policy.reroute_backlog,
                                 src=child_node.node_id)
        return inst

    @staticmethod
    def _route_sources(pairs):
        """vma name -> {replica parent -> ReplicaSource}: each replica's
        own frame table, prepared DC key and payload size for every VMA —
        the Router's re-route alternatives."""
        sources = {}
        for h, d in pairs:
            prepared = d.extra["prepared_keys"]
            for vd in d.vmas:
                nbytes = (int(np.prod(vd["shape"]))
                          * _dtypes.itemsize(vd["dtype"]))
                sources.setdefault(vd["name"], {})[h.parent_node] = \
                    ReplicaSource(
                        frames=np.frombuffer(vd["frames"], np.int32),
                        dc_key=prepared[vd["name"]], nbytes=nbytes)
        return sources

    def fan_out(self, nodes: Sequence, policy: Optional[ForkPolicy] = None,
                tree_degree: Optional[int] = None,
                child_lease: Optional[float] = None):
        """Fork one child per target node.

        ``tree_degree=None`` (default) keeps the flat fan-out: every child
        resumes straight off the replica set, each with its own rotated
        route plan.  With ``tree_degree=k`` the fan-out grows a §6.3 fork
        tree *under the seed's placement policy*: the sharded seed itself
        serves the first ``k × replicas`` children (its NIC budget is S
        parent links, not one), and when that frontier is exhausted the
        next short-lived re-seed is promoted from the child on the
        least-loaded side of the cluster — smallest live link backlog
        (``Network.link_backlog``), then smallest NIC-time ledger — instead
        of by raw descriptor-count order.  Returns a
        :class:`~repro_torch.fork.tree.ForkTree` (flat mode returns the plain
        child list)."""
        if tree_degree is None:
            return [self.resume_on(n, policy) for n in nodes]

        def promote_least_loaded(promotable):
            # placement-aware promotion: re-seed on the least-loaded
            # replica's side of the cluster — smallest live link backlog,
            # then smallest NIC-time ledger, then BFS order
            net = promotable[0][0].node.network
            return min(range(len(promotable)), key=lambda j: (
                net.link_backlog(promotable[j][0].node.node_id),
                net.node_busy(promotable[j][0].node.node_id), j))

        return build_fork_tree(
            self, nodes, policy=policy, tree_degree=tree_degree,
            child_lease=child_lease,
            root_quota=tree_degree * max(1, len(self.live_handles())),
            promote=promote_least_loaded)
