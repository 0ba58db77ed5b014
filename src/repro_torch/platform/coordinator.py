"""Fork-aware serverless coordinator (§6): seed store, long/short-lived seed
management, fork trees, timeout GC, and startup-policy dispatch.

"Functions" are model instances + a behavior callable; the coordinator
schedules them onto invoker nodes, accelerating startup via long-lived seeds
and state transfer via short-lived seeds, exactly mirroring the paper's Fn
integration.

The seed store holds leased ``ForkHandle`` capabilities (repro_torch.fork) — or,
for sharded seeds, a ``ShardedSeed`` (repro_torch.placement) wrapping S replica
handles behind one logical record: lease freshness, renewal and reclamation
all go through the handle surface instead of the old raw (handler_id,
auth_key) SeedRecord tuples.  Node selection is a pluggable scheduler
(transport- and load-aware by default, exclusion-stable round-robin
fallback); a seed replica whose parent drops out of the network is purged
on sight and telemetered as ``parent_lost``, and ``gc()`` re-replicates
sharded seeds back to their target replica count.
"""
from __future__ import annotations

import dataclasses
import time
from collections import Counter
from typing import Any, Callable, Dict, List, Optional, Union

from repro_torch.core.instance import ModelInstance
from repro_torch.core.pagetable import VMA
from repro_torch.fork import ForkHandle, ForkPolicy
from repro_torch.net import NoNodesAvailable, TransportError
from repro_torch.placement import (PlacementPolicy, ShardedSeed,
                                   TransportAwareScheduler, route_demand)
from repro_torch.platform.node import NodeRuntime

DEFAULT_SEED_KEEPALIVE = 600.0      # §6.2: 10 min vs caching's 1 min
DEFAULT_CACHE_KEEPALIVE = 30.0      # Fn caches coldstarted containers 30 s
MAX_FUNCTION_LIFETIME = 900.0       # §6.3: AWS-style 15 min upper bound


@dataclasses.dataclass
class FunctionDef:
    name: str
    arch: str
    make_params: Callable[[], Any]          # builds the pristine state
    behavior: Callable[[ModelInstance, dict], dict]
    exec_sim_time: float = 0.0              # modeled pure-exec seconds


@dataclasses.dataclass
class ForkTreeNode:
    func: str
    node_id: str
    handle: Optional[ForkHandle]
    children: List["ForkTreeNode"] = dataclasses.field(default_factory=list)


Seed = Union[ForkHandle, ShardedSeed]


def _seed_handles(seed: Seed) -> List[ForkHandle]:
    """The replica handles behind a seed-store entry (one for a plain
    handle) — the seam that lets every lifecycle pass treat sharded and
    unsharded seeds uniformly."""
    return list(seed.handles) if isinstance(seed, ShardedSeed) else [seed]


class Coordinator:
    def __init__(self, network, nodes: List[NodeRuntime],
                 clock=time.monotonic,  # sim-ok: wall-clock -- host default; replays pass SimClock

                 scheduler=None, seed_replicas: int = 1,
                 seed_placement: Optional[PlacementPolicy] = None,
                 reroute_backlog: Optional[float] = None,
                 cache_keepalive: float = DEFAULT_CACHE_KEEPALIVE,
                 auto_seed: bool = True):
        self.network = network
        self.nodes = {n.node_id: n for n in nodes}
        self.clock = clock
        # how long a released container stays warm before gc() frees it —
        # the keep-warm TTL knob autoscaler policies (repro_torch.sim) tune
        self.cache_keepalive = cache_keepalive
        # §6.2 registers the first coldstart container platform-wide as the
        # function's seed; pure-caching baselines turn that off so a
        # no-MITOSIS control run holds no seed state at all
        self.auto_seed = auto_seed
        self.functions: Dict[str, FunctionDef] = {}
        self.seed_store: Dict[str, Seed] = {}          # func -> seed record
        self.fork_trees: Dict[str, ForkTreeNode] = {}
        self.cached: Dict[str, List[tuple]] = {}       # func -> [(inst, ts)]
        # per-function lease churn (renewals/expiries/revocations/losses)
        # for fig20-style spike replays; surfaced by gc()
        self.lease_telemetry: Dict[str, Counter] = {}
        # node selection is pluggable; the default scores candidates by
        # per-backend setup cost + channel backlog and degrades to a
        # deterministic, exclusion-stable round-robin without context
        self.scheduler = scheduler or TransportAwareScheduler(network)
        # replication defaults applied by the coldstart auto-seed path
        self.seed_replicas = seed_replicas
        self.seed_placement = seed_placement
        # seconds of planned-owner link backlog above which sharded forks
        # re-route VMAs to a cooler replica (ForkPolicy.reroute_backlog on
        # every platform fork); None = static routes
        self.reroute_backlog = reroute_backlog

    def _lease_event(self, func: str, event: str, n: int = 1) -> None:
        self.lease_telemetry.setdefault(func, Counter())[event] += n

    def _count_lost(self, func: str, lost: List[str]) -> None:
        if lost:
            san = self.network.sanitizer
            if san is not None:
                for nid in lost:
                    san.parent_lost(func, nid)
            self._lease_event(func, "parent_lost", len(lost))

    # -- registry ---------------------------------------------------------

    def register_function(self, fdef: FunctionDef) -> None:
        self.functions[fdef.name] = fdef

    def pick_node(self, exclude=(), func: Optional[str] = None) -> NodeRuntime:
        """Schedule the next child.  With ``func``, the scheduler sees the
        seed's route demand — its replica parents × its placement policy's
        transport mix — and lands the child where connection setup (paid RC
        connects amortize, fresh ones don't) plus channel backlog is
        cheapest."""
        return self.scheduler.pick(self.nodes, exclude=exclude,
                                   demand=self._route_demand(func))

    def _route_demand(self, func: Optional[str]):
        seed = self.seed_store.get(func) if func else None
        if seed is None:
            return None
        if isinstance(seed, ShardedSeed):
            return route_demand(seed.parent_nodes,
                                seed.placement.transport_hints())
        return route_demand([seed.parent_node], [None])

    # -- startup paths ------------------------------------------------------

    def coldstart(self, func: str, node: NodeRuntime) -> ModelInstance:
        fdef = self.functions[func]
        params = fdef.make_params()
        inst = ModelInstance.create(node, fdef.arch, params, kind="weights")
        # §6.2: cache only the FIRST coldstart container platform-wide as seed
        if self.auto_seed and func not in self.seed_store:
            self.deploy_seed(func, node, instance=inst,
                             replicas=self.seed_replicas,
                             placement=self.seed_placement)
        return inst

    def deploy_seed(self, func: str, node: Optional[NodeRuntime] = None,
                    instance: Optional[ModelInstance] = None,
                    long_lived: bool = True,
                    keep_alive: float = DEFAULT_SEED_KEEPALIVE,
                    replicas: int = 1,
                    placement: Optional[PlacementPolicy] = None) -> Seed:
        """Prepare ``func``'s seed on ``node``.  ``replicas=S`` shards the
        logical seed over S parents: the origin handle is replicated onto
        S-1 further nodes through the ordinary fork path (eager restore,
        then prepare), and children route their VMAs across the replica set
        per ``placement`` (byte-balanced spread by default).  Returns the
        plain ``ForkHandle`` for an unsharded seed, else the
        ``ShardedSeed``."""
        fdef = self.functions[func]
        node = node or self.pick_node()
        if instance is None:
            instance = ModelInstance.create(node, fdef.arch, fdef.make_params(),
                                            kind="weights")
        handle = node.prepare_fork(instance, lease=keep_alive)
        seed: Seed = handle
        if replicas > 1 or placement is not None:
            seed = ShardedSeed([handle], placement=placement,
                               target_replicas=replicas)
            self._replicate(func, seed, keep_alive=keep_alive,
                            telemetry=False)
        if long_lived:
            self.seed_store[func] = seed
        return seed

    def _replicate(self, func: str, seed: ShardedSeed,
                   keep_alive: Optional[float] = None,
                   telemetry: bool = True) -> int:
        """Grow ``seed`` back to its target replica count by forking a live
        replica onto nodes not already hosting one.  Returns replicas
        added; stops early when no source replica or spare node exists."""
        added = 0
        while seed.replicas < seed.target_replicas:
            live = seed.live_handles()
            if not live:
                break
            src = live[0]
            try:
                node = self.pick_node(exclude=set(seed.parent_nodes))
            except RuntimeError:
                break
            try:
                rinst = src.resume_on(node, ForkPolicy(lazy=False))
            except TransportError:
                # the source replica died (or its fabric flapped) mid-heal:
                # stop growing this sweep, the next pass re-purges and
                # retries from whatever survived
                break
            lease = keep_alive if keep_alive is not None \
                else self._seed_lease(src)
            seed.add_replica(node.prepare_fork(rinst, lease=lease))
            added += 1
            if telemetry:
                self._lease_event(func, "rereplicated")
        return added

    def _seed_lease(self, handle: ForkHandle) -> Optional[float]:
        """The lease duration a replacement replica should inherit."""
        rt = handle.runtime
        entry = rt.seeds.get(handle.handler_id) if rt is not None else None
        return entry.lease_duration if entry is not None \
            else DEFAULT_SEED_KEEPALIVE

    # -- lease-driven recovery (the fault plane's rung 2) ---------------------

    def _make_recovery(self, func: str):
        """Build the ``ModelInstance.recover_owner`` hook for a forked child
        of ``func``: when a remote read fails and no sibling replica can
        serve (``repro_torch.core.instance._recover_group`` rung 1), the
        coordinator re-replicates the seed — replacement replicas inherit
        the survivors' lease via ``_seed_lease`` — or redeploys it from
        pristine state, then re-stamps the VMA's missing pages onto a live
        parent.  Returns True iff the child can retry its read."""
        def recover(inst: ModelInstance, vma: VMA, lost_owner: str) -> bool:
            seed = self._fresh_seed(func)
            if seed is None:
                if not self.auto_seed:
                    return False
                try:
                    seed = self.deploy_seed(func, replicas=self.seed_replicas,
                                            placement=self.seed_placement)
                except (NoNodesAvailable, TransportError):
                    return False
                self._lease_event(func, "reseeded")
            elif (isinstance(seed, ShardedSeed)
                    and seed.replicas < seed.target_replicas):
                # heal the shard set now, not at the next gc() tick — the
                # restamp below then has a spare replica to point at
                self._replicate(func, seed)
            return self._restamp_from_seed(inst, vma, seed, lost_owner)
        return recover

    def _restamp_from_seed(self, inst: ModelInstance, vma: VMA, seed: Seed,
                           lost_owner: str) -> bool:
        """Point ``vma``'s still-missing remote pages at a live seed
        replica: fetch that replica's descriptor (minting a fresh DC key)
        and rewrite the route — frames, hop-1 owner, DC key, ancestry —
        for the missing remote pages ONLY.  Resident and COW-dirty pages
        are untouched, so a half-fetched VMA keeps its local state
        (idempotent: re-running the restamp moves no extra bytes and
        never double-charges the pagetable)."""
        net = self.network
        for h in _seed_handles(seed):
            if h.parent_node not in net.nodes or h.parent_node == lost_owner:
                continue
            try:
                desc = h.fetch_descriptor(inst.node, ForkPolicy())
            except (TransportError, PermissionError):
                continue
            table = next((vd for vd in desc.vmas
                          if vd["name"] == vma.name), None)
            key = desc.extra.get("prepared_keys", {}).get(vma.name)
            if table is None or key is None:
                continue
            fresh = VMA.from_table_dict(table)
            # only pages the replica itself owns (hop 0 there) can be
            # served at hop 1 here; a replica mid-restore contributes what
            # it has and the next handle covers the rest on a later rung
            remote = (vma.missing_mask() & (vma.owner_hop >= 1)
                      & (fresh.owner_hop == 0))
            if not remote.any():
                continue
            vma.frames[remote] = fresh.frames[remote]
            vma.owner_hop[remote] = 1
            vma.dc_keys[1] = key
            vma.ancestry = [h.parent_node] + list(desc.ancestry)
            vma.version += 1
            net.meter["recovery.reseed_fetches"] += 1
            return True
        return False

    def acquire_instance(self, func: str, *, node: Optional[NodeRuntime] = None,
                         policy: str = "fork", lazy: bool = True,
                         prefetch: int = 1):
        """Start (or reuse) a container for `func` without executing it.
        policy: fork | cache | coldstart."""
        node = node or self.pick_node(func=func)
        inst = None
        if policy == "cache":
            pool = self.cached.get(func, [])
            # local cached instance (unpause): only usable on its own node;
            # husks (freed underneath the pool, e.g. by seed-expiry GC with
            # free_instance=True) are dropped, never handed out
            self.cached[func] = pool = [(c, ts) for c, ts in pool if c.aspace]
            for i, (cand, ts) in enumerate(pool):
                if cand.node is node:
                    inst = pool.pop(i)[0]
                    break
        if inst is None and policy == "fork":
            seed = self._fresh_seed(func)
            if seed is not None:
                try:
                    inst = seed.resume_on(node, ForkPolicy(
                        lazy=lazy, prefetch=prefetch,
                        reroute_backlog=self.reroute_backlog))
                except TransportError:
                    # every usable replica died between the freshness check
                    # and the descriptor fetch — degrade to coldstart below.
                    # Lease violations (PermissionError) stay loud: those are
                    # capability bugs, not infrastructure faults.
                    inst = None
                if isinstance(seed, ShardedSeed):
                    # a replica can die between the freshness check and the
                    # fetch; the resume re-routes and records the victim
                    self._count_lost(func, seed.drain_lost())
                if inst is not None:
                    inst.recover_owner = self._make_recovery(func)
        if inst is None:
            inst = self.coldstart(func, node)
        return inst

    def invoke(self, func: str, inputs: Optional[dict] = None, *,
               node: Optional[NodeRuntime] = None, policy: str = "fork",
               lazy: bool = True, prefetch: int = 1) -> tuple:
        """Returns (outputs, instance). policy: fork | cache | coldstart."""
        inst = self.acquire_instance(func, node=node, policy=policy,
                                     lazy=lazy, prefetch=prefetch)
        out = self.functions[func].behavior(inst, inputs or {})
        return out, inst

    def release(self, func: str, inst: ModelInstance, policy: str) -> None:
        """Post-execution: caching keeps the container; fork frees the child
        (§6.2: children are never cached).  An instance pinned as the
        platform seed is NOT freed here — the seed store owns it until its
        lease expires (coldstart registers the first container as seed, and
        freeing it would yank the live seed out from under later forks)."""
        if policy == "cache":
            self.cached.setdefault(func, []).append((inst, self.clock()))
        elif not self._pinned_as_seed(inst):
            inst.free()

    def _pinned_as_seed(self, inst: ModelInstance) -> bool:
        for seed in self.seed_store.values():
            for handle in _seed_handles(seed):
                node = self.nodes.get(handle.parent_node)
                entry = node.seeds.get(handle.handler_id) \
                    if node is not None else None
                if entry is not None and entry.instance is inst:
                    return True
        return False

    # -- lifecycle / GC -------------------------------------------------------

    def _seed_fresh(self, seed: Seed) -> bool:
        # alive: the node-side dangling-seed GC may have reclaimed the seed
        # (MAX_FUNCTION_LIFETIME) while the store still holds the handle —
        # treat that as stale so invokes fall back to coldstart.  A sharded
        # seed is fresh while ANY replica can serve.
        return any(h.parent_node in self.network.nodes
                   and h.alive and not h.expired
                   for h in _seed_handles(seed))

    def _purge_lost(self, func: str) -> Optional[Seed]:
        """THE loss-accounting site: purge ``func``'s seed replicas whose
        parent dropped out of the network, telemeter each loss as
        ``parent_lost`` exactly once, and drop a fully lost seed from the
        store.  Every lifecycle pass (_fresh_seed, _live_handle, gc) goes
        through here FIRST, so a crashed parent is never misattributed to
        the "reclaimed" bucket just because its cleared seed table also
        reads as not-alive.  Returns the surviving seed, else None."""
        seed = self.seed_store.get(func)
        if seed is None:
            return None
        if isinstance(seed, ShardedSeed):
            seed.purge_lost(self.network.nodes)
            self._count_lost(func, seed.drain_lost())
            if seed.replicas == 0:
                del self.seed_store[func]
                return None
        elif seed.parent_node not in self.network.nodes:
            san = self.network.sanitizer
            if san is not None:
                san.parent_lost(func, seed.parent_node)
            del self.seed_store[func]
            self._lease_event(func, "parent_lost")
            return None
        return seed

    def _fresh_seed(self, func: str) -> Optional[Seed]:
        """The store's seed for ``func`` iff it can serve a fork right now.
        A replica whose parent dropped out of the network is purged ON
        SIGHT (not left for gc to eventually notice) and telemetered as
        ``parent_lost``; a fully lost seed leaves the store immediately."""
        seed = self._purge_lost(func)
        if seed is None:
            return None
        return seed if self._seed_fresh(seed) else None

    def _live_handle(self, func: str) -> Optional[Seed]:
        """The store's seed for ``func`` iff it is still registered at (at
        least one) parent; a seed reclaimed underneath the store is dropped
        (and telemetered as "reclaimed")."""
        seed = self._purge_lost(func)
        if seed is None:
            return None
        if not seed.alive:
            del self.seed_store[func]
            self._lease_event(func, "reclaimed")
            return None
        return seed

    def renew_seed(self, func: str) -> None:
        handle = self._live_handle(func)
        if handle is None:
            return
        handle.renew()
        self._lease_event(func, "renewals")

    def revoke_seed(self, func: str) -> Optional[ForkHandle]:
        """Invalidate every outstanding handle for ``func``'s seed (bump its
        generation); the store keeps serving through the fresh handle.
        Returns None if there is nothing to revoke (no seed, or reclaimed
        underneath the store — dropped like renew_seed does)."""
        handle = self._live_handle(func)
        if handle is None:
            return None
        fresh = handle.revoke()
        self.seed_store[func] = fresh
        self._lease_event(func, "revocations")
        return fresh

    def gc(self) -> dict:
        """Timeout-based reclamation: expired long-lived seeds, stale cached
        containers, and node-side dangling short-lived seeds (§6.3).  The
        returned dict also carries the accumulated lease telemetry:
        ``lease`` (per-function renew/expiry/revocation counters) and
        ``lease_nodes`` (per-node parent-side counters)."""
        now = self.clock()
        freed = {"seeds": 0, "cached": 0, "dangling": 0, "rereplicated": 0}
        for func in list(self.seed_store):
            seed = self._purge_lost(func)
            if seed is None:
                freed["seeds"] += 1
                continue
            if isinstance(seed, ShardedSeed):
                for h in list(seed.handles):
                    if h.expired or not h.alive:
                        self._lease_event(
                            func, "expiries" if h.expired else "reclaimed")
                        h.reclaim(free_instance=True)  # no-op if already gone
                        seed.handles.remove(h)
                if not seed.handles:
                    del self.seed_store[func]
                    freed["seeds"] += 1
                else:
                    # heal the shard set back to its target replica count
                    freed["rereplicated"] += self._replicate(func, seed)
                continue
            if seed.expired or not seed.alive:
                self._lease_event(
                    func, "expiries" if seed.expired else "reclaimed")
                seed.reclaim(free_instance=True)   # no-op if already gone
                del self.seed_store[func]
                freed["seeds"] += 1
        for func, pool in self.cached.items():
            keep = []
            for inst, ts in pool:
                if now - ts >= self.cache_keepalive:
                    if inst.aspace and not self._pinned_as_seed(inst):
                        inst.free()
                    freed["cached"] += 1
                else:
                    keep.append((inst, ts))
            self.cached[func] = keep
        # invoker-side fault tolerance: GC seeds past max function lifetime
        for node in self.nodes.values():
            for hid, entry in list(node.seeds.items()):
                if now - entry.created >= MAX_FUNCTION_LIFETIME:
                    node.reclaim_seed(hid, free_instance=False)
                    freed["dangling"] += 1
        freed["lease"] = {f: dict(c) for f, c in self.lease_telemetry.items()}
        freed["lease_nodes"] = {i: dict(n.lease_stats)
                                for i, n in self.nodes.items()}
        return freed

    # -- fork trees (short-lived seeds, §6.3) -----------------------------------

    def tree_open(self, wf_id: str, root: ForkTreeNode) -> None:
        self.fork_trees[wf_id] = root

    def tree_close(self, wf_id: str) -> None:
        """Reclaim every short-lived seed in the tree except the root."""
        root = self.fork_trees.pop(wf_id, None)
        if root is None:
            return

        def walk(n: ForkTreeNode, is_root: bool):
            for c in n.children:
                walk(c, False)
            if not is_root and n.handle is not None:
                n.handle.reclaim()

        walk(root, True)

    def memory_by_node(self) -> Dict[str, int]:
        return {i: n.memory_bytes() for i, n in self.nodes.items()}
