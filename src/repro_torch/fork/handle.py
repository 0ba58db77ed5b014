"""ForkHandle — the leased capability for one prepared seed.

``prepare_fork`` builds the KB-sized descriptor (page tables + registers,
no memory copy), assigns one DC key per VMA from the pooled targets, and
registers the seed under a fresh (handler_id, auth_key) pair guarded by a
lease deadline and a revocation generation.  The returned handle is the
only thing a child (or the coordinator) needs: it serializes to a small
dict/JSON record and travels over the control plane instead of loose ints.

Enforcement lives at the parent: ``NodeRuntime.auth_seed`` rejects stale
generations with ``AccessRevoked`` and expired leases with ``LeaseExpired``
during the authentication RPC, before any descriptor bytes move.
"""
from __future__ import annotations

import dataclasses
import json
import math
import time
from typing import Optional, Sequence

from repro_torch import tracing
from repro_torch.core.descriptor import Descriptor
from repro_torch.core.instance import ModelInstance
from repro_torch.core.pagetable import VMA
from repro_torch.fork.policy import ForkPolicy
from repro_torch.net import HandleUnbound, NodeDown

DEFAULT_TREE_DEGREE = 8

_WIRE_FIELDS = ("parent_node", "handler_id", "auth_key", "lease_deadline",
                "generation", "created")


@dataclasses.dataclass
class ForkHandle:
    """Serializable capability: everything a child needs to resume a seed.

    ``runtime`` is the parent NodeRuntime when the handle was minted (or
    rebound) in-process; it is excluded from serialization and only needed
    for the parent-side lifecycle calls (renew / revoke / reclaim).
    ``resume_on`` never needs it — the child reaches the parent through its
    own network, exactly like the RPC in the paper.
    """

    parent_node: str
    handler_id: int
    auth_key: int
    lease_deadline: float = math.inf     # absolute seconds on the parent clock
    generation: int = 0
    created: float = 0.0
    runtime: Optional[object] = dataclasses.field(
        default=None, repr=False, compare=False)

    # -- serialization ------------------------------------------------------

    def to_dict(self) -> dict:
        d = {k: getattr(self, k) for k in _WIRE_FIELDS}
        if math.isinf(d["lease_deadline"]):
            d["lease_deadline"] = None      # RFC 8259 JSON has no Infinity
        return d

    @classmethod
    def from_dict(cls, d: dict, runtime=None) -> "ForkHandle":
        d = {k: d[k] for k in _WIRE_FIELDS}
        if d["lease_deadline"] is None:
            d["lease_deadline"] = math.inf
        return cls(runtime=runtime, **d)

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    @classmethod
    def from_json(cls, s: str, runtime=None) -> "ForkHandle":
        return cls.from_dict(json.loads(s), runtime=runtime)

    def bind(self, runtime) -> "ForkHandle":
        """Re-attach a deserialized handle to its parent runtime."""
        if runtime.node_id != self.parent_node:
            raise ValueError(
                f"handle belongs to {self.parent_node!r}, not {runtime.node_id!r}")
        self.runtime = runtime
        return self

    # -- lease bookkeeping (advisory; the parent is authoritative) ----------

    def _now(self, now: Optional[float] = None) -> float:
        if now is not None:
            return now
        if self.runtime is not None:
            return self.runtime.clock()
        # sim-ok: wall-clock -- only unbound (deserialized) handles outside a
        # sim reach this; bound handles read the parent's clock above
        return time.monotonic()

    def remaining(self, now: Optional[float] = None) -> float:
        """Seconds of lease left (inf for unbounded leases).

        Advisory only: ``lease_deadline`` is absolute on the PARENT's clock.
        Bound handles read that clock; an unbound (deserialized) handle
        falls back to this process's ``time.monotonic()``, which is only
        meaningful when producer and consumer share it (the in-process
        simulation norm) — pass ``now`` explicitly otherwise.  The parent's
        check at auth is always authoritative."""
        if math.isinf(self.lease_deadline):
            return math.inf
        return self.lease_deadline - self._now(now)

    @property
    def expired(self) -> bool:
        return self.remaining() <= 0

    @property
    def alive(self) -> bool:
        """True while the seed is still registered at the (bound) parent —
        False once reclaimed (e.g. by GC), or when the handle is unbound."""
        return (self.runtime is not None
                and self.handler_id in self.runtime.seeds)

    # -- lifecycle ----------------------------------------------------------

    def fetch_descriptor(self, child_node,
                         policy: Optional[ForkPolicy] = None) -> Descriptor:
        """Steps 1–2 of a fork: authentication RPC (lease + generation
        checked at the parent, §5.2) and the descriptor transfer through the
        policy's named transport.  Shared by ``resume_on`` and the sharded
        multi-parent resume (``repro_torch.placement.ShardedSeed``), which fetches
        one descriptor per replica it routes VMAs to."""
        policy = ForkPolicy.coerce(policy)
        net = child_node.network
        if self.parent_node not in net.nodes:
            raise NodeDown(f"parent {self.parent_node} is down")
        parent = net.nodes[self.parent_node]

        # 1) authentication RPC (malformed ids/keys, revoked generations and
        #    expired leases are all rejected here, §5.2)
        info = net.rpc(child_node.node_id, self.parent_node, 64,
                       parent.auth_seed, self.handler_id, self.auth_key,
                       self.generation)

        # 2) descriptor fetch through the named transport: one-sided backends
        #    read the blob RNIC-style behind its own DC key (a reclaimed
        #    seed's descriptor is unreadable, like any VMA); two-sided
        #    backends RPC the parent daemon
        dt = net.transport_obj(policy.descriptor_fetch)
        if dt.one_sided:
            net.read_blob(child_node.node_id, self.parent_node,
                          info["nbytes"], info["desc_key"], transport=dt.name)
            blob = parent.seed_blob(self.handler_id)
        else:
            blob = net.rpc(child_node.node_id, self.parent_node,
                           info["nbytes"], parent.seed_blob, self.handler_id,
                           info["desc_key"], transport=dt.name)
        return Descriptor.from_bytes(blob)

    def resume_on(self, child_node, policy: Optional[ForkPolicy] = None,
                  placement=None) -> ModelInstance:
        """Fork a child onto ``child_node``: authentication RPC (lease +
        generation checked at the parent), one-sided descriptor fetch, child
        page tables shifted one hop up, then lazy paging per ``policy``.

        ``placement`` (a ``repro_torch.placement`` PlacementPolicy) optionally
        routes each VMA over its own transport (e.g. hot weights on ``dct``,
        cold optimizer state on ``shared_fs``); with a single parent every
        route's owner is this handle's parent."""
        with tracing.span("fork.resume", node=child_node.node_id):
            policy = ForkPolicy.coerce(policy)
            desc = self.fetch_descriptor(child_node, policy)
            plan = None
            if placement is not None:
                plan = placement.plan_for(desc, [self.parent_node])

            # 3) child address space: page tables shifted one hop up, each
            #    VMA stamped with its owner chain (and plan transport, if
            #    routed)
            prepared = desc.extra["prepared_keys"]
            aspace = {}
            for vd in desc.vmas:
                vma = VMA.from_table_dict(vd)
                vma = vma.child_view(prepared[vma.name],
                                     parent_node=self.parent_node,
                                     default_ancestry=desc.ancestry)
                if plan is not None and vma.name in plan:
                    vma.transport = plan[vma.name].transport or vma.transport
                aspace[vma.name] = vma
            ancestry = [self.parent_node] + list(desc.ancestry)
            return instantiate_child(child_node, policy, desc, aspace,
                                     ancestry)

    def renew(self, extend: Optional[float] = None) -> "ForkHandle":
        """Extend the lease at the parent by ``extend`` seconds (default:
        the original lease duration).  Returns self with the new deadline."""
        self.lease_deadline = self._require_runtime().renew_seed(
            self.handler_id, extend)
        return self

    def revoke(self) -> "ForkHandle":
        """Invalidate every outstanding copy of this handle by bumping the
        seed's generation at the parent.  Returns a fresh handle for the new
        generation (the seed itself stays prepared)."""
        gen = self._require_runtime().revoke_seed(self.handler_id)
        return dataclasses.replace(self, generation=gen)

    def reclaim(self, free_instance: bool = False) -> None:
        """Destroy the seed's DC targets and unregister it; idempotent.
        Subsequent child reads are rejected by the RNIC-analogue and surface
        as AccessRevoked (served via the fallback daemon if pages live)."""
        self._require_runtime().reclaim_seed(self.handler_id,
                                             free_instance=free_instance)

    def fan_out(self, nodes: Sequence, policy: Optional[ForkPolicy] = None,
                tree_degree: int = DEFAULT_TREE_DEGREE,
                child_lease: Optional[float] = None):
        """Fork one child per entry of ``nodes`` through a §6.3 fork tree:
        each seed (the root, then children re-prepared as short-lived seeds)
        serves at most ``tree_degree`` children, so descriptor fan-out load
        spreads over the tree instead of hammering one parent NIC.  Returns
        a ForkTree; ``close()`` reclaims every re-seed in one call."""
        from repro_torch.fork.tree import build_fork_tree
        return build_fork_tree(self, nodes, policy=policy,
                               tree_degree=tree_degree,
                               child_lease=child_lease)

    def _require_runtime(self):
        if self.runtime is None:
            raise HandleUnbound(
                "handle is not bound to its parent runtime; call "
                "handle.bind(parent_node_runtime) after deserializing")
        return self.runtime

    # -- context manager: auto-reclaim on exit ------------------------------

    def __enter__(self) -> "ForkHandle":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.reclaim()


def instantiate_child(child_node, policy: ForkPolicy, desc: Descriptor,
                      aspace, ancestry) -> ModelInstance:
    """Build and policy-configure the child instance from an assembled
    address space — the tail every resume path shares (single-parent
    ``resume_on`` and the sharded multi-parent resume), so prefetch/eager/
    cache semantics cannot drift between them."""
    if policy.sibling_cache is not None:
        child_node.cache_enabled = policy.sibling_cache
    inst = ModelInstance(child_node, desc.arch, desc.kind, aspace,
                         desc.leaf_paths, desc.extra["leaf_names"],
                         ancestry, dict(desc.registers))
    inst.page_transport = policy.page_fetch
    if policy.async_prefetch:
        from repro_torch.core.prefetch import PrefetchEngine
        inst.prefetch_engine = PrefetchEngine(inst, policy.async_prefetch)
    if not policy.lazy:
        # eager restore pipelines through the engine when one is attached:
        # the next VMA's pages transfer while this one assembles
        inst.ensure_all(prefetch=0)
    inst.default_prefetch = policy.prefetch
    return inst


def prepare_fork(node, instance, lease: Optional[float] = None) -> ForkHandle:
    """Prepare ``instance`` as a seed on ``node`` (paper Figure 7
    fork_prepare, plus a lease): descriptor build, DC-key assignment from the
    pooled targets, registration under a fresh (handler_id, auth_key).

    ``lease`` is a duration in seconds; None means unbounded (legacy
    semantics).  Prefer calling this as ``node.prepare_fork(instance, ...)``.
    """
    from repro_torch.platform.node import SeedEntry, make_auth_key

    if lease is not None and lease <= 0:
        raise ValueError(f"lease must be positive seconds or None, got {lease!r}")
    handler_id = next(node._hid)
    auth_key = make_auth_key()
    now = node.clock()
    deadline = math.inf if lease is None else now + lease
    prepared_keys = {name: node.take_dc_target() for name in instance.aspace}
    desc_key = node.take_dc_target()    # guards the descriptor blob itself
    instance.frames_published = True    # remote nodes may now cache our frames
    desc = Descriptor(
        arch=instance.arch,
        kind=instance.kind,
        parent_node=node.node_id,
        handler_id=handler_id,
        ancestry=list(instance.ancestry),
        leaf_paths=instance.leaf_paths,
        vmas=[v.table_dict() for v in instance.aspace.values()],
        registers=dict(instance.registers),
        extra={"prepared_keys": prepared_keys,
               "leaf_names": list(instance.leaf_names)},
        routes={name: {"owner": node.node_id, "transport": v.transport}
                for name, v in instance.aspace.items()},
    )
    blob = desc.to_bytes()
    node.register_seed(handler_id, SeedEntry(
        descriptor=desc, blob=blob, auth_key=auth_key, instance=instance,
        keys=prepared_keys, created=now, lease_deadline=deadline,
        lease_duration=lease, desc_key=desc_key))
    return ForkHandle(parent_node=node.node_id, handler_id=handler_id,
                      auth_key=auth_key, lease_deadline=deadline,
                      generation=0, created=now, runtime=node)
