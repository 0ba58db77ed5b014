"""Bounded per-node connection pools and the network-wide manager.

A :class:`ConnPool` is one node's connection table (QP / DC contexts):
an LRU-ordered, capacity-bounded set of :class:`~repro_torch.net.conn.types.
Connection` slots.  ``NetModel.conn_cap`` bounds every pool (0 =
unbounded, the legacy behavior); overflowing a pool evicts the
least-recently-used *unreferenced* connection first and only tears a
connection out from under live users as a last resort.

The :class:`ConnManager` owns all pools for one :class:`~repro_torch.net.
network.Network` and is the single place connection state changes:

* ``acquire`` — ensure a live (src, dst) path over a backend, returning
  the owed establishment seconds (``None`` when the path is warm).  RC
  acquires a per-peer QP in both pools; DCT acquires/reuses one
  initiator at src and one target at dst and pays only the per-new-pair
  piggyback handshake.
* eviction — cascades structurally: evicting a DCT target invalidates
  every initiator's handshake to it (they re-pay the piggyback on next
  use), evicting an RC QP frees the slot at both endpoints.
* churn meters — ``{backend}.conn_evicted`` counts slots torn down and
  ``{backend}.conn_reestablished`` counts pairs that pay setup *again*
  after having been warm before: the Swift-style setup-storm signal the
  fig18 churn rows pin.
"""
from __future__ import annotations

import contextlib
from collections import OrderedDict
from typing import Dict, Optional, Set

from repro_torch.net.conn.types import (Connection, DCTInitiator, DCTTarget,
                                  RCConnection)


class ConnPool:
    """One node's LRU-ordered, capacity-bounded connection table."""

    def __init__(self, node_id: str, manager: "ConnManager"):
        self.node_id = node_id
        self.manager = manager
        self._order: "OrderedDict[tuple, Connection]" = OrderedDict()

    def __len__(self) -> int:
        return len(self._order)

    def __contains__(self, key: tuple) -> bool:
        return key in self._order

    def connections(self):
        """Connections in LRU -> MRU order (a snapshot list)."""
        return list(self._order.values())

    def touch(self, key: tuple) -> None:
        if key in self._order:
            self._order.move_to_end(key)

    def insert(self, conn: Connection) -> None:
        self._order[conn.key] = conn
        self._order.move_to_end(conn.key)

    def remove(self, key: tuple) -> None:
        self._order.pop(key, None)

    def enforce_cap(self, protect: tuple) -> int:
        """Evict until the pool fits ``NetModel.conn_cap``; never evicts
        ``protect`` (the entry being acquired).  Unreferenced connections
        go first in LRU order; if every other slot is held by a live
        user, the LRU one is torn down anyway (forced churn under
        pressure — the QP table is a hard hardware bound).  Returns the
        number of evictions."""
        cap = self.manager.cap
        if cap <= 0:
            return 0
        evicted = 0
        while len(self._order) > cap:
            victim = None
            for key, conn in self._order.items():
                if key != protect and not conn.users:
                    victim = conn
                    break
            if victim is None:
                for key, conn in self._order.items():
                    if key != protect:
                        victim = conn
                        break
            if victim is None:      # only the protected entry remains
                break
            self.manager.evict(victim)
            evicted += 1
        return evicted


class ConnManager:
    """All connection state for one Network: pools, live entries, churn."""

    def __init__(self, net):
        self.net = net
        self.pools: Dict[str, ConnPool] = {}
        self.conns: Dict[tuple, Connection] = {}
        # (backend, src, dst) pairs that have EVER paid setup: a pair
        # paying again after eviction is re-establishment churn
        self._seen_pairs: Set[tuple] = set()
        # user -> connection keys it holds a reference on
        self._user_index: Dict[str, Set[tuple]] = {}

    @property
    def cap(self) -> int:
        return getattr(self.net.model, "conn_cap", 0)

    def pool(self, node_id: str) -> ConnPool:
        p = self.pools.get(node_id)
        if p is None:
            p = self.pools[node_id] = ConnPool(node_id, self)
        return p

    # -- acquisition ---------------------------------------------------------

    def acquire(self, transport, src: str, dst: str,
                user: Optional[str] = None) -> Optional[float]:
        """Ensure a live (src, dst) path over ``transport``.  Returns the
        owed establishment seconds when a handshake is needed, or None
        when the path is already warm (slot reuse / DCT amortization).
        The caller decides how the owed time lands on the clock (sync
        stall vs folded into async channel time)."""
        kind = transport.conn_kind
        name = transport.name
        if kind == "peer":
            key = (name, "peer", src, dst)
            conn = self.conns.get(key)
            fresh = conn is None
            if fresh:
                conn = RCConnection(name, src, dst)
                self._admit(conn)
            self._touch(conn, user)
            if not fresh:
                return None
            return self._established(name, src, dst, transport)
        if kind != "dc":
            raise ValueError(
                f"transport {name!r} has unsupported conn_kind {kind!r}")
        dci = self.conns.get((name, "dci", src))
        if dci is None:
            dci = DCTInitiator(name, src)
            self._admit(dci)
        tgt = self.conns.get((name, "tgt", dst))
        if tgt is None:
            tgt = DCTTarget(name, dst)
            self._admit(tgt)
        self._touch(dci, user)
        self._touch(tgt, user)
        if dst in dci.peers and src in tgt.initiators:
            return None             # handshake already piggybacked
        dci.peers.add(dst)
        tgt.initiators.add(src)
        return self._established(name, src, dst, transport)

    def _established(self, name: str, src: str, dst: str,
                     transport) -> float:
        pair = (name, src, dst)
        if pair in self._seen_pairs:
            self.net.meter[f"{name}.conn_reestablished"] += 1
        else:
            self._seen_pairs.add(pair)
        return transport.setup_cost()

    def _admit(self, conn: Connection) -> None:
        self.conns[conn.key] = conn
        # slot the connection everywhere BEFORE enforcing caps: eviction
        # scans the whole control plane, so it must never observe a conn
        # half-inserted (cap victims only depend on each pool's own LRU
        # order, so splitting the loop changes nothing behaviorally)
        for nid in conn.nodes:
            self.pool(nid).insert(conn)
        for nid in conn.nodes:
            self.pools[nid].enforce_cap(protect=conn.key)
        san = self.net.sanitizer
        if san is not None:
            san.check_conns(self, f"admit {conn.key}")

    def _touch(self, conn: Connection, user: Optional[str]) -> None:
        san = self.net.sanitizer
        if san is not None:
            san.touch_live(conn, self, f"touch {conn.key}")
        for nid in conn.nodes:
            pool = self.pools.get(nid)
            if pool is not None:
                pool.touch(conn.key)
        if user is not None:
            conn.users.add(user)
            self._user_index.setdefault(user, set()).add(conn.key)

    # -- teardown ------------------------------------------------------------

    def evict(self, conn: Connection, meter: bool = True) -> None:
        """Tear ``conn`` down everywhere: drop its pool slots, release its
        users' references, and structurally invalidate DCT handshakes
        that rode the evicted context."""
        self.conns.pop(conn.key, None)
        for nid in conn.nodes:
            pool = self.pools.get(nid)
            if pool is not None:
                pool.remove(conn.key)
        # sim-ok: set-iter -- pure per-user discards; order cannot matter
        for u in conn.users:
            keys = self._user_index.get(u)
            if keys is not None:
                keys.discard(conn.key)
        conn.users.clear()
        if isinstance(conn, DCTInitiator):
            # sim-ok: set-iter -- independent handshake invalidations
            for d in conn.peers:
                tgt = self.conns.get((conn.backend, "tgt", d))
                if tgt is not None:
                    tgt.initiators.discard(conn.src)
            conn.peers.clear()
        elif isinstance(conn, DCTTarget):
            # sim-ok: set-iter -- independent handshake invalidations
            for s in conn.initiators:
                dci = self.conns.get((conn.backend, "dci", s))
                if dci is not None:
                    dci.peers.discard(conn.dst)
            conn.initiators.clear()
        if meter:
            self.net.meter[f"{conn.backend}.conn_evicted"] += 1
        san = self.net.sanitizer
        if san is not None:
            san.check_conns(self, f"evict {conn.key}")

    def release_user(self, user: str) -> None:
        """Drop every reference ``user`` holds (instance free): the
        connections stay warm in their pools but become first in line
        for eviction under cap pressure."""
        for key in self._user_index.pop(user, ()):
            conn = self.conns.get(key)
            if conn is not None:
                conn.users.discard(user)
        san = self.net.sanitizer
        if san is not None:
            san.check_conns(self, f"release_user {user}")

    def fault_pair(self, name: str, src: str, dst: str) -> None:
        """An op on the (src, dst) QP over backend ``name`` timed out: RC
        semantics move the QP to the error state, so the connection is
        torn down at both endpoints (``{name}.conn_faulted``) and the
        retry re-pays establishment through ``acquire`` — metered as
        re-establishment churn because the pair was seen before."""
        conn = self.conns.get((name, "peer", src, dst))
        if conn is not None:
            self.evict(conn)
            self.net.meter[f"{name}.conn_faulted"] += 1

    def drop_node(self, node_id: str) -> None:
        """A node left the network (crash/unregister): every connection
        with a slot in its pool dies — peers will re-pay setup if the
        node comes back."""
        pool = self.pools.pop(node_id, None)
        if pool is None:
            return
        san = self.net.sanitizer
        # the cascade is inconsistent by construction (the pool is gone
        # while its conns still exist), so scan once at the end instead
        # of after each evict
        with (san.bulk() if san is not None else contextlib.nullcontext()):
            for conn in pool.connections():
                self.evict(conn)
        if san is not None:
            san.check_conns(self, f"drop_node {node_id}")

    def reset(self) -> None:
        """Forget ALL connection state (tests/diagnostics): pairs re-pay
        setup as if never connected, with no churn metered."""
        self.pools.clear()
        self.conns.clear()
        self._seen_pairs.clear()
        self._user_index.clear()

    # -- observed state (what schedulers/telemetry read) ---------------------

    def has(self, name: str, src: str, dst: str) -> bool:
        """True iff the (src, dst) path over backend ``name`` is warm in
        the pools right now (observed state, not history)."""
        from repro_torch.net.transport import resolve_transport
        kind = resolve_transport(name).conn_kind
        if kind == "peer":
            return (name, "peer", src, dst) in self.conns
        if kind == "dc":
            dci = self.conns.get((name, "dci", src))
            tgt = self.conns.get((name, "tgt", dst))
            return (dci is not None and dst in dci.peers
                    and tgt is not None and src in tgt.initiators)
        return False

    def setup_owed(self, name: str, src: str, dst: str) -> float:
        """Seconds the NEXT (src, dst) op over ``name`` will owe for
        establishment, from observed pool state: 0 for connectionless
        fabrics and warm paths, the backend's setup cost otherwise."""
        from repro_torch.net.transport import resolve_transport
        if not resolve_transport(name).connection_oriented:
            return 0.0
        if self.has(name, src, dst):
            return 0.0
        return self.net.transport_obj(name).setup_cost()

    def live(self, name: str) -> int:
        """Live pool entries (slots, not pairs) for backend ``name``."""
        return sum(1 for c in self.conns.values() if c.backend == name)
