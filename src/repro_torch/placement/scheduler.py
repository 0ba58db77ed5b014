"""Node schedulers — where a child lands (transport- and load-aware).

``Coordinator.pick_node`` used to be blind round-robin with a drifting
cursor: ``self._rr % len(ids)`` indexed the *filtered* (live, non-excluded)
list, so an exclusion or crash shifted every later pick and the cursor
could hand out the same node back-to-back.  The schedulers here fix that
and add the Swift-style cost dimension: connection setup (RC's 4 ms QP
connect amortizes very differently than DCT's piggybacked setup) and
per-channel backlog should decide where a fork lands.

* :class:`RoundRobinScheduler` — deterministic, exclusion-stable rotation
  over a stable node order; skipping a dead/excluded node never shifts the
  other nodes' turns.
* :class:`TransportAwareScheduler` — scores each candidate against the
  seed's route demand ((owner, transport) pairs) from OBSERVED pool
  state: ``Network.setup_owed`` prices exactly the establishment the
  next op would pay (0 for a warm slot — even a shared DCT context
  another sibling brought up — the backend's setup cost for a cold or
  LRU-evicted pair), and busy channels/links/control planes charge
  their backlogs.  Ties fall back to the round-robin order, so with no
  demand context it degrades to exactly the deterministic rotation.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.net import NoNodesAvailable


class RoundRobinScheduler:
    """Deterministic, exclusion-stable round-robin.

    The cursor walks a stable order (node ids in first-seen order, growing
    as nodes register); a pick scans from the cursor for the first live,
    non-excluded node and advances the cursor just past it.  Excluded or
    dead nodes are skipped *in place* — the mapping from cursor to node
    never re-indexes a filtered list, so the same node is only returned
    twice in a row when it is the sole eligible node.
    """

    def __init__(self):
        self._order: List[str] = []
        self._known = set()
        self._cursor = 0

    def _refresh(self, nodes: Dict[str, object]) -> None:
        for nid in nodes:
            if nid not in self._known:
                self._known.add(nid)
                self._order.append(nid)

    def _eligible(self, nodes: Dict[str, object],
                  exclude: Iterable[str]) -> List[Tuple[int, object]]:
        """(order index, node) in scan order starting at the cursor."""
        self._refresh(nodes)
        exclude = set(exclude)
        out = []
        n = len(self._order)
        for i in range(n):
            idx = (self._cursor + i) % n
            nid = self._order[idx]
            node = nodes.get(nid)
            if node is not None and node.alive and nid not in exclude:
                out.append((idx, node))
        return out

    def pick(self, nodes: Dict[str, object], exclude: Iterable[str] = (),
             demand: Optional[Sequence[tuple]] = None):
        ranked = self._eligible(nodes, exclude)
        if not ranked:
            raise NoNodesAvailable("no live nodes")
        idx, node = ranked[0]
        self._cursor = (idx + 1) % len(self._order)
        return node


class TransportAwareScheduler(RoundRobinScheduler):
    """Score candidates by what the seed's route plan would cost from
    there; fall back to the stable rotation when scores tie (or no demand
    context is given)."""

    def __init__(self, network):
        super().__init__()
        self.net = network

    def score(self, node_id: str, demand: Sequence[tuple]) -> float:
        """Cost of placing a child on ``node_id`` for the given
        (owner, transport) route demand: the establishment the pools say
        each route would actually owe (``Network.setup_owed`` — observed
        state, NOT a backend-constant estimate, so a candidate holding a
        warm shared DCT context beats a cold RC peer and an LRU-evicted
        pair is correctly priced as cold again), the current backlog of
        each (child, owner) channel, the link backlog of the candidate's
        own NIC, and its control-plane backlog (in-flight handshakes).
        (The OWNERS' link backlogs are deliberately not charged: every
        candidate queues on them equally, so they cannot discriminate a
        placement.)

        Connection setup is priced once per (src, dst, transport) —
        repeated demand entries for the same pair (a many-VMA plan routed
        to one owner, or ``None`` next to the spelled-out default
        backend) are deduped, and each (child, owner) channel is charged
        once, not once per transport riding it."""
        cost = self.net.link_backlog(node_id) + self.net.conn_backlog(node_id)
        seen_pairs = set()
        seen_owners = set()
        for owner, transport in demand:
            name = transport or self.net.transport
            if (owner, name) not in seen_pairs:
                seen_pairs.add((owner, name))
                cost += self.net.setup_owed(name, node_id, owner)
            if owner not in seen_owners:
                seen_owners.add(owner)
                cost += self.net.channel_backlog(node_id, owner)
        return cost

    def pick(self, nodes: Dict[str, object], exclude: Iterable[str] = (),
             demand: Optional[Sequence[tuple]] = None):
        ranked = self._eligible(nodes, exclude)
        if not ranked:
            raise NoNodesAvailable("no live nodes")
        if demand:
            # min() is stable: equal scores resolve to scan order, i.e. the
            # deterministic round-robin fallback
            idx, node = min(ranked,
                            key=lambda e: self.score(e[1].node_id, demand))
        else:
            idx, node = ranked[0]
        self._cursor = (idx + 1) % len(self._order)
        return node
