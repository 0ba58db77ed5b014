"""Typed connection objects — RC vs DCT modeled structurally.

The paper's DCT-vs-RC ablation (§5.3) is usually summarized as two setup
*constants* (4 ms QP connect vs <1 us piggyback).  The structural
difference matters just as much under bounded pools:

* an RC connection is a per-(src, dst) queue pair — it occupies one slot
  in **both** endpoints' connection tables, so a K-way fan-out costs the
  parent K slots;
* a DCT initiator is one DC context at the source that can reach *any*
  target, and a DCT target is one context at the destination serving
  *any* initiator — a node fanning out to (or in from) K peers holds one
  slot, not K.  Each new (src, dst) pair still pays the piggybacked
  handshake once, but the slot footprint is O(1) per node.

Every connection tracks its ``users`` (instance-scoped refcounts): a
connection still referenced by a live child is only evicted as a last
resort, so siblings landed on one node keep sharing a warm path.
"""
from __future__ import annotations

from typing import List, Set, Tuple


class Connection:
    """One live connection-table entry at one or two nodes' pools."""

    kind = "conn"

    __slots__ = ("backend", "key", "nodes", "users")

    def __init__(self, backend: str, key: tuple, nodes: Tuple[str, ...]):
        self.backend = backend
        self.key = key
        self.nodes = nodes          # node ids whose pool holds a slot
        self.users: Set[str] = set()  # instance-scoped refcounts (sharing)

    def pairs(self) -> List[Tuple[str, str]]:
        """(src, dst) pairs this entry keeps warm."""
        raise NotImplementedError

    def __repr__(self):
        return (f"<{type(self).__name__} {self.key} "
                f"users={len(self.users)}>")


class RCConnection(Connection):
    """A reliable-connected queue pair: exactly one (src, dst) peer,
    occupying a slot at BOTH endpoints."""

    kind = "peer"

    __slots__ = ("src", "dst")

    def __init__(self, backend: str, src: str, dst: str):
        nodes = (src, dst) if src != dst else (src,)
        super().__init__(backend, (backend, "peer", src, dst), nodes)
        self.src = src
        self.dst = dst

    def pairs(self):
        return [(self.src, self.dst)]


class DCTInitiator(Connection):
    """One DC initiator context at ``src``: a single slot that reaches
    every target it has handshaken with (``peers``)."""

    kind = "dci"

    __slots__ = ("src", "peers")

    def __init__(self, backend: str, src: str):
        super().__init__(backend, (backend, "dci", src), (src,))
        self.src = src
        self.peers: Set[str] = set()    # dst nodes with a live handshake

    def pairs(self):
        return [(self.src, d) for d in sorted(self.peers)]


class DCTTarget(Connection):
    """One DC target context at ``dst``: a single slot serving every
    initiator (``initiators`` is the reverse index used to invalidate
    peers' handshakes when this slot is evicted)."""

    kind = "tgt"

    __slots__ = ("dst", "initiators")

    def __init__(self, backend: str, dst: str):
        super().__init__(backend, (backend, "tgt", dst), (dst,))
        self.dst = dst
        self.initiators: Set[str] = set()

    def pairs(self):
        return [(s, self.dst) for s in sorted(self.initiators)]
