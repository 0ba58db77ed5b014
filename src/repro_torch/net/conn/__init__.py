"""repro_torch.net.conn — the clocked connection control plane.

Swift (arxiv 2501.19051) argues the RDMA *control plane* — connection
establishment — is the real bottleneck of elastic computing: a 10k-child
fan-out over RC pays a QP connect per (child, parent) pair, while DCT
amortizes one initiator context across every peer.  This package makes
that cost structural instead of a scalar: typed connection objects
(:class:`RCConnection` vs :class:`DCTInitiator`/:class:`DCTTarget`) live
in bounded per-node :class:`ConnPool` tables with LRU eviction, sibling
children *share* a warm connection through per-user refcounts, and every
establishment is charged on the link clock — a setup storm queues on the
NIC like any other traffic.  See ``docs/connection.md``.
"""
from repro_torch.net.conn.types import (Connection, DCTInitiator, DCTTarget,
                                  RCConnection)
from repro_torch.net.conn.pool import ConnManager, ConnPool

__all__ = [
    "Connection",
    "RCConnection",
    "DCTInitiator",
    "DCTTarget",
    "ConnPool",
    "ConnManager",
]
