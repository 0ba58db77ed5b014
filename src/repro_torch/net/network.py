"""Network — a thin router over the transport registry.

The network now owns exactly three things:

* **membership** — which nodes are up (``register`` / ``unregister``);
* **DC-target access control** — the (node, key) registry every read is
  admitted against, one key per VMA *and per descriptor blob*;
* **meter aggregation** — one Counter + sim clock that all transports
  charge into, with per-backend ``{name}.bytes`` / ``{name}.ops`` keys next
  to the legacy category aggregates.

All data movement dispatches through a named :class:`~repro_torch.net.transport.
Transport` from the registry: ``read_pages`` (paging fast path),
``read_blob`` (descriptor fetch) and ``rpc`` (two-sided control plane /
fallback daemon).  ``transport=None`` means the network's default backend.
"""
from __future__ import annotations

from collections import Counter
from typing import Dict, Optional

from repro_torch.analysis import simsan
from repro_torch.net import backends as _backends   # noqa: F401  (registers built-ins)
from repro_torch.net.conn import ConnManager
from repro_torch.net.errors import AccessRevoked, NodeDown
from repro_torch.net.model import NetModel
from repro_torch.net.transport import Transport, resolve_transport, transport_names


class Network:
    def __init__(self, model: Optional[NetModel] = None, transport: str = "dct",
                 sanitize: Optional[bool] = None):
        resolve_transport(transport)        # unknown name -> ValueError
        self.model = model or NetModel()
        self.transport = transport          # default backend name
        self.nodes: Dict[str, "object"] = {}
        self.meter = Counter()
        self.sim_time = 0.0
        self._transports: Dict[str, Transport] = {}
        # the connection control plane: bounded per-node pools of typed
        # connection objects (RC per-peer QPs vs DCT contexts), LRU
        # eviction under NetModel.conn_cap, sibling sharing via per-user
        # refcounts — see repro_torch.net.conn / docs/connection.md
        self.conns = ConnManager(self)
        # per-node establishment busy-until stamps: how far ahead of the
        # clock each node's control plane is committed (conn_backlog)
        self._conn_busy: Dict[str, float] = {}
        # per-(src, dst) channel busy-until timestamps: overlapped (async)
        # transfers serialize against each other on their channel, not
        # against the sim clock
        self._channel_busy: Dict[tuple, float] = {}
        # per-node link lanes (model.node_links busy-until stamps): a
        # transfer holds one lane at EACH endpoint, so K children gathering
        # from one parent queue on the parent NIC in sim_time itself — the
        # contention the node_busy ledger only recorded passively
        self._link_busy: Dict[str, list] = {}
        # per-node cumulative link occupancy (seconds of wire time on either
        # end of a transfer): the parent-NIC contention ledger that fan-out
        # benchmarks and the transport-aware scheduler read
        self._node_busy: Counter = Counter()
        # DC targets: (node_id, dc_key) -> True while valid
        self._dc_targets: Dict[tuple, bool] = {}
        self._next_key = 1
        # fault plane: a repro_torch.sim.faults.FaultInjector when a replay (or
        # test) installs one; None on the fault-free path, in which case
        # transports skip every fault check and charge identically to a
        # pre-fault-plane build (digest-stable by construction)
        self.faults = None
        # SimSan: the opt-in runtime invariant sanitizer (lane/channel
        # monotonicity, meter conservation, conn-pool consistency, lease
        # edges).  None by default — every hook in the data plane sits
        # behind a None guard, mirroring the fault plane's pattern — and a
        # sanitized run of a correct build is digest-identical because the
        # sanitizer only reads.  ``sanitize=None`` defers to REPRO_SIMSAN.
        if sanitize is None:
            sanitize = simsan.enabled()
        self.sanitizer = simsan.Sanitizer(self) if sanitize else None

    # -- transport registry ----------------------------------------------------

    def transport_obj(self, name: Optional[str] = None) -> Transport:
        """The (lazily instantiated) backend for ``name`` (None = default)."""
        name = name or self.transport
        t = self._transports.get(name)
        if t is None:
            t = resolve_transport(name)(self)
            self._transports[name] = t
        return t

    # -- membership -----------------------------------------------------------

    def register(self, node) -> None:
        self.nodes[node.node_id] = node
        if self.sanitizer is not None:
            # a (re-)registered node is a fresh incarnation for the
            # exactly-once parent_lost accounting
            self.sanitizer.node_registered(node.node_id)

    def unregister(self, node_id: str) -> None:
        self.nodes.pop(node_id, None)
        for k in [k for k in self._dc_targets if k[0] == node_id]:
            del self._dc_targets[k]
        # the node's connection table dies with it: every QP/DC context
        # holding a slot there is torn down and peers re-pay setup
        self.conns.drop_node(node_id)

    def require_node(self, node_id: str):
        node = self.nodes.get(node_id)
        if node is None:
            raise NodeDown(f"node {node_id} is down")
        return node

    def drop_cached_frames(self, owner: str, dtype: str, frames) -> None:
        """Broadcast sibling-cache invalidation: ``owner`` is freeing these
        frames, so every node must forget (owner, dtype, frame) entries —
        the reused frame indices would otherwise serve stale data.  Modeled
        as free kernel-level coherence traffic (unmetered)."""
        for node in self.nodes.values():
            drop = getattr(node, "page_cache_drop_owner_frames", None)
            if drop is not None:
                drop(owner, dtype, frames)

    # -- DC targets (access control) -------------------------------------------

    def create_dc_target(self, node_id: str) -> int:
        """Allocate a DC key guarding one VMA or blob (paper: 12 B child-side)."""
        key = self._next_key
        self._next_key += 1
        self._dc_targets[(node_id, key)] = True
        self.meter["dc_targets"] += 1
        return key

    def destroy_dc_target(self, node_id: str, key: int) -> None:
        self._dc_targets.pop((node_id, key), None)

    def target_valid(self, node_id: str, key: int) -> bool:
        return self._dc_targets.get((node_id, key), False)

    def check_target(self, node_id: str, key: int) -> None:
        if not self.target_valid(node_id, key):
            raise AccessRevoked(f"DC target {key}@{node_id} destroyed")

    # -- channel busy-time accounting (transfer/execution overlap) ---------------

    def channel_busy(self, src: str, dst: str) -> float:
        """Absolute sim time until which the (src, dst) channel is occupied.
        Right after an async read this is that transfer's completion time."""
        return self._channel_busy.get((src, dst), 0.0)

    def set_channel_busy(self, src: str, dst: str, until: float) -> None:
        self._channel_busy[(src, dst)] = until

    def channel_backlog(self, src: str, dst: str) -> float:
        """Seconds of queued transfer still ahead of ``sim_time`` on the
        (src, dst) channel — the load signal schedulers weigh."""
        return max(0.0, self.channel_busy(src, dst) - self.sim_time)

    # -- per-node link capacity (the contention *clock*) -------------------------

    def _lanes(self, node_id: str) -> list:
        lanes = self._link_busy.get(node_id)
        if lanes is None:
            lanes = self._link_busy[node_id] = [0.0] * self.model.node_links
        return lanes

    def link_free(self, node_id: str) -> float:
        """Absolute sim time at which ``node_id``'s NIC next has a free
        lane.  With the link clock disabled (``node_links <= 0``) this is
        always 0.0 — transfers serialize per channel only."""
        if self.model.node_links <= 0:
            return 0.0
        lanes = self._link_busy.get(node_id)
        return min(lanes) if lanes else 0.0

    def link_busy_until(self, node_id: str) -> float:
        """Absolute sim time at which ``node_id``'s NIC drains completely
        (its LAST busy lane) — the fan-in makespan stamp.  Equal to
        ``link_free`` at ``node_links=1``; with wider links the two
        diverge (next-free lane vs last-busy lane).  0.0 while the link
        clock is disabled."""
        if self.model.node_links <= 0:
            return 0.0
        lanes = self._link_busy.get(node_id)
        return max(lanes) if lanes else 0.0

    def link_backlog(self, node_id: str) -> float:
        """Seconds of queued wire time ahead of ``sim_time`` on ``node_id``'s
        link — the hot-spot signal the Router and schedulers act on."""
        return max(0.0, self.link_free(node_id) - self.sim_time)

    def backlog_snapshot(self) -> Dict[str, float]:
        """{node_id: seconds of queued wire time} for every node that has a
        lane ledger — the per-node hot-spot view replay timelines sample.
        Nodes that never moved a byte have no ledger and are omitted (the
        lane dicts are lazy precisely so fleet-scale clusters stay cheap)."""
        return {nid: self.link_backlog(nid) for nid in self._link_busy}

    def occupy_link(self, node_id: str, until: float) -> None:
        """Hold ``node_id``'s earliest-free lane until ``until`` (absolute).
        Transports call this for both endpoints of every transfer; a no-op
        while the link clock is disabled."""
        if self.model.node_links <= 0:
            return
        lanes = self._lanes(node_id)
        i = min(range(len(lanes)), key=lanes.__getitem__)
        if until > lanes[i]:
            lanes[i] = until

    def account_node_busy(self, src: str, dst: str, seconds: float) -> None:
        """Charge ``seconds`` of wire occupancy to both endpoints' links.
        Summed per node this is the NIC-time ledger: a parent serving a
        K-way fan-out accumulates the whole working set here while each
        child accumulates only its own share."""
        self._node_busy[src] += seconds
        self._node_busy[dst] += seconds

    def node_busy(self, node_id: str) -> float:
        """Cumulative link-busy seconds charged to ``node_id`` since the
        last ``reset_meter``."""
        return self._node_busy.get(node_id, 0.0)

    def advance(self, seconds: float) -> None:
        """Model ``seconds`` of child-side *execution* on the critical path.
        Channel busy-until stamps are absolute, so in-flight async transfers
        keep draining while the clock moves — this is where overlap pays."""
        if seconds > 0:
            self.sim_time += seconds

    def wait_until(self, t: float) -> None:
        """Block the sim clock until ``t`` (awaiting an async completion);
        time already covered by execution costs nothing extra."""
        if t > self.sim_time:
            self.meter["async_wait_s"] += t - self.sim_time
            self.sim_time = t

    # -- connections (the clocked control plane) --------------------------------

    def note_connection(self, transport: str, src: str, dst: str) -> bool:
        """Admit the (src, dst) pair into the pools warm, without charging
        the clock (an externally established connection); True if it was
        new.  Tests and warm-import paths use this to pre-pay setup."""
        return self.conns.acquire(self.transport_obj(transport),
                                  src, dst) is not None

    def has_connection(self, transport: str, src: str, dst: str) -> bool:
        """True iff the (src, dst) path over ``transport`` is warm in the
        pools *right now* — observed state, so an LRU-evicted pair reads
        False again (and ``setup_owed`` prices its re-establishment)."""
        return self.conns.has(transport, src, dst)

    def setup_owed(self, transport: str, src: str, dst: str) -> float:
        """Seconds the next (src, dst) op over ``transport`` will owe for
        connection establishment, from observed pool state — what the
        transport-aware scheduler and Router charge a candidate."""
        return self.conns.setup_owed(transport or self.transport, src, dst)

    def conn_release_user(self, user: str) -> None:
        """Release every connection reference ``user`` (an instance)
        holds: warm slots survive but become first in line for LRU
        eviction under ``NetModel.conn_cap``."""
        self.conns.release_user(user)

    def reset_connections(self) -> None:
        """Forget all connection state (tests/diagnostics): every pair
        re-pays setup as if never connected."""
        self.conns.reset()

    def note_conn_busy(self, node_id: str, until: float) -> None:
        """Stamp ``node_id``'s control plane busy until ``until`` —
        establishment work committed ahead of (or at) the clock."""
        if until > self._conn_busy.get(node_id, 0.0):
            self._conn_busy[node_id] = until

    def conn_backlog(self, node_id: str) -> float:
        """Seconds of connection-establishment work still ahead of
        ``sim_time`` at ``node_id`` — the setup-storm signal setup-aware
        placement scores alongside ``link_backlog``."""
        return max(0.0, self._conn_busy.get(node_id, 0.0) - self.sim_time)

    # -- data plane ---------------------------------------------------------------

    def read_pages(self, src: str, dst: str, dtype, frames, dc_key: int,
                   transport: Optional[str] = None, async_read: bool = False,
                   user: Optional[str] = None):
        """Read of `frames` from dst's pool over the named backend.
        ``async_read=True`` issues the read without blocking the sim clock
        (it occupies the channel; completion = ``channel_busy(src, dst)``).
        ``user`` (an instance identity) takes a refcount on the connection
        so siblings on one node share a warm slot until freed."""
        return self.transport_obj(transport).read_pages(
            src, dst, dtype, frames, dc_key, async_read=async_read,
            user=user)

    def read_blob(self, src: str, dst: str, nbytes: int, dc_key: int,
                  transport: Optional[str] = None,
                  user: Optional[str] = None) -> None:
        """Metered blob fetch (descriptor transfer), DC-key guarded."""
        return self.transport_obj(transport).read_blob(src, dst, nbytes,
                                                       dc_key, user=user)

    def rpc(self, src: str, dst: str, nbytes: int, fn, *args,
            transport: Optional[str] = None, **kwargs):
        """Two-sided RPC executed by the destination node (FaSST-style)."""
        return self.transport_obj(transport).rpc(src, dst, nbytes, fn,
                                                 *args, **kwargs)

    # -- reporting -----------------------------------------------------------------

    def snapshot(self) -> dict:
        return dict(self.meter) | {"sim_time": self.sim_time}

    def per_backend(self) -> Dict[str, dict]:
        """{backend: {bytes, ops, sges, async_ops, setups, setup_s,
        conn_live, conn_evicted, conn_reestablished}} for every registered
        backend (zeros for backends this network never used).
        ``conn_live`` is observed pool state (slots currently held);
        the churn counters accumulate since the last ``reset_meter``."""
        out: Dict[str, dict] = {}
        for name in transport_names():
            out[name] = {k: self.meter.get(f"{name}.{k}", 0)
                         for k in ("bytes", "ops", "sges", "async_ops",
                                   "setups", "setup_s", "conn_evicted",
                                   "conn_reestablished")}
            out[name]["conn_live"] = self.conns.live(name)
        return out

    def reset_meter(self) -> None:
        self.meter.clear()
        if self.sanitizer is not None:
            self.sanitizer.reset_meters()   # the shadow ledger follows
        self.sim_time = 0.0
        self._channel_busy.clear()   # busy stamps are absolute on the clock
        self._link_busy.clear()
        self._node_busy.clear()
        self._conn_busy.clear()      # ...and so are establishment stamps
        # NOTE: connection pools survive a meter reset on purpose (warm
        # state is not a meter); use reset_connections() to forget them
