"""Transport — the pluggable data-plane interface (§5.3, Fig. 18 ablation).

MITOSIS's core claim is that remote-fork speed comes from the *choice* of
data path: one-sided RDMA reads vs two-sided RPC vs distributed-FS
checkpoints.  A ``Transport`` makes that choice a first-class, name-keyed
object instead of string flags scattered through the data plane.  One
interface sits behind all three traffic classes:

``read_pages``   one VMA page gather out of the owner pool (paging fast path)
``read_blob``    an opaque blob fetch (descriptor transfer)
``rpc``          a two-sided call executed by the destination (control plane,
                 fallback daemon, message baselines)

Every backend declares capability flags (``one_sided``: reads bypass the
owner's CPU, like an RNIC/DMA engine; ``connection_oriented``: pays a
per-(src, dst) setup cost) and derives its per-op latency and per-byte
bandwidth from the shared :class:`~repro_torch.net.model.NetModel`.  Access
control is identical across backends: every read — page or descriptor —
is admitted iff its DC key is a live target at the network, so a reclaimed
seed is unreadable over *any* fabric, not just RDMA.

Metering is aggregated at the :class:`~repro_torch.net.network.Network` but tagged
per backend: each op charges ``{name}.bytes`` / ``{name}.ops`` (plus
``{name}.setups`` / ``{name}.setup_s`` for connection-oriented backends, and
``{name}.sges`` / ``{name}.async_ops`` on the paging path) alongside the
legacy category aggregates (``rdma_*``, ``rpc_*``, ``ici_*``, ``dfs_*``)
that benchmarks and examples report.

Page reads are *doorbell-batched*: the frame list is split into maximal
contiguous runs (one scatter-gather entry each), and one posted op carries
up to ``max_sge`` runs — so fragmentation and tiny faults show up in
``sim_time`` while extent-packed VMAs move in a handful of ops (see
``docs/paging.md``).

Registering a custom backend::

    from repro_torch.net import Transport, register_transport

    @register_transport
    class CxlTransport(Transport):
        name = "cxl"
        one_sided = True
        legacy_meter = "rdma"
        def op_latency(self):  return 300e-9
        def bandwidth(self):   return 64e9

``Network(transport="cxl")`` / ``ForkPolicy(page_fetch="cxl")`` then resolve
it by name; unknown names raise ``ValueError`` listing what is registered.
"""
from __future__ import annotations

import abc
import math
from typing import ClassVar, Dict, List, Optional, Type

import numpy as np

from repro_torch.net.errors import RetriesExhausted


_REGISTRY: Dict[str, Type["Transport"]] = {}


def contiguous_runs(frames) -> int:
    """Number of maximal contiguous ascending runs in ``frames`` — the
    scatter-gather entry (SGE) count a doorbell-batched read needs.  A
    fully contiguous gather is 1 run; a fully scattered one is len(frames)."""
    idx = np.asarray(frames, np.int64).ravel()
    if idx.size == 0:
        return 0
    return 1 + int(np.count_nonzero(np.diff(idx) != 1))


def register_transport(cls: Type["Transport"]) -> Type["Transport"]:
    """Class decorator: key ``cls`` by its ``name`` in the global registry.
    The required ClassVars are checked here so a malformed backend fails at
    registration, not deep inside its first resume_on."""
    name = getattr(cls, "name", None)
    if not isinstance(name, str) or not name:
        raise ValueError(f"transport class {cls!r} must define a `name` string")
    if not isinstance(getattr(cls, "one_sided", None), bool):
        raise ValueError(
            f"transport {name!r} must define the `one_sided` bool ClassVar")
    if not isinstance(getattr(cls, "legacy_meter", None), str):
        raise ValueError(
            f"transport {name!r} must define the `legacy_meter` str ClassVar "
            "(aggregate category, e.g. 'rdma' or 'rpc')")
    max_sge = getattr(cls, "max_sge", None)
    if not isinstance(max_sge, int) or isinstance(max_sge, bool) or max_sge < 1:
        raise ValueError(
            f"transport {name!r} must define `max_sge` as an int >= 1 "
            f"(scatter-gather entries per doorbell op), got {max_sge!r}")
    kind = getattr(cls, "conn_kind", None)
    if getattr(cls, "connection_oriented", False):
        if kind not in ("peer", "dc"):
            raise ValueError(
                f"connection-oriented transport {name!r} must declare "
                f"`conn_kind` as 'peer' (per-pair QP, slots at both "
                f"endpoints) or 'dc' (one initiator/target context per "
                f"node), got {kind!r}")
    elif kind is not None:
        raise ValueError(
            f"connectionless transport {name!r} must leave `conn_kind` as "
            f"None, got {kind!r}")
    _REGISTRY[name] = cls
    return cls


def transport_names() -> List[str]:
    """Sorted names of every registered transport backend."""
    return sorted(_REGISTRY)


def resolve_transport(name: str) -> Type["Transport"]:
    """Look a backend class up by name; unknown names fail loudly."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown transport {name!r}; registered transports: "
            f"{', '.join(transport_names())}") from None


class Transport(abc.ABC):
    """One data-plane fabric: cost model + data movement + capability flags.

    Instances are created per :class:`Network` (``net.transport_obj(name)``)
    and charge all traffic back into the network's meter/sim clock.
    """

    name: ClassVar[str]
    one_sided: ClassVar[bool]                  # reads bypass the owner's CPU
    connection_oriented: ClassVar[bool] = False  # pays setup per (src, dst)
    # pool shape for connection-oriented fabrics: "peer" = one QP per
    # (src, dst) occupying a slot at BOTH endpoints (RC); "dc" = one
    # initiator context per src + one target context per dst, each a
    # single slot shared across every peer (DCT).  None = connectionless.
    conn_kind: ClassVar[Optional[str]] = None
    legacy_meter: ClassVar[str]                # aggregate category: rdma|rpc|ici|dfs
    max_sge: ClassVar[int] = 16                # SGEs per doorbell-batched op
    # how many times one op is re-posted after a timeout before the backend
    # surfaces RetriesExhausted; 0 = fail over immediately (the rpc path's
    # "fall back" semantics).  Only consulted when a FaultInjector is
    # installed on the network — the fault-free path never checks.
    max_retries: ClassVar[int] = 2

    def __init__(self, net):
        self.net = net
        self.model = net.model

    # -- cost model ---------------------------------------------------------

    def setup_cost(self) -> float:
        """Seconds to bring up one (src, dst) connection (0 = connectionless)."""
        return 0.0

    @abc.abstractmethod
    def op_latency(self) -> float:
        """Seconds of fixed latency per read op."""

    @abc.abstractmethod
    def bandwidth(self) -> float:
        """Bytes/second for bulk payload movement."""

    def rpc_latency(self) -> float:
        """Seconds of fixed latency per two-sided round trip."""
        return self.model.rpc_lat

    # -- fault plane --------------------------------------------------------

    def op_timeout(self) -> float:
        """Seconds one attempt holds its lane before it is declared lost."""
        return self.model.op_timeout_s

    def _penalty(self, src: str, dst: str) -> float:
        """Degradation multiplier (>= 1.0) on this transfer's wire time —
        1.0 exactly when no fault injector is installed or neither endpoint
        NIC is degraded, so the fault-free cost model is bit-identical."""
        inj = self.net.faults
        if inj is None:
            return 1.0
        return inj.penalty(src, dst)

    def _admit(self, op: str, src: str, dst: str, sync: bool = True) -> None:
        """Fault-injection gate ahead of every data-plane op.

        No-op without an installed injector.  A faulted attempt models an
        initiator-side completion timeout: the op held a lane at both
        endpoints for ``NetModel.op_timeout_s`` moving ZERO payload bytes
        (metered ``{name}.timeouts``), then — for per-pair fabrics (RC) —
        the QP transitioned to the error state, so the connection is torn
        down and the retry re-pays establishment through the pool, charged
        on the link clock by ``_setup`` like any cold pair.  Between
        attempts the initiator backs off linearly
        (``attempt * retry_backoff_s``, metered ``backoff_wait_s``); after
        ``max_retries`` re-posts the backend gives up with a typed
        :class:`RetriesExhausted`.  Async callers meter identically but
        never block the sim clock (their issue loop absorbs the failure)."""
        inj = self.net.faults
        if inj is None:
            return
        net = self.net
        meter = net.meter
        san = net.sanitizer
        # SimSan: faulted attempts hold lanes but move ZERO payload bytes
        bytes_before = meter.get(f"{self.name}.bytes", 0) \
            if san is not None else 0
        attempt = 0
        while inj.op_fault(self.name, op, src, dst):
            attempt += 1
            meter["timeouts"] += 1
            meter[f"{self.name}.timeouts"] += 1
            if sync:
                timeout = self.op_timeout()
                start = max(net.sim_time, net.link_free(src),
                            net.link_free(dst))
                end = start + timeout
                if san is not None:
                    opdesc = f"{self.name} {op} timeout {src}->{dst}"
                    san.link_hold(src, start, end, opdesc)
                    if dst != src:
                        san.link_hold(dst, start, end, opdesc)
                net.occupy_link(src, end)
                if dst != src:
                    net.occupy_link(dst, end)
                net.sim_time = end
            if self.conn_kind == "peer":
                net.conns.fault_pair(self.name, src, dst)
            if san is not None:
                san.retry_conserved(
                    self.name, bytes_before,
                    f"{self.name} {op} retry {src}->{dst}")
            if attempt > self.max_retries:
                raise RetriesExhausted(
                    f"{self.name} {op} {src}->{dst}: "
                    f"{attempt} attempt(s) timed out")
            meter["retries"] += 1
            meter[f"{self.name}.retries"] += 1
            backoff = self.model.retry_backoff_s * attempt
            if sync and backoff > 0:
                meter["backoff_wait_s"] += backoff
                net.sim_time += backoff

    # -- data plane ---------------------------------------------------------

    def read_pages(self, src: str, dst: str, dtype, frames, dc_key: int,
                   async_read: bool = False, user: Optional[str] = None):
        """Read ``frames`` out of dst's pool.  Admitted iff (dst, dc_key) is
        a live DC target — revoking the target kills access on EVERY backend.

        The gather is doorbell-batched: each maximal contiguous frame run is
        one scatter-gather entry, and one posted op carries up to ``max_sge``
        of them — so a contiguous 64-page fault is ONE op while 64 scattered
        pages cost ``ceil(64/max_sge)`` ops plus 64 SGEs.  ``async_read=True``
        occupies the (src, dst) channel without blocking the sim clock; the
        caller learns the completion time from ``net.channel_busy(src, dst)``
        and waits only when it actually needs the pages (overlap, rFaaS-style).
        """
        node = self.net.require_node(dst)
        self.net.check_target(dst, dc_key)
        # the fault gate: times out / retries / raises typed BEFORE any
        # payload byte is charged, so a failed read moves nothing (and an
        # RC timeout tears the pair down so _setup below re-pays it)
        self._admit("read", src, dst, sync=not async_read)
        # an async read must not stall the child's clock on a cold
        # connection: the setup cost is folded into the transfer's channel
        # time instead of charged to sim_time (the sync path pays it up
        # front, exactly as before)
        setup = self._setup(src, dst, defer=async_read, user=user)
        # the wire payload is HOST memory (the RNIC DMAs physical frames);
        # device materialization happens at tensor assembly, not per fault
        pages = node.pool.read_pages_host(dtype, frames)
        nbytes = pages.size * pages.dtype.itemsize
        sges = contiguous_runs(frames)
        ops = max(1, math.ceil(sges / self.max_sge))
        seconds = ops * self.op_latency() + nbytes / self.bandwidth()
        seconds *= self._penalty(src, dst)
        self.net.meter["page_pages_moved"] += int(np.asarray(frames).size)
        self._charge("read", src, dst, nbytes, seconds,
                     ops=ops, sges=sges, async_read=async_read, setup=setup)
        san = self.net.sanitizer
        if san is not None:
            # the wire payload must reach PagePool.write_pages whole —
            # the adopter (ModelInstance._adopt_pages) closes this tag
            san.tag_payload(pages, self.name, rows=int(pages.shape[0]),
                            nbytes=nbytes)
        return pages

    def read_blob(self, src: str, dst: str, nbytes: int, dc_key: int,
                  user: Optional[str] = None) -> None:
        """Metered fetch of an opaque blob (descriptor transfer).  Guarded by
        the blob's own DC key, exactly like a VMA."""
        self.net.require_node(dst)
        self.net.check_target(dst, dc_key)
        self._admit("read", src, dst)
        self._setup(src, dst, user=user)
        self._charge("read", src, dst, nbytes,
                     (self.op_latency() + nbytes / self.bandwidth())
                     * self._penalty(src, dst))

    def rpc(self, src: str, dst: str, nbytes: int, fn, *args, **kwargs):
        """Two-sided call executed by the destination node (FaSST-style).
        Connection-oriented backends acquire the (src, dst) connection
        from the pool here too — a two-sided call over RC still rides a
        QP, so the control plane can no longer get free connections the
        data plane would have had to pay for."""
        self.net.require_node(dst)
        self._admit("rpc", src, dst)
        self._setup(src, dst)
        self._charge("rpc", src, dst, nbytes,
                     (self.rpc_latency() + nbytes / self.bandwidth())
                     * self._penalty(src, dst))
        return fn(*args, **kwargs)

    # -- metering -----------------------------------------------------------

    def _setup(self, src: str, dst: str, defer: bool = False,
               user: Optional[str] = None) -> float:
        """Acquire the (src, dst) connection from the pool, paying the
        establishment cost if it is still owed.

        The pool (``net.conns``) decides whether a handshake is needed:
        a warm slot (RC reuse, DCT amortization, sibling sharing) costs
        nothing; a cold or evicted path owes the backend's setup cost and
        the pair is re-admitted (possibly evicting an LRU slot under
        ``NetModel.conn_cap``).

        A synchronous caller is clocked here (``defer=False``, returns
        0.0): establishment is a control-plane exchange on the wire, so
        it occupies a link lane at both endpoints — a setup storm queues
        on the NIC like payload traffic — and any stall behind busy lanes
        is metered as ``channel_wait_s``.  An async caller gets the owed
        seconds back instead (``defer=True``) and folds them into the
        transfer's channel time — a cold connection must not stall the
        clock the async path exists to keep moving.  Metering is
        identical either way."""
        if not self.connection_oriented:
            return 0.0
        net = self.net
        owed = net.conns.acquire(self, src, dst, user=user)
        if owed is None:
            return 0.0
        meter = net.meter
        meter["conn_setups"] += 1
        meter[f"{self.name}.setups"] += 1
        meter[f"{self.name}.setup_s"] += owed
        if defer:
            return owed
        start = max(net.sim_time, net.link_free(src), net.link_free(dst))
        end = start + owed
        san = net.sanitizer
        if san is not None:
            opdesc = f"{self.name} setup {src}->{dst}"
            san.link_hold(src, start, end, opdesc)
            if dst != src:
                san.link_hold(dst, start, end, opdesc)
        net.occupy_link(src, end)
        if dst != src:
            net.occupy_link(dst, end)
        net.note_conn_busy(src, end)
        net.note_conn_busy(dst, end)
        if start > net.sim_time:
            meter["channel_wait_s"] += start - net.sim_time
        net.sim_time = end
        return 0.0

    def _charge(self, kind: str, src: str, dst: str, nbytes: int,
                seconds: float, ops: int = 1, sges: Optional[int] = None,
                async_read: bool = False, setup: float = 0.0) -> float:
        """Meter one transfer and account its time on the (src, dst) channel
        and both endpoints' links.

        The transfer starts when the caller (sim clock), the channel AND a
        link lane at each endpoint are all free — per-node link capacity
        (``NetModel.node_links``) is a clocked resource, so a K-way fan-in
        visibly queues on the parent NIC instead of overlapping for free.
        A synchronous charge blocks the sim clock to the completion and
        meters any stall behind a busy channel/link as ``channel_wait_s``;
        an async charge leaves the clock alone.  ``setup`` is deferred
        connection-setup time (async cold connections) served ahead of the
        payload on the same channel.  Returns the completion time."""
        net = self.net
        meter = net.meter
        meter[f"{self.name}.bytes"] += nbytes
        meter[f"{self.name}.ops"] += ops
        if sges is not None:        # page reads only — blob/rpc have no SGEs
            meter[f"{self.name}.sges"] += sges
        category = "rpc" if kind == "rpc" else self.legacy_meter
        meter[f"{category}_bytes"] += nbytes
        meter[f"{category}_ops"] += ops
        start = max(net.sim_time, net.channel_busy(src, dst),
                    net.link_free(src), net.link_free(dst))
        end = start + setup + seconds
        san = net.sanitizer
        if san is not None:
            opdesc = f"{self.name} {kind} {src}->{dst}"
            san.channel_hold(src, dst, start, end, opdesc)
            san.link_hold(src, start, end, opdesc)
            if dst != src:
                san.link_hold(dst, start, end, opdesc)
            san.charged(self.name, nbytes, opdesc)
        if setup > 0:
            # deferred establishment rides the channel ahead of the
            # payload: stamp it on both endpoints' conn-backlog clocks so
            # setup-aware schedulers see the in-flight handshake
            net.note_conn_busy(src, start + setup)
            net.note_conn_busy(dst, start + setup)
        net.set_channel_busy(src, dst, end)
        net.occupy_link(src, end)
        if dst != src:
            net.occupy_link(dst, end)
        net.account_node_busy(src, dst, seconds)
        if async_read:
            meter[f"{self.name}.async_ops"] += ops
        else:
            if start > net.sim_time:
                # the caller's stall behind a busy channel or link — fan-in
                # queueing at a hot parent surfaces here, not just in
                # async_wait_s (which only meters explicit wait_until)
                meter["channel_wait_s"] += start - net.sim_time
            net.sim_time = end
        return end
