"""SimSan — opt-in runtime invariant sanitizer for the replay stack.

Every pinned result in this repo (fig20's p99 win, the fault plane's
digest-identical replays, the conn-pool byte invariants) rests on a small
set of conservation and monotonicity invariants that nothing used to
check at runtime:

* **clock/lane monotonicity** — per-node link-lane reservations never
  overlap beyond the NIC's lane count, and the absolute busy-until stamps
  (``channel_busy``, ``link_free``) only move forward;
* **meter conservation** — per-backend ``{name}.bytes`` exactly equals
  the payload bytes the transports charged (a shadow ledger), faulted
  retries move zero payload, and every transport-returned page payload is
  handed to ``PagePool.write_pages`` whole (no rows dropped or doubled);
* **connection-pool consistency** — pool slots and the manager's live
  table agree bidirectionally, refcount indices never dangle, evicted
  QPs are never touched again, and bounded pools respect their cap;
* **lease state machine** — seeds move only along legal edges
  (register -> renew/revoke* -> reclaim, with crash killing a node's
  whole registry), and a lost parent is telemetered as ``parent_lost``
  exactly once per (function, node) incarnation.

The sanitizer is wired into the existing chokepoints behind ``None``
guards, mirroring the fault plane's ``net.faults`` pattern: with it off
(the default) the data plane runs byte-identically to a pre-SimSan
build.  Turn it on with ``REPRO_SIMSAN=1`` in the environment or
``Network(sanitize=True)``; violations raise :class:`SanitizerError`
with the violating op's full context.  A sanitized replay of a correct
build is digest-identical to an unsanitized one — the sanitizer only
reads, it never perturbs the clock or the meters (``BENCH_faults.json``
pins this for fig22's storm row).

This module deliberately imports nothing from ``repro_torch.net`` /
``repro_torch.sim`` (the network imports *us*), so it can sit underneath the
whole stack without an import cycle.
"""
from __future__ import annotations

import contextlib
import os
from typing import Any, Dict, Iterator, List, Optional, Set, Tuple

# float slop for comparing absolute sim-time stamps: resource math is
# sums/maxes of small floats, so equality checks get one ulp-ish margin
EPS = 1e-9

_ENV = "REPRO_SIMSAN"


def enabled() -> bool:
    """True iff the environment opts into sanitized runs
    (``REPRO_SIMSAN=1`` / ``true`` / ``yes`` / ``on``)."""
    return os.environ.get(_ENV, "").strip().lower() in (
        "1", "true", "yes", "on")


class SanitizerError(AssertionError):
    """A runtime invariant violation, carrying the violating op's context.

    ``check`` names the invariant (e.g. ``lane-overlap``, ``meter-drift``,
    ``lease-edge``); ``op`` describes the operation that tripped it;
    ``context`` holds every value the check compared, so the message is a
    complete bug report on its own.
    """

    def __init__(self, check: str, op: str, **context: Any):
        self.check = check
        self.op = op
        self.context = context
        ctx = " ".join(f"{k}={v!r}" for k, v in context.items())
        super().__init__(f"[simsan:{check}] {op}" + (f" ({ctx})" if ctx else ""))


class Sanitizer:
    """All SimSan state for one Network.  Install via
    ``Network(sanitize=True)`` (or ``REPRO_SIMSAN=1``); every hook is a
    no-op path in the instrumented code when the network's ``sanitizer``
    is None."""

    def __init__(self, net):
        self.net = net
        self.checks = 0             # checks performed (deterministic count)
        # shadow of the per-backend {name}.bytes meter keys: only the
        # transports' _charge writes them, so the shadow must track exactly
        self._shadow_bytes: Dict[str, float] = {}
        # transport-returned page payloads awaiting adoption:
        # id(arr) -> (arr, backend, rows, nbytes).  The strong reference
        # pins the array so a recycled id can never alias a stale tag;
        # prefetch payloads that are discarded unadopted simply stay until
        # the sanitizer is dropped with its network.
        self._payloads: Dict[int, Tuple[Any, str, int, int]] = {}
        # lease registry state: (node_id, handler_id) -> "live" | "reclaimed"
        self._leases: Dict[Tuple[str, int], str] = {}
        # parent_lost accounting: node -> funcs already counted for this
        # incarnation of the node (cleared when the node re-registers)
        self._lost: Dict[str, Set[str]] = {}
        # >0 while inside a multi-step teardown whose intermediate states
        # are deliberately inconsistent (see ``bulk``)
        self._suspended = 0

    @contextlib.contextmanager
    def bulk(self) -> Iterator[None]:
        """Suspend per-mutation connection scans across a cascade (e.g.
        ``drop_node`` pops the pool first, then evicts its conns one by
        one): the caller re-runs ``check_conns`` once at the end, so only
        the intermediate states are exempt."""
        self._suspended += 1
        try:
            yield
        finally:
            self._suspended -= 1

    # -- clock / lane monotonicity ------------------------------------------

    def link_hold(self, node_id: str, start: float, end: float,
                  op: str) -> None:
        """A transport is about to hold one of ``node_id``'s link lanes
        for [start, end].  Legal iff the hold has non-negative duration
        and starts no earlier than the node's earliest-free lane — an
        earlier start would overlap a reservation on EVERY lane, i.e. the
        caller skipped the ``link_free`` term of its start max()."""
        self.checks += 1
        if end < start - EPS:
            raise SanitizerError("negative-hold", op, node=node_id,
                                 start=start, end=end)
        free = self.net.link_free(node_id)
        if start < free - EPS:
            raise SanitizerError(
                "lane-overlap", op, node=node_id, start=start, end=end,
                earliest_free_lane=free,
                lanes=self.net.model.node_links)

    def channel_hold(self, src: str, dst: str, start: float, end: float,
                     op: str) -> None:
        """A transfer is about to occupy the (src, dst) channel for
        [start, end]: it must start at/after the channel's current
        busy-until stamp (channels serialize) and never move it backward."""
        self.checks += 1
        busy = self.net.channel_busy(src, dst)
        if start < busy - EPS:
            raise SanitizerError("channel-overlap", op, src=src, dst=dst,
                                 start=start, end=end, channel_busy=busy)
        if end < busy - EPS:
            raise SanitizerError("channel-backward", op, src=src, dst=dst,
                                 end=end, channel_busy=busy)

    # -- meter conservation --------------------------------------------------

    def charged(self, backend: str, nbytes: float, op: str) -> None:
        """``_charge`` just added ``nbytes`` to ``{backend}.bytes``: the
        meter must equal the shadow ledger exactly — any drift means
        something other than the transports wrote a payload meter."""
        self.checks += 1
        self._shadow_bytes[backend] = \
            self._shadow_bytes.get(backend, 0.0) + nbytes
        actual = self.net.meter.get(f"{backend}.bytes", 0)
        if abs(actual - self._shadow_bytes[backend]) > EPS:
            raise SanitizerError(
                "meter-drift", op, backend=backend, charged_now=nbytes,
                meter_bytes=actual, expected=self._shadow_bytes[backend])

    def retry_conserved(self, backend: str, before_bytes: float,
                        op: str) -> None:
        """A faulted attempt just timed out inside ``_admit``: it must
        have moved ZERO payload bytes (timeouts hold lanes, not data)."""
        self.checks += 1
        now = self.net.meter.get(f"{backend}.bytes", 0)
        if now != before_bytes:
            raise SanitizerError(
                "retry-payload", op, backend=backend,
                bytes_before=before_bytes, bytes_after=now)

    def reset_meters(self) -> None:
        """``Network.reset_meter`` cleared the counters: the shadow ledger
        follows (busy stamps were cleared with it, so lane/channel checks
        restart clean too)."""
        self._shadow_bytes.clear()

    # -- payload conservation (transport -> PagePool.write_pages) ------------

    def tag_payload(self, arr, backend: str, rows: int, nbytes: int) -> None:
        """A transport returned a page payload of ``rows`` pages /
        ``nbytes`` bytes; remember it until an adopter hands it to
        ``PagePool.write_pages``."""
        self._payloads[id(arr)] = (arr, backend, rows, nbytes)

    def adopt_payload(self, arr, rows: int, row_bytes: int, op: str) -> None:
        """``ModelInstance._adopt_pages`` is writing ``arr`` into ``rows``
        freshly allocated frames of ``row_bytes`` each: if the payload
        came off a transport, every byte the wire moved must land — no
        rows dropped, none duplicated."""
        tag = self._payloads.pop(id(arr), None)
        if tag is None:
            return                  # cache hit / local / RPC reply: untagged
        self.checks += 1
        _, backend, wire_rows, wire_bytes = tag
        if rows != wire_rows or rows * row_bytes != wire_bytes:
            raise SanitizerError(
                "payload-conservation", op, backend=backend,
                wire_rows=wire_rows, wire_bytes=wire_bytes,
                adopted_rows=rows, adopted_bytes=rows * row_bytes)

    # -- connection pools ----------------------------------------------------

    def touch_live(self, conn, manager, op: str) -> None:
        """Every use of a connection object must find it in the manager's
        live table — touching an evicted QP is use-after-free."""
        self.checks += 1
        if manager.conns.get(conn.key) is not conn:
            raise SanitizerError("evicted-conn-use", op, key=conn.key,
                                 backend=conn.backend)

    def check_conns(self, manager, op: str) -> None:
        """Full consistency scan of the connection control plane (runs
        after every state change while sanitized):

        * every live connection holds a slot in each of its nodes' pools,
          and every pool slot points back at a live connection (RC slot
          accounting balances across ``fault_pair``/eviction);
        * the user refcount index and the per-connection user sets agree
          bidirectionally (refcounts can never go "negative" — a release
          without a reference surfaces here as a dangling index entry);
        * no bounded pool exceeds ``NetModel.conn_cap``.
        """
        if self._suspended:
            return
        self.checks += 1
        cap = manager.cap
        for key, conn in manager.conns.items():
            for nid in conn.nodes:
                pool = manager.pools.get(nid)
                if pool is None or key not in pool:
                    raise SanitizerError(
                        "conn-slot-missing", op, key=key, node=nid)
            for u in conn.users:    # sim-ok: set-iter -- membership checks only, order-free
                if key not in manager._user_index.get(u, ()):
                    raise SanitizerError(
                        "refcount-unindexed", op, key=key, user=u)
        for nid, pool in manager.pools.items():
            if cap > 0 and len(pool) > cap:
                raise SanitizerError("pool-over-cap", op, node=nid,
                                     size=len(pool), cap=cap)
            for key in pool._order:
                if key not in manager.conns:
                    raise SanitizerError(
                        "conn-slot-dangling", op, key=key, node=nid)
        for user, keys in manager._user_index.items():
            for key in keys:        # sim-ok: set-iter -- membership checks only, order-free
                conn = manager.conns.get(key)
                if conn is None or user not in conn.users:
                    raise SanitizerError(
                        "refcount-dangling", op, user=user, key=key)

    # -- lease state machine -------------------------------------------------

    def lease_register(self, node_id: str, handler_id: int) -> None:
        self.checks += 1
        key = (node_id, handler_id)
        if self._leases.get(key) == "live":
            raise SanitizerError("lease-edge", "register_seed",
                                 node=node_id, handler_id=handler_id,
                                 state="live",
                                 detail="handler_id reused while live")
        self._leases[key] = "live"

    def _lease_event(self, node_id: str, handler_id: int, op: str) -> None:
        self.checks += 1
        key = (node_id, handler_id)
        state = self._leases.get(key)
        if state != "live":
            raise SanitizerError("lease-edge", op, node=node_id,
                                 handler_id=handler_id,
                                 state=state or "unregistered")

    def lease_renew(self, node_id: str, handler_id: int) -> None:
        self._lease_event(node_id, handler_id, "renew_seed")

    def lease_revoke(self, node_id: str, handler_id: int) -> None:
        self._lease_event(node_id, handler_id, "revoke_seed")

    def lease_reclaim(self, node_id: str, handler_id: int) -> None:
        """Only called for EFFECTIVE reclaims (the entry existed) — the
        public ``reclaim_seed`` stays idempotent, a second call never
        reaches this hook."""
        self._lease_event(node_id, handler_id, "reclaim_seed")
        self._leases[(node_id, handler_id)] = "reclaimed"

    def node_crashed(self, node_id: str) -> None:
        """A fail-stop kills the node's whole seed registry in one edge."""
        self.checks += 1
        for key, state in self._leases.items():
            if key[0] == node_id and state == "live":
                self._leases[key] = "reclaimed"

    def node_registered(self, node_id: str) -> None:
        """A (re-)registered node is a fresh incarnation: its parent_lost
        ledger resets, so a later loss of the NEW incarnation counts."""
        self._lost.pop(node_id, None)

    def parent_lost(self, func: str, node_id: str) -> None:
        """``parent_lost`` telemetry must fire exactly once per
        (function, node incarnation) — double counting would inflate the
        fig20/fig22 lease rows."""
        self.checks += 1
        funcs = self._lost.setdefault(node_id, set())
        if func in funcs:
            raise SanitizerError(
                "parent-lost-twice", "lease_telemetry", func=func,
                node=node_id,
                detail="parent_lost counted twice without re-registration")
        funcs.add(func)

    # -- reporting -----------------------------------------------------------

    def stats(self) -> Dict[str, int]:
        return {"checks": self.checks,
                "pending_payloads": len(self._payloads),
                "leases_tracked": len(self._leases)}
