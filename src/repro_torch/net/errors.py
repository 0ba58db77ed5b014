"""Data-/control-plane exceptions shared by every transport backend.

Everything operational raised by the fork / paging / transport paths
derives from one :class:`ReproError` base carrying a machine-readable
``.kind`` — fault handlers, autoscalers and the chaos harness dispatch on
the kind string instead of matching exception classes or message text.

The taxonomy dual-inherits from the builtin exception each error used to
be (``ConnectionError``, ``PermissionError``, ``RuntimeError``,
``KeyError``) so every pre-taxonomy ``except`` clause keeps catching what
it caught before; new code should catch :class:`ReproError` /
:class:`TransportError` and branch on ``.kind``.
"""
from typing import ClassVar


class ReproError(Exception):
    """Base of every typed operational error in the stack.

    ``kind`` is a stable machine-readable discriminator (telemetry keys,
    chaos-test assertions); ``str(e)`` stays the human-readable detail.
    """

    kind: ClassVar[str] = "error"


# -- transport / fabric ------------------------------------------------------

class TransportError(ReproError, ConnectionError):
    """A data-plane operation failed at the fabric: peer unreachable,
    timed out, or retries exhausted.  The recovery chain (sibling replica
    -> seed re-replication -> coldstart degradation) starts here."""

    kind = "transport"


class NodeDown(TransportError):
    """The target node left the network (crash / unregister) — membership
    is authoritative, so this is raised without retrying."""

    kind = "node_down"


class ReadTimeout(TransportError):
    """One op attempt exceeded ``NetModel.op_timeout_s`` (injected NIC
    flap or per-op fault).  Retried up to the backend's ``max_retries``."""

    kind = "read_timeout"


class RetriesExhausted(TransportError):
    """Every retry attempt of an op timed out — the backend gives up and
    the caller must fail over (RC additionally tore its connection down)."""

    kind = "retries_exhausted"


class SeedUnavailable(TransportError):
    """A (sharded) seed has no live replica left to serve from."""

    kind = "seed_unavailable"


class RecoveryFailed(TransportError):
    """The fault-handler recovery chain ran out of options (no usable
    sibling, no re-replicable seed) — callers degrade to coldstart."""

    kind = "recovery_failed"


# -- capability / lease control plane ----------------------------------------

class AccessRevoked(ReproError, PermissionError):
    """One-sided access rejected: the DC target is gone or the handle's
    generation was revoked at the parent (§5.2 connection-based control)."""

    kind = "access_revoked"


class LeaseExpired(ReproError, PermissionError):
    """The seed's lease ran out before the child authenticated — the parent
    refuses resume, mirroring rFaaS-style leased capabilities."""

    kind = "lease_expired"


class AuthError(ReproError, PermissionError):
    """Bad fork credentials: unknown handler id or wrong auth key."""

    kind = "bad_credentials"


class SeedGone(ReproError, KeyError):
    """The seed entry no longer exists at the parent (reclaimed, or the
    parent restarted) — renew/reclaim against it cannot proceed."""

    kind = "seed_gone"


# -- control-plane preconditions ---------------------------------------------

class HandleUnbound(ReproError, RuntimeError):
    """A local-only ForkHandle operation needs the parent runtime bound."""

    kind = "handle_unbound"


class NoNodesAvailable(ReproError, RuntimeError):
    """The scheduler found no live node to place on."""

    kind = "no_nodes"
