"""repro_torch.net — the pluggable data plane.

One :class:`Transport` interface (``read_pages`` / ``read_blob`` / ``rpc``,
capability flags, per-backend metering) behind a name-keyed registry, with
:class:`Network` as a thin router (membership + DC-target access control +
meter aggregation).  Built-in backends: ``dct``, ``rc``, ``rpc``,
``tpu_ici``, ``shared_fs`` — see ``docs/transport.md``.
"""
from repro_torch.net.conn import (ConnManager, ConnPool, Connection, DCTInitiator,
                            DCTTarget, RCConnection)
from repro_torch.net.errors import (AccessRevoked, AuthError, HandleUnbound,
                              LeaseExpired, NoNodesAvailable, NodeDown,
                              ReadTimeout, RecoveryFailed, ReproError,
                              RetriesExhausted, SeedGone, SeedUnavailable,
                              TransportError)
from repro_torch.net.model import NetModel
from repro_torch.net.network import Network
from repro_torch.net.transport import (Transport, contiguous_runs,
                                 register_transport, resolve_transport,
                                 transport_names)
from repro_torch.net.backends import (DctTransport, RcTransport, RpcTransport,
                                SharedFsTransport, TpuIciTransport)

__all__ = [
    "AccessRevoked",
    "AuthError",
    "HandleUnbound",
    "NoNodesAvailable",
    "NodeDown",
    "ReadTimeout",
    "RecoveryFailed",
    "ReproError",
    "RetriesExhausted",
    "SeedGone",
    "SeedUnavailable",
    "TransportError",
    "ConnManager",
    "ConnPool",
    "Connection",
    "DCTInitiator",
    "DCTTarget",
    "LeaseExpired",
    "RCConnection",
    "NetModel",
    "Network",
    "Transport",
    "contiguous_runs",
    "register_transport",
    "resolve_transport",
    "transport_names",
    "DctTransport",
    "RcTransport",
    "RpcTransport",
    "TpuIciTransport",
    "SharedFsTransport",
]
