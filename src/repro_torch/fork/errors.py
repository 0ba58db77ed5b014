"""Control-plane exceptions.

Defined next to the transport layer (``repro_torch.net``) so the node runtime and
every backend can raise them without importing this package; re-exported
here as the public names of the fork API.  The whole taxonomy derives from
:class:`ReproError` with a machine-readable ``.kind`` — see
``repro/net/errors.py``.
"""
from repro_torch.net import (AccessRevoked, AuthError, HandleUnbound, LeaseExpired,
                       NoNodesAvailable, NodeDown, ReadTimeout, RecoveryFailed,
                       ReproError, RetriesExhausted, SeedGone, SeedUnavailable,
                       TransportError)

__all__ = [
    "AccessRevoked",
    "AuthError",
    "HandleUnbound",
    "LeaseExpired",
    "NoNodesAvailable",
    "NodeDown",
    "ReadTimeout",
    "RecoveryFailed",
    "ReproError",
    "RetriesExhausted",
    "SeedGone",
    "SeedUnavailable",
    "TransportError",
]
