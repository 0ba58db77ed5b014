"""Capability-style fork control plane (lease-based, rFaaS-inspired).

This package replaces the raw ``(handler_id, auth_key)`` tuple surface of
``repro_torch.core.fork`` with typed, self-reclaiming handles:

``ForkHandle``
    Serializable capability for one prepared seed: parent node, handler id,
    auth key, lease deadline, generation.  Lifecycle methods ``resume_on``,
    ``renew``, ``revoke``, ``reclaim``, ``fan_out``; usable as a context
    manager (auto-``reclaim()`` on exit).
``ForkPolicy``
    Consolidates the resume knobs (``lazy``/``prefetch``/``descriptor_fetch``/
    sibling-cache participation) with validation.
``ForkTree``
    Result of ``ForkHandle.fan_out``: the §6.3 fork tree, closed (all
    short-lived re-seeds reclaimed) in one call.

Leases and revocation generations are enforced AT THE PARENT during the
authentication RPC: an expired lease raises ``LeaseExpired``, a stale
generation raises ``AccessRevoked`` — children never see a half-valid seed.

Entry point: ``NodeRuntime.prepare_fork(instance, lease=...) -> ForkHandle``.
The old ``fork_prepare``/``fork_resume``/``fork_reclaim`` tuple shims have
been removed; descriptor and page traffic both dispatch through the
``repro_torch.net`` transport registry (``ForkPolicy.descriptor_fetch`` /
``page_fetch`` select backends by name — see ``docs/transport.md``).
"""
from repro_torch.fork.errors import AccessRevoked, LeaseExpired
from repro_torch.fork.handle import DEFAULT_TREE_DEGREE, ForkHandle, prepare_fork
from repro_torch.fork.policy import ForkPolicy
from repro_torch.fork.tree import ForkTree

__all__ = [
    "AccessRevoked",
    "LeaseExpired",
    "ForkHandle",
    "ForkPolicy",
    "ForkTree",
    "prepare_fork",
    "DEFAULT_TREE_DEGREE",
]
