"""ForkPolicy — one validated object for every resume-time knob.

Replaces the kwargs (``lazy``, ``prefetch``, descriptor/page transport
selection and the node-level sibling-cache flag) that callers used to
re-thread by hand.  Transport choices are names resolved against the
:mod:`repro_torch.net` registry, so the same fork protocol runs over any
registered fabric (``dct``, ``rc``, ``rpc``, ``tpu_ici``, ``shared_fs``,
or a custom backend).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.net import resolve_transport


@dataclasses.dataclass(frozen=True)
class ForkPolicy:
    """How a child resumes from a seed.

    lazy             : map pages on demand (COW) instead of eager full copy
    prefetch         : adjacent pages pulled per fault (0 = none) — these
                       widen the *blocking* read
    async_prefetch   : lookahead window issued as BACKGROUND fetches by the
                       child's PrefetchEngine (0 = off); transfers overlap
                       execution and the clock only waits when a page is
                       touched before its transfer completes
    descriptor_fetch : transport name for the descriptor transfer (repro_torch.net
                       registry); None = the child network's default backend.
                       One-sided backends read the blob RNIC-style behind its
                       DC key; two-sided backends RPC the parent daemon.
    page_fetch       : transport name for first-touch paging; None = the
                       network's default backend
    sibling_cache    : True/False toggles the child node's sibling page
                       cache for this and later forks; None keeps the
                       node's current setting
    reroute_backlog  : seconds of planned-owner link backlog
                       (``Network.link_backlog``) above which the child's
                       Router re-routes VMAs to a cooler sibling replica
                       holding the same bytes (``RoutePlan.reroute``);
                       None = static routes only.  Takes effect on sharded
                       (multi-replica) resumes, where alternates exist.
    """

    lazy: bool = True
    prefetch: int = 0
    async_prefetch: int = 0
    descriptor_fetch: Optional[str] = None
    page_fetch: Optional[str] = None
    sibling_cache: Optional[bool] = None
    reroute_backlog: Optional[float] = None

    def __post_init__(self):
        self.validate()

    def validate(self) -> "ForkPolicy":
        if not isinstance(self.lazy, bool):
            raise ValueError(f"lazy must be a bool, got {self.lazy!r}")
        for field in ("prefetch", "async_prefetch"):
            v = getattr(self, field)
            if not isinstance(v, int) or isinstance(v, bool) or v < 0:
                raise ValueError(f"{field} must be an int >= 0, got {v!r}")
        for field in ("descriptor_fetch", "page_fetch"):
            name = getattr(self, field)
            if name is None:
                continue
            if not isinstance(name, str):
                raise ValueError(
                    f"{field} must be None or a transport name, got {name!r}")
            try:
                resolve_transport(name)
            except ValueError as e:
                raise ValueError(f"{field}: {e}") from None
        if self.sibling_cache is not None and not isinstance(self.sibling_cache, bool):
            raise ValueError(
                f"sibling_cache must be None or a bool, got {self.sibling_cache!r}")
        rb = self.reroute_backlog
        if rb is not None and (isinstance(rb, bool)
                               or not isinstance(rb, (int, float)) or rb < 0):
            raise ValueError(
                f"reroute_backlog must be None or seconds >= 0, got {rb!r}")
        return self

    @classmethod
    def coerce(cls, policy=None) -> "ForkPolicy":
        """Accept None (defaults), a ForkPolicy, or a kwargs dict."""
        if policy is None:
            return cls()
        if isinstance(policy, cls):
            return policy
        if isinstance(policy, dict):
            return cls(**policy)
        raise TypeError(f"cannot build a ForkPolicy from {policy!r}")
