"""Straggler mitigation via backup forks.

The coordinator tracks per-worker step latencies; when a worker's EWMA
exceeds `threshold` x the cluster median, its shard is BACKUP-FORKED onto a
spare node (remote fork: descriptor + on-demand pages — no checkpoint
read), and whichever replica reports first wins.  This is the paper's
O(1)-provisioning argument applied to straggler handling: no standby
replicas are kept warm; the seed is enough.
"""
from __future__ import annotations

import dataclasses
import statistics
from typing import Callable, Dict, List, Optional

from repro_torch.fork import ForkHandle, ForkPolicy


@dataclasses.dataclass
class WorkerStat:
    node_id: str
    ewma_s: float = 0.0
    steps: int = 0


class StragglerMonitor:
    def __init__(self, network, threshold: float = 2.0, alpha: float = 0.4,
                 min_steps: int = 3):
        self.network = network
        self.threshold = threshold
        self.alpha = alpha
        self.min_steps = min_steps
        self.stats: Dict[str, WorkerStat] = {}
        self.backups: Dict[str, str] = {}       # straggler -> backup node

    def report(self, node_id: str, step_seconds: float) -> None:
        st = self.stats.setdefault(node_id, WorkerStat(node_id))
        st.ewma_s = (step_seconds if st.steps == 0
                     else self.alpha * step_seconds + (1 - self.alpha) * st.ewma_s)
        st.steps += 1

    def stragglers(self) -> List[str]:
        ready = [s for s in self.stats.values() if s.steps >= self.min_steps]
        if len(ready) < 2:
            return []
        med = statistics.median(s.ewma_s for s in ready)
        return [s.node_id for s in ready
                if med > 0 and s.ewma_s > self.threshold * med
                and s.node_id not in self.backups]

    def mitigate(self, straggler_id: str, handle: ForkHandle,
                 spare_node) -> object:
        """Backup-fork the straggler's worker state (its prepared seed
        handle) onto a spare node."""
        child = handle.resume_on(spare_node, ForkPolicy(lazy=True, prefetch=1))
        self.backups[straggler_id] = spare_node.node_id
        return child

    def resolve(self, straggler_id: str, winner: str) -> None:
        self.backups.pop(straggler_id, None)
        if winner != straggler_id and straggler_id in self.stats:
            del self.stats[straggler_id]
