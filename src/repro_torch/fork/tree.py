"""ForkTree — the §6.3 fork tree built by ``ForkHandle.fan_out``.

To fork N children from one seed without serializing on the root parent,
children are re-prepared as short-lived seeds once the current serving seed
has handed out ``tree_degree`` descriptors; later children then fork from
those re-seeds (BFS order, so the tree stays as shallow as possible).  The
coordinator closes the whole tree — every re-seed reclaimed, the root left
alone — in one call.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.fork.policy import ForkPolicy


@dataclasses.dataclass
class ForkTree:
    """Fan-out result: children (BFS order), the short-lived re-seed handles
    (root excluded), per-child depth, and edges (serving handle -> child)."""

    root: "ForkHandle"
    degree: int
    children: List[object] = dataclasses.field(default_factory=list)
    seeds: List["ForkHandle"] = dataclasses.field(default_factory=list)
    levels: List[int] = dataclasses.field(default_factory=list)
    edges: List[Tuple["ForkHandle", object]] = dataclasses.field(default_factory=list)
    closed: bool = False

    def __len__(self) -> int:
        return len(self.children)

    def depth(self) -> int:
        return max(self.levels, default=0)

    def served_by(self) -> Dict[Tuple[str, int], int]:
        """(parent_node, handler_id) -> number of children that seed served.
        Keyed by the pair because handler ids are per-node counters."""
        count: Dict[Tuple[str, int], int] = {}
        for handle, _ in self.edges:
            key = (handle.parent_node, handle.handler_id)
            count[key] = count.get(key, 0) + 1
        return count

    def close(self, free_instances: bool = False) -> None:
        """Reclaim every short-lived re-seed in the tree (never the root);
        idempotent.  ``free_instances`` additionally frees the children."""
        if not self.closed:
            for handle in self.seeds:
                handle.reclaim(free_instance=False)
            self.closed = True
        if free_instances:
            for child in self.children:
                child.free()

    def __enter__(self) -> "ForkTree":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()


def build_fork_tree(root: "ForkHandle", nodes: Sequence,
                    policy: Optional[ForkPolicy] = None,
                    tree_degree: int = 8,
                    child_lease: Optional[float] = None,
                    root_quota: Optional[int] = None,
                    promote=None) -> ForkTree:
    """Fork one child per entry of ``nodes`` (NodeRuntime targets; repeats
    allowed) through a degree-bounded tree rooted at ``root``.

    Children are promoted to servers lazily — a child only pays the
    re-prepare cost when the frontier of existing seeds is exhausted.

    ``root_quota`` is how many children the root itself serves before the
    first promotion (default ``tree_degree``; a sharded root with S parent
    NICs passes ``tree_degree * S``).  ``promote`` picks which pending
    child to re-seed next: a callable from the promotable list of
    (child instance, level) pairs to an index (default 0 = FIFO/BFS; the
    placement-aware sharded fan-out promotes the least-loaded side)."""
    if tree_degree < 1:
        raise ValueError(f"tree_degree must be >= 1, got {tree_degree}")
    policy = ForkPolicy.coerce(policy)
    tree = ForkTree(root=root, degree=tree_degree)
    # [handle, children_served, level, serve quota]
    servers = deque([[root, 0, 0, root_quota or tree_degree]])
    promotable = []                     # (child instance, its level)
    try:
        for node in nodes:
            while servers and servers[0][1] >= servers[0][3]:
                servers.popleft()
            if not servers:
                i = promote(promotable) if promote is not None else 0
                inst, level = promotable.pop(i)
                reseed = inst.node.prepare_fork(inst, lease=child_lease)
                tree.seeds.append(reseed)
                servers.append([reseed, 0, level, tree_degree])
            server = servers[0]
            child = server[0].resume_on(node, policy)
            server[1] += 1
            tree.children.append(child)
            tree.levels.append(server[2] + 1)
            tree.edges.append((server[0], child))
            promotable.append((child, server[2] + 1))
    except BaseException:
        # a failed fan-out must not leak re-seeds (SeedEntry + DC targets)
        # or orphaned children the caller has no handle on — reclaim the
        # partial tree (never the root) before surfacing the error
        tree.close(free_instances=True)
        raise
    return tree
