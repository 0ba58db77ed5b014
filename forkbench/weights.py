"""The benchmark's weights: made on the device from the run's seed, in one
draw, in the leaf layout the program takes (``repro_torch.models.lm``'s
nested dict: each block's leaves stacked over the layers).

Every leaf is a view of one float32 buffer filled by a single
``normal_`` from a generator seeded with ``--seed``, then scaled leaf by
leaf: projections by ``1/sqrt(fan_in)``, the router and the token
embedding by 0.02, and the norms' scales (used as ``1 + scale``) by 0.1.
The same seed on the same device gives the same weights.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

Leaf = Tuple[Tuple[str, ...], Tuple[int, ...], float]


def leaves(m: dict) -> List[Leaf]:
    """(path, shape, scale) of every leaf of model ``m``."""
    D, H, K, hd = m["d_model"], m["num_heads"], m["num_kv_heads"], m["head_dim"]
    L, V = m["num_layers"], m["vocab_size"]
    blk = ("groups", "0", "blocks", "0")
    out: List[Leaf] = [(("embed", "tok"), (V, D), 0.02)]
    if not m["tie_embeddings"]:
        out.append((("embed", "out"), (D, V), D ** -0.5))
    out += [
        (blk + ("norm1", "scale"), (L, D), 0.1),
        (blk + ("attn", "wq"), (L, D, H, hd), D ** -0.5),
        (blk + ("attn", "wk"), (L, D, K, hd), D ** -0.5),
        (blk + ("attn", "wv"), (L, D, K, hd), D ** -0.5),
        (blk + ("attn", "wo"), (L, H, hd, D), (H * hd) ** -0.5),
        (blk + ("norm2", "scale"), (L, D), 0.1),
    ]
    if m["moe_experts"]:
        E, Fe = m["moe_experts"], m["moe_d_ff"]
        out += [(blk + ("moe", "router"), (L, D, E), 0.02),
                (blk + ("moe", "wi"), (L, E, D, Fe), D ** -0.5),
                (blk + ("moe", "wg"), (L, E, D, Fe), D ** -0.5),
                (blk + ("moe", "wd"), (L, E, Fe, D), Fe ** -0.5)]
    else:
        Fd = m["d_ff"]
        out += [(blk + ("mlp", "wi"), (L, D, Fd), D ** -0.5),
                (blk + ("mlp", "wg"), (L, D, Fd), D ** -0.5),
                (blk + ("mlp", "wd"), (L, Fd, D), Fd ** -0.5)]
    out.append((("final_norm", "scale"), (D,), 0.1))
    return out


def param_count(m: dict) -> int:
    return sum(math.prod(s) for _, s, _ in leaves(m))


def make(m: dict, seed: int, device) -> dict:
    """The nested weight dict of ``m``, drawn from ``seed`` on ``device``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    spec = leaves(m)
    buf = torch.empty(sum(math.prod(s) for _, s, _ in spec),
                      dtype=torch.float32, device=device)
    buf.normal_(generator=gen)
    tree: Dict = {}
    off = 0
    for path, shape, scale in spec:
        n = math.prod(shape)
        t = buf[off:off + n].view(shape).mul_(scale)
        off += n
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = t
    # the program's layout has lists where the path says "0"
    tree["groups"] = [{"blocks": [tree["groups"]["0"]["blocks"]["0"]]}]
    return tree


def flat(tree, prefix: str = ""):
    """(name, tensor) of every leaf of a nested dict/list, in sorted order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from flat(tree[k], f"{prefix}/{k}" if prefix else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from flat(v, f"{prefix}/{i}" if prefix else str(i))
    else:
        yield prefix, tree
