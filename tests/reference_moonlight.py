"""A plain reference of Moonlight-16B-A3B's language model (DeepSeek-V3's
block, ``model_type`` deepseek_v3), written from its published equations
in plain PyTorch, float32, for the CPU tests of the port's
``moonlight-16b-a3b``.  It imports nothing of the port or of JAX.

No cache and no batching: one sequence through the whole model, with
latent attention in its expanded form (each head's key and value brought
up from the latent), every query against every earlier key.

- RMSNorm ``x * rsqrt(mean(x^2) + eps) * (1 + scale)`` (the port holds the
  scale as 1 + scale);
- rotary embedding on the rope dimensions, halves rotated,
  frequencies ``theta^(-2i/rope)`` (the port's; the source pairs
  interleaved dimensions: a fixed permutation of the rope columns);
- attention: ``q = x wq`` split per head into nope and rope parts;
  ``[c, k_pe] = x wkv_a``, ``c`` normed by ``kv_norm``, ``k_pe`` roped
  and shared by every head; ``[k_nope_h, v_h] = c wkv_b[:, h]``; scores
  ``[q_nope_h, q_pe_h] . [k_nope_h, k_pe] / sqrt(nope + rope)``, causal
  softmax, ``o_h = sum p v_h``, then ``wo``;
- a dense block: the gated MLP ``(silu(x wg) * (x wi)) wd``;
- an expert block: scores ``sigmoid(x router)``; the top k of the scores
  plus ``router_bias`` chosen (the bias for the choice only); gates the
  chosen scores over their sum (+ 1e-20), times ``routed_scale``; the
  output the gated sum of the chosen experts' MLPs plus the shared MLP.
  No token is dropped.

Weights are the port's nested dict (``groups`` of ``blocks``, each leaf
stacked over its group's repeats), run in the port's order; a block
holding ``moe`` is an expert block, one holding ``mlp`` dense.  ``m``
holds the sizes: ``num_heads``, ``kv_lora_rank``, ``qk_nope_head_dim``,
``qk_rope_head_dim``, ``v_head_dim``, ``moe_topk``, ``routed_scale``,
``rope_theta``, ``norm_eps``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def rms_norm(x, scale, eps):
    return x * torch.rsqrt(torch.mean(x * x, -1, keepdim=True) + eps) \
        * (1.0 + scale)


def rope(x, pos, theta):
    """x (T, heads, d) at positions ``pos`` (T,)."""
    d = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32) / d))
    ang = pos.float()[:, None] * inv[None, :]
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def latent(a, x, pos, m):
    """The normed latent ``c`` (T, kv_lora) and the roped shared key
    ``k_pe`` (T, rope) of ``x`` (T, D)."""
    C = m["kv_lora_rank"]
    kv = x @ a["wkv_a"]
    c = rms_norm(kv[:, :C], a["kv_norm"]["scale"], m["norm_eps"])
    return c, rope(kv[:, None, C:], pos, m["rope_theta"])[:, 0]


def attention_heads(a, x, pos, m):
    """Each head's attention output (T, H, v) before ``wo``."""
    T, D = x.shape
    H, nope, r, dv = (m["num_heads"], m["qk_nope_head_dim"],
                      m["qk_rope_head_dim"], m["v_head_dim"])
    q = (x @ a["wq"].reshape(D, H * (nope + r))).view(T, H, nope + r)
    q = torch.cat([q[..., :nope], rope(q[..., nope:], pos, m["rope_theta"])],
                  -1)
    c, k_pe = latent(a, x, pos, m)
    kv = (c @ a["wkv_b"].reshape(-1, H * (nope + dv))).view(T, H, nope + dv)
    k = torch.cat([kv[..., :nope], k_pe[:, None, :].expand(T, H, r)], -1)
    v = kv[..., nope:]
    out = torch.zeros(T, H, dv)
    for t in range(T):                   # query t sees keys 0..t
        for h in range(H):
            s = (k[:t + 1, h] @ q[t, h]) / (nope + r) ** 0.5
            out[t, h] = torch.softmax(s, 0) @ v[:t + 1, h]
    return out


def attention(a, x, pos, m):
    T = x.shape[0]
    return attention_heads(a, x, pos, m).reshape(T, -1) \
        @ a["wo"].reshape(-1, x.shape[1])


def mlp(p, x):
    return (F.silu(x @ p["wg"]) * (x @ p["wi"])) @ p["wd"]


def route(p, x, m):
    """(chosen experts (T, k), their gates (T, k))."""
    s = torch.sigmoid(x @ p["router"])
    idx = torch.topk(s + p["router_bias"], m["moe_topk"], dim=-1).indices
    g = s.gather(1, idx)
    return idx, g / (g.sum(-1, keepdim=True) + 1e-20) * m["routed_scale"]


def moe(p, x, m):
    idx, g = route(p, x, m)
    out = mlp(p["shared"], x)
    for t in range(x.shape[0]):
        for j in range(idx.shape[1]):
            e = int(idx[t, j])
            out[t] = out[t] + g[t, j] * mlp(
                {n: p[n][e] for n in ("wi", "wg", "wd")}, x[t:t + 1])[0]
    return out


def layers(w):
    """(block, repeat) of every layer, in the port's order."""
    return [(b, r) for g in w["groups"]
            for r in range(g["blocks"][0]["norm1"]["scale"].shape[0])
            for b in g["blocks"]]


def leaf(tree, r):
    """The layer ``r`` slice of a block's stacked leaves."""
    if isinstance(tree, dict):
        return {k: leaf(v, r) for k, v in tree.items()}
    return tree[r]


@torch.no_grad()
def forward(w, m, tokens):
    """Logits (T, V) at every position of ``tokens``."""
    pos = torch.arange(len(tokens))
    h = w["embed"]["tok"][torch.tensor(tokens)]
    for b, r in layers(w):
        b = leaf(b, r)
        h = h + attention(b["attn"], rms_norm(h, b["norm1"]["scale"],
                                              m["norm_eps"]), pos, m)
        hn = rms_norm(h, b["norm2"]["scale"], m["norm_eps"])
        h = h + (moe(b["moe"], hn, m) if "moe" in b else mlp(b["mlp"], hn))
    h = rms_norm(h, w["final_norm"]["scale"], m["norm_eps"])
    return h @ w["embed"]["out"]
