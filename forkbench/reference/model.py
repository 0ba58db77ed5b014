"""Plain PyTorch forward of a causal LM of pre-norm attention blocks, each
followed by a gated dense MLP or a top-k mixture of experts, in float32.

The semantics are those of the model the benchmark serves, written anew
from its equations:

- RMSNorm ``x * rsqrt(mean(x^2) + eps) * (1 + scale)``;
- rotary embedding on whole heads, halves rotated
  (``[x1 cos - x2 sin, x2 cos + x1 sin]``, frequencies
  ``theta^(-2i/hd)``);
- multi-head attention with KV heads shared by groups of query heads
  (query head ``h`` reads KV head ``h // G``), scaled by ``hd^-0.5``;
- the gated MLP ``(silu(x Wg) * (x Wi)) Wd``;
- the mixture: softmax over the router's logits, the top ``k`` experts of
  each token with their probabilities renormalised to sum to 1, and each
  expert taking at most ``max(int(factor * T * k / E), 1)`` of a call's
  ``T`` tokens, in token order: a token past its expert's capacity gets
  nothing from that expert.  A served prompt is one call (``prefill``);
  each decoded token is a call of its own, of one token, so no decoded
  token is ever dropped (``extend`` runs the served tokens without a
  capacity).

Weights are the benchmark's nested dict (the layout of ``weights.py``):
groups of blocks, each block's leaves stacked over its group's repeats,
run in the program's order (each group's unit of blocks, repeat after
repeat); a block holding ``moe`` is a mixture, one holding ``mlp`` a
dense MLP.
``precision="tf32"`` rounds both operands of every matrix product to
TF32's 10-bit mantissa (round to nearest even) and accumulates in float32:
the control that computes one precision below the configuration's.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

PRECISIONS = ("fp32", "tf32")


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32: 10 mantissa bits, nearest even."""
    b = x.contiguous().view(torch.int32)
    b = (b + 0x0FFF + ((b >> 13) & 1)) & -0x2000
    return b.view(torch.float32)


class Reference:
    """``m``: the configuration's ``model`` dict; ``w``: the weights."""

    def __init__(self, m: dict, w: dict, precision: str = "fp32"):
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}")
        self.m = m
        self.w = w
        self.tf32 = precision == "tf32"
        self.layers = [(blk, r) for g in w["groups"]
                       for r in range(g["blocks"][0]["norm1"]["scale"].shape[0])
                       for blk in g["blocks"]]

    def mm(self, a, b):
        if self.tf32:
            a, b = round_tf32(a), round_tf32(b)
        return a @ b

    # -- pieces ---------------------------------------------------------------

    def norm(self, x, scale):
        var = torch.mean(x * x, dim=-1, keepdim=True)
        return x * torch.rsqrt(var + self.m["norm_eps"]) * (1.0 + scale)

    def rope(self, x, pos):
        hd = x.shape[-1]
        inv = 1.0 / (self.m["rope_theta"] ** (
            torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd))
        ang = pos.float()[:, None] * inv[None, :]          # (T, hd/2)
        cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
        x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)

    def attention(self, a, l, x, pos, cache):
        """Attention of leaves ``a`` at layer ``l`` of their stack; x (T, D)
        at positions ``pos``; ``cache`` (k, v) of the earlier positions or
        None.  Returns the output and the new (k, v)."""
        m = self.m
        T, D = x.shape
        H, K, hd = m["num_heads"], m["num_kv_heads"], m["head_dim"]
        q = self.mm(x, a["wq"][l].reshape(D, H * hd)).view(T, H, hd)
        k = self.mm(x, a["wk"][l].reshape(D, K * hd)).view(T, K, hd)
        v = self.mm(x, a["wv"][l].reshape(D, K * hd)).view(T, K, hd)
        q, k = self.rope(q, pos), self.rope(k, pos)
        if cache is not None:
            k = torch.cat([cache[0], k])
            v = torch.cat([cache[1], v])
        S = k.shape[0]
        G = H // K
        kk = k.repeat_interleave(G, dim=1)                 # (S, H, hd)
        vv = v.repeat_interleave(G, dim=1)
        qh, kh, vh = q.transpose(0, 1), kk.transpose(0, 1), vv.transpose(0, 1)
        s = self.mm(qh, kh.transpose(1, 2)) * hd ** -0.5   # (H, T, S)
        kpos = torch.arange(S, device=x.device)
        mask = pos[:, None] >= kpos[None, :]
        s = s.masked_fill(~mask[None], float("-inf"))
        o = self.mm(torch.softmax(s, dim=-1), vh)          # (H, T, hd)
        o = o.transpose(0, 1).reshape(T, H * hd)
        return self.mm(o, a["wo"][l].reshape(H * hd, D)), (k, v)

    def mlp(self, p, l, x):
        h = F.silu(self.mm(x, p["wg"][l])) * self.mm(x, p["wi"][l])
        return self.mm(h, p["wd"][l])

    def moe(self, p, l, x, capacity: bool):
        m = self.m
        T = x.shape[0]
        E, k = m["moe_experts"], m["moe_topk"]
        probs = torch.softmax(self.mm(x, p["router"][l]), dim=-1)
        gate, idx = torch.topk(probs, k, dim=-1)           # (T, k)
        gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
        cap = (max(int(m["moe_capacity_factor"] * T * k / E), 1)
               if capacity else T)
        out = torch.zeros_like(x)
        for e in range(E):
            tok, slot = torch.nonzero(idx == e, as_tuple=True)   # token order
            tok, slot = tok[:cap], slot[:cap]
            if tok.numel() == 0:
                continue
            xe = x[tok]
            h = F.silu(self.mm(xe, p["wg"][l, e])) * self.mm(xe, p["wi"][l, e])
            y = self.mm(h, p["wd"][l, e]) * gate[tok, slot][:, None]
            out.index_add_(0, tok, y)
        return out

    # -- the model ------------------------------------------------------------

    def _run(self, tokens, pos, caches, capacity):
        m = self.m
        h = self.w["embed"]["tok"][tokens]
        new = []
        for i, (b, l) in enumerate(self.layers):
            a, kv = self.attention(b["attn"], l,
                                   self.norm(h, b["norm1"]["scale"][l]),
                                   pos, caches[i] if caches else None)
            new.append(kv)
            h = h + a
            hn = self.norm(h, b["norm2"]["scale"][l])
            h = h + (self.moe(b["moe"], l, hn, capacity) if "moe" in b
                     else self.mlp(b["mlp"], l, hn))
        h = self.norm(h, self.w["final_norm"]["scale"])
        head = (self.w["embed"]["tok"].t() if m["tie_embeddings"]
                else self.w["embed"]["out"])
        return self.mm(h, head), new

    @torch.no_grad()
    def logits(self, prompt, served):
        """Logits (len(prompt) + len(served) - 1, V) at every position of
        ``prompt`` then ``served`` but the last: row ``i`` predicts token
        ``i + 1``.  The prompt is one call of the model (a prefill, with
        the experts' capacity over its tokens); the served tokens but the
        last follow it through the cache, one token a call, so without a
        capacity limit."""
        dev = self.w["final_norm"]["scale"].device
        P = len(prompt)
        toks = torch.tensor(list(prompt), dtype=torch.long, device=dev)
        out, caches = self._run(toks, torch.arange(P, device=dev), None, True)
        rest = list(served)[:-1]
        if rest:
            toks = torch.tensor(rest, dtype=torch.long, device=dev)
            more, _ = self._run(toks, torch.arange(P, P + len(rest),
                                                   device=dev), caches, False)
            out = torch.cat([out, more])
        return out
