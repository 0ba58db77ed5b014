"""Plain PyTorch forward of Moonlight-16B-A3B's language model (DeepSeek-V3's
block) in float32: the benchmark's reference of the ``moonlight`` arch.

The semantics are the published model's, written anew from its equations:

- RMSNorm ``x * rsqrt(mean(x^2) + eps) * (1 + scale)``;
- rotary embedding on the rope dimensions, halves rotated
  (``[x1 cos - x2 sin, x2 cos + x1 sin]``, frequencies
  ``theta^(-2i/rope)``);
- multi-head latent attention in its expanded form: ``q = x wq`` split per
  head into ``q_nope`` and ``q_pe`` (roped); ``[c, k_pe] = x wkv_a``,
  ``c`` normed by ``kv_norm``, ``k_pe`` roped and shared by every head;
  ``[k_nope_h, v_h] = c wkv_b[:, h]``; scores ``[q_nope_h, q_pe_h] .
  [k_nope_h, k_pe]`` over ``sqrt(nope + rope)``, causal softmax, ``o_h =
  sum p v_h``, then ``wo``;
- a dense layer's gated MLP ``(silu(x wg) * (x wi)) wd``;
- an expert layer: ``s = sigmoid(x router)``; the top ``k`` of ``s +
  router_bias`` chosen (the bias for the choice only); gates ``s`` of the
  chosen over their sum (+ 1e-20), times ``moe_routed_scale``; the gated
  sum of the chosen experts' MLPs plus the shared experts' MLP.  No token
  is dropped (the source drops none; the program's capacity factor of
  11.0 drops none either), so a request is one forward over the prompt
  and the served tokens, with no cache.

Weights are the benchmark's nested dict (``forkbench/archs/moonlight.py``'s
layout): groups of blocks, each block's leaves stacked over its group's
repeats, run in the program's order; a block holding ``moe`` is an expert
layer, one holding ``mlp`` dense.  Attention takes its queries in blocks
of ``Q_BLOCK`` so that a long prompt's scores fit.  ``precision="tf32"``
rounds both operands of every matrix product to TF32's 10-bit mantissa
and accumulates in float32: the control one precision below the
configuration's.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from forkbench.reference.model import PRECISIONS, round_tf32

Q_BLOCK = 1024


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
        d = x.shape[-1]
        inv = 1.0 / (self.m["rope_theta"] ** (
            torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d))
        ang = pos.float()[:, None] * inv[None, :]           # (T, d/2)
        cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
        x1, x2 = x[..., :d // 2], x[..., d // 2:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)

    def attention(self, a, l, x, pos):
        m = self.m
        T, D = x.shape
        H, C = m["num_heads"], m["kv_lora_rank"]
        nope, r, dv = (m["qk_nope_head_dim"], m["qk_rope_head_dim"],
                       m["v_head_dim"])
        q = self.mm(x, a["wq"][l].reshape(D, H * (nope + r))).view(T, H, -1)
        q = torch.cat([q[..., :nope], self.rope(q[..., nope:], pos)], -1)
        kv = self.mm(x, a["wkv_a"][l])
        c = self.norm(kv[:, :C], a["kv_norm"]["scale"][l])
        k_pe = self.rope(kv[:, None, C:], pos)              # (T, 1, r)
        kvb = self.mm(c, a["wkv_b"][l].reshape(C, H * (nope + dv)))
        kvb = kvb.view(T, H, nope + dv)
        k = torch.cat([kvb[..., :nope], k_pe.expand(T, H, r)], -1)
        qh, kh = q.transpose(0, 1), k.transpose(0, 1)        # (H, T, nope+r)
        vh = kvb[..., nope:].transpose(0, 1)                 # (H, T, dv)
        outs = []
        for lo in range(0, T, Q_BLOCK):
            hi = min(lo + Q_BLOCK, T)
            s = self.mm(qh[:, lo:hi], kh[:, :hi].transpose(1, 2)) \
                * (nope + r) ** -0.5
            mask = pos[lo:hi, None] >= pos[None, :hi]
            s = s.masked_fill(~mask[None], float("-inf"))
            outs.append(self.mm(torch.softmax(s, dim=-1), vh[:, :hi]))
        o = torch.cat(outs, 1).transpose(0, 1).reshape(T, H * dv)
        return self.mm(o, a["wo"][l].reshape(H * dv, D))

    def mlp(self, p, x):
        return self.mm(F.silu(self.mm(x, p["wg"])) * self.mm(x, p["wi"]),
                       p["wd"])

    def moe(self, p, l, x):
        m = self.m
        s = torch.sigmoid(self.mm(x, p["router"][l]))
        idx = torch.topk(s + p["router_bias"][l], m["moe_topk"],
                         dim=-1).indices
        g = s.gather(1, idx)
        g = g / (g.sum(-1, keepdim=True) + 1e-20) * m["moe_routed_scale"]
        out = self.mlp({n: t[l] for n, t in p["shared"].items()}, x)
        for e in range(m["moe_experts"]):
            tok, slot = torch.nonzero(idx == e, as_tuple=True)
            if tok.numel() == 0:
                continue
            y = self.mlp({n: p[n][l, e] for n in ("wi", "wg", "wd")}, x[tok])
            out.index_add_(0, tok, y * g[tok, slot][:, None])
        return out

    # -- the model ------------------------------------------------------------

    @torch.no_grad()
    def logits(self, prompt, served):
        """Logits (len(prompt) + len(served) - 1, V) at every position of
        ``prompt`` then ``served`` but the last: row ``i`` predicts token
        ``i + 1``; one forward, no token dropped."""
        dev = self.w["final_norm"]["scale"].device
        toks = torch.tensor(list(prompt) + list(served)[:-1],
                            dtype=torch.long, device=dev)
        pos = torch.arange(len(toks), device=dev)
        h = self.w["embed"]["tok"][toks]
        for b, l in self.layers:
            h = h + self.attention(b["attn"], l,
                                   self.norm(h, b["norm1"]["scale"][l]), pos)
            hn = self.norm(h, b["norm2"]["scale"][l])
            h = h + (self.moe(b["moe"], l, hn) if "moe" in b else
                     self.mlp({n: t[l] for n, t in b["mlp"].items()}, hn))
        h = self.norm(h, self.w["final_norm"]["scale"])
        return self.mm(h, self.w["embed"]["out"])
