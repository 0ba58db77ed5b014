"""Serving engine: continuous batching over a paged KV cache, with
fork-based prefix sharing (the MITOSIS state-transfer path).

Serves the attention architectures through a paged decode forward built
from the same layer primitives as the model (models/layers.py).  The
decode attention runs through kernels/paged_attention (the CUDA kernel on
the card, its plain version on the CPU), reading KV directly from the
pool's frames tensor — children created by `fork_request` attend over the
parent's pages with zero copies.
"""
from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import _dtypes
from repro_torch.configs.base import ArchConfig, AttnSpec
from repro_torch.kernels import dispatch
from repro_torch.kernels.paged_attention.ops import paged_attention
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.serving.kv_cache import PagedKV
from repro_torch.serving.sampling import sample


@dataclasses.dataclass
class Request:
    req_id: int
    prompt: List[int]
    max_tokens: int
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    seq_id: Optional[int] = None
    done: bool = False
    # per generated token, its (V,) fp32 logits on the CPU (keep_logits)
    logits: List[torch.Tensor] = dataclasses.field(default_factory=list)


class ServingEngine:
    """``backend`` is the paged-attention and page-kernel dispatch request
    (kernels/dispatch.py).  ``meter`` collects the kernel choices
    (``kernel.{name}.{impl}``) and the KV pool's ``pool.*`` counters.
    ``keep_logits`` stores each generated token's logits on its request,
    for checking against the non-paged model."""

    def __init__(self, cfg: ArchConfig, params, *, page_tokens: int = 16,
                 backend: str = "auto", eos_id: int = -1, device="cuda",
                 keep_logits: bool = False):
        self.cfg = cfg
        specs = [s for s in cfg.block_specs() if isinstance(s, AttnSpec)]
        if len(specs) != cfg.num_layers or cfg.moe_experts:
            raise NotImplementedError(
                "the paged engine serves dense attention archs; MoE and "
                "recurrent archs are not ported yet (ROADMAP queue A)")
        self.specs = list(cfg.block_specs())
        self.params = params
        self.device = torch.device(device)
        self.meter = Counter()
        self.kv = PagedKV(cfg.num_layers, cfg.num_kv_heads, cfg.head_dim,
                          page_tokens=page_tokens, dtype=cfg.compute_dtype,
                          device=self.device, kernel_backend=backend,
                          meter=self.meter)
        self.backend = backend
        self.eos_id = eos_id
        self.keep_logits = keep_logits
        self.requests: Dict[int, Request] = {}
        self.active: List[int] = []
        self.waiting: List[int] = []
        self._rid = 0
        self._block_params = self._flatten_blocks()

    def _flatten_blocks(self):
        """Per-layer param slices (unstacked views for the python-loop path)."""
        out = []
        for g, gp in zip(self.cfg.groups, self.params["groups"]):
            for r in range(g.repeat):
                for bi, spec in enumerate(g.unit):
                    bp = gp["blocks"][bi]
                    if getattr(spec, "shared", False):
                        out.append((spec, bp))
                    else:
                        out.append((spec, lm._index_tree(bp, r)))
        return out

    # -- request lifecycle -----------------------------------------------------

    def submit(self, prompt: List[int], max_tokens: int = 16) -> int:
        rid = self._rid
        self._rid += 1
        self.requests[rid] = Request(rid, list(prompt), max_tokens)
        self.waiting.append(rid)
        return rid

    def fork_request(self, src_rid: int, max_tokens: int = 16) -> int:
        """Fork a running request: shares its KV prefix pages COW."""
        src = self.requests[src_rid]
        rid = self._rid
        self._rid += 1
        r = Request(rid, list(src.prompt) + list(src.out_tokens), max_tokens)
        r.seq_id = self.kv.fork_sequence(src.seq_id)
        self.requests[rid] = r
        self.active.append(rid)
        return rid

    # -- model internals ---------------------------------------------------------

    def _keep(self, req: Request, logits) -> None:
        if self.keep_logits:
            req.logits.append(logits.detach().float().cpu())

    def _prefill(self, req: Request) -> None:
        toks = torch.tensor(req.prompt, dtype=torch.int32,
                            device=self.device)[None, :]
        Tp = self.kv.Tp
        cache_len = ((len(req.prompt) + Tp - 1) // Tp) * Tp
        logits, caches = lm.prefill(self.params, self.cfg, toks, cache_len)
        req.seq_id = self.kv.new_seq()
        # flatten the grouped caches into (L, S, K, hd)
        ks, vs = [], []
        for g, gc in zip(self.cfg.groups, caches["groups"]):
            for r in range(g.repeat):               # execution order: repeat
                for bi in range(len(g.unit)):       # outer, unit inner
                    c = gc["blocks"][bi]
                    ks.append(c["k"][r, 0])
                    vs.append(c["v"][r, 0])
        k = torch.stack(ks)[:, :len(req.prompt)]
        v = torch.stack(vs)[:, :len(req.prompt)]
        self.kv.write_prefill(req.seq_id, k, v)
        last = logits[0, -1] if logits.dim() == 3 else logits[0]
        self._keep(req, last)
        req.out_tokens.append(int(torch.argmax(last)))

    def _decode_batch(self, rids: List[int]) -> None:
        B = len(rids)
        cfg = self.cfg
        dev = self.device
        reqs = [self.requests[r] for r in rids]
        sids = [r.seq_id for r in reqs]
        toks = torch.tensor([(r.out_tokens[-1] if r.out_tokens
                              else r.prompt[-1]) for r in reqs],
                            dtype=torch.int32, device=dev)
        pos = torch.tensor([self.kv.seqs[s].length for s in sids],
                           dtype=torch.int32, device=dev)
        dt = _dtypes.torch_dtype(cfg.compute_dtype)

        # reserve the slot for the incoming token (alloc/COW before write)
        for s in sids:
            self.kv.ensure_writable_slot(s)
        k_pt, v_pt, lens = self.kv.batch_tables(sids)
        # one upload per step, layer-major so each layer's table is a
        # contiguous (B, P) slice
        k_pt = torch.from_numpy(np.ascontiguousarray(
            k_pt.transpose(1, 0, 2))).to(dev)
        v_pt = torch.from_numpy(np.ascontiguousarray(
            v_pt.transpose(1, 0, 2))).to(dev)
        eff = torch.from_numpy(lens + 1).to(dev)
        G = cfg.num_heads // cfg.num_kv_heads

        h = L.embed_tokens(self.params["embed"], cfg, toks[:, None], dt)
        for li, (spec, bp) in enumerate(self._block_params):
            hn = L.rms_norm(h, bp["norm1"]["scale"], cfg.norm_eps)
            q, k1, v1 = L._project_qkv(bp["attn"], hn, spec, cfg,
                                       pos[:, None])
            # write this token's K/V into the reserved slot, then attend
            self._write_token(sids, li, k1[:, 0], v1[:, 0])
            frames = self.kv.frames_view()
            qh = q[:, 0].reshape(B, cfg.num_kv_heads, G, cfg.head_dim)
            starts = (torch.clamp(eff - spec.window, min=0)
                      if spec.window is not None else None)
            att = paged_attention(qh, frames, frames, k_pt[li], eff,
                                  v_page_table=v_pt[li], starts=starts,
                                  backend=self.backend)
            dispatch.drain_meters_into(self.meter)
            a = att.reshape(B, 1, cfg.num_heads, cfg.head_dim)
            y = torch.einsum("bshk,hkd->bsd", a, bp["attn"]["wo"].to(dt))
            h = h + y
            if "mlp" in bp:
                hn2 = L.rms_norm(h, bp["norm2"]["scale"], cfg.norm_eps)
                h = h + L.mlp(bp["mlp"], hn2, cfg.mlp_gated)
        h = L.rms_norm(h, self.params["final_norm"]["scale"], cfg.norm_eps)
        logits = L.output_logits(self.params["embed"], cfg, h)[:, 0]
        toks_new = sample(logits).tolist()     # greedy, as in the reference
        for i, (r, s) in enumerate(zip(reqs, sids)):
            self.kv.seqs[s].length += 1
            self._keep(r, logits[i])
            t = int(toks_new[i])
            r.out_tokens.append(t)
            if t == self.eos_id or len(r.out_tokens) >= r.max_tokens:
                r.done = True

    def _write_token(self, sids, layer, k_rows, v_rows) -> None:
        """k_rows/v_rows: (B, K, hd) for one layer at each seq's current pos."""
        kv = self.kv
        kf, vf, slots = [], [], []
        for s in sids:
            seq = kv.seqs[s]
            col, slot = divmod(seq.length, kv.Tp)
            kf.append(seq.k_pages[layer, col])
            vf.append(seq.v_pages[layer, col])
            slots.append(slot)
        B = len(sids)
        row = kv.K * kv.hd
        kv.pool.write_rows(kv.dtype, kf, slots, k_rows.reshape(B, -1), row)
        kv.pool.write_rows(kv.dtype, vf, slots, v_rows.reshape(B, -1), row)

    # -- scheduler ------------------------------------------------------------------

    def step(self) -> List[int]:
        """One engine iteration: admit one waiting request (prefill), then
        decode all active. Returns finished request ids."""
        if self.waiting:
            rid = self.waiting.pop(0)
            self._prefill(self.requests[rid])
            self.active.append(rid)
        if self.active:
            self._decode_batch(self.active)
        finished = [r for r in self.active if self.requests[r].done]
        for r in finished:
            self.active.remove(r)
            self.kv.free_seq(self.requests[r].seq_id)
        return finished

    def run_to_completion(self, max_steps: int = 1000):
        steps = 0
        while (self.waiting or self.active) and steps < max_steps:
            self.step()
            steps += 1
        return {r.req_id: r.out_tokens for r in self.requests.values()}
