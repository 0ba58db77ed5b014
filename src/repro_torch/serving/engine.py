"""Serving engine: continuous batching over a paged KV cache, with
fork-based prefix sharing (the MITOSIS state-transfer path).

Serves the dense and MoE attention architectures through a paged decode
forward built from the same layer primitives as the model
(models/layers.py, models/moe.py); recurrent archs (Mamba2, xLSTM) decode
through ``lm.decode_step``'s O(1) states instead, and the engine refuses
them as the reference's does.  The
decode attention runs through kernels/paged_attention (the CUDA kernel on
the card, its plain version on the CPU), reading KV directly from the
pool's frames tensor — children created by `fork_request` attend over the
parent's pages with zero copies.

A model of latent-attention blocks (MLASpec, models/mla.py) is decided at
construction: its cache is latent (one row per token and layer, no V
pages), and each decode layer absorbs its queries, writes the token's row
and attends through the latent kernel (kernels/paged_attention/latent.py)
inside an ``attn.latent`` span; the bytes the kernel needs are counted
in ``mla.latent_bytes`` once a step, from the host lengths.  A model of
GQA blocks takes the GQA path alone; every kind shares one step body.

A decode step (``_decode_batch``) reserves its slots eagerly, copies its
inputs once into static buffers (serving/graph.py), and runs one body
that reads nothing from the host: each layer's write targets come from
the uploaded tables on the device.  On a CUDA device the body is captured
as a CUDA graph for each key (batch, tables' width, the pool's frames
tensor) and replayed, with ``serve.capture`` around the capture; spans
inside the body (``attn.latent``) then open only while it is captured.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch

from repro_torch import _dtypes, tracing
from repro_torch.configs.base import ArchConfig, AttnSpec, MLASpec
from repro_torch.kernels.paged_attention.latent import (latent_attention,
                                                        latent_bytes)
from repro_torch.kernels.paged_attention.ops import paged_attention
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE
from repro_torch.serving import graph
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
    (kernels/dispatch.py); as in the reference, the engine keeps no meter
    of its own.  ``keep_logits`` stores each generated token's logits on
    its request, for checking against the non-paged model."""

    def __init__(self, cfg: ArchConfig, params, *, page_tokens: int = 16,
                 backend: str = "auto", eos_id: int = -1, device="cuda",
                 keep_logits: bool = False):
        self.cfg = cfg
        self.specs = list(cfg.block_specs())
        gqa = sum(isinstance(s, AttnSpec) for s in self.specs)
        mla = [s for s in self.specs if isinstance(s, MLASpec)]
        if gqa + len(mla) != cfg.num_layers:
            raise ValueError("paged engine supports attention archs; "
                             "use the recurrent-state engine for SSM archs")
        if gqa and mla:
            raise ValueError("paged engine serves GQA or latent attention, "
                             "not both in one model")
        self.latent = bool(mla)
        self.params = params
        self.device = torch.device(device)
        if self.latent:
            if len({s.latent_dim for s in mla}) != 1:
                raise ValueError("latent rows of one width in every layer")
            self.kv = PagedKV(cfg.num_layers, 1, mla[0].latent_dim,
                              page_tokens=page_tokens,
                              dtype=cfg.compute_dtype, device=self.device,
                              kernel_backend=backend, latent=True)
        else:
            self.kv = PagedKV(cfg.num_layers, cfg.num_kv_heads,
                              cfg.head_dim, page_tokens=page_tokens,
                              dtype=cfg.compute_dtype, device=self.device,
                              kernel_backend=backend)
        self.backend = backend
        self.eos_id = eos_id
        self.keep_logits = keep_logits
        self.requests: Dict[int, Request] = {}
        self.active: List[int] = []
        self.waiting: List[int] = []
        self._rid = 0
        self._block_params = self._flatten_blocks()
        self._inputs: Optional[graph.StepInputs] = None  # the step's buffers
        self._graph: Optional[graph.StepGraph] = None  # its captured step

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
        if self.keep_logits:       # a copy: a replay rewrites its outputs
            req.logits.append(logits.detach().to("cpu", torch.float32,
                                                  copy=True))

    def _prefill(self, req: Request) -> None:
        toks = torch.tensor(req.prompt, dtype=torch.int32,
                            device=self.device)[None, :]
        Tp = self.kv.Tp
        cache_len = ((len(req.prompt) + Tp - 1) // Tp) * Tp
        logits, caches = lm.prefill(self.params, self.cfg, toks, cache_len)
        req.seq_id = self.kv.new_seq()
        # flatten the grouped caches into (L, S, K, hd); a latent cache's
        # rows (L, S, 1, latent_dim)
        names = ("c",) if self.latent else ("k", "v")
        flat = {n: [] for n in names}
        for g, gc in zip(self.cfg.groups, caches["groups"]):
            for r in range(g.repeat):               # execution order: repeat
                for bi in range(len(g.unit)):       # outer, unit inner
                    c = gc["blocks"][bi]
                    for n in names:
                        flat[n].append(c[n][r, 0])
        parts = [torch.stack(flat[n])[:, :len(req.prompt)] for n in names]
        parts.append(None)                  # a latent cache's V
        self.kv.write_prefill(req.seq_id, parts[0], parts[1])
        last = logits[0, -1] if logits.dim() == 3 else logits[0]
        self._keep(req, last)
        req.out_tokens.append(int(torch.argmax(last)))

    def _decode_batch(self, rids: List[int]) -> None:
        """One token for each of ``rids``: the slots reserved (alloc and
        copy-on-write, eager), the inputs copied once, then the body:
        replayed from its CUDA graph on a CUDA device (captured anew for
        each key: batch, tables' width, frames tensor), run as it is
        elsewhere."""
        reqs = [self.requests[r] for r in rids]
        sids = [r.seq_id for r in reqs]
        for s in sids:
            self.kv.ensure_writable_slot(s)
        Tp = self.kv.Tp
        # the tables padded to the batch's final width, so that a request
        # keeps one key from its first step to its last
        W = max(max(-(-(len(r.prompt) + r.max_tokens) // Tp),
                    self.kv.seqs[s].k_pages.shape[1])
                for r, s in zip(reqs, sids))
        x = self._inputs
        if x is None or (x.B, x.W) != (len(sids), W):
            x = self._inputs = graph.StepInputs(
                len(sids), self.cfg.num_layers, W, len(self.kv.tables),
                self.device)
        k_pt, v_pt, lens = self.kv.batch_tables(sids, width=W)
        x.load([r.out_tokens[-1] if r.out_tokens else r.prompt[-1]
                for r in reqs], lens, (k_pt, v_pt)[:len(self.kv.tables)])
        if self.latent and tracing.enabled():
            item = _dtypes.torch_dtype(self.cfg.compute_dtype).itemsize
            for spec in self.specs:
                tracing.count("mla.latent_bytes", latent_bytes(
                    lens + 1, self.cfg.num_heads, spec.latent_dim,
                    spec.kv_lora_rank, item))
        if graph.captures(self.device):
            f = self.kv.frames_view()
            key = (x.B, W, f.data_ptr(), f.shape[0])
            if self._graph is None or self._graph.key != key:
                self._graph = None          # its pool freed before the next
                self._graph = graph.StepGraph(key, lambda: self._body(x),
                                              self.device)
            logits, toks = self._graph.replay()
        else:
            logits, toks = self._body(x)
        toks_new = toks.tolist()
        for i, (r, s) in enumerate(zip(reqs, sids)):
            self.kv.seqs[s].length += 1
            self._keep(r, logits[i])
            t = int(toks_new[i])
            r.out_tokens.append(t)
            if t == self.eos_id or len(r.out_tokens) >= r.max_tokens:
                r.done = True

    def _body(self, x: graph.StepInputs):
        """The step on the static inputs ``x``, host values read from
        nothing else: embedding, every layer (each writes its token's rows,
        then attends), final norm, head, greedy token.  Returns (logits
        (B, V), tokens (B,))."""
        cfg = self.cfg
        B = x.B
        dt = _dtypes.torch_dtype(cfg.compute_dtype)
        # every layer's write targets, derived on the device: the frame of
        # each sequence's column pos // Tp in each table, and slot pos % Tp
        cols = (x.pos // self.kv.Tp).long()
        at = ([pt.gather(2, cols.expand(pt.shape[0], B)[..., None])[..., 0]
               .long() for pt in x.tables], (x.pos % self.kv.Tp).long())
        G = cfg.num_heads // cfg.num_kv_heads
        h = L.embed_tokens(self.params["embed"], cfg, x.tokens[:, None], dt)
        for li, (spec, bp) in enumerate(self._block_params):
            hn = L.rms_norm(h, bp["norm1"]["scale"], cfg.norm_eps)
            if self.latent:
                with tracing.span("attn.latent"):
                    h = h + self._latent_attention(at, li, spec, bp, hn, x)
                h = h + lm.mla_block_mlp(bp, h, cfg, spec)
                continue
            q, k1, v1 = L._project_qkv(bp["attn"], hn, spec, cfg,
                                       x.pos[:, None])
            # write this token's K/V into the reserved slot, then attend
            self._write_token(at, li, k1[:, 0], v1[:, 0])
            frames = self.kv.frames_view()
            qh = q[:, 0].reshape(B, cfg.num_kv_heads, G, cfg.head_dim)
            starts = (torch.clamp(x.eff - spec.window, min=0)
                      if spec.window is not None else None)
            att = paged_attention(qh, frames, frames, x.tables[0][li], x.eff,
                                  v_page_table=x.tables[1][li], starts=starts,
                                  backend=self.backend)
            a = att.reshape(B, 1, cfg.num_heads, cfg.head_dim)
            y = torch.einsum("bshk,hkd->bsd", a, bp["attn"]["wo"].to(dt))
            h = h + y
            if "mlp" in bp or "moe" in bp:
                hn2 = L.rms_norm(h, bp["norm2"]["scale"], cfg.norm_eps)
                if "moe" in bp:
                    h = h + MOE.moe_mlp(bp["moe"], hn2, cfg)
                else:
                    h = h + L.mlp(bp["mlp"], hn2, cfg.mlp_gated)
        h = L.rms_norm(h, self.params["final_norm"]["scale"], cfg.norm_eps)
        logits = L.output_logits(self.params["embed"], cfg, h)[:, 0]
        return logits, sample(logits)      # greedy, as in the reference

    def _latent_attention(self, at, li, spec, bp, hn, x: graph.StepInputs):
        """Layer ``li``'s latent attention of one token per sequence: the
        absorbed queries, the token's row written, the kernel over the
        rows (``x.eff`` of them), the heads' outputs un-absorbed."""
        q, row = MLA.absorb(bp["attn"], hn, spec, self.cfg, x.pos)
        self._write_token(at, li, row[:, None], None)
        o = latent_attention(q, self.kv.frames_view(), x.tables[0][li], x.eff,
                             dv=spec.kv_lora_rank, scale=MLA.scale_of(spec),
                             backend=self.backend)
        return MLA.unabsorb(bp["attn"], o, spec, hn.dtype)

    def _write_token(self, at, layer, k_rows, v_rows) -> None:
        """Layer ``layer``'s rows of this token, k_rows/v_rows (B, K, hd)
        (v_rows None in a latent cache), into each sequence's reserved
        slot by one ``index_put_`` a table: ``at`` is the step's write
        targets on the device, the frames (L, B) of each table and the
        slots (B,)."""
        frames, slots = at
        view = self.kv.frames_view()
        for f, rows in zip(frames, (k_rows, v_rows)):
            view.index_put_((f[layer], slots), rows.to(view.dtype))

    # -- scheduler ------------------------------------------------------------------

    def step(self) -> List[int]:
        """One engine iteration: admit one waiting request (prefill), then
        decode all active. Returns finished request ids."""
        if self.waiting:
            rid = self.waiting.pop(0)
            req = self.requests[rid]
            with tracing.span("serve.prefill", tokens=len(req.prompt)):
                self._prefill(req)
            self.active.append(rid)
        if self.active:
            with tracing.span("serve.decode", batch=len(self.active)):
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
