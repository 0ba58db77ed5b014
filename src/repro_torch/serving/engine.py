"""Serving engine: continuous batching over a paged KV cache, with
fork-based prefix sharing (the MITOSIS state-transfer path).

Serves the attention architectures, GQA blocks or latent-attention ones
(MLASpec, models/mla.py), each with a dense or an MoE MLP, through the
model layer's own pieces: each layer's paged decode (``lm.PAGED_DECODE``,
chosen once per layer at construction by its spec's type) and the
block's tail (``lm.block_mlp``).  Recurrent archs (Mamba2, xLSTM) decode
through ``lm.decode_step``'s O(1) states instead, and the engine refuses
them as the reference's does.  The decode attention runs through
kernels/paged_attention or the latent kernel (kernels/paged_attention/
latent.py), the CUDA kernel on the card, its plain version on the CPU,
reading the cache directly from the pool's frames tensor: children
created by `fork_request` attend over the parent's pages with zero copies.

The cache's layout is decided at construction: a latent model's holds one
row per token and layer and no V pages.  A latent layer decodes inside an
``attn.latent`` span, and the bytes the latent kernel needs are counted
in ``mla.latent_bytes`` once a step, from the host lengths.  Every kind
shares one step body.

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
import functools
from typing import Dict, List, Optional

import torch

from repro_torch import _dtypes, tracing
from repro_torch.configs.base import ArchConfig, AttnSpec, MLASpec
from repro_torch.kernels.paged_attention.latent import latent_bytes
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.serving import graph
from repro_torch.serving.kv_cache import PagedKV
from repro_torch.serving.sampling import sample


def _in_span(name, decode):
    """``decode`` run inside a ``name`` span."""
    def run(*args, **kw):
        with tracing.span(name):
            return decode(*args, **kw)
    return run


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
        if len({s.latent_dim for s in mla}) > 1:
            raise ValueError("latent rows of one width in every layer")
        self.latent = bool(mla)
        # the cache's layout: heads, row width, the prefill cache's keys
        heads, width, self._cache_keys = (
            (1, mla[0].latent_dim, ("c",)) if self.latent
            else (cfg.num_kv_heads, cfg.head_dim, ("k", "v")))
        self.params = params
        self.device = torch.device(device)
        self.kv = PagedKV(cfg.num_layers, heads, width,
                          page_tokens=page_tokens, dtype=cfg.compute_dtype,
                          device=self.device, kernel_backend=backend,
                          latent=self.latent)
        self.backend = backend
        self.eos_id = eos_id
        self.keep_logits = keep_logits
        self.requests: Dict[int, Request] = {}
        self.active: List[int] = []
        self.waiting: List[int] = []
        self._rid = 0
        self._layers = self._flatten_blocks()
        self._inputs: Optional[graph.StepInputs] = None  # the step's buffers
        self._graph: Optional[graph.StepGraph] = None  # its captured step

    def _flatten_blocks(self):
        """Each layer's (spec, param slices, paged decode): the params
        unstacked views for the python-loop path, the decode chosen by the
        spec's type (``lm.PAGED_DECODE``), a latent layer's inside an
        ``attn.latent`` span."""
        out = []
        for g, gp in zip(self.cfg.groups, self.params["groups"]):
            for r in range(g.repeat):
                for bi, spec in enumerate(g.unit):
                    bp = gp["blocks"][bi]
                    if not getattr(spec, "shared", False):
                        bp = lm._index_tree(bp, r)
                    decode = lm.PAGED_DECODE[type(spec)]
                    if isinstance(spec, MLASpec):
                        decode = _in_span("attn.latent", decode)
                    out.append((spec, bp, decode))
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
        names = self._cache_keys
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
        nothing else: embedding, every layer (its paged decode writes the
        token's rows and attends, then the block's tail), final norm, head,
        greedy token.  Returns (logits (B, V), tokens (B,))."""
        cfg = self.cfg
        B = x.B
        dt = _dtypes.torch_dtype(cfg.compute_dtype)
        # every layer's write targets, derived on the device: the frame of
        # each sequence's column pos // Tp in each table, and slot pos % Tp
        cols = (x.pos // self.kv.Tp).long()
        at = ([pt.gather(2, cols.expand(pt.shape[0], B)[..., None])[..., 0]
               .long() for pt in x.tables], (x.pos % self.kv.Tp).long())
        frames = self.kv.frames_view()
        h = L.embed_tokens(self.params["embed"], cfg, x.tokens[:, None], dt)
        for li, (spec, bp, decode) in enumerate(self._layers):
            hn = L.rms_norm(h, bp["norm1"]["scale"], cfg.norm_eps)
            h = h + decode(bp["attn"], hn, spec, cfg, x.pos,
                           write=functools.partial(self._write_token, at, li),
                           frames=frames, tables=[t[li] for t in x.tables],
                           lengths=x.eff, backend=self.backend)
            h = lm.block_mlp(bp, h, cfg, spec)
        h = L.rms_norm(h, self.params["final_norm"]["scale"], cfg.norm_eps)
        logits = L.output_logits(self.params["embed"], cfg, h)[:, 0]
        return logits, sample(logits)      # greedy, as in the reference

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
