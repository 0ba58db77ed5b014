"""The training step: microbatch gradient accumulation, remat policy from
the arch config, optional gradient "compression" (bf16 accumulators, as
the reference keeps for its bf16 cross-replica all-reduces), AdamW + clip
+ schedule.

Gradients come from ``torch.autograd.grad`` over the params' leaves, in
the reference's leaf order.  Microbatches are accumulated in a Python
loop (``scan.scan``), each microbatch's gradient cast to ``grad_dtype``
and then added, as the reference's ``lax.scan`` does.  The step updates params and
optimizer state in place and returns them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch.distributed.tensor import DTensor

from repro_torch import _dtypes
from repro_torch.configs.base import ArchConfig
from repro_torch.core.descriptor import flatten_with_names, unflatten_from_paths
from repro_torch.models import lm
from repro_torch.models.scan import scan
from repro_torch.training.optimizer import AdamWConfig, adamw_update
from repro_torch.training.schedule import warmup_cosine


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    peak_lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 10000
    microbatches: int = 1
    grad_dtype: str = "float32"      # "bfloat16" = compressed accumulators
    remat: Optional[str] = None      # None -> cfg.remat_policy
    q_chunk: int = 1024
    exact_causal: bool = False
    xent_chunk: int = 512
    adamw: AdamWConfig = AdamWConfig()


def _local(x) -> torch.Tensor:
    return x.to_local() if isinstance(x, DTensor) else x


def make_loss_and_grads(cfg: ArchConfig, tcfg: TrainConfig):
    """Returns loss_and_grads(paths, leaves, tokens, labels) -> (loss,
    grads): the mean loss over ``tokens``' rows and each leaf's gradient
    in ``grad_dtype``, accumulated over ``tcfg.microbatches``.  A DTensor
    leaf (the sharded step's group leaves, which the layer loop gathers
    itself) gets its local part's gradient as the gathers' backward
    leaves it: this rank's shard, already reduced."""
    gdt = _dtypes.torch_dtype(tcfg.grad_dtype)

    def value_and_grad(paths, leaves, tok, lab):
        xs = [p.detach().requires_grad_() for p in leaves]
        loss = lm.loss_fn(unflatten_from_paths(paths, xs), cfg, tok, lab,
                          q_chunk=tcfg.q_chunk,
                          exact_causal=tcfg.exact_causal, remat=tcfg.remat,
                          xent_chunk=tcfg.xent_chunk)
        grads = torch.autograd.grad(loss, xs, allow_unused=True)
        return loss.detach(), [torch.zeros_like(_local(x)) if g is None
                               else _local(g) for x, g in zip(xs, grads)]

    def loss_and_grads(paths, leaves, tokens, labels):
        mb = tcfg.microbatches
        B = tokens.shape[0]
        if B % mb:
            raise ValueError(f"batch {B} is not a multiple of {mb} "
                             f"microbatches")
        if mb == 1:
            loss, grads = value_and_grad(paths, leaves, tokens, labels)
            return loss, [g.to(gdt) for g in grads]
        split = lambda t: t.reshape((mb, B // mb) + tuple(t.shape[1:]))
        toks, labs = split(tokens), split(labels)
        grads = [torch.zeros(_local(p).shape, dtype=gdt,
                             device=_local(p).device)
                 for p in leaves]

        def step(i, loss):
            l, g = value_and_grad(paths, leaves, toks[i], labs[i])
            with torch.no_grad():
                for acc, gi in zip(grads, g):
                    acc.add_(gi.to(gdt))
            del g
            return loss + l, None

        loss, _ = scan(step, torch.zeros((), dtype=torch.float32,
                                         device=tokens.device), mb)
        return loss / mb, [g.div_(mb) for g in grads]

    return loss_and_grads


def make_train_step(cfg: ArchConfig, tcfg: TrainConfig):
    """Returns train_step(params, opt_state, tokens, labels) -> (params,
    opt_state, metrics). tokens/labels: (B, S) int (or (B, S, CB));
    metrics holds float32 scalar tensors ``loss``, ``gnorm`` and ``lr``."""
    loss_and_grads = make_loss_and_grads(cfg, tcfg)

    def train_step(params, opt_state, tokens, labels):
        _, paths, leaves = flatten_with_names(params)
        loss, grads = loss_and_grads(paths, leaves, tokens, labels)
        lr = warmup_cosine(opt_state["count"], peak_lr=tcfg.peak_lr,
                           warmup=tcfg.warmup, total=tcfg.total_steps)
        params, opt_state, gnorm = adamw_update(
            params, unflatten_from_paths(paths, grads), opt_state, lr,
            tcfg.adamw)
        return params, opt_state, {"loss": loss, "gnorm": gnorm, "lr": lr}

    return train_step


def make_serve_prefill(cfg: ArchConfig, cache_len: int, q_chunk: int = 1024):
    """prefill(params, tokens) -> (last_logits, caches)."""
    def serve_prefill(params, tokens):
        return lm.prefill(params, cfg, tokens, cache_len, q_chunk=q_chunk)
    return serve_prefill


def make_serve_decode(cfg: ArchConfig):
    def serve_decode(params, caches, token, pos):
        return lm.decode_step(params, cfg, caches, token, pos)
    return serve_decode
