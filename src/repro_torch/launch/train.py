"""Training driver.

Runs real steps on one device (``--device``, default ``cuda``).  Supports
checkpoint/restart (--resume), simulated failure (--fail-at) and gradient
compression; the fork-based elastic join is what ``chip_smoke.py``'s
train phase drives.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch train-100m \\
      --steps 200 --batch 8 --seq 256 --ckpt-dir /tmp/ckpt
  PYTHONPATH=src python -m repro_torch.launch.train --arch micro-hello \\
      --steps 40 --batch 4 --seq 64 --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from types import SimpleNamespace

import torch

from repro_torch.configs.base import get_arch, reduce_for_smoke
from repro_torch.models import lm
from repro_torch.models.flops import param_counts
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.data import Prefetcher, TokenStream
from repro_torch.training.optimizer import init_opt_state
from repro_torch.training.train_step import TrainConfig, make_train_step


def main(argv=None):
    """Train; returns the loss of every step."""
    return run(argv).losses


def run(argv=None) -> SimpleNamespace:
    """Train; returns the config and the ``TrainConfig``, the loss of every
    step and each step's wall seconds (each step ends in a device sync:
    its loss is read)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="train-100m")
    ap.add_argument("--smoke", action="store_true",
                    help="reduce the arch config to smoke scale")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-compression", choices=["none", "bf16"],
                    default="none")
    ap.add_argument("--remat", choices=["none", "full", "dots"], default="none")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--fail-at", type=int, default=-1,
                    help="simulate a crash after N steps (tests restart)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)

    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = reduce_for_smoke(cfg)
    cfg = dataclasses.replace(cfg, compute_dtype="float32",
                              microbatches=args.microbatches)
    N, Na, _ = param_counts(cfg)
    print(f"[train] arch={cfg.name} params={N/1e6:.1f}M active={Na/1e6:.1f}M "
          f"batch={args.batch} seq={args.seq} device={device}")

    tcfg = TrainConfig(
        peak_lr=args.lr, warmup=args.warmup, total_steps=args.steps,
        microbatches=args.microbatches,
        grad_dtype="bfloat16" if args.grad_compression == "bf16" else "float32",
        remat=args.remat, q_chunk=max(256, args.seq // 4),
        xent_chunk=min(256, args.seq))
    step_fn = make_train_step(cfg, tcfg)

    start = 0
    if args.resume and args.ckpt_dir and ckpt.latest_step(args.ckpt_dir) is not None:
        start, params, opt_state, extra = ckpt.load_checkpoint(
            args.ckpt_dir, device=device)
        print(f"[train] resumed from step {start}")
    else:
        params = lm.init_params(
            cfg, torch.Generator(device=device).manual_seed(args.seed), device)
        opt_state = init_opt_state(params)

    stream = TokenStream(cfg.vocab_size, args.batch, args.seq, seed=args.seed,
                         codebooks=cfg.num_codebooks)
    pf = Prefetcher(stream, start_step=start)
    losses, step_s = [], []
    t0 = time.perf_counter()
    try:
        for step in range(start, args.steps):
            tok, lab = pf.next()
            ts = time.perf_counter()
            params, opt_state, metrics = step_fn(
                params, opt_state, torch.from_numpy(tok).to(device),
                torch.from_numpy(lab).to(device))
            losses.append(float(metrics["loss"]))
            step_s.append(time.perf_counter() - ts)
            if step % args.log_every == 0 or step == args.steps - 1:
                dt = time.perf_counter() - t0
                tput = (step - start + 1) * args.batch * args.seq / max(dt, 1e-9)
                print(f"step {step:5d} loss {losses[-1]:.4f} "
                      f"gnorm {float(metrics['gnorm']):.3f} "
                      f"lr {float(metrics['lr']):.2e} tok/s {tput_fmt(tput)}")
            if args.ckpt_dir and args.save_every and \
                    (step + 1) % args.save_every == 0:
                ckpt.save_checkpoint(args.ckpt_dir, step + 1, params,
                                     opt_state, extra={"loss": losses[-1]})
            if args.fail_at >= 0 and step + 1 >= args.fail_at:
                print(f"[train] simulated crash at step {step + 1}")
                raise SystemExit(42)
    finally:
        pf.close()
    print(f"[train] done: loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    return SimpleNamespace(cfg=cfg, tcfg=tcfg, losses=losses, step_s=step_s)


def tput_fmt(x: float) -> str:
    return f"{x/1e3:.1f}k" if x > 1e3 else f"{x:.0f}"


if __name__ == "__main__":
    main()
