"""End-to-end elastic training: data-parallel, sharded, with a crash and
MITOSIS-style scale-up.  Train a ~100M-param LM on a data-parallel mesh of
2 ranks with params and AdamW state sharded by ``param_pspec`` (ZeRO-3
over ``data``), checkpoint and restart after a simulated crash, then add
workers: one joins by REMOTE-FORKING the training state (descriptor +
on-demand page pull) instead of reading the checkpoint, and training goes
on on 4 ranks -- the paper's "no provisioned concurrency" applied to
elastic training.

One ``torch.multiprocessing`` spawn starts 4 ranks (``--backend``, default
gloo; every rank on ``cuda:rank % device_count``, or the CPU):

1. ranks 0-1 train to ``steps/3`` on the 2-rank sub-mesh, save a
   checkpoint, "crash", restart from it and train to ``2 steps/3``;
   ranks 2-3 stand by as the joiners-to-be;
2. rank 0 holds both ``NodeRuntime``s, as the reference's single process
   does: it packs the gathered state with registers ``step`` and
   ``count`` on the donor, forks it to the joiner (lazy, prefetch 1) and
   materializes it there;
3. the joiner's tree is laid out over the 4-rank mesh by its placements,
   and the 4 ranks train to ``steps``.  The last loss must be below the
   first.

``--check`` adds the checks ``chip_smoke.py``'s distributed phase reads:
steps 0 and 1 on 2 ranks, each against a single-rank step from the same
state and tokens (lr is 0 at step 0 under warmup, so step 1 holds the
sharded AdamW update); the restored state against the saved one, and the
joiner's against the donor's, bit for bit; the first 4-rank step taken from the
joiner's state and, again, from the donor's; and which collectives the
backend takes on the device's tensors.

  PYTHONPATH=src python -m repro_torch.launch.elastic --steps 12 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.elastic --full-100m \\
      --steps 12 --batch 8 --seq 512
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time
from datetime import timedelta
from types import SimpleNamespace

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.configs.base import get_arch, reduce_for_smoke
from repro_torch.core.descriptor import flatten_with_names
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.distributed import comm
from repro_torch.distributed.sharding import make_axis_env
from repro_torch.distributed.train_step import (gather_tree, local_nbytes,
                                                make_sharded_train_step,
                                                scatter_state, shard_tree)
from repro_torch.kernels import dispatch
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import lm
from repro_torch.models.flops import param_counts
from repro_torch.training.checkpoint import checkpoint_nbytes
from repro_torch.training.data import TokenStream
from repro_torch.training.optimizer import init_opt_state, tree_map
from repro_torch.training.train_step import TrainConfig, make_train_step

WORLD = 4
GROUP_TIMEOUT = timedelta(seconds=60)     # any one collective
JOIN_WAIT = timedelta(seconds=300)        # ranks 1-3 waiting for the join


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--full-100m", action="store_true",
                    help="use the full ~100M config (slow on CPU)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default="gloo")
    ap.add_argument("--check", action="store_true",
                    help="also run the checks chip_smoke.py reads")
    args = ap.parse_args(argv)
    if args.check and args.steps < 6:
        ap.error("--check takes steps 0 and 1 before the crash at steps/3: "
                 "give --steps 6 or more")
    return args


def config(args):
    """The reference's train-100m (or its smoke cut, widened to d_model
    256) in float32, and its train config."""
    cfg = get_arch("train-100m")
    if not args.full_100m:
        cfg = dataclasses.replace(reduce_for_smoke(cfg), d_model=256,
                                  d_ff=1024, vocab_size=4096)
    cfg = dataclasses.replace(cfg, compute_dtype="float32")
    tcfg = TrainConfig(peak_lr=1e-3, warmup=5, total_steps=args.steps,
                       q_chunk=args.seq, xent_chunk=args.seq)
    return cfg, tcfg


def main(argv=None):
    """Train; returns the loss of every step."""
    return run(argv).losses


def run(argv=None) -> SimpleNamespace:
    """Spawn the 4 ranks and train; returns rank 0's record (losses, each
    step's synced seconds and data-parallel size, the fork's and the
    checkpoint's numbers, collective and kernel counts, the checks) and
    ``ranks``, every rank's own (state bytes, peak device memory)."""
    args = parse_args(argv)
    cfg, _ = config(args)
    print(f"[elastic] {cfg.name}: {param_counts(cfg)[0]/1e6:.1f}M params "
          f"on {WORLD} ranks ({args.device}, {args.backend})")
    ranks = spawn(_train, (args,), WORLD, args.backend, args.device)
    losses = ranks[0]["losses"]
    print(f"[elastic] OK: {losses[0]:.4f} -> {losses[-1]:.4f} across "
          f"crash-restart and 2->4 elastic resize")
    return SimpleNamespace(cfg=cfg, ranks=ranks, **ranks[0])


def spawn(fn, fn_args=(), world=WORLD, backend="gloo", device="cuda"):
    """Runs ``fn(rank, device, store, tmp, *fn_args)`` on ``world`` ranks,
    each a process started by ``spawn`` and joined to one process group
    (``backend``, a ``FileStore`` in the temporary directory ``tmp`` that
    all of them share, a ``GROUP_TIMEOUT`` on each collective); ``device``
    is ``cuda:rank % device_count`` for "cuda".  ``fn`` must be importable
    by name.  If one rank raises, the others are ended and this raises.
    Returns every rank's return value, in rank order."""
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_rank_main, args=(fn, fn_args, world, backend, device, tmp),
                 nprocs=world, join=True)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"))
                for r in range(world)]


def _rank_main(rank, fn, fn_args, world, backend, device, tmp):
    device = torch.device(device)
    if device.type == "cuda":
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    else:                       # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    store = dist.FileStore(os.path.join(tmp, "store"), world)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world, timeout=GROUP_TIMEOUT)
    try:
        out = fn(rank, device, store, tmp, *fn_args)
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _state(params, opt):
    return {"params": params, "opt_m": opt["m"], "opt_v": opt["v"]}


def _gathered(params, opt):
    """Rank 0's own copy of the sharded params and AdamW state, full; None
    on the other ranks.  Every rank of the mesh calls it."""
    params, opt = gather_tree(params), gather_tree(opt)
    if dist.get_rank() != 0:
        return None
    # a replicated leaf (and ``count``) comes back as the live tensor itself
    return tree_map(torch.clone, params), tree_map(torch.clone, opt)


def _train(rank, device, store, tmp, args) -> dict:
    cfg, tcfg = config(args)
    dispatch.reset_launches()
    comm.reset()
    stream = TokenStream(cfg.vocab_size, args.batch, args.seq, seed=0)
    # creating a mesh's groups is collective: every rank makes both
    mesh2 = make_test_mesh(2, 1, device_type=device.type, ranks=[0, 1])
    mesh4 = make_test_mesh(4, 1, device_type=device.type)
    crash_at, join_at = args.steps // 3, 2 * args.steps // 3
    out = {"rank": rank, "losses": [], "step_s": [], "dp": [], "comm": {},
           "checks": {}, "state_bytes": {}}

    def tokens(s):
        return [torch.from_numpy(a).to(device) for a in stream.batch_at(s)]

    def metered(key):
        """Moves the collectives counted since the last call to ``key``."""
        acc = out["comm"].setdefault(key, {})
        for kind, s in comm.snapshot().items():
            a = acc.setdefault(kind, {"calls": 0, "bytes": 0, "seconds": 0.0})
            for k in a:
                a[k] += s[k]
        comm.reset()

    def train(step, params, opt, lo, hi, dp):
        for s in range(lo, hi):
            tok, lab = tokens(s)
            t0 = time.perf_counter()
            params, opt, m = step(params, opt, tok, lab)
            out["losses"].append(float(m["loss"]))        # syncs
            out["step_s"].append(time.perf_counter() - t0)
            out["dp"].append(dp)
        metered(f"train_dp{dp}")
        return params, opt, (m if hi > lo else None)

    state = got = regs = None
    if rank < 2:
        # ---- phase 1: dp=2, crash at 1/3 of the run, restart from checkpoint
        env = make_axis_env(mesh2)
        step = make_sharded_train_step(cfg, tcfg, env)
        full = lm.init_params(
            cfg, torch.Generator(device=device).manual_seed(0), device)
        params = shard_tree(full, cfg, env)
        opt = init_opt_state(params)
        out["state_bytes"]["dp2"] = local_nbytes(_state(params, opt))
        out["full_state_bytes"] = 3 * sum(
            t.nbytes for t in flatten_with_names(full)[2])
        lo = 0
        if args.check:
            # (a) steps 0 (lr 0: the gradient, through AdamW's m) and 1 (the
            # first update) against one rank's steps from the same state
            before = (full, init_opt_state(full)) if rank == 0 else None
            a = {}
            for s in (0, 1):
                if s:
                    before = _gathered(params, opt)
                    metered("check")
                params, opt, m = train(step, params, opt, s, s + 1, 2)
                a[f"step{s}"] = _single_rank_check(cfg, tcfg, before, params,
                                                   opt, m, tokens(s))
                metered("check")
            if rank == 0:
                out["checks"]["a"] = a
            del before
            lo = 2
        del full
        params, opt, _ = train(step, params, opt, lo, crash_at, 2)
        ckpt_dir = os.path.join(tmp, "ckpt")
        t0 = time.perf_counter()
        ckpt.save_checkpoint(ckpt_dir, crash_at, params, opt)
        out["checkpoint"] = {"save_s": time.perf_counter() - t0}
        saved = _locals(_state(params, opt)) if args.check else None
        del params, opt                             # CRASH (simulated)
        t0 = time.perf_counter()
        step0, params, opt, _ = ckpt.load_checkpoint(
            ckpt_dir, device=device, env=env, cfg=cfg)
        _sync(device)
        out["checkpoint"]["load_s"] = time.perf_counter() - t0
        if rank == 0:
            out["checkpoint"]["bytes"] = checkpoint_nbytes(ckpt_dir,
                                                           crash_at)
        metered("checkpoint")
        if saved is not None:
            out["checks"]["b"] = {
                "restored_bit_equal": _bit_equal(
                    saved, _locals(_state(params, opt))),
                "count_restored": int(opt["count"]) == crash_at}
        if rank == 0:
            print(f"[elastic] dp=2 trained to step {crash_at}, CRASH "
                  f"(simulated); restarted from step {step0}")
        params, opt, _ = train(step, params, opt, step0, join_at, 2)

        # ---- phase 2: rank 0 forks the state to the joiner (no checkpoint IO)
        state = gather_tree(_state(params, opt))
        count = int(opt["count"])
        del params, opt
        metered("join")
        if rank == 0:
            got, regs, out["fork"] = fork_state(
                cfg.name, state, {"step": join_at, "count": count}, device)
            if args.check:
                out["checks"]["c"] = {
                    "joiner_bit_equal": _bit_equal(
                        flatten_with_names(got)[2],
                        flatten_with_names(state)[2]),
                    "registers_equal": regs == {"step": join_at,
                                                "count": count}}
            print(f"[elastic] worker joined via remote fork in "
                  f"{out['fork']['fork_wall_s']*1e3:.0f} ms "
                  f"({out['fork']['pages_rdma']} pages, descriptor "
                  f"{out['fork']['descriptor_bytes']} B — no checkpoint "
                  f"read)")
            store.set("joined", "1")
        if rank != 0 or not args.check:
            state = None
    if rank != 0:
        store.wait(["joined"], JOIN_WAIT)

    # ---- phase 3: the joiner's state over the 4-rank mesh
    env = make_axis_env(mesh4)
    if args.check:
        out["collectives"] = comm.probe(mesh4.get_group("data"), device)
    regs = comm.broadcast_object(regs, mesh4)
    params, opt = _layout(got, regs, cfg, env, device)
    del got
    out["state_bytes"]["dp4"] = local_nbytes(_state(params, opt))
    metered("join")
    step = make_sharded_train_step(cfg, tcfg, env)
    start = regs["step"]
    if args.check:
        dparams, dopt = _layout(state, regs, cfg, env, device)
        del state
        dparams, dopt, dm = step(dparams, dopt, *tokens(start))
        metered("check")
        params, opt, m = train(step, params, opt, start, start + 1, 4)
        out["checks"]["d"] = _same_step(params, dparams, m, dm)
        del dparams, dopt
        start += 1
    params, opt, _ = train(step, params, opt, start, args.steps, 4)
    out["peak_device_bytes"] = (torch.cuda.max_memory_allocated(device)
                                if device.type == "cuda" else None)
    if rank == 0:
        out["kernels"] = {"launches": dict(dispatch.launches),
                          "pages": dict(dispatch.pages_moved),
                          "routes": dict(dispatch.routes)}
        out["allow_tf32"] = torch.backends.cuda.matmul.allow_tf32
        losses = out["losses"]
        print(f"[elastic] dp=4 continued to step {args.steps}, final loss "
              f"{losses[-1]:.4f}")
        if not losses[-1] < losses[0]:
            raise AssertionError(f"loss must decrease across crash + "
                                 f"resize: {losses}")
    return out


def _layout(tree, regs, cfg, env, device):
    """Rank 0's gathered or forked state (None elsewhere) as sharded params
    and AdamW state over ``env.mesh``, ``count`` from the registers."""
    if tree is None:
        return scatter_state(None, None, cfg, env, device)
    count = torch.tensor(regs["count"], dtype=torch.int32, device=device)
    return scatter_state(tree["params"], {"m": tree["opt_m"],
                                          "v": tree["opt_v"],
                                          "count": count}, cfg, env, device)


def fork_state(arch: str, state, registers, device):
    """Pack ``state`` with ``registers`` on a donor node (device pools,
    frames reserved), fork it to a joiner (lazy, prefetch 1) and
    materialize it there.  Returns the joiner's tree, its registers and
    the fork's numbers (wall seconds from ``resume_on`` to materialized,
    synced)."""
    from repro_torch.core.instance import ModelInstance
    from repro_torch.fork import ForkPolicy
    from repro_torch.memory.paging import num_pages
    from repro_torch.memory.pool import PAGE_ELEMS
    from repro_torch.net import Network
    from repro_torch.platform.node import NodeRuntime
    leaves = flatten_with_names(state)[2]
    frames = sum(num_pages(t.numel(), PAGE_ELEMS) for t in leaves)
    net = Network()
    donor, joiner = (NodeRuntime(n, net, cache_enabled=True,
                                 device_pool=True, device=device,
                                 pool_frames=frames)
                     for n in ("donor", "joiner"))
    inst = ModelInstance.create(donor, arch, state, registers=registers)
    handle = donor.prepare_fork(inst)
    _sync(device)
    t0 = time.perf_counter()
    child = handle.resume_on(joiner, ForkPolicy(lazy=True, prefetch=1))
    got = child.materialize_pytree()
    _sync(device)
    return got, dict(child.registers), {
        "fork_wall_s": time.perf_counter() - t0, "frames": frames,
        "pages_rdma": child.stats["pages_rdma"], "sim_time_s": net.sim_time,
        "state_bytes": sum(t.numel() * t.element_size() for t in leaves),
        "descriptor_bytes": len(donor.seeds[handle.handler_id].blob)}


def _locals(tree):
    return [x.to_local().clone() if hasattr(x, "to_local") else x.clone()
            for x in flatten_with_names(tree)[2]]


def _bits(t):
    """``t``'s bytes as integers of its width, so that -0.0 != 0.0."""
    t = t.contiguous()
    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


def _bit_equal(a, b) -> bool:
    return len(a) == len(b) and all(
        x.dtype == y.dtype and x.shape == y.shape
        and torch.equal(_bits(x), _bits(y)) for x, y in zip(a, b))


def _single_rank_check(cfg, tcfg, before, params, opt, m, tok_lab):
    """A step just taken on the sharded ranks (``params``, ``opt``, its
    metrics ``m``) against one rank's step from the same state ``before``
    (rank 0's full params and AdamW state, None elsewhere; the step updates
    it in place) and tokens: rank 0 takes the step, every rank gathers,
    rank 0 compares and returns loss, gnorm, params and AdamW ``m`` apart;
    None on the others."""
    first = dist.get_rank() == 0
    if first:
        rp, ro, rm = make_train_step(cfg, tcfg)(*before, *tok_lab)
    errors = state_errors(params, opt["m"], rp if first else None,
                          ro["m"] if first else None)
    if not first:
        return None
    lr = float(rm["lr"])
    out = {"loss": float(m["loss"]), "single_loss": float(rm["loss"]),
           "gnorm": float(m["gnorm"]), "single_gnorm": float(rm["gnorm"]),
           "lr": lr, "sharded_lr": float(m["lr"])}
    out["loss_rel_err"] = abs(out["loss"] - out["single_loss"]) / abs(
        out["single_loss"])
    out["gnorm_rel_err"] = abs(out["gnorm"] - out["single_gnorm"]) / abs(
        out["single_gnorm"])
    return {**out, **errors}


def state_errors(params, m, want, want_m) -> dict:
    """Sharded ``params`` and AdamW ``m`` against whole ones (``want``,
    ``want_m``, given on the mesh's first rank only), leaf by leaf, each
    gathered in turn into that rank (every rank calls): the largest
    param difference, the
    share of elements further than 1e-5 relative (+1e-7), and ``m``'s
    largest difference over the CPU parity tests' gradient tolerance
    (1e-4 relative + 1e-5 of the leaf's largest magnitude; ``m = b1 m0 +
    (1 - b1) g s`` with ``m0`` the same on both sides, so its gradient
    part differs, to the clip scale).  {} on the other ranks."""
    first = want is not None
    wp = flatten_with_names(want)[2] if first else None
    wm = flatten_with_names(want_m)[2] if first else None
    diff, far, n, ratio = 0.0, 0, 0, 0.0
    for i, (x, mx) in enumerate(zip(flatten_with_names(params)[2],
                                    flatten_with_names(m)[2])):
        a, am = comm.gather(x, first_only=True), comm.gather(
            mx, first_only=True)
        if first:
            d = (a - wp[i]).abs()
            diff = max(diff, float(d.max()))
            far += int((d > 1e-5 * wp[i].abs() + 1e-7).sum())
            n += d.numel()
            b = wm[i]
            tol = 1e-4 * b.abs() + 1e-5 * float(b.abs().max()) + 1e-30
            ratio = max(ratio, float(((am - b).abs() / tol).max()))
        del a, am
    if not first:
        return {}
    return {"params_max_abs_diff": diff, "params_far_share": far / n,
            "m_err_over_grad_tol": ratio}


def _same_step(params, dparams, m, dm) -> dict:
    """The first 4-rank step from the joiner's state (``params``, ``m``)
    against the same step from the donor's: losses bit for bit, and which
    param leaves differ on this rank's shards, by how much."""
    differ, diff = [], 0.0
    names = flatten_with_names(params)[0]
    for name, a, b in zip(names, _locals(params), _locals(dparams)):
        if not torch.equal(_bits(a), _bits(b)):
            differ.append(name)
            diff = max(diff, float((a - b).abs().max()))
    return {"loss": float(m["loss"]), "donor_loss": float(dm["loss"]),
            "loss_bit_equal": bool(torch.equal(_bits(m["loss"]),
                                               _bits(dm["loss"]))),
            "params_differ": differ, "params_max_abs_diff": diff,
            "lr": float(m["lr"])}


if __name__ == "__main__":
    main()
