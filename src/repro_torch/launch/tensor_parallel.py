"""Tensor parallelism over ``model`` end to end: one spawn of 4 ranks laid
out as a data=2 x model=2 mesh (``--backend``, default gloo; every rank on
``cuda:rank % device_count``, or the CPU), each case held against one
rank's run of the same function on the same inputs:

(a) gemma3-1b (``--smoke``: its smoke cut), params and AdamW state sharded
    by ``param_pspec``, 2 sharded steps of a global batch of 4 rows, 2
    microbatches, full remat, under ``attn_policy`` "v1" (gemma's one KV
    head makes it split head_dim) and "qtp" (Q heads split, K/V whole).
    Rank 0 holds the same state whole and takes the same steps alone (lr
    is 0 at step 0 under warmup, so both start step 1 from equal params);
    loss and gnorm are compared at both steps, every param and AdamW ``m``
    after step 1 only, leaf by leaf, each gathered in turn into rank 0 (at step 0 the
    params are equal by construction, and step 1's ``m`` carries step 0's
    gradient);
(b) the same params served: a sharded prefill (caches laid out by
    ``cache_pspec``) and greedy decode steps against rank 0's
    ``lm.prefill`` / ``lm.decode_step`` on the whole params: logits and
    tokens;
(c) one moonshot MoE layer at full width (``--smoke``: smoke) over the
    experts split over ``model``, 2 rows per data shard, under
    ``moe_impl`` "shardmap" (against one rank's ``moe_mlp`` on each data
    shard) and "gspmd" (on the whole batch), at capacity factors 1.25 and
    1.0: outputs and the gradients of the input and of every param of a
    fixed linear probe of the output;
(d) one zamba2 Mamba layer at full width (``--smoke``: smoke) with
    ``mamba_tp``: output, final state and gradients;
(e) one xlstm mLSTM layer at full width (``--smoke``: smoke), its value
    columns split over ``model`` (whole heads): output, final state and
    gradients;
(g) gemma3-1b (``--smoke``: its smoke cut) served at batch 1, which does
    not divide the data axes: the attention caches are split along their
    sequence axis (``cache_pspec``, ``ctx.seq_split``), and the head_dim
    over ``model``.  Decode: a cache of long_500k's 524,288 positions
    seeded from a generator up to position 262,142, then greedy steps
    whose writes land on both data shards; prefill: a prompt of 6,000
    into a cache of 8,192, then greedy steps.  Against rank 0's
    ``lm.decode_step`` / ``lm.prefill`` on the whole cache: logits,
    tokens, and every rank's cache part against the same slice of the
    one-rank cache (bit for bit where no step wrote; the entries the
    steps wrote, computed under tensor parallelism, to rounding).

A second spawn of 8 ranks, laid out as data=1 x model=8 (``_rank8``):

(e) the same mLSTM layer, half a head on each rank (xlstm-1.3b's 4 heads
    of 1,024 over 8 ranks);
(f) musicgen-large's output head and loss at full width (``--smoke``:
    smoke), its 4 codebooks each over 2 ranks: loss and the gradients of
    the hidden states and of the head.

Rank 0's record holds each case's largest errors with the scale they are
relative to; the checks against tolerances are ``chip_smoke.py``'s.
Every rank's record holds, per case, its state bytes, its peak device
memory and its collectives (``comm.stats``), for (a) the FLOPs of its
step 0 (``FlopCounterMode``), and its kernel launches over the whole run
(``dispatch``).

  PYTHONPATH=src python -m repro_torch.launch.tensor_parallel --smoke \\
      --device cpu
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import time
from types import SimpleNamespace

import numpy as np
import torch
from torch.distributed.tensor import DTensor
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.base import GroupSpec, get_arch, reduce_for_smoke
from repro_torch.core.descriptor import (flatten_with_names,
                                         unflatten_from_paths)
from repro_torch.distributed import comm, ctx
from repro_torch.distributed.sharding import (P, make_axis_env, mesh_axes,
                                              placements)
from repro_torch.distributed.train_step import (
    batch_rows, compute_params, lay_out_cache, local_nbytes,
    make_sharded_serve_decode, make_sharded_serve_prefill,
    make_sharded_train_step, shard_grads, shard_tree)
from repro_torch.kernels import dispatch
from repro_torch.launch.elastic import spawn, state_errors
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import lm
from repro_torch.models.layers import chunked_xent, init_embed
from repro_torch.models.moe import count_dropped, init_moe, moe_mlp
from repro_torch.models.ssm import init_mamba, mamba_forward
from repro_torch.models.xlstm import init_mlstm, mlstm_forward
from repro_torch.training.data import TokenStream
from repro_torch.training.optimizer import init_opt_state
from repro_torch.training.train_step import TrainConfig, make_train_step

WORLD = 4
DATA, MODEL = 2, 2
WIDE = 8                 # the second spawn: data=1 x model=8
POLICIES = ("v1", "qtp")
MOE_IMPLS = ("shardmap", "gspmd")
MOE_FACTORS = (1.25, 1.0)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default="gloo")
    ap.add_argument("--smoke", action="store_true",
                    help="smoke-size configs (CPU rehearsal)")
    return ap.parse_args(argv)


def sizes(smoke: bool) -> dict:
    """Batch shapes of each case: (a) rows x seq of the global batch; (b)
    rows, prompt, cache length, decode steps, query chunk; (c), (d) rows
    per data shard x seq; (g) the decode's cache length and the position
    it is seeded up to, the prefill's prompt, cache length and query
    chunk, and the greedy steps after each."""
    if smoke:
        return dict(train=(4, 32), q_chunk=16, xent_chunk=16,
                    serve=(2, 16, 24, 3, 8), layer=(2, 16),
                    long=dict(cache=64, filled=30, prompt=24,
                              prefill_cache=32, q_chunk=8, steps=4))
    return dict(train=(4, 1024), q_chunk=1024, xent_chunk=256,
                serve=(2, 64, 96, 8, 32), layer=(2, 512),
                long=dict(cache=524288, filled=262142, prompt=6000,
                          prefill_cache=8192, q_chunk=1000, steps=4))


ARCHS = ("gemma3-1b", "moonshot-v1-16b-a3b", "zamba2-2.7b", "xlstm-1.3b",
         "musicgen-large")


def configs(smoke: bool):
    """``ARCHS``' configs, float32: whole, or at smoke size (gemma cut to
    one window and one global layer)."""
    out = []
    for arch in ARCHS:
        cfg = get_arch(arch)
        if smoke:
            if arch == "gemma3-1b":
                cfg = dataclasses.replace(cfg, groups=(GroupSpec(
                    unit=tuple(dict.fromkeys(cfg.groups[0].unit)),
                    repeat=1),))
            cfg = reduce_for_smoke(cfg)
        out.append(dataclasses.replace(cfg, compute_dtype="float32"))
    return out


def main(argv=None):
    return run(argv).cases


def run(argv=None) -> SimpleNamespace:
    """Spawn the 4 ranks, then the 8, and run every case; returns rank 0's
    case records (``cases``), the collectives the backend takes on the
    first spawn's groups (``collectives``), ``ranks``, every rank's
    per-case state bytes, peak memory and collectives (the two spawns'
    rank ``i`` in one dict), and ``kernels``, every rank's kernel
    launches, pages and routes."""
    args = parse_args(argv)
    four = spawn(_rank, (args,), WORLD, args.backend, args.device)
    eight = spawn(_rank8, (args,), WIDE, args.backend, args.device)
    ranks = [{**(four[i]["per_case"] if i < WORLD else {}),
              **eight[i]["per_case"]} for i in range(WIDE)]
    return SimpleNamespace(cases=four[0]["cases"] + eight[0]["cases"],
                           collectives=four[0]["collectives"], ranks=ranks,
                           kernels=[r["kernels"] for r in four + eight])


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _card_used(device) -> int:
    """Bytes in use on the card, by every process (0 on the CPU)."""
    if device.type != "cuda":
        return 0
    free, total = torch.cuda.mem_get_info(device)
    return total - free


def _release(device):
    """Hand the allocator's cached blocks back to the card, which the 4
    ranks share."""
    if device.type == "cuda":
        torch.cuda.empty_cache()


def _start(device):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dispatch.reset_launches()


def _runner(rank, device, mesh, out):
    """``case(name, fn)``: runs one case on this rank into ``out``: its
    record (rank 0), state bytes, peak memory and collectives."""
    sizes_ = dict(mesh_axes(mesh))

    def case(name, fn):
        comm.reset()
        _release(device)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        _sync(device)
        t0 = time.perf_counter()
        rec, state_bytes = fn()
        _sync(device)
        wall = time.perf_counter() - t0
        out["per_case"][name] = {
            "rank": rank, "state_bytes": state_bytes, "comm": comm.snapshot(),
            "flops": rec.pop("flops", None),
            "peak_device_bytes": (torch.cuda.max_memory_allocated(device)
                                  if device.type == "cuda" else None),
            "peak_reserved_bytes": (torch.cuda.max_memory_reserved(device)
                                    if device.type == "cuda" else None)}
        if rank == 0:
            out["cases"].append({"case": name, "mesh": sizes_, "wall_s": wall,
                                 **rec})
    return case


def _finish(out):
    out["kernels"] = {"launches": dict(dispatch.launches),
                      "pages": dict(dispatch.pages_moved),
                      "routes": dict(dispatch.routes)}
    return out


def _rank(rank, device, store, tmp, args) -> dict:
    _start(device)
    mesh = make_test_mesh(DATA, MODEL, device_type=device.type)
    out = {"cases": [], "per_case": {},
           "collectives": {a: comm.probe(mesh.get_group(a), device)
                           for a in ("data", "model")}}
    gemma, moon, zamba, xlstm, _ = configs(args.smoke)
    sz = sizes(args.smoke)
    case = _runner(rank, device, mesh, out)

    for policy in POLICIES:
        env = make_axis_env(mesh, attn_policy=policy)
        state = {}
        case(f"b:{gemma.name}:{policy}",
             lambda: _serve_case(gemma, env, sz, device, state))
        case(f"a:{gemma.name}:{policy}",
             lambda: _train_case(gemma, env, sz, device, state))
        del state
    for impl in MOE_IMPLS:
        for factor in MOE_FACTORS:
            cfg = dataclasses.replace(moon, moe_capacity_factor=factor)
            env = make_axis_env(mesh, moe_impl=impl)
            case(f"c:{moon.name}:{impl}:{factor}",
                 lambda: _moe_case(cfg, env, sz, device))
    case(f"d:{zamba.name}:mamba_tp",
         lambda: _mamba_case(zamba, make_axis_env(mesh, mamba_tp=True), sz,
                             device))
    case(f"e:{xlstm.name}:mlstm",
         lambda: _mlstm_case(xlstm, make_axis_env(mesh), sz, device))
    env, state, L = make_axis_env(mesh), {}, sz["long"]
    case(f"g:{gemma.name}:decode_{L['cache']}",
         lambda: _long_case(gemma, env, sz, device, state, prefill=False))
    case(f"g:{gemma.name}:prefill_{L['prompt']}",
         lambda: _long_case(gemma, env, sz, device, state, prefill=True))
    return _finish(out)


def _rank8(rank, device, store, tmp, args) -> dict:
    _start(device)
    mesh = make_test_mesh(1, WIDE, device_type=device.type)
    out = {"cases": [], "per_case": {}}
    _, _, _, xlstm, musicgen = configs(args.smoke)
    sz = sizes(args.smoke)
    case = _runner(rank, device, mesh, out)
    env = make_axis_env(mesh)
    case(f"e:{xlstm.name}:mlstm:1x{WIDE}",
         lambda: _mlstm_case(xlstm, env, sz, device))
    case(f"f:{musicgen.name}:head", lambda: _head_case(musicgen, env, sz,
                                                       device))
    return _finish(out)


def _since(before) -> dict:
    """The collectives counted since the snapshot ``before``, by kind."""
    out = {}
    for kind, now in comm.snapshot().items():
        was = before.get(kind, {"calls": 0, "bytes": 0, "seconds": 0.0})
        d = {k: now[k] - was[k] for k in now}
        if d["calls"]:
            out[kind] = d
    return out


def _first(env) -> bool:
    return comm.is_first(env.mesh)


def _max_err(a, b) -> float:
    return float((a - b).abs().max()) if a.numel() else 0.0


def _compare_leaves(tree, want, env, errors, key):
    """Every DTensor leaf of ``tree`` gathered in turn into the mesh's
    first rank (every rank calls) and there its largest difference from
    ``want``'s leaf and that leaf's largest magnitude: errors[key] = [err,
    scale, leaf]."""
    names, _, leaves = flatten_with_names(tree)
    wl = flatten_with_names(want)[2] if want is not None else None
    worst, rel = None, -1.0
    for i, (name, x) in enumerate(zip(names, leaves)):
        full = comm.gather(x, first_only=True)
        if wl is not None:
            err, scale = _max_err(full, wl[i]), float(wl[i].abs().max())
            if err / (scale or 1.0) > rel:
                worst, rel = [err, scale, name], err / (scale or 1.0)
        del full
    if wl is not None:
        errors[key] = worst


# ---------------------------------------------------------------------------
# (a) training, (b) serving
# ---------------------------------------------------------------------------


def _tcfg(sz) -> TrainConfig:
    return TrainConfig(peak_lr=1e-3, warmup=5, total_steps=12,
                       microbatches=2, remat="full", q_chunk=sz["q_chunk"],
                       xent_chunk=sz["xent_chunk"])


def _serve_case(cfg, env, sz, device, state):
    """(b): sharded prefill and greedy decode of fresh params (kept in
    ``state`` for (a)) against rank 0's whole-params run."""
    full = lm.init_params(cfg, torch.Generator(device).manual_seed(0),
                          device)
    params = shard_tree(full, cfg, env)
    if not _first(env):
        del full
    else:
        state["whole"] = full
    state["params"] = params
    B, prompt, cache_len, steps, q_chunk = sz["serve"]
    rng = np.random.default_rng(7)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, prompt))).to(
        device=device, dtype=torch.int32)
    pre = make_sharded_serve_prefill(cfg, cache_len, env, q_chunk=q_chunk)
    dec = make_sharded_serve_decode(cfg, env)
    with torch.no_grad():
        cp = compute_params(params, env, groups=False)
        logits, caches = pre(cp, tok)
        got = [comm.gather(logits)]
        pos = torch.full((B,), prompt, dtype=torch.int32, device=device)
        for _ in range(steps):
            t = got[-1].argmax(-1).to(torch.int32)
            logits, caches = dec(cp, caches, t, pos)
            got.append(comm.gather(logits))
            pos = pos + 1
        cache_bytes = local_nbytes(caches)
        del cp, caches
        rec = {"batch": B, "prompt": prompt, "cache_len": cache_len,
               "decode_steps": steps, "q_chunk": q_chunk}
        if _first(env):
            want, rc = lm.prefill(full, cfg, tok, cache_len, q_chunk=q_chunk)
            wants = [want]
            pos = torch.full((B,), prompt, dtype=torch.int32, device=device)
            for _ in range(steps):
                want, rc = lm.decode_step(full, cfg, rc,
                                          wants[-1].argmax(-1).to(torch.int32),
                                          pos)
                wants.append(want)
                pos = pos + 1
            rec["logits_max_abs_err"] = max(_max_err(a, b)
                                            for a, b in zip(got, wants))
            rec["tokens_equal"] = all(
                torch.equal(a.argmax(-1), b.argmax(-1))
                for a, b in zip(got, wants))
            del rc
    return rec, {"params": local_nbytes(params), "caches": cache_bytes}


def _fresh_params(cfg, env, device, state):
    """Fresh params laid out by ``param_pspec`` and, on rank 0, whole:
    made once and kept in ``state``."""
    if "params" not in state:
        full = lm.init_params(cfg, torch.Generator(device).manual_seed(0),
                              device)
        state["params"] = shard_tree(full, cfg, env)
        state["whole"] = full if _first(env) else None
        del full
    return state["params"], state["whole"]


def _seeded_caches(cfg, cache_len, filled, env, device, keep):
    """Caches of batch 1 and ``cache_len`` whose positions (ring slots)
    below ``filled`` come from a seeded generator, zeros past it: this
    rank's parts laid out by ``cache_pspec``, and the whole caches when
    ``keep`` (rank 0).  Each leaf is made whole on every rank in turn."""
    shapes = lm.init_cache(cfg, 1, cache_len, torch.float32, "meta")
    names, paths, leaves = flatten_with_names(shapes)
    parts, wholes = [], []
    for i, (name, t) in enumerate(zip(names, leaves)):
        g = torch.Generator(device).manual_seed(100 + i)
        whole = torch.zeros(t.shape, device=device)
        n = min(filled, t.shape[2])
        whole[:, :, :n] = torch.randn(
            (t.shape[0], t.shape[1], n) + tuple(t.shape[3:]), generator=g,
            device=device)
        parts.append(lay_out_cache(name, whole, cfg, env, 1))
        wholes.append(whole if keep else None)
        del whole
    return (unflatten_from_paths(paths, parts),
            unflatten_from_paths(paths, wholes) if keep else None)


def _cache_errors(cfg, caches, want, written) -> dict:
    """Every rank's cache part (each leaf gathered in turn into rank 0;
    every rank calls) against the same slice of ``want``, the one-rank
    caches (rank 0; None elsewhere): whether every position (ring slot)
    that no step wrote is bit-equal, and the largest difference over the
    ``written`` positions (a ring's: their slots) with the largest
    magnitude there."""
    names, _, leaves = flatten_with_names(caches)
    wl = flatten_with_names(want)[2] if want is not None else None
    equal, err, scale = True, 0.0, 0.0
    for i, (name, x) in enumerate(zip(names, leaves)):
        full = comm.gather(x, first_only=True)
        if wl is None:
            continue
        w = wl[i]
        parts = name.split("/")
        window = cfg.groups[int(parts[1])].unit[int(parts[3])].window
        n = w.shape[2]
        mine = sorted({p % n if window is not None else p for p in written})
        at = torch.tensor(mine, device=w.device)
        differs = (full != w).flatten(3).any(-1).any(1).any(0)
        differs[at] = False
        equal = equal and not bool(differs.any())
        a, b = full.index_select(2, at), w.index_select(2, at)
        err = max(err, _max_err(a, b))
        scale = max(scale, float(b.abs().max()))
        del full
    if wl is None:
        return {}
    return {"cache_unwritten_bits_equal": equal,
            "cache_written_max_abs_err": err, "cache_written_scale": scale}


def _long_case(cfg, env, sz, device, state, prefill):
    """(g): batch 1 over sequence-parallel caches, against rank 0's one-rank
    run on the whole caches: a decode from seeded caches, or a prefill,
    then greedy steps (see the module's docstring)."""
    L = sz["long"]
    params, whole = _fresh_params(cfg, env, device, state)
    rng = np.random.default_rng(11 if prefill else 13)
    dec = make_sharded_serve_decode(cfg, env)
    want = None
    with torch.no_grad():
        if prefill:
            tok = torch.from_numpy(rng.integers(
                0, cfg.vocab_size, (1, L["prompt"]))).to(device=device,
                                                          dtype=torch.int32)
            pre = make_sharded_serve_prefill(cfg, L["prefill_cache"], env,
                                             q_chunk=L["q_chunk"])
            logits, caches = pre(params, tok)
            got, start = [comm.gather(logits)], L["prompt"]
            if whole is not None:
                wlog, want = lm.prefill(whole, cfg, tok, L["prefill_cache"],
                                        q_chunk=L["q_chunk"])
                wants = [wlog]
        else:
            caches, want = _seeded_caches(cfg, L["cache"], L["filled"], env,
                                          device, whole is not None)
            first = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1,))
                                     ).to(device=device, dtype=torch.int32)
            got, start = [], L["filled"]
            wants = [] if whole is not None else None
        t0 = time.perf_counter()
        for i in range(L["steps"]):
            pos = torch.full((1,), start + i, dtype=torch.int32, device=device)
            t = got[-1].argmax(-1).to(torch.int32) if got else first
            logits, caches = dec(params, caches, t, pos)
            got.append(comm.gather(logits))
        _sync(device)
        step_s = (time.perf_counter() - t0) / L["steps"]
        if whole is not None:
            for i in range(L["steps"]):
                pos = torch.full((1,), start + i, dtype=torch.int32,
                                 device=device)
                t = wants[-1].argmax(-1).to(torch.int32) if wants else first
                wlog, want = lm.decode_step(whole, cfg, want, t, pos)
                wants.append(wlog)
        cache_bytes = local_nbytes(caches)
        written = range(0 if prefill else start, start + L["steps"])
        rec = {"batch": 1, "cache_len": (L["prefill_cache"] if prefill
                                         else L["cache"]),
               "decode_steps": L["steps"], "decode_s_per_token": step_s,
               "first_position": start,
               "cache_part_shapes": {n: list(x.to_local().shape) for n, x in
                                     zip(*flatten_with_names(caches)[::2])}}
        if prefill:
            rec.update(prompt=L["prompt"], q_chunk=L["q_chunk"])
        else:
            rec["seeded_to"] = L["filled"]
        rec.update(_cache_errors(cfg, caches, want, written))
        if whole is not None:
            rec["logits_max_abs_err"] = max(_max_err(a, b)
                                            for a, b in zip(got, wants))
            rec["tokens_equal"] = all(
                torch.equal(a.argmax(-1), b.argmax(-1))
                for a, b in zip(got, wants))
        del caches, want
    return rec, {"params": local_nbytes(params), "caches": cache_bytes}


def _train_case(cfg, env, sz, device, state):
    """(a): 2 sharded steps against rank 0's steps on the whole state."""
    tcfg = _tcfg(sz)
    params = state.pop("params")
    opt = init_opt_state(params)
    whole = state.pop("whole", None)
    wopt = init_opt_state(whole) if whole is not None else None
    B, S = sz["train"]
    stream = TokenStream(cfg.vocab_size, B, S, seed=0)
    step = make_sharded_train_step(cfg, tcfg, env)
    single = make_train_step(cfg, tcfg)
    rec = {"batch": B, "seq": S, "microbatches": tcfg.microbatches,
           "step_s": [], "steps": [], "card_used_bytes": 0}
    for s in range(2):
        tok, lab = (torch.from_numpy(a).to(device) for a in
                    stream.batch_at(s))
        _sync(device)
        before = comm.snapshot()
        t0 = time.perf_counter()
        # step 0's FLOPs, which the dry run of this step is held to
        with (FlopCounterMode(display=False) if s == 0
              else contextlib.nullcontext()) as flops:
            params, opt, m = step(params, opt, tok, lab)
        loss = float(m["loss"])                         # syncs
        rec["step_s"].append(time.perf_counter() - t0)
        if s == 0:
            rec["flops"] = flops.get_total_flops()
        chk = {"loss": loss, "gnorm": float(m["gnorm"]), "lr": float(m["lr"]),
               "step_comm": _since(before)}
        used = _card_used(device)
        _release(device)     # the step's cached blocks, for rank 0's step
        if whole is not None:
            whole, wopt, wm = single(whole, wopt, tok, lab)
            _sync(device)
            used = max(used, _card_used(device))
            _release(device)
            chk.update(single_loss=float(wm["loss"]),
                       single_gnorm=float(wm["gnorm"]),
                       single_lr=float(wm["lr"]))
            chk["loss_rel_err"] = abs(chk["loss"] - chk["single_loss"]) / abs(
                chk["single_loss"])
            chk["gnorm_rel_err"] = abs(chk["gnorm"] - chk["single_gnorm"]) / (
                abs(chk["single_gnorm"]))
        rec["card_used_bytes"] = max(rec["card_used_bytes"], used)
        if s == 1:
            chk.update(state_errors(params, opt["m"], whole,
                                    wopt["m"] if wopt is not None else None))
        rec["steps"].append(chk)
    state_bytes = local_nbytes(params) + local_nbytes(
        {"m": opt["m"], "v": opt["v"]})
    return rec, state_bytes


# ---------------------------------------------------------------------------
# (c) the MoE layer, (d) the Mamba layer
# ---------------------------------------------------------------------------


def _block_tree(key, p):
    """A block's params at the path the sharding rules read."""
    return {"groups": [{"blocks": [{key: p}]}]}


def _layer_inputs(cfg, sz, device, seed, data=DATA):
    """The global input x (data * rows, seq, d_model) and a probe of the
    same shape, from a seed."""
    rows, S = sz["layer"]
    g = torch.Generator(device).manual_seed(seed)
    shape = (data * rows, S, cfg.d_model)
    return (torch.randn(shape, generator=g, device=device),
            torch.randn(shape, generator=g, device=device))


def _layer_case(cfg, env, tree, x, probe, apply_sharded, apply_whole):
    """Shared by (c) and (d): the sharded layer on this rank's rows and
    its gradients of ``sum(out * probe)`` (params laid out by the step's
    ``shard_grads``), against rank 0's whole-batch run (``apply_whole``
    returns (out, extra outputs))."""
    sharded = shard_tree(tree, cfg, env)
    names, paths, leaves = flatten_with_names(sharded)
    xl, _ = batch_rows(x, 1, env)
    pl, _ = batch_rows(probe, 1, env)
    cp = [t.detach().requires_grad_() for t in
          flatten_with_names(compute_params(sharded, env))[2]]
    xl = xl.detach().requires_grad_()
    t0 = time.perf_counter()
    with ctx.use_env(env, split_batch=True):
        y, extra = apply_sharded(unflatten_from_paths(paths, cp), xl)
        grads = list(torch.autograd.grad((y * pl).sum(), [xl] + cp))
    gx = grads.pop(0)
    gp = unflatten_from_paths(paths, shard_grads(names, leaves, grads,
                                                 cfg, env))
    _sync(x.device)
    rec = {"sharded_s": time.perf_counter() - t0}
    rows = placements(P(env.dp), env)
    lay = lambda t: DTensor.from_local(t.detach().contiguous(), env.mesh,
                                       rows, run_check=False)
    y, gx = comm.gather(lay(y)), comm.gather(lay(gx))
    extra = {k: comm.gather(lay(v)) for k, v in extra.items()}
    errors = {}
    want_p = None
    if _first(env):
        whole = [t.detach().clone().requires_grad_() for t in
                 flatten_with_names(tree)[2]]
        xw = x.detach().clone().requires_grad_()
        wy, wextra = apply_whole(unflatten_from_paths(paths, whole), xw)
        wg = torch.autograd.grad((wy * probe).sum(), [xw] + whole)
        for key, a, b in [("out", y, wy), ("x_grad", gx, wg[0])] + [
                (k, extra[k], wextra[k]) for k in extra]:
            b = b.detach()
            errors[key] = [_max_err(a, b), float(b.abs().max()), None]
        # the step's gradient is the mean over the data shards
        want_p = unflatten_from_paths(paths, [g / env.dpsize
                                              for g in wg[1:]])
    _compare_leaves(gp, want_p, env, errors, "param_grads")
    rec["errors"] = errors
    return rec, local_nbytes(sharded)


def _moe_case(cfg, env, sz, device):
    p = init_moe(torch.Generator(device).manual_seed(1), cfg, device=device)
    x, probe = _layer_inputs(cfg, sz, device, 2)
    tree = _block_tree("moe", p)
    blk = lambda t: t["groups"][0]["blocks"][0]["moe"]
    shards = [x[i * sz["layer"][0]:(i + 1) * sz["layer"][0]]
              for i in range(DATA)]

    def whole(t, xw):
        if env.moe_impl == "shardmap":    # one call per data shard
            n = sz["layer"][0]
            return torch.cat([moe_mlp(blk(t), xw[i * n:(i + 1) * n], cfg)
                              for i in range(DATA)]), {}
        return moe_mlp(blk(t), xw, cfg), {}

    rec, nbytes = _layer_case(cfg, env, tree, x, probe,
                              lambda t, xl: (moe_mlp(blk(t), xl, cfg), {}),
                              whole)
    if _first(env):
        with torch.no_grad():
            rec["dropped"] = (sum(count_dropped(p, s, cfg) for s in shards)
                              if env.moe_impl == "shardmap"
                              else count_dropped(p, x, cfg))
        rec.update(impl=env.moe_impl, factor=cfg.moe_capacity_factor,
                   tokens=x.shape[0] * x.shape[1])
    return rec, nbytes


def _mamba_case(cfg, env, sz, device):
    spec = cfg.groups[0].unit[0]
    p = init_mamba(torch.Generator(device).manual_seed(3), cfg, spec,
                   device=device)
    x, probe = _layer_inputs(cfg, sz, device, 4)
    blk = lambda t: t["groups"][0]["blocks"][0]["mamba"]

    def apply(t, xi):
        y, st = mamba_forward(blk(t), xi, cfg, spec, return_state=True)
        return y, {"ssd": st["ssd"], "conv": st["conv"]}

    rec, nbytes = _layer_case(cfg, env, _block_tree("mamba", p), x, probe,
                              apply, apply)
    if _first(env):
        rec["tokens"] = x.shape[0] * x.shape[1]
    return rec, nbytes


def _mlstm_case(cfg, env, sz, device):
    """(e): one mLSTM layer, its value columns split over ``model``."""
    spec = cfg.groups[0].unit[0]
    p = init_mlstm(torch.Generator(device).manual_seed(5), cfg, spec,
                   device=device)
    x, probe = _layer_inputs(cfg, sz, device, 6, env.dpsize)
    blk = lambda t: t["groups"][0]["blocks"][0]["mlstm"]

    def apply(t, xi):
        y, st = mlstm_forward(blk(t), xi, cfg, spec, return_state=True)
        return y, {"C": st["C"], "n": st["n"], "conv": st["conv"]}

    rec, nbytes = _layer_case(cfg, env, _block_tree("mlstm", p), x, probe,
                              apply, apply)
    if _first(env):
        rec.update(tokens=x.shape[0] * x.shape[1], heads=spec.num_heads,
                   value_columns_per_rank=spec.expand * cfg.d_model
                   // env.msize)
    return rec, nbytes


def _head_case(cfg, env, sz, device):
    """(f): the untied multi-codebook output head and its loss
    (``chunked_xent``) on hidden states of ``rows`` x seq: the loss and
    the gradients of the hidden states and of the head's leaf, against
    rank 0's whole head (data=1: every rank has the batch)."""
    rows, S = sz["layer"]
    g = torch.Generator(device).manual_seed(7)
    tree = {"embed": {"out": init_embed(g, cfg, device)["out"]}}
    h = torch.randn((rows, S, cfg.d_model), generator=g, device=device)
    labels = torch.randint(0, cfg.vocab_size, (rows, S, cfg.num_codebooks),
                           generator=g, device=device)
    sharded = shard_tree(tree, cfg, env)
    names, paths, leaves = flatten_with_names(sharded)
    cp = [t.detach().requires_grad_() for t in
          flatten_with_names(compute_params(sharded, env))[2]]
    hl = h.detach().requires_grad_()
    t0 = time.perf_counter()
    with ctx.use_env(env):
        loss = chunked_xent(unflatten_from_paths(paths, cp)["embed"], cfg, hl,
                            labels, chunk=sz["xent_chunk"])
        grads = list(torch.autograd.grad(loss, [hl] + cp))
    gh = grads.pop(0)
    gp = unflatten_from_paths(paths, shard_grads(names, leaves, grads, cfg,
                                                 env))
    _sync(device)
    rec = {"sharded_s": time.perf_counter() - t0}
    errors, want_p = {}, None
    if _first(env):
        whole = [t.detach().clone().requires_grad_() for t in
                 flatten_with_names(tree)[2]]
        hw = h.detach().clone().requires_grad_()
        wl = chunked_xent(unflatten_from_paths(paths, whole)["embed"], cfg,
                          hw, labels, chunk=sz["xent_chunk"])
        wg = torch.autograd.grad(wl, [hw] + whole)
        errors["loss"] = [abs(float(loss.detach()) - float(wl.detach())),
                          abs(float(wl.detach())), None]
        errors["h_grad"] = [_max_err(gh, wg[0]), float(wg[0].abs().max()),
                            None]
        want_p = unflatten_from_paths(paths, list(wg[1:]))
        rec.update(codebooks=cfg.num_codebooks, vocab=cfg.vocab_size,
                   tokens=rows * S, loss=float(loss.detach()))
    _compare_leaves(gp, want_p, env, errors, "param_grads")
    rec["errors"] = errors
    return rec, local_nbytes(sharded)


if __name__ == "__main__":
    for c in main():
        print(c)
