"""Dry run of the port's sharded steps on the production meshes: the
counterpart of the reference's ``launch/dryrun.py``.

The reference lowers each cell (arch x shape x mesh) with ``jax.jit`` for
512 fake CPU devices and reads the compiled HLO.  Here the port's own
steps (``distributed/train_step.py``: ``make_sharded_train_step``,
``make_sharded_serve_prefill``, ``make_sharded_serve_decode``) run once,
as one rank of a fake process group of the mesh's world size (256 or 512;
``torch.testing``'s "fake" backend: every collective returns at once and
moves nothing), on meta tensors: each leaf of the rank's state is built
at its local shape (``sharding.local_shape``), never whole, so no cell
allocates.  ``distributed/op_analysis`` counts what the rank runs, and
``distributed/roofline`` turns the counts into a three-term roofline with
the H100's constants.  Every number a cell holds is a model value for
those constants, not a measurement.

Differences from the reference's tool, each deliberate:

- no HLO: FLOPs, collectives, traffic and peak bytes are counted on the
  eager ops of one rank (``op_analysis``: its traffic is eager PyTorch's,
  which fuses nothing, so it is larger than XLA's for the same step);
- ``trace_s`` (set-up and the one traced run) in place of ``lower_s`` and
  ``compile_s``; no ``xla_*`` numbers and no ``hlo_bytes``;
- the rank is ``RANK`` (1), not the mesh's first: the launchers give the
  first rank check-only work;
- a loop over time steps or chunks (``models/scan.py``) runs three trips
  and counts for all of them, as the reference counts a scan's body for
  its trip count;
- ``fits_hbm`` compares the rank's peak live bytes (``op_analysis``) with
  ``HBM_PER_CHIP``, where the reference adds XLA's argument and temp
  sizes.  The port's step gathers each layer's params over the fsdp axes
  inside the layer loop (``comm.gather_layer``), as GSPMD does inside
  the scan; the loop's three trips count its gathers for every layer;
- ``long_500k`` (batch 1, 524,288 positions) serves the batch whole on
  every data rank and splits the attention caches along their sequence
  axis (``cache_pspec``), merging the ranks' attention by
  ``comm.sp_attn_combine``; the reference's rule skips the cell for the
  archs that are not sub-quadratic;
- the roofline's constants are the H100's (``distributed/roofline.py``).

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-1b \\
      --shape decode_32k [--multi-pod] [--opt k=v]
"""
from __future__ import annotations

import argparse
import ast
import contextlib
import dataclasses
import json
import os
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.configs.base import SHAPES, get_arch, shape_applicable
from repro_torch.core.descriptor import flatten_with_names, unflatten_from_paths
from repro_torch.distributed import op_analysis
from repro_torch.distributed.roofline import HBM_PER_CHIP, roofline
from repro_torch.distributed.sharding import (cache_pspec,
                                              local_shape, make_axis_env,
                                              param_pspec, placements)
from repro_torch.distributed.train_step import (batch_rows,
                                                make_sharded_serve_decode,
                                                make_sharded_serve_prefill,
                                                make_sharded_train_step)
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import flops as flops_mod
from repro_torch.models import lm
from repro_torch.training.train_step import TrainConfig

ARCHS = [
    "stablelm-3b", "gemma3-1b", "granite-34b", "qwen2-7b", "zamba2-2.7b",
    "kimi-k2-1t-a32b", "moonshot-v1-16b-a3b", "musicgen-large", "xlstm-1.3b",
    "chameleon-34b",
]
OUT_DIR = os.environ.get("DRYRUN_OUT", "artifacts/dryrun_torch")
RANK = 1


@contextlib.contextmanager
def fake_group(world: int, rank: int = RANK):
    """A "fake" default process group of ``world`` ranks in which this
    process is ``rank``, destroyed on the way out.  Raises if a default
    group exists: the dry run sets up its own."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a default process group exists; the dry run "
                           "sets up its own fake one")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def mesh_of(sizes: dict):
    """The ``DeviceMesh`` of axis sizes ``{"pod"?, "data", "model"}`` over
    the fake group (``make_test_mesh``'s layout)."""
    return make_test_mesh(sizes["data"], sizes["model"], sizes.get("pod", 0),
                          device_type="cpu")


def _meta(shape, dtype, spec, env):
    """A DTensor of this rank's part of a tensor of ``shape`` under
    ``spec``, on meta."""
    local = torch.empty(local_shape(shape, spec, env), dtype=dtype,
                        device="meta")
    return torch.distributed.tensor.DTensor.from_local(
        local, env.mesh, placements(spec, env), run_check=False)


def _laid_out(tree, env, spec_of):
    names, paths, leaves = flatten_with_names(tree)
    return unflatten_from_paths(paths, [
        _meta(tuple(x.shape), x.dtype, spec_of(n, tuple(x.shape)), env)
        for n, x in zip(names, leaves)])


def _local_bytes(tree) -> int:
    return sum(x.to_local().nbytes for x in flatten_with_names(tree)[2])


def _tok_shape(cfg, B: int, S: int):
    return (B, S, cfg.num_codebooks) if cfg.num_codebooks > 1 else (B, S)


def step_spec(cfg, step: str, env, B: int, S: int, tcfg=None, p_env=None,
              q_chunk: int = 1024) -> dict:
    """One rank's state on meta for the port's ``step`` ("train",
    "prefill" or "decode") of a global batch ``B`` x ``S`` under ``env``:
    {"fn", "args", "read_bytes"}.  Params are laid out by ``p_env``
    (``env`` by default), AdamW state and caches by ``env``;
    ``read_bytes`` is the state plus this rank's rows of the batch."""
    p_env = p_env or env
    shapes = lm.init_params(cfg, torch.Generator(), device="meta")
    params = _laid_out(shapes, p_env,
                       lambda n, s: param_pspec(n, s, cfg, p_env))
    read = _local_bytes(params)
    if step == "train":
        tokens = torch.empty(_tok_shape(cfg, B, S), dtype=torch.int32,
                             device="meta")
        opt = {k: _laid_out(shapes, env,
                            lambda n, s: param_pspec(n, s, cfg, env))
               for k in ("m", "v")}
        opt["count"] = torch.zeros((), dtype=torch.int32, device="meta")
        rows = batch_rows(tokens, tcfg.microbatches, env)[0]
        read += _local_bytes({"m": opt["m"], "v": opt["v"]}) \
            + 2 * rows.nbytes + 4
        return dict(fn=make_sharded_train_step(cfg, tcfg, env),
                    args=(params, opt, tokens, tokens), read_bytes=read)
    if step == "prefill":
        tokens = torch.empty(_tok_shape(cfg, B, S), dtype=torch.int32,
                             device="meta")
        read += batch_rows(tokens, 1, env)[0].nbytes
        return dict(fn=make_sharded_serve_prefill(cfg, S, env,
                                                  q_chunk=q_chunk),
                    args=(params, tokens), read_bytes=read)
    # decode: one new token against a cache of S
    whole = lm.init_cache(cfg, B, S, dtype=torch.bfloat16, device="meta")
    caches = _laid_out(whole, env,
                       lambda n, s: cache_pspec(n, s, cfg, env, B))
    tshape = (B, cfg.num_codebooks) if cfg.num_codebooks > 1 else (B,)
    token = torch.empty(tshape, dtype=torch.int32, device="meta")
    pos = torch.empty((B,), dtype=torch.int32, device="meta")
    read += _local_bytes(caches) + sum(
        batch_rows(t, 1, env)[0].nbytes for t in (token, pos))
    return dict(fn=make_sharded_serve_decode(cfg, env),
                args=(params, caches, token, pos), read_bytes=read)


def input_specs(arch: str, shape_name: str, multi_pod: bool = False,
                opts: dict = None) -> dict:
    """One rank's meta state for the cell and the port's step for it,
    inside a fake group of the mesh's world size (``fake_group``).

    ``opts`` — the reference's levers that the port has:
      tp_only_params : replicate params over data (serving sharding)
      remat          : none|full|dots
      exact_causal   : exact causal KV slices per query chunk
      grad_dtype     : float32|bfloat16 (gradient accumulators)
      microbatches, q_chunk, xent_chunk : ints
      attn_policy, moe_impl, mamba_tp : the ``AxisEnv`` fields
      arch overrides : any ArchConfig field, e.g. moe_capacity_factor
    """
    opts = dict(opts or {})
    cfg = get_arch(arch)
    fields = {f.name for f in dataclasses.fields(cfg)}
    over = {k: v for k, v in opts.items() if k in fields}
    if over:
        cfg = dataclasses.replace(cfg, **over)
    shape = SHAPES[shape_name]
    sizes = ({"pod": 2, "data": 16, "model": 16} if multi_pod
             else {"data": 16, "model": 16})
    mesh = mesh_of(sizes)
    env = make_axis_env(mesh, attn_policy=opts.get("attn_policy", "v1"),
                        moe_impl=opts.get("moe_impl", "gspmd"),
                        mamba_tp=bool(opts.get("mamba_tp", False)))
    B, S = shape.global_batch, shape.seq_len
    p_env = (dataclasses.replace(env, fsdp=())
             if opts.get("tp_only_params") and shape.step != "train"
             else env)
    q_chunk = int(opts.get("q_chunk", 1024))
    meta = {}
    tcfg = None
    if shape.step == "train":
        mb = int(opts.get("microbatches", cfg.microbatches))
        while mb > 1 and (B // mb) % env.dpsize != 0:
            mb //= 2
        mb = max(1, min(mb, B // env.dpsize))
        tcfg = TrainConfig(microbatches=mb, remat=opts.get("remat"),
                           grad_dtype=opts.get("grad_dtype", "float32"),
                           q_chunk=q_chunk,
                           exact_causal=bool(opts.get("exact_causal", False)),
                           xent_chunk=int(opts.get("xent_chunk", 512)))
        meta = {"microbatches": mb}
    spec = step_spec(cfg, shape.step, env, B, S, tcfg, p_env, q_chunk)
    return dict(step=shape.step, mesh=mesh, env=env, cfg=cfg, shape=shape,
                chips=mesh.size(), meta=meta, **spec)


def cell_numbers(an: dict, chips: int, model_flops: float) -> dict:
    """A cell's counts, roofline and HBM fit from one rank's analysis."""
    flops_dev, bytes_dev = an["dot_flops"], an["traffic_bytes"]
    coll = an["collectives"]
    coll_dev = op_analysis.total_collective_bytes(coll)
    flops_global = flops_dev * chips
    rl = roofline(flops_global, bytes_dev * chips, coll_dev * chips, chips)
    peak = an["peak_bytes"]
    return dict(
        chips=chips,
        cost_analysis={"flops_per_device": flops_dev,
                       "bytes_per_device": bytes_dev},
        memory_analysis={"peak_bytes": peak,
                         "input_bytes": an["input_bytes"]},
        bytes_per_device_total=peak,
        fits_hbm=bool(peak <= HBM_PER_CHIP),
        collectives=coll,
        port_collectives=an["port_collectives"],
        collective_bytes_per_device=coll_dev,
        roofline=rl.to_dict(),
        step_time_lb=rl.step_time_lb,
        model_flops=model_flops,
        useful_flops_ratio=(model_flops / flops_global) if flops_global
        else None,
        roofline_fraction=rl.fraction_of_roofline(model_flops))


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             opts: dict = None, tag: str = "") -> dict:
    cfg = get_arch(arch)
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    mesh_tag = "pod512" if multi_pod else "pod256"
    cell = {"arch": arch, "shape": shape_name, "mesh": mesh_tag, "tag": tag,
            "opts": opts or {}}
    if not ok:
        cell.update(status="skipped", reason=why)
        return cell
    t0 = time.perf_counter()
    with fake_group(512 if multi_pod else 256):
        spec = input_specs(arch, shape_name, multi_pod, opts)
        an = op_analysis.analyze(spec["fn"], *spec["args"],
                                 read_bytes=spec["read_bytes"])
        del an["output"]
    cell.update(status="ok", trace_s=round(time.perf_counter() - t0, 2),
                rank=RANK,
                **cell_numbers(an, spec["chips"],
                               flops_mod.model_flops(spec["cfg"], shape)),
                meta=spec["meta"])
    return cell


def cell_path(arch, shape_name, multi_pod, tag=""):
    mesh_tag = "pod512" if multi_pod else "pod256"
    t = f"--{tag}" if tag else ""
    return os.path.join(OUT_DIR, f"{arch}--{shape_name}--{mesh_tag}{t}.json")


def parse_opts(pairs) -> dict:
    opts = {}
    for kv in pairs:
        k, v = kv.split("=", 1)
        try:
            opts[k] = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            opts[k] = v
    return opts


def summary(res: dict) -> str:
    """The one line printed per cell."""
    if res["status"] != "ok":
        why = res.get("reason") or res.get("error", "")
        return f"-> {res['status']} {why}"[:300]
    return (f"-> ok trace={res['trace_s']}s dominant="
            f"{res['roofline']['dominant']} step_time_lb="
            f"{res['step_time_lb']:.4g}s fits_hbm={res['fits_hbm']}")


def try_cell(arch, shape_name, multi_pod, opts=None, tag="") -> dict:
    """``run_cell``, its failure recorded as the cell (status "error")."""
    try:
        return run_cell(arch, shape_name, multi_pod, opts=opts, tag=tag)
    except Exception as e:      # one cell's failure is its record
        return {"arch": arch, "shape": shape_name,
                "mesh": "pod512" if multi_pod else "pod256", "tag": tag,
                "status": "error", "error": repr(e),
                "trace": traceback.format_exc()[-4000:]}


def sweep(cells, opts=None, tag="", workers: int = 1):
    """Yields ``try_cell`` of each (arch, shape, multi_pod) of ``cells``,
    in order; with ``workers`` > 1 in that many spawned processes (each
    cell sets up its own fake group in its process)."""
    if workers <= 1:
        for a, s, mp in cells:
            yield try_cell(a, s, mp, opts, tag)
        return
    import concurrent.futures
    import multiprocessing
    with concurrent.futures.ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn")) as pool:
        yield from pool.map(try_cell, *zip(*cells),
                            [opts] * len(cells), [tag] * len(cells))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-done", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--opt", action="append", default=[],
                    help="hillclimb lever key=value (repeatable)")
    ap.add_argument("--workers", type=int, default=1,
                    help="cells run in this many processes at once")
    args = ap.parse_args(argv)
    opts = parse_opts(args.opt)

    os.makedirs(OUT_DIR, exist_ok=True)
    archs = [args.arch] if args.arch else ARCHS
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = ([False, True] if (args.both_meshes or args.all)
              else [args.multi_pod])
    cells = []
    for c in [(a, s, mp) for mp in meshes for a in archs for s in shapes]:
        if args.skip_done and os.path.exists(cell_path(*c, args.tag)):
            print(f"[skip] {cell_path(*c, args.tag)}")
        else:
            cells.append(c)
    out = []
    for res in sweep(cells, opts, args.tag, args.workers):
        with open(cell_path(res["arch"], res["shape"],
                            res["mesh"] == "pod512", args.tag), "w") as f:
            json.dump(res, f, indent=1)
        print(f"[dryrun] {res['arch']} x {res['shape']} x {res['mesh']} "
              f"{opts or ''} {summary(res)}", flush=True)
        out.append(res)
    return out


if __name__ == "__main__":
    main()
