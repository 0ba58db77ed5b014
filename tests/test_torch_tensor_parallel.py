"""Tensor parallelism over ``model`` in the port against the reference.

One spawn of 4 gloo CPU ranks runs every multi-rank case, and the
reference's results are computed once, jitted, in this process:

- the MoE repair: moonshot at smoke size with ``moe_capacity_factor``
  1.0 (tokens drop) on data=2 x model=1, ``microbatches`` 1 and 2, one
  sharded step against the reference's ``make_train_step``;
- the sharded step on data=2 x model=2 (2 microbatches, full remat)
  against ``make_train_step`` for gemma3-1b under ``v1`` (head_dim split:
  one KV head) and ``qtp`` (Q heads split), train-100m (heads split),
  moonshot at factor 1.0 (drops; one microbatch) under ``gspmd`` and
  ``shardmap`` (each data shard its own capacity: the reference's step
  with one microbatch per data shard) and zamba2 with ``mamba_tp``;
  tolerances are ``torch_train_parity``'s;
- the sharded prefill (query chunks shorter than the prompt) and decode
  against the reference's ``lm.prefill`` / ``lm.decode_step``, logits
  within atol 1e-4 (as ``test_torch_serving.py``);
- ``moe_mlp_shardmap`` against the reference's ``_moe_mlp_gspmd`` on each
  data shard (what its shard_map computes), and the ``gspmd`` dispatch
  against ``_moe_mlp_gspmd`` on the whole batch, at factor 0.5 (drops);
- a checkpoint of model-sharded state read back on the mesh and on one
  rank, bit for bit;
- xlstm's step with its mLSTM split over ``model``, and the same 4 ranks
  as data=1 x model=4: xlstm with part of an mLSTM head on each rank and
  musicgen with each of its 2 codebooks over 2 ranks, against the
  reference's step, prefill and decode;
- the sharded step of the layouts those leave out (q/k norms and biases
  under the head_dim split and ``qtp``, musicgen's head split by
  codebooks) and xlstm's against the port's own step on one device;
- the dry run (``launch/dryrun.py``) of the steps: rank 1's collectives
  and FLOPs, counted on meta tensors in a fake group, against what rank
  1 measured running them.

Single-process: ``lm.prefill`` with ``q_chunk`` shorter than the prompt
against the reference, and ``chip_smoke.py``'s phase 10 rehearsed at
smoke size.  The rank functions import neither jax nor the reference.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.descriptor import flatten_with_names  # noqa: E402
from repro_torch.distributed import checkpoint as dckpt  # noqa: E402
from repro_torch.distributed import comm, ctx  # noqa: E402
from repro_torch.distributed.sharding import make_axis_env  # noqa: E402
from repro_torch.distributed.train_step import (  # noqa: E402
    batch_rows, compute_params, gather_tree, make_sharded_serve_decode,
    make_sharded_serve_prefill, make_sharded_train_step, shard_tree)
from repro_torch.launch import elastic  # noqa: E402
from repro_torch.launch.mesh import make_test_mesh  # noqa: E402
from repro_torch.models.moe import count_dropped, moe_mlp  # noqa: E402
from repro_torch.training.optimizer import init_opt_state  # noqa: E402
from repro_torch.training.train_step import TrainConfig  # noqa: E402

B, S, MB, Q_CHUNK, XENT = 4, 16, 2, 8, 12
STEP = dict(q_chunk=Q_CHUNK, xent_chunk=XENT, warmup=0, peak_lr=1e-3)
MOE = ("moonshot-v1-16b-a3b", {"moe_capacity_factor": 1.0})
# name: (arch, AxisEnv fields, config fields, microbatches)
STEPS = {
    "gemma3-v1": ("gemma3-1b", {"attn_policy": "v1"}, {}, MB),
    "gemma3-qtp": ("gemma3-1b", {"attn_policy": "qtp"}, {}, MB),
    "train-100m": ("train-100m", {}, {}, MB),
    "moonshot-gspmd": (MOE[0], {"moe_impl": "gspmd"}, MOE[1], 1),
    "moonshot-shardmap": (MOE[0], {"moe_impl": "shardmap"}, MOE[1], 1),
    "zamba2-mamba_tp": ("zamba2-2.7b", {"mamba_tp": True}, {}, MB),
    "xlstm-mlstm": ("xlstm-1.3b", {}, {}, MB),
}
# on data=1 x model=4 (the same 4 ranks): smoke xlstm's 2 mLSTM heads over
# 4 ranks (half a head each) and musicgen's 2 codebooks (each over 2)
STEPS14 = {
    "xlstm-part-head": ("xlstm-1.3b", {}, {}, MB),
    "musicgen-columns": ("musicgen-large", {}, {"num_codebooks": 2}, MB),
}
SERVES = ("gemma3-v1", "gemma3-qtp", "zamba2-mamba_tp", "xlstm-mlstm",
          "xlstm-part-head", "musicgen-columns")
# the steps whose rank-1 collectives and FLOPs the dry run is held to
DRY = ("gemma3-v1", "gemma3-qtp", "moonshot-gspmd", "zamba2-mamba_tp",
       "xlstm-mlstm", "xlstm-part-head", "musicgen-columns")
# the layouts the steps above leave out, against the port's own step on
# one device (itself held to the reference by test_torch_train_*.py)
PORT_STEPS = {
    "chameleon-qk_norm-hd": ("chameleon-34b", {}, {"num_kv_heads": 1}),
    "qwen2-bias-hd": ("qwen2-7b", {}, {"num_kv_heads": 1}),
    "qwen2-bias-qtp": ("qwen2-7b", {"attn_policy": "qtp"},
                       {"num_kv_heads": 1}),
    "musicgen-codebooks": ("musicgen-large", {}, {}),
    # the test's name; the mLSTM is split over ``model`` now
    "xlstm-mlstm-whole": ("xlstm-1.3b", {}, {}),
}
PROMPT, CACHE, DECODE = 16, 24, 3
MOE_FACTOR = 0.5


def _cfgs(arch, **kw):
    from torch_parity import smoke_cfgs
    from torch_train_parity import KINDS
    return smoke_cfgs(arch, kinds=arch in KINDS, **kw)


def _tokens(cfg, seed, shape):
    """Token ids of ``shape`` (and each codebook's, for multi-codebook
    archs, when ``shape`` is (B, S) or (B,))."""
    if len(shape) <= 2 and cfg.num_codebooks > 1:
        shape = shape + (cfg.num_codebooks,)
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _reference_step(jc, jp, tok, lab, mb):
    """The reference's step (``microbatches`` mb) from a fresh AdamW state,
    jitted, and its mean gradient, read back from AdamW's first ``m``:
    ``(1 - b1) g s``, ``s`` the clip scale."""
    import jax
    from repro.training.optimizer import init_opt_state as jinit
    from repro.training.train_step import TrainConfig as JTrainConfig
    from repro.training.train_step import make_train_step as jmake
    tcfg = JTrainConfig(microbatches=mb, remat="none", **STEP)
    jstep = jmake(jc, tcfg)
    p2, o2, m = jax.jit(lambda p: jstep(p, jinit(p), tok, lab))(jp)
    metrics = {k: float(v) for k, v in m.items()}
    s = min(1.0, tcfg.adamw.clip_norm / (metrics["gnorm"] + 1e-9))
    return {"grads": jax.tree.map(
                lambda t: np.asarray(t) / ((1 - tcfg.adamw.b1) * s), o2["m"]),
            "params": jax.tree.map(np.asarray, p2), "metrics": metrics}


def _reference_serve(jc, jp, tok, steps):
    """The reference's logits of a prefill (query chunks of ``Q_CHUNK``)
    and of decode steps feeding ``steps``, and the prefill's caches."""
    import jax
    import jax.numpy as jnp
    from repro.models import lm as jlm
    logits, caches = jax.jit(jlm.prefill, static_argnums=(1, 3, 4))(
        jp, jc, tok, CACHE, Q_CHUNK)
    out = [np.asarray(logits)]
    prefill_caches = jax.tree.leaves(jax.tree.map(np.asarray, caches))
    dec = jax.jit(jlm.decode_step, static_argnums=(1,))
    for i, t in enumerate(steps):
        pos = jnp.full((tok.shape[0],), PROMPT + i, jnp.int32)
        logits, caches = dec(jp, jc, caches, jnp.asarray(t), pos)
        out.append(np.asarray(logits))
    return out, prefill_caches


def _port_step(tc, tp, tok, lab):
    """The port's own single-device step and mean gradient, as
    ``_reference_step`` returns the reference's."""
    from repro_torch.training.optimizer import tree_map
    from repro_torch.training.train_step import (make_loss_and_grads,
                                                 make_train_step)
    tcfg = TrainConfig(microbatches=MB, remat="none", **STEP)
    names, paths, leaves = flatten_with_names(tp)
    _, grads = make_loss_and_grads(tc, tcfg)(paths, leaves, tok, lab)
    params = tree_map(torch.clone, tp)
    p2, _, m = make_train_step(tc, tcfg)(params, init_opt_state(params),
                                         tok, lab)
    host = lambda t: tree_map(lambda x: x.numpy(), t)
    from repro_torch.core.descriptor import unflatten_from_paths
    return {"grads": host(unflatten_from_paths(paths, grads)),
            "params": host(p2),
            "metrics": {k: float(v) for k, v in m.items()}}


def _port_drops(tc, tp, tok, lab, mb) -> int:
    """Tokens dropped over the MoE calls of the port's single-device loss
    on each of ``mb`` microbatches."""
    from repro_torch.models import lm
    from repro_torch.models import moe
    seen, orig = [], moe.moe_mlp

    def spy(params, x, cfg, return_aux=False, **kw):
        seen.append(moe.count_dropped(params, x, cfg))
        return orig(params, x, cfg, return_aux, **kw)

    moe.moe_mlp, n = spy, B // mb
    try:
        with torch.no_grad():
            for i in range(mb):
                lm.loss_fn(tp, tc, tok[i * n:(i + 1) * n],
                           lab[i * n:(i + 1) * n], q_chunk=Q_CHUNK,
                           remat="none", xent_chunk=XENT)
    finally:
        moe.moe_mlp = orig
    return sum(seen)


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    """The port's inputs for every case, saved for the ranks; the one
    spawn, which runs while this process computes the reference's
    results (each jitted once); rank 0's record beside them."""
    import concurrent.futures
    import jax
    from repro.models import moe as jmoe
    from repro_torch.models import lm
    from repro_torch.models.moe import init_moe
    refs, inputs, models = {}, {"steps": {}, "serve": {}}, {}
    jobs, pending = {}, {}       # the reference's jobs; case -> job

    def model(arch, kw):
        """Weights from the port's init, carried to the reference (the
        reference's eager init compiles op by op, ten times slower)."""
        key = (arch, tuple(sorted(kw.items())))
        if key not in models:
            jc, tc = _cfgs(arch, **kw)
            tp = lm.init_params(tc, torch.Generator().manual_seed(0), "cpu")
            models[key] = (jc, tc, jax.tree.map(lambda t: t.numpy(), tp), tp)
        return models[key]

    def case(arch, kw, mb):
        """The inputs of a step, and its reference's job key."""
        jc, tc, jp, tp = model(arch, kw)
        tok, lab = _tokens(jc, 1, (B, S)), _tokens(jc, 2, (B, S))
        key = ("step", arch, tuple(sorted(kw.items())), mb)
        jobs[key] = lambda: _reference_step(jc, jp, tok, lab, mb)
        return key, dict(cfg=tc, params=tp, tok=torch.from_numpy(tok),
                         lab=torch.from_numpy(lab), mb=mb)

    for name, (arch, env, kw, mb) in {**STEPS, **STEPS14}.items():
        # shardmap: each data shard's rows are a microbatch of their own
        ref_mb = mb * 2 if env.get("moe_impl") == "shardmap" else mb
        pending[name], inputs["steps"][name] = case(arch, kw, ref_mb)
        inputs["steps"][name].update(env=env, mb=mb, mesh=(
            (1, 4) if name in STEPS14 else (2, 2)))
    for mb in (1, 2):
        pending[f"repair-mb{mb}"], inputs["repair"] = case(*MOE, mb)
    for name, (arch, env, kw) in PORT_STEPS.items():
        jc, tc, _, tp = model(arch, kw)
        tok = torch.from_numpy(_tokens(jc, 1, (B, S)))
        lab = torch.from_numpy(_tokens(jc, 2, (B, S)))
        refs[name] = _port_step(tc, tp, tok, lab)
        inputs["steps"][name] = dict(cfg=tc, params=tp, tok=tok, lab=lab,
                                     env=env, mb=MB, mesh=(2, 2))
    jc, tc, jp, tp = model(*MOE)
    refs["repair-drops"] = [_port_drops(tc, tp, inputs["repair"]["tok"],
                                        inputs["repair"]["lab"], mb)
                            for mb in (1, 2)]
    for name in SERVES:
        arch, env, kw, _ = {**STEPS, **STEPS14}[name]
        jc, tc, jp, tp = model(arch, kw)
        ptok = _tokens(jc, 3, (2, PROMPT))
        steps = [_tokens(jc, 4 + i, (2,)) for i in range(DECODE)]
        key = ("serve", arch, tuple(sorted(kw.items())))
        pending["serve-" + name] = key
        jobs[key] = (lambda jc=jc, jp=jp, ptok=ptok, steps=steps:
                     _reference_serve(jc, jp, ptok, steps))
        inputs["serve"][name] = dict(
            cfg=tc, env=env, params=tp, tok=torch.from_numpy(ptok),
            steps=[torch.from_numpy(t) for t in steps],
            mesh=(1, 4) if name in STEPS14 else (2, 2))
    jc, tc = _cfgs("moonshot-v1-16b-a3b", moe_capacity_factor=MOE_FACTOR)
    tm = init_moe(torch.Generator().manual_seed(3), tc)
    tx = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (B, S, jc.d_model)).astype(np.float32))
    half = B // 2
    refs["moe-drops"] = (
        count_dropped(tm, tx[:half], tc) + count_dropped(tm, tx[half:], tc),
        count_dropped(tm, tx, tc))
    inputs["moe"] = dict(cfg=tc, params=tm, x=tx)
    path = tmp_path_factory.mktemp("tp") / "inputs.pt"
    torch.save(inputs, path)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(elastic.spawn, _tp_rank, (str(path),), 4,
                            "gloo", "cpu")
        done = {key: job() for key, job in jobs.items()}
        jp, x = jax.tree.map(lambda t: t.numpy(), tm), tx.numpy()
        moe = lambda rows: np.asarray(jmoe._moe_mlp_gspmd(jp, rows, jc))
        refs["moe-shardmap"] = np.concatenate([moe(x[:half]),
                                               moe(x[half:])])
        refs["moe-gspmd"] = moe(x)
        got, dry = ranks.result()[:2]
    refs.update({name: done[key] for name, key in pending.items()})
    got["dry"] = dry
    return refs, got, inputs


# ---------------------------------------------------------------------------
# on the ranks
# ---------------------------------------------------------------------------


def _tp_rank(rank, device, store, tmp, path):
    data = torch.load(path, weights_only=False)
    mesh21 = make_test_mesh(2, 1, device_type="cpu", ranks=[0, 1])
    meshes = {(2, 2): make_test_mesh(2, 2, device_type="cpu"),
              (1, 4): make_test_mesh(1, 4, device_type="cpu")}
    mesh22 = meshes[(2, 2)]
    out, dry = {}, {}
    if rank < 2:
        c = data["repair"]
        for mb in (1, 2):
            out[f"repair-mb{mb}"] = _step(c, make_axis_env(mesh21), mb)
    for name, c in data["steps"].items():
        out[name] = _step(c, make_axis_env(meshes[c["mesh"]], **c["env"]),
                          c["mb"])
        dry[name] = out[name].pop("measured")
    for name, c in data["serve"].items():
        out["serve-" + name] = _serve(c, make_axis_env(meshes[c["mesh"]],
                                                       **c["env"]))
    out.update(_moe(data["moe"], mesh22))
    out["checkpoint"] = _checkpoint(data["steps"]["gemma3-v1"], mesh22, tmp)
    return {0: out, 1: dry}.get(rank)


def _step(c, env, mb):
    """One sharded step; ``measured``: its collectives by kind (calls and
    bytes) and its FLOPs (``FlopCounterMode``), for the dry run."""
    from torch.utils.flop_counter import FlopCounterMode
    cfg = c["cfg"]
    p = shard_tree(c["params"], cfg, env)
    step = make_sharded_train_step(cfg, _tcfg(mb), env)
    o = init_opt_state(p)
    before = comm.snapshot()
    with FlopCounterMode(display=False) as flops:
        p, o, m = step(p, o, c["tok"], c["lab"])
    coll = {}
    for kind, now in comm.snapshot().items():
        was = before.get(kind, {"calls": 0, "bytes": 0})
        if now["calls"] > was["calls"]:
            coll[kind] = {"calls": now["calls"] - was["calls"],
                          "bytes": now["bytes"] - was["bytes"]}
    return {"metrics": {k: float(v) for k, v in m.items()},
            "count": int(o["count"]), "params": gather_tree(p),
            "measured": {"collectives": coll,
                         "flops": flops.get_total_flops()}}


def _tcfg(mb):
    return TrainConfig(microbatches=mb, remat="full", **STEP)


def _serve(c, env):
    cfg = c["cfg"]
    p = shard_tree(c["params"], cfg, env)
    pre = make_sharded_serve_prefill(cfg, CACHE, env, q_chunk=Q_CHUNK)
    dec = make_sharded_serve_decode(cfg, env)
    with torch.no_grad():
        logits, caches = pre(p, c["tok"])
        out = [comm.gather(logits)]
        for i, t in enumerate(c["steps"]):
            pos = torch.full((t.shape[0],), PROMPT + i, dtype=torch.int32)
            logits, caches = dec(p, caches, t, pos)
            out.append(comm.gather(logits))
    return out


def _moe(c, mesh):
    cfg, tree = c["cfg"], {"groups": [{"blocks": [{"moe": c["params"]}]}]}
    out = {}
    for impl in ("shardmap", "gspmd"):
        env = make_axis_env(mesh, moe_impl=impl)
        moe = compute_params(shard_tree(tree, cfg, env), env)
        xl, _ = batch_rows(c["x"], 1, env)
        with torch.no_grad(), ctx.use_env(env, split_batch=True):
            y = moe_mlp(moe["groups"][0]["blocks"][0]["moe"], xl, cfg)
        out["moe-" + impl] = [None] * 2
        for i, part in enumerate(_all_rows(y, env)):
            out["moe-" + impl][i] = part
    return out


def _all_rows(y, env):
    """Every data shard's rows of ``y`` (each rank's own), in order."""
    parts = [torch.empty_like(y) for _ in range(env.dpsize)]
    torch.distributed.all_gather(parts, y.contiguous(),
                                 group=env.mesh.get_group("data"))
    return parts


def _bits_equal(a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.view(torch.int32), b.view(torch.int32))


def _checkpoint(c, mesh, tmp):
    """Model-sharded params and AdamW state saved, then read back on the
    mesh and on one rank: bit-equal (a list of failures)."""
    cfg = c["cfg"]
    env = make_axis_env(mesh)
    g = torch.Generator().manual_seed(9)
    rand = lambda tree: shard_tree(flatten_map(
        tree, lambda t: torch.randn(t.shape, generator=g)), cfg, env)
    p = shard_tree(c["params"], cfg, env)
    opt = {"m": rand(c["params"]), "v": rand(c["params"]),
           "count": torch.tensor(3, dtype=torch.int32)}
    dckpt.save_checkpoint(f"{tmp}/ck", 5, p, opt)
    torch.distributed.barrier()
    step, p2, o2, _ = dckpt.load_checkpoint(f"{tmp}/ck", device="cpu",
                                            env=env, cfg=cfg)
    bad = [] if step == 5 and int(o2["count"]) == 3 else ["step/count"]
    for key, a, b in [("params", p, p2), ("m", opt["m"], o2["m"]),
                      ("v", opt["v"], o2["v"])]:
        for n, x, y in zip(flatten_with_names(a)[0], flatten_with_names(a)[2],
                           flatten_with_names(b)[2]):
            if x.placements != y.placements or not _bits_equal(
                    x.to_local(), y.to_local()):
                bad.append(f"{key} {n}")
    if comm.is_first(mesh):
        _, p1, _, _ = dckpt.load_checkpoint(f"{tmp}/ck", device="cpu")
        for n, x, y in zip(*flatten_with_names(c["params"])[::2],
                           flatten_with_names(p1)[2]):
            if not _bits_equal(x, y):
                bad.append(f"one rank {n}")
    return bad


def flatten_map(tree, fn):
    from repro_torch.training.optimizer import tree_map
    return tree_map(fn, tree)


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


def _check_step(got, want, key):
    from torch_train_parity import step_bound
    w, g = want["metrics"], got["metrics"]
    assert abs(g["loss"] - w["loss"]) <= 1e-5 * w["loss"], key
    assert abs(g["gnorm"] - w["gnorm"]) <= 1e-4 * w["gnorm"], key
    assert g["lr"] == w["lr"] and got["count"] == 1, key
    names, _, leaves = flatten_with_names(got["params"])
    wnames, _, wleaves = flatten_with_names(want["params"])
    assert names == wnames
    grads = flatten_with_names(want["grads"])[2]
    for name, a, b, gw in zip(names, leaves, wleaves, grads):
        excess = np.abs(a.numpy() - b) - step_bound(gw, w["lr"], w["gnorm"])
        assert excess.max() <= 0, (key, name, excess.max())


@pytest.mark.parametrize("mb", [1, 2])
def test_sharded_step_takes_moe_capacity_over_the_microbatch(cases, mb):
    """The repair: on 2 data shards the MoE's capacity and in-expert order
    are the whole microbatch's, as the reference's GSPMD keeps them."""
    refs, got, _ = cases
    assert refs["repair-drops"][mb - 1] > 0          # tokens do drop
    _check_step(got[f"repair-mb{mb}"], refs[f"repair-mb{mb}"], mb)


@pytest.mark.parametrize("name", list(STEPS) + list(STEPS14))
def test_tensor_parallel_step_matches_reference(cases, name):
    refs, got, _ = cases
    _check_step(got[name], refs[name], name)


@pytest.mark.parametrize("name", DRY)
def test_dry_run_counts_what_a_rank_runs(cases, name):
    """The dry run (meta tensors, one rank of a fake group of 4) of a
    step: rank 1's collectives by kind, calls and bytes, and its FLOPs,
    equal to what rank 1 of the gloo spawn measured running it."""
    from repro_torch.distributed import op_analysis
    from repro_torch.launch import dryrun
    _, got, inputs = cases
    c = inputs["steps"][name]
    data, model = c["mesh"]
    with dryrun.fake_group(4):
        env = make_axis_env(dryrun.mesh_of({"data": data, "model": model}),
                            **c["env"])
        spec = dryrun.step_spec(c["cfg"], "train", env, B, S,
                                _tcfg(c["mb"]))
        an = op_analysis.analyze(spec["fn"], *spec["args"])
    assert not torch.distributed.is_initialized()
    want = got["dry"][name]
    assert an["port_collectives"] == want["collectives"], name
    assert an["dot_flops"] == want["flops"], name


@pytest.mark.parametrize("name", DRY)
def test_sharded_step_gathers_each_layer_in_its_loop(cases, name):
    """Rank 1's step gathers a group leaf's slice over ``data`` once per
    application of its block, per microbatch, and again in the full
    remat's recompute (``fsdp_layer_gather``); before the loss it
    gathers only the embedding's and the final norm's leaves that
    ``data`` shards (``all_gather``)."""
    from repro_torch.distributed.sharding import (MeshShape, param_pspec,
                                                  spec_axes)
    from repro_torch.models import lm
    _, got, inputs = cases
    c = inputs["steps"][name]
    cfg = c["cfg"]
    env = make_axis_env(MeshShape(("data", "model"), c["mesh"]), **c["env"])
    shapes = lm.init_params(cfg, torch.Generator(), "meta")
    layer = whole = 0
    for leaf, x in zip(*flatten_with_names(shapes)[::2]):
        spec = param_pspec(leaf, tuple(x.shape), cfg, env)
        if env.axes["data"] == 1 or "data" not in [
                a for e in spec for a in spec_axes(e)]:
            continue
        if leaf.startswith("groups/"):
            layer += cfg.groups[int(leaf.split("/")[1])].repeat
        else:
            whole += 1
    coll = got["dry"][name]["collectives"]
    assert coll.get("fsdp_layer_gather", {}).get("calls", 0) \
        == layer * c["mb"] * 2, name                 # remat "full"
    assert coll.get("all_gather", {}).get("calls", 0) == whole, name


@pytest.mark.parametrize("name", list(PORT_STEPS))
def test_tensor_parallel_step_matches_one_device(cases, name):
    refs, got, _ = cases
    _check_step(got[name], refs[name], name)


@pytest.mark.parametrize("name", SERVES)
def test_sharded_prefill_and_decode_match_reference(cases, name):
    refs, got, _ = cases
    want = refs["serve-" + name][0]
    assert len(got["serve-" + name]) == len(want) == DECODE + 1
    for a, b in zip(got["serve-" + name], want):
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("impl", ["shardmap", "gspmd"])
def test_moe_dispatch_matches_reference_per_shard_or_whole(cases, impl):
    """``shardmap``: the reference's ``_moe_mlp_gspmd`` on each data shard;
    ``gspmd``: on the whole batch.  Both drop tokens at factor 0.5."""
    refs, got, _ = cases
    assert min(refs["moe-drops"]) > 0
    y = torch.cat(got["moe-" + impl]).numpy()
    np.testing.assert_allclose(y, refs["moe-" + impl], rtol=1e-5, atol=1e-5)
    if impl == "shardmap":           # the two differ once tokens drop
        assert not np.allclose(y, refs["moe-gspmd"], rtol=1e-5, atol=1e-5)


def test_model_sharded_checkpoint_reads_back_bit_for_bit(cases):
    _, got, _ = cases
    assert got["checkpoint"] == []


def test_prefill_with_query_chunks_matches_reference(cases):
    """One device: gemma's prompt of 16 in query chunks of 8 (its window
    and global layers' chunked paths) against the reference's prefill."""
    from repro_torch.models import lm
    refs, _, inputs = cases
    c = inputs["serve"]["gemma3-v1"]
    with torch.no_grad():
        got, caches = lm.prefill(c["params"], c["cfg"], c["tok"], CACHE,
                                 q_chunk=Q_CHUNK)
    want, want_caches = refs["serve-gemma3-v1"]
    np.testing.assert_allclose(got.numpy(), want[0], rtol=0, atol=1e-4)
    got_caches = flatten_with_names(caches)[2]
    assert len(got_caches) == len(want_caches)
    for a, b in zip(got_caches, want_caches):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-5)


def test_chip_smoke_tensor_parallel_phase_rehearses_on_the_cpu():
    """Phase 10 at smoke size, then phase 11 on its run (the sweep at
    smoke size: two cells)."""
    from torch_parity import load_chip_smoke
    from repro_torch.configs.base import get_arch, reduce_for_smoke
    cs = load_chip_smoke()
    cpu = torch.device("cpu")
    got = cs.tensor_parallel_phase(torch, cpu, smoke=True)
    kinds = [c["case"].split(":")[0] for c in got.cases]
    assert kinds == ["b", "a", "b", "a", "c", "c", "c", "c", "d", "e", "g",
                     "g", "e", "f"]
    drops = {(c["impl"], c["factor"]): c["dropped"] for c in got.cases
             if c["case"].startswith("c:")}
    assert drops[("gspmd", 1.0)] > 0 and drops[("shardmap", 1.0)] > 0
    train = {"config": (reduce_for_smoke(get_arch("gemma3-1b")),
                        TrainConfig(microbatches=2, q_chunk=32,
                                    xent_chunk=32)),
             "batch": 4, "seq": 64, "mean_step_s_2_4": None,
             "peak_device_bytes": None}
    dry = cs.dryrun_phase(torch, cpu, got, train, smoke=True)
    assert [c["status"] for c in dry["a"]] == ["ok", "ok"]
    assert all(b["collectives_equal"] and b["flops_equal"]
               for b in dry["b"])
    assert dry["c"]["dot_flops"] > 0
