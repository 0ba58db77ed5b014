"""Sequence-parallel serve caches and per-layer FSDP gathers in the port,
against the reference.

A batch that does not divide the data axes (batch-1 long-context decode)
is served with its attention caches split along their sequence axis,
as the reference's ``cache_pspec`` lays them out.  One spawn of 4 gloo
CPU ranks serves batch 1 on data=2 x model=2 (``v1``; gemma3-1b also
under ``qtp``, whose head_dim split is at rest only) and on data=4 x
model=1, for the gemma3-1b, zamba2 and xlstm smoke configs cut to one
block of each kind, while this process computes the reference's
unsharded results once per arch (jitted):

- a prefill of an 11-token prompt into a cache of 24, then 5 decode
  steps at positions 11-15, which cross the data shards' boundary at 12
  (and 6 and 18 on 4 shards); gemma's window is cut to 10, so that its
  ring of 10 slots splits over 2 data shards (slots 1-5 cross 5) and not
  over 4 (every rank attends over the whole ring);
- the same 5 steps from a seeded cache: the prefill's, its attention
  entries below position 11 replaced by numpy-seeded values.

Logits within atol 1e-4 (as ``test_torch_serving.py``), greedy tokens
equal; every cache entry that no step wrote bit-equal to the
reference's, the written ones (and recurrent states) within rtol 1e-4,
atol 1e-5: they come from hidden states summed in another order.

The same spawn takes the ``qtp`` case whose Q heads per rank straddle KV
groups (12 Q heads over 2 KV heads on model 3) through a sharded step
and serve.  Single-process: the dry run's ``long_500k`` cells, and the
peak a smoke step saves by gathering layer by layer.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.descriptor import (flatten_with_names,  # noqa: E402
                                         unflatten_from_paths)
from repro_torch.distributed import comm  # noqa: E402
from repro_torch.distributed.sharding import (MeshShape,  # noqa: E402
                                              cache_pspec, local_shape,
                                              make_axis_env)
from repro_torch.distributed.train_step import (  # noqa: E402
    gather_tree, lay_out_cache, make_sharded_serve_decode,
    make_sharded_serve_prefill, make_sharded_train_step, shard_tree)
from repro_torch.launch import elastic  # noqa: E402
from repro_torch.launch.mesh import make_test_mesh  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.training.optimizer import init_opt_state  # noqa: E402
from repro_torch.training.train_step import TrainConfig  # noqa: E402

PROMPT, CACHE, DECODE, WINDOW = 11, 24, 5, 10
ARCHS = ("gemma3-1b", "zamba2-2.7b", "xlstm-1.3b")
# (data, model, attn_policy) of each serve run
MESHES = {"gemma3-1b": ((2, 2, "v1"), (2, 2, "qtp"), (4, 1, "v1")),
          "zamba2-2.7b": ((2, 2, "v1"), (4, 1, "v1")),
          "xlstm-1.3b": ((2, 2, "v1"), (4, 1, "v1"))}
RUNS = [(arch, m, start) for arch in ARCHS for m in MESHES[arch]
        for start in ("prefill", "seeded")]
STRADDLE = {"num_heads": 12, "num_kv_heads": 2}      # qwen2 smoke, model 3
B, S, MB = 4, 16, 2
STEP = dict(q_chunk=S, xent_chunk=12, warmup=0, peak_lr=1e-3)


def _cfgs(arch, **kw):
    """(reference, port) smoke configs; gemma's window cut to ``WINDOW``."""
    from torch_parity import smoke_cfgs
    from torch_train_parity import KINDS
    jc, tc = smoke_cfgs(arch, kinds=arch in KINDS, **kw)
    if arch == "gemma3-1b":
        cut = lambda c: dataclasses.replace(c, groups=tuple(
            dataclasses.replace(g, unit=tuple(
                dataclasses.replace(s, window=WINDOW) if s.window else s
                for s in g.unit)) for g in c.groups))
        jc, tc = cut(jc), cut(tc)
    return jc, tc


def _tokens(cfg, seed, shape):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _seeded(cfg, leaves, names):
    """The prefill's cache leaves, their attention entries below
    ``PROMPT`` replaced by numpy-seeded values."""
    rng = np.random.default_rng(17)
    out = []
    for name, a in zip(names, leaves):
        a = np.array(a)
        if name.split("/")[-1] in ("k", "v"):
            n = min(PROMPT, a.shape[2])
            a[:, :, :n] = rng.standard_normal(a[:, :, :n].shape)
        out.append(a.astype(np.float32))
    return out


def _reference(jc, jp, tok, steps, names):
    """The reference's logits and caches: the prefill and ``steps`` decode
    steps after it, and the same steps from the seeded cache."""
    import jax
    import jax.numpy as jnp
    from repro.models import lm as jlm
    logits, caches = jax.jit(jlm.prefill, static_argnums=(1, 3, 4))(
        jp, jc, tok, CACHE, PROMPT)
    leaves, tree = jax.tree.flatten(caches)
    seeded = _seeded(jc, leaves, names)
    dec = jax.jit(jlm.decode_step, static_argnums=(1,))
    out = {}
    for start, c in (("prefill", caches),
                     ("seeded", jax.tree.unflatten(
                         tree, [jnp.asarray(a) for a in seeded]))):
        got = [np.asarray(logits)] if start == "prefill" else []
        for i, t in enumerate(steps):
            pos = jnp.full((1,), PROMPT + i, jnp.int32)
            lg, c = dec(jp, jc, c, jnp.asarray(t), pos)
            got.append(np.asarray(lg))
        out[start] = (got, [np.asarray(a) for a in jax.tree.leaves(c)])
    return out, seeded


def _reference_step(jc, jp, tok, lab):
    """The reference's step (``MB`` microbatches) from a fresh AdamW
    state, and its mean gradient, read back from AdamW's first ``m``."""
    import jax
    from repro.training.optimizer import init_opt_state as jinit
    from repro.training.train_step import TrainConfig as JTrainConfig
    from repro.training.train_step import make_train_step as jmake
    tcfg = JTrainConfig(microbatches=MB, remat="none", **STEP)
    p2, o2, m = jax.jit(lambda p: jmake(jc, tcfg)(p, jinit(p), tok, lab))(jp)
    metrics = {k: float(v) for k, v in m.items()}
    s = min(1.0, tcfg.adamw.clip_norm / (metrics["gnorm"] + 1e-9))
    return {"grads": jax.tree.map(
                lambda t: np.asarray(t) / ((1 - tcfg.adamw.b1) * s), o2["m"]),
            "params": jax.tree.map(np.asarray, p2), "metrics": metrics}


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    """The port's inputs, saved for the ranks; the one spawn, which runs
    while this process computes the reference's results; rank 0's
    record beside them."""
    import concurrent.futures
    import jax
    inputs, jobs = {"serve": {}}, {}
    for arch in ARCHS:
        jc, tc = _cfgs(arch)
        tp = lm.init_params(tc, torch.Generator().manual_seed(0), "cpu")
        jp = jax.tree.map(lambda t: t.numpy(), tp)
        tok = _tokens(jc, 3, (1, PROMPT))
        steps = [_tokens(jc, 4 + i, (1,)) for i in range(DECODE)]
        names = flatten_with_names(lm.init_cache(tc, 1, CACHE,
                                                 torch.float32, "meta"))[0]
        jobs[arch] = (lambda jc=jc, jp=jp, tok=tok, steps=steps, names=names:
                      _reference(jc, jp, tok, steps, names))
        inputs["serve"][arch] = dict(cfg=tc, params=tp,
                                     tok=torch.from_numpy(tok),
                                     steps=[torch.from_numpy(t)
                                            for t in steps])
    refs = {}
    jc, tc = _cfgs("qwen2-7b", **STRADDLE)
    tp = lm.init_params(tc, torch.Generator().manual_seed(0), "cpu")
    jp = jax.tree.map(lambda t: t.numpy(), tp)
    tok, lab = _tokens(jc, 1, (B, S)), _tokens(jc, 2, (B, S))
    inputs["straddle"] = dict(cfg=tc, params=tp, tok=torch.from_numpy(tok),
                              lab=torch.from_numpy(lab))
    path = tmp_path_factory.mktemp("sp") / "inputs.pt"
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        # the seeded caches are the reference's: made before the spawn
        for arch, job in jobs.items():
            refs[arch] = job()
            inputs["serve"][arch]["seeded"] = [
                torch.from_numpy(a) for a in refs[arch][1]]
        torch.save(inputs, path)
        ranks = pool.submit(elastic.spawn, _rank, (str(path),), 4, "gloo",
                            "cpu")
        refs["straddle-step"] = _reference_step(jc, jp, tok, lab)
        refs["straddle-serve"] = _straddle_reference(jc, jp, tok)
        got = ranks.result()[0]
    return refs, got, inputs


def _straddle_reference(jc, jp, tok):
    import jax
    import jax.numpy as jnp
    from repro.models import lm as jlm
    logits, caches = jax.jit(jlm.prefill, static_argnums=(1, 3, 4))(
        jp, jc, tok[:, :PROMPT], CACHE, PROMPT)
    out = [np.asarray(logits)]
    dec = jax.jit(jlm.decode_step, static_argnums=(1,))
    for i in range(DECODE):
        pos = jnp.full((B,), PROMPT + i, jnp.int32)
        logits, caches = dec(jp, jc, caches, jnp.asarray(tok[:, PROMPT + i]),
                             pos)
        out.append(np.asarray(logits))
    return out


# ---------------------------------------------------------------------------
# on the ranks
# ---------------------------------------------------------------------------


def _rank(rank, device, store, tmp, path):
    data = torch.load(path, weights_only=False)
    meshes = {(2, 2): make_test_mesh(2, 2, device_type="cpu"),
              (4, 1): make_test_mesh(4, 1, device_type="cpu")}
    mesh13 = make_test_mesh(1, 3, device_type="cpu", ranks=[0, 1, 2])
    out = {}
    for arch, m, start in RUNS:
        env = make_axis_env(meshes[m[:2]], attn_policy=m[2])
        out[(arch, m, start)] = _serve(data["serve"][arch], env, start)
    if rank < 3:
        env = make_axis_env(mesh13, attn_policy="qtp")
        out["straddle-step"] = _step(data["straddle"], env)
        out["straddle-serve"] = _straddle_serve(data["straddle"], env)
    return out if rank == 0 else None


def _serve(c, env, start):
    """Batch 1 on ``env``: the prefill (or the seeded cache) and the
    decode steps; logits, the whole caches after the steps, each rank's
    cache part shapes (rank 0's) and the collectives by kind."""
    cfg = c["cfg"]
    p = shard_tree(c["params"], cfg, env)
    dec = make_sharded_serve_decode(cfg, env)
    comm.reset()
    with torch.no_grad():
        if start == "prefill":
            pre = make_sharded_serve_prefill(cfg, CACHE, env, q_chunk=PROMPT)
            logits, caches = pre(p, c["tok"])
            got = [comm.gather(logits)]
        else:
            names, paths, _ = flatten_with_names(lm.init_cache(
                cfg, 1, CACHE, torch.float32, "meta"))
            caches = unflatten_from_paths(paths, [
                lay_out_cache(n, t, cfg, env, 1)
                for n, t in zip(names, c["seeded"])])
            got = []
        for i, t in enumerate(c["steps"]):
            pos = torch.full((1,), PROMPT + i, dtype=torch.int32)
            logits, caches = dec(p, caches, t, pos)
            got.append(comm.gather(logits))
    names, _, leaves = flatten_with_names(caches)
    return {"logits": got, "caches": [comm.gather(x) for x in leaves],
            "names": names,
            "parts": [tuple(x.to_local().shape) for x in leaves],
            "comm": {k: v["calls"] for k, v in comm.snapshot().items()}}


def _step(c, env):
    cfg = c["cfg"]
    p = shard_tree(c["params"], cfg, env)
    step = make_sharded_train_step(
        cfg, TrainConfig(microbatches=MB, remat="full", **STEP), env)
    p, o, m = step(p, init_opt_state(p), c["tok"], c["lab"])
    return {"metrics": {k: float(v) for k, v in m.items()},
            "count": int(o["count"]), "params": gather_tree(p)}


def _straddle_serve(c, env):
    cfg = c["cfg"]
    p = shard_tree(c["params"], cfg, env)
    pre = make_sharded_serve_prefill(cfg, CACHE, env, q_chunk=PROMPT)
    dec = make_sharded_serve_decode(cfg, env)
    with torch.no_grad():
        logits, caches = pre(p, c["tok"][:, :PROMPT])
        out = [comm.gather(logits)]
        for i in range(DECODE):
            pos = torch.full((B,), PROMPT + i, dtype=torch.int32)
            logits, caches = dec(p, caches, c["tok"][:, PROMPT + i], pos)
            out.append(comm.gather(logits))
    return out


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


def _written(cfg, name, n, first):
    """The positions (a ring's slots) of cache leaf ``name`` (``n`` long)
    written from position ``first`` through the decode steps."""
    parts = name.split("/")
    window = cfg.groups[int(parts[1])].unit[int(parts[3])].window
    pos = range(first, PROMPT + DECODE)
    return sorted({p % n for p in pos} if window is not None else set(pos))


@pytest.mark.parametrize("arch,mesh,start", RUNS)
def test_batch1_serve_matches_reference(cases, arch, mesh, start):
    refs, got, inputs = cases
    cfg = inputs["serve"][arch]["cfg"]
    run = got[(arch, mesh, start)]
    want_logits, want_caches = refs[arch][0][start]
    assert len(run["logits"]) == len(want_logits)
    for a, b in zip(run["logits"], want_logits):
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-4)
        assert np.array_equal(a.numpy().argmax(-1), b.argmax(-1))
    env = make_axis_env(MeshShape(("data", "model"), mesh[:2]))
    split = 0
    for name, a, b, part in zip(run["names"], run["caches"], want_caches,
                                run["parts"]):
        a = a.numpy()
        assert a.shape == b.shape, name
        spec = cache_pspec(name, b.shape, cfg, env, 1)
        assert part == local_shape(b.shape, spec, env), name
        if name.split("/")[-1] not in ("k", "v"):     # recurrent: replicated
            assert part == b.shape, name
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5,
                                       err_msg=name)
            continue
        split += part[2] < b.shape[2]
        written = _written(cfg, name, b.shape[2],
                           PROMPT if start == "seeded" else 0)
        rest = np.setdiff1d(np.arange(b.shape[2]), written)
        assert np.array_equal(a[:, :, rest].view(np.int32),
                              b[:, :, rest].view(np.int32)), name
        np.testing.assert_allclose(a[:, :, written], b[:, :, written],
                                   rtol=1e-4, atol=1e-5, err_msg=name)
    # the sequence split where cache_pspec makes it, and only there
    combines = run["comm"].get("sp_attn_combine", 0)
    assert (split > 0) == (combines > 0), (split, combines)
    if arch == "gemma3-1b":           # global layers split on both meshes
        assert split >= 2


def test_serve_splits_a_ring_on_two_shards_and_not_on_four(cases):
    """gemma's ring of 10 slots: split on data=2, whole on data=4."""
    _, got, inputs = cases
    cfg = inputs["serve"]["gemma3-1b"]["cfg"]
    for mesh, n in (((2, 2, "v1"), WINDOW // 2), ((4, 1, "v1"), WINDOW)):
        run = got[("gemma3-1b", mesh, "seeded")]
        rings = [p[2] for name, p in zip(run["names"], run["parts"])
                 if cfg.groups[int(name.split("/")[1])].unit[
                     int(name.split("/")[3])].window]
        assert rings and set(rings) == {n}, (mesh, rings)


def test_qtp_heads_that_straddle_kv_groups_match_reference(cases):
    """12 Q heads over 2 KV heads on model 3: rank 1's 4 Q heads read KV
    heads 0, 0, 1, 1.  The sharded step within ``torch_train_parity``'s
    bounds, prefill and decode logits within atol 1e-4."""
    from torch_train_parity import step_bound
    refs, got, _ = cases
    g, w = got["straddle-step"], refs["straddle-step"]
    assert abs(g["metrics"]["loss"] - w["metrics"]["loss"]) \
        <= 1e-5 * w["metrics"]["loss"]
    assert abs(g["metrics"]["gnorm"] - w["metrics"]["gnorm"]) \
        <= 1e-4 * w["metrics"]["gnorm"]
    assert g["count"] == 1
    names, _, leaves = flatten_with_names(g["params"])
    wnames, _, wleaves = flatten_with_names(w["params"])
    assert names == wnames
    grads = flatten_with_names(w["grads"])[2]
    for name, a, b, gw in zip(names, leaves, wleaves, grads):
        excess = np.abs(a.numpy() - b) - step_bound(
            gw, w["metrics"]["lr"], w["metrics"]["gnorm"])
        assert excess.max() <= 0, (name, excess.max())
    for a, b in zip(got["straddle-serve"], refs["straddle-serve"]):
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("multi_pod", [False, True])
def test_long_500k_cell_ends_ok(arch, multi_pod):
    """Batch 1 over 524,288 positions on the production meshes: the
    attention caches split over the 16 (32) data shards."""
    from repro_torch.launch import dryrun
    cell = dryrun.run_cell(arch, "long_500k", multi_pod)
    assert cell["status"] == "ok", cell
    assert cell["chips"] == (512 if multi_pod else 256)
    kinds = cell["port_collectives"]
    has_attn = arch != "xlstm-1.3b"
    assert ("sp_attn_combine" in kinds) == has_attn, kinds
    assert not torch.distributed.is_initialized()


def test_layer_gathers_lower_a_steps_peak():
    """A smoke step on data=2 x model=2 (one rank of a fake group, meta
    tensors): gathering each layer inside the loop, against gathering
    every leaf before the loss (``compute_params`` and ``shard_grads``
    as they were), lowers the peak live bytes by at least the group
    leaves' gathered bytes less one unit's."""
    from repro_torch.configs.base import get_arch, reduce_for_smoke
    from repro_torch.distributed import ctx, op_analysis
    from repro_torch.distributed.sharding import param_pspec, spec_axes
    from repro_torch.distributed.train_step import (batch_rows,
                                                    compute_params,
                                                    shard_grads)
    from repro_torch.launch import dryrun
    from repro_torch.training.train_step import make_loss_and_grads
    cfg = dataclasses.replace(reduce_for_smoke(get_arch("train-100m")),
                              d_model=256, d_ff=1024, vocab_size=512)
    tcfg = TrainConfig(microbatches=1, remat="full", q_chunk=S,
                       xent_chunk=S)

    def whole_step(params, tok):
        """The loss and gradients with every leaf gathered first."""
        names, paths, leaves = flatten_with_names(params)
        rows, split = batch_rows(tok, 1, env)
        full = flatten_with_names(compute_params(params, env))[2]
        with ctx.use_env(env, split_batch=split):
            _, grads = make_loss_and_grads(cfg, tcfg)(paths, full, rows,
                                                      rows)
        del full
        return shard_grads(names, leaves, grads, cfg, env)

    def layer_step(params, tok):
        names, paths, leaves = flatten_with_names(params)
        rows, split = batch_rows(tok, 1, env)
        full = flatten_with_names(compute_params(params, env,
                                                 groups=False))[2]
        with ctx.use_env(env, split_batch=split):
            _, grads = make_loss_and_grads(cfg, tcfg)(paths, full, rows,
                                                      rows)
        del full
        return shard_grads(names, leaves, grads, cfg, env, groups=False)

    peaks = {}
    with dryrun.fake_group(4):
        env = make_axis_env(dryrun.mesh_of({"data": 2, "model": 2}))
        for name, fn in (("whole", whole_step), ("layer", layer_step)):
            spec = dryrun.step_spec(cfg, "train", env, B, S, tcfg)
            params, tok = spec["args"][0], spec["args"][2]
            peaks[name] = op_analysis.analyze(fn, params, tok)["peak_bytes"]
    shapes = lm.init_params(cfg, torch.Generator(), "meta")
    envs = make_axis_env(MeshShape(("data", "model"), (2, 2)))
    gathered, unit = 0, {}
    for name, x in zip(*flatten_with_names(shapes)[::2]):
        if not name.startswith("groups/"):
            continue
        spec = param_pspec(name, tuple(x.shape), cfg, envs)
        n = x.numel() * x.element_size() // np.prod(
            [2 for e in spec for a in spec_axes(e) if a == "model"] or [1])
        gathered += n
        g = name.split("/")[1]
        unit[g] = unit.get(g, 0) + n // cfg.groups[int(g)].repeat
    assert peaks["whole"] - peaks["layer"] >= gathered - max(unit.values()), (
        peaks, gathered, unit)
