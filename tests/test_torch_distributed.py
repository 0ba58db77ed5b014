"""Sharded data-parallel training in the port against the reference.

The reference's sharding rules (``param_pspec``, ``batch_pspec``,
``cache_pspec``) against the port's, leaf for leaf, on every arch's full
and smoke shapes (``jax.eval_shape``) and on every mesh and policy; the
port's placements and layout on a 4-rank gloo CPU mesh; the sharded step
on 2 and 4 gloo CPU ranks against the reference's ``make_train_step``
(``torch_train_parity``'s tolerances); the elastic launcher end to end and
``chip_smoke.py``'s distributed phase, rehearsed on the CPU.

The multi-rank tests spawn their ranks with
``repro_torch.launch.elastic.spawn``: each rank joins a gloo group through
a ``FileStore`` in the spawn's own temporary directory (no port is fixed),
every collective times out after 60 s, and a rank that raises ends the
others.  The rank functions below import neither jax nor the reference.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import get_arch, reduce_for_smoke
from repro_torch.core.descriptor import flatten_with_names
from repro_torch.distributed import comm, ctx
from repro_torch.distributed.sharding import (MeshShape, P, batch_pspec,
                                              cache_pspec, local_shape,
                                              make_axis_env, param_pspec,
                                              placements)
from repro_torch.launch import elastic
from repro_torch.launch.mesh import make_production_mesh, make_test_mesh
from repro_torch.models import lm

MESHES = [(("data", "model"), (16, 16)), (("pod", "data", "model"), (2, 16, 16)),
          (("data", "model"), (2, 4)), (("data", "model"), (2, 1)),
          (("data", "model"), (4, 1))]
POLICIES = [(a, f) for a in ("v1", "qtp") for f in (True, False)]
BATCHES = (1, 2, 4, 8, 32, 64, 512)


def _archs():
    from repro.configs.base import list_archs
    return list_archs()


def _norm(spec):
    """A spec as ``PartitionSpec`` prints it: a one-axis tuple is its name."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


class _RefMesh:
    """The reference's rules read ``mesh.shape[axis]`` and ``axis_names``."""

    def __init__(self, names, sizes):
        self.axis_names, self.shape = names, dict(zip(names, sizes))


def _envs():
    from repro.distributed.sharding import make_axis_env as jmake_axis_env
    for names, sizes in MESHES:
        for policy, over_pod in POLICIES:
            yield ((names, sizes, policy, over_pod),
                   jmake_axis_env(_RefMesh(names, sizes), over_pod, policy),
                   make_axis_env(MeshShape(names, sizes), over_pod, policy))


@functools.lru_cache(maxsize=None)
def _shapes(arch):
    """The reference's param shapes of ``arch`` whole and at smoke size, and
    its cache shapes at smoke size (batch 2) and whole (batch 1, a long
    context): (label, cfg, [(name, shape)]) each."""
    import jax
    from repro.configs.base import get_arch as jget_arch
    from repro.configs.base import reduce_for_smoke as jreduce
    from repro.core.descriptor import flatten_with_names as jflat
    from repro.models import lm as jlm
    full = jget_arch(arch)
    smoke = jreduce(full)
    key = jax.random.PRNGKey(0)

    def leaves(tree):
        names, _, ls = jflat(tree)
        return [(n, tuple(l.shape)) for n, l in zip(names, ls)]

    params = [(label, cfg, leaves(jax.eval_shape(
        functools.partial(jlm.init_params, cfg=cfg), key)))
        for label, cfg in (("full", full), ("smoke", smoke))]
    caches = [(label, cfg, b, leaves(jax.eval_shape(
        lambda c=cfg, b=b, n=n: jlm.init_cache(c, b, n))))
        for label, cfg, b, n in (("smoke", smoke, 2, 64),
                                 ("full", full, 1, 1024))]
    return params, caches


@pytest.mark.parametrize("arch", _archs())
def test_param_pspec_equals_reference(arch):
    from repro.distributed.sharding import param_pspec as jparam_pspec
    params, _ = _shapes(arch)
    for key, jenv, tenv in _envs():
        for label, cfg, leaves in params:
            tcfg = get_arch(arch) if label == "full" else reduce_for_smoke(
                get_arch(arch))
            for name, shape in leaves:
                want = jparam_pspec(name, shape, cfg, jenv)
                got = param_pspec(name, shape, tcfg, tenv)
                assert isinstance(got, P)
                assert _norm(got) == _norm(want), (key, label, name, shape)


@pytest.mark.parametrize("arch", _archs())
def test_cache_pspec_equals_reference(arch):
    from repro.distributed.sharding import cache_pspec as jcache_pspec
    _, caches = _shapes(arch)
    for key, jenv, tenv in _envs():
        for label, cfg, batch, leaves in caches:
            for b in (batch,) + BATCHES:
                for name, shape in leaves:
                    want = jcache_pspec(name, shape, cfg, jenv, b)
                    got = cache_pspec(name, shape, cfg, tenv, b)
                    assert _norm(got) == _norm(want), (key, label, b, name)


def test_batch_pspec_and_meshes_equal_reference():
    from repro.distributed.sharding import batch_pspec as jbatch_pspec
    for key, jenv, tenv in _envs():
        assert (tenv.msize, tenv.fsize, tenv.dpsize) == (
            jenv.msize, jenv.fsize, jenv.dpsize), key
        for b in BATCHES + (3, 6, 48):
            assert _norm(batch_pspec(b, tenv)) == _norm(jbatch_pspec(b, jenv))
    assert make_production_mesh().shape == {"data": 16, "model": 16}
    assert make_production_mesh(multi_pod=True).shape == {
        "pod": 2, "data": 16, "model": 16}
    assert P("data", None) == ("data", None) and repr(P()) == "P()"


@pytest.mark.parametrize("kw", [{}, {"moe_impl": "shardmap"},
                                {"mamba_tp": True},
                                {"attn_policy": "qtp", "moe_impl": "gspmd",
                                 "mamba_tp": True}])
def test_axis_env_equals_reference(kw):
    """``make_axis_env``'s fields, ``moe_impl`` and ``mamba_tp`` included,
    and their defaults, as the reference's."""
    import dataclasses
    from repro.distributed.sharding import make_axis_env as jmake_axis_env
    for names, sizes in MESHES:
        for over_pod in (True, False):
            j = jmake_axis_env(_RefMesh(names, sizes), over_pod, **kw)
            t = make_axis_env(MeshShape(names, sizes), over_pod, **kw)
            fields = [f.name for f in dataclasses.fields(j)
                      if f.name != "mesh"]
            assert fields == [f.name for f in dataclasses.fields(t)
                              if f.name != "mesh"]
            assert all(getattr(t, f) == getattr(j, f) for f in fields), (
                names, sizes, kw)


def test_placements_and_local_shapes():
    from torch.distributed.tensor import Replicate, Shard
    env = make_axis_env(MeshShape(("pod", "data", "model"), (2, 4, 8)))
    assert placements(P(("pod", "data"), None, "model"), env) == (
        Shard(0), Shard(0), Shard(2))
    assert placements(P(), env) == (Replicate(),) * 3
    assert local_shape((16, 3, 64), P(("pod", "data"), None, "model"),
                       env) == (2, 3, 8)
    with pytest.raises(ValueError, match="does not divide"):
        local_shape((12, 3), P(("pod", "data")), env)
    with pytest.raises(ValueError, match="mesh order"):
        placements(P(("data", "pod")), env)
    with pytest.raises(ValueError, match="shards two dims"):
        placements(P("data", "data"), env)


def test_shardings_trees_follow_the_specs():
    from repro_torch.distributed.sharding import (cache_shardings,
                                                  opt_state_shardings,
                                                  params_shardings)
    cfg = reduce_for_smoke(get_arch("gemma3-1b"))
    env = make_axis_env(MeshShape(("pod", "data", "model"), (2, 2, 4)))
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), "meta")
    sh = params_shardings(cfg, params, env)
    names, _, leaves = flatten_with_names(params)
    got = flatten_with_names(sh)[2]
    assert len(got) == len(leaves)
    for name, t, ns in zip(names, leaves, got):
        spec = param_pspec(name, tuple(t.shape), cfg, env)
        assert ns.spec == spec and ns.mesh is env.mesh, name
        assert ns.placements == placements(spec, env), name
    opt = opt_state_shardings(sh, env)
    assert opt["m"] is sh and opt["v"] is sh
    assert opt["count"].spec == P()
    assert opt["count"].placements == placements(P(), env)
    caches = lm.init_cache(cfg, 4, 16, device="meta")
    cnames, _, cleaves = flatten_with_names(caches)
    csh = flatten_with_names(cache_shardings(cfg, caches, env, 4))[2]
    assert len(csh) == len(cleaves)
    for name, t, ns in zip(cnames, cleaves, csh):
        assert ns.spec == cache_pspec(name, tuple(t.shape), cfg, env, 4), name


def test_constrain_is_identity_without_env_or_dtensor():
    x = torch.arange(8.0).reshape(2, 4)
    assert ctx.get_env() is None
    assert ctx.constrain(x, ("dp", "model")) is x
    env = make_axis_env(MeshShape(("data", "model"), (2, 4)))
    with ctx.use_env(env):
        assert ctx.get_env() is env
        assert ctx.constrain(x, ("dp", None)) is x      # a plain tensor
    assert ctx.get_env() is None


# ---------------------------------------------------------------------------
# on gloo CPU ranks
# ---------------------------------------------------------------------------


def _smoke_100m():
    import dataclasses
    return dataclasses.replace(reduce_for_smoke(get_arch("train-100m")),
                               compute_dtype="float32")


def _layout_rank(rank, device, store, tmp):
    """On a (pod 2, data 2, model 1) mesh: shard train-100m-smoke's params
    (fsdp over pod and data), check each shard's shape, DTensor's own
    view of the whole and the port's gather; the sharded global norm; a
    sharded checkpoint read back whole and sharded; ``constrain``."""
    from torch.distributed.tensor import DTensor
    from repro_torch.distributed.train_step import (gather_tree, shard_tree,
                                                    local_part)
    from repro_torch.distributed import checkpoint as ckpt
    from repro_torch.training.optimizer import global_norm, init_opt_state
    cfg = _smoke_100m()
    mesh = make_test_mesh(data=2, model=1, pod=2, device_type="cpu")
    env = make_axis_env(mesh)
    full = lm.init_params(cfg, torch.Generator().manual_seed(0), device)
    sharded = shard_tree(full, cfg, env)
    names, _, fl = flatten_with_names(full)
    out = {"shapes": []}
    for name, f, d in zip(names, fl, flatten_with_names(sharded)[2]):
        spec = param_pspec(name, tuple(f.shape), cfg, env)
        assert isinstance(d, DTensor) and d.shape == f.shape
        assert tuple(d.to_local().shape) == local_shape(f.shape, spec, env)
        assert d.placements == placements(spec, env)
        assert torch.equal(d.full_tensor(), f), name        # DTensor's view
        assert torch.equal(comm.gather(d), f), name
        g = comm.gather(d, first_only=True)
        assert torch.equal(g, f) if comm.is_first(mesh) else g is None, name
        out["shapes"].append((name, tuple(d.to_local().shape)))
    want = float(global_norm(full))
    got = float(global_norm(sharded))
    out["norm"] = (got, want)
    opt = init_opt_state(sharded)
    ckpt.save_checkpoint(f"{tmp}/ck", 3, sharded, opt)
    torch.distributed.barrier()
    step, p1, o1, _ = ckpt.load_checkpoint(f"{tmp}/ck", device="cpu")
    assert step == 3 and all(torch.equal(a, b) for a, b in zip(
        flatten_with_names(p1)[2], fl))
    step, p2, o2, _ = ckpt.load_checkpoint(f"{tmp}/ck", device="cpu",
                                           env=env, cfg=cfg)
    for a, b in zip(flatten_with_names(p2)[2],
                    flatten_with_names(sharded)[2]):
        assert a.placements == b.placements
        assert torch.equal(a.to_local(), b.to_local())
    assert int(o2["count"]) == 0
    assert all(torch.equal(a, b) for a, b in zip(
        flatten_with_names(gather_tree(p2))[2], fl))
    # constrain: a plain tensor stays, a DTensor is laid out by the dims
    x = DTensor.from_local(torch.arange(16.0).reshape(4, 4), mesh,
                           placements(P(), env), run_check=False)
    with ctx.use_env(env):
        y = ctx.constrain(x, ("dp", None))
    assert y.placements == placements(P(("pod", "data")), env)
    assert torch.equal(y.to_local(), local_part(
        torch.arange(16.0).reshape(4, 4), P(("pod", "data")), env))
    with ctx.use_env(env):                 # 2 rows do not divide over 4
        z = ctx.constrain(x[:2], ("dp", None))
    assert z.placements == placements(P(), env)
    # a model=2 mesh: shards over data and model, the fsdp-only gather
    # keeping the model shard
    from repro_torch.distributed.train_step import compute_params
    env2 = make_axis_env(make_test_mesh(data=2, model=2, device_type="cpu"))
    # the reference's jax.make_mesh((2, 2), ("data", "model")): row-major
    assert env2.mesh.mesh.tolist() == [[0, 1], [2, 3]]
    assert env2.mesh.mesh_dim_names == ("data", "model")
    sharded2 = shard_tree(full, cfg, env2)
    kept = flatten_with_names(compute_params(sharded2, env2))[2]
    out["shapes_model2"] = []
    for name, f, d, k in zip(names, fl, flatten_with_names(sharded2)[2],
                             kept):
        spec = param_pspec(name, tuple(f.shape), cfg, env2)
        assert tuple(d.to_local().shape) == local_shape(f.shape, spec, env2)
        assert d.placements == placements(spec, env2)
        assert torch.equal(comm.gather(d), f), name
        g = comm.gather(d, first_only=True)
        assert (torch.equal(g, f) if comm.is_first(env2.mesh)
                else g is None), name
        model_only = P(*[e if e == "model" else None for e in spec])
        assert torch.equal(k, local_part(f, model_only, env2)), name
        out["shapes_model2"].append((name, tuple(d.to_local().shape)))
    return out


def test_layout_on_four_cpu_ranks():
    ranks = elastic.spawn(_layout_rank, (), 4, "gloo", "cpu")
    env = make_axis_env(MeshShape(("pod", "data", "model"), (2, 2, 1)))
    cfg = _smoke_100m()
    full = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    for name, shape in ranks[0]["shapes"]:
        t = dict(zip(*flatten_with_names(full)[::2]))[name]
        assert shape == local_shape(t.shape, param_pspec(
            name, tuple(t.shape), cfg, env), env)
        if name.endswith(("wq", "wi", "wd")):          # fsdp: 4 ways
            assert np.prod(shape) * 4 == t.numel()
    for r in ranks:
        got, want = r["norm"]
        assert abs(got - want) <= 1e-6 * want          # replicas counted once
    env2 = make_axis_env(MeshShape(("data", "model"), (2, 2)))
    for name, shape in ranks[0]["shapes_model2"]:
        t = dict(zip(*flatten_with_names(full)[::2]))[name]
        spec = param_pspec(name, tuple(t.shape), cfg, env2)
        assert shape == local_shape(t.shape, spec, env2)
        if name.endswith(("wq", "wi", "wd")):          # data x model
            assert np.prod(shape) * 4 == t.numel(), name


def _step_rank(rank, device, store, tmp, dp, case_path, tcfg):
    """One sharded step of train-100m-smoke from the params and tokens saved
    at ``case_path`` on a (dp, 1) mesh of the first ``dp`` ranks; rank 0
    returns the loss, gnorm, lr, count and the gathered params."""
    from repro_torch.distributed.train_step import (gather_tree,
                                                    make_sharded_train_step,
                                                    shard_tree)
    from repro_torch.training.optimizer import init_opt_state
    cfg = _smoke_100m()
    case = torch.load(case_path)
    env = make_axis_env(make_test_mesh(data=dp, model=1, device_type="cpu"))
    p = shard_tree(case["params"], cfg, env)
    step = make_sharded_train_step(cfg, tcfg, env)
    p, o, m = step(p, init_opt_state(p), case["tok"], case["lab"])
    full = gather_tree(p)
    return {"metrics": {k: float(v) for k, v in m.items()},
            "count": int(o["count"]), "params": full} if rank == 0 else None


@pytest.fixture(scope="module")
def step_case():
    from torch_train_parity import make_case
    return make_case("train-100m", batch=8)


@pytest.mark.parametrize("dp", [2, 4])
def test_sharded_step_matches_reference(step_case, dp, tmp_path):
    from torch_train_parity import STEP, step_bound
    from repro_torch.training.train_step import TrainConfig
    case = step_case
    # through a file: arguments a spawned rank must unpickle before it starts
    path = tmp_path / "case.pt"
    torch.save({k: case[k] for k in ("tok", "lab")} | {"params": case["tp"]},
               path)
    r = elastic.spawn(_step_rank, (dp, str(path), TrainConfig(**STEP)), dp,
                      "gloo", "cpu")[0]
    want, got = case["step_metrics"], r["metrics"]
    assert abs(got["loss"] - want["loss"]) <= 1e-5 * want["loss"]
    assert abs(got["gnorm"] - want["gnorm"]) <= 1e-4 * want["gnorm"]
    assert got["lr"] == want["lr"] and r["count"] == case["step_count"] == 1
    names, _, leaves = flatten_with_names(r["params"])
    wnames, _, wleaves = flatten_with_names(case["step_params"])
    assert names == wnames
    grads = flatten_with_names(case["grads"])[2]
    for name, g, w, gw in zip(names, leaves, wleaves, grads):
        excess = np.abs(g.numpy() - w) - step_bound(gw, want["lr"],
                                                    want["gnorm"])
        assert excess.max() <= 0, (dp, name, excess.max())


def test_elastic_run_on_cpu_ranks():
    r = elastic.run(["--steps", "6", "--seq", "16", "--device", "cpu"])
    assert len(r.losses) == 6 and r.dp == [2, 2, 2, 2, 4, 4]
    assert all(np.isfinite(r.losses)) and r.losses[-1] < r.losses[0]
    assert r.fork["pages_rdma"] == r.fork["frames"] > 0
    assert r.checkpoint["bytes"] > r.full_state_bytes
    full = r.full_state_bytes
    for k in r.ranks:
        assert 0 < k["state_bytes"]["dp4"] < full
    assert r.ranks[0]["state_bytes"]["dp2"] > r.ranks[0]["state_bytes"]["dp4"]
    assert r.comm["train_dp2"]["reduce_scatter"]["calls"] > 0
    # the step gathers each layer's params inside its layer loop
    assert r.comm["train_dp4"]["fsdp_layer_gather"]["calls"] > 0
    assert r.checks == {}


def test_chip_smoke_distributed_phase_rehearses_on_the_cpu():
    from torch_parity import load_chip_smoke
    line = load_chip_smoke().distributed_phase(torch, torch.device("cpu"),
                                        smoke=True)
    assert line["steps"] == 12 and line["dp"] == [2] * 8 + [4] * 4
    assert set(line["checks"]) == {"a", "b", "c", "d"}
    a = line["checks"]["a"]
    assert set(a) == {"step0", "step1"}
    assert a["step0"]["lr"] == 0 < a["step1"]["lr"] == a["step1"]["sharded_lr"]
    assert line["comm"]["join"]["broadcast"]["bytes"] > 0
    assert line["gloo_collectives"] == {
        "device": "cpu", "all_gather_into_tensor": True,
        "reduce_scatter_tensor": True, "all_reduce": True, "broadcast": True,
        "all_gather": True, "reduce": True, "gather": True,
        "all_reduce_max": True}
