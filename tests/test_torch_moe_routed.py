"""The MoE layer's routed path (``models/moe.py:_routed``) on the CPU: where
no token can drop, the sorted rows go through their own experts alone
(``kernels/moe_experts``, whose plain version runs here inside
``moe.routed_on("cpu")``) and give the JAX package's outputs (softmax
router), the plain ``tests/reference_moonlight.py``'s (sigmoid router with
shared experts) and the dense dispatch's; everywhere else, the CPU itself
outside that block included, the dense dispatch stays.  Also the kernel's
launch plan (``moe_experts.plan``), which only host ints decide."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import moe as jmoe  # noqa: E402

from repro_torch import tracing  # noqa: E402
from repro_torch.configs.base import MoESpec, get_arch  # noqa: E402
from repro_torch.kernels import moe_experts as MX  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

import reference_moonlight as R  # noqa: E402
from torch_parity import smoke_cfgs  # noqa: E402

BASE = dataclasses.replace(get_arch("micro-hello"), compute_dtype="float32",
                           param_dtype="float32")
# Mixtral's router (softmax, 8 experts, top 2, factor 4.0) and Moonlight's
# (sigmoid with a selection bias, 64 experts, top 6, factor 11.0, shared
# experts), at small widths
ROUTERS = {
    "softmax": (dataclasses.replace(BASE, moe_experts=8, moe_topk=2,
                                    moe_d_ff=32, moe_capacity_factor=4.0),
                None),
    "sigmoid": (dataclasses.replace(BASE, moe_experts=64, moe_topk=6,
                                    moe_d_ff=24, moe_capacity_factor=11.0),
                MoESpec(routed_scale=2.446, shared_d_ff=48)),
}
# the two paths hold the same fp32 products, taken by matmuls of other
# shapes (one expert's rows against a padded (E, cap) buffer), whose
# blockings may order the sums differently: fp32's default closeness
TOL = dict(rtol=1.3e-6, atol=1e-5)


@pytest.fixture
def routed_on_the_cpu():
    with MOE.routed_on("cpu"):
        yield


@pytest.fixture(autouse=True)
def tracer_on():
    tracing.reset()
    tracing.enable()
    yield
    tracing.disable()
    tracing.reset()


def _case(router, T, seed=0):
    cfg, spec = ROUTERS[router]
    gen = torch.Generator().manual_seed(seed)
    params = MOE.init_moe(gen, cfg, device="cpu", moe=spec)
    x = torch.randn(1, T, cfg.d_model, generator=gen)
    return cfg, spec, params, x


def _counts(fn):
    """fn()'s output and the tracer's counters it added."""
    tracing.reset()
    out = fn()
    return out, tracing.snapshot()["counters"]


def _tracking(params):
    return {k: _tracking(v) if isinstance(v, dict)
            else v.detach().clone().requires_grad_()
            for k, v in params.items()}


@pytest.mark.parametrize("T", [1, 2, 7, 64])
@pytest.mark.parametrize("gated", [True, False])
def test_routed_softmax_path_equals_the_jax_package(gated, T,
                                                    routed_on_the_cpu):
    """Mixtral's router (8 experts, top 2, factor 4.0) on the JAX package's
    weights, against its ``moe_mlp``: within the module tolerance of
    ``tests/test_torch_models.py`` (fp32, sums in another order)."""
    jc, tc = smoke_cfgs("moonshot-v1-16b-a3b", mlp_gated=gated,
                        moe_experts=8, moe_topk=2, moe_capacity_factor=4.0)
    assert MOE.capacity(tc, T) >= T
    jp = jmoe.init_moe(jax.random.PRNGKey(T), jc)
    params = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    x = np.random.default_rng(T).standard_normal(
        (1, T, tc.d_model)).astype(np.float32)
    got, c = _counts(lambda: MOE.moe_mlp(params, torch.from_numpy(x), tc))
    assert c["moe.routed_calls"] == 1
    assert c["moe.expert_rows"] == T * tc.moe_topk
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jmoe.moe_mlp(jp, jnp.asarray(x),
                                                       jc)),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("T", [1, 2, 7, 64])
def test_routed_sigmoid_path_equals_the_plain_reference(T,
                                                        routed_on_the_cpu):
    """Moonlight's router (64 experts, top 6, factor 11.0, a selection bias,
    shared experts) against ``tests/reference_moonlight.py``'s ``moe``, a
    loop over each token's experts: within fp32's default closeness."""
    cfg, spec, params, x = _case("sigmoid", T, seed=T)
    got, c = _counts(lambda: MOE.moe_mlp(params, x, cfg, moe=spec))
    assert c["moe.routed_calls"] == 1
    assert c["moe.shared_rows"] == T
    want = R.moe(params, x[0], {"moe_topk": cfg.moe_topk,
                                "routed_scale": spec.routed_scale})
    torch.testing.assert_close(got[0], want, **TOL)


@pytest.mark.parametrize("T", [1, 2, 7, 64])
@pytest.mark.parametrize("router", sorted(ROUTERS))
def test_routed_path_equals_the_dense_path(router, T, routed_on_the_cpu):
    cfg, spec, params, x = _case(router, T, seed=T)
    E, K = cfg.moe_experts, cfg.moe_topk
    assert MOE.capacity(cfg, T) >= T
    got, c = _counts(lambda: MOE.moe_mlp(params, x, cfg, moe=spec))
    assert c["moe.routed_calls"] == 1
    assert c["moe.routed_rows"] == c["moe.expert_rows"] == T * K
    want, d = _counts(lambda: MOE.moe_mlp(_tracking(params), x, cfg,
                                          moe=spec))
    assert "moe.routed_calls" not in d
    assert d["moe.expert_rows"] == E * MOE.capacity(cfg, T)
    torch.testing.assert_close(got, want.detach(), **TOL)
    again = MOE.moe_mlp(params, x, cfg, moe=spec)
    assert torch.equal(again, got)


def _dense_cases():
    cfg, _ = ROUTERS["softmax"]
    tight = dataclasses.replace(cfg, moe_capacity_factor=1.25)
    return {
        "cap-below-T": (tight, {}, lambda p: p, "cpu"),
        "return-aux": (cfg, {"return_aux": True}, lambda p: p, "cpu"),
        "grad-params": (cfg, {}, _tracking, "cpu"),
        "meta": (cfg, {}, lambda p: p, "meta"),
    }


@pytest.mark.parametrize("case", sorted(_dense_cases()))
def test_the_dense_path_stays_where_the_routed_one_does_not_apply(
        case, routed_on_the_cpu):
    cfg, kw, prepare, device = _dense_cases()[case]
    T = 8
    gen = torch.Generator().manual_seed(5)
    params = MOE.init_moe(gen, cfg, device="cpu")
    x = torch.randn(1, T, cfg.d_model, generator=gen)
    if device == "meta":
        params = {k: torch.empty_like(v, device="meta")
                  for k, v in params.items()}
        x = torch.empty_like(x, device="meta")
    out, c = _counts(lambda: MOE.moe_mlp(prepare(params), x, cfg, **kw))
    assert "moe.routed_calls" not in c
    assert c["moe.expert_rows"] == cfg.moe_experts * MOE.capacity(cfg, T)
    if case == "cap-below-T":
        assert MOE.capacity(cfg, T) < T


@pytest.mark.parametrize("router", sorted(ROUTERS))
def test_the_cpu_keeps_the_dense_path_by_default(router):
    """Only the card, where the grouped kernel launches, takes the routed
    path: a CPU call that could take it keeps the dense dispatch, outside
    ``routed_on("cpu")`` and again once that block has left."""
    cfg, spec, params, x = _case(router, 2)
    assert MOE.capacity(cfg, 2) >= 2
    with MOE.routed_on("cpu"):
        _, inside = _counts(lambda: MOE.moe_mlp(params, x, cfg, moe=spec))
    assert inside["moe.routed_calls"] == 1
    _, c = _counts(lambda: MOE.moe_mlp(params, x, cfg, moe=spec))
    assert "moe.routed_calls" not in c
    assert c["moe.expert_rows"] == cfg.moe_experts * MOE.capacity(cfg, 2)


@pytest.mark.parametrize("gated", [True, False])
def test_plain_version_is_each_experts_mlp(gated):
    """Rows sorted by expert, an expert with none among them."""
    gen = torch.Generator().manual_seed(2)
    E, D, Fd = 4, 12, 8
    counts = torch.tensor([3, 0, 1, 2])
    starts = torch.cumsum(counts, 0) - counts
    h = torch.randn(6, D, generator=gen)
    wi, wg = (torch.randn(E, D, Fd, generator=gen) for _ in range(2))
    wd = torch.randn(E, Fd, D, generator=gen)
    got = MX.moe_experts(h, counts, starts, wi, wg if gated else None, wd)
    for r, e in enumerate([0, 0, 0, 2, 3, 3]):
        a = h[r] @ wi[e]
        a = (torch.nn.functional.silu(h[r] @ wg[e]) * a if gated
             else torch.nn.functional.gelu(a, approximate="tanh"))
        torch.testing.assert_close(got[r], a @ wd[e], **TOL)


def test_the_kernel_backend_needs_cuda_tensors():
    h = torch.zeros(2, 4)
    counts = torch.tensor([2, 0])
    w = torch.zeros(2, 4, 4)
    with pytest.raises(RuntimeError, match="need CUDA"):
        MX.moe_experts(h, counts, counts, w, w, w, backend="kernel")


def _tiles(counts, bm):
    return sum(-(-int(n) // bm) for n in counts)


@pytest.mark.parametrize("shape", [
    (1, 8, 2, 4096, 14336), (32, 8, 2, 4096, 14336),
    (33, 8, 2, 4096, 14336), (256, 8, 2, 4096, 14336),
    (513, 8, 2, 4096, 14336), (1024, 8, 2, 4096, 14336),
    (1, 64, 6, 2048, 1408), (85, 64, 6, 2048, 1408),
    (1366, 64, 6, 2048, 1408), (4096, 64, 6, 2048, 1408),
    (3, 4, 2, 64, 64), (37, 8, 3, 64, 24)])
def test_plan_bounds_every_routing(shape):
    """The grid's tile bound holds every expert's tiles whatever the
    routing (spread, all on one expert, random); a split is never empty,
    a gemv split no longer than its shared memory holds, a tiled one a
    whole number of slabs; decode and prefills of up to 128 rows an expert
    take gemv, longer ones the tiled route, whose reduction splits only
    where its grid is short of blocks."""
    T, E, K, D, Fd = shape
    TK = T * K
    p = MX.plan(TK, E, D, Fd, True, 132)
    gemv = TK <= MX.GEMV_ROWS * MX.GEMV_TILES * E
    assert p.route == ("gemv" if gemv else "tiled")
    assert p.bm == (MX.GEMV_ROWS if gemv else MX.TILE_ROWS)
    gen = torch.Generator().manual_seed(T)
    picks = torch.rand(T, E, generator=gen).topk(K, -1).indices
    skewed = torch.zeros(E, dtype=torch.long)
    skewed[0] = T
    skewed[1:K] = T
    for counts in (MOE.expert_counts(picks.reshape(-1), E), skewed):
        assert int(counts.sum()) == TK
        assert _tiles(counts, p.bm) <= p.tiles
    for chunk, splits, K_dim in ((p.up_chunk, p.up_splits, D),
                                 (p.dn_chunk, p.dn_splits, Fd)):
        assert (splits - 1) * chunk < K_dim <= splits * chunk
        if gemv:
            assert chunk <= MX.MAX_CHUNK and chunk % MX.UNROLL == 0
        else:
            assert chunk % MX.SLAB == 0 and splits <= MX.MAX_SPLITS
    if T == 1:
        assert gemv and p.up_splits * p.dn_splits > 1
    if shape == (1024, 8, 2, 4096, 14336):      # Mixtral: 32 x 32 blocks
        assert (p.up_splits, p.dn_splits) == (1, 4)
    if shape == (4096, 64, 6, 2048, 1408):      # Moonlight: 384 x 16
        assert (p.up_splits, p.dn_splits) == (1, 1)
