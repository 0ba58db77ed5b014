"""The MoE, Mamba2 and xLSTM families against the reference, module by
module and as whole models, with the reference's weights carried across
(``models/convert.py``) and inputs from numpy seeds.

Tolerances, fp32 on the CPU: the module functions within rtol 1e-5 and
atol 1e-6 (summation order of einsums and matmuls; softplus is computed
as the reference computes it); whole-model logits within atol 1e-4, as
``tests/test_torch_serving.py`` holds the attention models."""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import get_arch as jget_arch  # noqa: E402
from repro.models import flops as jflops  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models import xlstm as jxl  # noqa: E402

from repro_torch.configs.base import (MambaSpec, MLSTMSpec,  # noqa: E402
                                      SLSTMSpec, get_arch)
from repro_torch.models import flops, lm  # noqa: E402
from repro_torch.models import moe, ssm, xlstm  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

from torch_parity import smoke_cfgs  # noqa: E402


def _cfgs(family):
    """smoke_cfgs of ``family``: an arch, or ``arch:kinds`` for the arch
    cut to one block of each kind."""
    name, _, kinds = family.partition(":")
    return smoke_cfgs(name, kinds=bool(kinds))

RTOL, ATOL = 1e-5, 1e-6          # module functions
LOGIT_ATOL = 1e-4                # whole models
FAMILIES = ["moonshot-v1-16b-a3b", "kimi-k2-1t-a32b", "zamba2-2.7b",
            "xlstm-1.3b"]
# the smoke cut of zamba2 is Mamba blocks only and of xlstm mLSTM blocks
# only; cut to one block of each kind, zamba2 applies its one shared
# attention block twice and xlstm runs an sLSTM inside the model
KINDS = ["zamba2-2.7b:kinds", "xlstm-1.3b:kinds"]

_jprefill = jax.jit(jlm.prefill, static_argnums=(1, 3))
_jdecode = jax.jit(jlm.decode_step, static_argnums=(1,))


def _carry(jparams):
    return params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")


def _x(shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)) \
        .astype(np.float32)


def _close(got, want, rtol=RTOL, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def _close_tree(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k])


# -- MoE ------------------------------------------------------------------------


def _moe_case(gated=True, **kw):
    jc, tc = smoke_cfgs("moonshot-v1-16b-a3b", mlp_gated=gated, **kw)
    jp = jmoe.init_moe(jax.random.PRNGKey(0), jc)
    return jc, tc, jp, _carry(jp)


def _dropped(tp, x, cfg):
    """Tokens an expert turns away: assignments past its capacity."""
    T = x.shape[0] * x.shape[1]
    probs = torch.softmax(torch.from_numpy(x).reshape(T, -1)
                          @ tp["router"], -1)
    expert = torch.topk(probs, cfg.moe_topk, dim=-1).indices
    cap = max(int(cfg.moe_capacity_factor * T * cfg.moe_topk
                  / cfg.moe_experts), 1)
    counts = torch.bincount(expert.reshape(-1), minlength=cfg.moe_experts)
    return int(torch.clamp(counts - cap, min=0).sum())


@pytest.mark.parametrize("gated", [True, False])
def test_moe_mlp_matches_reference_without_drops(gated):
    jc, tc, jp, tp = _moe_case(gated)
    x = _x((2, 5, tc.d_model))
    assert tc.moe_capacity_factor == 8.0 and _dropped(tp, x, tc) == 0
    _close(moe.moe_mlp(tp, torch.from_numpy(x), tc),
           jmoe.moe_mlp(jp, jnp.asarray(x), jc))


@pytest.mark.parametrize("gated", [True, False])
def test_moe_mlp_matches_reference_with_drops(gated):
    # E=8, K=2, T=8 at factor 1.25: each expert takes 2 of the 16 picks
    jc, tc, jp, tp = _moe_case(gated, moe_experts=8, moe_topk=2,
                               moe_capacity_factor=1.25)
    x = _x((2, 4, tc.d_model), seed=3)
    assert _dropped(tp, x, tc) > 0
    want = jmoe.moe_mlp(jp, jnp.asarray(x), jc)
    got = moe.moe_mlp(tp, torch.from_numpy(x), tc)
    _close(got, want)
    # the drops are real: without them the output differs
    roomy = dataclasses.replace(tc, moe_capacity_factor=8.0)
    assert not np.allclose(moe.moe_mlp(tp, torch.from_numpy(x), roomy),
                           np.asarray(want), rtol=RTOL, atol=ATOL)


def test_moe_mlp_return_aux_matches_reference():
    jc, tc, jp, tp = _moe_case(moe_experts=8, moe_topk=2,
                               moe_capacity_factor=1.25)
    x = _x((2, 4, tc.d_model), seed=3)
    out, aux = moe.moe_mlp(tp, torch.from_numpy(x), tc, return_aux=True)
    jout, jaux = jmoe.moe_mlp(jp, jnp.asarray(x), jc, return_aux=True)
    _close(out, jout)
    _close(aux, jaux)


def test_moe_mlp_rows_of_one_batch_drop_as_the_reference():
    """Identical rows pick the same experts, so at capacity 1 only the
    first keeps them: the fork demo's batch of a parent and its children."""
    jc, tc, jp, tp = _moe_case(moe_experts=8, moe_topk=2,
                               moe_capacity_factor=1.25)
    x = np.repeat(_x((1, 1, tc.d_model), seed=5), 4, axis=0)
    got = moe.moe_mlp(tp, torch.from_numpy(x), tc)
    _close(got, jmoe.moe_mlp(jp, jnp.asarray(x), jc))
    assert float(got[0].abs().max()) > 0
    assert float(got[1:].abs().max()) == 0


# -- Mamba2 ---------------------------------------------------------------------


def _mamba_case():
    jc, tc = smoke_cfgs("zamba2-2.7b")
    spec = tc.groups[0].unit[0]
    assert isinstance(spec, MambaSpec)
    jp = jssm.init_mamba(jax.random.PRNGKey(1), jc, spec)
    return jc, tc, spec, jp, _carry(jp)


@pytest.mark.parametrize("S", [16, 32])
def test_mamba_forward_state_and_decode_match_reference(S):
    """One chunk (S = 16) and two (S = 32, the state carried across)."""
    jc, tc, spec, jp, tp = _mamba_case()
    x = _x((2, S, tc.d_model), seed=S)
    _close(ssm.mamba_forward(tp, torch.from_numpy(x), tc, spec, chunk=16),
           jssm.mamba_forward(jp, jnp.asarray(x), jc, spec, chunk=16))
    out, state = ssm.mamba_forward(tp, torch.from_numpy(x), tc, spec,
                                   chunk=16, return_state=True)
    jout, jstate = jssm.mamba_forward(jp, jnp.asarray(x), jc, spec, chunk=16,
                                      return_state=True)
    _close(out, jout)
    _close_tree(state, jstate)
    assert state["ssd"].dtype == torch.float32
    x1 = _x((2, 1, tc.d_model), seed=S + 1)
    y, new = ssm.mamba_decode(tp, torch.from_numpy(x1), tc, spec, state)
    jy, jnew = jssm.mamba_decode(jp, jnp.asarray(x1), jc, spec, jstate)
    _close(y, jy)
    _close_tree(new, jnew)


def test_mamba_decode_from_an_empty_cache_matches_reference():
    jc, tc, spec, jp, tp = _mamba_case()
    cache = ssm.init_mamba_cache(tc, spec, 2, torch.float32)
    jcache = jssm.init_mamba_cache(jc, spec, 2, jnp.float32)
    _close_tree(cache, jcache)
    x1 = _x((2, 1, tc.d_model), seed=9)
    y, new = ssm.mamba_decode(tp, torch.from_numpy(x1), tc, spec, cache)
    jy, jnew = jssm.mamba_decode(jp, jnp.asarray(x1), jc, spec, jcache)
    _close(y, jy)
    _close_tree(new, jnew)


def test_chunked_scans_refuse_a_length_off_the_chunk_as_the_reference():
    jc, tc, spec, jp, tp = _mamba_case()
    x = _x((1, 24, tc.d_model))
    with pytest.raises(AssertionError):
        jssm.mamba_forward(jp, jnp.asarray(x), jc, spec, chunk=16)
    with pytest.raises(ValueError, match="divisible by chunk"):
        ssm.mamba_forward(tp, torch.from_numpy(x), tc, spec, chunk=16)
    mspec = MLSTMSpec(expand=2, num_heads=2)
    jm = jxl.init_mlstm(jax.random.PRNGKey(2), jc, mspec)
    with pytest.raises(AssertionError):
        jxl.mlstm_forward(jm, jnp.asarray(x), jc, mspec, chunk=16)
    with pytest.raises(ValueError, match="divisible by chunk"):
        xlstm.mlstm_forward(_carry(jm), torch.from_numpy(x), tc, mspec,
                            chunk=16)


def test_softplus_has_no_threshold():
    x = torch.tensor([-30.0, -1.0, 0.0, 1.0, 19.0, 21.0, 40.0])
    _close(ssm.softplus(x), jax.nn.softplus(jnp.asarray(x.numpy())),
           rtol=1e-6, atol=0)


# -- xLSTM ----------------------------------------------------------------------


def _xlstm_case(kind):
    # the smoke config keeps the first 3 blocks of the unit, all mLSTM
    jc, tc = smoke_cfgs("xlstm-1.3b")
    spec = kind(num_heads=2)
    init = jxl.init_mlstm if kind is MLSTMSpec else jxl.init_slstm
    jp = init(jax.random.PRNGKey(3), jc, spec)
    return jc, tc, spec, jp, _carry(jp)


@pytest.mark.parametrize("S", [16, 32])
def test_mlstm_forward_state_and_decode_match_reference(S):
    jc, tc, spec, jp, tp = _xlstm_case(MLSTMSpec)
    x = _x((2, S, tc.d_model), seed=S)
    _close(xlstm.mlstm_forward(tp, torch.from_numpy(x), tc, spec, chunk=16),
           jxl.mlstm_forward(jp, jnp.asarray(x), jc, spec, chunk=16))
    out, state = xlstm.mlstm_forward(tp, torch.from_numpy(x), tc, spec,
                                     chunk=16, return_state=True)
    jout, jstate = jxl.mlstm_forward(jp, jnp.asarray(x), jc, spec, chunk=16,
                                     return_state=True)
    _close(out, jout)
    _close_tree(state, jstate)
    x1 = _x((2, 1, tc.d_model), seed=S + 1)
    y, new = xlstm.mlstm_decode(tp, torch.from_numpy(x1), tc, spec, state)
    jy, jnew = jxl.mlstm_decode(jp, jnp.asarray(x1), jc, spec, jstate)
    _close(y, jy)
    _close_tree(new, jnew)


@pytest.mark.parametrize("S", [1, 12])
def test_slstm_forward_state_and_decode_match_reference(S):
    jc, tc, spec, jp, tp = _xlstm_case(SLSTMSpec)
    x = _x((2, S, tc.d_model), seed=S)
    _close(xlstm.slstm_forward(tp, torch.from_numpy(x), tc, spec),
           jxl.slstm_forward(jp, jnp.asarray(x), jc, spec))
    out, state = xlstm.slstm_forward(tp, torch.from_numpy(x), tc, spec,
                                     return_state=True)
    jout, jstate = jxl.slstm_forward(jp, jnp.asarray(x), jc, spec,
                                     return_state=True)
    _close(out, jout)
    _close_tree(state, jstate)
    x1 = _x((2, 1, tc.d_model), seed=S + 1)
    y, new = xlstm.slstm_decode(tp, torch.from_numpy(x1), tc, spec, state)
    jy, jnew = jxl.slstm_decode(jp, jnp.asarray(x1), jc, spec, jstate)
    _close(y, jy)
    _close_tree(new, jnew)


def test_xlstm_caches_match_reference():
    jc, tc = smoke_cfgs("xlstm-1.3b")
    for spec, init, jinit in (
            (MLSTMSpec(expand=2, num_heads=2), xlstm.init_mlstm_cache,
             jxl.init_mlstm_cache),
            (SLSTMSpec(num_heads=2), xlstm.init_slstm_cache,
             jxl.init_slstm_cache)):
        got = init(tc, spec, 3, torch.float32)
        want = jinit(jc, spec, 3, jnp.float32)
        _close_tree(got, want)
        for k in want:
            assert str(got[k].dtype) == "torch." + str(want[k].dtype)


# -- whole models ---------------------------------------------------------------


@pytest.fixture(scope="module", params=FAMILIES + KINDS)
def family(request):
    jc, tc = _cfgs(request.param)
    jparams = jlm.init_params(jax.random.PRNGKey(1), jc)
    return request.param, jc, tc, jparams, _carry(jparams)


def test_prefill_and_decode_match_reference(family):
    """B=2, a 20-token prompt, then decode to 24 (tests/test_models.py's
    shapes), feeding the same tokens to both."""
    name, jc, tc, jparams, tparams = family
    B, S, P = 2, 24, 20
    toks = np.random.default_rng(7).integers(0, tc.vocab_size, (B, S)) \
        .astype(np.int32)
    jlog, jcache = _jprefill(jparams, jc, jnp.asarray(toks[:, :P]), S)
    tlog, tcache = lm.prefill(tparams, tc, torch.from_numpy(toks[:, :P]), S)
    _close(tlog, jlog, rtol=0, atol=LOGIT_ATOL)
    for t in range(P, S):
        pos = np.full((B,), t, np.int32)
        jlog, jcache = _jdecode(jparams, jc, jcache, jnp.asarray(toks[:, t]),
                                jnp.asarray(pos))
        tlog, tcache = lm.decode_step(tparams, tc, tcache,
                                      torch.from_numpy(toks[:, t]),
                                      torch.from_numpy(pos))
        _close(tlog, jlog, rtol=0, atol=LOGIT_ATOL)
    # the caches keep the reference's structure, shapes and dtypes
    jleaves = jax.tree_util.tree_leaves_with_path(jcache)
    tleaves = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda t: t.numpy(), tcache))
    assert [(p, x.shape, str(x.dtype)) for p, x in tleaves] == \
        [(p, x.shape, str(x.dtype)) for p, x in jleaves]


def test_init_cache_matches_reference(family):
    name, jc, tc, _, _ = family
    want = jlm.init_cache(jc, 2, 24, jnp.float32)
    got = lm.init_cache(tc, 2, 24, "float32", device="cpu")
    jleaves = jax.tree_util.tree_leaves_with_path(want)
    tleaves = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda t: t.numpy(), got))
    assert [(p, x.shape, str(x.dtype)) for p, x in tleaves] == \
        [(p, x.shape, str(x.dtype)) for p, x in jleaves]


def test_init_params_matches_reference_tree(family):
    """Same names, shapes and dtypes; shared blocks hold one set."""
    name, jc, tc, jparams, _ = family
    tparams = lm.init_params(tc, torch.Generator().manual_seed(0), "cpu")
    got = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda t: t.numpy(), tparams))
    want = jax.tree_util.tree_leaves_with_path(jparams)
    assert [(p, x.shape, str(x.dtype)) for p, x in got] == \
        [(p, x.shape, str(x.dtype)) for p, x in want]


# -- parameter counts -----------------------------------------------------------


@pytest.mark.parametrize("name", FAMILIES + KINDS)
def test_param_counts_equal_the_allocation(name):
    cfg = _cfgs(name)[1]
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), "meta")
    n = sum(t.numel() for t in jax.tree.leaves(
        params, is_leaf=lambda x: isinstance(x, torch.Tensor)))
    assert n == flops.param_counts(cfg)[0]


@pytest.mark.parametrize("name", FAMILIES + ["gemma3-1b", "micro-hello"])
def test_param_counts_match_reference(name):
    assert flops.param_counts(get_arch(name)) == \
        jflops.param_counts(jget_arch(name))
