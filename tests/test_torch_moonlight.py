"""The port's Moonlight-16B-A3B block (latent attention over a paged latent
cache, sigmoid-routed experts with shared experts, a leading dense layer)
against the plain reference ``tests/reference_moonlight.py``, at small
widths on the CPU, on seeded random weights; and the block tail it shares
with the GQA blocks, those held to the JAX package's."""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jL
from repro.models import lm as jlm
from repro.models import moe as jMOE

from repro_torch.configs.base import (GroupSpec, MLASpec, MoESpec,
                                      get_arch)
from repro_torch.distributed import ctx
from repro_torch.kernels import dispatch
from repro_torch.kernels.paged_attention.latent import latent_attention
from repro_torch.models import lm
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.kv_cache import PagedKV

import reference_moonlight as R
from torch_parity import smoke_cfgs

SEEDS = (3, 2 ** 31 + 5)
ATTN = MLASpec(kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
               v_head_dim=16)
SPARSE = dataclasses.replace(ATTN, moe=MoESpec(routed_scale=2.446,
                                               shared_d_ff=2 * 24))
# the reference's sizes (tests/reference_moonlight.py)
M = {"num_heads": 4, "kv_lora_rank": 32, "qk_nope_head_dim": 16,
     "qk_rope_head_dim": 8, "v_head_dim": 16, "moe_topk": 3,
     "routed_scale": 2.446, "rope_theta": 50000.0, "norm_eps": 1e-5}
TOL = dict(atol=2e-5, rtol=1e-5)   # fp32, sums in another order


def tiny_cfg(moe_layers: int = 2):
    """Moonlight's block at small widths: a dense layer, then expert
    layers of 8 experts, top 3, capacity factor 11.0."""
    return dataclasses.replace(
        get_arch("moonlight-16b-a3b"), name="moonlight-tiny", d_model=64,
        num_heads=4, num_kv_heads=4, head_dim=16, d_ff=96, vocab_size=256,
        groups=(GroupSpec(unit=(ATTN,), repeat=1),
                GroupSpec(unit=(SPARSE,), repeat=moe_layers)),
        moe_experts=8, moe_topk=3, moe_d_ff=24, compute_dtype="float32")


def params_of(cfg, seed):
    return lm.init_params(cfg, torch.Generator().manual_seed(seed), "cpu")


def tokens(seed, n):
    g = torch.Generator().manual_seed(seed % 1000)
    return torch.randint(0, 256, (n,), generator=g).tolist()


def layer(params, gi, r=0):
    return R.leaf(params["groups"][gi]["blocks"][0], r)


@pytest.mark.parametrize("seed", SEEDS)
def test_train_forward_logits_match_the_reference(seed):
    cfg = tiny_cfg()
    p = params_of(cfg, seed)
    toks = tokens(seed, 24)
    got = lm.logits_fn(p, cfg, torch.tensor([toks]), q_chunk=8)[0]
    torch.testing.assert_close(got, R.forward(p, M, toks), **TOL)


@pytest.mark.parametrize("seed", SEEDS)
def test_prefill_then_paged_decode_match_the_reference(seed):
    """The engine's prefill writes the latent rows into a latent PagedKV
    (no V pages) and each decode step attends over them; every served
    row against the reference's full forward at its position, and the
    dense-cache path (``lm.prefill``, ``lm.decode_step``) the same."""
    cfg = tiny_cfg()
    p = params_of(cfg, seed)
    prompt = tokens(seed, 13)
    eng = ServingEngine(cfg, p, page_tokens=4, device="cpu",
                        keep_logits=True)
    assert eng.latent and eng.kv.latent and eng.kv.hd == ATTN.latent_dim
    rid = eng.submit(prompt, max_tokens=7)
    served = eng.run_to_completion()[rid]
    want = R.forward(p, M, prompt + served[:-1])[len(prompt) - 1:]
    torch.testing.assert_close(torch.stack(eng.requests[rid].logits), want,
                               **TOL)
    logits, caches = lm.prefill(p, cfg, torch.tensor([prompt]), 24)
    rows = [logits[0]]
    for i, t in enumerate(served[:-1]):
        logits, caches = lm.decode_step(p, cfg, caches, torch.tensor([t]),
                                        torch.tensor([len(prompt) + i]))
        rows.append(logits[0])
    torch.testing.assert_close(torch.stack(rows), want, **TOL)


def test_a_latent_cache_holds_rows_and_no_values():
    kv = PagedKV(2, 1, 40, page_tokens=4, dtype=torch.float32, device="cpu",
                 latent=True)
    s0 = kv.new_seq()
    rows = torch.randn(2, 6, 1, 40)
    kv.write_prefill(s0, rows, None)
    seq = kv.seqs[s0]
    assert seq.v_pages is None and seq.k_pages.shape == (2, 2)
    s1 = kv.fork_sequence(s0)
    kv.ensure_writable_slot(s1)                   # COW of the shared page
    assert kv.seqs[s1].k_pages[0, 1] != seq.k_pages[0, 1]
    frames = kv.frames_view()
    torch.testing.assert_close(
        frames[torch.from_numpy(kv.seqs[s1].k_pages[1])].reshape(8, 40)[:6],
        rows[1, :, 0])
    k_pt, v_pt, lens = kv.batch_tables([s0, s1])
    assert v_pt is None and k_pt.shape == (2, 2, 2) and list(lens) == [6, 6]
    with pytest.raises(ValueError):
        PagedKV(2, 2, 40, device="cpu", latent=True)


@pytest.mark.parametrize("seed", SEEDS)
def test_absorbed_decode_matches_expanded_attention(seed):
    """One layer: the absorbed query against the cached rows and the
    un-absorbed output (``mla_decode`` over a dense latent cache) against
    the reference's expanded attention at the last position."""
    cfg = tiny_cfg()
    a = layer(params_of(cfg, seed), 1)["attn"]
    g = torch.Generator().manual_seed(seed % 1000)
    T = 11
    x = torch.randn(1, T, 64, generator=g)
    pos = torch.arange(T)
    _, cache = MLA.mla_prefill(a, x[:, :-1], SPARSE, cfg, pos[None, :-1], 16)
    y, _ = MLA.mla_decode(a, x[:, -1:], SPARSE, cfg, cache,
                          torch.tensor([T - 1]))
    want = R.attention(a, x[0], pos, M)[-1]
    torch.testing.assert_close(y[0, 0], want, **TOL)


@pytest.mark.parametrize("seed", SEEDS)
def test_the_latent_kernels_plain_version_matches_the_reference(seed):
    """Three sequences of 9, 1 and 14 tokens in permuted pages of 4 slots:
    the plain version of the latent kernel, fed the absorbed queries of
    each one's last token, against the reference's expanded attention of
    each head; a sequence of no token gets zeros."""
    cfg = tiny_cfg()
    a = layer(params_of(cfg, seed), 1)["attn"]
    g = torch.Generator().manual_seed(seed % 1000)
    lens, Tp, P = [9, 1, 14], 4, 4
    pool = torch.zeros(16, Tp, ATTN.latent_dim)
    perm = torch.randperm(16, generator=g).to(torch.int32)
    pt = perm[:3 * P].reshape(3, P)
    qs, want = [], []
    for b, n in enumerate(lens):
        x = torch.randn(1, n, 64, generator=g)
        pos = torch.arange(n)
        rows = MLA.latent_rows(a, x, ATTN, cfg, pos[None])[0]
        for t in range(n):
            pool[pt[b, t // Tp], t % Tp] = rows[t]
        q, _ = MLA.absorb(a, x[:, -1:], ATTN, cfg, pos[-1:])
        qs.append(q[0])
        want.append(R.attention_heads(a, x[0], pos, M)[-1])
    o = latent_attention(torch.stack(qs), pool, pt, torch.tensor(lens),
                         dv=ATTN.kv_lora_rank, scale=MLA.scale_of(ATTN),
                         backend="torch")
    w_uv = a["wkv_b"][..., ATTN.qk_nope_head_dim:]
    got = torch.einsum("bhc,chv->bhv", o, w_uv)
    torch.testing.assert_close(got, torch.stack(want), **TOL)
    empty = latent_attention(torch.stack(qs), pool, pt, torch.tensor(
        [0, 1, 0]), dv=ATTN.kv_lora_rank, scale=1.0, backend="torch")
    assert not empty[0].any() and not empty[2].any() and empty[1].any()


@pytest.mark.parametrize("seed", SEEDS)
def test_the_router_and_the_shared_experts(seed):
    """Sigmoid scores, the top k of score plus bias chosen, the chosen
    scores (not biased) renormalised and scaled by 2.446, the shared MLP
    added; a bias that forces an expert moves the choice and not the
    gate."""
    cfg = tiny_cfg()
    p = layer(params_of(cfg, seed), 1)["moe"]
    g = torch.Generator().manual_seed(seed % 1000)
    x = torch.randn(1, 17, 64, generator=g)
    got = MOE.moe_mlp(p, x, cfg, moe=SPARSE.moe)[0]
    torch.testing.assert_close(got, R.moe(p, x[0], M), **TOL)
    idx, gate = R.route(p, x[0], M)
    torch.testing.assert_close(gate.sum(-1), torch.full((17,), 2.446))
    forced = dict(p, router_bias=p["router_bias"].clone())
    forced["router_bias"][5] = 10.0
    f_idx, f_gate = R.route(forced, x[0], M)
    assert (f_idx == 5).any(-1).all() and not (idx == 5).any(-1).all()
    s = torch.sigmoid(x[0] @ p["router"])
    chosen = s.gather(1, f_idx)
    torch.testing.assert_close(f_gate, chosen / chosen.sum(-1, keepdim=True)
                               * 2.446)
    torch.testing.assert_close(MOE.moe_mlp(forced, x, cfg, moe=SPARSE.moe)[0],
                               R.moe(forced, x[0], M), **TOL)
    shared = R.mlp(p["shared"], x[0])
    torch.testing.assert_close(
        MOE.moe_mlp(p, x, cfg, moe=SPARSE.moe)[0] - shared,
        R.moe(p, x[0], M) - shared, **TOL)


def test_no_token_is_dropped_at_capacity_factor_11():
    """Moonlight's 64 experts, top 6, at factor 11.0: every expert can take
    every token of a call of 1 to 130 tokens (64/6 could not: it drops one
    at 7), and a call where every token picks one expert loses none."""
    cfg = get_arch("moonlight-16b-a3b")
    E, K, f = cfg.moe_experts, cfg.moe_topk, cfg.moe_capacity_factor
    assert all(int(f * T * K / E) >= T for T in range(1, 131))
    assert int(64 / 6 * 7 * K / E) < 7
    small = tiny_cfg()
    p = layer(params_of(small, 7), 1)["moe"]
    p = dict(p, router_bias=p["router_bias"].clone())
    p["router_bias"][2] = 100.0                   # every token takes expert 2
    for T in (1, 7, 64, 130):
        x = torch.randn(1, T, 64, generator=torch.Generator().manual_seed(T))
        torch.testing.assert_close(MOE.moe_mlp(p, x, small, moe=SPARSE.moe)[0],
                                   R.moe(p, x[0], M), **TOL)


@pytest.mark.parametrize("seed", SEEDS)
def test_the_leading_layer_is_dense(seed):
    cfg = tiny_cfg()
    p = params_of(cfg, seed)
    b0, b1 = layer(p, 0), layer(p, 1)
    assert "mlp" in b0 and "moe" not in b0 and "moe" in b1
    assert b0["mlp"]["wi"].shape == (64, 96)
    g = torch.Generator().manual_seed(seed % 1000)
    h = torch.randn(1, 5, 64, generator=g)
    want = R.mlp(b0["mlp"], R.rms_norm(h[0], b0["norm2"]["scale"], 1e-5))
    torch.testing.assert_close(lm.block_mlp(b0, h, cfg, ATTN)[0],
                               h[0] + want, **TOL)


def _gqa_block(arch, h, pos):
    """A GQA block of ``arch`` at smoke size, the JAX package's weights
    carried across: (port config, spec, params, the reference's block
    output on ``h`` at ``pos``, the reference's tail on ``h``)."""
    jc, tc = smoke_cfgs(arch)
    spec = tc.groups[0].unit[0]
    jp = jlm.init_block(jax.random.PRNGKey(5), jc, jc.groups[0].unit[0])
    jh = jnp.asarray(h.numpy())
    block, _ = jlm.apply_block(jp, jh, jc, jc.groups[0].unit[0],
                               mode="train", positions=jnp.asarray(pos))
    hn2 = jL.rms_norm(jh, jp["norm2"]["scale"], jc.norm_eps)
    tail = jh + (jMOE.moe_mlp(jp["moe"], hn2, jc) if "moe" in jp
                 else jL.mlp(jp["mlp"], hn2, jc.mlp_gated))
    return (tc, spec, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"),
            torch.tensor(np.asarray(block)),
            torch.tensor(np.asarray(tail)))


def _mla_block(moe_layer, h, pos):
    """Block 0 of the tiny Moonlight's dense or expert group: (config,
    spec, params, the plain reference's block output, its tail)."""
    cfg = tiny_cfg()
    b = layer(params_of(cfg, 5), int(moe_layer))
    hn = R.rms_norm(h[0], b["norm1"]["scale"], 1e-5)
    mid = h[0] + R.attention(b["attn"], hn, pos[0], M)

    def tail(x):
        xn = R.rms_norm(x, b["norm2"]["scale"], 1e-5)
        return x + (R.moe(b["moe"], xn, M) if moe_layer
                    else R.mlp(b["mlp"], xn))
    return (cfg, SPARSE if moe_layer else ATTN, b, tail(mid)[None],
            tail(h[0])[None])


@pytest.mark.parametrize("kind", ["gqa-dense", "gqa-moe", "mla-dense",
                                  "mla-moe"])
def test_block_mlp_is_the_reference_blocks_tail(kind):
    """``lm.block_mlp``, the one tail of every attention block (norm2, then
    the MoE or the dense MLP), against the reference's tail, and the whole
    block through ``lm.apply_block`` against the reference's block
    output."""
    h = torch.randn(1, 5, 64, generator=torch.Generator().manual_seed(5))
    pos = torch.arange(5)[None]          # every config here is 64 wide
    if kind.startswith("gqa"):
        cfg, spec, p, block, tail = _gqa_block(
            "moonshot-v1-16b-a3b" if kind == "gqa-moe" else "stablelm-3b",
            h, pos)
    else:
        cfg, spec, p, block, tail = _mla_block(kind == "mla-moe", h, pos)
    assert ("moe" in p) == kind.endswith("moe")
    torch.testing.assert_close(lm.block_mlp(p, h, cfg, spec), tail, **TOL)
    got, _ = lm.apply_block(p, h, cfg, spec, mode="train", positions=pos)
    torch.testing.assert_close(got, block, **TOL)


def test_latent_attention_is_on_the_main_path_of_latent_models_only():
    """The engine's decode counts the latent kernel's plain version for a
    latent model and never for a GQA one."""
    cfg = tiny_cfg(1)
    gqa = dataclasses.replace(get_arch("moonshot-v1-16b-a3b"), d_model=64,
                              num_heads=4, num_kv_heads=2, head_dim=16,
                              vocab_size=256, moe_experts=4, moe_topk=2,
                              moe_d_ff=32, moe_capacity_factor=8.0,
                              groups=(GroupSpec(unit=get_arch(
                                  "moonshot-v1-16b-a3b").groups[0].unit,
                                  repeat=2),), compute_dtype="float32")
    for c, latent in ((cfg, True), (gqa, False)):
        dispatch.reset_meters()
        eng = ServingEngine(c, params_of(c, 1), page_tokens=4, device="cpu")
        eng.submit(tokens(1, 6), max_tokens=3)
        eng.run_to_completion()
        m = dispatch.kernel_meters()
        assert ("kernel.latent_attention.torch" in m) == latent
        assert ("kernel.paged_attention.torch" in m) == (not latent)
    dispatch.reset_meters()


# a mesh of data 2 x model 1 as this rank sees it: coordinate and groups
MESH = types.SimpleNamespace(get_coordinate=lambda: [0, 0],
                             get_group=lambda i: None)


@pytest.mark.parametrize("env, kw", [
    (types.SimpleNamespace(msize=2, dpsize=1, moe_impl="gspmd"), {}),
    (types.SimpleNamespace(msize=1, dpsize=2, moe_impl="gspmd",
                           axes={"data": 2, "model": 1}, dp=("data",),
                           mesh=MESH), {"split_seq": 16}),
], ids=["tensor-or-expert-parallel", "sequence-parallel"])
def test_a_sharded_latent_block_is_refused(env, kw):
    cfg = tiny_cfg(1)
    a = layer(params_of(cfg, 1), 1)["attn"]
    x = torch.randn(1, 4, 64)
    with ctx.use_env(env, **kw):
        with pytest.raises(NotImplementedError):
            MLA.mla_prefill(a, x, ATTN, cfg, torch.arange(4)[None], 16)
        with pytest.raises(NotImplementedError):
            MLA.mla_train(a, x, ATTN, cfg, torch.arange(4)[None])


@pytest.mark.parametrize("seed", SEEDS)
def test_the_benchmarks_reference_equals_the_tests(seed):
    """``forkbench/reference/moonlight.py`` on the benchmark's weights of a
    tiny configuration, against this file's reference on the same
    weights, in fp32."""
    from forkbench import weights as W
    from forkbench.reference.moonlight import Reference
    m = {"arch": "moonlight", "d_model": 64, "num_heads": 4,
         "vocab_size": 256, "num_layers": 3, "dense_layers": 1, "d_ff": 96,
         "kv_lora_rank": 32, "qk_nope_head_dim": 16, "qk_rope_head_dim": 8,
         "v_head_dim": 16, "moe_experts": 8, "moe_topk": 3, "moe_d_ff": 24,
         "moe_shared_d_ff": 48, "moe_routed_scale": 2.446,
         "moe_capacity_factor": 11.0, "tie_embeddings": False,
         "rope_theta": 50000.0, "norm_eps": 1e-5}
    w = W.make(m, seed, "cpu")
    prompt, served = tokens(seed, 15), tokens(seed + 1, 5)
    got = Reference(m, w).logits(prompt, served)
    torch.testing.assert_close(got, R.forward(w, M, prompt + served[:-1]),
                               **TOL)
