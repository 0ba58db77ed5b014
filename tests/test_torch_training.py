"""The port's training substrate against the reference: chunked attention,
remat, microbatches and bf16 accumulation, AdamW and its schedule, the
data stream, checkpoints both ways, ``paging.from_pages``, the training
driver, the five configs that came with it and ``core/lean.py``.

Inputs come from numpy seeds and the reference's weights are carried
across (``models/convert.py``).  Tolerances, fp32 on the CPU unless said:
attention layers within rtol 1e-5 / atol 1e-5 (einsum and softmax
summation order, as the whole models' hidden states); whole-step losses within 1e-5 relative and gnorms
within 1e-4 relative, as ``torch_train_parity`` holds them; AdamW on
identical inputs within rtol 1e-6 (float32 pow and sqrt); schedules,
data, checkpoint bits, pages and configs exactly equal."""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402
import os  # noqa: E402
import time  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import get_arch as jget_arch  # noqa: E402
from repro.core.lean import LeanExecutorPool as JPool  # noqa: E402
from repro.memory import paging as jpaging  # noqa: E402
from repro.models import flops as jflops  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.training import checkpoint as jckpt  # noqa: E402
from repro.training import data as jdata  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training.schedule import warmup_cosine as jwarmup  # noqa: E402
from repro.training.train_step import TrainConfig as JTrainConfig  # noqa: E402
from repro.training.train_step import make_train_step as jmake_step  # noqa: E402

from repro_torch.configs.base import get_arch  # noqa: E402
from repro_torch.core.descriptor import flatten_with_names  # noqa: E402
from repro_torch.core.lean import LeanExecutorPool  # noqa: E402
from repro_torch.memory import paging  # noqa: E402
from repro_torch.models import flops, lm  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.convert import (opt_state_from_numpy,  # noqa: E402
                                        params_from_numpy)
from repro_torch.training import checkpoint as ckpt  # noqa: E402
from repro_torch.training import data  # noqa: E402
from repro_torch.training import optimizer as opt  # noqa: E402
from repro_torch.training.schedule import warmup_cosine  # noqa: E402
from repro_torch.training.train_step import (  # noqa: E402
    TrainConfig, make_serve_decode, make_serve_prefill, make_train_step)

from torch_parity import bits, smoke_cfgs  # noqa: E402

NEW_CONFIGS = ["stablelm-3b", "granite-34b", "qwen2-7b", "musicgen-large",
               "chameleon-34b"]


def _host(tree):
    return jax.tree.map(np.asarray, tree)


def _carry(jtree):
    return params_from_numpy(_host(jtree), "cpu")


def _x(shape, seed, scale=1.0):
    return np.asarray(scale * np.random.default_rng(seed).standard_normal(
        shape), np.float32)


def _toks(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


# -- chunked attention ----------------------------------------------------------


def _attn_case(arch, S, seed):
    jc, tc = smoke_cfgs(arch, kinds=True)
    spec = tc.groups[0].unit[0]
    jp = jL.init_attention(jax.random.PRNGKey(seed), jc, spec)
    x = _x((2, S, jc.d_model), seed)
    pos = np.arange(S)[None, :]
    return jc, tc, spec, jp, _carry(jp), x, pos


_jattn = jax.jit(jL.attention_train, static_argnums=(2, 3, 5, 6))


def _port_attn(tc, spec, tp, x, pos, **kw):
    with torch.no_grad():
        return L.attention_train(tp, torch.from_numpy(x), spec, tc,
                                 torch.from_numpy(pos), **kw).numpy()


@pytest.mark.parametrize("exact", [False, True],
                         ids=["causal_chunked", "causal_unrolled"])
def test_global_attention_chunks_match_reference(exact):
    """A global layer (qwen2: qkv bias) past its q_chunk: 4 chunks of 16."""
    jc, tc, spec, jp, tp, x, pos = _attn_case("qwen2-7b", 64, 0)
    assert spec.window is None and spec.qkv_bias
    want = _jattn(jp, x, spec, jc, pos, 16, exact)
    got = _port_attn(tc, spec, tp, x, pos, q_chunk=16,
                     exact_causal_slices=exact)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


def test_window_attention_chunks_match_reference():
    """A window layer (gemma: window 32) in chunks of 24: the band is padded
    to w = 48 keys, not a multiple of the window; the chunked result also
    equals the one-pass masked attention."""
    jc, tc, spec, jp, tp, x, pos = _attn_case("gemma3-1b", 72, 1)
    assert spec.window == 32
    want = _jattn(jp, x, spec, jc, pos, 24, False)
    got = _port_attn(tc, spec, tp, x, pos, q_chunk=24)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)
    whole = _port_attn(tc, spec, tp, x, pos, q_chunk=72)
    np.testing.assert_allclose(got, whole, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ["qwen2-7b", "gemma3-1b"])
def test_chunked_attention_refuses_a_ragged_sequence(arch):
    """S not a multiple of q_chunk: the reference's reshape fails, and the
    port raises rather than pad."""
    _, tc, spec, _, tp, x, pos = _attn_case(arch, 40, 2)
    with pytest.raises(ValueError, match="multiple of q_chunk"):
        _port_attn(tc, spec, tp, x, pos, q_chunk=16)


def _port_model(arch, seed, **kw):
    """The port's smoke config of ``arch`` and its own seeded params (for
    tests of the port alone)."""
    tc = smoke_cfgs(arch, **kw)[1]
    return tc, lm.init_params(tc, torch.Generator().manual_seed(seed), "cpu")


def test_exact_causal_matches_chunked():
    """The reference's test on the port: qwen2 at smoke size, 4 chunks,
    within the reference's rtol 1e-4 / atol 1e-5."""
    tc, tp = _port_model("qwen2-7b", 3)
    toks = torch.from_numpy(_toks(tc, 2, 64, 3))
    with torch.no_grad():
        h1 = lm.forward(tp, tc, toks, q_chunk=16, exact_causal=False)
        h2 = lm.forward(tp, tc, toks, q_chunk=16, exact_causal=True)
    np.testing.assert_allclose(h1.numpy(), h2.numpy(), rtol=1e-4, atol=1e-5)


def test_window_attention_masks_history():
    """One window layer (gemma's, window 32) in chunks of 16: a change to
    token 0 reaches position 1 and no position from 32 on, bit for bit."""
    tc, _ = _port_model("gemma3-1b", 4)
    g = tc.groups[0]
    tc = dataclasses.replace(tc, groups=(dataclasses.replace(
        g, unit=g.unit[:1], repeat=1),))
    assert tc.groups[0].unit[0].window == 32
    tp = lm.init_params(tc, torch.Generator().manual_seed(4), "cpu")
    toks = torch.from_numpy(_toks(tc, 1, 64, 4))
    toks2 = toks.clone()
    toks2[0, 0] = (toks[0, 0] + 1) % tc.vocab_size
    with torch.no_grad():
        h1, h2 = (lm.logits_fn(tp, tc, t, q_chunk=16) for t in (toks, toks2))
    assert float((h1[0, 1] - h2[0, 1]).abs().max()) > 0
    assert torch.equal(h1[0, 32:], h2[0, 32:])


# -- remat, microbatches, bf16 accumulation --------------------------------------


def _loss_and_grads(tp, tc, toks, remat):
    _, _, leaves = flatten_with_names(tp)
    for t in leaves:
        t.grad = None
        t.requires_grad_(True)
    loss = lm.loss_fn(tp, tc, toks, toks, q_chunk=16, remat=remat,
                      xent_chunk=32)
    grads = torch.autograd.grad(loss, leaves)
    for t in leaves:
        t.requires_grad_(False)
    return loss.detach(), grads


def test_remat_policies_agree():
    """none, full and dots give the same loss and gradients, bit for bit on
    the CPU (recomputation repeats the same ops), through the chunked
    window and global paths of gemma cut to one layer of each kind."""
    tc, tp = _port_model("gemma3-1b", 5, kinds=True)
    toks = torch.from_numpy(_toks(tc, 2, 64, 5))
    out = {r: _loss_and_grads(tp, tc, toks, r) for r in ("none", "full",
                                                         "dots")}
    for r in ("full", "dots"):
        assert torch.equal(out[r][0], out["none"][0]), r
        for a, b in zip(out[r][1], out["none"][1]):
            assert torch.equal(a, b), r


def test_dots_policy_saves_weight_products_only():
    mm, bmm = torch.ops.aten.mm.default, torch.ops.aten.bmm.default
    save = torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE
    pol = lm._save_weight_products
    assert pol(None, mm, torch.zeros(4, 3), torch.zeros(3, 2)) == save
    assert pol(None, bmm, torch.zeros(1, 4, 3), torch.zeros(1, 3, 2)) == save
    assert pol(None, bmm, torch.zeros(8, 4, 3), torch.zeros(8, 3, 2)) != save
    with pytest.raises(ValueError):
        lm._remat(lambda h: h, "most")


@pytest.fixture(scope="module")
def stablelm():
    jc, tc = smoke_cfgs("stablelm-3b")
    jp = jlm.init_params(jax.random.PRNGKey(2), jc)
    return jc, tc, jp, _host(jp), _toks(jc, 4, 32, 2)


def _step_both(stablelm, **kw):
    jc, tc, jp, hp, toks = stablelm
    kw = dict(q_chunk=32, xent_chunk=32, warmup=0, peak_lr=1e-2, **kw)
    _, _, jm = jax.jit(jmake_step(jc, JTrainConfig(**kw)))(
        jp, jopt.init_opt_state(jp), toks, toks)
    tp = params_from_numpy(hp, "cpu")
    t = torch.from_numpy(toks)
    tp2, _, tm = make_train_step(tc, TrainConfig(**kw))(
        tp, opt.init_opt_state(tp), t, t)
    return ({k: float(v) for k, v in jm.items()},
            {k: float(v) for k, v in tm.items()}, tp2)


def test_microbatch_accum_equivalence(stablelm):
    """mb=2 against mb=1 on the port (the reference's test and
    tolerances), and mb=2 against the reference's mb=2."""
    jm, tm, tp2 = _step_both(stablelm, microbatches=2)
    _, tm1, tp1 = _step_both(stablelm, microbatches=1)
    assert abs(tm["loss"] - jm["loss"]) <= 1e-5 * jm["loss"]
    assert abs(tm["gnorm"] - jm["gnorm"]) <= 1e-4 * jm["gnorm"]
    assert abs(tm1["loss"] - tm["loss"]) < 1e-4
    for a, b in zip(flatten_with_names(tp1)[2], flatten_with_names(tp2)[2]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-3,
                                   atol=1e-4)


def test_bf16_grad_accumulation_matches_reference(stablelm):
    """grad_dtype bfloat16 with two microbatches: each microbatch's
    gradient rounded to bf16, summed and halved in bf16, as the
    reference does.  The loss is fp32 (1e-5 relative); the gnorm of the
    bf16 sums within 1e-3 relative (a gradient a float32 ulp apart can
    round to neighbouring bf16 values, 2^-8 apart)."""
    jm, tm, tp2 = _step_both(stablelm, microbatches=2,
                             grad_dtype="bfloat16")
    assert abs(tm["loss"] - jm["loss"]) <= 1e-5 * jm["loss"]
    assert abs(tm["gnorm"] - jm["gnorm"]) <= 1e-3 * jm["gnorm"]
    assert all(torch.isfinite(t).all() for t in flatten_with_names(tp2)[2])


# -- optimizer and schedule ---------------------------------------------------------


def _opt_inputs(dtype):
    """params, grads and a state three steps in: a clip is due (gnorm ~ 60)."""
    shapes = {"a": (7, 5), "b": {"c": (11,), "d": (3, 4, 2)}}
    names, paths, leaves = flatten_with_names(shapes)
    p = {"a": _x((7, 5), 0), "b": {"c": _x((11,), 1), "d": _x((3, 4, 2), 2)}}
    g = jax.tree.map(lambda a: 5 * _x(a.shape, 3 + a.size), p)
    m = jax.tree.map(lambda a: 0.1 * _x(a.shape, 4 + a.size), p)
    v = jax.tree.map(lambda a: np.abs(_x(a.shape, 5 + a.size)), p)
    cast = lambda t: jax.tree.map(lambda a: jnp.asarray(a, dtype), t)
    return cast(p), cast(g), {"m": cast(m), "v": cast(v),
                              "count": jnp.asarray(3, jnp.int32)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_matches_reference(dtype):
    """One clipped update on identical inputs: fp32 within rtol 1e-6; bf16
    params and state (the update is fp32, rounded to bf16 once) within one
    bf16 step of 2^-7 relative."""
    jp, jg, js = _opt_inputs(dtype)
    cfg = jopt.AdamWConfig(weight_decay=0.1, clip_norm=1.0)
    wp, ws, wn = jopt.adamw_update(jp, jg, js, 1e-3, cfg)
    tp, tg = _carry(jp), _carry(jg)
    ts = opt_state_from_numpy(_host(js), "cpu")
    gp, gs, gn = opt.adamw_update(tp, tg, ts, 1e-3, opt.AdamWConfig(
        weight_decay=0.1, clip_norm=1.0))
    assert gp is tp and gs["m"] is ts["m"]          # updated in place
    assert float(wn) > 1 and abs(float(gn) - float(wn)) <= 1e-6 * float(wn)
    assert int(gs["count"]) == int(ws["count"]) == 4
    assert gs["count"].dtype == torch.int32
    rtol = 1e-6 if dtype == "float32" else 2 ** -7
    for got, want in ((gp, wp), (gs["m"], ws["m"]), (gs["v"], ws["v"])):
        for a, b in zip(flatten_with_names(got)[2],
                        flatten_with_names(_host(want))[2]):
            assert a.dtype == getattr(torch, dtype)
            np.testing.assert_allclose(a.float().numpy(),
                                       np.asarray(b, np.float32), rtol=rtol,
                                       atol=1e-7)


def test_global_norm_and_init_opt_state():
    jp, jg, _ = _opt_inputs("float32")
    tg = _carry(jg)
    assert abs(float(opt.global_norm(tg)) - float(jopt.global_norm(jg))) \
        <= 1e-6 * float(jopt.global_norm(jg))
    st = opt.init_opt_state(tg)
    assert st["count"].dtype == torch.int32 and int(st["count"]) == 0
    assert all(not t.any() for t in flatten_with_names(st["m"])[2])


def test_adamw_decreases_quadratic():
    params = {"w": torch.tensor([5.0, -3.0])}
    state = opt.init_opt_state(params)
    cfg = opt.AdamWConfig(weight_decay=0.0)
    for _ in range(200):
        params, state, _ = opt.adamw_update(params, {"w": 2 * params["w"]},
                                            state, 0.1, cfg)
    assert float(params["w"].abs().max()) < 0.05


def test_grad_clip_bounds_update():
    params = {"w": torch.zeros(3)}
    p2, _, gn = opt.adamw_update(params, {"w": torch.full((3,), 1e6)},
                                 opt.init_opt_state(params), 1e-3,
                                 opt.AdamWConfig(clip_norm=1.0,
                                                 weight_decay=0.0))
    assert float(gn) > 1e5 and float(p2["w"].abs().max()) < 1e-2


@pytest.mark.parametrize("step", [0, 3, 10, 55, 100, 150])
def test_warmup_cosine_matches_reference(step):
    """Python and int32-tensor steps, before, at and after the warmup and
    past the total: equal float32 values."""
    kw = dict(peak_lr=3e-4, warmup=10, total=100)
    want = np.float32(jwarmup(step, **kw))
    got = warmup_cosine(step, **kw)
    assert got.dtype == torch.float32 and got.numpy() == want
    want_t = np.float32(jwarmup(jnp.asarray(step, jnp.int32), **kw))
    got_t = warmup_cosine(torch.tensor(step, dtype=torch.int32), **kw)
    assert got_t.numpy() == want_t


def test_schedule_shape():
    assert float(warmup_cosine(0, peak_lr=1.0, warmup=10, total=100)) == 0.0
    assert abs(float(warmup_cosine(10, peak_lr=1.0, warmup=10,
                                   total=100)) - 1.0) < 1e-6
    assert float(warmup_cosine(100, peak_lr=1.0, warmup=10, total=100)) < 0.11


# -- data ------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(vocab_size=1000, batch=8, seq_len=64, seed=3),
    dict(vocab_size=1000, batch=8, seq_len=64, seed=3, num_hosts=2,
         host_id=1),
    dict(vocab_size=2048, batch=2, seq_len=16, seed=7, codebooks=4)],
    ids=["one-host", "host-1-of-2", "codebooks"])
def test_token_stream_matches_reference(kw):
    mine, ref = data.TokenStream(**kw), jdata.TokenStream(**kw)
    for s in (0, 1, 5, 63, 64):
        for a, b in zip(mine.batch_at(s), ref.batch_at(s)):
            assert a.dtype == b.dtype == np.int32
            np.testing.assert_array_equal(a, b)


def test_prefetcher_matches_reference_stream():
    s = data.TokenStream(500, 4, 32, seed=1)
    ref = jdata.TokenStream(500, 4, 32, seed=1)
    pf = data.Prefetcher(s, start_step=2)
    try:
        for i in range(2, 5):
            tok, lab = pf.next()
            want_tok, want_lab = ref.batch_at(i)
            np.testing.assert_array_equal(tok, want_tok)
            np.testing.assert_array_equal(lab, want_lab)
    finally:
        pf.close()
    assert not pf._t.is_alive()


# -- checkpoints ------------------------------------------------------------------


@pytest.fixture(scope="module")
def ckpt_trees():
    """The reference's stablelm smoke params with two leaves in bf16, its
    AdamW state (count 7), and the same trees in the port."""
    jc, _ = smoke_cfgs("stablelm-3b")
    jp = jlm.init_params(jax.random.PRNGKey(0), jc)
    jp["final_norm"]["scale"] = jp["final_norm"]["scale"].astype(jnp.bfloat16)
    jp["embed"]["out"] = (jp["embed"]["out"] + 0.5).astype(jnp.bfloat16)
    jo = jopt.init_opt_state(jp)
    jo["count"] = jnp.asarray(7, jnp.int32)
    jo["m"] = jax.tree.map(lambda a: a + 1, jo["m"])
    tp, to = _carry(jp), opt_state_from_numpy(_host(jo), "cpu")
    return jp, jo, tp, to


def _same_bits(got, want):
    gn, _, gl = flatten_with_names(got)
    wn, _, wl = flatten_with_names(want)
    assert gn == wn
    for a, b in zip(gl, wl):
        np.testing.assert_array_equal(bits(a), bits(b))


def test_checkpoint_roundtrip_and_keep(tmp_path, ckpt_trees):
    _, _, tp, to = ckpt_trees
    for step in (10, 20, 30, 40):
        ckpt.save_checkpoint(str(tmp_path), step, tp, to, keep=2,
                             extra={"loss": 1.5})
    assert ckpt.latest_step(str(tmp_path)) == 40
    assert sorted(os.listdir(tmp_path)) == ["step-00000030", "step-00000040"]
    step, p2, o2, extra = ckpt.load_checkpoint(str(tmp_path), device="cpu")
    assert step == 40 and extra == {"loss": 1.5}
    _same_bits(p2, tp)
    _same_bits(o2, to)
    assert p2["final_norm"]["scale"].dtype == torch.bfloat16
    assert o2["count"].dtype == torch.int32
    t = ckpt.save_checkpoint(str(tmp_path), 50, tp, to, keep=2,
                             async_save=True)
    t.join(timeout=60)
    assert not t.is_alive() and ckpt.latest_step(str(tmp_path)) == 50


def test_checkpoints_interoperate_both_ways(tmp_path, ckpt_trees,
                                            monkeypatch):
    """The reference reads the port's checkpoint and the port the
    reference's, fp32, bf16 and int32 leaves bit for bit; the manifests
    are the same bytes, and so are every non-bf16 leaf's files."""
    jp, jo, tp, to = ckpt_trees
    monkeypatch.setattr(time, "time", lambda: 1234.5)
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    jckpt.save_checkpoint(ref_dir, 3, jp, jo, extra={"loss": 2.25})
    ckpt.save_checkpoint(port_dir, 3, tp, to, extra={"loss": 2.25})
    sub = "step-00000003"
    files = sorted(os.listdir(os.path.join(ref_dir, sub)))
    assert files == sorted(os.listdir(os.path.join(port_dir, sub)))
    read = lambda d, f: open(os.path.join(d, sub, f), "rb").read()
    assert read(ref_dir, "manifest.msgpack") == read(port_dir,
                                                     "manifest.msgpack")
    manifest = ckpt.unpackb(read(port_dir, "manifest.msgpack"))
    bf16 = {f"{name}.{i}.npy" for name in ("params", "opt")
            for i, dt in enumerate(manifest[name]["dtypes"])
            if dt == "bfloat16"}
    assert len(bf16) == 6        # two params, their m and v
    for f in files:
        if f not in bf16:
            assert read(ref_dir, f) == read(port_dir, f), f

    _, p, o, _ = ckpt.load_checkpoint(ref_dir, device="cpu")   # port reads
    _same_bits(p, tp)
    _same_bits(o, to)
    assert p["embed"]["out"].dtype == torch.bfloat16
    _, rp, ro, extra = jckpt.load_checkpoint(port_dir)        # ref reads
    _, wp, wo, _ = jckpt.load_checkpoint(ref_dir)
    assert extra == {"loss": 2.25}
    for got, want in ((rp, wp), (ro, wo)):
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_array_equal(
                np.asarray(a).reshape(-1).view(np.uint8),
                np.asarray(b).reshape(-1).view(np.uint8))


def test_restart_continues_identically(tmp_path):
    """The reference's test on the port: 4 steps, against 2 steps, a
    checkpoint, a restore and 2 more; on the CPU the two runs are equal."""
    jc, tc = smoke_cfgs("stablelm-3b")
    step_fn = make_train_step(tc, TrainConfig(
        microbatches=1, q_chunk=32, xent_chunk=32, warmup=0, peak_lr=1e-3))
    stream = data.TokenStream(tc.vocab_size, 4, 32, seed=0)
    hp = _host(jlm.init_params(jax.random.PRNGKey(0), jc))

    def run(params, state, lo, hi):
        for s in range(lo, hi):
            tok, lab = (torch.from_numpy(a) for a in stream.batch_at(s))
            params, state, m = step_fn(params, state, tok, lab)
        return params, state, float(m["loss"])

    pa = params_from_numpy(hp, "cpu")
    pa, oa, loss_a = run(pa, opt.init_opt_state(pa), 0, 4)
    pb = params_from_numpy(hp, "cpu")
    pb, ob, _ = run(pb, opt.init_opt_state(pb), 0, 2)
    ckpt.save_checkpoint(str(tmp_path), 2, pb, ob)
    _, pb, ob, _ = ckpt.load_checkpoint(str(tmp_path), device="cpu")
    pb, ob, loss_b = run(pb, ob, 2, 4)
    assert abs(loss_a - loss_b) < 1e-5
    for a, b in zip(flatten_with_names(pa)[2], flatten_with_names(pb)[2]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)
    assert int(ob["count"]) == 4


# -- pages, the driver, configs, the executor pool -----------------------------------


@pytest.mark.parametrize("shape,page_elems,dtype", [
    ((3, 5, 7), 16, "float32"), ((64,), 64, "float32"), ((), 8, "float32"),
    ((9, 13), 32, "bfloat16")])
def test_from_pages_matches_reference(shape, page_elems, dtype):
    a = _x(shape, 6)
    want = np.asarray(jpaging.from_pages(
        jpaging.to_pages(jnp.asarray(a, dtype), page_elems), shape, dtype))
    t = torch.from_numpy(a).to(getattr(torch, dtype))
    got = paging.from_pages(paging.to_pages(t, page_elems), shape, dtype)
    assert got.dtype == t.dtype and tuple(got.shape) == shape
    np.testing.assert_array_equal(bits(got), bits(want))
    host = paging.from_pages(paging.to_pages(bits(t), page_elems), shape,
                             dtype)
    np.testing.assert_array_equal(host, bits(want))
    with pytest.raises(TypeError):
        paging.from_pages(np.zeros((1, 8), np.float32), (8,), "bfloat16")


def test_loss_decreases_end_to_end():
    from repro_torch.launch.train import main as train_main
    losses = train_main(["--arch", "micro-hello", "--steps", "40",
                         "--batch", "4", "--seq", "64", "--log-every", "40",
                         "--warmup", "2", "--lr", "1e-3", "--device", "cpu"])
    assert len(losses) == 40 and losses[-1] < losses[0] - 0.05


def test_serve_entry_points_are_prefill_and_decode():
    """make_serve_prefill / make_serve_decode give lm.prefill's and
    lm.decode_step's results."""
    tc, tp = _port_model("qwen2-7b", 6)
    toks = torch.from_numpy(_toks(tc, 2, 8, 6))
    with torch.no_grad():
        logits, caches = make_serve_prefill(tc, 16)(tp, toks)
        want, want_caches = lm.prefill(tp, tc, toks, 16)
        assert torch.equal(logits, want)
        pos = torch.full((2,), 8, dtype=torch.int32)
        got, _ = make_serve_decode(tc)(tp, caches, toks[:, 0], pos)
        assert torch.equal(got, lm.decode_step(tp, tc, want_caches,
                                               toks[:, 0], pos)[0])


@pytest.mark.parametrize("arch", NEW_CONFIGS)
def test_new_configs_match_reference(arch):
    tc, jc = get_arch(arch), jget_arch(arch)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert flops.param_counts(tc) == jflops.param_counts(jc)


def test_lean_executor_pool_counts_hits_misses_and_build_time():
    for pool in (LeanExecutorPool(), JPool()):
        built = []

        def builder():
            built.append(1)
            time.sleep(0.01)
            return lambda x: x + 1

        f = pool.get(("micro-hello", "decode", (1,)), builder)
        assert f(1) == 2 and pool.get(("micro-hello", "decode", (1,)),
                                      builder) is f
        pool.prewarm(("micro-hello", "prefill", (6,)), builder)
        assert (pool.hits, pool.misses, len(built)) == (1, 2, 2)
        assert pool.build_time >= 0.02
        pool.clear()
        pool.get(("micro-hello", "decode", (1,)), builder)
        assert pool.misses == 3


def test_chip_smoke_train_phase_rehearses_on_the_cpu():
    """The card script's train phase, checks and all, at smoke size on the
    CPU: the driver's losses fall, the step equals itself on two CPU
    copies, the forked training state and step 3 are bit-equal, and the
    checkpoint restart continues identically."""
    from torch_parity import load_chip_smoke
    smoke = load_chip_smoke()
    out = smoke.train_phase(torch, torch.device("cpu"), smoke=True)
    assert len(out["a"]["losses"]) == 4
    assert out["b"]["loss_rel_err"] == 0 and out["b"]["params_far_share"] == 0
    assert out["c"]["step3_params_bit_equal"] and out["c"]["pages_rdma"] > 0
    assert out["d"]["max_loss_diff"] == 0 and out["d"]["checkpoint_bytes"] > 0
