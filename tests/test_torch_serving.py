"""Serving (part 2 of the slice): the port's paged engine and model against
the reference's, with the reference's weights carried across.  Greedy
tokens must be equal and logits within atol 1e-4 (fp32, CPU summation
order); copy-on-write forks keep the same refcounts and frame counts."""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import get_arch as jget_arch  # noqa: E402
from repro.configs.base import reduce_for_smoke as jreduce  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serving.engine import ServingEngine as JEngine  # noqa: E402

from repro_torch.configs.base import get_arch, reduce_for_smoke  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.serving.kv_cache import PagedKV  # noqa: E402

ATOL = 1e-4

# the reference model, compiled once per config and shape
_jprefill = jax.jit(jlm.prefill, static_argnums=(1, 3))
_jdecode = jax.jit(jlm.decode_step, static_argnums=(1,))


def _cfgs(name):
    """(reference cfg, port cfg) for an arch name or '<name>-smoke'."""
    base = name[:-len("-smoke")] if name.endswith("-smoke") else name
    jc, tc = jget_arch(base), get_arch(base)
    if base != name:
        jc, tc = jreduce(jc), reduce_for_smoke(tc)
    jc = dataclasses.replace(jc, compute_dtype="float32")
    tc = dataclasses.replace(tc, compute_dtype="float32")
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    return jc, tc


@pytest.fixture(scope="module", params=["micro-hello", "gemma3-1b-smoke"])
def model(request):
    jc, tc = _cfgs(request.param)
    jparams = jlm.init_params(jax.random.PRNGKey(0), jc)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return request.param, jc, tc, jparams, tparams


def _jax_greedy(jc, jparams, prompt, n, cache_len):
    toks = jnp.asarray(prompt, jnp.int32)[None]
    logits, caches = _jprefill(jparams, jc, toks, cache_len)
    out, all_logits = [int(jnp.argmax(logits[0]))], [np.asarray(logits[0])]
    for t in range(n - 1):
        pos = jnp.asarray([len(prompt) + t], jnp.int32)
        logits, caches = _jdecode(
            jparams, jc, caches, jnp.asarray([out[-1]], jnp.int32), pos)
        out.append(int(jnp.argmax(logits[0])))
        all_logits.append(np.asarray(logits[0]))
    return out, all_logits


def _torch_greedy(tc, tparams, prompt, n, cache_len):
    toks = torch.tensor(prompt, dtype=torch.int32)[None]
    logits, caches = lm.prefill(tparams, tc, toks, cache_len)
    out, all_logits = [int(torch.argmax(logits[0]))], [logits[0].numpy()]
    for t in range(n - 1):
        pos = torch.tensor([len(prompt) + t], dtype=torch.int32)
        logits, caches = lm.decode_step(
            tparams, tc, caches, torch.tensor([out[-1]], dtype=torch.int32),
            pos)
        out.append(int(torch.argmax(logits[0])))
        all_logits.append(logits[0].numpy())
    return out, all_logits


def _case(name):
    # gemma's smoke window is 32: prompt + decode run past it, so the
    # paged kernel's window start (starts > 0) is exercised
    if name.startswith("gemma"):
        return list(np.random.default_rng(3).integers(0, 256, 20)), 20, 8
    return [5, 9, 2, 77, 31], 6, 4


def test_model_matches_reference(model):
    name, jc, tc, jparams, tparams = model
    prompt, n, _ = _case(name)
    jtoks, jlogits = _jax_greedy(jc, jparams, prompt, n, 64)
    ttoks, tlogits = _torch_greedy(tc, tparams, prompt, n, 64)
    assert ttoks == jtoks
    for a, b in zip(tlogits, jlogits):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=0)


def test_engine_matches_reference_engine_and_model(model):
    name, jc, tc, jparams, tparams = model
    prompt, n, page_tokens = _case(name)
    want, want_logits = _jax_greedy(jc, jparams, prompt, n, 64)
    jeng = JEngine(jc, jparams, page_tokens=page_tokens, backend="ref")
    jrid = jeng.submit(prompt, max_tokens=n)
    assert jeng.run_to_completion()[jrid] == want
    dispatch.reset_meters()      # earlier calls in this process stay out
    eng = ServingEngine(tc, tparams, page_tokens=page_tokens, device="cpu",
                        keep_logits=True)
    rid = eng.submit(prompt, max_tokens=n)
    assert eng.run_to_completion()[rid] == want
    got_logits = eng.requests[rid].logits
    assert len(got_logits) == n
    for a, b in zip(got_logits, want_logits):
        np.testing.assert_allclose(a.numpy(), b, atol=ATOL, rtol=0)
    assert eng.meter["kernel.paged_attention.torch"] == tc.num_layers * (n - 1)
    assert eng.kv.pool.num_allocated() == 0        # finished seqs freed


def test_engine_continuous_batching_matches_reference(model):
    name, jc, tc, jparams, tparams = model
    prompts = [[1, 2, 3], [9, 8, 7, 6], [42]]
    eng = ServingEngine(tc, tparams, page_tokens=4, device="cpu")
    rids = [eng.submit(p, max_tokens=4) for p in prompts]
    res = eng.run_to_completion()
    for r, p in zip(rids, prompts):
        assert res[r] == _jax_greedy(jc, jparams, p, 4, 64)[0]


def test_fork_request_matches_reference(model):
    name, jc, tc, jparams, tparams = model
    prompt = [3, 1, 4, 1, 5]
    runs = []
    for Eng, params, kw in ((JEngine, jparams, {"backend": "ref"}),
                            (ServingEngine, tparams, {"device": "cpu"})):
        eng = Eng(jc if Eng is JEngine else tc, params, page_tokens=4, **kw)
        r0 = eng.submit(prompt, max_tokens=8)
        eng.step()
        eng.step()
        b0 = eng.kv.bytes_in_use()
        free0 = eng.kv.pool.num_allocated()
        kids = [eng.fork_request(r0, max_tokens=6) for _ in range(2)]
        assert eng.kv.bytes_in_use() == b0      # COW: no page copied at fork
        refs = dict(eng.kv.refcount)
        eng.requests[kids[1]].prompt[-1] = 123  # diverge one child
        res = eng.run_to_completion()
        runs.append((res[r0], [res[k] for k in kids], refs, free0,
                     eng.kv.pool.num_allocated()))
    assert runs[0] == runs[1]


def test_paged_kv_refcount_free():
    kv = PagedKV(2, 2, 16, page_tokens=4, dtype=torch.float32, device="cpu")
    s0 = kv.new_seq()
    k = torch.ones((2, 6, 2, 16))
    kv.write_prefill(s0, k, k)
    used0 = kv.pool.num_allocated(torch.float32)
    s1 = kv.fork_sequence(s0)
    kv.free_seq(s0)
    assert kv.pool.num_allocated(torch.float32) == used0  # child holds pages
    kv.free_seq(s1)
    assert kv.pool.num_allocated(torch.float32) == 0


def test_cow_write_after_fork_isolates():
    kv = PagedKV(1, 1, 8, page_tokens=4, dtype=torch.float32, device="cpu")
    s0 = kv.new_seq()
    # 3 tokens: the first page column is only partially filled
    kv.write_prefill(s0, torch.ones((1, 3, 1, 8)), torch.ones((1, 3, 1, 8)))
    s1 = kv.fork_sequence(s0)
    # child appends into the shared partial column -> COW
    kv.append_token(s1, torch.full((1, 1, 8), 9.0), torch.full((1, 1, 8), 9.0))
    f = kv.frames_view()
    parent_page = kv.seqs[s0].k_pages[0, 0]
    child_page = kv.seqs[s1].k_pages[0, 0]
    assert parent_page != child_page
    assert torch.equal(f[parent_page, :3], torch.ones((3, 1, 8)))
    assert torch.equal(f[child_page, 3], torch.full((1, 8), 9.0))
    assert f.data_ptr() == kv.pool.frames_array("float32").data_ptr()


def test_unported_block_families_raise():
    from repro_torch.configs.base import (ArchConfig, GroupSpec, MambaSpec)
    cfg = ArchConfig(name="x", family="ssm", d_model=16, num_heads=2,
                     num_kv_heads=2, head_dim=8, d_ff=0, vocab_size=32,
                     groups=(GroupSpec(unit=(MambaSpec(),), repeat=1),))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")


def test_serve_entry_point_runs_on_cpu(capsys):
    from repro_torch.launch import serve
    st = serve.main(["--arch", "micro-hello", "--requests", "2",
                     "--fork-demo", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[serve] req1 ->" in out and "fork-demo parent=" in out
    assert len(st.children) == 2
    assert st.net.meter["kernel.cow_scatter.torch"] > 0
    for eng, rid in st.results:
        assert len(eng.requests[rid].out_tokens) == 8


def test_sampling_greedy_and_seeded_temperature():
    from repro_torch.serving.sampling import sample
    logits = torch.tensor([[0.0, 3.0, 1.0, 3.0], [5.0, -1.0, 0.0, 4.0]])
    assert sample(logits).tolist() == [1, 0]          # first max wins
    draws = [sample(logits, torch.Generator().manual_seed(7),
                    temperature=0.7, top_k=2).tolist() for _ in range(2)]
    assert draws[0] == draws[1]                      # seeded: reproducible
    many = sample(logits.repeat(200, 1), torch.Generator().manual_seed(1),
                  temperature=1.0, top_k=2)
    assert set(many[0::2].tolist()) <= {1, 3}        # outside top-k: never
    assert set(many[1::2].tolist()) <= {0, 3}
