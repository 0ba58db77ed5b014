"""The paged decode step's one body (serving/graph.py, the engine's
``_decode_batch``) on the CPU: the rope table built once and bit-equal to
the numpy-built one; tokens and logits on tiny dense-GQA, MoE and latent
configs across a page-column boundary, a fork with its copy-on-write and a
batch of two, against the reference engine's tokens and the non-paged
model's logits; and the accounting of a captured step, with the capture
stood in by the body: a whole serve's counts equal the eager engine's."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import lm as jlm  # noqa: E402
from repro.serving.engine import ServingEngine as JEngine  # noqa: E402

from repro_torch import tracing  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serving import graph  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402

import test_torch_moonlight as ML  # noqa: E402
from torch_parity import load_chip_smoke, smoke_cfgs  # noqa: E402

TP = 4                   # page tokens
ATOL = 1e-4              # fp32, the non-paged model sums in another order
ARCHS = ["micro-hello", "moonshot-v1-16b-a3b", "latent"]


@pytest.fixture(autouse=True)
def tracer_off():
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


@pytest.fixture
def routed_on_the_cpu():
    """The expert layers on the routed path, as the card's are, through the
    grouped kernel's plain version."""
    with MOE.routed_on("cpu"):
        yield


def _model(arch):
    """(port cfg, port params, the reference's (cfg, params) or None)."""
    if arch == "latent":
        cfg = ML.tiny_cfg()
        return cfg, ML.params_of(cfg, 3), None
    jc, tc = smoke_cfgs(arch)
    jparams = jlm.init_params(jax.random.PRNGKey(1), jc)
    return tc, params_from_numpy(jax.tree.map(np.asarray, jparams),
                                 "cpu"), (jc, jparams)


def _scenario(eng):
    """(a) a prompt of 2 Tp - 1 tokens, so the first step fills a column's
    last slot and the next opens a column; (b) two requests of different
    final widths decoding as a batch of two; (c) a request forked after
    two steps at 7 tokens, mid-column, so its first write copies the
    shared page, then parent and child as a batch of two.  Returns every
    request's record."""
    rng = np.random.default_rng(5)
    prompt = lambda n: [int(t) for t in rng.integers(0, 256, n)]
    ra = eng.submit(prompt(2 * TP - 1), max_tokens=5)
    eng.run_to_completion()
    eng.submit(prompt(3), max_tokens=4)
    eng.submit(prompt(9), max_tokens=6)
    eng.run_to_completion()
    r0 = eng.submit(prompt(5), max_tokens=6)
    eng.step()
    eng.step()
    assert eng.kv.seqs[eng.requests[r0].seq_id].length % TP
    kid = eng.fork_request(r0, max_tokens=4)
    cow = eng.kv.pool.num_allocated()
    eng.step()                          # the child's copy-on-write
    assert eng.kv.pool.num_allocated() > cow
    eng.run_to_completion()
    assert ra in eng.requests and kid in eng.requests
    return [eng.requests[r] for r in sorted(eng.requests)]


def _want(cfg, params, req):
    """The non-paged model's logits at each position ``req`` served."""
    seq = req.prompt + req.out_tokens[:-1]
    if cfg.name.startswith("moonlight"):
        rows = ML.R.forward(params, ML.M, seq)
    else:
        rows = lm.logits_fn(params, cfg, torch.tensor([seq]))[0]
    return rows[len(req.prompt) - 1:]


def test_rope_table_is_built_once_and_bit_equal():
    theta, hd = 12345.0, 16
    x = torch.randn(2, 5, 3, hd, generator=torch.Generator().manual_seed(0))
    pos = torch.arange(5)[None].expand(2, 5)
    before = L.rope_table.cache_info()
    got = L.apply_rope(x, pos, theta)
    built = L.rope_table.cache_info()
    again = L.apply_rope(x, pos + 1, theta)
    after = L.rope_table.cache_info()
    assert built.misses == before.misses + 1
    assert after.misses == built.misses and after.hits == built.hits + 1
    # the numpy-built table of every call before the cache, inline
    freqs = torch.from_numpy(L.rope_freqs(hd, theta).astype(np.float32))
    for p, y in ((pos, got), (pos + 1, again)):
        ang = p[..., None].float() * freqs
        cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
        x1, x2 = torch.chunk(x, 2, dim=-1)
        want = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
        assert torch.equal(y, want)
    meta = L.apply_rope(x.to("meta"), pos.to("meta"), theta)
    assert meta.device.type == "meta" and meta.shape == x.shape
    assert L.rope_table(hd, theta, torch.device("meta")).device.type == "meta"
    assert L.rope_table.cache_info().misses == after.misses + 1


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_serves_what_the_model_and_the_reference_engine_do(
        arch, routed_on_the_cpu):
    """The expert layers on the routed path, which the card serves."""
    cfg, params, ref = _model(arch)
    eng = ServingEngine(cfg, params, page_tokens=TP, device="cpu",
                        keep_logits=True)
    tracing.enable()
    reqs = _scenario(eng)
    tracing.disable()
    counts = tracing.snapshot()["counters"]
    if cfg.moe_experts:
        assert counts["moe.routed_calls"] > 0
        assert counts["moe.expert_rows"] == counts["moe.routed_rows"]
    assert len(reqs) == 5 and eng.kv.pool.num_allocated() == 0
    tol = ML.TOL if ref is None else dict(atol=ATOL, rtol=0)
    for r in reqs:
        want = _want(cfg, params, r)
        torch.testing.assert_close(torch.stack(r.logits), want, **tol)
        assert r.out_tokens == want.argmax(-1).tolist()
    if ref is not None:
        jeng = JEngine(*ref, page_tokens=TP, backend="ref")
        assert [r.out_tokens for r in _scenario(jeng)] == \
            [r.out_tokens for r in reqs]


def _stand_in(body, device):
    """What a capture gives, on the CPU: the body's outputs, and a replay
    that runs the body again, its counts dropped, into those outputs."""
    out = body()

    def replay():
        with graph.held():
            fresh = body()
        for o, f in zip(out, fresh):
            o.copy_(f)
    return replay, out


def _counted_serve(cfg, params, monkeypatch, captured: bool):
    """The scenario with the tracer on and every count reset; the plain
    attention counted as a launch with its route, as the kernel's wrapper
    does on the card."""
    real = L.paged_attention

    def attention(*a, **kw):
        dispatch.count_launch("paged_attention", route="tma")
        return real(*a, **kw)
    with monkeypatch.context() as m:
        m.setattr(L, "paged_attention", attention)
        if captured:
            m.setattr(graph, "captures", lambda device: True)
            m.setattr(graph, "cuda_capture", _stand_in)
        for c in dispatch.counters():
            c.clear()
        tracing.reset()
        tracing.enable()
        eng = ServingEngine(cfg, params, page_tokens=TP, device="cpu",
                            keep_logits=True)
        reqs = _scenario(eng)
        tracing.disable()
    snap = tracing.snapshot()
    return (reqs, dict(snap["counters"]), [s.name for s in snap["spans"]],
            [dict(c) for c in dispatch.counters()])


@pytest.mark.parametrize("arch", ARCHS)
def test_a_replay_counts_what_an_eager_step_counts(arch, monkeypatch,
                                                 routed_on_the_cpu):
    """Each replay adds the capture pass's counts (``moe.*``, the launches
    and routes, the backend meter), so a serve's counts equal the eager
    engine's; ``serve.graph_replays`` counts every decode step and
    ``serve.graph_captures`` every ``serve.capture``, one per key.  The
    expert layers take the routed path here, as on the card."""
    cfg, params, _ = _model(arch)
    eager, counts, spans, kernel = _counted_serve(cfg, params, monkeypatch,
                                                  False)
    got, gcounts, gspans, gkernel = _counted_serve(cfg, params, monkeypatch,
                                                   True)
    assert [r.out_tokens for r in got] == [r.out_tokens for r in eager]
    for a, b in zip(got, eager):
        assert all(torch.equal(x, y) for x, y in zip(a.logits, b.logits))
    steps = spans.count("serve.decode")
    assert gspans.count("serve.decode") == steps
    assert gcounts.pop("serve.graph_replays") == steps
    captures = gcounts.pop("serve.graph_captures")
    assert captures == gspans.count("serve.capture")
    assert 3 <= captures < steps
    assert "serve.capture" not in spans
    assert gcounts == counts and gkernel == kernel
    if arch == "latent":
        assert counts["mla.latent_bytes"] > 0 and counts["moe.shared_rows"] > 0
    else:
        assert kernel[1]["paged_attention"] == cfg.num_layers * steps
        assert kernel[3]["paged_attention.tma"] == cfg.num_layers * steps
    if cfg.moe_experts:
        assert counts["moe.routed_rows"] > 0
        assert counts["moe.expert_rows"] >= counts["moe.routed_rows"]
        assert gcounts["moe.routed_calls"] == counts["moe.routed_calls"] > 0


def test_one_capture_per_request_and_a_replay_per_step(monkeypatch):
    """A lone request keeps one key from its first step to its last."""
    cfg, params, _ = _model("micro-hello")
    monkeypatch.setattr(graph, "captures", lambda device: True)
    monkeypatch.setattr(graph, "cuda_capture", _stand_in)
    tracing.enable()
    eng = ServingEngine(cfg, params, page_tokens=TP, device="cpu")
    eng.submit(list(range(1, 2 * TP)), max_tokens=9)     # three columns
    eng.run_to_completion()
    tracing.disable()
    counters = tracing.snapshot()["counters"]
    assert counters["serve.graph_captures"] == 1
    assert counters["serve.graph_replays"] == 8      # the prefill's one
    assert eng._inputs.W == -(-(2 * TP - 1 + 9) // TP)


def test_chip_smoke_decode_graph_phase_rehearses_on_the_cpu(
        monkeypatch, routed_on_the_cpu):
    """The card script's decode-graph phase, checks and all, on the CPU with
    the capture stood in by the body (its profiled trace is the card's),
    the expert layers on the routed path as the card's are."""
    monkeypatch.setattr(graph, "captures", lambda device: True)
    monkeypatch.setattr(graph, "cuda_capture", _stand_in)
    out = load_chip_smoke().decode_graph_phase(torch, torch.device("cpu"))
    assert set(out) == {"gqa", "moe", "latent"}
    for row in out.values():
        assert [(r["captures"], r["replays"]) for r in row["requests"]] == \
            [(1, 8), (1, 8)]
        assert row["demo"]["captures"] >= 2 and "profiled" not in row
