"""The ``moonlight`` architecture in the harness, on the CPU at tiny
sizes: a cell of it under the ``warm-long`` mix runs through the program
(latent attention over a latent paged cache, sigmoid-routed experts with
shared experts, a leading dense layer) and is correct against
``forkbench/reference/moonlight.py``; a broken timed path and the TF32
control are not; the real configuration's published keys and counts."""
import json
import time

import pytest
import torch

from forkbench import archs, harness, roofline
from forkbench import weights as W
from forkbench.conftest import BENCH, REAL
from forkbench.test_forkbench_harness import (SEED, _alter_token,
                                              _corrupt_page, _skip_kv_write,
                                              run_cell)

CELL = REAL["moonlight-16b-a3b-5L.warm-long"]


@pytest.mark.parametrize("trace", [0, 1])
def test_a_moonlight_cell_runs_and_is_correct(tiny_root, trace):
    out, rec = harness.run_record(harness.load_cell(tiny_root, CELL), SEED,
                                  0.8, bool(trace), torch.device("cpu"),
                                  time.perf_counter())
    assert out["correct"] is True and out["failed"] == 0, out["checks"]
    assert out["checks"]["fork_mismatch"]["value"] == 0
    got = out["metrics"]
    if not trace:
        assert {"invoke_p50_s", "invoke_p90_s", "setup_s"} <= set(got)
        return
    # the CPU run has no device events: no kernel share to read
    assert "latent_attention_roofline.warm-long" not in got
    # but the bytes the share counts are the program's own count of them
    prof = rec.mix["profile"]
    traced = [v for v in rec.ok
              if prof["first"] <= v.index < prof["first"] + prof["count"]]
    assert traced and sum(
        roofline.attention_bytes(rec.model, v.prompt_len, len(v.tokens))
        for v in traced) == rec.counters["mla.latent_bytes"]
    useful = got["moe_useful_pct.warm-long"]["value"]
    if rec.counters.get("moe.routed_calls", 0) > 0:
        # the routed path computes the routed rows and no others
        assert useful == 100.0
    else:
        # the dense path: 3 of 8 experts, each computing int(11 * T * 3 /
        # 8) >= T rows of a call of T tokens: 9.375% at a decode step,
        # just under in a prefill
        assert 9.0 < useful <= 100 * 3 / (8 * 4)
    assert got["kv_cache_gb"]["value"] > 0


def test_the_readers_of_the_latent_kernel_and_the_cache():
    """The latent roofline reads the bytes the architecture counts from
    each traced request's lengths over the device time of the kernels
    named ``latent_attention`` in its serve span; the cache reading the
    ``kv.page_bytes`` counter per traced invocation."""
    import types
    from forkbench import profiling
    from forkbench.conftest import ROOT
    m = json.loads((BENCH / "configs"
                    / "moonlight-16b-a3b-5L.json").read_text())["model"]
    serve = profiling._sums([(0, 500, "paged_attention_kernel"),
                             (100, 1100, "latent_attention_kernel"),
                             (1100, 2100, "latent_attention_combine"),
                             (2100, 9100, "gemv")], 0, 10_000)
    assert serve["latent_kernels"] == 2e-6
    span = types.SimpleNamespace(name="invoke", parent=-1)
    req = lambda i: types.SimpleNamespace(index=i, prompt_len=1000,
                                          tokens=[5, 6])
    run = types.SimpleNamespace(
        model=m, ok=[req(1), req(2)],
        trace={"invocations": {1: {"serve": serve},
                               2: {"serve": {"latent_kernels": 0.0}}}},
        counters={"kv.page_bytes": 8_000}, spans=[span, span])
    roof = harness.reader(ROOT, "latent_attention_roofline.warm-long")(run)
    need = 5 * 4 * (1001 * 576 + 16 * (576 + 512))
    assert roof == pytest.approx(100.0 * need / roofline.PEAK_BYTES / 2e-6)
    run.trace["invocations"][1] = {"serve": {"attention_kernels": 1e-6}}
    assert harness.reader(ROOT, "latent_attention_roofline.warm-long")(
        run) is None
    assert harness.reader(ROOT, "kv_cache_gb")(run) == 4e-6


@pytest.mark.parametrize("fault", [_alter_token, _skip_kv_write,
                                   _corrupt_page])
def test_a_broken_moonlight_path_is_not_correct(tiny_root, fault,
                                                monkeypatch):
    fault(monkeypatch)
    out = run_cell(tiny_root, CELL)
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


def test_the_tf32_control_of_moonlight_fails_the_limit(tiny_root):
    out = run_cell(tiny_root, CELL, seconds=1.5, control=True)
    assert out["correct"] is True and out["control"]["correct"] is False
    limit = out["checks"]["logit_err_p90"]["limit"]
    assert out["control"]["checks"]["logit_err_p90"]["value"] > limit


def test_the_real_configuration_and_its_counts():
    conf = json.loads((BENCH / "configs"
                       / "moonlight-16b-a3b-5L.json").read_text())
    m = conf["model"]
    mod = archs.load(m)
    assert mod.__name__.endswith(".moonlight")
    mod.check_config(conf)
    for key, bad in (("scoring_func", "softmax"), ("first_k_dense_replace", 3),
                     ("n_shared_experts", 1), ("q_lora_rank", 1536)):
        with pytest.raises(ValueError):
            mod.check_config(dict(conf, **{key: bad}))
    cfg = harness.port_config(conf)
    assert [(g.repeat, g.unit[0].moe is None) for g in cfg.groups] == [
        (1, True), (4, False)]
    assert W.param_count(m) == 3_093_455_616
    assert roofline.state_bytes(m) == 4 * 3_093_455_616
    # a latent row of 576 floats per token and layer
    assert mod.kv_bytes(m, 1) == 5 * 576 * 4
    assert roofline.attention_bytes(m, 1000, 2) == (
        5 * 4 * (1001 * 576 + 16 * (576 + 512)))
