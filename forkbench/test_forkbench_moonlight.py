"""The ``moonlight`` architecture in the harness, on the CPU at tiny
sizes: a cell of it under the ``warm-long`` mix runs through the program
(latent attention over a latent paged cache, sigmoid-routed experts with
shared experts, a leading dense layer) and is correct against
``forkbench/reference/moonlight.py``; a broken timed path and the TF32
control are not; the real configuration's published keys and counts."""
import json

import pytest

from forkbench import archs, harness, roofline
from forkbench import weights as W
from forkbench.conftest import BENCH, tiny_config, tiny_mix
from forkbench.test_forkbench_harness import (_alter_token, _corrupt_page,
                                              _skip_kv_write, run_cell)

CELL = "tiny-moonlight.warm-long"
TINY = {"arch": "moonlight", "d_model": 64, "num_heads": 4,
        "vocab_size": 256, "num_layers": 3, "dense_layers": 1, "d_ff": 96,
        "kv_lora_rank": 32, "qk_nope_head_dim": 16, "qk_rope_head_dim": 8,
        "v_head_dim": 16, "moe_experts": 8, "moe_topk": 3, "moe_d_ff": 24,
        "moe_shared_d_ff": 48, "moe_routed_scale": 2.446,
        "moe_capacity_factor": 11.0, "tie_embeddings": False,
        "rope_theta": 50000.0, "norm_eps": 1e-5}
# what the cell reports here beyond the benchmark's own entries: the
# latency and the two per-layer readings of the moonlight cell
LISTED = ("invoke_p50_s", "invoke_p90_s")
LAYER = ({"name": "latent_attention_roofline.warm-long", "unit": "%",
          "better": "higher", "source": "device_trace", "layer": "kernels",
          "moves": "invoke_p90_s"},
         {"name": "moe_useful_pct.warm-long", "unit": "%",
          "better": "higher", "source": "program_counter",
          "layer": "serving", "moves": "invoke_p90_s"})


@pytest.fixture
def moon_root(tiny_root):
    b = tiny_root / BENCH.name
    conf = dict(tiny_config("tiny-moonlight", False), model=dict(TINY))
    conf["port"] = {"arch": "moonlight-16b-a3b", "name": "tiny-moonlight"}
    (b / "configs" / "tiny-moonlight.json").write_text(json.dumps(conf))
    (b / "traffic" / "warm-long.json").write_text(
        json.dumps(tiny_mix("warm-long")))
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-moonlight", "source": "tiny",
                             "file": "forkbench/configs/tiny-moonlight.json",
                             "reduced": [], "why": "a CPU test"})
    bench["workloads"].append({"name": CELL, "config": "tiny-moonlight",
                               "traffic": "warm-long", "chips": 1,
                               "why": "a CPU test"})
    for m in bench["end_to_end"]:
        if m["name"] in LISTED:
            m["workloads"].append(CELL)
    bench["per_layer"] += [dict(m, workloads=[CELL]) for m in LAYER]
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    return tiny_root


@pytest.mark.parametrize("trace", [0, 1])
def test_a_moonlight_cell_runs_and_is_correct(moon_root, trace):
    out = run_cell(moon_root, CELL, bool(trace), seconds=0.8)
    assert out["correct"] is True and out["failed"] == 0, out["checks"]
    assert out["checks"]["fork_mismatch"]["value"] == 0
    got = out["metrics"]
    if not trace:
        assert {"invoke_p50_s", "invoke_p90_s", "setup_s"} <= set(got)
        return
    # the CPU run has no device events: no kernel share to read
    assert "latent_attention_roofline.warm-long" not in got
    useful = got["moe_useful_pct.warm-long"]["value"]
    # 3 of 8 experts; each computes int(11 * T * 3 / 8) >= T rows of a
    # call of T tokens: 9.375% at a decode step, just under in a prefill
    assert 9.0 < useful <= 100 * 3 / (8 * 4)
    assert got["kv_cache_gb"]["value"] > 0


def test_the_readers_of_the_latent_kernel_and_the_cache():
    """The latent roofline reads the ``mla.latent_bytes`` counter over the
    device time of the kernels named ``latent_attention`` in the profiled
    sub-window; the cache reading the ``kv.page_bytes`` counter per traced
    invocation."""
    import types
    from forkbench.conftest import ROOT
    span = types.SimpleNamespace(name="invoke", parent=-1)
    run = types.SimpleNamespace(
        counters={"mla.latent_bytes": int(3.35e6), "kv.page_bytes": 8_000},
        device_events=[(100, 1100, "latent_attention_kernel"),
                       (1100, 2100, "latent_attention_combine"),
                       (2100, 9100, "gemv"), (9_000_000, 9_001_000,
                                              "latent_attention_kernel")],
        profiled=(0, 10_000), spans=[span, span])
    roof = harness.reader(ROOT, "latent_attention_roofline.warm-long")(run)
    assert roof == pytest.approx(100.0 * 1e-6 / 2e-6)
    assert harness.reader(ROOT, "kv_cache_gb")(run) == 4e-6


@pytest.mark.parametrize("fault", [_alter_token, _skip_kv_write,
                                   _corrupt_page])
def test_a_broken_moonlight_path_is_not_correct(moon_root, fault,
                                                monkeypatch):
    fault(monkeypatch)
    out = run_cell(moon_root, CELL)
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


def test_the_tf32_control_of_moonlight_fails_the_limit(moon_root):
    out = run_cell(moon_root, CELL, seconds=1.5, control=True)
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
