"""The port's dry-run tools (``distributed/{roofline,op_analysis,
inspect_cell}.py``, ``launch/dryrun.py``, the loops of ``models/scan.py``)
against the reference's (``distributed/{roofline,hlo_analysis}.py``).

Each test that sets up a fake process group destroys it again
(``dryrun.fake_group``), so that no default group is left behind for the
next test in the same process.  The dry run's collectives and FLOPs
against a real gloo run of the same step are in
``test_torch_tensor_parallel.py`` (its spawn measures them).
"""
import concurrent.futures
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.distributed import comm, op_analysis  # noqa: E402
from repro_torch.distributed import roofline as troof  # noqa: E402
from repro_torch.distributed.ctx import tp_of  # noqa: E402
from repro_torch.distributed.sharding import make_axis_env  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models.scan import scan  # noqa: E402

ARCHS = dryrun.ARCHS
# the one-device smoke step of the FLOP parity test: every loop over
# chunks of 256 has 2 trips, so XLA keeps the reference's scans as loops
B, S, MB, CHUNK = 8, 512, 2, 256


def test_roofline_terms_equal_the_reference_with_its_constants():
    """Each term times its constant is the reference's term times its own:
    the same formulas, other constants."""
    from repro.distributed import roofline as jroof
    for args in [(3.2e17, 7.1e14, 2.2e12, 256), (1e15, 5e16, 0.0, 512)]:
        t, j = troof.roofline(*args), jroof.roofline(*args)
        assert t.compute_s * troof.PEAK_FLOPS == pytest.approx(
            j.compute_s * jroof.PEAK_FLOPS, rel=1e-12)
        assert t.memory_s * troof.HBM_BW == pytest.approx(
            j.memory_s * jroof.HBM_BW, rel=1e-12)
        assert t.collective_s * troof.LINK_BW == pytest.approx(
            j.collective_s * jroof.LINK_BW, rel=1e-12)
        assert t.to_dict().keys() == j.to_dict().keys()
        mf = args[0] / 3
        assert t.fraction_of_roofline(mf) * t.step_time_lb \
            * troof.PEAK_FLOPS == pytest.approx(
                j.fraction_of_roofline(mf) * j.step_time_lb
                * jroof.PEAK_FLOPS, rel=1e-12)
    assert 0.98 * 80 * 1024**3 < troof.HBM_PER_CHIP <= 80 * 1024**3


def _handcrafted():
    """``tests/test_hlo_analysis.py``'s module as a port program: six trips
    of an all-gather over 4 ranks of an [8,32] part, an [8,32]x[32,32]
    matmul and an all-reduce over 2 ranks, one rank of a fake world of 8
    on meta tensors (the loop runs three trips for six)."""
    with dryrun.fake_group(8):
        env = make_axis_env(dryrun.mesh_of({"data": 2, "model": 4}))
        tp = tp_of(env)

        def body(i, x):
            y = x @ comm.gather_model(x, tp, 0)
            return comm.all_reduce_sum(y, env.mesh, dims=[0]), None

        x = torch.empty(8, 32, device="meta")
        return op_analysis.analyze(lambda: scan(body, x, 6))


def test_handcrafted_analysis_gives_the_reference_tests_numbers():
    out = _handcrafted()
    assert out["dot_flops"] == 6 * 2 * 8 * 32 * 32
    coll = out["collectives"]
    assert coll["all-gather"] == 6 * 32 * 32 * 4
    assert coll["all-reduce"] == 6 * 8 * 32 * 4
    assert coll["all-gather_ops"] == 6
    total = op_analysis.total_collective_bytes(coll)
    assert total == 6 * 32 * 32 * 4 + 2 * 6 * 8 * 32 * 4
    assert out["port_collectives"] == {
        "tp_all_gather": {"calls": 6, "bytes": 6 * 32 * 32 * 4},
        "all_reduce": {"calls": 6, "bytes": 6 * 8 * 32 * 4}}
    assert not torch.distributed.is_initialized()


def test_nested_loops_multiply():
    """A loop of 5 trips in one of 4, as ``test_nested_loop_multiplier``."""
    w = torch.empty(4, 4, device="meta")

    def inner(i, x):
        return x @ w, None

    def outer(i, x):
        return scan(inner, x, 5)[0], None

    out = op_analysis.analyze(
        lambda: scan(outer, torch.empty(4, 4, device="meta"), 4))
    assert out["dot_flops"] == 4 * 5 * 2 * 4 * 4 * 4


def _reference_dot_flops(jc):
    import jax
    from repro.distributed import hlo_analysis
    from repro.models import lm as jlm
    from repro.training.optimizer import init_opt_state
    from repro.training.train_step import TrainConfig, make_train_step
    tok = jax.ShapeDtypeStruct(_tok_shape(jc), np.int32)
    params = jax.eval_shape(lambda k: jlm.init_params(k, jc),
                            jax.random.PRNGKey(0))
    step = make_train_step(jc, TrainConfig(microbatches=MB, q_chunk=CHUNK,
                                           xent_chunk=CHUNK))
    hlo = jax.jit(lambda p, t, l: step(p, init_opt_state(p), t, l)).lower(
        params, tok, tok).compile().as_text()
    return hlo_analysis.analyze(hlo)["dot_flops"]


def _tok_shape(cfg):
    return (B, S, cfg.num_codebooks) if cfg.num_codebooks > 1 else (B, S)


@pytest.fixture(scope="module")
def reference_flops():
    """Every arch's reference dot FLOPs (a future each, compiled two at a
    time while the tests count the port's steps) and its port config."""
    from torch_parity import smoke_cfgs
    from torch_train_parity import KINDS
    cfgs = {a: smoke_cfgs(a, kinds=a in KINDS) for a in ARCHS}
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        yield {a: (pool.submit(_reference_dot_flops, c[0]), c[1])
               for a, c in cfgs.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_one_device_dot_flops_equal_the_reference(reference_flops, arch):
    """The port's one-device smoke train step (full remat, 2 microbatches)
    counted on meta tensors: its dot FLOPs equal the reference's
    ``hlo_analysis`` of the compiled step, exactly."""
    from repro_torch.models import lm
    from repro_torch.training.optimizer import init_opt_state
    from repro_torch.training.train_step import (TrainConfig,
                                                 make_train_step)
    want, tc = reference_flops[arch]
    params = lm.init_params(tc, torch.Generator(), "meta")
    tok = torch.empty(_tok_shape(tc), dtype=torch.int32, device="meta")
    step = make_train_step(tc, TrainConfig(microbatches=MB, q_chunk=CHUNK,
                                           xent_chunk=CHUNK))
    got = op_analysis.analyze(step, params, init_opt_state(params), tok, tok)
    assert got["dot_flops"] == want.result(), arch


def _layer(kind, device):
    """A smoke sLSTM, mLSTM or Mamba layer, fp32, and its input: 2 x 64
    tokens (64 sLSTM trips; mLSTM and Mamba in chunks of 16, 4 trips)."""
    from repro_torch.configs.base import (MambaSpec, MLSTMSpec, SLSTMSpec,
                                          get_arch, reduce_for_smoke)
    from repro_torch.models import ssm, xlstm
    arch, spec, init, fwd = {
        "slstm": ("xlstm-1.3b", SLSTMSpec(num_heads=2), xlstm.init_slstm,
                  xlstm.slstm_forward),
        "mlstm": ("xlstm-1.3b", MLSTMSpec(num_heads=2), xlstm.init_mlstm,
                  lambda *a: xlstm.mlstm_forward(*a, chunk=16)),
        "mamba": ("zamba2-2.7b", MambaSpec(d_state=8, head_dim=16),
                  ssm.init_mamba, lambda *a: ssm.mamba_forward(*a, chunk=16)),
    }[kind]
    cfg = dataclasses.replace(reduce_for_smoke(get_arch(arch)),
                              compute_dtype="float32")
    params = init(torch.Generator().manual_seed(0), cfg, spec)
    leaves = [t.to(device).requires_grad_() for t in
              [v for v in params.values() if isinstance(v, torch.Tensor)]]
    tree = dict(zip([k for k, v in params.items()
                     if isinstance(v, torch.Tensor)], leaves),
                norm={"scale": params["norm"]["scale"].to(device)})
    x = torch.randn(2, 64, cfg.d_model).to(device).requires_grad_()

    def run():
        y = fwd(tree, x, cfg, spec)
        return torch.autograd.grad((y * y).sum(), [x] + leaves)
    return run


@pytest.mark.parametrize("kind", ["slstm", "mlstm", "mamba"])
def test_loop_counts_for_its_trips_what_it_counts_unrolled(kind):
    """A recurrent layer forward and backward: unrolled on the CPU, and on
    meta tensors, where its loop runs three trips for all of them.  FLOPs
    (equal to ``FlopCounterMode``'s), traffic and collectives are equal;
    the peak within the 1/256 the analysis allows."""
    from torch.utils.flop_counter import FlopCounterMode
    unrolled = op_analysis.analyze(_layer(kind, "cpu"))
    folded = op_analysis.analyze(_layer(kind, "meta"))
    for key in ("dot_flops", "traffic_bytes", "collectives"):
        assert folded[key] == unrolled[key], key
    assert abs(folded["peak_bytes"] - unrolled["peak_bytes"]) \
        <= unrolled["peak_bytes"] / 256
    with FlopCounterMode(display=False) as fc:
        _layer(kind, "cpu")()
    assert unrolled["dot_flops"] == fc.get_total_flops()


def test_a_full_size_cell_ends_ok_with_the_references_keys():
    """gemma3-1b decode_32k on the 16x16 mesh: the reference's cell keys,
    ``trace_s`` in place of ``lower_s`` / ``compile_s``."""
    cell = dryrun.run_cell("gemma3-1b", "decode_32k", False)
    assert cell["status"] == "ok", cell
    reference_keys = {
        "arch", "shape", "mesh", "tag", "opts", "status", "chips",
        "cost_analysis", "memory_analysis", "bytes_per_device_total",
        "fits_hbm", "collectives", "collective_bytes_per_device",
        "roofline", "model_flops", "useful_flops_ratio",
        "roofline_fraction", "meta"}
    assert reference_keys <= set(cell) and "trace_s" in cell
    assert cell["chips"] == 256 and cell["rank"] == dryrun.RANK
    assert cell["fits_hbm"] and 0 < cell["bytes_per_device_total"]
    assert cell["cost_analysis"]["flops_per_device"] > 0
    assert set(cell["roofline"]) == {
        "compute_s", "memory_s", "collective_s", "dominant", "flops_global",
        "bytes_global", "coll_bytes_global", "chips"}
    assert not torch.distributed.is_initialized()
