"""The port's kernel modules against the reference's Pallas kernels
(interpret mode) and jnp oracles, on CPU tensors, where each wrapper takes
its plain PyTorch version.  Copies must be bit-exact; attention meets
3e-5 (fp32) / 3e-2 (bf16), since its sums run in another order."""
import pytest

torch = pytest.importorskip("torch")

from collections import Counter  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.cow_scatter import ops as jcs_ops  # noqa: E402
from repro.kernels.cow_scatter.kernel import cow_scatter as jcs_kernel  # noqa: E402
from repro.kernels.cow_scatter.kernel import \
    cow_scatter_runs as jcs_runs_kernel  # noqa: E402
from repro.kernels.page_gather import ops as jpg_ops  # noqa: E402
from repro.kernels.page_gather.kernel import page_gather as jpg_kernel  # noqa: E402
from repro.kernels.page_gather.kernel import \
    page_gather_runs as jpg_runs_kernel  # noqa: E402
from repro.kernels.page_gather.ref import expand_runs as jexpand_runs  # noqa: E402
from repro.kernels.paged_attention.kernel import \
    paged_attention as jpa_kernel  # noqa: E402
from repro.kernels.paged_attention.ref import paged_attention_ref as jpa_ref  # noqa: E402

from repro_torch import _dtypes  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels.cow_scatter import ops as cs  # noqa: E402
from repro_torch.kernels.page_gather import ops as pg  # noqa: E402
from repro_torch.kernels.page_gather.ref import expand_runs  # noqa: E402
from repro_torch.kernels.paged_attention.ops import paged_attention  # noqa: E402

DTYPES = ("float32", "bfloat16", "int32")


def _data(rng, shape, dtype):
    if dtype == "int32":
        return rng.integers(0, 1000, shape).astype(np.int32)
    return rng.standard_normal(shape).astype(np.float32)


def _jx(a, dtype):
    return jnp.asarray(a).astype(dtype)


def _pt(a, dtype):
    return torch.from_numpy(np.ascontiguousarray(a)).to(
        _dtypes.torch_dtype(dtype))


def _bits_j(x):
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _bits_t(x):
    return _dtypes.to_numpy(x)


def _f32_t(x):
    return x.float().numpy()


def _f32_j(x):
    return np.asarray(x.astype(jnp.float32))


# -- page_gather ---------------------------------------------------------------


@pytest.mark.parametrize("F,E,n", [(8, 128, 3), (32, 512, 32), (64, 1024, 1)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_page_gather_matches_reference(F, E, n, dtype):
    rng = np.random.default_rng(F * E + n)
    frames = _data(rng, (F, E), dtype)
    ids = rng.integers(0, F, n).astype(np.int32)
    got = pg.page_gather(_pt(frames, dtype), ids)
    jf = _jx(frames, dtype)
    want_kernel = jpg_kernel(jf, jnp.asarray(ids), interpret=True)
    want_ref = jpg_ops.page_gather(jf, ids, backend="ref")
    np.testing.assert_array_equal(_bits_t(got), _bits_j(want_kernel))
    np.testing.assert_array_equal(_bits_t(got), _bits_j(want_ref))


def test_page_gather_duplicate_ids():
    frames = torch.arange(8 * 128, dtype=torch.float32).reshape(8, 128)
    got = pg.page_gather(frames, [5, 5, 5])
    assert torch.equal(got, torch.stack([frames[5]] * 3))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("runs", [
    [(0, 1)],                                  # single-page single-run
    [(3, 4), (10, 2), (20, 1)],                # mixed lengths
    [(12, 1), (4, 1), (30, 1)],                # all singletons, unsorted
    [(0, 8), (16, 8)],                         # uniform long runs
])
def test_page_gather_runs_matches_reference(dtype, runs):
    F, E = 40, 128
    frames = _data(np.random.default_rng(3), (F, E), dtype)
    starts = np.array([s for s, _ in runs], np.int64)
    lens = np.array([l for _, l in runs], np.int64)
    got = pg.page_gather_runs(_pt(frames, dtype), starts, lens)
    jf = _jx(frames, dtype)
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]])
    want = jpg_runs_kernel(jf, jnp.asarray(starts, jnp.int32),
                           jnp.asarray(lens, jnp.int32),
                           jnp.asarray(offs, jnp.int32),
                           max_len=int(lens.max()), n_out=int(lens.sum()),
                           interpret=True)
    np.testing.assert_array_equal(_bits_t(got), _bits_j(want))
    np.testing.assert_array_equal(expand_runs(starts, lens),
                                  jexpand_runs(starts, lens))


def test_page_gather_runs_empty_and_zero_len():
    frames = torch.arange(8 * 128, dtype=torch.float32).reshape(8, 128)
    assert pg.page_gather_runs(frames, [], []).shape == (0, 128)
    got = pg.page_gather_runs(frames, [2, 5], [0, 3])
    assert torch.equal(got, frames[5:8])


@pytest.mark.parametrize("shape", [(300,), (3, 129), (1, 1), (257,)])
def test_gather_assemble_matches_reference(shape):
    F, E = 16, 128
    frames = np.random.default_rng(2).standard_normal((F, E)).astype(
        np.float32)
    size = int(np.prod(shape))
    n = -(-size // E)
    ids = np.random.default_rng(0).choice(F, n, replace=False).astype(
        np.int32)
    got = pg.gather_assemble(torch.from_numpy(frames), ids, shape)
    want = jpg_ops.gather_assemble(jnp.asarray(frames), ids, shape,
                                   backend="interpret")
    assert tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- cow_scatter -----------------------------------------------------------------


@pytest.mark.parametrize("F,E,n", [(8, 128, 3), (16, 256, 8)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cow_scatter_matches_reference(F, E, n, dtype):
    rng = np.random.default_rng(F + n)
    frames = _data(rng, (F, E), dtype)
    ids = rng.choice(F, size=n, replace=False).astype(np.int32)
    pages = _data(rng, (n, E), dtype)
    got = cs.cow_scatter(_pt(frames, dtype), ids, _pt(pages, dtype))
    want = jcs_kernel(_jx(frames, dtype), jnp.asarray(ids),
                      _jx(pages, dtype), interpret=True)
    np.testing.assert_array_equal(_bits_t(got), _bits_j(want))
    # frames not addressed keep their bits
    untouched = np.setdiff1d(np.arange(F), ids)
    np.testing.assert_array_equal(_bits_t(got)[untouched],
                                  _bits_t(_pt(frames, dtype))[untouched])


def test_cow_scatter_casts_payload_to_pool_dtype():
    frames = torch.zeros((4, 128), dtype=torch.bfloat16)
    pages = torch.full((1, 128), 1.5, dtype=torch.float32)
    got = cs.cow_scatter(frames, [2], pages)
    assert got is frames and got.dtype == torch.bfloat16
    assert float(got[2, 0]) == 1.5 and float(got[0].abs().sum()) == 0.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cow_scatter_runs_matches_reference(dtype):
    F, E = 32, 128
    starts = np.array([0, 8, 20], np.int64)
    lens = np.array([3, 1, 4], np.int64)
    rng = np.random.default_rng(0)
    frames = _data(rng, (F, E), dtype)
    pages = _data(rng, (int(lens.sum()), E), dtype)
    got = cs.cow_scatter_runs(_pt(frames, dtype), starts, lens,
                              _pt(pages, dtype))
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]])
    want = jcs_runs_kernel(_jx(frames, dtype), jnp.asarray(starts, jnp.int32),
                           jnp.asarray(lens, jnp.int32),
                           jnp.asarray(offs, jnp.int32), _jx(pages, dtype),
                           max_len=int(lens.max()), interpret=True)
    np.testing.assert_array_equal(_bits_t(got), _bits_j(want))


def test_cow_scatter_runs_empty_and_zero_len():
    frames = torch.ones((4, 128))
    before = frames.clone()
    assert cs.cow_scatter_runs(frames, [], [], torch.zeros((0, 128))) \
        is frames
    assert torch.equal(frames, before)
    cs.cow_scatter_runs(frames, [1, 2], [0, 1], torch.zeros((1, 128)))
    assert float(frames[2].sum()) == 0.0 and float(frames[1].sum()) == 128.0


@pytest.mark.parametrize("shape", [(300,), (5, 70), (256,)])
def test_scatter_patch_matches_reference(shape):
    E = 128
    size = int(np.prod(shape))
    n = -(-size // E)
    rng = np.random.default_rng(1)
    t0 = rng.standard_normal(shape).astype(np.float32)
    ids = rng.choice(n, max(1, n // 2), replace=False).astype(np.int32)
    rows = rng.standard_normal((ids.size, E)).astype(np.float32)
    t = torch.from_numpy(t0.copy())
    got = cs.scatter_patch(t, ids, torch.from_numpy(rows), page_elems=E)
    want = jcs_ops.scatter_patch(jnp.asarray(t0), ids, jnp.asarray(rows),
                                 page_elems=E, backend="interpret")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(t.numpy(), t0)      # input untouched


def test_scatter_patch_empty_ids_is_identity():
    t = torch.arange(10.0)
    assert cs.scatter_patch(t, [], torch.zeros((0, 128)), page_elems=128) is t


# -- paged_attention -----------------------------------------------------------


def _attn_inputs(seed, B, K, G, hd, Tp, P, F):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, K, G, hd)).astype(np.float32)
    pk = rng.standard_normal((F, Tp, K, hd)).astype(np.float32)
    pv = rng.standard_normal((F, Tp, K, hd)).astype(np.float32)
    pt = rng.integers(0, F, (B, P)).astype(np.int32)
    vt = rng.integers(0, F, (B, P)).astype(np.int32)
    lengths = rng.integers(1, P * Tp + 1, B).astype(np.int32)
    return q, pk, pv, pt, vt, lengths


@pytest.mark.parametrize("B,K,G,hd,Tp,P,F", [
    (2, 2, 4, 128, 8, 4, 16),
    (1, 1, 8, 128, 16, 2, 8),       # MQA
    (3, 4, 1, 256, 8, 3, 24),       # MHA
    (2, 4, 7, 128, 16, 3, 12),      # qwen2's 7 query heads per kv head
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_attention_matches_reference(B, K, G, hd, Tp, P, F, dtype):
    q, pk, pv, pt, vt, lengths = _attn_inputs(B * 7 + G, B, K, G, hd, Tp,
                                              P, F)
    got = paged_attention(_pt(q, dtype), _pt(pk, dtype), _pt(pv, dtype),
                          pt, lengths, v_page_table=vt)
    jargs = (_jx(q, dtype), _jx(pk, dtype), _jx(pv, dtype), jnp.asarray(pt),
             jnp.asarray(lengths))
    want_kernel = jpa_kernel(*jargs, v_page_table=jnp.asarray(vt),
                             interpret=True)
    want_ref = jpa_ref(*jargs, v_page_table=jnp.asarray(vt))
    tol = 3e-2 if dtype == "bfloat16" else 3e-5
    assert got.dtype == _dtypes.torch_dtype(dtype)
    for want in (want_kernel, want_ref):
        err = float(np.abs(_f32_t(got) - _f32_j(want)).max())
        assert err < tol, err


def test_paged_attention_window_starts():
    B, K, G, hd, Tp, P, F = 2, 1, 2, 128, 8, 4, 12
    q, pk, pv, pt, _, _ = _attn_inputs(0, B, K, G, hd, Tp, P, F)
    lengths = np.array([30, 25], np.int32)
    starts = np.array([10, 0], np.int32)
    got = paged_attention(torch.from_numpy(q), torch.from_numpy(pk),
                          torch.from_numpy(pv), pt, lengths, starts=starts)
    want = jpa_kernel(jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv),
                      jnp.asarray(pt), jnp.asarray(lengths),
                      starts=jnp.asarray(starts), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-5,
                               atol=3e-5)
    no_window = paged_attention(torch.from_numpy(q), torch.from_numpy(pk),
                                torch.from_numpy(pv), pt, lengths)
    assert float((got - no_window).abs().max()) > 1e-4     # starts matter


# -- dispatch ----------------------------------------------------------------------


def _calls():
    f = torch.zeros((4, 128))
    return {
        "page_gather": lambda b: pg.page_gather(f, [1], backend=b),
        "page_gather_runs": lambda b: pg.page_gather_runs(f, [0], [2],
                                                          backend=b),
        "gather_assemble": lambda b: pg.gather_assemble(f, [1], (100,),
                                                        backend=b),
        "cow_scatter": lambda b: cs.cow_scatter(f, [1], torch.ones((1, 128)),
                                                backend=b),
        "cow_scatter_runs": lambda b: cs.cow_scatter_runs(
            f, [0], [2], torch.ones((2, 128)), backend=b),
        "scatter_patch": lambda b: cs.scatter_patch(
            torch.zeros(128), [0], torch.ones((1, 128)), page_elems=128,
            backend=b),
        "paged_attention": lambda b: paged_attention(
            torch.zeros((1, 1, 1, 16)), torch.zeros((2, 4, 1, 16)),
            torch.zeros((2, 4, 1, 16)), [[1]], [3], backend=b),
    }


@pytest.mark.parametrize("op", sorted(_calls()))
def test_kernel_backend_on_cpu_tensor_raises(op):
    call = _calls()[op]
    call("torch")
    call("auto")
    with pytest.raises(RuntimeError, match="CUDA"):
        call("kernel")


def test_dispatch_meters_and_launch_counts():
    dispatch.reset_meters()
    dispatch.reset_launches()
    f = torch.arange(4 * 128, dtype=torch.float32).reshape(4, 128)
    pg.page_gather(f, [1, 3])
    paged_attention(torch.zeros((1, 1, 1, 16)), torch.zeros((2, 4, 1, 16)),
                    torch.zeros((2, 4, 1, 16)), [[1]], [3], backend="torch")
    assert dispatch.kernel_meters() == {"kernel.page_gather.torch": 1,
                                        "kernel.paged_attention.torch": 1}
    sink = Counter()
    dispatch.drain_meters_into(sink)
    assert sum(sink.values()) == 2 and not dispatch.kernel_meters()
    pg.page_gather(f, [0])
    dispatch.drain_meters_into(None)           # no meter: counts dropped
    assert not dispatch.kernel_meters()
    assert not dispatch.launches               # the plain versions launch nothing
    with pytest.raises(ValueError):
        dispatch.resolve_backend("jnp", kernel_name="page_gather",
                                 device=torch.device("cpu"))


def test_page_ids_are_range_checked():
    f = torch.zeros((4, 128))
    with pytest.raises(IndexError):
        pg.page_gather(f, [4])
    with pytest.raises(IndexError):
        pg.page_gather_runs(f, [3], [2])
    with pytest.raises(IndexError):
        cs.cow_scatter(f, [-1], torch.ones((1, 128)))
    with pytest.raises(IndexError):
        paged_attention(torch.zeros((1, 1, 1, 16)), torch.zeros((2, 4, 1, 16)),
                        torch.zeros((2, 4, 1, 16)), [[2]], [3])


# -- the property matrix of the reference (seeded mirror) ----------------------
# Every backend of the port on CPU tensors against the reference's ref.py,
# over dtypes, extent-run shapes (zero-length, single-page, shuffled,
# non-contiguous) and the assemble -> patch round trip that
# ensure_tensor's incremental reassembly relies on.

PE, PF = 128, 48


def _prop_frames(dt, seed):
    return _data(np.random.default_rng(seed), (PF, PE), dt)


def _random_runs(rng, max_runs=6, max_len=5):
    k = int(rng.integers(0, max_runs + 1))
    runs, cursor = [], 0
    for _ in range(k):
        gap = int(rng.integers(1, 4))
        length = int(rng.integers(0, max_len + 1))
        start = cursor + gap
        if start + max(length, 1) > PF:
            break
        runs.append((start, length))
        cursor = start + max(length, 1)
    rng.shuffle(runs)
    return runs


def _tables(runs):
    starts = np.array([s for s, _ in runs], np.int64)
    lens = np.array([l for _, l in runs], np.int64)
    return starts, lens, expand_runs(starts, lens)


@pytest.mark.parametrize("dt", DTYPES)
def test_gather_matrix_matches_reference(dt):
    rng = np.random.default_rng(42)
    cases = [[], [(0, 1)], [(PF - 1, 1)], [(3, 0)], [(5, 3), (20, 1), (9, 4)]]
    cases += [_random_runs(rng) for _ in range(10)]
    frames = _prop_frames(dt, 11)
    jf = _jx(frames, dt)
    for runs in cases:
        starts, lens, ids = _tables(runs)
        want = _bits_j(jpg_ops.page_gather_runs(jf, starts, lens,
                                                backend="ref"))
        for backend in ("auto", "torch"):
            got = pg.page_gather_runs(_pt(frames, dt), starts, lens,
                                      backend=backend)
            np.testing.assert_array_equal(_bits_t(got), want,
                                          err_msg=f"{dt}/{backend}/{runs}")
            got = pg.page_gather(_pt(frames, dt), ids, backend=backend)
            np.testing.assert_array_equal(_bits_t(got), want,
                                          err_msg=f"{dt}/{backend}/ids")


@pytest.mark.parametrize("dt", DTYPES)
def test_scatter_matrix_matches_reference(dt):
    rng = np.random.default_rng(43)
    cases = [[], [(0, 1)], [(PF - 1, 1)], [(2, 4), (12, 1), (30, 2)]]
    cases += [_random_runs(rng) for _ in range(10)]
    frames, payload = _prop_frames(dt, 17), _prop_frames(dt, 13)
    for runs in cases:
        starts, lens, ids = _tables(runs)
        pages = payload[:ids.size]
        want = _bits_j(jcs_ops.cow_scatter_runs(
            _jx(frames, dt), starts, lens, _jx(pages, dt), backend="ref"))
        for backend in ("auto", "torch"):
            got = cs.cow_scatter_runs(_pt(frames, dt), starts, lens,
                                      _pt(pages, dt), backend=backend)
            np.testing.assert_array_equal(_bits_t(got), want,
                                          err_msg=f"{dt}/{backend}/{runs}")
            got = cs.cow_scatter(_pt(frames, dt), ids, _pt(pages, dt),
                                 backend=backend)
            np.testing.assert_array_equal(_bits_t(got), want,
                                          err_msg=f"{dt}/{backend}/ids")


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_assemble_patch_roundtrip_matches_reference(dt):
    rng = np.random.default_rng(44)
    for shape in [(PE,), (PE * 3 - 7,), (5, 77), (1,)]:
        size = int(np.prod(shape))
        n = -(-size // PE)
        frames = _prop_frames(dt, 19)
        ids = rng.choice(PF, n, replace=False).astype(np.int32)
        changed = rng.choice(n, max(1, n // 2), replace=False).astype(
            np.int32)
        rows = _prop_frames(dt, 23)[:changed.size]
        jt = jpg_ops.gather_assemble(_jx(frames, dt), ids, shape,
                                     backend="ref")
        want = _bits_j(jcs_ops.scatter_patch(jt, changed, _jx(rows, dt),
                                             page_elems=PE, backend="ref"))
        t = pg.gather_assemble(_pt(frames, dt), ids, shape)
        np.testing.assert_array_equal(_bits_t(t), _bits_j(jt))
        for backend in ("auto", "torch"):
            got = cs.scatter_patch(t, changed, _pt(rows, dt), page_elems=PE,
                                   backend=backend)
            np.testing.assert_array_equal(_bits_t(got), want,
                                          err_msg=f"{dt}/{backend}/{shape}")
