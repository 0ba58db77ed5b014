"""The byte plans of the bulk-copy kernels (``csrc/bulk_copy.cu``) for a
run-table gather and a run-table scatter, ``kernels/page_gather/plan.py:
run_spans`` and ``scatter_spans``: executed with numpy byte slices on the
CPU, they must give the reference's ``page_gather_runs`` and
``cow_scatter_runs`` (Pallas, interpret mode) byte for byte, trimmed at the
destination limit; and the routes the wrappers pick on the host.  The
kernels themselves run only on the card (``chip_smoke.py``)."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.cow_scatter import ops as jcs_ops  # noqa: E402
from repro.kernels.page_gather import ops as jpg_ops  # noqa: E402

from repro_torch.kernels import bulk_copy  # noqa: E402
from repro_torch.kernels.page_gather import ops as pg_ops  # noqa: E402
from repro_torch.kernels.page_gather.ops import kernel_ids  # noqa: E402
from repro_torch.kernels.page_gather.plan import (run_spans,  # noqa: E402
                                                  scatter_spans)
from repro_torch.kernels.page_gather.ref import expand_runs  # noqa: E402

F, E = 64, 128         # rows of 512 (fp32) / 256 (bf16) bytes

RUNS = {
    "skewed": ([0, 20, 30, 50], [18, 1, 15, 2]),
    "zero-length-filtered": ([3, 9, 40, 44], [4, 0, 2, 0]),
    "single-run": ([5], [40]),
    "singletons-unsorted": ([33, 2, 17, 60], [1, 1, 1, 1]),
}
# destination bytes cut off the end: none, inside the last page (not a
# multiple of 16), the whole last page and part of the one before
TRIM = {"none": lambda row: 0, "inside-last-page": lambda row: row - 4,
        "past-last-page": lambda row: row + 6}


def _bytes(a):
    a = np.asarray(a)
    return (a.view(np.uint16) if a.dtype.name == "bfloat16" else a) \
        .reshape(-1).view(np.uint8)


def _reference_bytes(frames, starts, lens):
    return _bytes(jpg_ops.page_gather_runs(jnp.asarray(frames), starts, lens,
                                           backend="interpret"))


@pytest.mark.parametrize("trim", sorted(TRIM))
@pytest.mark.parametrize("runs", sorted(RUNS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_run_spans_match_reference_gather(dtype, runs, trim):
    starts, lens = (np.array(x, np.int64) for x in RUNS[runs])
    rng = np.random.default_rng(len(runs) + len(trim))
    frames = jnp.asarray(rng.standard_normal((F, E)).astype(np.float32)) \
        .astype(dtype)
    fb = np.asarray(frames)
    fb = (fb.view(np.uint16) if dtype == "bfloat16" else fb).reshape(-1) \
        .view(np.uint8)
    row = E * jnp.dtype(dtype).itemsize
    limit = int(lens.sum()) * row - TRIM[trim](row)

    src, dst, nbytes = run_spans(starts, lens, row, limit)
    out = np.zeros(limit, np.uint8)
    for s, d, n in zip(src, dst, nbytes):
        out[d:d + n] = fb[s:s + n]
    np.testing.assert_array_equal(
        out, _reference_bytes(frames, starts, lens)[:limit])
    # the spans tile the destination: in order, no gap, no overlap, and
    # only the last one may end off a row boundary
    assert (nbytes > 0).all() and int(nbytes.sum()) == limit
    np.testing.assert_array_equal(dst, np.cumsum(nbytes) - nbytes)
    assert not (nbytes[:-1] % row).any() and not (src % row).any()
    table = bulk_copy.span_table(src, dst, nbytes)
    assert table.dtype == np.int64 and table.flags.c_contiguous
    np.testing.assert_array_equal(table[2], np.cumsum(nbytes))


@pytest.mark.parametrize("row, trim, base, want", [
    (512, 0, 0, True),            # fp32 rows of 128
    (512, 4, 0, True),            # only the last span is off 16
    (2002, 0, 0, False),          # odd bf16 rows: offsets off 16
    (512, 0, 8, False),           # a misaligned view
])
def test_spans_aligned_follows_the_bulk_rule(row, trim, base, want):
    """The host-side copy of the kernel's alignment rule, which decides
    before a large table is uploaded whether the bulk path takes it."""
    starts, lens = (np.array(x, np.int64) for x in RUNS["skewed"])
    limit = int(lens.sum()) * row - trim
    table = bulk_copy.span_table(*run_spans(starts, lens, row, limit))
    assert bulk_copy.spans_aligned(table, 0x10000 + base, 0x20000) is want


def _normal(rng, shape, dtype):
    return jnp.asarray(rng.standard_normal(shape).astype(np.float32)) \
        .astype(dtype)


@pytest.mark.parametrize("trim", sorted(TRIM))
@pytest.mark.parametrize("runs", sorted(RUNS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scatter_spans_match_reference_scatter(dtype, runs, trim):
    """The run-table scatter's byte plan, run with numpy byte slices on a
    copy of the frames, against the reference's ``cow_scatter_runs``; the
    destination ends where the last frame written ends, less ``trim``."""
    starts, lens = (np.array(x, np.int64) for x in RUNS[runs])
    rng = np.random.default_rng(2 * len(runs) + len(trim))
    frames = _normal(rng, (F, E), dtype)
    pages = _normal(rng, (int(lens.sum()), E), dtype)
    row = E * jnp.dtype(dtype).itemsize
    limit = int((starts + lens)[lens > 0].max()) * row - TRIM[trim](row)

    fb, pb = _bytes(frames).copy(), _bytes(pages)    # frames are donated
    want = _bytes(jcs_ops.cow_scatter_runs(frames, starts, lens, pages,
                                           backend="interpret"))
    src, dst, nbytes = scatter_spans(starts, lens, row, limit)
    out = fb.copy()
    for s, d, n in zip(src, dst, nbytes):
        out[d:d + n] = pb[s:s + n]
    np.testing.assert_array_equal(out[:limit], want[:limit])
    np.testing.assert_array_equal(out[limit:], fb[limit:])
    untouched = np.setdiff1d(np.arange(F), expand_runs(starts, lens))
    np.testing.assert_array_equal(out.reshape(F, row)[untouched],
                                  fb.reshape(F, row)[untouched])
    # the spans tile the payload in run order (a trimmed destination only
    # shortens or drops spans) and start on frame rows
    assert (nbytes > 0).all() and not (dst % row).any()
    assert not (src % row).any() and (src[1:] >= src[:-1] + nbytes[:-1]).all()
    if trim == "none":
        np.testing.assert_array_equal(src, np.cumsum(nbytes) - nbytes)
        assert int(nbytes.sum()) == pb.size
    table = bulk_copy.span_table(src, dst, nbytes)
    assert table.dtype == np.int64 and table.flags.c_contiguous


@pytest.mark.parametrize("row, starts, lens, cut, base, aligned, route", [
    (512, [0, 20, 30, 50], [18, 1, 15, 2], 0, 0, True, "bulk-value"),
    # the last span ends off 16: still bulk, but the route rule, which
    # sees only the destination's end, leaves it to copy_rows
    (512, [0, 20, 30, 50], [18, 1, 15, 2], 4, 0, True, None),
    # a span cut off 16 with another after it: not bulk
    (512, [60, 2], [1, 1], 4, 0, False, None),
    (2002, [0, 20, 30, 50], [18, 1, 15, 2], 0, 0, False, None),   # odd rows
    (512, [0, 20, 30, 50], [18, 1, 15, 2], 0, 8, False, None),    # a view
])
def test_spans_aligned_takes_the_scatter_table(row, starts, lens, cut, base,
                                               aligned, route):
    """``spans_aligned`` (the kernel's alignment rule) on the scatter's
    table, beside ``runs_route``, the rule the wrapper applies: it takes a
    bulk route only where the table is aligned."""
    starts, lens = np.array(starts, np.int64), np.array(lens, np.int64)
    limit = int((starts + lens).max()) * row - cut
    table = bulk_copy.span_table(*scatter_spans(starts, lens, row, limit))
    ptrs = (0x10000 + base, 0x20000)
    assert bulk_copy.spans_aligned(table, *ptrs) is aligned
    assert bulk_copy.runs_route(len(starts), row, limit, 100, *ptrs) == route


@pytest.mark.parametrize("n, row, limit, base, want", [
    (1, 4096, 4096 * 4096, 0, "bulk-value"),     # the replay's runs
    (100, 512, 512 * 300, 0, "bulk-value"),      # exactly the capacity
    (101, 512, 512 * 300, 0, "bulk-device"),     # one past it: uploaded
    (3, 4004, 4004 * 256, 0, None),              # odd fp32 rows of 1,001
    (3, 512, 512 * 64, 4, None),                 # a misaligned payload
    (101, 512, 512 * 300 - 4, 0, None),          # a partial last frame
])
def test_runs_route_follows_the_bulk_rule(n, row, limit, base, want):
    """The run-table scatter's route, decided on the host before anything
    is uploaded, with a by-value capacity of 100 runs."""
    assert bulk_copy.runs_route(n, row, limit, 100, 0x10000, 0x20000 + base) \
        == want


def test_kernel_ids_stay_on_their_side():
    """Host ids stay a range-checked int32 numpy array (they travel in the
    launch); ids already in a tensor are not read back."""
    ids = kernel_ids([3, 1, 2], 4, torch.device("cpu"))
    assert isinstance(ids, np.ndarray) and ids.dtype == np.int32
    assert ids.flags.c_contiguous and ids.tolist() == [3, 1, 2]
    with pytest.raises(IndexError):
        kernel_ids([4], 4, torch.device("cpu"))
    t = kernel_ids(torch.tensor([[7, 9]]), 4, torch.device("cpu"))
    assert t.dtype == torch.int32 and t.tolist() == [7, 9]


def _run_table_result(starts, lens):
    try:
        s, n, total = pg_ops.run_table(starts, lens, F)
    except Exception as e:                  # noqa: BLE001
        return type(e)
    assert s.dtype == n.dtype == np.int64 and s.ndim == n.ndim == 1
    assert type(total) is int
    return s.tolist(), n.tolist(), total


@pytest.mark.parametrize("starts, lens", [
    *RUNS.values(),
    ([F - 4], [4]), ([F - 4], [5]), ([-1], [2]), ([3, 70], [2, -1]),
    ([[1, 9]], [[2, 3]]), ([1, 2], [3]), ([], []),
    (list(range(65)), [1] * 65),
    (list(range(65)), [1] * 64 + [0]),
], ids=[*RUNS, "ends-at-limit", "past-limit", "negative-start",
        "negative-len-filtered", "2-d", "sizes-differ", "empty",
        "65-runs-past-limit", "65-runs-zero-length"])
def test_run_table_checks_few_runs_as_numpy_does(monkeypatch, starts, lens):
    """run_table's path for a few runs (Python ints) gives what its numpy
    path gives: the same tables, or the same exception."""
    small = _run_table_result(starts, lens)
    monkeypatch.setattr(pg_ops, "SMALL_RUNS", -1)
    assert small == _run_table_result(starts, lens)


@pytest.mark.parametrize("n, on_device, row, base, want", [
    (64, False, 512, 0, "bulk-value"),
    (100, False, 512, 0, "bulk-value"),          # exactly the capacity
    (101, False, 512, 0, "bulk-device"),         # one past it: uploaded
    (3, True, 512, 0, "bulk-device"),            # read where they are
    (3, False, 2002, 0, None),                   # odd bf16 rows
    (101, False, 512, 4, None),                  # misaligned: no upload
])
def test_ids_route_follows_the_bulk_rule(n, on_device, row, base, want):
    """The row-id copies' route (``scatter_ids``/``gather_ids``), decided
    on the host before any upload, with a by-value capacity of 100."""
    ids = np.arange(n, dtype=np.int32)
    if on_device:
        ids = torch.from_numpy(ids)
    assert bulk_copy.ids_route(ids, row, 100, 0x10000 + base, 0x20000) \
        == want


def test_pool_passes_its_int32_ids_through_uncopied(monkeypatch):
    """A device pool's gathers hand the kernel path the pool's own int32
    table: ``kernel_ids`` returns the same array, not a copy."""
    from repro_torch.kernels.page_gather import ops as pg
    from repro_torch.memory.pool import PagePool
    seen = []
    real = pg.kernel_ids

    def spy(page_ids, num_frames, device):
        out = real(page_ids, num_frames, device)
        seen.append((page_ids, out))
        return out
    monkeypatch.setattr(pg, "kernel_ids", spy)
    pool = PagePool(page_elems=E, device="cpu")
    frames = pool.alloc("float32", 6)
    pages = torch.arange(6 * E, dtype=torch.float32).reshape(6, E)
    pool.write_pages("float32", frames, pages)
    picked = [int(frames[4]), int(frames[1]), int(frames[4])]
    got = pool.read_pages("float32", picked)
    assert torch.equal(got, pages[[4, 1, 4]])
    t = pool.assemble("float32", frames[:3], (3 * E - 5,))
    assert torch.equal(t, pages[:3].reshape(-1)[:3 * E - 5])
    assert len(seen) == 2
    for arg, out in seen:
        assert isinstance(arg, np.ndarray) and arg.dtype == np.int32
        assert out is arg


@pytest.mark.parametrize("runs", sorted(RUNS))
def test_run_table_counts_the_pages_of_its_runs(runs):
    """``run_table``'s page count, which the run-table wrappers take as
    the output's rows, equals ``lens.sum()``, on both of its paths."""
    starts, lens = RUNS[runs]
    total = int(np.sum(lens))
    assert pg_ops.run_table(starts, lens, F)[2] == total
    small = pg_ops.SMALL_RUNS
    try:
        pg_ops.SMALL_RUNS = -1
        assert pg_ops.run_table(starts, lens, F)[2] == total
    finally:
        pg_ops.SMALL_RUNS = small


def _kernel_ids_result(ids):
    try:
        out = kernel_ids(ids, F, torch.device("cpu"))
    except Exception as e:                  # noqa: BLE001
        return type(e)
    assert isinstance(out, np.ndarray) and out.dtype == np.int32
    assert out.ndim == 1 and out.flags.c_contiguous
    return out.tolist()


KERNEL_IDS = {
    "in-range": [3, 1, 2], "last-frame": [F - 1], "past-end": [F],
    "negative": [-1], "negative-among-many": [5] * 20 + [-3],
    "empty": [], "1-id": [7], "16-ids": list(range(16)),
    "64-ids": list(range(64)), "65-ids": [i % F for i in range(65)],
    "65-ids-past-end": [i % F for i in range(64)] + [F],
    "64-ids-last-past-end": list(range(63)) + [F + 1000],
    "2-d": [[1, 2], [3, 4]],
}


@pytest.mark.parametrize("dtype", ["int32", "int64", "list"])
@pytest.mark.parametrize("case", sorted(KERNEL_IDS))
def test_kernel_ids_checks_few_ids_as_numpy_does(monkeypatch, case, dtype):
    """kernel_ids' check of up to ``SMALL_RUNS`` ids as Python ints raises
    and passes exactly where its numpy path does, for the pool's own int32
    tables and for other ids; and an int32 table passes through uncopied
    on both paths."""
    ids = KERNEL_IDS[case]
    if dtype != "list":
        ids = np.array(ids, dtype)
    small = _kernel_ids_result(ids)
    if dtype == "int32" and ids.ndim == 1 and small is not IndexError:
        assert kernel_ids(ids, F, torch.device("cpu")) is ids
    monkeypatch.setattr(pg_ops, "SMALL_RUNS", -1)
    assert small == _kernel_ids_result(ids)
    if dtype == "int32" and ids.ndim == 1 and small is not IndexError:
        assert kernel_ids(ids, F, torch.device("cpu")) is ids
    want = (IndexError if any(not 0 <= i < F
                              for i in np.ravel(KERNEL_IDS[case]))
            else np.ravel(KERNEL_IDS[case]).astype(int).tolist())
    assert small == want


@pytest.mark.parametrize("n, cut, base, want", [
    (1, 0, 0, "bulk-value"),            # the replay's runs
    (100, 0, 0, "bulk-value"),          # exactly the capacity
    (101, 0, 0, "bulk-device"),         # one past it: run_spans uploaded
    (3, 4, 0, None),                    # an output ending off 16 bytes
    (3, 0, 4, None),                    # a misaligned output
])
def test_gather_runs_hands_the_c_entry_its_runs_as_bytes(monkeypatch, n,
                                                         cut, base, want):
    """``bulk_copy.gather_runs`` takes ``runs_route``'s route, decided
    before anything is uploaded.  On ``bulk-value`` it makes one call of
    the C entry ``bulk_gather_runs`` with ``starts.tobytes()``,
    ``lens.tobytes()``, ``n``, the row and the limit, and no numpy plan;
    past the capacity it hands ``run_spans``' table to ``copy_spans``."""
    row, E = 512, 128
    starts = np.arange(0, 3 * n, 3, dtype=np.int64)
    lens = np.ones(n, np.int64) + np.arange(n) % 2
    limit = int(lens.sum()) * row - cut
    src = torch.zeros(3 * n + 2, E)
    buf = torch.zeros(int(lens.sum()) * E + 4)
    dst = buf[base // 4:]
    calls, spans = [], []

    def function(lib, entry, argtypes):
        assert lib == "bulk_copy"

        def fn(*args):
            calls.append((entry, args))
            return 0
        return fn

    def copy_spans(d, s, table):
        spans.append(table)
        return "bulk-device"
    monkeypatch.setattr(bulk_copy.build, "function", function)
    monkeypatch.setattr(bulk_copy.build, "stream", lambda device: 77)
    monkeypatch.setattr(bulk_copy, "_limits",
                        {"ids": 100, "spans": 100, "param_bytes": 0})
    monkeypatch.setattr(bulk_copy, "copy_spans", copy_spans)
    route = bulk_copy.gather_runs(dst, src, starts, lens, row, limit)
    assert route == want == bulk_copy.runs_route(
        n, row, limit, 100, dst.data_ptr(), src.data_ptr())
    if want == "bulk-value":
        assert calls == [("bulk_gather_runs", (
            dst.data_ptr(), src.data_ptr(), starts.tobytes(), lens.tobytes(),
            n, row, limit, 77))]
        assert not spans
    elif want == "bulk-device":
        assert not calls and len(spans) == 1
        np.testing.assert_array_equal(
            spans[0], bulk_copy.span_table(*run_spans(starts, lens, row,
                                                      limit)))
    else:
        assert not calls and not spans


def test_gather_ids_hands_the_c_entry_its_ids_as_bytes(monkeypatch):
    """Host ids within the by-value capacity reach ``bulk_gather_ids`` as
    ``ids.tobytes()``, with no device table; ids past it are uploaded and
    passed by their device pointer alone."""
    calls = []

    def function(lib, entry, argtypes):
        def fn(*args):
            calls.append((entry, args))
            return 0
        return fn
    monkeypatch.setattr(bulk_copy.build, "function", function)
    monkeypatch.setattr(bulk_copy.build, "stream", lambda device: 77)
    monkeypatch.setattr(bulk_copy, "_limits",
                        {"ids": 4, "spans": 4, "param_bytes": 0})
    src, dst = torch.zeros(F, E), torch.zeros(5, E)
    row = E * 4
    ids = np.array([7, 3, 3, 60], np.int32)
    assert bulk_copy.gather_ids(dst, src, ids, row, 4 * row) == "bulk-value"
    assert calls == [("bulk_gather_ids", (dst.data_ptr(), src.data_ptr(),
                                          ids.tobytes(), None, 4, row,
                                          4 * row, 77))]
    calls.clear()
    ids = np.array([7, 3, 3, 60, 1], np.int32)
    assert bulk_copy.gather_ids(dst, src, ids, row, 5 * row) == "bulk-device"
    (entry, args), = calls
    assert entry == "bulk_gather_ids" and args[2] is None
    assert isinstance(args[3], int) and args[4:] == (5, row, 5 * row, 77)
