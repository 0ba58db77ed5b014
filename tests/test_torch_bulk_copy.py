"""The byte plan of the bulk-copy kernel (``csrc/bulk_copy.cu``) for a
run-table gather, ``kernels/page_gather/plan.py:run_spans``: executed with
numpy byte slices on the CPU, it must give the reference's
``page_gather_runs`` (Pallas, interpret mode) byte for byte, trimmed at the
destination limit.  The kernel itself runs only on the card
(``chip_smoke.py``)."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.page_gather import ops as jpg_ops  # noqa: E402

from repro_torch.kernels import bulk_copy  # noqa: E402
from repro_torch.kernels.page_gather.ops import kernel_ids  # noqa: E402
from repro_torch.kernels.page_gather.plan import run_spans  # noqa: E402

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


def _reference_bytes(frames, starts, lens):
    want = jpg_ops.page_gather_runs(jnp.asarray(frames), starts, lens,
                                    backend="interpret")
    a = np.asarray(want)
    return (a.view(np.uint16) if a.dtype.name == "bfloat16" else a) \
        .reshape(-1).view(np.uint8)


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
