"""The split plan of the paged_attention kernel
(``kernels/paged_attention/plan.py``) and the kernel's arithmetic, on the
CPU.  ``_split_and_combine`` below repeats in plain torch what
``csrc/paged_attention.cu`` computes — the plan's splits, tiles of
``tile_tokens(Tp)`` slots, an online fp32 softmax per split, and the
combine over the splits — and must give the reference's
``paged_attention_ref`` (jnp) within 1e-5 in fp32.  The kernel itself runs
only on the card (``chip_smoke.py``)."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.paged_attention.ref import paged_attention_ref as jpa_ref  # noqa: E402

from repro_torch.kernels.paged_attention import plan  # noqa: E402

NEG_INF = -1e30


def _columns(splits, cols, P):
    return [range(s * cols, min((s + 1) * cols, P)) for s in range(splits)]


@pytest.mark.parametrize("B,K,P,sms", [
    (4, 1, 1, 132),          # the main path's decode: one split
    (8, 1, 129, 132),        # long window batch
    (1, 1, 513, 132),        # one long sequence
    (3, 4, 7, 132),          # more splits wanted than columns
    (256, 8, 3, 132),        # more (b, k) than SMs: one split
    (2, 1, 5000, 132),       # more columns than one block holds
    (1, 1, 1, 1),
])
def test_split_plan_covers_each_column_once(B, K, P, sms):
    splits, cols = plan.split_plan(B, K, P, sms)
    spans = _columns(splits, cols, P)
    assert [c for r in spans for c in r] == list(range(P))
    assert all(len(r) >= 1 for r in spans)
    assert 1 <= cols <= plan.MAX_COLS
    if P == 1:
        assert splits == 1
    target = plan.BLOCKS_PER_SM * sms          # blocks to fill the card
    want = -(-target // (B * K))
    if B * K <= target and want <= P <= plan.MAX_COLS * want:
        assert target / 2 <= B * K * splits < target + B * K


def test_split_plan_rejects_empty_shapes():
    with pytest.raises(ValueError):
        plan.split_plan(0, 1, 4, 132)
    with pytest.raises(ValueError):
        plan.split_plan(1, 1, 0, 132)


@pytest.mark.parametrize("Tp,want", [(16, 16), (8, 8), (64, 16), (24, 12),
                                     (17, 1), (1, 1)])
def test_tile_tokens_divides_the_page(Tp, want):
    assert plan.tile_tokens(Tp) == want


def _split_and_combine(q, pk, pv, kt, vt, lengths, starts, sms):
    """The kernel's arithmetic in plain torch, fp32."""
    B, K, G, hd = q.shape
    Tp, P = pk.shape[1], kt.shape[1]
    splits, cols = plan.split_plan(B, K, P, sms)
    tile = plan.tile_tokens(Tp)
    out = torch.empty(B, K, G, hd)
    for b in range(B):
        ln = min(int(lengths[b]), P * Tp)
        st = max(int(starts[b]), 0)
        empty = st >= ln
        for kh in range(K):
            parts = []
            for s in range(splits):
                c0, c1 = s * cols, min((s + 1) * cols, P)
                lo, hi = c0 * Tp, c1 * Tp
                if not empty:
                    lo, hi = max(lo, st), min(hi, ln)
                m = torch.full((G,), NEG_INF)
                l, acc = torch.zeros(G), torch.zeros(G, hd)
                for u in range(lo // tile, -(-hi // tile) if hi > lo else 0):
                    t = torch.arange(u * tile, (u + 1) * tile)
                    ok = (t >= lo) & (t < hi)
                    t = t[ok]                 # masked slots are never read
                    kr = pk[kt[b, t // Tp], t % Tp, kh].float()
                    vr = pv[vt[b, t // Tp], t % Tp, kh].float()
                    sc = (torch.zeros(G, len(t)) if empty
                          else q[b, kh].float() @ kr.T * hd ** -0.5)
                    m_new = torch.maximum(m, sc.max(1).values)
                    p = torch.exp(sc - m_new[:, None])
                    alpha = torch.exp(m - m_new)
                    l = l * alpha + p.sum(1)
                    acc = acc * alpha[:, None] + p @ vr
                    m = m_new
                parts.append((m, l, acc))
            if splits == 1:
                out[b, kh] = acc / torch.clamp(l, min=1e-30)[:, None]
                continue
            M = torch.stack([p[0] for p in parts]).max(0).values
            L, A = torch.zeros(G), torch.zeros(G, hd)
            for m, l, acc in parts:
                w = torch.exp(m - M)
                L, A = L + w * l, A + w[:, None] * acc
            out[b, kh] = A / torch.clamp(L, min=1e-30)[:, None]
    return out


# (B, K, G, hd, Tp, P, SM count, lengths, starts): empty ranges (a zero
# length, starts == lengths, starts past the table), lengths past the
# table, windows that leave whole splits without a token, and a page size
# cut into tiles
CASES = {
    "mixed-ranges": (5, 2, 3, 32, 8, 6, 16, [0, 53, 37, 20, 48],
                     [0, 3, 30, 20, 60]),
    "one-long-sequence": (1, 1, 4, 64, 16, 12, 132, [190], [0]),
    "windows": (3, 1, 4, 64, 16, 9, 24, [144, 100, 17], [130, 60, 0]),
    "tiles-per-page": (2, 2, 2, 16, 24, 5, 40, [119, 61], [7, 0]),
    "one-split": (4, 1, 4, 64, 16, 1, 132, [8, 9, 16, 3], [0, 0, 9, 3]),
    "all-empty": (2, 1, 2, 32, 8, 4, 16, [0, 5], [0, 5]),
}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", sorted(CASES))
def test_split_and_combine_matches_reference(case, seed):
    B, K, G, hd, Tp, P, sms, lens, sts = CASES[case]
    rng = np.random.default_rng(seed)
    F = B * P + 3
    q = rng.standard_normal((B, K, G, hd)).astype(np.float32)
    pk = rng.standard_normal((F, Tp, K, hd)).astype(np.float32)
    pv = rng.standard_normal((F, Tp, K, hd)).astype(np.float32)
    kt = rng.integers(0, F, (B, P)).astype(np.int32)
    vt = rng.integers(0, F, (B, P)).astype(np.int32)
    lengths = np.array(lens, np.int32)
    starts = np.array(sts, np.int32)
    got = _split_and_combine(*(torch.from_numpy(a) for a in
                               (q, pk, pv, kt, vt, lengths, starts)), sms)
    want = jpa_ref(*(jnp.asarray(a) for a in (q, pk, pv, kt, lengths)),
                   starts=jnp.asarray(starts), v_page_table=jnp.asarray(vt))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    splits, _ = plan.split_plan(B, K, P, sms)
    assert (splits > 1) == (case != "one-split")
