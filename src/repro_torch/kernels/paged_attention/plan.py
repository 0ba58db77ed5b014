"""Split plan of the paged_attention kernel (``csrc/paged_attention.cu``),
from shapes alone: the wrapper never reads ``lengths`` back, which would
synchronise.

Each (sequence, kv head) is cut into ``splits`` contiguous ranges of
``cols`` page-table columns (the last may be shorter), one block each, so
that ``B * K * splits`` is about :data:`BLOCKS_PER_SM` blocks per SM
however few sequences a batch holds (two blocks of the kernel fit on an
SM).  A block holds its columns of the page tables in shared memory, so
``cols`` is at most :data:`MAX_COLS`.  Tokens move in
tiles of ``tile`` slots, a divisor of the page size of at most
:data:`MAX_TILE`, so a tile never crosses a page.
"""
from __future__ import annotations

BLOCKS_PER_SM = 2
MAX_COLS = 256     # page-table columns of one block (csrc: kMaxCols)
MAX_TILE = 16      # tokens of one stage of the ring (csrc: kMaxTile)


def split_plan(B: int, K: int, P: int, sm_count: int):
    """-> (splits, cols): ``splits`` blocks per (sequence, kv head), block
    ``s`` taking page-table columns ``[s * cols, min((s + 1) * cols, P))``;
    every block gets at least one column, and ``P = 1`` gives one split."""
    if min(B, K, P, sm_count) < 1:
        raise ValueError(f"split_plan needs B, K, P and sm_count >= 1, got "
                         f"{(B, K, P, sm_count)}")
    want = -(-BLOCKS_PER_SM * sm_count // (B * K))    # blocks per (b, k)
    splits = min(P, max(want, -(-P // MAX_COLS)))
    cols = -(-P // splits)
    return -(-P // cols), cols


def tile_tokens(Tp: int) -> int:
    """Tokens per stage: the largest divisor of the page size ``Tp`` that
    is at most :data:`MAX_TILE`."""
    return next(t for t in range(min(Tp, MAX_TILE), 0, -1) if Tp % t == 0)
