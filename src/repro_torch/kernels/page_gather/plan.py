"""Host-side plans of the run-table copies, in plain numpy.

``run_spans`` and ``scatter_spans`` are the byte plans the bulk-copy
kernel (``csrc/bulk_copy.cu``) executes for a run-table gather and a
run-table scatter: a run of contiguous frames is one contiguous span of
bytes on both sides, so the kernel moves spans, not pages.  Both copies
of up to the by-value capacity build the same plans in C from the host
runs (``bulk_copy.cu:runs_by_value``, a line-for-line mirror of both,
checked against the plain gather and scatter only on the card, by
``chip_smoke.py``); larger ones upload these functions' tables, and the
CPU tests hold them to the reference.  ``run_offsets`` gives the per-run
tables of the row-copy kernel (``csrc/paging.cu``), which takes the runs
whose rows or addresses are not 16-byte multiples.
"""
from __future__ import annotations

import numpy as np
import torch


def run_spans(starts, lens, row_bytes: int, limit_bytes: int):
    """Byte spans of the gather ``out[offs[i] + j] = frames[starts[i] + j]``
    for ``j < lens[i]`` (``offs`` the exclusive cumsum of ``lens``), with
    rows of ``row_bytes``: returns int64 arrays ``(src_off, dst_off,
    nbytes)``, one span per run of nonzero length, run-major.  Destination
    bytes at or past ``limit_bytes`` are dropped: the span that crosses it
    is trimmed, those past it are left out."""
    starts = np.asarray(starts, np.int64).reshape(-1)
    lens = np.asarray(lens, np.int64).reshape(-1)
    keep = lens > 0
    if not keep.all():
        starts, lens = starts[keep], lens[keep]
    nbytes = lens * row_bytes
    end = np.cumsum(nbytes)
    src, dst = starts * row_bytes, end - nbytes
    if end.size and end[-1] > limit_bytes:
        nbytes = np.minimum(nbytes, limit_bytes - dst)
        keep = nbytes > 0
        src, dst, nbytes = src[keep], dst[keep], nbytes[keep]
    return src, dst, nbytes


def scatter_spans(starts, lens, row_bytes: int, limit_bytes: int):
    """Byte spans of the scatter ``frames[starts[i] + j] = pages[offs[i] +
    j]`` for ``j < lens[i]`` (``offs`` the exclusive cumsum of ``lens``),
    with rows of ``row_bytes``: returns int64 arrays ``(src_off, dst_off,
    nbytes)``, one span per run of nonzero length, in run order, so that
    the spans tile the payload.  Destination bytes at or past
    ``limit_bytes`` are dropped: a span that crosses it is trimmed, those
    past it are left out."""
    starts = np.asarray(starts, np.int64).reshape(-1)
    lens = np.asarray(lens, np.int64).reshape(-1)
    nbytes = lens * row_bytes
    src, dst = np.cumsum(nbytes) - nbytes, starts * row_bytes
    nbytes = np.minimum(nbytes, limit_bytes - dst)
    keep = nbytes > 0
    if not keep.all():
        src, dst, nbytes = src[keep], dst[keep], nbytes[keep]
    return src, dst, nbytes


def run_offsets(starts, lens, device):
    """Device (starts, offs) int32 tables; offs = exclusive cumsum."""
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]])
    return (torch.from_numpy(starts.astype(np.int32)).to(device),
            torch.from_numpy(offs.astype(np.int32)).to(device))
