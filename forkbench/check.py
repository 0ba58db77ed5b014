"""The comparisons that decide ``correct``, made once the window has
closed, against the plain reference (``forkbench/reference``) on the
weights the benchmark made.

- ``fork_mismatch``: the elements of a child's materialized tree whose
  bits differ from the benchmark's weights (a leaf missing or of another
  shape counts whole).  A fork copies bytes, so the limit is 0.
- ``logit_err_p90``: at every served position (the prompt's last, then
  each decode step), the program's logits against the reference's over
  the same prompt and served tokens, as ``|p - r| / |r|`` (Euclidean
  norms of the row); the 90th percentile over the rows of the answers
  checked.  Not the widest row: where two experts' router scores tie to
  rounding, either side may route a token to the other one, which moves
  that row by tens of percent in a sound run; such rows are few, and a
  fault or a lower precision moves most rows.  The widest is reported
  beside it (``logit_err_max``).
- ``served_gap``: how far each served token's logit lies below the
  reference's best at its position; the widest.  Greedy tokens that the
  reference agrees with read 0; a token altered after its logits were
  made reads far above.

The control (``control_answers``) puts a lower-precision reference in
the program's place: at the same served positions of the same prompts
and tokens, its logits, and as its tokens the ones it puts first.  It is
judged by the same ``measure`` and ``judge`` as the program.
"""
from __future__ import annotations

import statistics
from typing import List, Sequence, Tuple

import torch

from forkbench.weights import flat

# (prompt, served tokens, the program's logits at the served positions:
# (len(served), V), row i the logits that served token i was chosen from)
Answer = Tuple[List[int], List[int], torch.Tensor]


def fork_mismatch(tree, w) -> int:
    got, want = dict(flat(tree)), dict(flat(w))
    bad = 0
    for name, t in want.items():
        g = got.get(name)
        if g is None or tuple(g.shape) != tuple(t.shape) or g.dtype != t.dtype:
            bad += t.numel()
            continue
        a = g.contiguous().view(torch.int32)
        b = t.to(g.device).contiguous().view(torch.int32)
        bad += int((a != b).sum())
    return bad + sum(t.numel() for n, t in got.items() if n not in want)


def reference_rows(ref, answers: Sequence[Answer]) -> List[torch.Tensor]:
    """The reference's logits at each answer's served positions."""
    return [ref.logits(prompt, served)[len(prompt) - 1:]
            for prompt, served, _ in answers]


def measure(want: Sequence[torch.Tensor], answers: Sequence[Answer]) -> dict:
    """``logit_err_p90`` (``logit_err_max`` beside it) and ``served_gap``
    of ``answers`` against the reference's rows ``want``
    (``reference_rows``)."""
    errs: List[float] = []
    gap = 0.0
    off = 0
    for r, (_, served, rows) in zip(want, answers):
        p = rows.to(r.device, torch.float32)
        if p.shape != r.shape:
            inf = float("inf")
            return {"logit_err_p90": inf, "logit_err_max": inf,
                    "served_gap": inf, "off_best": len(served),
                    "tokens": len(served)}
        errs += ((p - r).norm(dim=-1) / r.norm(dim=-1)).tolist()
        toks = torch.tensor(served, device=r.device)[:, None]
        g = r.max(-1).values - r.gather(1, toks)[:, 0]
        gap = max(gap, float(g.max()))
        off += int((g > 0).sum())
    p90 = (statistics.quantiles(errs, n=10, method="inclusive")[-1]
           if len(errs) >= 2
           else max(errs, default=float("inf")))
    return {"logit_err_p90": p90, "logit_err_max": max(errs, default=0.0),
            "served_gap": gap, "off_best": off, "tokens": len(errs)}


def control_answers(control, answers: Sequence[Answer]) -> List[Answer]:
    """The answers a lower-precision reference would give in the
    program's place, at the same positions of the same tokens."""
    out = []
    for prompt, served, _ in answers:
        rows = control.logits(prompt, served)[len(prompt) - 1:]
        out.append((prompt, rows.argmax(-1).tolist(), rows))
    return out


def judge(values: dict, limits: dict) -> Tuple[bool, dict]:
    """Each compared number beside its limit, and whether every one keeps
    to it (``fork_mismatch`` read -1 when there was no tree to read)."""
    checks = {k: {"value": values[k], "limit": limits[k]} for k in limits}
    ok = all(0 <= c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
