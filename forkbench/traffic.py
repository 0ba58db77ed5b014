"""The one traffic generator.  A traffic mix is a JSON file of parameters
(``forkbench/traffic/<mix>.json``); this module turns it and a seed into
the run's requests.

Every seed gets the same set of sizes and arrivals, in its own order, so
that seeds change which tokens and which order, not how much work:

- prompt lengths are the lognormal's quantiles at ``(i + 0.5) / n``
  (``median``, ``sigma``), rounded and clipped to ``[min, max]``; output
  lengths are evenly spread over ``[min, max]``; the two are paired by a
  fixed permutation, and the pairs ordered by one drawn from the seed;
- a closed loop repeats a set of ``cycle`` requests, each repetition in a
  new order; an open loop sends ``round(0.98 * rate * seconds)`` requests,
  every one due inside the window, ``1 / rate`` apart;
- token ids are uniform over the vocabulary, drawn from the seed.
"""
from __future__ import annotations

import dataclasses
import math
from statistics import NormalDist
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class Request:
    prompt: List[int]
    max_tokens: int
    due: Optional[float] = None      # seconds after the window opens


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % 2 ** 63, stream])


def sizes(mix: dict, n: int, rng) -> List[tuple]:
    """``n`` (prompt length, output length) pairs: the stratified set,
    paired the same way for every seed, in an order drawn from ``rng``."""
    p, o = mix["prompt"], mix["output"]
    lens = []
    for i in range(n):
        z = NormalDist().inv_cdf((i + 0.5) / n)
        lens.append(int(min(max(round(p["median"] * math.exp(p["sigma"] * z)),
                                p["min"]), p["max"])))
    span = o["max"] - o["min"] + 1
    outs = [o["min"] + (i * span) // n for i in range(n)]
    outs = [outs[j] for j in np.random.default_rng(n).permutation(n)]
    return [(lens[j], outs[j]) for j in rng.permutation(n)]


def _prompt(rng, length: int, vocab: int) -> List[int]:
    return rng.integers(0, vocab, size=length).tolist()


def warmup(mix: dict, vocab: int, seed: int) -> List[Request]:
    rng = _rng(seed, 1)
    return [Request(_prompt(rng, P, vocab), n) for P, n in mix["warmup"]]


class Closed:
    """A closed loop's requests, made as the loop reaches them: repeats of
    the stratified set of ``cycle`` sizes, each repeat in a new order."""

    def __init__(self, mix: dict, vocab: int, rng):
        self.mix, self.vocab, self.rng = mix, vocab, rng
        self.made: List[Request] = []

    def __getitem__(self, i: int) -> Request:
        while len(self.made) <= i:
            self.made += [Request(_prompt(self.rng, P, self.vocab), n)
                          for P, n in sizes(self.mix, self.mix["cycle"],
                                            self.rng)]
        return self.made[i]

    def __iter__(self):
        i = 0
        while True:
            yield self[i]
            i += 1


def window(mix: dict, vocab: int, seed: int, seconds: float) -> List[Request]:
    """The requests of the measured window, in the order they are sent."""
    rng = _rng(seed, 2)
    if mix["loop"] == "closed":
        return Closed(mix, vocab, rng)
    if mix["loop"] != "open":
        raise ValueError(f"loop must be closed or open, got {mix['loop']!r}")
    rate = float(mix["rate"])
    n = max(1, round(0.98 * rate * seconds))
    return [Request(_prompt(rng, P, vocab), k, j / rate)
            for j, (P, k) in enumerate(sizes(mix, n, rng))]
