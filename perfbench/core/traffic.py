"""One general generator of serving traffic, read from a traffic file.

Lengths: a pool of ``pool`` requests whose prompt and output lengths are
the distribution's quantiles at ``(i + 0.5) / pool`` (clipped, whole
numbers, not rounded to any multiple), the outputs paired with the prompts
by a permutation fixed by the file's ``pairing_seed``. Every seed thus
sees the same multiset of sizes; the run's seed only orders the pool and
draws the token ids, uniform over the vocabulary.

Closed loop: ``clients`` clients each keep one request in flight. The
clients' first requests stand for requests caught in flight: their sizes
are the length-biased quantiles of the pool (a request in flight is
likelier a long one) and their outputs are cut to residuals (at evenly
spaced shares of what remains), so the window opens near steady state
and not with every client starting together. These too are the same for
every seed, in the seed's order.

A file with ``order_seed`` fixes the order too, for every run: the run's
seed then draws only the token ids (and the weights). Where a tail is set
by which requests meet at admission, the order is the work: one seed run
twice reads alike while two seeds do not.
"""
from __future__ import annotations

import random
import statistics
from typing import Any, Dict, List, Tuple

import numpy as np


def quantiles(spec: Dict[str, Any], n: int) -> List[int]:
    lo, hi = spec["min"], spec["max"]
    us = [(i + 0.5) / n for i in range(n)]
    if spec["dist"] == "uniform":
        vals = [lo + u * (hi - lo + 1) for u in us]
    elif spec["dist"] == "lognormal":
        nd = statistics.NormalDist(0.0, spec["sigma"])
        vals = [spec["median"] * float(np.exp(nd.inv_cdf(u))) for u in us]
    else:
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    return [int(min(hi, max(lo, int(v)))) for v in vals]


def pool(traffic: Dict[str, Any]) -> List[Tuple[int, int]]:
    """The (prompt length, output length) pairs every seed shares."""
    n = traffic["pool"]
    prompts = quantiles(traffic["prompt"], n)
    outputs = quantiles(traffic["output"], n)
    random.Random(traffic["pairing_seed"]).shuffle(outputs)
    return list(zip(prompts, outputs))


def in_flight(sizes: List[Tuple[int, int]], n: int, pairing_seed: int) -> List[Tuple[int, int]]:
    """``n`` requests caught in flight: pool entries at the quantiles
    ``(i + 0.5) / n`` of the output-length-biased pool, each with its
    output cut to a residual ``2 + floor(u (L - 1))``, the shares ``u`` at
    ``(i + 0.5) / n`` paired by a fixed permutation."""
    by_out = sorted(sizes, key=lambda s: s[1])
    total = sum(o for _, o in by_out)
    picks, acc, j = [], 0, 0
    for i in range(n):
        target = (i + 0.5) / n * total
        while acc + by_out[j][1] < target:
            acc += by_out[j][1]
            j += 1
        picks.append(by_out[j])
    shares = [(i + 0.5) / n for i in range(n)]
    random.Random(pairing_seed).shuffle(shares)
    return [(p, 2 + int(u * (o - 1))) for (p, o), u in zip(picks, shares)]


class ClosedLoop:
    """The requests of one run, in the order its seed (or the file's
    ``order_seed``) gives."""

    def __init__(self, traffic: Dict[str, Any], seed: int, vocab: int):
        self.seed, self.vocab = int(seed), vocab
        self.sizes = pool(traffic)
        order_seed = traffic.get("order_seed", self.seed)
        self.order = list(range(len(self.sizes)))
        random.Random(order_seed).shuffle(self.order)
        self.clients = traffic["slots"]
        self.first = in_flight(self.sizes, self.clients, traffic["pairing_seed"])
        random.Random(order_seed + 1).shuffle(self.first)
        self.issued = 0

    def tokens(self, uid: int, n: int) -> np.ndarray:
        rng = np.random.default_rng([self.seed & (2 ** 63 - 1), uid])
        return rng.integers(0, self.vocab, size=n, dtype=np.int64).astype(np.int32)

    def next(self) -> Tuple[int, np.ndarray, int]:
        """The next request: (uid, prompt token ids, output length)."""
        uid = self.issued
        self.issued += 1
        if uid < self.clients:
            plen, out = self.first[uid]
        else:
            plen, out = self.sizes[self.order[(uid - self.clients) % len(self.order)]]
        return uid, self.tokens(uid, plen), out
