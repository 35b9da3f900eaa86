"""Traffic: deterministic per seed, one multiset of sizes for every seed,
residual first lengths."""
from collections import Counter

import numpy as np

from perfbench.core import traffic
from perfbench.core.bench import HERE, load_json

CHAT = load_json(HERE / "traffic" / "chat.json")
RAG = load_json(HERE / "traffic" / "rag.json")


def draw(t, seed, n):
    loop = traffic.ClosedLoop(t, seed, 151936)
    return [loop.next() for _ in range(n)]


def test_same_seed_same_requests():
    a, b = draw(CHAT, 2 ** 40 + 3, 80), draw(CHAT, 2 ** 40 + 3, 80)
    for (ua, pa, oa), (ub, pb, ob) in zip(a, b):
        assert ua == ub and oa == ob and np.array_equal(pa, pb)


def test_seeds_share_the_sizes_in_another_order():
    n = CHAT["pool"] + CHAT["slots"]
    a, b = draw(CHAT, 1, n), draw(CHAT, 2 ** 33 + 9, n)
    sizes = lambda reqs: Counter((len(p), o) for _, p, o in reqs)  # noqa: E731
    assert sizes(a) == sizes(b)
    assert [len(p) for _, p, _ in a] != [len(p) for _, p, _ in b]
    clients = CHAT["slots"]
    assert sizes(a[:clients]) == sizes(b[:clients])



def test_order_seed_fixes_the_order_for_every_seed():
    n = RAG["slots"] + 200
    a, b = draw(RAG, 1, n), draw(RAG, 2 ** 33 + 9, n)
    assert [(len(p), o) for _, p, o in a] == [(len(p), o) for _, p, o in b]
    assert not np.array_equal(a[20][1], b[20][1])
    other = draw(dict(RAG, order_seed=2), 1, n)
    assert [(len(p), o) for _, p, o in other] != [(len(p), o) for _, p, o in a]
    assert "order_seed" not in CHAT

def test_lengths_clipped_and_quantiles():
    for t in (CHAT, RAG):
        for name in ("prompt", "output"):
            q = traffic.quantiles(t[name], 500)
            assert min(q) >= t[name]["min"] and max(q) <= t[name]["max"]
            assert q == sorted(q)
    q = traffic.quantiles(CHAT["prompt"], 1001)
    assert abs(q[500] - CHAT["prompt"]["median"]) <= 1


def test_first_requests_are_length_biased_residuals():
    pool = traffic.pool(CHAT)
    first = traffic.in_flight(pool, 64, 1)
    outs = {o for _, o in pool}
    mean_out = sum(o for _, o in pool) / len(pool)
    # caught in flight: longer than the pool's requests on average, cut to what remains
    full = []
    for plen, rest in first:
        cands = [o for p, o in pool if p == plen and o >= rest]
        assert cands and 2 <= rest
        full.append(min(cands))
    assert sum(full) / len(full) > mean_out
    assert all(o in outs for o in full)
    loop = traffic.ClosedLoop(CHAT, 5, 1000)
    got = sorted((len(p), o) for _, p, o in (loop.next() for _ in range(64)))
    assert got == sorted(first)
    uid, prompt, out = loop.next()
    assert (len(prompt), out) == pool[loop.order[0]]


def test_token_ids_in_vocab_and_seeded():
    loop = traffic.ClosedLoop(CHAT, 2 ** 31 + 17, 1000)
    ids = loop.tokens(3, 4000)
    assert ids.min() >= 0 and ids.max() < 1000
    assert not np.array_equal(ids, traffic.ClosedLoop(CHAT, 2 ** 31 + 18, 1000).tokens(3, 4000))
