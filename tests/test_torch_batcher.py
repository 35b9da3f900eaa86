"""The port's continuous batcher (``repro_torch.serve.batcher``) against
the invariants of ``tests/test_batcher.py`` — slot and page-lease
accounting under churn, per-request outputs independent of co-batched
neighbours, deterministic replay — and against the JAX package's
batcher: equal greedy streams on its three fixed traces, on the same
weights. Sampled streams cannot match across the two RNGs, so only their
invariants are held. Also the offload round trip of
``tests/test_hetero.py:337``. The ``@given`` versions re-check the
invariants over random traces when hypothesis is installed."""
import dataclasses

import jax
import numpy as np
import pytest

from _hyp import given, settings, st
from _torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)
from repro.configs import get_config, smoke_variant
from repro.models.model_zoo import build_model as jax_build_model
from repro.serve import ContinuousBatcher as JaxBatcher
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_jax
from repro_torch.models.model_zoo import build_model
from repro_torch.serve import (
    ContinuousBatcher,
    PagePool,
    PagePoolError,
    Request,
    ServeEngine,
)
from repro_torch.serve.batcher import sample_seed

SLOTS, MAX_SEQ = 3, 32
PROMPT_LENS = (3, 4, 5)

_ENGINE = {}


def _engines():
    """(cfg, port engine, JAX engine) on the smoke qwen3-4b in f32, the
    JAX weights converted through numpy; shared."""
    if "eng" not in _ENGINE:
        cfg = dataclasses.replace(smoke_variant(get_config("qwen3-4b")), dtype="float32")
        tcfg = dataclasses.replace(tconfigs.smoke_variant(tconfigs.get_config("qwen3-4b")),
                                   dtype="float32")
        japi = jax_build_model(cfg)
        jparams = japi.init(jax.random.PRNGKey(0))
        jeng = JaxServeEngine(api=japi, batch_size=SLOTS, max_seq=MAX_SEQ)
        jeng.load(jparams)
        tapi = build_model(tcfg, device="cpu")
        eng = ServeEngine(tapi, batch_size=SLOTS, max_seq=MAX_SEQ, device="cpu")
        eng.load(params_from_jax(jax.tree.map(np.asarray, jparams), tcfg))
        _ENGINE["eng"] = (cfg, eng, jeng)
    return _ENGINE["eng"]


def _engine():
    cfg, eng, _ = _engines()
    return cfg, eng


def _trace(spec, seed=0, cls=Request):
    """Requests from (arrival, prompt_len_idx, max_new_tokens) triples,
    token ids seeded off the uid (``tests/test_batcher.py:_trace``)."""
    cfg, _ = _engine()
    rng = np.random.RandomState(seed)
    reqs = []
    for uid, (arrival, len_idx, new_toks) in enumerate(spec, start=1):
        s = PROMPT_LENS[len_idx % len(PROMPT_LENS)]
        rng.seed(seed * 1000 + uid)
        reqs.append(cls(
            uid=uid,
            prompt=rng.randint(0, cfg.vocab_size, size=s).astype(np.int32),
            max_new_tokens=1 + new_toks % 5,
            arrival=arrival,
        ))
    return reqs


TRACES = [
    [(0, 0, 3), (0, 1, 2), (0, 2, 4), (0, 0, 1)],
    [(0, 1, 4), (2, 2, 3), (4, 0, 2), (6, 1, 5), (8, 2, 1)],
    [(0, 0, 0), (0, 1, 0), (1, 2, 2), (1, 0, 3), (2, 1, 4), (3, 2, 3)],
]


def _check_invariants(bat):
    live = [s.uid for s in bat.slots if s.uid is not None]
    assert len(live) == len(set(live)), "slot aliasing: duplicate uid"
    leased = bat.pool.leased_pages()
    assert set(leased) == set(live), "lease lifetime != slot residency"
    pages = [p for ps in leased.values() for p in ps]
    assert len(pages) == len(set(pages)), "page aliasing across leases"
    assert bat.pool.available + len(pages) == bat.pool.n_pages


def _run_checked(bat, reqs):
    for r in reqs:
        bat.submit(r)
    while True:
        alive = bat.step()
        _check_invariants(bat)
        if not alive:
            break
    return dict(bat.results)


def _assert_trace_clean(reqs, results, pool):
    assert set(results) == {r.uid for r in reqs}
    for r in reqs:
        res = results[r.uid]
        assert len(res.tokens) == r.max_new_tokens
        assert res.submitted >= r.arrival
        assert res.admitted >= res.submitted
        assert res.finished >= res.first_token == res.admitted
    assert pool.available == pool.n_pages, "pages leaked"
    assert all(v == 1 for v in pool.freed_count.values()), "double free"
    assert set(pool.freed_count) == {r.uid for r in reqs}


# ---------------------------------------------------------------------------
# the page pool
# ---------------------------------------------------------------------------


def test_page_pool_accounting():
    pool = PagePool(n_pages=8, page_size=16)
    assert pool.pages_for(1) == 1 and pool.pages_for(16) == 1 and pool.pages_for(17) == 2
    a, b = pool.alloc(1, 3), pool.alloc(2, 2)
    assert len(set(a) | set(b)) == 5 and pool.available == 3
    with pytest.raises(PagePoolError):
        pool.alloc(1, 1)        # double lease
    with pytest.raises(PagePoolError):
        pool.alloc(3, 4)        # more than free
    pool.free(1)
    assert pool.available == 6
    with pytest.raises(PagePoolError):
        pool.free(1)            # double free
    with pytest.raises(PagePoolError):
        pool.free(99)           # unknown uid
    pool.free(2)
    assert pool.available == pool.n_pages and pool.freed_count == {1: 1, 2: 1}


def test_page_pool_host_tier():
    """``tests/test_hetero.py``'s two-tier cases: evict / lease back,
    the host capacity, finishing while parked."""
    pool = PagePool(4, 4, host_pages=4)
    pool.alloc(1, 2)
    assert pool.evict(1) == 2 and pool.available == 4 and pool.host_leased() == {1: 2}
    with pytest.raises(PagePoolError):
        pool.evict(1)           # already evicted
    with pytest.raises(PagePoolError):
        pool.alloc(1, 1)        # a parked uid still holds a lease
    assert len(pool.lease_back(1)) == 2 and pool.transfer_pages == {"out": 2, "in": 2}
    pool.evict(1)
    pool.free(1)                # finishing while parked releases the host lease
    assert pool.host_leased() == {} and pool.available == 4 and pool.freed_count == {1: 1}
    small = PagePool(4, 4, host_pages=1)
    small.alloc(9, 2)
    with pytest.raises(PagePoolError):
        small.evict(9)          # wants 2 host pages, only 1
    assert small.host_leased() == {} and small.available == 2


def test_oversized_request_raises():
    _, eng = _engine()
    bat = ContinuousBatcher(eng, page_size=4, n_pages=2)  # 8 token budget
    with pytest.raises(PagePoolError):
        bat.run(_trace([(0, 2, 4)]))  # 5 prompt + 5 new > 8


# ---------------------------------------------------------------------------
# fixed traces: slots, pages, independence, replay, the JAX batcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("trace_idx", range(len(TRACES)))
def test_slot_and_page_invariants_and_greedy_streams_match_jax(trace_idx):
    cfg, eng, jeng = _engines()
    reqs = _trace(TRACES[trace_idx], seed=trace_idx)
    bat = ContinuousBatcher(eng)
    results = _run_checked(bat, reqs)
    _assert_trace_clean(reqs, results, bat.pool)
    jres = JaxBatcher(jeng).run(_trace(TRACES[trace_idx], seed=trace_idx,
                                       cls=_jax_request))
    for r in reqs:
        np.testing.assert_array_equal(results[r.uid].tokens, jres[r.uid].tokens,
                                      err_msg=f"uid {r.uid}")
        assert dataclasses.astuple(results[r.uid])[2:] == dataclasses.astuple(jres[r.uid])[2:]


def _jax_request(**kw):
    from repro.serve import Request as JaxRequest

    return JaxRequest(**kw)


@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_outputs_independent_of_neighbors(temperature):
    """Each request's tokens match a solo run of it: the draws are keyed
    on (uid, pos), never on slot or step."""
    _, eng = _engine()
    reqs = _trace(TRACES[1], seed=7)
    co = ContinuousBatcher(eng, temperature=temperature).run(reqs)
    for r in reqs:
        solo = ContinuousBatcher(eng, temperature=temperature).run(
            [dataclasses.replace(r, arrival=0)])
        np.testing.assert_array_equal(co[r.uid].tokens, solo[r.uid].tokens,
                                      err_msg=f"uid {r.uid} depends on its neighbours")


@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_deterministic_replay(temperature):
    _, eng = _engine()
    reqs = _trace(TRACES[2], seed=3)
    a = ContinuousBatcher(eng, temperature=temperature).run(reqs)
    b = ContinuousBatcher(eng, temperature=temperature).run(reqs)
    assert set(a) == set(b)
    for uid in a:
        np.testing.assert_array_equal(a[uid].tokens, b[uid].tokens)
        assert dataclasses.astuple(a[uid])[2:] == dataclasses.astuple(b[uid])[2:]


def test_sample_seed_separates_requests_and_positions():
    seeds = {sample_seed(0, u, p) for u in range(8) for p in range(64)}
    assert len(seeds) == 8 * 64 and all(0 <= s < 2 ** 63 for s in seeds)
    assert sample_seed(1, 2, 3) == sample_seed(1, 2, 3) != sample_seed(2, 2, 3)


def test_page_pressure_head_of_line_waits():
    _, eng = _engine()
    reqs = _trace([(0, 0, 3), (0, 1, 3), (0, 2, 3), (1, 0, 2)], seed=11)
    bat = ContinuousBatcher(eng, page_size=MAX_SEQ // 2, n_pages=2)
    results = _run_checked(bat, reqs)
    _assert_trace_clean(reqs, results, bat.pool)
    admitted = {r.uid: results[r.uid].admitted for r in reqs}
    assert admitted[1] <= admitted[2] <= admitted[3]


def test_slots_recycle_under_churn():
    _, eng = _engine()
    reqs = _trace([(i // 2, i, 2 + i % 3) for i in range(SLOTS * 3)], seed=5)
    bat = ContinuousBatcher(eng)
    results = _run_checked(bat, reqs)
    _assert_trace_clean(reqs, results, bat.pool)
    assert len(results) == SLOTS * 3 > SLOTS


def test_duplicate_uid_rejected():
    _, eng = _engine()
    bat = ContinuousBatcher(eng)
    (req,) = _trace([(0, 0, 2)])
    bat.submit(req)
    with pytest.raises(ValueError):
        bat.submit(req)


def test_offload_round_trip_token_parity():
    """``tests/test_hetero.py:337``: 6 requests through 3 slots with 4
    device pages; head-of-line blocking forces page-outs, every evicted
    request leases back and emits the tokens it emits with unconstrained
    pages."""
    cfg, eng = _engine()
    rng = np.random.RandomState(7)

    def reqs():
        return [Request(uid=u, prompt=rng.randint(0, cfg.vocab_size, size=4).astype(np.int32),
                        max_new_tokens=4, arrival=0) for u in range(1, 7)]

    def drain(bat, rs):
        for r in rs:
            bat.submit(r)
        while bat.step():
            pass
        return {uid: list(res.tokens) for uid, res in bat.results.items()}

    rng.seed(7)
    ref = drain(ContinuousBatcher(eng, page_size=4), reqs())
    rng.seed(7)
    two = ContinuousBatcher(eng, page_size=4, n_pages=4, offload=True)
    assert drain(two, reqs()) == ref
    outs = [e for e in two.transfer_log if e[0] == "page_out"]
    ins = [e for e in two.transfer_log if e[0] == "page_in"]
    assert outs and ins and all(tag == "Transfer" for (_k, _u, tag) in two.transfer_log)
    assert two.pool.transfer_pages["out"] == two.pool.transfer_pages["in"]
    assert two.transfer_bytes > 0
    assert two.pool.available == two.pool.n_pages and two.pool.host_leased() == {}


# ---------------------------------------------------------------------------
# property versions (skip without hypothesis)
# ---------------------------------------------------------------------------

_triples = st.lists(
    st.tuples(st.integers(0, 6), st.integers(0, 2), st.integers(0, 4)),
    min_size=1, max_size=6,
)


@settings(max_examples=10, deadline=None)
@given(spec=_triples, seed=st.integers(0, 3))
def test_invariants_random_traces(spec, seed):
    _, eng = _engine()
    reqs = _trace(spec, seed=seed)
    bat = ContinuousBatcher(eng)
    results = _run_checked(bat, reqs)
    _assert_trace_clean(reqs, results, bat.pool)


@settings(max_examples=5, deadline=None)
@given(spec=_triples, seed=st.integers(0, 3))
def test_replay_random_traces(spec, seed):
    _, eng = _engine()
    reqs = _trace(spec, seed=seed)
    a = ContinuousBatcher(eng).run(reqs)
    b = ContinuousBatcher(eng).run(reqs)
    for uid in a:
        np.testing.assert_array_equal(a[uid].tokens, b[uid].tokens)
