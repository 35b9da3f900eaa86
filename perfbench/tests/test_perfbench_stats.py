"""The window arithmetic of each end-to-end metric on synthetic times."""

import pytest

from perfbench.core import stats


def test_rate_counts_steps_that_end_in_the_window():
    ends = [(9.5, 64), (10.2, 64), (10.7, 65), (11.4, 64), (12.1, 64)]
    # window [10, 12]: steps ending at 10.2, 10.7, 11.4; time to the last of them
    assert stats.rate(ends, 10.0, 12.0) == pytest.approx((64 + 65 + 64) / 1.4)
    assert stats.rate(ends, 20.0, 30.0) is None


def test_ttft_and_tpot_take_the_window():
    reqs = {
        0: {"submit": 9.0, "first": 9.5, "finish": 10.5, "tokens": 11},   # first before
        1: {"submit": 10.0, "first": 10.25, "finish": 11.25, "tokens": 5},
        2: {"submit": 11.0, "first": 11.5},                                 # in flight
        3: {"submit": 11.5, "first": 12.5, "finish": 12.6, "tokens": 1},   # after close
    }
    assert sorted(stats.ttfts(reqs, 10.0, 12.0)) == [0.25, 0.5]
    # request 0 finished in the window: (10.5 - 9.5) / 10; request 1: 1.0 / 4
    assert sorted(stats.tpots(reqs, 10.0, 12.0)) == pytest.approx([0.1, 0.25])


def test_p90_and_the_count_beyond_it():
    xs = list(range(1, 101))
    p = stats.percentile(xs, 90)
    assert p == pytest.approx(90.1)
    assert stats.beyond(xs, p) == 10
    assert stats.percentile([5.0], 90) == 5.0

