"""Rate and percentile arithmetic over a window that holds a stall."""
from __future__ import annotations

import statistics

import pytest

from chipbench import stats


def window_with_stall():
    """Ten units of 1 s from t = 0, the sixth stalled 5 s before it
    started: 10 units end at 15 s."""
    units, t = [], 0.0
    for i in range(10):
        if i == 5:
            t += 5.0
        units.append({"start": t, "first": t + 0.2, "end": t + 1.0,
                      "tokens": 100, "requests": 4})
        t += 1.0
    return units


def test_rate_counts_the_stall():
    units = window_with_stall()
    r = stats.rate(sum(u["tokens"] for u in units), 0.0,
                   [u["end"] for u in units])
    assert r == pytest.approx(1000 / 15.0)
    # a median of per-unit rates would not see it
    assert statistics.median(u["tokens"] / (u["end"] - u["start"])
                             for u in units) == 100


def test_rate_of_nothing():
    assert stats.rate(0, 0.0, []) is None


@pytest.mark.parametrize("values,q,want", [
    (list(range(1, 101)), 95, 95),
    (list(range(1, 101)), 50, 50),
    ([5.0], 95, 5.0),
    ([3, 1, 2], 100, 3),
    ([1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
      200], 95, 19),
    ([1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
      200], 96, 200),
])
def test_nearest_rank_percentile(values, q, want):
    assert stats.percentile(values, q) == want


def test_tail_of_every_request():
    """A stalled call's requests are in the tail: 4 requests a call."""
    units = window_with_stall()
    units[7]["first"] = units[7]["start"] + 3.0
    ttft = [u["first"] - u["start"] for u in units
            for _ in range(u["requests"])]
    assert stats.percentile(ttft, 95) == pytest.approx(3.0)

