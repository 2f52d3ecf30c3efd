"""The window's statistics and the trace's interval arithmetic."""

import pytest

from bench_gpu import core


def test_percentile_is_nearest_rank_over_all_values():
    values = list(range(1, 101))
    assert core.percentile(values, 95) == 95
    assert core.percentile(values, 100) == 100
    assert core.percentile([7.0], 95) == 7.0
    with pytest.raises(ValueError):
        core.percentile([], 95)


def test_rate_is_over_the_whole_window_and_p95_over_all_steps():
    steady = [0.04] * 100
    rate, p95 = core.window_metrics(steady, 8, 4.0)
    assert rate == pytest.approx(200.0)
    assert p95 == pytest.approx(40.0)
    # A stall: ten steps of the window wait 60 ms more. The window is
    # the same length, so fewer steps end inside it.
    stalled = [0.04] * 75 + [0.1] * 10
    rate_s, p95_s = core.window_metrics(stalled, 8, 4.0)
    assert rate_s < rate
    assert p95_s == pytest.approx(100.0)


def test_union_of_overlapping_intervals_and_gaps():
    intervals = [(0, 2), (1, 3), (5, 6), (5.5, 7), (10, 12)]
    assert core.merge_intervals(intervals) == [(0, 3), (5, 7), (10, 12)]
    assert core.union_length(intervals, 0, 11) == pytest.approx(6.0)
    assert core.gaps(intervals, -1, 11) == [(-1, 0), (3, 5), (7, 10)]
    assert core.union_length([], 0, 1) == 0
    assert core.gaps([], 0, 1) == [(0, 1)]
    # Nested intervals count once.
    assert core.union_length([(0, 10), (2, 3), (4, 5)], 0, 10) == 10
