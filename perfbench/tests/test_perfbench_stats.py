"""The frozen metric arithmetic on hand-made samples and intervals."""

import statistics

import pytest

from perfbench.core import stats


def test_rate_is_work_over_the_whole_window():
    assert stats.rate(300, 2.0) == 150.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


@pytest.mark.parametrize("q, want", [(0, 1.0), (50, 50.5), (95, 95.05),
                                     (100, 100.0)])
def test_percentile_interpolates_between_ranks(q, want):
    assert stats.percentile(range(1, 101), q) == pytest.approx(want)


def test_percentile_takes_every_sample():
    # one slow step in twenty sets the tail
    assert stats.percentile([10.0] * 19 + [100.0], 95) == pytest.approx(
        10.0 + 0.05 * 90.0)


def test_busy_counts_overlaps_once_and_clips_to_the_window():
    ivs = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0), (9.0, 12.0)]
    assert stats.busy(ivs, (0.0, 10.0)) == pytest.approx(5.0)
    assert stats.idle_pct(ivs, (0.0, 10.0)) == pytest.approx(50.0)


def test_gaps_are_the_uncovered_stretches():
    ivs = [(1.0, 2.0), (1.5, 3.0), (6.0, 7.0)]
    assert stats.gaps(ivs, (0.0, 8.0)) == [(0.0, 1.0), (3.0, 6.0),
                                           (7.0, 8.0)]
    assert stats.gaps([], (0.0, 1.0)) == [(0.0, 1.0)]


def test_idle_share_is_against_the_window_s_time_a_unit():
    # 60 ms busy a profiled step, 100 ms a step in the measured window
    assert stats.idle_share_pct(0.06, 0.1) == pytest.approx(40.0)
    assert stats.idle_share_pct(0.11, 0.1) == pytest.approx(-10.0)


def test_roofline_and_mfu():
    assert stats.roofline_pct(3.0, 6.0) == pytest.approx(50.0)
    # 1 TFLOP an image at 100 img/s on a 1000 TFLOP/s chip
    assert stats.mfu_pct(1e12, 100.0, 1e15) == pytest.approx(10.0)


def test_spread_rule_uses_python_quartiles():
    # the bound rule's spread: statistics.quantiles, not numpy's
    v = [100, 102, 98, 101, 99, 120]
    q = statistics.quantiles(v, n=4)
    assert (q[2] - q[0]) / statistics.median(v) == pytest.approx(
        (106.5 - 98.75) / 100.5)
