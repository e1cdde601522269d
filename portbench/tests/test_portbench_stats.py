"""The end-to-end arithmetic: rates over whole windows, percentiles over
every request, the spread, and the reservoir sample."""

import pytest

from portbench import stats
from portbench.sample import Reservoir


def test_rate_counts_all_work_over_all_time():
    assert stats.rate(4096 * 10, 0.25) == pytest.approx(163840.0)
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_p95_over_all_requests_with_a_stall():
    # 99 requests of 25 ms and one stalled for 2 s: the stall sits above
    # the 95th percentile of 100 requests, which stays 25 ms, and the
    # window's rate pays for it in full.
    lat = [0.025] * 99 + [2.0]
    assert stats.percentile(lat, 95) == pytest.approx(0.025)
    window = sum(lat)
    assert stats.rate(4096 * len(lat), window) == pytest.approx(
        4096 * 100 / 4.475)
    # Six stalls of 100: the 95th percentile is a stalled request.
    lat = [0.025] * 94 + [2.0] * 6
    assert stats.percentile(lat, 95) == pytest.approx(2.0)


@pytest.mark.parametrize("values,pct,want", [
    ([1.0, 2.0, 3.0, 4.0, 5.0], 50, 3.0),
    ([1.0, 2.0, 3.0, 4.0, 5.0], 95, 4.8),
    ([7.0], 95, 7.0),
])
def test_percentile_inclusive(values, pct, want):
    assert stats.percentile(values, pct) == pytest.approx(want)


def test_percentile_of_nothing():
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def test_reservoir_is_uniform_and_seeded():
    counts = [0] * 20
    for seed in range(400):
        r = Reservoir(4, seed)
        for i in range(20):
            r.offer(i)
        for i in r.kept:
            counts[i] += 1
    # 1,600 kept items over 20 positions: 80 each on average.
    assert min(counts) > 45 and max(counts) < 120
    a, b = Reservoir(3, 7), Reservoir(3, 7)
    for i in range(50):
        a.offer(i)
        b.offer(i)
    assert a.kept == b.kept and len(a.kept) == 3
