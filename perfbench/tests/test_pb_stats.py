"""The arithmetic of the readings: frame_ms_p95 over every frame, the idle
share over the union of device intervals, the frozen bounds."""

import pytest

from pbench import bounds, stats


def test_p95_is_over_every_frame_not_over_steps():
    # eight fast 8-frame groups and one slow 2-frame window step
    steps = [(i * 0.01, i * 0.01 + 0.01, 8) for i in range(8)] + [(0.08, 0.12, 2)]
    lat = stats.frame_latencies_ms(steps)
    assert len(lat) == 66
    # 2 of 66 frames are slow: under 5%, so the p95 is a fast frame's
    assert stats.percentile(lat, 95) == pytest.approx(10.0)
    # per step the slow one is 1 of 9 (11%): a p95 over steps would read it
    per_step = [(e - s) * 1e3 for s, e, _ in steps]
    assert stats.percentile(per_step, 95) > 25.0
    # 6 slow frames of 70: the p95 is a slow frame's
    lat2 = stats.frame_latencies_ms(steps + [(0.12, 0.16, 2), (0.16, 0.20, 2)])
    assert stats.percentile(lat2, 95) == pytest.approx(40.0)


def test_percentile_interpolates_like_numpy():
    np = pytest.importorskip("numpy")
    xs = [3.0, 1.0, 4.0, 1.5, 9.0, 2.6, 5.0]
    for q in (0, 5, 50, 95, 100):
        assert stats.percentile(xs, q) == pytest.approx(float(np.percentile(xs, q)))


def test_idle_share_takes_the_union_of_intervals():
    ivals = [(0.0, 2.0), (1.0, 3.0), (2.5, 2.8), (5.0, 6.0)]
    assert stats.union_seconds(ivals) == pytest.approx(4.0)
    # the sum of durations over-counts the overlaps
    assert sum(e - s for s, e in ivals) == pytest.approx(5.3)
    assert stats.gaps(ivals, 0.0, 10.0) == [(3.0, 5.0), (6.0, 10.0)]


def test_spread_is_the_quartile_distance_over_the_median():
    assert stats.spread([1.0, 2.0, 3.0, 4.0, 5.0]) == pytest.approx(3.0 / 3.0)


def test_adam_bytes_of_the_main_path_row():
    # PERF.md section 6: window_adam_cuda over 1,933,324 elements at a
    # 32,768-row opt prefix, SH degree 3 (54.1 MB at 28 B an element)
    assert bounds.gaussian_row_elements(3) == 59
    assert bounds.adam_elements(32768, 3) == 1_933_324
    assert bounds.adam_bytes(32768, 3) == 54_133_072
    t, by = bounds.bound_s(bounds.adam_bytes(32768, 3))
    assert by == "bytes" and t * 1e3 == pytest.approx(0.01616, rel=1e-3)
    assert bounds.roofline_pct(bounds.adam_bytes(32768, 3), 0.02778e-3) == pytest.approx(
        100 * 0.016159 / 0.02778, rel=1e-3)
    assert bounds.roofline_pct(1.0, 0.0) is None
