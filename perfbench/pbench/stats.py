"""The arithmetic of the benchmark's readings: percentiles over every
sample, the union of device intervals, spreads."""

from __future__ import annotations

import math
import statistics


def percentile(values, q: float) -> float:
    """The q-th percentile (0..100) of every value, by linear
    interpolation between order statistics (numpy's default)."""
    xs = sorted(float(v) for v in values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def frame_latencies_ms(steps) -> list[float]:
    """One latency per frame: every frame of a step waits from the step's
    start to its end (steps: (start s, end s, frames))."""
    out = []
    for start, end, n in steps:
        out.extend([(end - start) * 1e3] * n)
    return out


def union_seconds(intervals) -> float:
    """Length of the union of (start, end) intervals, in their unit."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals, lo: float, hi: float) -> list[tuple]:
    """The (start, end) stretches of [lo, hi] that no interval covers."""
    out, cur = [], lo
    for s, e in sorted(intervals):
        if s > cur:
            out.append((cur, min(s, hi)))
        cur = max(cur, e)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(s, e) for s, e in out if e > s]


def spread(values) -> float:
    """Distance between the first and third quartiles as a share of the
    median (`statistics.quantiles(values, n=4)`)."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med
