"""device_idle_pct: the share of the profiled slice in which the device
had nothing to run, in %: 100 (1 - the union of the device's activity
intervals / the slice's wall time), both from the profiler's trace.  The
profiler slows this loop: it reads the idle share under tracing
(`device_idle_est_pct` carries the estimate for the untraced window)."""


def read(rec):
    t = rec.get("trace")
    if not t or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
