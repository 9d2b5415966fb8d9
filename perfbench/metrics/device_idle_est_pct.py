"""device_idle_est_pct: an estimate of the share of the timed window in
which the device had nothing to run, in %: 100 (1 - the union of the
device's activity intervals per frame of the profiled slice x the
window's frames / the window's seconds).  The slice gives the device
time a frame; the window, which runs without the profiler, the wall time
a frame.  It assumes the slice's frames cost the device what the
window's did (the same orbit, the same graphs); a negative reading says
they did not.  `device_idle_pct` is the slice's own reading."""


def read(rec):
    t, w = rec.get("trace"), rec["window"]
    if not t or not t["frames"] or not w["frames"] or w["seconds"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["frames"] * w["frames"] / w["seconds"])
