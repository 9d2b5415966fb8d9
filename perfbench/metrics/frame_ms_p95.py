"""frame_ms_p95: the 95th percentile over every frame of the window of
its latency, from the start of the pipeline step that takes the frame to
the end of that step (the window it triggers included)."""

from pbench import stats


def read(rec):
    lat = stats.frame_latencies_ms(rec["window"]["steps"])
    return stats.percentile(lat, 95.0) if lat else None
