"""The profiled slice: torch.profiler over a bounded stretch of steps,
reduced to device intervals, kernel time by name, idle gaps and the
breakdown the result line carries."""

from __future__ import annotations

import bisect
from collections import defaultdict

from . import stats


def start():
    """A profiler of the device's activity alone: tracing the host's
    operations too would slow the host, which holds this program back,
    several times over."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    # a CPU-only build traces no device: the slice then reads no device event
    act = ProfilerActivity.CUDA if torch.cuda.is_available() else ProfilerActivity.CPU
    prof = profile(activities=[act], record_shapes=False,
                   with_stack=False, profile_memory=False)
    prof.start()
    return prof


def reduce(prof, window_s: float) -> dict:
    """The slice's device activity: `busy_s` (the union of every device
    event's interval), `kernels` {name: [seconds, count]}, the breakdown's
    `device_ops` and `idle_gaps` (each gap named by the device work that
    ends it: what the host was preparing while the device waited)."""
    from torch.autograd import DeviceType

    dev = []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            dev.append((e.time_range.start * 1e-6, e.time_range.end * 1e-6, e.name))
    kern = defaultdict(lambda: [0.0, 0])
    for s, t, name in dev:
        kern[name][0] += t - s
        kern[name][1] += 1
    ivals = [(s, t) for s, t, _ in dev]
    busy = stats.union_seconds(ivals)
    out = {"busy_s": busy, "window_s": window_s, "kernels": dict(kern), "events": len(dev)}
    top = sorted(kern.items(), key=lambda kv: kv[1][0], reverse=True)[:10]
    out["device_ops"] = [[name[:120], v[0]] for name, v in top]
    out["idle_gaps"] = []
    if ivals:
        dev.sort()
        starts = [s for s, _, _ in dev]
        g = sorted(stats.gaps(ivals, starts[0], max(t for _, t in ivals)),
                   key=lambda x: x[1] - x[0], reverse=True)[:10]
        for gs, ge in g:
            nxt = dev[bisect.bisect_left(starts, ge)][2] if ge <= starts[-1] else "the end"
            out["idle_gaps"].append([f"host, before {nxt}"[:120], ge - gs])
    return out
