#!/usr/bin/env python
"""Time a replayed window megastep on the card, on a given tree of the
port, and count its graph's kernel nodes per Adam step, so that two trees
can be compared in one call.

    python tools/window_step_time.py [--root DIR] [--replays 10] [--out FILE]

Imports `gps_slam_torch` and `chip_smoke` from `--root` (default: this
repository), drives `chip_smoke.py`'s main path (30 frames of the outward
arc at 1200x680, bench_config, 20 Adam steps a window: the bootstrap
window eager, the second a megastep), then draws one more window of that
state (`SLAMPipeline._megastep_window`) and runs it through a fresh
`WindowGraphs`: one capture, then `--replays` replays of the same graph on
the same inputs (the pool moves on with each).  Each replay (the copy of
its inputs and the graph's launch) is timed by the host clock,
synchronised, and by CUDA events.  The same window with half the
steps is captured once more and replayed as often: the difference of
the two graphs' node counts, and of their replays' median device ms,
over the steps between them is what one Adam step adds.  Prints one JSON
line: the card, the replays' ms (median, mean, least, most), the graphs'
nodes, the nodes and device ms per step, the window's key and the
kernels' launches; with `--breakdown` also the device kernels one Adam
step adds, by name (the window profiled uncaptured at both step
counts).  Card only: exits 2 without CUDA.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--replays", type=int, default=10)
    ap.add_argument("--out", default=None, help="also write the JSON line here")
    ap.add_argument("--breakdown", action="store_true",
                    help="also profile the window uncaptured at both step counts and "
                         "give the device kernels one Adam step adds, by name")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("window_step_time: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from gps_slam_torch import kernels
    from gps_slam_torch.slam import megastep as ms

    cams = cs.synthetic_cams(cs.N_FRAMES, 1200, 680)
    extras: dict = {}
    _, engine, model = cs.run_path(SimpleNamespace(seed=0, profile=False), cams, cs.ADAM_STEPS,
                                   "window step time: main path", kernels.INTEGRATE,
                                   extras=extras)
    pipe = extras["pipe"]
    key, inputs, statics = pipe._megastep_window(model)
    vol, pool = engine.vol, model.pool
    steps = int(inputs["iter_cam_idx"].shape[0])
    kernels.reset_counts()
    graphs = ms.WindowGraphs()
    graphs.run(key, vol, pool, inputs, **statics)
    host, device = [], []
    for _ in range(args.replays):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t = time.monotonic()
        a.record()
        graphs.run(key, vol, pool, inputs, **statics)
        b.record()
        torch.cuda.synchronize()
        host.append((time.monotonic() - t) * 1e3)
        device.append(a.elapsed_time(b))
    launches = kernels.counts()
    for name, n in graphs.replayed_launches.items():
        launches[name] += n
    half = steps // 2
    graphs2 = ms.WindowGraphs()
    key2 = (key[0], half, *key[2:])
    inputs2 = dict(inputs, iter_cam_idx=inputs["iter_cam_idx"][:half])
    graphs2.run(key2, vol, pool, inputs2, **statics)
    device2 = []
    for _ in range(args.replays):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graphs2.run(key2, vol, pool, inputs2, **statics)
        b.record()
        torch.cuda.synchronize()
        device2.append(a.elapsed_time(b))
    nodes, nodes2 = graphs.node_counts[0]["nodes"], graphs2.node_counts[0]["nodes"]
    breakdown = None
    if args.breakdown:
        breakdown = step_kernels(ms, vol, pool, inputs, statics, steps, half)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    spread = lambda x: {"median": float(np.median(x)), "mean": float(np.mean(x)),  # noqa: E731
                        "min": float(np.min(x)), "max": float(np.max(x)), "n": len(x)}
    out = {"root": str(Path(args.root).resolve()), "card": smi, "steps": steps,
           "replay_host_ms": spread(host), "replay_device_ms": spread(device),
           "replay_device_ms_half_steps": spread(device2),
           # the device ms one Adam step adds to a replay (medians)
           "step_device_ms": (float(np.median(device)) - float(np.median(device2)))
                             / (steps - half),
           "graph_nodes": nodes, "graph_nodes_half_steps": nodes2,
           "window_nodes_per_step": (nodes - nodes2) / (steps - half),
           "key": {"M": key[0], "steps": key[1], "opt_cap": key[13]},
           "gaussians": int(pool.alive.sum().item()), "launches": launches,
           "step_kernels": breakdown}
    line = json.dumps(out)
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0


def step_kernels(ms, vol, pool, inputs, statics, steps: int, half: int) -> dict:
    """The window run uncaptured under torch.profiler with `steps` and with
    `half` Adam steps: the device kernels (and copies and sets) that one
    step adds, by name (cut to 90 characters), and their total."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    st = dict(statics)
    K = st.pop("K")
    counts = {}
    for n in (steps, half):
        ms.hoist_constants(st["mcfg"], st["sc"], n, pool.device)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            ms.window_megastep(vol, pool, inputs["poses"], K, torch.stack(inputs["gt_rgb"]),
                               inputs["iter_cam_idx"][:n], inputs["spawn_noise"], **st)
            torch.cuda.synchronize()
        c: dict = {}
        for e in prof.key_averages():
            if e.device_type.name == "CUDA":
                c[e.key[:90]] = c.get(e.key[:90], 0) + e.count
        counts[n] = c
    per = {k: (counts[steps].get(k, 0) - counts[half].get(k, 0)) / (steps - half)
           for k in set(counts[steps]) | set(counts[half])}
    per = {k: v for k, v in sorted(per.items(), key=lambda kv: -kv[1]) if v}
    return {"per_step": per, "total_per_step": sum(per.values()),
            "window_total": {n: sum(c.values()) for n, c in counts.items()}}


if __name__ == "__main__":
    sys.exit(main())
