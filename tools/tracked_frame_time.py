#!/usr/bin/env python
"""Time the tracked frame on both tracked routes on the card, on a given
tree of the port, so that two trees can be compared in one call.

    python tools/tracked_frame_time.py [--root DIR] [--frames 30] [--profile 5] [--out FILE]

Imports `gps_slam_torch` and `chip_smoke` from `--root` (default: this
repository) and drives `chip_smoke.py`'s tracked path without its
Gaussian windows: 1200x680 frames of the inward orbit at TRACKED_ARC,
bench_config's TSDF settings with the tracked path's visible cap, the ICP
tracker, frame 0 at its gt pose, every later frame tracked, fused and
followed by its tracking-prepare raycast.  The frames run twice, on a
fresh engine each time: on the tracked megastep (one CUDA graph a frame,
captured on the first tracked frame and replayed) and on the eager route
(`_can_fast_track` off).  Each frame's `engine.process_frame` is timed
(synchronised before and after), on the eager route also the ICP alone,
on the megastep each replay.  With `--profile N` the last N frames of
each route run again under torch.profiler, and the Gauss-Newton kernels'
device time (kernels named gn_*, and the WHILE nodes' set_condition
where a tree has them) is summed per frame beside the frame's device
total.  Prints one JSON line: the card, per route the frame ms (median,
mean, least, most, first), the replay ms and the graph's nodes (all and
conditional), the Gauss-Newton device ms a frame, the ICP iterations per
level, the kernels' launches (a replay's counted as its capture's) and
the ATE.  Card only: exits 2 without CUDA.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--profile", type=int, default=5,
                    help="frames of each route traced at the end (0: none)")
    ap.add_argument("--out", default=None, help="also write the JSON line here")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("tracked_frame_time: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from gps_slam_torch import kernels
    from gps_slam_torch.config import Config
    from gps_slam_torch.eval import metrics
    from gps_slam_torch.slam.tracker import make_tracker
    from gps_slam_torch.tsdf.engine import TsdfEngine

    W, H, n = 1200, 680, args.frames
    cams = cs.synthetic_cams(n, W, H, look="in", arc=cs.TRACKED_ARC)
    d = cs.bench_config(n, W, H, cams[0], 0)
    d["PIPE"]["TSDF"]["use_gt_pose"] = False
    d["TPU"]["visible_block_capacity"] = cs.TRACKED_VISIBLE_CAP
    cfg = Config.from_dict(d)

    def spread(ms: list) -> dict:
        return {"median": float(np.median(ms)), "mean": float(np.mean(ms)),
                "min": float(np.min(ms)), "max": float(np.max(ms)), "first": ms[0],
                "n": len(ms)}

    def gn_device_ms(prof) -> tuple[float, float]:
        """The Gauss-Newton kernels' device ms and all kernels' device ms."""
        gn = total = 0.0
        for e in prof.key_averages():
            t = getattr(e, "self_device_time_total", 0.0) / 1e3
            if getattr(e, "device_type", None) is not None and "CUDA" not in str(e.device_type):
                continue
            total += t
            if e.key.startswith("gn_") or "gn_level" in e.key or "gn_iter" in e.key \
                    or "set_condition" in e.key:
                gn += t
        return gn, total

    def route(fast: bool) -> dict:
        from torch.profiler import ProfilerActivity, profile

        engine = TsdfEngine(cfg, W, H, cams[0].K, device="cuda")
        engine.set_gt_poses([cams[0].c2w])
        tracker = make_tracker(cfg, W, H)
        engine.attach_tracker(tracker)
        if not fast:
            engine._can_fast_track = lambda: False
        graphs = engine._track_graphs
        frame_ms, track_ms, replay_ms, iters = [], [], [], []
        track = tracker.track

        def timed_track(*a, **kw):
            torch.cuda.synchronize()
            t = time.monotonic()
            out = track(*a, **kw)
            torch.cuda.synchronize()
            track_ms.append((time.monotonic() - t) * 1e3)
            return out

        tracker.track = timed_track
        if graphs is not None:
            run = graphs.run

            def timed_run(*a, **kw):
                torch.cuda.synchronize()
                t = time.monotonic()
                out = run(*a, **kw)
                torch.cuda.synchronize()
                if graphs.last[1] == "replay":
                    replay_ms.append((time.monotonic() - t) * 1e3)
                return out

            graphs.run = timed_run
        kernels.reset_counts()
        n_prof = min(args.profile, n - 2)
        gn_ms, dev_ms = [], []
        for k, c in enumerate(cams):
            traced = n_prof > 0 and k >= n - n_prof
            if traced:
                prof = profile(activities=[ProfilerActivity.CUDA])
                prof.__enter__()
            torch.cuda.synchronize()
            t = time.monotonic()
            engine.process_frame(c.image, c.depth)
            torch.cuda.synchronize()
            ms = (time.monotonic() - t) * 1e3
            if traced:
                prof.__exit__(None, None, None)
                g, tot = gn_device_ms(prof)
                gn_ms.append(g)
                dev_ms.append(tot)
            elif k > 0:
                frame_ms.append(ms)
            if k > 0:
                iters.append(list(tracker.last_iters))
        launches = kernels.counts()
        out = {"route": "megastep" if graphs is not None and graphs.captures else "eager",
               # untraced tracked frames (the megastep's first holds the capture)
               "tracked_frame_ms": spread(frame_ms),
               "icp_ms_per_frame": spread(track_ms) if track_ms else None,
               "gn_iters_mean_per_level": [float(v) for v in np.mean(iters, 0)],
               "gn_iters_total": int(np.sum(iters)),
               "gn_device_ms_per_frame": spread(gn_ms) if gn_ms else None,
               "device_ms_per_frame": spread(dev_ms) if dev_ms else None,
               "launches": launches,
               "ate_cm": metrics.ate_rmse_cm(engine.cam_poses, [c.c2w for c in cams])}
        if graphs is not None and graphs.captures:
            out.update(replay_ms=spread(replay_ms), captures=graphs.captures,
                       replays=graphs.replays, graph_nodes=graphs.node_counts,
                       replayed_launches=dict(graphs.replayed_launches))
        return out

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    kernels.build_all()
    res = {"root": str(Path(args.root).resolve()), "card": smi, "frames": n,
           "megastep": route(True), "eager": route(False)}
    line = json.dumps(res)
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
