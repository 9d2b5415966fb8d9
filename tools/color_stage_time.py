#!/usr/bin/env python
"""Time the colour stage of the composite tracker on the card, on a given
tree of the port, so that two trees can be compared in one call.

    python tools/color_stage_time.py [--root DIR] [--frames 30] [--out FILE]

Imports `gps_slam_torch` and `chip_smoke` from `--root` (default: this
repository) and drives `chip_smoke.py`'s colour tracked path without its
Gaussian windows: 1200x680 frames of the inward orbit at TRACKED_ARC,
bench_config's TSDF settings with the tracked path's visible cap,
PIPE.TSDF.tracker.type composite, frame 0 at its gt pose, every later
frame tracked (colour refine, then ICP, eager), fused, and the next
tracking-prepare raycast run with colour.  Each frame's colour stage is
timed apart (synchronised before and after): its pyramid, Sobel and
Gauss-Newton levels.  Prints one JSON line: the card, the colour stage's
ms per frame (median, mean, least, most, first), its iterations per
level, labels, inlier shares and residuals, ICP's iterations, the
trajectory's ATE and last-pose error, and the kernels' launches.  Card
only: exits 2 without CUDA.
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
    ap.add_argument("--out", default=None, help="also write the JSON line here")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("color_stage_time: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from gps_slam_torch import kernels
    from gps_slam_torch.config import Config
    from gps_slam_torch.eval import metrics
    from gps_slam_torch.slam.tracker import ColorTracker, make_tracker
    from gps_slam_torch.tsdf.engine import TsdfEngine

    W, H, n = 1200, 680, args.frames
    cams = cs.synthetic_cams(n, W, H, look="in", arc=cs.TRACKED_ARC)
    d = cs.bench_config(n, W, H, cams[0], 0)
    d["PIPE"]["TSDF"]["use_gt_pose"] = False
    d["PIPE"]["TSDF"]["tracker"] = {"type": "composite"}
    d["TPU"]["visible_block_capacity"] = cs.TRACKED_VISIBLE_CAP
    cfg = Config.from_dict(d)
    engine = TsdfEngine(cfg, W, H, cams[0].K, device="cuda")
    engine.set_gt_poses([cams[0].c2w])
    tracker = make_tracker(cfg, W, H)
    color = next(t for t in tracker.trackers if isinstance(t, ColorTracker))
    icp = tracker.trackers[-1]
    log = {"ms": [], "quality": [], "inlier": [], "residual": [], "iters": [], "icp_iters": []}
    color_track, comp_track = color.track, tracker.track

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t = time.monotonic()
        pose, q = color_track(*a, **kw)
        torch.cuda.synchronize()
        log["ms"].append((time.monotonic() - t) * 1e3)
        log["quality"].append(int(q))
        log["inlier"].append(color.last_inlier)
        log["residual"].append(color.last_residual)
        log["iters"].append(list(color.last_iters))
        return pose, q

    def composite(*a, **kw):
        out = comp_track(*a, **kw)
        log["icp_iters"].append(list(icp.last_iters))
        return out

    color.track, tracker.track = timed, composite
    engine.attach_tracker(tracker)
    kernels.reset_counts()
    t0 = time.monotonic()
    for c in cams:
        engine.process_frame(c.image, c.depth)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    est, gt = engine.cam_poses, [c.c2w for c in cams]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    ms = log["ms"]
    out = {"root": str(Path(args.root).resolve()), "card": smi, "frames": n,
           "color_stage_ms_per_frame": {"median": float(np.median(ms)),
                                        "mean": float(np.mean(ms)), "min": float(np.min(ms)),
                                        "max": float(np.max(ms)), "first": ms[0],
                                        "n": len(ms)},
           "color_stage_ms_total": float(np.sum(ms)), "loop_s": wall,
           "color_iters_per_frame": log["iters"],
           "color_iters_total": int(np.sum(log["iters"])),
           "color_quality": log["quality"], "color_inlier": log["inlier"],
           "color_residual": log["residual"], "icp_iters_per_frame": log["icp_iters"],
           "ate_cm": metrics.ate_rmse_cm(est, gt),
           "last_translation_err_cm": float(np.linalg.norm(est[-1][:3, 3] - gt[-1][:3, 3])
                                            * 100),
           "launches": kernels.counts()}
    line = json.dumps(out)
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
