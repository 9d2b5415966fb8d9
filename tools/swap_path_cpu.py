#!/usr/bin/env python
"""The block dynamics of chip_smoke.py's swap path at a reduced frame size
on the CPU: gt-pose `train` mode with no Adam steps (fusion, the windows'
raycasts and spawns, the eval raycasts), bench.py's configuration on a
full outward turn with the block pool cut to 16,384 rows and swapping on
(check every 2 frames, waters 0.80 / 0.50), through the port's engine:

    python tools/swap_path_cpu.py [--width 300] [--height 170] [--jax-fill]

Prints the allocated count after each fusion, how many fusions found the
pool full (their new blocks dropped), and the spill and reload counts.
With --jax-fill the engine keeps the JAX package's rule: no spill before
a fusion that follows a swap-in which filled the pool.  Allocation and
the swap engine match the JAX package bit for bit, so that run shows the
JAX engine's counts.  About 30 s at 300x170.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import chip_smoke as cs  # noqa: E402
from gps_slam_torch.config import Config  # noqa: E402
from gps_slam_torch.data import synthetic  # noqa: E402
from gps_slam_torch.gs.model import GaussianModel  # noqa: E402
from gps_slam_torch.slam.pipeline import SLAMPipeline  # noqa: E402
from gps_slam_torch.tsdf import integrate as tint  # noqa: E402
from gps_slam_torch.tsdf.engine import TsdfEngine  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--width", type=int, default=300)
    ap.add_argument("--height", type=int, default=170)
    ap.add_argument("--jax-fill", action="store_true",
                    help="no spill before a fusion that follows a filling swap-in")
    args = ap.parse_args()
    W, H, N = args.width, args.height, cs.SWAP_FRAMES
    cams = synthetic.make_cameras(n_frames=N, width=W, height=H, look="out", arc=1.0)
    d = cs.bench_config(N, W, H, cams[0], 0)
    d["TPU"].update(cs.SWAP_TPU)
    with tempfile.TemporaryDirectory() as ws:
        d["workspace_dir"] = ws
        cfg = Config.from_dict(d)
        engine = TsdfEngine(cfg, W, H, cams[0].K, device="cpu")
        engine.set_gt_poses([c.c2w for c in cams])
        engine.turn_off_tracking()
        fused = []
        fuse, run_raycast = tint.fuse_frame, engine.run_raycast

        def counted(vol, *a, **kw):
            out = fuse(vol, *a, **kw)
            fused.append(vol.n_blocks)
            return out

        def raycast(*a, **kw):
            maps = run_raycast(*a, **kw)
            if args.jax_fill:
                engine.swap.over_high_water = False
            return maps

        tint.fuse_frame, engine.run_raycast = counted, raycast
        try:
            pipe = SLAMPipeline(cfg, engine, ws, is_train=False)
            pipe.slam_train_cams(GaussianModel(cfg, W, H, device="cpu"), cams)
            for _ in pipe.render_eval(GaussianModel(cfg, W, H, device="cpu"), cams[::6]):
                pass
        finally:
            tint.fuse_frame = fuse
    B = cfg.tpu.block_capacity
    print(f"{W}x{H}, {N} frames, {B} rows, jax fill: {args.jax_fill}")
    print("blocks after each fusion:", fused)
    print(f"fusions into a full pool: {sum(n == B for n in fused)} of {len(fused)}; "
          f"spilled {engine.swap.n_spilled_total}, reloaded {engine.swap.n_reloaded_total}")


if __name__ == "__main__":
    torch.set_num_threads(min(4, torch.get_num_threads()))
    main()
