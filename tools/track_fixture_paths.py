#!/usr/bin/env python
"""Tracked runs of tests/test_tracking.py's fixture (160x120, 16 frames,
look="in", arc=0.025, 2 cm voxels) through every tracked path of the JAX
package and through the port, on the CPU:

    JAX_PLATFORMS=cpu python tools/track_fixture_paths.py

JAX paths: the XLA raycast or the TPU kernels' branch (Pallas in interpret
mode, as tests/test_torch_slice.py runs it), each on the one-dispatch
tracked megastep (which inverts the reference pose analytically) and on
the eager per-frame path (ICPTracker.track, np.linalg.inv); the port
(the TPU kernels' semantics) on its tracked megastep (the reference pose
inverted on the device) and on its eager route.  Prints, per
path, the ATE (cm), the last pose's translation (cm) and rotation (deg)
errors and the GOOD count.  About four minutes, most of it the kernel
branch in interpret mode.
"""

from __future__ import annotations

import os
import sys
import tempfile
import time

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "tests"))

W, H, N, ARC = 160, 120, 16, 0.025


def config_dict(cams, ws):
    from gps_slam_tpu.data import synthetic

    c = cams[0]
    node = {"input_dir": "mem", "image_path": "c", "pose_path": "c", "depth_path": "d",
            "pcd_name": "n", "depth_scale": 6553.5, "scene_scale": 1.0,
            "start_frame": 0, "end_frame": N - 1, "frame_step": 1,
            "intrinsics": [c.fx, c.fy, c.cx, c.cy], "image_shape": [W, H],
            "downscale_factor": 1, "test_split_interval": -1}
    d = synthetic.default_config_dict(ws, node)
    d["PIPE"]["TSDF"]["use_gt_pose"] = False
    os.makedirs(ws, exist_ok=True)
    return d


def report(name, poses, quality, cams, seconds):
    from gps_slam_torch.eval import metrics

    gt = [c.c2w for c in cams]
    est = [np.asarray(p) for p in poses]
    t_err = np.linalg.norm(est[-1][:3, 3] - gt[-1][:3, 3]) * 100
    R = est[-1][:3, :3].T @ gt[-1][:3, :3]
    ang = np.degrees(np.arccos(np.clip((np.trace(R) - 1) / 2, -1, 1)))
    good = sum(q == 2 for q in quality[1:])
    print(f"{name:28s} ate_cm {metrics.ate_rmse_cm(est, gt):.3f}  last_cm {t_err:.3f}  "
          f"last_deg {ang:.3f}  GOOD {good}/{N - 1}  ({seconds:.0f} s)", flush=True)


def run_jax(cams, d, kernel_branch: bool, megastep: bool):
    import jax.numpy as jnp

    from gps_slam_tpu.config import Config
    from gps_slam_tpu.slam.tracker import ICPTracker
    from gps_slam_tpu.tsdf.engine import TsdfEngine

    with pytest.MonkeyPatch.context() as mp:
        if kernel_branch:
            from test_torch_slice import _jax_on_kernel_branch

            _jax_on_kernel_branch(mp)
        if not megastep:
            mp.setattr(TsdfEngine, "_can_fast_track", lambda self: False)
        cfg = Config.from_dict(d)
        e = TsdfEngine(cfg, W, H, cams[0].K)
        e.set_gt_poses([cams[0].c2w])
        e.attach_tracker(ICPTracker(cfg, W, H))
        q = []
        for c in cams:
            e.process_frame(jnp.asarray(c.image), jnp.asarray(c.depth))
            q.append(e._tracking_quality)
    return e.cam_poses, q


def run_port(cams, d, megastep: bool):
    from gps_slam_torch.config import Config
    from gps_slam_torch.slam.tracker import ICPTracker
    from gps_slam_torch.tsdf.engine import TsdfEngine

    cfg = Config.from_dict(d)
    e = TsdfEngine(cfg, W, H, cams[0].K, device="cpu")
    if not megastep:
        e._can_fast_track = lambda: False
    e.set_gt_poses([cams[0].c2w])
    e.attach_tracker(ICPTracker(cfg, W, H))
    q = []
    for c in cams:
        e.process_frame(c.image, c.depth)
        q.append(e._tracking_quality)
    return e.cam_poses, q


def main() -> int:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    from gps_slam_tpu.data import synthetic

    cams = synthetic.make_cameras(n_frames=N, width=W, height=H, look="in", arc=ARC)
    with tempfile.TemporaryDirectory() as tmp:
        d = config_dict(cams, os.path.join(tmp, "ws"))
        for name, fn in (
                ("jax xla, megastep", lambda: run_jax(cams, d, False, True)),
                ("jax xla, eager", lambda: run_jax(cams, d, False, False)),
                ("jax kernels, megastep", lambda: run_jax(cams, d, True, True)),
                ("jax kernels, eager", lambda: run_jax(cams, d, True, False)),
                ("port, megastep", lambda: run_port(cams, d, True)),
                ("port, eager", lambda: run_port(cams, d, False))):
            t0 = time.monotonic()
            poses, q = fn()
            report(name, poses, q, cams, time.monotonic() - t0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
