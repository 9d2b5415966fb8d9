#!/usr/bin/env python
"""Tracked runs and prepare-raycast maps of tests/test_tracking.py's
fixture (160x120, 16 frames, look="in", 2 cm voxels; arc 0.025 unless
--arc says otherwise; --stress: its noisy 32-frame fixture, arc 0.05,
depth noise of 5 mm and 10% dropout from default_rng(7)), through the JAX
package and through the port, on the CPU:

    JAX_PLATFORMS=cpu python tools/track_fixture_paths.py [--arc A] [--stress]
        [--what runs,split,points,maps] [--threads N]

`runs`: the JAX package's four tracked paths (the XLA raycast or the TPU
kernels' branch, Pallas in interpret mode as tests/test_torch_slice.py
runs it, each on the one-dispatch tracked megastep and on the eager
per-frame path) and the port's two routes (the tracked megastep and the
eager route, both on the march's tracking mode).  `split`: the JAX eager
kernel branch with one kernel each: the Pallas raycast with the XLA
fusion, then the Pallas packed integrate with the XLA raycast.  `points`:
the port's two routes with the tracking-prepare march switched point by
point (raycast_tiles.TRACK: none of the XLA march's points is the TPU
kernel's semantics; then each point alone; then all) at k 1 and k 2
picks, all but one point at k 2, and no point at k 4 and 8.  Each run
prints the ATE (cm), the last pose's translation (cm) and rotation (deg)
errors, the GOOD and FAILED counts.  `maps`: after 6 gt-pose fusions (the JAX XLA fusion; the
port reads the same volume through convert.volume_from_numpy) the maps
of frame 5's pose from the JAX Pallas march (interpret mode, k 1 and 2),
the port's march with each set of points and the tracking mode, each
against the JAX XLA march (k 2): hits in the XLA map only, in the other
only, and over the common hits the mean and p99 vertex distance (mm).

Times on one CPU thread: runs ~5 min (the kernel branch in interpret
mode ~2 min of it), split ~3 min, points ~12 min, maps ~1 min.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "tests"))

W, H = 160, 120
POINTS = ("pixel_rank", "pixel_cand", "two_stage")


def fixture(arc: float, stress: bool):
    """(cameras, depth of frame i) of the plain or the noisy fixture."""
    from gps_slam_tpu.data import synthetic

    n = 32 if stress else 16
    cams = synthetic.make_cameras(n_frames=n, width=W, height=H, look="in",
                                  arc=0.05 if stress else arc)
    if not stress:
        return cams, [c.depth for c in cams]
    rng = np.random.default_rng(7)
    depths = []
    for c in cams:   # tests/test_tracking.py's `noisy`, frame by frame
        d = np.asarray(c.depth).copy()
        d += rng.normal(0.0, 0.005, d.shape).astype(np.float32)
        d[rng.random(d.shape) < 0.10] = 0.0
        depths.append(np.maximum(d, 0.0))
    return cams, depths


def config_dict(cams, ws):
    from gps_slam_tpu.data import synthetic

    c = cams[0]
    node = {"input_dir": "mem", "image_path": "c", "pose_path": "c", "depth_path": "d",
            "pcd_name": "n", "depth_scale": 6553.5, "scene_scale": 1.0,
            "start_frame": 0, "end_frame": len(cams) - 1, "frame_step": 1,
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
    failed = sum(q == 0 for q in quality[1:])
    n = len(cams) - 1
    print(f"{name:40s} ate_cm {metrics.ate_rmse_cm(est, gt):.3f}  last_cm {t_err:.3f}  "
          f"last_deg {ang:.3f}  GOOD {good}/{n}  FAILED {failed}/{n}  ({seconds:.0f} s)",
          flush=True)


def jax_xla_raycast(mp):
    """The JAX engine's raycasts on its XLA march, its fusion left on the
    packed integrate kernel (tests/test_torch_tracking.py's helper)."""
    from test_torch_tracking import _jax_on_xla_raycast

    _jax_on_xla_raycast(mp)


def jax_xla_fusion(mp):
    """The JAX engine's fusion on its XLA branch, its raycast left alone."""
    from gps_slam_tpu.tsdf import integrate as jint

    fuse = jint.fuse_frame

    def xla(*a, **k):   # use_pallas is the engine's 7th positional argument
        return fuse(*a[:6], False, *a[7:], **k)

    mp.setattr(jint, "fuse_frame", xla)


def run_jax(cams, depths, d, kernel_branch: bool, megastep: bool, split=None):
    import jax.numpy as jnp

    from gps_slam_tpu.config import Config
    from gps_slam_tpu.slam.tracker import ICPTracker
    from gps_slam_tpu.tsdf.engine import TsdfEngine

    with pytest.MonkeyPatch.context() as mp:
        if kernel_branch:
            from test_torch_slice import _jax_on_kernel_branch

            _jax_on_kernel_branch(mp)
            if split is not None:
                split(mp)
        if not megastep:
            mp.setattr(TsdfEngine, "_can_fast_track", lambda self: False)
        cfg = Config.from_dict(d)
        e = TsdfEngine(cfg, W, H, cams[0].K)
        e.set_gt_poses([cams[0].c2w])
        e.attach_tracker(ICPTracker(cfg, W, H))
        q = []
        for c, dep in zip(cams, depths):
            e.process_frame(jnp.asarray(c.image), jnp.asarray(dep))
            q.append(e._tracking_quality)
    return e.cam_poses, q


def run_port(cams, depths, d, megastep: bool, points=None, k=None):
    """The port's route; `points` / `k` replace the tracking mode's XLA
    points and its pick count for this run."""
    from gps_slam_torch.config import Config
    from gps_slam_torch.slam.tracker import ICPTracker
    from gps_slam_torch.tsdf import raycast_tiles as trc
    from gps_slam_torch.tsdf.engine import TsdfEngine

    with pytest.MonkeyPatch.context() as mp:
        if points is not None:
            mp.setattr(trc, "TRACK", frozenset(points))
        if k is not None:
            mp.setattr(trc, "TRACK_K_BLOCKS", k)
        cfg = Config.from_dict(d)
        e = TsdfEngine(cfg, W, H, cams[0].K, device="cpu")
        if not megastep:
            e._can_fast_track = lambda: False
        e.set_gt_poses([cams[0].c2w])
        e.attach_tracker(ICPTracker(cfg, W, H))
        q = []
        for c, dep in zip(cams, depths):
            e.process_frame(c.image, dep)
            q.append(e._tracking_quality)
    return e.cam_poses, q


def point_sets():
    """(label, points, k) of the `points` runs and maps."""
    out = []
    for k in (1, 2):
        out.append((f"none, k {k}", (), k))
        out += [(f"{p}, k {k}", (p,), k) for p in POINTS]
        out.append((f"all (the tracking mode), k {k}", POINTS, k))
    out += [(f"all but {p}, k 2", tuple(q for q in POINTS if q != p), 2) for p in POINTS]
    out += [(f"none, k {k}", (), k) for k in (4, 8)]
    return out


def compare_maps(name, ref, other, vox):
    """Hit masks and vertex distances of `other` against `ref` (numpy
    depth [H, W] and vertex [H, W, 3] maps)."""
    (d0, v0), (d1, v1) = ref, other
    h0, h1 = d0 > 0, d1 > 0
    both = h0 & h1
    dist = np.linalg.norm(v0[both] - v1[both], axis=-1) * 1000
    print(f"{name:40s} hits {int(h1.sum()):5d}  xla only {int((h0 & ~h1).sum()):4d}  "
          f"other only {int((h1 & ~h0).sum()):4d}  xor share "
          f"{np.mean(h0 != h1):.4f}  vertex mm mean {dist.mean():.3f}  "
          f"p99 {np.percentile(dist, 99):.3f}  max {dist.max():.3f}  "
          f"(past a voxel: {int((dist > vox * 1000).sum())})", flush=True)


def maps(cams, d, frame=5):
    import jax.numpy as jnp

    from gps_slam_tpu.config import Config as JConfig
    from gps_slam_tpu.tsdf import raycast_pallas as rcp
    from gps_slam_tpu.tsdf import raycast_tiles as jrt
    from gps_slam_tpu.tsdf.engine import TsdfEngine as JEngine
    from gps_slam_torch import convert
    from gps_slam_torch.config import Config
    from gps_slam_torch.tsdf import raycast_tiles as trc
    from gps_slam_torch.tsdf.engine import TsdfEngine

    je = JEngine(JConfig.from_dict(d), W, H, cams[0].K)
    je.set_gt_poses([c.c2w for c in cams])
    je.turn_off_tracking()
    for c in cams[:frame + 1]:
        je.process_frame(jnp.asarray(c.image), jnp.asarray(c.depth))
    te = TsdfEngine(Config.from_dict(d), W, H, cams[0].K, device="cpu")
    arrays = {k: np.asarray(getattr(je.vol, k)) for k in
              ("table_keys", "table_ptrs", "block_coords", "state", "color",
               "summary", "n_blocks", "last_seen")}
    tv = convert.volume_from_numpy(arrays, te.params, "cpu")
    p, cam = je.vol.params, cams[frame]
    lb, s_c, s_r = p.raycast_lb, p.raycast_samples, max(p.raycast_bisect, 3)
    c2w, K = jnp.asarray(cam.c2w), jnp.asarray(cam.K)

    def dv(m):
        return (np.asarray(m["depth_map"])[..., 0], np.asarray(m["vertex_map"]))

    ref = dv(jrt.raycast(je.vol, c2w, K, W, H, lb, s_c, s_r, p.raycast_chunk, 2))
    print(f"maps of frame {frame} after {frame + 1} gt-pose fusions, "
          f"against the JAX XLA march (k 2, {int((ref[0] > 0).sum())} hits):")
    for k in (1, 2):
        compare_maps(f"jax pallas (interpret), k {k}", ref,
                     dv(rcp.raycast(je.vol, c2w, K, W, H, lb, s_c, s_r, k, 4,
                                    interpret=True, need_color=False)), p.voxel_size)
    for label, points, k in point_sets():
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(trc, "TRACK", frozenset(points))
            m = trc.raycast(tv, cam.c2w, cam.K, W, H, lb, s_c, s_r, k,
                            need_color=False, track=True)
        compare_maps(f"port, {label}", ref, (m["depth_map"].numpy()[..., 0],
                                             m["vertex_map"].numpy()), p.voxel_size)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arc", type=float, default=0.025)
    ap.add_argument("--stress", action="store_true")
    ap.add_argument("--what", default="runs,split,maps")
    ap.add_argument("--threads", type=int, default=1)
    args = ap.parse_args()
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import torch

    torch.set_num_threads(args.threads)
    what = set(args.what.split(","))
    cams, depths = fixture(args.arc, args.stress)
    print(f"fixture: {len(cams)} frames, arc {0.05 if args.stress else args.arc}"
          f"{', noisy' if args.stress else ''}", flush=True)
    runs = []
    if "runs" in what:
        runs += [
            ("jax xla, megastep", lambda: run_jax(cams, depths, d, False, True)),
            ("jax xla, eager", lambda: run_jax(cams, depths, d, False, False)),
            ("jax kernels, megastep", lambda: run_jax(cams, depths, d, True, True)),
            ("jax kernels, eager", lambda: run_jax(cams, depths, d, True, False)),
            ("port, megastep", lambda: run_port(cams, depths, d, True)),
            ("port, eager", lambda: run_port(cams, depths, d, False))]
    if "split" in what:
        runs += [
            ("jax kernels, eager, xla fusion",
             lambda: run_jax(cams, depths, d, True, False, jax_xla_fusion)),
            ("jax kernels, eager, xla raycast",
             lambda: run_jax(cams, depths, d, True, False, jax_xla_raycast))]
    if "points" in what:
        for label, points, k in point_sets():
            for route, mega in (("megastep", True), ("eager", False)):
                runs.append((f"port {route}, {label}",
                             lambda points=points, k=k, mega=mega:
                             run_port(cams, depths, d, mega, points, k)))
    with tempfile.TemporaryDirectory() as tmp:
        d = config_dict(cams, os.path.join(tmp, "ws"))
        for name, fn in runs:
            t0 = time.monotonic()
            poses, q = fn()
            report(name, poses, q, cams, time.monotonic() - t0)
        if "maps" in what:
            maps(cams, d)
    return 0


if __name__ == "__main__":
    sys.exit(main())
