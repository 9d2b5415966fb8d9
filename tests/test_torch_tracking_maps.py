"""The tracking mode of the port's march (`raycast_tiles.TRACK`, the
tracking-prepare raycast of both tracked routes) against the JAX XLA
march, the march under which the JAX package meets its own tracking
gates, and both tracked routes of the port on the other two fixtures of
tests/test_tracking.py's gates: its fixture at half the arc and its noisy
stress fixture (the fixture itself is in test_torch_tracking.py).

Numpy inputs made from a seed go through both packages; each test states
its tolerance."""

import inspect
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gps_slam_tpu.config import Config as JConfig
from gps_slam_tpu.data import synthetic
from gps_slam_tpu.eval import metrics as jmetrics
from gps_slam_tpu.tsdf import raycast_tiles as jrt
from gps_slam_tpu.tsdf.engine import TsdfEngine as JEngine
from gps_slam_torch import convert
from gps_slam_torch.config import Config as TConfig
from gps_slam_torch.eval import metrics as tmetrics
from gps_slam_torch.slam import tracker as ttrk
from gps_slam_torch.tsdf import raycast_tiles as trc
from gps_slam_torch.tsdf.engine import TsdfEngine as TEngine
from gps_slam_torch.utils import se3 as tse3


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tracked runs are thousands of small torch ops; one thread per
    test worker keeps them from handing work between threads (the
    tracker's sums are f64: the results do not depend on the thread
    count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


W, H = 160, 120
# tests/test_tracking.py's fixtures: (frames, arc, noisy depth)
FIXTURES = {"arc0.025": (16, 0.025, False), "arc0.0125": (16, 0.0125, False),
            "stress": (32, 0.05, True)}


def _fixture(name):
    """The fixture's cameras and the depth each frame is fused from: the
    noisy one draws tests/test_tracking.py's noise (5 mm sigma, 10%
    dropout, default_rng(7)) frame by frame, in that file's order."""
    n, arc, noisy = FIXTURES[name]
    cams = synthetic.make_cameras(n_frames=n, width=W, height=H, look="in", arc=arc)
    if not noisy:
        return cams, [c.depth for c in cams]
    rng = np.random.default_rng(7)
    depths = []
    for c in cams:
        d = np.asarray(c.depth).copy()
        d += rng.normal(0.0, 0.005, d.shape).astype(np.float32)
        d[rng.random(d.shape) < 0.10] = 0.0
        depths.append(np.maximum(d, 0.0))
    return cams, depths


def _config_dict(tmp, cams):
    c = cams[0]
    d = synthetic.default_config_dict(str(tmp), {
        "input_dir": "mem", "image_path": "c", "pose_path": "c", "depth_path": "d",
        "pcd_name": "n", "depth_scale": 6553.5, "scene_scale": 1.0, "start_frame": 0,
        "end_frame": len(cams) - 1, "frame_step": 1,
        "intrinsics": [c.fx, c.fy, c.cx, c.cy], "image_shape": [W, H],
        "downscale_factor": 1, "test_split_interval": -1})
    d["PIPE"]["TSDF"]["use_gt_pose"] = False
    os.makedirs(d["workspace_dir"], exist_ok=True)
    return d


# ------------------------------------------------------------- the maps

# The XLA march reads the sdf rows and the mip as bf16 (8-bit significand,
# relative rounding 2^-9) and rounds its hat weights and both partial
# trilinear sums to bf16 too; the port reads f32.  Four such roundings move
# a trilinear value by at most ~4 x 2^-9 of the corner values, and with
# the TSDF linear in depth across the band (slope 1/mu) the crossing by
# ~4 x 2^-9 x mu = 0.6 mm at mu 8 cm: vertices within 1 mm.  Where a
# rounded value lies that close to a threshold (the sign at a bracket
# sample, NEAR at a coarse sample, a tie of two blocks' keys) the hit or
# the block flips: a thin set of pixels, at most 0.5% of them.
XOR_MAX = 0.005
VERTEX_MM = 1.0
VERTEX_SHARE = 0.995
# The XLA march's colour read rounds its trilinear weights to bf16 twice
# (wz wy, then x wx: relative 2^-9 each) against the port's f32 weights on
# the same 8-bit colours, so where both packages read the same cell at
# crossings within VERTEX_MM a colour channel differs by at most ~4 x 2^-9
# of a unit colour: COLOR_ATOL = 2/255.  The pixels whose crossing or
# picked block differs (the thin set of the vertex gates) may differ by
# more: COLOR_SHARE of the common hits lie within COLOR_ATOL.
COLOR_ATOL = 2.0 / 255.0
COLOR_SHARE = 0.995


def _map_gaps(ref, other):
    """(hit-mask xor share, share of the common hits within VERTEX_MM) of
    two (depth [H, W], vertex [H, W, 3], ...) numpy maps."""
    (d0, v0), (d1, v1) = ref[:2], other[:2]
    both = (d0 > 0) & (d1 > 0)
    dist_mm = np.linalg.norm(v0[both] - v1[both], axis=-1) * 1000
    return float(np.mean((d0 > 0) != (d1 > 0))), float(np.mean(dist_mm <= VERTEX_MM))


def _color_gaps(ref, other):
    """(share of the common hits whose three colour channels lie within
    COLOR_ATOL, [the share of each map's hits with colour 0]) of two
    (depth, vertex, colour [H, W, 3]) numpy maps."""
    (d0, _, c0), (d1, _, c1) = ref, other
    both = (d0 > 0) & (d1 > 0)
    near = float(np.mean(np.abs(c0[both] - c1[both]).max(-1) <= COLOR_ATOL))
    dark = [float(np.mean(c[d > 0].sum(-1) == 0)) for d, c in ((d0, c0), (d1, c1))]
    return near, dark


@pytest.mark.parametrize("name", list(FIXTURES))
def test_tracking_mode_matches_the_xla_march(tmp_path, name):
    """After 6 gt-pose fusions of the fixture's frames (the JAX XLA
    fusion; the port reads the same volume through volume_from_numpy), the
    maps of frame 5's pose from the port's tracking mode (its plain
    version, at TRACK_K_BLOCKS picks) against the JAX XLA march at its
    default 2 picks, at the engine's raycast settings: hit masks differ on
    at most XOR_MAX of the pixels, and VERTEX_SHARE of the common hits lie
    within VERTEX_MM (the bf16 reads' bound, above).  The march on the TPU
    kernel's semantics, which the tracking prepare ran before, misses the
    same gates (2-3.5% of the pixels flip, its p99 vertex gap is
    centimetres).  The tracking mode's colour map (which the colour and
    composite trackers read) against the XLA march's: COLOR_SHARE of the
    common hits within COLOR_ATOL (the bf16 weights' bound, above), and
    the same share of hits with colour 0 within 0.5% (fusion writes colour
    only near the surface, and the trilinear read averages the voxels
    without it: a dark map in both packages)."""
    cams, depths = _fixture(name)
    d = _config_dict(tmp_path, cams)
    je = JEngine(JConfig.from_dict(d), W, H, cams[0].K)
    je.set_gt_poses([c.c2w for c in cams])
    je.turn_off_tracking()
    for c, dep in list(zip(cams, depths))[:6]:
        je.process_frame(jnp.asarray(c.image), jnp.asarray(dep))
    p = je.vol.params
    lb, s_c, s_r = p.raycast_lb, p.raycast_samples, max(p.raycast_bisect, 3)
    tv = convert.volume_from_numpy(
        {k: np.asarray(getattr(je.vol, k)) for k in
         ("table_keys", "table_ptrs", "block_coords", "state", "color", "summary",
          "n_blocks", "last_seen")},
        TEngine(TConfig.from_dict(d), W, H, cams[0].K, device="cpu").params, "cpu")
    cam = cams[5]
    m = jrt.raycast(je.vol, jnp.asarray(cam.c2w), jnp.asarray(cam.K), W, H, lb, s_c, s_r,
                    p.raycast_chunk, 2)
    ref = (np.asarray(m["depth_map"])[..., 0], np.asarray(m["vertex_map"]),
           np.asarray(m["color_map"]))
    assert (ref[0] > 0).mean() > 0.8

    def port(track, k, need_color=False):
        m = trc.raycast(tv, cam.c2w, cam.K, W, H, lb, s_c, s_r, k, need_color=need_color,
                        track=track)
        return (m["depth_map"].numpy()[..., 0], m["vertex_map"].numpy(),
                m["color_map"].numpy())

    track = port(True, trc.TRACK_K_BLOCKS, need_color=True)
    xor, near = _map_gaps(ref, track)
    assert xor <= XOR_MAX and near >= VERTEX_SHARE, (xor, near)
    near, (dark_ref, dark) = _color_gaps(ref, track)
    assert near >= COLOR_SHARE and abs(dark - dark_ref) <= 0.005, (near, dark_ref, dark)
    xor, near = _map_gaps(ref, port(False, 1))
    assert xor > XOR_MAX and near < VERTEX_SHARE, (xor, near)


def test_tracking_mode_points_are_the_xla_marchs():
    """The tracking mode names the three points of the XLA march that the
    TPU kernel departs from, and refines its default 2 picks."""
    assert trc.TRACK == {"pixel_rank", "pixel_cand", "two_stage"}
    k_xla = inspect.signature(jrt.raycast.__wrapped__).parameters["k_blocks"].default
    assert trc.TRACK_K_BLOCKS == k_xla == 2


# ------------------------------------------------------- tracked runs

@pytest.mark.parametrize("route", ["eager", "megastep"])
@pytest.mark.parametrize("name", ["arc0.0125", "stress"])
def test_port_tracked_run_on_more_fixtures(tmp_path, monkeypatch, name, route):
    """Both routes of the port on tests/test_tracking.py's fixture at half
    its arc (0.0125: the slower the camera, the further the TPU kernel's
    semantics drifted: 15-17 cm off the last pose) and on its noisy stress
    fixture, held to that file's gates: at arc 0.0125 those of the
    fixture (ATE below 3 voxels, the last pose within 4 voxels and 2
    degrees, GOOD on >= 70% of the tracked frames), on the stress fixture
    its own (ATE below 6 voxels, FAILED on <= 20% of the tracked
    frames)."""
    cams, depths = _fixture(name)
    if route == "eager":
        monkeypatch.setattr(TEngine, "_can_fast_track", lambda self: False)
    cfg = TConfig.from_dict(_config_dict(tmp_path, cams))
    e = TEngine(cfg, W, H, cams[0].K, device="cpu")
    e.set_gt_poses([cams[0].c2w])
    e.attach_tracker(ttrk.ICPTracker(cfg, W, H))
    q = []
    for c, dep in zip(cams, depths):
        e.process_frame(c.image, dep)
        q.append(e._tracking_quality)
    assert e._can_fast_track() == (route == "megastep")
    n = len(cams) - 1
    vox = e.params.voxel_size
    est, gt = e.cam_poses, [c.c2w for c in cams]
    ate_cm = tmetrics.ate_rmse_cm(est, gt)
    assert ate_cm == pytest.approx(jmetrics.ate_rmse_cm(est, gt), abs=1e-9)
    if name == "stress":
        assert ate_cm < 6.0 * vox * 100, ate_cm
        assert sum(x == ttrk.TrackerQuality.FAILED for x in q[1:]) <= 0.2 * n, q
        return
    assert ate_cm < 3.0 * vox * 100, ate_cm
    t_err = np.linalg.norm(est[-1][:3, 3] - gt[-1][:3, 3])
    ang = float(tse3.rot_angle_deg(torch.as_tensor(est[-1][:3, :3]),
                                   torch.as_tensor(gt[-1][:3, :3])))
    assert t_err < 4.0 * vox, t_err
    assert ang < 2.0, ang
    assert sum(x == ttrk.TrackerQuality.GOOD for x in q[1:]) >= 0.7 * n, q
