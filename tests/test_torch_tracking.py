"""Tracked mode of the port against the JAX package: the se3 additions,
the ICP and colour trackers (one level, the pyramid, the factory), the fern
relocaliser, the engine's failure policies, a tracked run on the JAX
package's own tracking fixture, a short tracked sequence through both
engines, and the CLI in tracked recon mode.

Numpy inputs made from a seed go through both packages; each test states
its tolerance."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gps_slam_tpu.config import Config as JConfig
from gps_slam_tpu.data import synthetic
from gps_slam_tpu.eval import metrics as jmetrics
from gps_slam_tpu.slam import relocalizer as jreloc
from gps_slam_tpu.slam import tracker as jtrk
from gps_slam_tpu.tsdf.engine import TsdfEngine as JEngine
from gps_slam_tpu.utils import se3 as jse3
from gps_slam_torch.config import Config as TConfig
from gps_slam_torch.eval import metrics as tmetrics
from gps_slam_torch.slam import relocalizer as treloc
from gps_slam_torch.slam import tracker as ttrk
from gps_slam_torch.tsdf.engine import TsdfEngine as TEngine
from gps_slam_torch.utils import se3 as tse3


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The tracker's Gauss-Newton loops are thousands of small torch ops;
    when every test worker's torch spreads each of them over all cores,
    the loops spend their time handing work between threads.  The
    tracker's sums are f64, so its results do not depend on the thread
    count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _node(cams, n):
    c = cams[0]
    return {"input_dir": "mem", "image_path": "c", "pose_path": "c", "depth_path": "d",
            "pcd_name": "n", "depth_scale": 6553.5, "scene_scale": 1.0,
            "start_frame": 0, "end_frame": n - 1, "frame_step": 1,
            "intrinsics": [c.fx, c.fy, c.cx, c.cy],
            "image_shape": [c.width, c.height], "downscale_factor": 1,
            "test_split_interval": -1}


def _config_dict(tmp, cams, tsdf=None, tracker=None):
    d = synthetic.default_config_dict(str(tmp), _node(cams, len(cams)))
    d["PIPE"]["TSDF"]["use_gt_pose"] = False
    d["PIPE"]["TSDF"].update(tsdf or {})
    if tracker is not None:
        d["PIPE"]["TSDF"]["tracker"] = tracker
    os.makedirs(d["workspace_dir"], exist_ok=True)
    return d


def _t(x):
    return torch.as_tensor(np.asarray(x))


# ------------------------------------------------------------------ se3

def test_se3_additions_match_jax():
    """se3_exp (angles from 1e-9 to 1 rad: the small-angle branch below
    1e-8), rotmat_to_quat, rot_angle_deg, trans_dist: within 1e-6;
    bilateral_filter_depth: within 1e-6 m."""
    rng = np.random.default_rng(0)
    xi = (rng.normal(size=(12, 6)) * 0.3).astype(np.float32)
    xi[:4, 3:] *= np.array([1e-9, 5e-9, 2e-8, 1e-6], np.float32)[:, None]
    Tj = np.asarray(jse3.se3_exp(jnp.asarray(xi)))
    Tt = tse3.se3_exp(_t(xi)).numpy()
    np.testing.assert_allclose(Tt, Tj, atol=1e-6)
    R = Tj[:, :3, :3]
    np.testing.assert_allclose(tse3.rotmat_to_quat(_t(R)).numpy(),
                               np.asarray(jse3.rotmat_to_quat(jnp.asarray(R))), atol=1e-6)
    for a, b in ((0, 5), (6, 7), (8, 11)):
        aj = float(jse3.rot_angle_deg(jnp.asarray(R[a]), jnp.asarray(R[b])))
        at = float(tse3.rot_angle_deg(_t(R[a]), _t(R[b])))
        assert abs(at - aj) <= 1e-6 * max(1.0, aj), (a, b, aj, at)
        dj = float(jse3.trans_dist(jnp.asarray(Tj[a, :3, 3]), jnp.asarray(Tj[b, :3, 3])))
        dt = float(tse3.trans_dist(_t(Tj[a, :3, 3]), _t(Tj[b, :3, 3])))
        assert abs(dt - dj) <= 1e-6
    d = rng.uniform(0.3, 4.0, (48, 64)).astype(np.float32)
    d[rng.random(d.shape) < 0.15] = 0.0
    np.testing.assert_allclose(tse3.bilateral_filter_depth(_t(d)).numpy(),
                               np.asarray(jse3.bilateral_filter_depth(jnp.asarray(d))),
                               atol=1e-6)


# -------------------------------------------------------------- tracker

def test_subsample_and_bilinear_match_jax():
    """_subsample_depth and _bilinear (invalid corners left out of the
    weights): within 1e-6."""
    rng = np.random.default_rng(1)
    d = rng.uniform(0.5, 3.0, (61, 83)).astype(np.float32)
    d[rng.random(d.shape) < 0.3] = 0.0
    np.testing.assert_allclose(ttrk._subsample_depth(_t(d)).numpy(),
                               np.asarray(jtrk._subsample_depth(jnp.asarray(d))), atol=1e-6)
    img = rng.normal(size=(40, 50, 3)).astype(np.float32)
    img[rng.random((40, 50)) < 0.2] = 0.0
    u = rng.uniform(-1, 50, 500).astype(np.float32).clip(0, 49)
    v = rng.uniform(-1, 40, 500).astype(np.float32).clip(0, 39)
    aj, wj = jtrk._bilinear(jnp.asarray(img), jnp.asarray(u), jnp.asarray(v))
    at, wt = ttrk._bilinear(_t(img), _t(u), _t(v))
    np.testing.assert_allclose(at.numpy(), np.asarray(aj), atol=1e-6)
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), atol=1e-6)


@pytest.fixture(scope="module")
def ref_maps():
    """Reference maps built with numpy from frame 0's depth (world vertices
    and normals, zero where there is no depth), frame 1's depth, and frame
    1's pose perturbed by a small twist: the tracker's inputs without a
    raycast."""
    cams = synthetic.make_cameras(n_frames=16, width=160, height=120, look="in", arc=0.025)
    a, b = cams[0], cams[1]
    vm = np.asarray(jse3.compute_vertex_map(jnp.asarray(a.depth[..., 0]), a.fx, a.fy, a.cx, a.cy))
    nm = np.asarray(jse3.compute_normal_map(jnp.asarray(vm)))
    ok = vm[..., 2:3] > 0
    vw = np.where(ok, vm @ a.c2w[:3, :3].T + a.c2w[:3, 3], 0).astype(np.float32)
    nw = np.where(ok, nm @ a.c2w[:3, :3].T, 0).astype(np.float32)
    T0 = (np.asarray(jse3.se3_exp(jnp.asarray(
        np.array([0.004, -0.003, 0.006, 0.004, -0.006, 0.003], np.float32)))) @ b.c2w
          ).astype(np.float32)
    return cams, vw, nw, b.depth[..., 0].astype(np.float32), T0


@pytest.mark.parametrize("lvl", [3, 2, 1, 0])
def test_track_level_matches_jax(ref_maps, lvl):
    """One pyramid level (levels 3, 2 solve rotation only, 1, 0 the full
    twist) from the same perturbed pose: the same iteration count, pose
    within 1e-5, inlier share within 1e-6, mean residual within 1e-7 m."""
    cams, vw, nw, depth, T0 = ref_maps
    dj, dt = jnp.asarray(depth), _t(depth)
    for _ in range(lvl):
        dj, dt = jtrk._subsample_depth(dj), ttrk._subsample_depth(dt)
    cam = ttrk._level_cam(cams[0].K, lvl, True)
    rpi = np.linalg.inv(cams[0].c2w.astype(np.float32))
    li = min(lvl, 3)
    rot = lvl >= ttrk.ROTATION_ONLY_FROM_LEVEL
    Tj, ij, mj, nj = jtrk._track_level(
        jnp.asarray(T0), dj, jnp.asarray(vw), jnp.asarray(nw), jnp.asarray(cam),
        jtrk.LEVEL_ITERS[li], rot, ref_pose_inv=jnp.asarray(rpi),
        space_thresh=jnp.asarray(jtrk.SPACE_THRESH[li]), tukey_c=jnp.asarray(jtrk.TUKEY_C[li]))
    Tt, it_, mt, nt = ttrk._track_level(
        _t(T0), dt, _t(vw), _t(nw), _t(cam), ttrk.LEVEL_ITERS[li], rot, _t(rpi),
        ttrk._scalar(ttrk.SPACE_THRESH[li], "cpu"), ttrk._scalar(ttrk.TUKEY_C[li], "cpu"))
    assert nt == int(nj) > 1
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), atol=1e-5)
    assert abs(float(it_) - float(ij)) <= 1e-6
    assert abs(float(mt) - float(mj)) <= 1e-7


def _cfg_pair(tmp, cams, tracker=None, tsdf=None):
    d = _config_dict(tmp, cams, tsdf, tracker)
    return JConfig.from_dict(d), TConfig.from_dict(d)


def test_icp_tracker_matches_jax(ref_maps, tmp_path):
    """ICPTracker.track over the 4-level pyramid: the same quality, pose
    within 1e-4 (four levels of f32 Gauss-Newton, sums in another order)."""
    cams, vw, nw, depth, T0 = ref_maps
    jc, tc = _cfg_pair(tmp_path, cams)
    W, H = cams[0].width, cams[0].height
    Tj, qj = jtrk.ICPTracker(jc, W, H).track(
        T0, jnp.asarray(depth), {"vertex_map": jnp.asarray(vw), "normal_map": jnp.asarray(nw)},
        cams[0].K)
    tt = ttrk.ICPTracker(tc, W, H)
    Tt, qt = tt.track(T0, _t(depth), {"vertex_map": _t(vw), "normal_map": _t(nw)}, cams[0].K)
    assert qt == qj != ttrk.TrackerQuality.FAILED
    np.testing.assert_allclose(Tt, np.asarray(Tj), atol=1e-4)
    assert len(tt.last_iters) == 4 and all(n >= 1 for n in tt.last_iters)
    # the tracked pose is closer to the truth than the perturbed start
    assert np.abs(Tt - cams[1].c2w).max() < 0.2 * np.abs(T0 - cams[1].c2w).max()


def test_color_tracker_matches_jax(tmp_path):
    """ColorTracker.track on the setup of test_tracking's colour test (the
    old view's exact points and colours, a new rgb 2 cm away): the same
    quality, pose within 1e-4."""
    W, H = 160, 120
    cams = synthetic.make_cameras(n_frames=2, width=W, height=H, look="in")
    cam = cams[0]
    jc, tc = _cfg_pair(tmp_path, cams)
    vm = np.asarray(jse3.compute_vertex_map(jnp.asarray(cam.depth[..., 0]),
                                            cam.fx, cam.fy, cam.cx, cam.cy))
    vw = (vm.reshape(-1, 3) @ cam.c2w[:3, :3].T + cam.c2w[:3, 3]).reshape(vm.shape)
    vw = vw.astype(np.float32)
    true_pose = cam.c2w.copy()
    true_pose[:3, 3] += np.array([0.012, 0.0, 0.018], np.float32)
    rgb_new, _ = synthetic.render_frame(true_pose, W, H, cam.fx, cam.fy, cam.cx, cam.cy)
    Tj, qj = jtrk.ColorTracker(jc, W, H).track(
        cam.c2w, None, {"vertex_map": jnp.asarray(vw), "color_map": jnp.asarray(cam.image)},
        cam.K, rgb=rgb_new)
    Tt, qt = ttrk.ColorTracker(tc, W, H).track(
        cam.c2w, None, {"vertex_map": _t(vw), "color_map": _t(cam.image)}, cam.K, rgb=rgb_new)
    assert qt == qj != ttrk.TrackerQuality.FAILED
    np.testing.assert_allclose(Tt, np.asarray(Tj), atol=1e-4)
    assert (np.linalg.norm(Tt[:3, 3] - true_pose[:3, 3])
            < 0.5 * np.linalg.norm(cam.c2w[:3, 3] - true_pose[:3, 3]))


def test_make_tracker_and_trivial_trackers_match_jax(tmp_path):
    """make_tracker builds the JAX package's tracker for every type, and the
    file, force-fail and composite trackers return what the JAX ones
    return (the file tracker reads column-major inverse poses, fails on a
    missing file and still advances its counter)."""
    cams = synthetic.make_cameras(n_frames=3, width=64, height=48)
    cam = cams[0]
    mask = str(tmp_path / "pose%06d.txt")
    inv = np.linalg.inv(cam.c2w).astype(np.float32)
    with open(mask % 0, "w") as f:
        f.write(" ".join(str(v) for v in inv.flatten(order="F")))
    with open(mask % 1, "w") as f:
        f.write("1 2 3")
    for tnode, cls in (({}, "ICPTracker"), ({"type": "extended"}, "ICPTracker"),
                       ({"type": "rgb"}, "ColorTracker"), ({"type": "color"}, "ColorTracker"),
                       ({"type": "composite"}, "CompositeTracker"),
                       ({"type": "file", "pose_mask": mask}, "FileBasedTracker"),
                       ({"type": "force_fail"}, "ForceFailTracker")):
        jc, tc = _cfg_pair(tmp_path, cams, tracker=tnode)
        tj, tt = jtrk.make_tracker(jc, 64, 48), ttrk.make_tracker(tc, 64, 48)
        assert type(tj).__name__ == type(tt).__name__ == cls
        assert getattr(tt, "needs_color", False) == getattr(tj, "needs_color", False)
        if cls == "CompositeTracker":
            assert [type(t).__name__ for t in tt.trackers] == ["ColorTracker", "ICPTracker"]
        if cls in ("FileBasedTracker", "ForceFailTracker"):
            last = np.eye(4, dtype=np.float32)
            for _ in range(3):
                pj, qj = tj.track(last, None, None, cam.K)
                pt, qt = tt.track(last, None, None, cam.K)
                assert qt == qj
                np.testing.assert_array_equal(pt, np.asarray(pj))
            if cls == "FileBasedTracker":
                assert tt.frame == tj.frame == 3
    with pytest.raises(ValueError):
        ttrk.make_tracker(_cfg_pair(tmp_path, cams, tracker={"type": "nope"})[1], 64, 48)
    # a composite with nothing to track against keeps the pose, POOR
    comp = ttrk.CompositeTracker([ttrk.ICPTracker(tc, 64, 48)])
    assert comp.track(cam.c2w, None, None, cam.K)[1] == ttrk.TrackerQuality.POOR


# ---------------------------------------------------------- relocaliser

@pytest.mark.parametrize("width,height", [(1200, 680), (160, 120), (96, 72)])
def test_fern_codes_match_jax(width, height):
    """The port's nearest-neighbour pick gives OpenCV's INTER_NEAREST
    resize: fern codes equal to the JAX relocaliser's (which resizes with
    cv2), from numpy and from a tensor."""
    rng = np.random.default_rng(width)
    d = rng.uniform(0.2, 4.2, (height, width)).astype(np.float32)
    d[rng.random(d.shape) < 0.1] = 0.0
    rj, rt = jreloc.FernRelocalizer(seed=3), treloc.FernRelocalizer(seed=3)
    np.testing.assert_array_equal(rt.px, rj.px)
    np.testing.assert_array_equal(rt.thresh, rj.thresh)
    cj = rj.compute_code(d)
    np.testing.assert_array_equal(rt.compute_code(d), cj)
    np.testing.assert_array_equal(rt.compute_code(torch.as_tensor(d)[..., None]), cj)


def test_fern_harvest_and_retrieval_match_jax():
    """The same keyframes are harvested (trusted, novel views only) and the
    same stored pose is retrieved."""
    cams = synthetic.make_cameras(10, 80, 60)
    rj = jreloc.FernRelocalizer(harvest_threshold=0.05)
    rt = treloc.FernRelocalizer(harvest_threshold=0.05)
    for k, cam in enumerate(cams[:8]):
        rj.process_frame(cam.depth, cam.c2w, tracking_good=k != 3)
        rt.process_frame(torch.as_tensor(cam.depth), cam.c2w, tracking_good=k != 3)
    assert rt.num_keyframes == rj.num_keyframes >= 2
    for a, b in zip(rt.codes, rj.codes):
        np.testing.assert_array_equal(a, b)
    for cam in cams:
        np.testing.assert_array_equal(rt.relocalize(cam.depth), rj.relocalize(cam.depth))
    assert treloc.FernRelocalizer().relocalize(cams[0].depth) is None


# ---------------------------------------------------------------- engine

def _write_pose_files(mask, cams, gaps):
    """File n holds the column-major inverse pose of frame n + 1 (the n-th
    tracker call is made for engine frame n + 1); `gaps` are left out."""
    for n in range(len(cams) - 1):
        if n in gaps:
            continue
        inv = np.linalg.inv(cams[n + 1].c2w).astype(np.float32)
        with open(mask % n, "w") as f:
            f.write(" ".join(repr(float(v)) for v in inv.flatten(order="F")))


@pytest.mark.parametrize("policy,tracker", [
    ("ignore", "force_fail"), ("stop_integration", "force_fail"),
    ("stop_integration", "file"), ("relocalise", "file")])
def test_engine_failure_policies_match_jax(tmp_path, policy, tracker):
    """The behaviour-on-failure policies through both engines with the same
    frames and the same tracker: equal recorded poses (the file tracker's
    poses, or the reverted ones), equal fused block keys and the same
    relocaliser keyframe count.  The JAX engine fuses on its XLA branch
    here; allocation is the same code on both branches."""
    cams = synthetic.make_cameras(n_frames=6, width=96, height=72, look="in", arc=0.3)
    mask = str(tmp_path / "pose%06d.txt")
    _write_pose_files(mask, cams, gaps={2, 4})
    tnode = {"type": tracker, "pose_mask": mask}
    jc, tc = _cfg_pair(tmp_path, cams, tracker=tnode,
                       tsdf={"behaviour_on_failure": policy})
    je = JEngine(jc, 96, 72, cams[0].K)
    te = TEngine(tc, 96, 72, cams[0].K, device="cpu")
    for e, make in ((je, jtrk.make_tracker), (te, ttrk.make_tracker)):
        e.set_gt_poses([cams[0].c2w])
        e.attach_tracker(make(jc if e is je else tc, 96, 72))
    qj, qt = [], []
    for c in cams:
        je.process_frame(jnp.asarray(c.image), jnp.asarray(c.depth))
        te.process_frame(c.image, c.depth)
        qj.append(je._tracking_quality)
        qt.append(te._tracking_quality)
    assert qt == qj
    assert any(q == ttrk.TrackerQuality.FAILED for q in qt[1:])
    np.testing.assert_array_equal(np.stack(te.cam_poses), np.stack(je.cam_poses))
    nj = int(je.vol.n_blocks)
    assert te.vol.n_blocks == nj > 0
    kj = np.sort(np.asarray(je.vol.block_coords)[:nj])
    kt = np.sort(te.vol.block_coords[:nj].numpy().view(np.uint32))
    np.testing.assert_array_equal(kt, kj)
    if policy == "relocalise":
        assert te.relocalizer.num_keyframes == je.relocalizer.num_keyframes >= 1
    else:
        assert te.relocalizer is None and je.relocalizer is None


@pytest.mark.parametrize("tracked", [False, True])
def test_engine_bilateral_filter_in_both_modes(tmp_path, tracked):
    """PIPE.TSDF.use_bilateral_filter filters each frame's depth before
    tracking and fusion, in gt-pose and in tracked mode: the engine with
    the filter on gives the state words, poses and quality labels of the
    engine with it off fed the filtered depth."""
    cams = synthetic.make_cameras(n_frames=4, width=96, height=72, look="in", arc=0.0125)
    runs = []
    for on in (True, False):
        _, tc = _cfg_pair(tmp_path, cams, tsdf={"use_bilateral_filter": on})
        e = TEngine(tc, 96, 72, cams[0].K, device="cpu")
        if tracked:
            e.set_gt_poses([cams[0].c2w])
            e.attach_tracker(ttrk.ICPTracker(tc, 96, 72))
        else:
            e.set_gt_poses([c.c2w for c in cams])
            e.turn_off_tracking()
        q = []
        for c in cams:
            d = _t(c.depth[..., 0])
            e.process_frame(c.image, d if on else tse3.bilateral_filter_depth(d))
            q.append(e._tracking_quality)
        runs.append((e, q))
    (a, qa), (b, qb) = runs
    assert qa == qb
    np.testing.assert_array_equal(np.stack(a.cam_poses), np.stack(b.cam_poses))
    assert a.vol.n_blocks == b.vol.n_blocks > 0
    assert torch.equal(a.vol.state, b.vol.state) and torch.equal(a.vol.color, b.vol.color)
    # the filter changed the depth the engine fused
    _, tc = _cfg_pair(tmp_path, cams)
    raw = TEngine(tc, 96, 72, cams[0].K, device="cpu")
    raw.set_gt_poses([c.c2w for c in cams])
    raw.turn_off_tracking()
    for c in cams:
        raw.process_frame(c.image, c.depth)
    assert not torch.equal(raw.vol.state, b.vol.state)


def test_tracking_normals_keep_the_plane_z0(tmp_path):
    """The tracking-prepare normal map: the JAX package's rule
    (compute_normal_map on the world vertex map, 3x3 hit neighbourhood)
    (within 1e-4) wherever the vertex's world z > 0; the port also keeps normals where
    world z <= 0, which the JAX package zeroes (the synthetic room's wall
    z = 0 is one of them)."""
    cams = synthetic.make_cameras(n_frames=4, width=160, height=120, look="in", arc=0.025)
    _, tc = _cfg_pair(tmp_path, cams)
    te = TEngine(tc, 160, 120, cams[0].K, device="cpu")
    te.set_gt_poses([c.c2w for c in cams])
    te.turn_off_tracking()
    for c in cams:
        te.process_frame(c.image, c.depth)
    m = te.run_raycast(cams[3].c2w, quality=False, need_color=False)
    v, n, d = (m[k].numpy() for k in ("vertex_map", "normal_map", "depth_map"))
    nj = np.asarray(jse3.compute_normal_map(jnp.asarray(v)))
    keep = (np.abs(n).sum(-1) > 0)
    zpos = v[..., 2] > 0
    np.testing.assert_allclose(n[keep & zpos], nj[keep & zpos], atol=1e-4)
    low = keep & ~zpos
    assert low.sum() > 20
    assert np.all(np.abs(nj[low]).sum(-1) == 0)
    np.testing.assert_allclose(np.linalg.norm(n[low], axis=-1), 1.0, atol=1e-4)
    assert np.all(d[..., 0][keep] > 0)


# ------------------------------------------------------- tracked runs

def _jax_on_xla_raycast(mp):
    """After `_jax_on_kernel_branch`: the JAX engine's raycasts go to its
    XLA march (`raycast_tiles.raycast` at its default 2 picks, as the
    engine's XLA branch calls it), the march whose semantics the port's
    tracking mode takes; its fusion stays on the packed integrate kernel
    in interpret mode."""
    import gps_slam_tpu.tsdf.raycast_pallas as rcp
    from gps_slam_tpu.tsdf import raycast_tiles as jrt

    def xla(vol, c2w, K, width, height, lb, s_coarse, s_refine, k_blocks=2, *a,
            pool_prefix=None, **k):
        return jrt.raycast(vol, c2w, K, width, height, lb, s_coarse, s_refine,
                           vol.params.raycast_chunk, pool_prefix=pool_prefix)

    mp.setattr(rcp, "raycast", xla)


def _tracked_run(engine_cls, cfg, cams, frame, **kw):
    W, H = cams[0].width, cams[0].height
    e = engine_cls(cfg, W, H, cams[0].K, **kw)
    # frame 0 seeds from the dataset's first pose; later frames are tracked
    e.set_gt_poses([cams[0].c2w])
    mod = jtrk if engine_cls is JEngine else ttrk
    e.attach_tracker(mod.ICPTracker(cfg, W, H))
    q = []
    for c in cams:
        e.process_frame(*frame(c))
        q.append(e._tracking_quality)
    return e, q


@pytest.mark.parametrize("route", ["eager", "megastep"])
def test_port_tracked_run_on_the_tracking_fixture(tmp_path, monkeypatch, route):
    """The port on test_tracking.py's fixture (160x120, 16 frames,
    look="in", arc=0.025, 2 cm voxels), on its eager route and on its
    tracked megastep, held to that file's gates: ATE below 3 voxels, the
    last pose within 4 voxels and 2 degrees, GOOD on >= 70% of the
    tracked frames.  The JAX package meets them on its XLA raycast, whose
    semantics the port's tracking-prepare raycast takes (raycast_tiles.
    TRACK); on the TPU kernel's semantics both packages end 8.5-11 cm off
    the last pose (tools/track_fixture_paths.py).  The other fixtures of
    those gates are in test_torch_tracking_maps.py.  The sums are f64, so
    the results do not depend on the thread count."""
    W, H, N = 160, 120, 16
    cams = synthetic.make_cameras(n_frames=N, width=W, height=H, look="in", arc=0.025)
    if route == "eager":
        monkeypatch.setattr(TEngine, "_can_fast_track", lambda self: False)
    _, tc = _cfg_pair(tmp_path, cams)
    e, q = _tracked_run(TEngine, tc, cams, lambda c: (c.image, c.depth), device="cpu")
    vox = e.params.voxel_size
    est, gt = e.cam_poses, [c.c2w for c in cams]
    ate_cm = tmetrics.ate_rmse_cm(est, gt)
    assert ate_cm == pytest.approx(jmetrics.ate_rmse_cm(est, gt), abs=1e-9)
    assert ate_cm < 3.0 * vox * 100, ate_cm
    t_err = np.linalg.norm(est[-1][:3, 3] - gt[-1][:3, 3])
    ang = float(tse3.rot_angle_deg(_t(est[-1][:3, :3]), _t(gt[-1][:3, :3])))
    assert ang < 2.0, ang
    assert t_err < 4.0 * vox, t_err
    good = sum(x == ttrk.TrackerQuality.GOOD for x in q[1:])
    assert good >= 0.7 * (N - 1), q


def test_tracked_sequence_matches_jax(tmp_path, monkeypatch):
    """The same 8 frames (96x72, look="in", ~1.6 cm a frame) through the
    JAX engine's eager per-frame path on its kernel branch (the packed
    integrate kernel in interpret mode, as test_torch_slice runs it) with
    its raycasts on the XLA march, whose semantics the port's tracking-
    prepare raycast takes, and through the port, in lockstep: the port
    fuses at the JAX engine's poses, so both track every frame against
    maps of the same history, and each frame's own estimates are compared.
    Both engines are held to their eager routes (the tracked megastep's
    lockstep is in test_torch_tracked_megastep.py).  The XLA march reads
    the sdf as bf16 and the port as f32, and the port keeps the normals of
    the plane z = 0; ICP answers such micrometre map differences within a
    millimetre, except on a frame where a Levenberg-Marquardt accept/reject
    flips.  So: equal quality labels, every frame within 1 voxel and 0.1
    degree, all but one within 1 mm."""
    from test_torch_slice import _jax_on_kernel_branch

    W, H, N = 96, 72, 8
    cams = synthetic.make_cameras(n_frames=N, width=W, height=H, look="in", arc=0.0125)
    jc, tc = _cfg_pair(tmp_path, cams)
    _jax_on_kernel_branch(monkeypatch)
    _jax_on_xla_raycast(monkeypatch)
    monkeypatch.setattr(JEngine, "_can_fast_track", lambda self: False)
    monkeypatch.setattr(TEngine, "_can_fast_track", lambda self: False)
    je = JEngine(jc, W, H, cams[0].K)
    te = TEngine(tc, W, H, cams[0].K, device="cpu")
    je.set_gt_poses([cams[0].c2w])
    te.set_gt_poses([cams[0].c2w])
    je.attach_tracker(jtrk.ICPTracker(jc, W, H))
    port, own = ttrk.ICPTracker(tc, W, H), []

    class Lockstep:
        needs_color = False

        def track(self, last_pose, depth, maps, K, rgb=None):
            own.append(port.track(last_pose, depth, maps, K))
            return np.asarray(je.cam_poses[len(own)]), own[-1][1]

    te.attach_tracker(Lockstep())
    qj = []
    for c in cams:
        je.process_frame(jnp.asarray(c.image), jnp.asarray(c.depth))
        qj.append(je._tracking_quality)
        te.process_frame(c.image, c.depth)
    assert [q for _, q in own] == qj[1:]
    vox = te.params.voxel_size
    d_mm = []
    for k, (pt, _) in enumerate(own, 1):
        pj = np.asarray(je.cam_poses[k])
        d_mm.append(1000 * np.linalg.norm(pt[:3, 3] - pj[:3, 3]))
        assert float(tse3.rot_angle_deg(_t(pt[:3, :3]), _t(pj[:3, :3]))) < 0.1, k
    assert max(d_mm) < 1000 * vox, d_mm
    assert sum(d > 1.0 for d in d_mm) <= 1, d_mm


def test_cli_tracked_recon_writes_poses_and_mesh(tmp_path):
    """slam_trainer_torch.main in tracked recon mode on an on-disk synthetic
    dataset, on the CPU: the poses, the TSDF mesh and the scene with one
    recorded pose per frame are written."""
    import yaml

    import slam_trainer_torch

    node = synthetic.write_dataset(str(tmp_path / "scene"), n_frames=6, width=96, height=72)
    d = synthetic.default_config_dict(str(tmp_path / "scene"), node, work_mode="recon")
    d["PIPE"]["TSDF"]["use_gt_pose"] = False
    d["workspace_dir"] = str(tmp_path / "ws")
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(yaml.safe_dump(d))
    slam_trainer_torch.main(str(cfg), device="cpu")
    ws = d["workspace_dir"]
    assert len(os.listdir(os.path.join(ws, "pose"))) == 6
    from gps_slam_torch.utils import io as tio

    v, c, f = tio.read_mesh_ply(os.path.join(ws, d["PIPE"]["TSDF"]["saved_mesh"]))
    assert f.shape[0] > 100 and c is not None
    z = np.load(os.path.join(ws, d["PIPE"]["TSDF"]["saved_engine"], "scene.npz"))
    assert z["cam_poses"].shape == (6, 4, 4)
