"""The tracked megastep of the port (`tsdf/engine.track_fuse_step`, routed
by `TsdfEngine._can_fast_track`) on the CPU.

(a) The fixed-cap Gauss-Newton level against the early-exit
`_track_level`, bit for bit, masked and with its in-place iteration
repeated; a level's passes capped by a call's budget.  (b) The
read-back-free pyramid against the JAX `track_pyramid`.  (c) The
megastep frame under the guard that fails on every host read.  (d) A
failed frame keeps its previous pose.  (e) `_can_fast_track` gate by gate against the JAX engine's.  (f)
8 frames at 160x120 in lockstep with the JAX engine's tracked megastep
(its packed integrate kernel in interpret mode, its raycasts on the XLA
march)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gps_slam_tpu.config import Config as JConfig
from gps_slam_tpu.data import synthetic
from gps_slam_tpu.slam import tracker as jtrk
from gps_slam_tpu.tsdf.engine import TsdfEngine as JEngine
from gps_slam_tpu.utils import se3 as jse3
from gps_slam_torch.config import Config as TConfig
from gps_slam_torch.slam import tracker as ttrk
from gps_slam_torch.tsdf import engine as teng
from gps_slam_torch.tsdf.engine import TsdfEngine as TEngine
from gps_slam_torch.utils import se3 as tse3
from test_torch_megastep import NoHostReads


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The Gauss-Newton levels are thousands of small torch ops; one
    thread per test worker keeps them from handing work between threads
    (the sums are f64: the results do not depend on the thread count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _config_dict(tmp, cams, tsdf=None, tracker=None, tpu=None):
    c = cams[0]
    d = synthetic.default_config_dict(str(tmp), {
        "input_dir": "mem", "image_path": "c", "pose_path": "c", "depth_path": "d",
        "pcd_name": "n", "depth_scale": 6553.5, "scene_scale": 1.0, "start_frame": 0,
        "end_frame": len(cams) - 1, "frame_step": 1,
        "intrinsics": [c.fx, c.fy, c.cx, c.cy], "image_shape": [c.width, c.height],
        "downscale_factor": 1, "test_split_interval": -1})
    d["PIPE"]["TSDF"]["use_gt_pose"] = False
    d["PIPE"]["TSDF"].update(tsdf or {})
    d["TPU"].update(tpu or {})
    if tracker is not None:
        d["PIPE"]["TSDF"]["tracker"] = tracker
    os.makedirs(d["workspace_dir"], exist_ok=True)
    return d


@pytest.fixture(scope="module")
def ref_maps():
    """tests/test_torch_tracking.py's level inputs: frame 0's world
    vertices and normals (numpy), frame 1's depth and frame 1's pose
    perturbed by a small twist (160x120)."""
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


# ------------------------------------------------------ (a) one level

LEVEL_CASES = [(0, 50, "exit"), (1, 3, "cap"), (3, 20, "exit")]
LEVEL_IDS = ["early_exit", "to_cap", "rotation_only"]


@pytest.mark.parametrize(
    "lvl,budget,runs,form",
    [(*c, "masked") for c in LEVEL_CASES] + [(*c, "branch") for c in LEVEL_CASES],
    ids=LEVEL_IDS + [f"{i}_branch" for i in LEVEL_IDS])
def test_static_level_matches_track_level(ref_maps, lvl, budget, runs, form):
    """The same estimate, inlier share, residual and iteration count, bit
    for bit: level 0 exits before its 50 iterations, level 1 runs to a cap
    of 3, level 3 solves rotation only and exits before its 20.  The
    static level in its uncaptured form (unrolled to the budget, masked
    after the exit: `_track_level_static`) and as its WHILE node runs it
    (`branch`: the in-place iteration repeated while the read-back loop
    test holds, as the device repeats the node's body)."""
    cams, vw, nw, depth, T0 = ref_maps
    d = _t(depth)
    for _ in range(lvl):
        d = ttrk._subsample_depth(d)
    li = min(lvl, 3)
    args = (_t(T0), d, _t(vw), _t(nw), _t(ttrk._level_cam(cams[0].K, lvl, True)), budget,
            lvl >= ttrk.ROTATION_ONLY_FROM_LEVEL,
            _t(np.linalg.inv(cams[0].c2w.astype(np.float32))),
            ttrk._scalar(ttrk.SPACE_THRESH[li], "cpu"), ttrk._scalar(ttrk.TUKEY_C[li], "cpu"))
    T, inl, mr, n = ttrk._track_level(*args)
    if form == "masked":
        Ts, inls, mrs, ns = ttrk._track_level_static(*args)
    else:
        lv = ttrk._StaticLevel(*args)
        while bool(lv.more):
            lv.iterate()
        Ts, inls, mrs, ns = lv.result()
    assert int(ns) == n
    assert 1 < n < budget if runs == "exit" else n == budget
    for a, b in ((T, Ts), (inl, inls), (mr, mrs)):
        assert torch.equal(a, b)


# --------------------------------------------------------- (b) pyramid

def test_static_pyramid_matches_jax_track_pyramid(ref_maps, tmp_path):
    """`track_pyramid_static` against the JAX `track_pyramid` (both invert
    the reference pose on the device) and the JAX `ICPTracker.track` (on
    the host).  The two JAX routes end 6.8e-4 apart on this input (a
    Levenberg-Marquardt accept/reject that goes the other way, on last
    bits); the port, whose sums and products round in the order of
    `icp_gn_cuda`, follows the first, which inverts the reference pose as
    it does: pose within 1e-5 of it and within 1e-3 of
    `ICPTracker.track`, inlier share within 1e-3, residual within 1e-5 m."""
    cams, vw, nw, depth, T0 = ref_maps
    K = cams[0].K
    Tj, ij, mj = jtrk.track_pyramid(
        jnp.asarray(T0), jnp.asarray(depth), jnp.asarray(vw), jnp.asarray(nw),
        jnp.asarray(np.array([K[0, 0], K[1, 1], K[0, 2], K[1, 2]], np.float32)),
        jtrk.LEVEL_ITERS)
    Te, _ = jtrk.ICPTracker(JConfig.from_dict(_config_dict(tmp_path, cams)), 160, 120).track(
        T0, jnp.asarray(depth), {"vertex_map": jnp.asarray(vw), "normal_map": jnp.asarray(nw)},
        K)
    Tt, it_, mt, iters = ttrk.track_pyramid_static(_t(T0), _t(depth), _t(vw), _t(nw), K,
                                                   ttrk.LEVEL_ITERS)
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), atol=1e-5)
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Te), atol=1e-3)
    assert abs(float(it_) - float(ij)) <= 1e-3
    assert abs(float(mt) - float(mj)) <= 1e-5
    assert iters.shape == (4,) and bool((iters >= 1).all())


# ------------------------------------------------- (c, d) the frame

def _engine(tmp, cams, **kw):
    cfg = TConfig.from_dict(_config_dict(tmp, cams, **kw))
    W, H = cams[0].width, cams[0].height
    e = TEngine(cfg, W, H, cams[0].K, device="cpu")
    e.set_gt_poses([cams[0].c2w])
    e.attach_tracker(ttrk.make_tracker(cfg, W, H))
    return e


def test_megastep_frame_reads_nothing_back(tmp_path):
    """`track_fuse_step` (track, revert, fuse, the next prepare raycast,
    with the bilateral filter) after an eager first frame, under the guard
    that fails on every host read: what a CUDA graph cannot capture."""
    cams = synthetic.make_cameras(n_frames=2, width=96, height=72, look="in", arc=0.0125)
    e = _engine(tmp_path, cams)
    e.process_frame(cams[0].image, cams[0].depth)
    p, tr, c = e.params, e._tracker, cams[1]
    nb = e._n_blocks_dev
    nb.fill_(e.vol.n_blocks)
    args = (e.vol, nb, e._last_pose_dev, _t(c.depth[..., 0]), _t(c.image),
            e._last_raycast_for_tracking["vertex_map"],
            e._last_raycast_for_tracking["normal_map"])
    with NoHostReads():
        out = teng.track_fuse_step(
            *args, K=e.K, level_iters=tuple(tr.level_iters), space_thresh=tr.space_thresh,
            tukey_c=tr.tukey_c, bilateral=True,
            ray=(96, 72, p.raycast_lb, p.raycast_samples, max(p.raycast_bisect, 3)),
            prefix=1 << 12)
    assert bool(torch.isfinite(out["pose"]).all()) and float(out["inlier"]) > 0
    assert int(nb) > e.vol.n_blocks and tuple(out["vertex_map"].shape) == (72, 96, 3)


def test_level_budget_caps_a_launchs_passes(ref_maps):
    """A level's passes in one call (`icp_gn.iterate` at a budget, on the
    CPU its plain loop): made at budget 2, a level runs passes 0 and 1;
    `iterate(budget)` goes on from there, at most `budget` passes and
    none past the exit; the state and count bit for bit with one pass a
    call; the exit and the count those of `_track_level`."""
    cams, vw, nw, depth, T0 = ref_maps
    args = (_t(T0), _t(depth), _t(vw), _t(nw), _t(ttrk._level_cam(cams[0].K, 0, True)), 50,
            False, _t(np.linalg.inv(cams[0].c2w.astype(np.float32))),
            ttrk._scalar(ttrk.SPACE_THRESH[0], "cpu"), ttrk._scalar(ttrk.TUKEY_C[0], "cpu"))
    _, _, _, n = ttrk._track_level(*args)
    assert n > 3
    one = ttrk._StaticLevel(*args)
    one.iterate()
    two = ttrk._StaticLevel(*args, budget=2)
    assert int(two.n_run) == 2 and torch.equal(two.state, one.state)
    two.iterate(2)
    for _ in range(2):
        one.iterate()
    assert int(two.n_run) == 4 and torch.equal(two.state, one.state)
    two.iterate(100)
    while bool(one.more):
        one.iterate()
    assert int(two.n_run) == int(one.n_run) == n and not bool(two.more)
    assert torch.equal(two.state, one.state)
    before = two.state.clone()
    two.iterate(5)   # past the exit: the first pass of a call always runs
    assert int(two.n_run) == n + 1 and not torch.equal(two.state, before)


def test_failed_frame_keeps_its_pose(tmp_path):
    """On test_tracking.py's fixture (160x120): a frame with no depth is
    FAILED on the megastep route, its pose is the previous one and it
    fuses nothing; the next frame tracks again from that pose."""
    cams = synthetic.make_cameras(n_frames=16, width=160, height=120, look="in",
                                  arc=0.025)[:3]
    e = _engine(tmp_path, cams)
    assert e._can_fast_track()
    e.process_frame(cams[0].image, cams[0].depth)
    state = e.vol.state.clone()
    pose = e.process_frame(cams[1].image, np.zeros_like(cams[1].depth))
    assert e._tracking_quality == ttrk.TrackerQuality.FAILED
    np.testing.assert_array_equal(pose, e.cam_poses[0])
    assert torch.equal(e.vol.state, state)
    e.process_frame(cams[2].image, cams[2].depth)
    assert e._tracking_quality == ttrk.TrackerQuality.GOOD
    assert np.abs(e.cam_poses[2][:3, 3] - cams[2].c2w[:3, 3]).max() < e.params.voxel_size


# -------------------------------------------------------- (e) gates

GATES = {
    "none": {},
    "gt_pose": {"tsdf": {"use_gt_pose": True}},
    "color_tracker": {"tracker": {"type": "rgb"}},
    "composite_tracker": {"tracker": {"type": "composite"}},
    "stop_integration": {"tsdf": {"behaviour_on_failure": "stop_integration"}},
    "relocalise": {"tsdf": {"behaviour_on_failure": "relocalise"}},
    "swap": {"tpu": {"enable_swapping": 1}},
    "space_shards": {"tpu": {"space_shards": 2}},
}


@pytest.mark.parametrize("gate", list(GATES))
def test_can_fast_track_gates(tmp_path, gate):
    """The port's `_can_fast_track` answers as the JAX engine's, one gate
    at a time (the gt-pose engine: tracking off)."""
    cams = synthetic.make_cameras(n_frames=2, width=96, height=72)
    d = _config_dict(tmp_path, cams, **GATES[gate])
    W, H = 96, 72
    jc, tc = JConfig.from_dict(d), TConfig.from_dict(d)
    je = JEngine(jc, W, H, cams[0].K)
    te = TEngine(tc, W, H, cams[0].K, device="cpu")
    je.attach_tracker(jtrk.make_tracker(jc, W, H))
    te.attach_tracker(ttrk.make_tracker(tc, W, H))
    assert te._can_fast_track() == je._can_fast_track() == (gate == "none")


# ------------------------------------------------------ (f) lockstep

def test_megastep_lockstep_with_jax(tmp_path, monkeypatch):
    """8 frames of tests/test_tracking.py's fixture (160x120, look="in",
    arc 0.025) through the JAX engine's tracked megastep on its kernel
    branch (the packed integrate kernel in interpret mode) with its
    raycasts on the XLA march, whose semantics the port's tracking-prepare
    raycast takes, and through the port's, in lockstep: the port's pyramid
    tracks each frame from the JAX pose of the frame before and hands the
    JAX estimate on, so the port fuses and raycasts at the JAX engine's
    poses and both track every frame against maps of the same history.
    The JAX megastep splits this way: its prepare raycast is a call of its
    own after the fused step.  Every frame is GOOD in both packages here
    (at 96x72 every frame after the first is FAILED, and a pose gate would
    compare the JAX pose with itself).  Gates: equal labels, all GOOD,
    each frame's estimate within 1 voxel and 0.1 degree of the JAX one,
    and at least half of them within 1 mm.  Deviation from
    test_tracked_sequence_matches_jax's "all but one within 1 mm": the ICP
    answers the bf16 (JAX) and f32 (port) maps, and the JAX megastep
    compiled as one program rounds its level chain differently from the
    same levels run one by one (ROADMAP section 3); on the XLA march the
    estimates lie 0.005-0.6 mm from the JAX ones (on the TPU kernel's
    semantics 0.15-5.5 mm)."""
    from test_torch_slice import _jax_on_kernel_branch
    from test_torch_tracking import _jax_on_xla_raycast

    W, H, N = 160, 120, 8
    cams = synthetic.make_cameras(n_frames=16, width=W, height=H, look="in",
                                  arc=0.025)[:N]
    d = _config_dict(tmp_path, cams)
    jc, tc = JConfig.from_dict(d), TConfig.from_dict(d)
    _jax_on_kernel_branch(monkeypatch)
    _jax_on_xla_raycast(monkeypatch)
    je = JEngine(jc, W, H, cams[0].K)
    te = TEngine(tc, W, H, cams[0].K, device="cpu")
    for e, mod, cfg in ((je, jtrk, jc), (te, ttrk, tc)):
        e.set_gt_poses([cams[0].c2w])
        e.attach_tracker(mod.ICPTracker(cfg, W, H))
    assert je._can_fast_track() and te._can_fast_track()
    own = []
    track = ttrk.track_pyramid_static

    def lockstep(T0, *a, **kw):
        T, inl, mr, iters = track(T0, *a, **kw)
        own.append(T.numpy().copy())
        return _t(je.cam_poses[len(own)]), inl, mr, iters

    monkeypatch.setattr(ttrk, "track_pyramid_static", lockstep)
    qj, qt = [], []
    for c in cams:
        je.process_frame(jnp.asarray(c.image), jnp.asarray(c.depth))
        qj.append(je._tracking_quality)
        te.process_frame(c.image, c.depth)
        qt.append(te._tracking_quality)
    assert len(own) == N - 1 and qt == qj
    assert all(q == ttrk.TrackerQuality.GOOD for q in qt[1:]), qt
    vox = te.params.voxel_size
    d_mm = []
    for k, T in enumerate(own, 1):
        pj = np.asarray(je.cam_poses[k])
        d_mm.append(1000 * np.linalg.norm(T[:3, 3] - pj[:3, 3]))
        assert float(tse3.rot_angle_deg(_t(T[:3, :3]), _t(pj[:3, :3]))) < 0.1, k
    assert max(d_mm) < 1000 * vox, d_mm
    assert sum(v <= 1.0 for v in d_mm) >= len(d_mm) / 2, d_mm
