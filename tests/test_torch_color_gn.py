"""The plain version of `color_gn_cuda` (gps_slam_torch/slam/color_gn.py),
one Gauss-Newton iteration of a colour-tracker level, on the CPU: against
the JAX `_track_level_color` at 1, 2 and 3 iterations on every pyramid
level in both rotation modes, on tests/test_tracking.py's colour setup (the
old view's exact points and colours, a new rgb 2.2 cm away) from a seeded
start; its f64 sums in the kernel's order rounding like the single sum;
the colour tracker's reject branch and a singular system; the plain level
loop (`run_plain`, which the CPU routes take) against the per-pass loop
with a host read of the step after each pass; and a composite engine run
in lockstep with the JAX engine.

The kernel itself runs only on the card (tests/test_torch_cuda.py)."""

import math

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
from gps_slam_torch.slam import color_gn, icp_gn
from gps_slam_torch.slam import tracker as ttrk


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """A level's iteration is dozens of small torch ops; one thread per
    test worker keeps them from handing work between threads (the sums
    are f64 in a fixed order: the results do not depend on the thread
    count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.as_tensor(np.asarray(x))


W, H = 160, 120


@pytest.fixture(scope="module")
def color_setup():
    """tests/test_tracking.py's colour setup: frame 0's world points from
    compute_vertex_map and its colours at the tracker's stride 4 (1,200
    points), the rgb rendered 2.2 cm away, its pyramid and Sobel
    gradients (the JAX package's, fed to both), and a start w2c: frame 0's
    under a small seeded twist."""
    cams = synthetic.make_cameras(n_frames=2, width=W, height=H, look="in")
    cam = cams[0]
    vm = np.asarray(jse3.compute_vertex_map(jnp.asarray(cam.depth[..., 0]),
                                            cam.fx, cam.fy, cam.cx, cam.cy))
    vw = (vm.reshape(-1, 3) @ cam.c2w[:3, :3].T + cam.c2w[:3, 3]).reshape(vm.shape)
    s = 4
    pts = vw[::s, ::s].reshape(-1, 3).astype(np.float32)
    col = np.asarray(cam.image)[::s, ::s].reshape(-1, 3).astype(np.float32)
    valid = np.abs(pts).sum(-1) > 0
    true_pose = cam.c2w.copy()
    true_pose[:3, 3] += np.array([0.012, 0.0, 0.018], np.float32)
    rgb, _ = synthetic.render_frame(true_pose, W, H, cam.fx, cam.fy, cam.cx, cam.cy)
    levels = [jnp.asarray(rgb).reshape(H, W, 3)]
    for _ in range(3):
        levels.append(jtrk._downsample_rgb(levels[-1]))
    pyr = [(np.asarray(im), *(np.asarray(g) for g in jse3._sobel(im))) for im in levels]
    xi = np.random.default_rng(16).normal(size=6).astype(np.float32)
    xi *= np.array([0.004, 0.004, 0.004, 0.003, 0.003, 0.003], np.float32)
    M0 = (np.asarray(jse3.se3_exp(jnp.asarray(xi)))
          @ np.linalg.inv(cam.c2w)).astype(np.float32)
    return cam, pts, col, valid, pyr, M0


def _level(color_setup, lvl):
    cam, pts, col, valid, pyr, M0 = color_setup
    return M0, pts, col, valid, *pyr[lvl], ttrk._level_cam(cam.K, lvl, False)


# JAX's projection is a matmul and its sums run in f32 in XLA's order; the
# port's are written term by term with f64 sums.  From the same start the
# two give the same inliers and their residuals, systems and accepted
# poses within these tolerances at every level in both modes:
POSE_ATOL = 1e-5
RESIDUAL_ATOL = 1e-6


@pytest.mark.parametrize("rot", [False, True], ids=["full", "rotation-only"])
@pytest.mark.parametrize("lvl", [3, 2, 1, 0])
def test_plain_iteration_matches_jax(color_setup, lvl, rot):
    """`_track_level_color` (the plain version on the CPU) against the JAX
    one with budgets 1, 2 and 3 at each level, full twist and rotation
    only: the same iteration count and inlier count, the accepted w2c
    within POSE_ATOL, the residual within RESIDUAL_ATOL.  After one
    iteration the accepted estimate is the start, bit for bit; at level 3
    both packages reject the second and third steps (the reject branch),
    at the other levels they accept them."""
    M0, pts, col, valid, rgb, gx, gy, cam = _level(color_setup, lvl)
    for n in (1, 2, 3):
        Mj, ij, mj, nj = jtrk._track_level_color(
            jnp.asarray(M0), jnp.asarray(pts), jnp.asarray(col), jnp.asarray(valid),
            jnp.asarray(rgb), jnp.asarray(gx), jnp.asarray(gy), n, rot, jnp.asarray(cam))
        Mt, it_, mt, nt = ttrk._track_level_color(
            _t(M0), _t(pts), _t(col), _t(valid), _t(rgb), _t(gx), _t(gy), n, rot, _t(cam))
        assert nt == int(nj) == n
        assert round(float(it_) * len(pts)) == round(float(ij) * len(pts)) > len(pts) / 2
        assert abs(float(mt) - float(mj)) <= RESIDUAL_ATOL, (float(mt), float(mj))
        np.testing.assert_allclose(Mt.numpy(), np.asarray(Mj), atol=POSE_ATOL)
        if n == 1:
            assert torch.equal(Mt, _t(M0))


@pytest.mark.parametrize("lvl", [0, 1, 2, 3])
def test_plain_level_loop_matches_the_per_pass_loop(color_setup, lvl):
    """The plain level loop that the CPU routes take (`color_gn.iterate` at
    budget n_iters: `run_plain`, `iterate_plain` pass after pass while the
    device flag `more` holds) against the per-pass loop of the eager route
    before the level kernel (`iterate_plain` once a pass, the host reading
    `step` after each), from the level's start at its budget and rotation
    mode, at every level: the state, the iterations run and the loop's
    test bit for bit, and `_track_level_color` returns that state's
    estimate, inlier share, residual and count."""
    M0, pts, col, valid, rgb, gx, gy, cam = (_t(x) for x in _level(color_setup, lvl))
    n_iters = ttrk.LEVEL_ITERS[lvl]
    rot = lvl >= ttrk.ROTATION_ONLY_FROM_LEVEL
    inputs = (pts, col, valid, rgb, gx, gy, cam, rot, n_iters, ttrk._STEP_EXIT)

    def fresh():
        return (torch.cat([M0.reshape(-1), M0.reshape(-1),
                           torch.tensor([float("inf"), 1e-3, 0.0, 0.0, 0.0])]),
                torch.zeros((), dtype=torch.int64), torch.zeros((), dtype=torch.bool))

    s, n, m = fresh()
    color_gn.iterate_plain(*inputs, s, n, m, first=True)
    it, step = 1, float(s[color_gn.STEP])
    while it < n_iters and step > ttrk._STEP_EXIT:
        color_gn.iterate_plain(*inputs, s, n, m)
        it += 1
        step = float(s[color_gn.STEP])
    s2, n2, m2 = fresh()
    color_gn.iterate(*inputs, s2, n2, m2, None, first=True, budget=n_iters)
    assert torch.equal(s2, s) and int(n2) == int(n) == it and torch.equal(m2, m)
    assert it > 1 and not bool(m2)
    M, inl, mr, n3 = ttrk._track_level_color(M0, pts, col, valid, rgb, gx, gy, n_iters, rot,
                                             cam)
    assert n3 == it and torch.equal(M, s[16:32].view(4, 4))
    assert torch.equal(inl, s[35]) and torch.equal(mr, s[36])


@pytest.mark.parametrize("lvl", [3, 2, 1, 0])
def test_sums_round_like_the_single_sum(color_setup, lvl):
    """The 44 sums of a level's terms at the start and after one
    iteration, in the kernel's CTA blocks (`icp_gn.totals`) and in other
    block shapes, round to the same f32 values as the exact sum
    (math.fsum) and as torch's single f64 sum."""
    M0, pts, col, valid, rgb, gx, gy, cam = _level(color_setup, lvl)
    args = (_t(pts), _t(col), _t(valid), _t(rgb), _t(gx), _t(gy), _t(cam))
    state = torch.cat([_t(M0).reshape(-1), _t(M0).reshape(-1),
                       torch.tensor([float("inf"), 1e-3, 0.0, 0.0, 0.0])])
    n_run, more = torch.zeros((), dtype=torch.int64), torch.zeros((), dtype=torch.bool)
    color_gn.iterate(*args, lvl >= 2, 10, ttrk._STEP_EXIT, state, n_run, more, first=True)
    for M in (_t(M0), state[:16].view(4, 4)):
        x = color_gn.terms(M, *args, lvl >= 2)
        exact = torch.tensor([math.fsum(c) for c in x.T.tolist()]).float()
        assert torch.equal(x.sum(0).float(), exact)
        assert float(exact[43]) > 50   # an iteration with inliers
        assert torch.equal(icp_gn.totals(x).float(), exact)
        for rounds, pix in ((1, 1), (2, 1), (1, 2), (4, 4)):
            rows = icp_gn.cta_sums(x, rounds, pix)
            tot = icp_gn.cta_sums(rows, -(-rows.shape[0] // icp_gn.NT))[0]
            assert torch.equal(tot.float(), exact), (rounds, pix)


def _tot(H, g, sq=5.0, n_ok=900.0):
    return torch.cat([H.double().reshape(-1), g.double(),
                      torch.tensor([sq, n_ok], dtype=torch.float64)])


def _state(M, M_acc, err_acc, lam=1e-3):
    return torch.cat([M.reshape(-1), M_acc.reshape(-1),
                      torch.tensor([err_acc, lam, 0.0, 0.0, 0.0])])


M_A = torch.tensor([[1.0, 0.0, 0.0, 0.5], [0.0, 0.0, -1.0, 0.2], [0.0, 1.0, 0.0, 1.5],
                    [0.0, 0.0, 0.0, 1.0]])


def test_reject_damps_the_new_system():
    """A worse step (its error above the accepted one) goes back to the
    accepted estimate with 10x damping, and the step is solved from the
    system of this iteration, not a carried one (the JAX colour tracker's
    rule, unlike ICP's): M_acc and err_acc kept, lam x 10, and the new
    estimate se3_exp(delta) M_acc with delta within 1e-5 of numpy's f64
    solve of that damped system.  The same sums after a better error are
    accepted from the trial estimate with the damping relaxed."""
    rng = np.random.default_rng(3)
    A = rng.normal(size=(6, 6)).astype(np.float32)
    Hm = torch.as_tensor(A @ A.T + 6 * np.eye(6, dtype=np.float32))
    g = torch.as_tensor(rng.normal(size=6).astype(np.float32)) * 0.1
    M_trial = icp_gn._se3_exp(torch.tensor([0.01, 0.0, 0.0, 0.0, 0.02, 0.0])) @ M_A
    n_pts = torch.tensor(1200.0)
    err = float(np.float32(5.0 / 900.0))
    new = color_gn.lm_step(_state(M_trial, M_A, err_acc=err / 2), _tot(Hm, g), n_pts, False)
    assert torch.equal(new[16:32].view(4, 4), M_A)
    assert float(new[32]) == np.float32(err / 2)
    assert float(new[33]) == np.float32(np.float32(1e-3) * np.float32(10.0))
    lam = float(new[33])
    Hd = Hm.double().numpy()
    damped = Hd + lam * np.diag(np.diag(Hd)) + 1e-2 * (np.trace(Hd) / 6 + 1e-9) * np.eye(6)
    delta = np.linalg.solve(damped, -g.double().numpy())
    want = icp_gn._se3_exp(torch.as_tensor(delta, dtype=torch.float32)) @ M_A
    np.testing.assert_allclose(new[:16].view(4, 4).numpy(), want.numpy(), atol=1e-5)
    assert float(new[34]) == pytest.approx(float((delta ** 2).sum()), rel=1e-4)
    assert float(new[35]) == np.float32(900.0) / np.float32(1200.0)
    assert float(new[36]) == pytest.approx(math.sqrt(err), rel=1e-6)
    kept = color_gn.lm_step(_state(M_trial, M_A, err_acc=2 * err), _tot(Hm, g), n_pts, False)
    assert torch.equal(kept[16:32].view(4, 4), M_trial) and float(kept[32]) == np.float32(err)
    assert float(kept[33]) == np.float32(np.float32(1e-3) * np.float32(0.1))


def test_singular_system_gives_a_zero_step():
    """A damped system with two equal rows (a zero pivot), one with a NaN,
    and too few inliers (err inf): the step keeps the accepted estimate
    (M bit for bit, step 0), as the JAX tracker's `ok_solve` does.  A
    regular system moves it."""
    n_pts = torch.tensor(1200.0)
    g = torch.arange(1.0, 7.0)
    H = torch.zeros(6, 6)
    # zero diagonal: the damping is the floor c (the step's own f32
    # expression), and rows 0, 1 of the damped system are equal
    c = 1e-2 * (torch.tensor(0.0) / torch.tensor(6.0) + 1e-9)
    H[0, 1] = H[1, 0] = c
    assert not bool(icp_gn.solve6(H + c * torch.eye(6), -g)[1])
    H_nan = torch.eye(6)
    H_nan[2, 4] = float("nan")
    for Hs, n_ok in ((H, 900.0), (H_nan, 900.0), (torch.eye(6), 50.0)):
        new = color_gn.lm_step(_state(M_A, M_A, float("inf")), _tot(Hs, g, n_ok=n_ok),
                               n_pts, True)
        assert torch.equal(new[:16].view(4, 4), M_A) and float(new[34]) == 0.0
    moved = color_gn.lm_step(_state(M_A, M_A, float("inf")), _tot(torch.eye(6), g * 1e-3),
                             n_pts, True)
    assert float(moved[34]) > 0 and not torch.equal(moved[:16].view(4, 4), M_A)


def _config(tmp, cams, tracker):
    c = cams[0]
    d = synthetic.default_config_dict(str(tmp), {
        "input_dir": "mem", "image_path": "c", "pose_path": "c", "depth_path": "d",
        "pcd_name": "n", "depth_scale": 6553.5, "scene_scale": 1.0, "start_frame": 0,
        "end_frame": len(cams) - 1, "frame_step": 1,
        "intrinsics": [c.fx, c.fy, c.cx, c.cy], "image_shape": [W, H],
        "downscale_factor": 1, "test_split_interval": -1})
    d["PIPE"]["TSDF"]["use_gt_pose"] = False
    d["PIPE"]["TSDF"]["tracker"] = {"type": tracker}
    return JConfig.from_dict(d), TConfig.from_dict(d)


def _fixture_cams(n):
    """The first n frames of tests/test_tracking.py's fixture (160x120,
    16 frames, look="in", arc 0.025, 2 cm voxels)."""
    return synthetic.make_cameras(n_frames=16, width=W, height=H, look="in", arc=0.025)[:n]


def test_composite_engine_lockstep_with_jax(tmp_path, monkeypatch):
    """4 frames of tests/test_tracking.py's fixture through the JAX engine
    with the composite tracker (colour refine, then ICP; the eager route
    its engine takes for them), the port's composite tracker fed the same
    maps, frame and start pose each frame: both stages give equal labels.
    Each colour level the JAX tracker ran, replayed on the port's level
    from the same inputs (start, points, image, budget): the same inlier
    count and the residual within RESIDUAL_ATOL at every level, and the
    same iterations with the accepted w2c within POSE_ATOL at all but one
    of the 12: there (frame 3, level 2) the 19th step's error is one f32
    ulp above the accepted error in JAX's f32 sums and equal to it in the
    port's f64 ones, so JAX rejects the step and exits at 19 where the
    port accepts it and runs 23 (the poses 5e-5 apart).  The LM
    accept/reject compares errors on their last bits; sums in another
    order move them (as the ICP levels' are, ROADMAP's known deviations).
    The colour stage FAILS on every tracked
    frame in both packages, the JAX package's own label: inliers 0.80-0.83
    but a residual of 0.41-0.56, above its 0.10 gate, against the prepare
    raycast's dark colour map; ICP then tracks from the last pose."""
    cams = _fixture_cams(4)
    jc, tc = _config(tmp_path, cams, "composite")
    levels = []
    orig = jtrk._track_level_color

    def rec(*a):
        out = orig(*a)
        levels.append((a, out))
        return out

    monkeypatch.setattr(jtrk, "_track_level_color", rec)
    jcomp, tcomp = jtrk.make_tracker(jc, W, H), ttrk.make_tracker(tc, W, H)
    stages = {"jax": [], "port": []}
    for side, comp in (("jax", jcomp), ("port", tcomp)):
        for trk in comp.trackers:
            def rec_stage(*a, _track=trk.track, _trk=trk, _side=side, **kw):
                pose, q = _track(*a, **kw)
                stages[_side].append((type(_trk).__name__, q, _trk.last_inlier,
                                      _trk.last_residual))
                return pose, q
            trk.track = rec_stage

    class Lockstep:
        needs_color = True

        def track(self, last_pose, depth, maps, K, rgb=None):
            tmaps = {k: _t(maps[k]) for k in ("vertex_map", "normal_map", "color_map")}
            tcomp.track(np.asarray(last_pose), _t(depth), tmaps, K, rgb=_t(rgb))
            return jcomp.track(last_pose, depth, maps, K, rgb=rgb)

    je = JEngine(jc, W, H, cams[0].K)
    je.set_gt_poses([cams[0].c2w])
    je.attach_tracker(Lockstep())
    for cam in cams:
        je.process_frame(jnp.asarray(cam.image), jnp.asarray(cam.depth))
    js, ts = stages["jax"], stages["port"]
    assert len(js) == len(ts) == 2 * (len(cams) - 1)
    assert [s[:2] for s in ts] == [s[:2] for s in js]
    for (name, q, inl, res), (_, _, inl_j, res_j) in zip(ts, js):
        if name == "ColorTracker":
            assert q == ttrk.TrackerQuality.FAILED
            assert inl_j > 0.15 and res_j > 0.10
            assert abs(inl - inl_j) <= 2e-7 and abs(res - res_j) <= 1e-3, (inl, inl_j, res,
                                                                          res_j)
    assert len(levels) == 4 * (len(cams) - 1)
    flips = []
    for k, (a, (Mj, ij, mj, nj)) in enumerate(levels):
        Mt, it_, mt, nt = ttrk._track_level_color(
            *(_t(x) for x in a[:7]), a[7], a[8], _t(a[9]))
        n_pts = a[1].shape[0]
        assert round(float(it_) * n_pts) == round(float(ij) * n_pts)
        assert abs(float(mt) - float(mj)) <= RESIDUAL_ATOL
        if nt != int(nj):
            flips.append((k // 4 + 1, 3 - k % 4, int(nj), nt))
            continue
        np.testing.assert_allclose(Mt.numpy(), np.asarray(Mj), atol=POSE_ATOL)
    assert flips == [(3, 2, 19, 23)]


def test_frame1_inlier_gap_is_the_marchs_hit_mask(tmp_path):
    """The fixture's frame 1 through the colour tracker: on the JAX
    engine's tracking-prepare maps the port's tracker counts the JAX
    tracker's inliers exactly.  The port's own engine counts fewer: its
    maps come from its march (the tracking mode) and its fusion, and the
    port's march on the JAX engine's volume gives the same count as the
    port's engine, its residual within RESIDUAL_ATOL (fusion adds nothing
    to the gap).  The gap is the
    march's hit mask: the points the XLA march hits and the port's misses
    (its bf16 reads' thin set of flipped pixels, test_torch_tracking_maps)
    are inliers of the JAX tracker, one for one."""
    from gps_slam_torch import convert
    from gps_slam_torch.tsdf.engine import TsdfEngine as TEngine

    cams = _fixture_cams(2)
    c = cams[0]
    jc, tc = _config(tmp_path, cams, "rgb")
    je = JEngine(jc, W, H, c.K)
    te = TEngine(tc, W, H, c.K, device="cpu")
    for e in (je, te):
        e.set_gt_poses([c.c2w])
        e.turn_off_tracking()
    je.process_frame(jnp.asarray(c.image), jnp.asarray(c.depth))
    te.process_frame(c.image, c.depth)
    jm = je.run_raycast(c.c2w)
    on_jax_volume = TEngine(tc, W, H, c.K, device="cpu")
    on_jax_volume.shards = [convert.volume_from_numpy(
        {k: np.asarray(getattr(je.vol, k)) for k in (
            "table_keys", "table_ptrs", "block_coords", "state", "color", "summary",
            "n_blocks", "last_seen")}, te.params, "cpu")]
    maps = {"jax": {k: _t(jm[k]) for k in ("vertex_map", "color_map")},
            "port": te.run_raycast(c.c2w, need_color=True, track=True),
            "port march, JAX volume": on_jax_volume.run_raycast(c.c2w, need_color=True,
                                                                track=True)}
    rgb = cams[1].image
    jt = jtrk.ColorTracker(jc, W, H)
    jt.track(c.c2w, None, jm, c.K, rgb=jnp.asarray(rgb))
    n_pts = (W // 4) * (H // 4)
    got, hits = {}, {}
    for name, m in maps.items():
        tr = ttrk.ColorTracker(tc, W, H)
        tr.track(c.c2w, None, m, c.K, rgb=_t(rgb))
        got[name] = (round(tr.last_inlier * n_pts), tr.last_residual, tr.last_iters)
        hits[name] = m["vertex_map"][::4, ::4].reshape(-1, 3).abs().sum(-1) > 0
    assert got["jax"][0] == round(jt.last_inlier * n_pts)
    assert got["port"][0] == got["port march, JAX volume"][0]
    assert abs(got["port"][1] - got["port march, JAX volume"][1]) <= RESIDUAL_ATOL
    lost = hits["jax"] & ~hits["port"]
    assert not (hits["port"] & ~hits["jax"]).any() and 0 < int(lost.sum()) <= 0.005 * n_pts
    assert got["jax"][0] - got["port"][0] == int(lost.sum())


def test_pyramid_and_gradients_match_jax():
    """The colour tracker's pyramid and image gradients, each sum written
    out in one order (so that the card and the CPU agree bit for bit):
    within 1e-6 of the JAX `_downsample_rgb` and `_sobel` (whose sums XLA
    orders) on a seeded image with an odd size, and equal to the port's
    `_sobel` convolution within 1e-6."""
    from gps_slam_torch.utils import se3 as tse3

    img = np.random.default_rng(8).random((61, 83, 3)).astype(np.float32)
    j, t = jnp.asarray(img), _t(img)
    for _ in range(3):
        for got, want in zip(ttrk._gradients(t), jse3._sobel(j)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
        for got, want in zip(ttrk._gradients(t), tse3._sobel(t)):
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)
        j, t = jtrk._downsample_rgb(j), ttrk._downsample_rgb(t)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-6)
