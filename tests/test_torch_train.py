"""The port's Adam window held against the JAX package: the per-attribute
Adam against optax, and `window_optimize` (tile-space L1 path and
image-space `compute_loss` path) against the JAX `window_optimize` from
the same pool, batch and camera order, plus the port's own check that its
two loss paths agree.

Inputs are made with numpy from a seed: the Gaussians are spawned by the
JAX package and carried across with `convert.pool_from_numpy`; the JAX
splat kernels run in interpret mode, the port through its kernels' plain
PyTorch versions (the CUDA kernels are held against those in
test_torch_cuda.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gps_slam_tpu.config import Config as JConfig
from gps_slam_tpu.data import synthetic
from gps_slam_tpu.gs import losses as jlosses
from gps_slam_tpu.gs import model as jmodel
from gps_slam_tpu.gs import optim as joptim
from gps_slam_tpu.gs import rasterize as jrast
from gps_slam_torch import convert
from gps_slam_torch.config import Config as TConfig
from gps_slam_torch.gs import model as tmodel
from gps_slam_torch.gs import optim as toptim

ITERS = 10
ROW_KEYS = ("means", "scales", "quats", "features_dc", "features_rest", "opacities")


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _config_dict(tmp, cam):
    node = {"input_dir": "mem", "image_path": "c", "pose_path": "c", "depth_path": "d",
            "pcd_name": "n", "depth_scale": 6553.5, "scene_scale": 1.0,
            "start_frame": 0, "end_frame": 2, "frame_step": 1,
            "intrinsics": [cam.fx, cam.fy, cam.cx, cam.cy],
            "image_shape": [cam.width, cam.height], "downscale_factor": 1,
            "test_split_interval": -1}
    return synthetic.default_config_dict(str(tmp), node)


def _window(tmp, W, H, seed):
    """Gaussians spawned by the JAX package on each of three synthetic
    cameras (they overlap little), and the window batch of the three: gt images, a reference
    depth near the gt depth with an empty band (as a raycast leaves holes)
    and a noisy base colour.  Returns the JAX model, the port's pool, the
    two configs and the batches."""
    rng = np.random.default_rng(seed)
    cams = synthetic.make_cameras(n_frames=3, width=W, height=H)
    d = _config_dict(tmp, cams[0])
    jcfg, tcfg = JConfig.from_dict(d), TConfig.from_dict(d)
    jm = jmodel.GaussianModel(jcfg, W, H)
    jm.statics = jm.statics._replace(splat_impl="pallas_interpret")
    mask = jnp.zeros((H, W), bool).at[::4, ::4].set(True)
    for cam in cams:
        fm = cam.get_frame_maps()
        jm.pool, n_added, _ = jmodel.add_gaussians(
            jm.pool, fm["vertex_map"], fm["color_map"], fm["normal_map"], mask, 0.6,
            1024, jcfg.model.default_opacities,
            (jcfg.model.min_init_scale, jcfg.model.max_init_scale), jm.next_rng())
        assert int(n_added) > 50
    pool_np = {k: np.array(v) for k, v in jm.pool.params.items()}
    alive = np.array(jm.pool.alive)
    ref = np.stack([c.depth[..., 0] * rng.uniform(0.98, 1.02, (H, W)) for c in cams])
    ref[:, :, :6] = 0.0
    base = np.clip(np.stack([c.image for c in cams])
                   + rng.normal(0, 0.1, (3, H, W, 3)), 0, 1)
    arrs = {"c2w": np.stack([c.c2w for c in cams]), "K": np.stack([c.K for c in cams]),
            "gt_rgb": np.stack([c.image for c in cams]),
            "gt_depth": np.stack([c.depth[..., 0] for c in cams]),
            "ref_depth": ref, "base_color": base}
    arrs = {k: np.asarray(v, np.float32) for k, v in arrs.items()}
    batch_j = {k: jnp.asarray(v) for k, v in arrs.items()}
    batch_j["cam_id"] = jnp.zeros((3,), jnp.int32)
    batch_t = {k: torch.as_tensor(v) for k, v in arrs.items()}
    batch_t["cam_id"] = [0, 0, 0]
    pt = convert.pool_from_numpy(pool_np, alive, "cpu")
    return jm, pool_np, alive, pt, jcfg, tcfg, batch_j, batch_t


def _jax_first_grads(pool_np, alive, st, batch, m, opt_cap, ssim_w, depth_w, tile):
    """(loss, grads) of the JAX window loop's first step on camera m,
    rebuilt from the package's public pieces exactly as window_optimize
    composes them."""
    tw, th = -(-st.width // st.tile_size), -(-st.height // st.tile_size)
    st = st._replace(visible_cap=min(st.visible_cap, opt_cap),
                     active_tile_cap=min(tw * th, st.active_tile_cap))
    p0 = {k: jnp.asarray(v if k == "exposure" else v[:opt_cap]) for k, v in pool_np.items()}
    calive = jnp.asarray(alive[:opt_cap])
    c2w, K = batch["c2w"][m], batch["K"][m]
    b = jmodel.ges_bin(p0, calive, c2w, K, st, margin_px=st.bin_margin_px)
    if tile:
        ref_c = jnp.where(batch["ref_depth"][m] < 0.01, 1000.0, batch["ref_depth"][m])
        h = jrast.hoist_window_tiles(b, ref_c, batch["gt_rgb"][m], batch["base_color"][m],
                                     st.width, st.height, st.tile_size, 64, opt_cap)

        def loss(p):
            proj, _, colors = jmodel._project_and_colors(p, calive, c2w, K, st)
            colors4 = jnp.concatenate([colors, proj.depths[:, None]], 1)
            out = jrast.ges_splat_tiles(
                proj.means2d, proj.conics, colors4, jax.nn.sigmoid(p["opacities"][:, 0]),
                proj.depths, h, st.delta_depth, impl=st.splat_impl,
                tiles_per_gaussian_cap=st.tiles_per_gaussian_cap)
            rgb_t = (out[:, :3] + h["base_t"]) / (out[:, 4:5] + 1.0)
            diff = jnp.abs(rgb_t - h["gt_t"]) * h["pxmask"][:, None, :]
            return (jnp.sum(diff) + h["inactive_sum"]) / float(st.width * st.height * 3)
    else:
        def loss(p):
            res = jmodel.ges_forward(p, calive, c2w, K, batch["ref_depth"][m],
                                     batch["base_color"][m], batch["cam_id"][m], st, bins=b)
            return jlosses.compute_loss(
                res["rgb"], res["depth"], batch["gt_rgb"][m], batch["gt_depth"][m],
                ssim_w, depth_w,
                gt_ssim_moments=jlosses.ssim_gt_moments(batch["gt_rgb"][m]))["total"]
    v, g = jax.value_and_grad(loss)(p0)
    return float(v), {k: np.asarray(x) for k, x in g.items()}


def _port_first_grads(pt, st, batch, m, opt_cap, ssim_w, depth_w, tile):
    tw, th = -(-st.width // st.tile_size), -(-st.height // st.tile_size)
    st = st._replace(visible_cap=min(st.visible_cap, opt_cap),
                     active_tile_cap=min(tw * th, st.active_tile_cap))
    p0 = {k: (v if k == "exposure" else v[:opt_cap]).detach().clone().requires_grad_(True)
          for k, v in pt.params.items()}
    _, loss_fn = tmodel.window_loss(p0, pt.alive[:opt_cap], batch, st, ssim_w, depth_w, tile)
    loss = loss_fn(m)
    loss.backward()
    return float(loss.detach()), {k: _np(v.grad) for k, v in p0.items() if k in ROW_KEYS}


def _check_grads(gt, gj):
    """Each gradient element within 1e-4 of its attribute's largest |grad|
    plus 2e-4 of its own value: the per-pair components differ by the
    splat backward's summation order (test_torch_gs's K5 tests), and the
    chain rule through the projection carries that relative error into
    the few rows whose quaternion gradients are orders of magnitude above
    the rest."""
    for k in ROW_KEYS:
        scale = np.abs(gj[k]).max()
        assert scale > 0, k
        np.testing.assert_allclose(gt[k], gj[k], rtol=2e-4, atol=1e-4 * scale, err_msg=k)


def _lr(tcfg):
    m = tcfg.model
    return {"means": m.means_lr, "scales": m.scales_lr, "quats": m.quats_lr,
            "features_dc": m.featuresDc_lr, "features_rest": m.featuresRest_lr,
            "opacities": m.opacities_lr}


def _check_final_params(pool_t, pool_j, alive, tcfg, iters):
    """Final parameters row by row, in units of each attribute's learning
    rate.  Adam divides each gradient by its running RMS, so a row whose
    gradient is near zero and differs in its last bits between the
    packages can take steps of up to +-lr in opposite directions.  The
    noise is the JAX side's: its backward sums pixels through moments
    (see the K5 tests), while the port's window in f32 and in f64 ends
    within 1e-2 lr on every row (test_window_optimize_f32_matches_f64).
    So every row is bounded by 2 lr iters, fewer than 10% of the live
    rows may end more than one step (lr) apart (measured on the tile
    path: at most 4.3%),
    and more than 60% must agree within 1e-3 lr (measured: at least 69%)."""
    n = int(alive.sum())
    for k, lr in _lr(tcfg).items():
        t = _np(getattr(pool_t, k))[:n].reshape(n, -1)
        j = np.asarray(getattr(pool_j, k))[:n].reshape(n, -1)
        d = np.abs(t - j).max(1) / lr
        stats = (k, d.max(), (d > 1).mean(), (d < 1e-3).mean())
        assert d.max() <= 2 * iters and (d > 1).mean() < 0.1, stats
        assert (d < 1e-3).mean() > 0.6, stats


# ---------------------------------------------------------------- Adam

def test_adam_matches_optax():
    """Five steps of the same random gradients through the port's
    per-attribute Adam and the JAX package's optax multi_transform give
    the same parameters within 1e-6, with max_iterations 7 so the means
    learning rate visibly decays (gamma = 0.01**(1/7))."""
    rng = np.random.default_rng(20)
    cfg = jmodel._TxCfg(0.01, 1e-4, 0.005, 0.001, 0.0025, 0.0005, 0.05, 0.003, False)
    shapes = {"means": (40, 3), "scales": (40, 3), "quats": (40, 4),
              "features_dc": (40, 3), "features_rest": (40, 15, 3),
              "opacities": (40, 1), "exposure": (1, 3, 4)}
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(5)]
    tx = joptim.make_optimizer(cfg, 7)
    pj = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(pj)
    pt = {k: torch.tensor(v, requires_grad=True) for k, v in p0.items()}
    opt = toptim.WindowAdam(pt, cfg, 7)
    for g in grads:
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, pj)
        pj = optax.apply_updates(pj, upd)
        for k, v in pt.items():
            v.grad = torch.as_tensor(g[k])
        opt.step()
    for k in shapes:
        np.testing.assert_allclose(_np(pt[k]), np.asarray(pj[k]), rtol=0, atol=1e-6,
                                   err_msg=k)
    np.testing.assert_array_equal(_np(pt["exposure"]), p0["exposure"])
    moved = np.abs(_np(pt["means"]) - p0["means"]).max()
    assert 0.01 < moved < 0.05


# ---------------------------------------------------------------- window_optimize

@pytest.mark.parametrize("path", ["tile", "image"])
def test_window_optimize_matches_jax(tmp_path, path):
    """One window of 10 Adam steps over three cameras from the same pool,
    batch and camera order.  tile: the release-config loss (ssim and depth
    weights 0, tile-space L1) at 64x48.  image: ssim 0.2 and depth 0.1 on
    a non-zero reference depth through compute_loss at 100x72 (a width
    that is not a multiple of 16).  First-step loss within 1e-5 relative
    and grads as in _check_grads.  The loss history: every step within
    5e-3 relative and at least 7 of the 10 within 1e-4 (measured: 8).
    Later steps start from parameters that differ as _check_final_params
    allows, and a camera that sees the rows Adam moved apart (measured:
    quaternions of ~60 rows, up to 2.4e-4 after 3 steps) renders up to
    3.3e-3 off, while the other cameras' steps stay at 1e-6.  Final
    parameters as in _check_final_params."""
    tile = path == "tile"
    W, H = (64, 48) if tile else (100, 72)
    ssim_w, depth_w = (0.0, 0.0) if tile else (0.2, 0.1)
    jm, pool_np, alive, pt, jcfg, tcfg, bj, bt = _window(tmp_path, W, H, seed=21)
    st_j = jm.statics
    st_t = tmodel.RenderStatics(*st_j[:-1])
    opt_cap = jm.opt_cap()
    idx = [0, 2, 1, 1, 0, 2, 2, 0, 1, 0][:ITERS]

    lj, gj = _jax_first_grads(pool_np, alive, st_j, bj, idx[0], opt_cap, ssim_w,
                              depth_w, tile)
    lt, gt = _port_first_grads(pt, st_t, bt, idx[0], opt_cap, ssim_w, depth_w, tile)
    np.testing.assert_allclose(lt, lj, rtol=1e-5)
    _check_grads(gt, gj)

    pool_j, aux_j = jmodel.window_optimize(
        jm.pool, bj, jnp.asarray(idx, jnp.int32), st_j, jmodel.tx_cfg_tuple(jcfg.model),
        jcfg.pipe.max_iterations, ssim_w, depth_w, opt_cap, None)
    pool_t, aux_t = tmodel.window_optimize(
        pt, bt, idx, st_t, tcfg.model, tcfg.pipe.max_iterations,
        ssim_w, depth_w, opt_cap)
    hj, ht = np.asarray(aux_j["loss_hist"]), _np(aux_t["loss_hist"])
    assert ht.shape == (ITERS,) and np.isfinite(ht).all()
    rel = np.abs(ht - hj) / np.abs(hj)
    assert rel[0] <= 1e-5 and rel.max() <= 5e-3 and (rel <= 1e-4).sum() >= 7, rel
    for k in ("n_tile_overflow", "n_span_overflow", "n_active_overflow"):
        assert aux_t[k] == int(aux_j[k]), k
    _check_final_params(pool_t, pool_j, alive, tcfg, ITERS)


def test_window_optimize_f32_matches_f64(tmp_path):
    """The port's tile-path window of test_window_optimize_matches_jax in
    f32 against the same window in f64 (plain path, the same pool, batch
    and camera order): every live row of every attribute ends within
    1e-2 of its learning rate beyond the f32 run's storage rounding
    (measured: at most 4.8e-3, on the colour features; 5 of 345 rows
    above 1e-3), and the loss history agrees within 1e-5 relative.  This
    is what holds the wider bound of _check_final_params on the JAX
    package: the port's own rounding moves no row by more than a
    hundredth of one Adam step, so the rows that end one or more steps
    away from the JAX run take their difference from the JAX side's
    moment-form backward."""
    import dataclasses

    W, H = 64, 48
    jm, pool_np, alive, pt, _, tcfg, _, bt = _window(tmp_path, W, H, seed=21)
    st = tmodel.RenderStatics(*jm.statics[:-1])
    opt_cap = jm.opt_cap()
    idx = [0, 2, 1, 1, 0, 2, 2, 0, 1, 0][:ITERS]
    p64 = convert.pool_from_numpy(pool_np, alive, "cpu")
    p64 = dataclasses.replace(p64, **{k: v.double() for k, v in p64.params.items()})
    b64 = {k: v.double() if torch.is_tensor(v) and k != "K" else v for k, v in bt.items()}
    pool_32, aux_32 = tmodel.window_optimize(pt, bt, idx, st, tcfg.model,
                                             tcfg.pipe.max_iterations, 0.0, 0.0, opt_cap)
    default = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        pool_64, aux_64 = tmodel.window_optimize(p64, b64, idx, st, tcfg.model,
                                                 tcfg.pipe.max_iterations, 0.0, 0.0, opt_cap)
    finally:
        torch.set_default_dtype(default)
    assert pool_64.means.dtype == torch.float64
    np.testing.assert_allclose(_np(aux_32["loss_hist"]), _np(aux_64["loss_hist"]), rtol=1e-5)
    n = int(alive.sum())
    for k, lr in _lr(tcfg).items():
        a = _np(getattr(pool_32, k))[:n].reshape(n, -1).astype(np.float64)
        b = _np(getattr(pool_64, k))[:n].reshape(n, -1)
        # net of the f32 run's own storage rounding: each step rounds the
        # updated value to f32, half an ulp (2**-24 relative) at most
        excess = (np.abs(a - b) - ITERS * 2.0 ** -24 * np.abs(b)) / lr
        assert excess.max() <= 1e-2, (k, excess.max())
        assert np.abs(b - pool_np[k][:n].reshape(n, -1)).max() > 0.5 * lr, k


def test_tile_space_loss_matches_image_space(tmp_path):
    """The port's own two loss paths agree (as tests/test_gs_fit.py checks
    the JAX package's): with ssim and depth weights 0 the tile-space L1 and
    the image-space compute_loss give the same loss within 1e-5 relative
    and the same gradients within 1e-6 + 1e-4 relative, at 100x72 where
    edge tiles overhang the image."""
    _, _, _, pt, _, tcfg, _, bt = _window(tmp_path, 100, 72, seed=22)
    st = tmodel.GaussianModel(tcfg, 100, 72, device="cpu").statics
    out = []
    for tile in (True, False):
        p0 = {k: (v if k == "exposure" else v[:4096]).detach().clone().requires_grad_(True)
              for k, v in pt.params.items()}
        _, loss_fn = tmodel.window_loss(p0, pt.alive[:4096], bt, st, 0.0, 0.0, tile)
        loss = loss_fn(1)
        loss.backward()
        out.append((float(loss.detach()), {k: _np(p0[k].grad) for k in ROW_KEYS}))
    (l0, g0), (l1, g1) = out
    np.testing.assert_allclose(l0, l1, rtol=1e-5)
    for k in ROW_KEYS:
        assert np.abs(g1[k]).max() > 0, k
        np.testing.assert_allclose(g0[k], g1[k], rtol=1e-4, atol=1e-6, err_msg=k)


def test_check_key_frame_error_matches_jax(tmp_path):
    """After a window, each sampled keyframe's masked L1 (render vs gt
    where the raycast hit), frame id, mean raycast confidence and
    over-threshold count, recorded by both pipelines on the same pool,
    cameras and raycast maps: the loss within 1e-5 relative (the renders
    agree as in test_torch_gs's ges_forward test), the rest equal."""
    from types import SimpleNamespace

    from gps_slam_tpu.slam.pipeline import SLAMPipeline as JPipeline
    from gps_slam_torch.data import synthetic as tsyn
    from gps_slam_torch.slam.pipeline import SLAMPipeline as TPipeline

    W, H = 64, 48
    jm, _, _, pt, jcfg, tcfg, bj, bt = _window(tmp_path, W, H, seed=23)
    tm = tmodel.GaussianModel(tcfg, W, H, device="cpu")
    tm.pool = pt
    conf = np.random.default_rng(24).uniform(size=(3, H, W, 1)).astype(np.float32)
    pipes = {}
    for name, cams, pipe, arr in (
            ("jax", synthetic.make_cameras(n_frames=3, width=W, height=H),
             JPipeline(jcfg, SimpleNamespace(), str(tmp_path / "j"), is_train=False),
             jnp.asarray),
            ("torch", tsyn.make_cameras(n_frames=3, width=W, height=H),
             TPipeline(tcfg, SimpleNamespace(device=torch.device("cpu")),
                       str(tmp_path / "t"), is_train=False), torch.as_tensor)):
        for c in cams:
            c.c2w_slam = c.c2w
        pipe.curr_frame_id = 5
        pipe.localframe_cam_window = cams[:1]
        pipe.opt_cam_list = list(cams)
        pipe.opt_raycast_list = [
            {"depth_map": arr(_np(bt["ref_depth"][i])[..., None]),
             "color_map": arr(_np(bt["base_color"][i])), "confidence_map": arr(conf[i])}
            for i in range(3)]
        pipe.check_key_frame_error(jm if name == "jax" else tm)
        pipes[name] = pipe.keyframe_loss_dict
    dj, dt = pipes["jax"], pipes["torch"]
    assert sorted(dt) == sorted(dj) and len(dt) == 2
    for fid, vj in dj.items():
        vt = dt[fid]
        assert vt[0] > 0
        np.testing.assert_allclose(vt[0], vj[0], rtol=1e-5)
        np.testing.assert_allclose(vt[2], vj[2], rtol=1e-6)
        assert (vt[1], vt[3]) == (vj[1], vj[3])
