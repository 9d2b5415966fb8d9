"""The port's offline trainer (`raw` classic 3DGS with densify, offline
GES) against the JAX package at 96x72: the camera selector, the SH ramp,
depth-ordered binning, the classic compositor and its gradients,
`raw_forward` with its means2d probe, densify with the JAX split noise
injected, the opacity reset, the Adam moments' row surgery, the offline
Adam against optax, short `raw_train_cams` / `ges_train_cams` runs of both
packages from one pool, and the JAX tests' own training gates on the port.

Numpy inputs made from a seed go through both packages; the Gaussians are
spawned by the JAX package and carried across with
`convert.pool_from_numpy`.  Each test states its tolerance."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gps_slam_tpu.config import Config as JConfig
from gps_slam_tpu.data import reader as jreader
from gps_slam_tpu.data import synthetic
from gps_slam_tpu.gs import densify as jdens
from gps_slam_tpu.gs import losses as jlosses
from gps_slam_tpu.gs import model as jmodel
from gps_slam_tpu.gs import optim as joptim
from gps_slam_tpu.gs import params as jparams
from gps_slam_tpu.gs import rasterize_classic as jrc
from gps_slam_tpu.gs import sh as jsh
from gps_slam_tpu.slam import offline as joff
from gps_slam_torch import convert
from gps_slam_torch.config import Config as TConfig
from gps_slam_torch.data import reader as treader
from gps_slam_torch.gs import densify as tdens
from gps_slam_torch.gs import losses as tlosses
from gps_slam_torch.gs import model as tmodel
from gps_slam_torch.gs import optim as toptim
from gps_slam_torch.gs import rasterize_classic as trc
from gps_slam_torch.gs import sh as tsh
from gps_slam_torch.slam import offline as toff

W, H = 96, 72
ROW_KEYS = ("means", "scales", "quats", "features_dc", "features_rest", "opacities")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The offline loops are many small torch ops at 96x72; one thread per
    test worker keeps them from handing work between threads.  Module
    scope sets it before the module's other fixtures run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _config_dict(tmp, cams, method="raw", iters=50, densify=True):
    """tests/test_raw_mode.py's offline configuration."""
    c = cams[0]
    node = {"input_dir": "x", "image_path": "c", "pose_path": "c", "depth_path": "d",
            "pcd_name": "n", "depth_scale": 6553.5, "scene_scale": 1.0,
            "start_frame": 0, "end_frame": len(cams) - 1, "frame_step": 1,
            "intrinsics": [c.fx, c.fy, c.cx, c.cy], "image_shape": [W, H],
            "downscale_factor": 1, "test_split_interval": -1}
    d = synthetic.default_config_dict(str(tmp), node)
    d["MODEL"]["render_method"] = method
    d["PIPE"]["max_iterations"] = iters
    d["PIPE"]["enable_densify"] = densify
    d["MODEL"].update(densify_start_iter=10, densify_interval=20, densify_end_iter=45,
                      reset_opacity_interval=1000)
    return d


@functools.lru_cache(maxsize=None)
def _spawned(stride: int, ratio: float):
    """The JAX package's spawn from frame 0 (a pixel grid of `stride`,
    `ratio` of it taken, tests/test_raw_mode.py's and tests/test_aux.py's
    init): numpy params and alive mask of its pool; callers copy."""
    cams = synthetic.make_cameras(n_frames=3, width=W, height=H)
    jm = jmodel.GaussianModel(JConfig.from_dict(_config_dict("/nonexistent", cams)), W, H)
    fm = cams[0].get_frame_maps()
    mask = jnp.zeros((H, W), bool).at[::stride, ::stride].set(True)
    jm.pool, _, _ = jmodel.add_gaussians(
        jm.pool, fm["vertex_map"], fm["color_map"], fm["normal_map"], mask,
        ratio, 1024, 0.5, (-1.0, 0.05), jm.next_rng())
    return {k: np.array(v) for k, v in jm.pool.params.items()}, np.array(jm.pool.alive)


def _models(tmp, cams, d, stride=3, ratio=1.0):
    """The JAX and the port's GaussianModel holding one spawned pool."""
    params, alive = _spawned(stride, ratio)
    jm = jmodel.GaussianModel(JConfig.from_dict(d), W, H)
    jm.pool = jm.pool.with_params({k: jnp.asarray(v) for k, v in params.items()}).replace(
        alive=jnp.asarray(alive), n_alive=jnp.asarray(alive.sum(), jnp.int32))
    tm = tmodel.GaussianModel(TConfig.from_dict(d), W, H, device="cpu")
    tm.pool = convert.pool_from_numpy(params, alive, "cpu")
    return jm, tm


def test_random_selector_matches_jax():
    """The same numpy generator seed draws the same camera sequence across
    reshuffles: equal."""
    js = jreader.RandomSelector(list(range(5)), np.random.default_rng(7))
    ts = treader.RandomSelector(list(range(5)), np.random.default_rng(7))
    assert [js.get_next() for _ in range(23)] == [ts.get_next() for _ in range(23)]


def test_eval_sh_active_degree_matches_jax():
    """Degree-3 SH with the ramp at 0..3 and without it: within 2e-6 of
    the JAX package (f32); bands above the active one contribute nothing."""
    rng = np.random.default_rng(1)
    dirs = rng.normal(size=(300, 3)).astype(np.float32)
    coeffs = rng.normal(size=(300, 16, 3)).astype(np.float32)
    mask = rng.uniform(size=300) > 0.2
    outs = []
    for a in (None, 0, 1, 2, 3):
        ja = None if a is None else jnp.asarray(a, jnp.int32)
        ta = None if a is None else torch.tensor(a, dtype=torch.int32)
        j = jsh.eval_sh(3, jnp.asarray(dirs), jnp.asarray(coeffs), jnp.asarray(mask), ja)
        t = tsh.eval_sh(3, torch.as_tensor(dirs), torch.as_tensor(coeffs),
                        torch.as_tensor(mask), ta)
        np.testing.assert_allclose(_np(t), np.asarray(j), rtol=0, atol=2e-6, err_msg=str(a))
        outs.append(_np(t))
    np.testing.assert_array_equal(outs[0], outs[4])
    np.testing.assert_allclose(outs[1][mask], 0.28209479177387814 * coeffs[mask, 0],
                               rtol=1e-6, atol=1e-7)


def _rand_gaussians(rng, n, conic=(0.02, 0.5)):
    m2d = np.stack([rng.uniform(-10, W + 10, n), rng.uniform(-10, H + 10, n)], -1)
    a = rng.uniform(*conic, n)
    c = rng.uniform(*conic, n)
    b = rng.uniform(-0.5, 0.5, n) * np.sqrt(a * c)
    return {"means2d": m2d.astype(np.float32),
            "conics": np.stack([a, b, c], -1).astype(np.float32),
            "colors": rng.uniform(0, 1, (n, 4)).astype(np.float32),
            "opac": rng.uniform(0.05, 0.99, n).astype(np.float32),
            # depths on a coarse grid: ties exercise the stable order
            "depths": (rng.integers(1, 12, n) * 0.25).astype(np.float32),
            "radii": np.where(rng.uniform(size=n) < 0.15, 0,
                              rng.integers(1, 40, n)).astype(np.int32)}


def test_bin_gaussians_depth_matches_jax():
    """300 Gaussians (15% with radius 0, tied depths, bboxes past the frame
    and past the 3x3-tile span cap) into 8-slot lists: equal valid masks,
    equal Gaussian ids in every valid slot, equal pair and overflow
    counts."""
    g = _rand_gaussians(np.random.default_rng(2), 300)
    args = (6, 5, 250, 9, 8)  # tile_w, tile_h, visible cap, tiles cap, list cap
    jb = jrc.bin_gaussians_depth(jnp.asarray(g["means2d"]), jnp.asarray(g["radii"]),
                                 jnp.asarray(g["depths"]), 16, *args)
    tb = trc.bin_gaussians_depth(torch.as_tensor(g["means2d"]), torch.as_tensor(g["radii"]),
                                 torch.as_tensor(g["depths"]), 16, *args)
    valid = np.asarray(jb.valid)
    np.testing.assert_array_equal(_np(tb.valid), valid)
    np.testing.assert_array_equal(_np(tb.gids)[valid], np.asarray(jb.gids)[valid])
    assert (tb.n_pairs, tb.n_tile_overflow, tb.n_span_overflow) == (
        int(jb.n_pairs), int(jb.n_tile_overflow), int(jb.n_span_overflow))
    assert tb.n_tile_overflow > 0 and tb.n_span_overflow > 0 and valid.all(1).any()


def test_classic_rasterize_matches_jax_grad():
    """The compositor over 300 wide Gaussians at 96x72 (64-slot lists, some
    full, T < 1e-4 reached on 6.7% of the pixels): render and alpha within
    2e-6 of the JAX package; the
    gradients of sum(render * R) + sum(alpha * A) in means2d, conics,
    colours and opacities against `jax.grad` of the same function within
    1e-5 of each input's largest |gradient| plus 1e-4 of its own value
    (measured: forward 3.0e-7, gradients 6.3e-7 of the largest and 3.4e-5
    of their own value; f32 sums in another order)."""
    rng = np.random.default_rng(4)
    g = _rand_gaussians(rng, 300, conic=(0.005, 0.05))
    g["opac"] = rng.uniform(0.5, 0.99, 300).astype(np.float32)
    R = rng.normal(size=(H, W, 4)).astype(np.float32)
    A = rng.normal(size=(H, W)).astype(np.float32)
    jb = jrc.bin_gaussians_depth(jnp.asarray(g["means2d"]), jnp.asarray(g["radii"]),
                                 jnp.asarray(g["depths"]), 16, 6, 5, 300, 16, 64)
    tb = trc.bin_gaussians_depth(torch.as_tensor(g["means2d"]), torch.as_tensor(g["radii"]),
                                 torch.as_tensor(g["depths"]), 16, 6, 5, 300, 16, 64)
    names = ("means2d", "conics", "colors", "opac")

    def jloss(*xs):
        r, a = jrc.classic_rasterize(*xs, jb, W, H, 16)
        return jnp.sum(r * R) + jnp.sum(a * A), (r, a)

    (_, (jr, ja)), jg = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2, 3), has_aux=True))(
        *(jnp.asarray(g[k]) for k in names))
    xs = [torch.tensor(g[k], requires_grad=True) for k in names]
    tr, ta = trc.classic_rasterize(*xs, tb, W, H, 16)
    ((tr * torch.as_tensor(R)).sum() + (ta * torch.as_tensor(A)).sum()).backward()
    np.testing.assert_allclose(_np(tr), np.asarray(jr), rtol=0, atol=2e-6)
    np.testing.assert_allclose(_np(ta), np.asarray(ja), rtol=0, atol=2e-6)
    assert (np.asarray(ja) > 0.9999).mean() > 0.01 and tb.n_tile_overflow > 0
    for name, x, gj in zip(names, xs, jg):
        gj = np.asarray(gj)
        np.testing.assert_allclose(_np(x.grad), gj, rtol=1e-4,
                                   atol=1e-5 * np.abs(gj).max(), err_msg=name)


def test_raw_forward_and_probe_grad_match_jax(tmp_path):
    """`raw_forward` of the spawned pool from camera 0 with the SH ramp at
    degree 0: rgb, depth and alpha within 1e-5 (depth on pixels with alpha
    above 1e-3, where it is not 0/0); the L1 loss's gradient in the means2d
    probe and in each parameter against `jax.grad` within 1e-4 of its
    largest |gradient| plus 2e-4 of its own value (measured: 3.2e-6 of the
    largest); the projected means within 2e-5 px and the (gaussian, tile)
    pair counts within 0.5%."""
    cams = synthetic.make_cameras(n_frames=3, width=W, height=H)
    jm, tm = _models(tmp_path, cams, _config_dict(tmp_path, cams))
    cam, C = cams[0], jm.pool.capacity
    gt = cam.image

    def jloss(params, probe):
        res = jmodel.raw_forward(params, jm.pool.alive, jnp.asarray(cam.c2w),
                                 jnp.asarray(cam.K), jnp.asarray(1), jm.statics,
                                 means2d_probe=probe,
                                 active_sh_degree=jnp.asarray(0, jnp.int32))
        return jlosses.compute_loss(res["rgb"], res["depth"], jnp.asarray(gt), None,
                                    0.0, 0.0)["total"], res

    (_, jres), (jgp, jgprobe) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(
        jm.pool.params, jnp.zeros((C, 2)))
    params = {k: v.clone().requires_grad_(True) for k, v in tm.pool.params.items()}
    probe = torch.zeros((C, 2), requires_grad=True)
    tres = tmodel.raw_forward(params, tm.pool.alive, torch.as_tensor(cam.c2w), cam.K, 1,
                              tm.statics, means2d_probe=probe,
                              active_sh_degree=torch.tensor(0, dtype=torch.int32))
    tlosses.compute_loss(tres["rgb"], tres["depth"], torch.as_tensor(gt), None,
                         0.0, 0.0)["total"].backward()
    for k in ("rgb", "alpha"):
        np.testing.assert_allclose(_np(tres[k]), np.asarray(jres[k]), rtol=0, atol=1e-5,
                                   err_msg=k)
    lit = np.asarray(jres["alpha"]) > 1e-3
    np.testing.assert_allclose(_np(tres["depth"])[lit], np.asarray(jres["depth"])[lit],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(_np(tres["radii"]), np.asarray(jres["radii"]))
    # the projected means differ by an ulp (7.6e-6 px measured), which moves
    # a few bboxes' edges across a tile border: 4 of 2776 pairs measured
    np.testing.assert_allclose(_np(tres["means2d"]), np.asarray(jres["means2d"]),
                               rtol=0, atol=2e-5)
    assert abs(tres["n_pairs"] - int(jres["n_pairs"])) <= 0.005 * int(jres["n_pairs"])
    # at SH degree 0 the higher bands get no gradient in either package
    assert not _np(params["features_rest"].grad).any()
    assert not np.asarray(jgp["features_rest"]).any()
    grads = [("probe", probe.grad, jgprobe)] + [(k, params[k].grad, jgp[k]) for k in ROW_KEYS
                                                if k != "features_rest"]
    for name, t, j in grads:
        j = np.asarray(j)
        assert np.abs(j).max() > 0, name
        np.testing.assert_allclose(_np(t), j, rtol=2e-4, atol=1e-4 * np.abs(j).max(),
                                   err_msg=name)


def _densify_pool(rng):
    """60 live Gaussians of a 256-row pool, anisotropic: 20 small and 20
    large ones with screen gradients above the threshold, 20 more without,
    some of them nearly transparent or past 0.1 x the scene scale."""
    pool = jparams.create(256, sh_degree=1)
    n = 60
    attrs = jparams.init_attributes(
        jnp.asarray(rng.normal(size=(n, 3)).astype(np.float32)),
        jnp.asarray(rng.uniform(0, 1, (n, 3)).astype(np.float32)), None, 1, 0.5, 0.5, -1.0)
    size = np.concatenate([np.tile([0.001, 0.02], 20), rng.choice([0.001, 0.3], 20)])
    scales = np.log(size[:, None] * rng.uniform(0.5, 1.0, (n, 3))).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    opac = rng.choice([-6.0, 0.0, 2.0], size=(n, 1)).astype(np.float32)
    attrs.update(scales=jnp.asarray(scales),
                 quats=jnp.asarray(quats / np.linalg.norm(quats, axis=1, keepdims=True)),
                 opacities=jnp.asarray(opac))
    pool = jparams.add(pool, attrs, jnp.asarray(n, jnp.int32))
    grad2d = np.zeros(256, np.float32)
    grad2d[:40] = 1.0
    viscnt = np.where(np.arange(256) < n, rng.integers(1, 4, 256), 0).astype(np.float32)
    return pool, grad2d, viscnt


@pytest.mark.parametrize("allow_scale_prune", [False, True])
def test_densify_step_matches_jax(allow_scale_prune):
    """One densify round (max_new 24: clones and splits both past their
    caps) with the JAX split noise injected: equal alive masks, touched
    rows and counts; every live row's parameters equal, the split samples'
    means within 1e-6 (R diag(s) n summed in another order)."""
    pool, grad2d, viscnt = _densify_pool(np.random.default_rng(5))
    key = jax.random.PRNGKey(3)
    thr = [0.2, 0.01, 0.05, 0.01]
    p_np = {k: np.array(v) for k, v in pool.params.items()}
    tpool = convert.pool_from_numpy(p_np, np.array(pool.alive), "cpu")
    jpool, jt, js = jdens.densify_step(
        pool, jnp.asarray(grad2d), jnp.asarray(viscnt), key, jnp.asarray(0.5),
        jnp.asarray(thr), 24, jnp.asarray(allow_scale_prune))
    noise = np.asarray(jax.random.normal(key, tdens.split_noise_shape(24)))
    tpool, tt, ts = tdens.densify_step(
        tpool, torch.as_tensor(grad2d), torch.as_tensor(viscnt), None,
        torch.tensor(0.5), torch.tensor(thr), 24, allow_scale_prune,
        noise=torch.as_tensor(noise))
    assert ts == {k: int(v) for k, v in js.items()}
    assert ts["n_dup"] == 12 and ts["n_split"] == 6 and ts["n_pruned"] > 6
    np.testing.assert_array_equal(_np(tpool.alive), np.asarray(jpool.alive))
    np.testing.assert_array_equal(_np(tt), np.asarray(jt))
    assert tpool.n_alive == int(jpool.n_alive)
    live = np.asarray(jpool.alive)
    for k in ROW_KEYS:
        np.testing.assert_allclose(_np(getattr(tpool, k))[live],
                                   np.asarray(getattr(jpool, k))[live],
                                   rtol=0, atol=1e-6 if k == "means" else 0, err_msg=k)


def _optax_moments(state):
    """{attribute: (mu, nu, count)} of the JAX offline optimizer's state."""
    out = {}
    for label, ms in state.inner_states.items():
        adam = ms.inner_state[0]
        out[label] = (np.asarray(adam.mu[label]), np.asarray(adam.nu[label]),
                      int(adam.count))
    return out


def test_offline_adam_and_zero_state_rows_match_optax(tmp_path):
    """The offline optimizer (one WindowAdam over max_iterations 6, the
    JAX `make_optimizer` with its means decay) over 6 steps of the same
    random gradients, with `zero_state_rows` on a random row mask after
    step 3 (the moments of those rows zeroed, the step count kept, as the
    JAX function does): parameters within 2 ulp of optax's on every
    element and moments within 1e-7 after the surgery (measured: both bit
    for bit); and `reset_opacities` equal to the JAX one."""
    cams = synthetic.make_cameras(n_frames=3, width=W, height=H)
    d = _config_dict(tmp_path, cams, iters=6)
    jcfg, tcfg = JConfig.from_dict(d), TConfig.from_dict(d)
    rng = np.random.default_rng(6)
    C = 50
    shapes = {"means": (C, 3), "scales": (C, 3), "quats": (C, 4), "features_dc": (C, 3),
              "features_rest": (C, 3, 3), "opacities": (C, 1), "exposure": (1, 3, 4)}
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    mask = rng.uniform(size=C) < 0.3
    tx = joptim.make_optimizer(jcfg.model, 6)
    pj = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(pj)
    pt = {k: torch.tensor(v) for k, v in p0.items()}
    opt = toptim.WindowAdam(pt, tcfg.model, 6)
    for step in range(6):
        g = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, pj)
        pj = optax.apply_updates(pj, upd)
        for k, v in pt.items():
            v.grad = torch.as_tensor(g[k])
        opt.step()
        if step == 2:
            state = joptim.zero_state_rows(state, jnp.asarray(mask))
            toptim.zero_state_rows(opt, torch.as_tensor(mask))
            jm = _optax_moments(state)
            for k in ROW_KEYS:
                assert jm[k][2] == opt.count == 3
                assert not _np(opt.mu[k])[mask].any() and not _np(opt.nu[k])[mask].any()
                np.testing.assert_allclose(_np(opt.mu[k]), jm[k][0], rtol=0, atol=1e-7)
                np.testing.assert_allclose(_np(opt.nu[k]), jm[k][1], rtol=0, atol=1e-7)
    for k in shapes:
        j = np.asarray(pj[k])
        ulp = np.abs(_np(pt[k]) - j) / np.spacing(np.abs(j))
        assert ulp.max() <= 2, (k, ulp.max())
    jpool = jparams.create(64, sh_degree=1)
    jpool = jpool.replace(opacities=jnp.asarray(rng.normal(size=(64, 1)).astype(np.float32) * 4))
    tpool = convert.pool_from_numpy({k: np.array(v) for k, v in jpool.params.items()},
                                    np.array(jpool.alive), "cpu")
    jpool = jdens.reset_opacities(jpool, jnp.asarray(0.01))
    tdens.reset_opacities(tpool, torch.tensor(0.01))
    np.testing.assert_array_equal(_np(tpool.opacities), np.asarray(jpool.opacities))


def _record_iters(monkeypatch, mod, out):
    """Wrap `mod._train_iter` to record each iteration's camera and loss."""
    orig = mod._train_iter

    def rec(pool, opt, cam, *a, **kw):
        res = orig(pool, opt, cam, *a, **kw)
        out.append((int(np.asarray(_np(cam["cam_id"]))), float(_np(res[2] if mod is joff
                                                                    else res[0]))))
        return res

    monkeypatch.setattr(mod, "_train_iter", rec)


def _check_trained(tm, jm, lr):
    """Live rows' parameters after training, in units of each attribute's
    learning rate: every row within half a step (Adam's steps are +-lr for
    a row whose gradient is near zero and differs in its last bits, so a
    row that took one such step the other way would be a full lr off)."""
    live = np.asarray(jm.pool.alive)
    for k, r in lr.items():
        t = _np(getattr(tm.pool, k))[live].reshape(int(live.sum()), -1)
        j = np.asarray(getattr(jm.pool, k))[live].reshape(int(live.sum()), -1)
        dist = np.abs(t - j).max(1) / r
        assert dist.max() <= 0.5, (k, dist.max())


def _lrs(m):
    return {"means": m.means_lr, "scales": m.scales_lr, "quats": m.quats_lr,
            "features_dc": m.featuresDc_lr, "features_rest": m.featuresRest_lr,
            "opacities": m.opacities_lr}


def test_raw_train_cams_matches_jax(tmp_path, monkeypatch):
    """12 raw iterations with densify at 5 and 10 (start 3, interval 5,
    end 12; the pause after an opacity reset, 100 iterations from
    iteration 0, set to 0 in both packages so that densify runs this early)
    in both packages from one spawned pool, one selector seed and the JAX
    split noise injected: the same cameras in the same order, each
    iteration's loss within 1e-5 (measured 9e-8), the same alive rows
    after each densify and at the end, and every live row's trained
    parameters within half a learning-rate step (measured: 0.009)."""
    cams = synthetic.make_cameras(n_frames=3, width=W, height=H)
    d = _config_dict(tmp_path, cams, iters=12)
    d["PIPE"]["log_iter"] = 1000
    d["MODEL"].update(densify_start_iter=3, densify_interval=5, densify_end_iter=12)
    jm, tm = _models(tmp_path, cams, d)
    noises, alive = [], []
    jstep, tstep = jdens.densify_step, tdens.densify_step

    def jrec(pool, g2, vc, key, scale, thr, max_new, allow):
        noises.append(np.asarray(jax.random.normal(key, tdens.split_noise_shape(max_new))))
        out = jstep(pool, g2, vc, key, scale, thr, max_new, allow)
        alive.append(np.array(out[0].alive))  # a copy: the next step donates the pool
        return out

    def trec(pool, g2, vc, gen, scale, thr, max_new, allow):
        out = tstep(pool, g2, vc, gen, scale, thr, max_new, allow,
                    noise=torch.as_tensor(noises[len(alive) - len(noises)]))
        alive.append(_np(out[0].alive).copy())  # the pool changes in place
        return out

    monkeypatch.setattr(jdens, "densify_step", jrec)
    monkeypatch.setattr(tdens, "densify_step", trec)
    monkeypatch.setattr(jdens, "PAUSE_REFINE_AFTER_RESET", 0)
    monkeypatch.setattr(tdens, "PAUSE_REFINE_AFTER_RESET", 0)
    jl, tl = [], []
    _record_iters(monkeypatch, joff, jl)
    _record_iters(monkeypatch, toff, tl)
    joff.OfflinePipeline(JConfig.from_dict(d), str(tmp_path / "j")).raw_train_cams(jm, cams)
    toff.OfflinePipeline(TConfig.from_dict(d), str(tmp_path / "t")).raw_train_cams(tm, cams)
    assert len(tl) == len(jl) == 12 and len(noises) == 2 and len(alive) == 4
    assert [c for c, _ in tl] == [c for c, _ in jl]
    np.testing.assert_allclose([v for _, v in tl], [v for _, v in jl], rtol=0, atol=1e-5)
    for a, b in zip(alive[:2], alive[2:]):
        np.testing.assert_array_equal(b, a)
    assert not tm.pool_compact and tm.opt_cap() == tm.pool.capacity
    np.testing.assert_array_equal(_np(tm.pool.alive), np.asarray(jm.pool.alive))
    _check_trained(tm, jm, _lrs(tm.cfg.model))


def test_ges_train_cams_matches_jax(tmp_path, monkeypatch):
    """2 offline GES iterations in both packages (the JAX splat kernels in
    interpret mode) from one spawned pool against the same raycast-like
    targets (depth near the gt, a noisy base colour), one selector seed:
    the same cameras, losses within 1e-5 (measured 7e-9), and every live
    row's trained parameters within half a learning-rate step (measured:
    0.069)."""
    cams = synthetic.make_cameras(n_frames=3, width=W, height=H)
    d = _config_dict(tmp_path, cams, method="ges", iters=2, densify=False)
    jm, tm = _models(tmp_path, cams, d, stride=2, ratio=0.5)
    jm.statics = jm.statics._replace(splat_impl="pallas_interpret")
    rng = np.random.default_rng(8)
    targets = [{"depth_map": (c.depth * rng.uniform(0.98, 1.02, c.depth.shape)).astype(np.float32),
                "color_map": np.clip(c.image + rng.normal(0, 0.1, c.image.shape), 0, 1)
                .astype(np.float32)} for c in cams]
    jl, tl = [], []
    _record_iters(monkeypatch, joff, jl)
    _record_iters(monkeypatch, toff, tl)
    joff.OfflinePipeline(JConfig.from_dict(d), str(tmp_path / "j")).ges_train_cams(
        jm, cams, [{k: jnp.asarray(v) for k, v in t.items()} for t in targets])
    toff.OfflinePipeline(TConfig.from_dict(d), str(tmp_path / "t")).ges_train_cams(
        tm, cams, targets)
    assert len(tl) == len(jl) == 2
    assert [c for c, _ in tl] == [c for c, _ in jl]
    np.testing.assert_allclose([v for _, v in tl], [v for _, v in jl], rtol=0, atol=1e-5)
    _check_trained(tm, jm, _lrs(tm.cfg.model))


def test_port_raw_training_gains_1db(tmp_path):
    """tests/test_raw_mode.py's gate on the port: 50 raw iterations with
    densify on (which pauses for them: they all fall in the 100 iterations
    after the opacity reset at iteration 0) from the frame-0 spawn raise
    camera 0's PSNR by more than 1 dB."""
    cams = synthetic.make_cameras(n_frames=3, width=W, height=H)
    d = _config_dict(tmp_path, cams)
    _, tm = _models(tmp_path, cams, d)
    cam = cams[0]

    def psnr():
        with torch.no_grad():
            r = tmodel.raw_forward(tm.pool.params, tm.pool.alive, torch.as_tensor(cam.c2w),
                                   cam.K, 0, tm.statics)
        return float(tlosses.psnr(torch.clamp(r["rgb"], 0, 1), torch.as_tensor(cam.image)))

    p0 = psnr()
    toff.OfflinePipeline(TConfig.from_dict(d), str(tmp_path)).raw_train_cams(tm, cams)
    p1 = psnr()
    assert p1 > p0 + 1.0, (p0, p1)


def test_port_offline_ges_lowers_l1(tmp_path):
    """tests/test_aux.py's gate on the port: 25 offline GES iterations
    against empty targets lower camera 0's L1 to the gt image."""
    cams = synthetic.make_cameras(n_frames=2, width=W, height=H)
    d = _config_dict(tmp_path, cams, method="ges", iters=25, densify=False)
    _, tm = _models(tmp_path, cams, d, stride=2, ratio=0.5)
    targets = [{"depth_map": np.zeros((H, W, 1), np.float32),
                "color_map": np.zeros((H, W, 3), np.float32)} for _ in cams]
    cam = cams[0]

    def l1():
        with torch.no_grad():
            rgb = tm.forward(cam.c2w, cam.K, targets[0]["depth_map"],
                             targets[0]["color_map"])["rgb"]
        return float((rgb - torch.as_tensor(cam.image)).abs().mean())

    before = l1()
    toff.OfflinePipeline(TConfig.from_dict(d), str(tmp_path)).ges_train_cams(tm, cams, targets)
    assert l1() < before
