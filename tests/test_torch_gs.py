"""The port's Gaussian modules held against the JAX package: se3, SH,
projection, kNN, the pool, binning, the splat forward kernel (K4) and the
GES render.

Inputs are made with numpy from a seed and handed to both packages; the
JAX splat kernel runs in interpret mode, the port through K4's plain
PyTorch version (its CUDA kernel is held against that in
test_torch_cuda.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gps_slam_tpu.gs import knn as jknn
from gps_slam_tpu.gs import model as jmodel
from gps_slam_tpu.gs import params as jparams
from gps_slam_tpu.gs import projection as jproj
from gps_slam_tpu.gs import rasterize as jrast
from gps_slam_tpu.gs import sh as jsh
from gps_slam_tpu.gs import splat_pallas
from gps_slam_tpu.utils import se3 as jse3
from gps_slam_torch import convert
from gps_slam_torch.gs import knn as tknn
from gps_slam_torch.gs import model as tmodel
from gps_slam_torch.gs import params as tparams
from gps_slam_torch.gs import projection as tproj
from gps_slam_torch.gs import rasterize as trast
from gps_slam_torch.gs import sh as tsh
from gps_slam_torch.utils import se3 as tse3

RTOL = 1e-5   # f32 elementwise math in both packages; only op order differs


def _close(t, j, rtol=RTOL, atol=1e-6, err_msg=""):
    np.testing.assert_allclose(t.detach().cpu().numpy() if torch.is_tensor(t) else t,
                               np.asarray(j), rtol=rtol, atol=atol, err_msg=err_msg)


def _rand_pose(rng):
    q = rng.normal(size=4).astype(np.float32)
    R = np.asarray(jse3.quat_to_rotmat(jnp.asarray(q)))
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = R
    T[:3, 3] = rng.normal(size=3)
    return T


# ---------------------------------------------------------------- se3

def test_se3_matches_jax():
    """pose_inv, quat_to_rotmat, quat_between, vertex and normal maps
    agree with the JAX helpers within 1e-5 relative."""
    rng = np.random.default_rng(1)
    T = np.stack([_rand_pose(rng) for _ in range(5)])
    _close(tse3.pose_inv(torch.as_tensor(T)), jse3.pose_inv(jnp.asarray(T)), atol=1e-5)
    q = rng.normal(size=(50, 4)).astype(np.float32)
    _close(tse3.quat_to_rotmat(torch.as_tensor(q)), jse3.quat_to_rotmat(jnp.asarray(q)))
    a = rng.normal(size=(50, 3)).astype(np.float32)
    b = rng.normal(size=(50, 3)).astype(np.float32)
    b /= np.linalg.norm(b, axis=1, keepdims=True)
    _close(tse3.quat_between(torch.as_tensor(a), torch.as_tensor(b)),
           jse3.quat_between(jnp.asarray(a), jnp.asarray(b)), atol=1e-5)
    depth = rng.uniform(0.5, 3.0, (24, 32)).astype(np.float32)
    depth[3:6, 4:9] = 0.0
    vm_t = tse3.compute_vertex_map(torch.as_tensor(depth), 30.0, 31.0, 15.5, 11.5)
    vm_j = jse3.compute_vertex_map(jnp.asarray(depth), 30.0, 31.0, 15.5, 11.5)
    _close(vm_t, vm_j)
    _close(tse3.compute_normal_map(vm_t), jse3.compute_normal_map(vm_j), atol=1e-5)


def test_camera_frame_maps_match_jax():
    """Camera.get_frame_maps (world vertex/normal maps from the camera's
    own depth) on the same synthetic frame in both packages."""
    from gps_slam_tpu.data import synthetic as jsyn
    from gps_slam_torch.data import synthetic as tsyn

    cj = jsyn.make_cameras(n_frames=2, width=64, height=48)[1]
    ct = tsyn.make_cameras(n_frames=2, width=64, height=48)[1]
    np.testing.assert_array_equal(ct.depth, cj.depth)
    mj, mt = cj.get_frame_maps(), ct.get_frame_maps("cpu")
    for k in ("color_map", "vertex_map", "normal_map"):
        _close(mt[k], mj[k], atol=1e-5, err_msg=k)


# ---------------------------------------------------------------- SH

@pytest.mark.parametrize("degree", [0, 1, 2, 3, 4])
def test_eval_sh_matches_jax(degree):
    rng = np.random.default_rng(degree)
    n, k = 64, (degree + 1) ** 2
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    coeffs = rng.normal(size=(n, k, 3)).astype(np.float32)
    mask = rng.random(n) > 0.2
    _close(tsh.eval_sh(degree, torch.as_tensor(dirs), torch.as_tensor(coeffs),
                       torch.as_tensor(mask)),
           jsh.eval_sh(degree, jnp.asarray(dirs), jnp.asarray(coeffs), jnp.asarray(mask)),
           atol=1e-5)


# ---------------------------------------------------------------- projection

def test_project_matches_jax():
    """Projection values within 1e-5 relative; radii and culling equal."""
    rng = np.random.default_rng(2)
    n = 300
    means = rng.uniform([-2, -1.5, 0.0], [2, 1.5, 6.0], (n, 3)).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    scales = np.exp(rng.uniform(-5, -1, (n, 3))).astype(np.float32)
    valid = rng.random(n) > 0.1
    view = np.eye(4, dtype=np.float32)
    view[:3, 3] = [0.1, -0.2, 0.3]
    K = np.array([[60.0, 0, 47.5], [0, 60.0, 35.5], [0, 0, 1]], np.float32)
    pj = jproj.project(jnp.asarray(means), jnp.asarray(quats), jnp.asarray(scales),
                       jnp.asarray(view), jnp.asarray(K), 96, 72, valid=jnp.asarray(valid))
    pt = tproj.project(torch.as_tensor(means), torch.as_tensor(quats),
                       torch.as_tensor(scales), torch.as_tensor(view), K, 96, 72,
                       valid=torch.as_tensor(valid))
    vis = np.asarray(pj.radii) > 0
    assert vis.sum() > 100
    np.testing.assert_array_equal(pt.radii.numpy(), np.asarray(pj.radii))
    _close(pt.means2d, pj.means2d)
    _close(pt.depths, pj.depths)
    _close(pt.conics.numpy()[vis], np.asarray(pj.conics)[vis])


# ---------------------------------------------------------------- kNN / pool

def test_knn_morton_matches_jax():
    """Morton-window 3-NN distances within 1e-5 relative, with sentinel
    rows excluded from the bounding box."""
    rng = np.random.default_rng(3)
    pts = rng.uniform(size=(700, 3)).astype(np.float32)
    pts = np.concatenate([pts, np.full((100, 3), 1e6, np.float32)])
    valid = np.arange(800) < 700
    _close(tknn.mean_dist_sq_3nn_morton(torch.as_tensor(pts), 64, torch.as_tensor(valid))[:700],
           jknn.mean_dist_sq_3nn_morton(jnp.asarray(pts), 64, valid=jnp.asarray(valid))[:700],
           atol=1e-9)


def test_pool_init_add_remove_compact_match_jax():
    rng = np.random.default_rng(4)
    m = 40
    xyz = rng.uniform(-1, 1, (m, 3)).astype(np.float32)
    xyz[30:] = 1e6
    rgb = rng.uniform(size=(m, 3)).astype(np.float32)
    nrm = rng.normal(size=(m, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    nrm[::7] = 0.0
    aj = jparams.init_attributes(jnp.asarray(xyz), jnp.asarray(rgb), jnp.asarray(nrm),
                                 1, 0.5, 0.05, -1)
    at = tparams.init_attributes(torch.as_tensor(xyz), torch.as_tensor(rgb),
                                 torch.as_tensor(nrm), 1, 0.5, 0.05, -1)
    for k in aj:
        _close(at[k], aj[k], atol=1e-5, err_msg=k)
    pj = jparams.create(64, 1)
    pt = tparams.create(64, 1, device="cpu")
    pj = jparams.add(pj, aj, jnp.asarray(30, jnp.int32))
    tparams.add(pt, at, 30)
    kill = np.zeros(64, bool)
    kill[[2, 5, 11, 40]] = True
    pj = jparams.compact(jparams.remove(pj, jnp.asarray(kill)))
    tparams.compact(tparams.remove(pt, torch.as_tensor(kill)))
    assert pt.n_alive == int(pj.n_alive) == 27
    np.testing.assert_array_equal(pt.alive.numpy(), np.asarray(pj.alive))
    for k in tparams.ROW_KEYS:
        _close(getattr(pt, k), getattr(pj, k), atol=1e-5, err_msg=k)


def test_remove_redundant_matches_jax():
    rng = np.random.default_rng(5)
    pj = jparams.create(32, 1)
    n = 20
    attrs = {"means": rng.normal(size=(n, 3)), "scales": rng.uniform(-9, 0, (n, 3)),
             "quats": rng.normal(size=(n, 4)), "features_dc": rng.normal(size=(n, 3)),
             "features_rest": rng.normal(size=(n, 3, 3)),
             "opacities": rng.uniform(-7, 3, (n, 1))}
    attrs = {k: np.asarray(v, np.float32) for k, v in attrs.items()}
    pj = jparams.add(pj, {k: jnp.asarray(v) for k, v in attrs.items()},
                     jnp.asarray(n, jnp.int32))
    pt = convert.pool_from_numpy({k: np.asarray(v) for k, v in pj.params.items()},
                                 np.asarray(pj.alive), "cpu")
    pj2, nj = jmodel.remove_redundant(pj, jnp.asarray(0.0005), jnp.asarray(0.5),
                                      jnp.asarray(0.005))
    _, nt = tmodel.remove_redundant(pt, 0.0005, 0.5, 0.005)
    assert nt == int(nj) > 0
    np.testing.assert_array_equal(pt.alive.numpy(), np.asarray(pj2.alive))


# ---------------------------------------------------------------- binning + K4

def _splat_scene(rng, n=60, H=48, W=64):
    m2d = np.stack([rng.uniform(2, W - 2, n), rng.uniform(2, H - 2, n)], -1).astype(np.float32)
    conics = np.stack([rng.uniform(0.05, 0.4, n), rng.uniform(-0.02, 0.02, n),
                       rng.uniform(0.05, 0.4, n)], -1).astype(np.float32)
    colors = rng.uniform(0, 1, (n, 4)).astype(np.float32)
    opac = rng.uniform(0.1, 0.95, n).astype(np.float32)
    depths = rng.uniform(0.5, 2.0, n).astype(np.float32)
    radii = rng.integers(4, 30, n).astype(np.int32)
    radii[::9] = 0
    ref = rng.uniform(0.4, 2.2, (H, W)).astype(np.float32)
    return m2d, conics, colors, opac, depths, radii, ref


def test_bin_gaussians_active_matches_jax():
    """The same active tiles, lists (in order) and overflow counts, with
    caps small enough to bite."""
    rng = np.random.default_rng(6)
    m2d, _, _, _, _, radii, _ = _splat_scene(rng)
    tw, th = 4, 3
    jb = jrast.bin_gaussians_active(jnp.asarray(m2d), jnp.asarray(radii), 16, tw, th,
                                    50, 9, 12, 10)
    tb = trast.bin_gaussians_active(torch.as_tensor(m2d), torch.as_tensor(radii), 16, tw, th,
                                    50, 9, 12, 10, segments=True)
    A = tb.tiles.shape[0]
    np.testing.assert_array_equal(tb.tiles.numpy(), np.asarray(jb.tiles)[:A])
    assert (np.asarray(jb.tiles)[A:] == tw * th).all()
    np.testing.assert_array_equal(tb.gids.numpy(), np.asarray(jb.gids)[:A])
    np.testing.assert_array_equal(tb.valid.numpy(), np.asarray(jb.valid)[:A])
    assert tb.n_pairs == int(jb.n_pairs)
    assert tb.n_tile_overflow == int(jb.n_tile_overflow) > 0
    assert tb.n_span_overflow == int(jb.n_span_overflow) > 0
    assert tb.n_active_overflow == int(jb.n_active_overflow) > 0
    # the backward's segments: the JAX sort also covers the padding tiles'
    # null slots, which sort after the port's A*L pairs
    np.testing.assert_array_equal(tb.pair_order.numpy(), np.asarray(jb.pair_order)[:A * 12])
    np.testing.assert_array_equal(tb.seg_lo.numpy(), np.asarray(jb.seg_lo))
    np.testing.assert_array_equal(tb.seg_hi.numpy(), np.asarray(jb.seg_hi))
    assert (tb.seg_hi > tb.seg_lo).sum() > 20


def test_splat_fwd_plain_matches_pallas_interpret():
    """K4's plain version against splat_pallas.splat_fwd(interpret=True)
    at rtol 2e-4 / atol 1e-4 (the TPU kernel contracts over the list with
    a HIGHEST-precision matmul, the port sums the slots in order)."""
    rng = np.random.default_rng(8)
    m2d, conics, colors, opac, depths, radii, ref = _splat_scene(rng)
    H, W = ref.shape
    jb = jrast.bin_gaussians_active(jnp.asarray(m2d), jnp.asarray(radii), 16, 4, 3,
                                    64, 9, 32, 12)
    tiles = np.asarray(jb.tiles)
    tsafe = np.where(tiles < 12, tiles, 0)
    pp = np.arange(256)
    px = ((tsafe % 4)[:, None] * 16 + pp % 16 + 0.5).astype(np.float32)
    py = ((tsafe // 4)[:, None] * 16 + pp // 16 + 0.5).astype(np.float32)
    ref_t = ref.reshape(3, 16, 4, 16).transpose(0, 2, 1, 3).reshape(12, 256)[tsafe]
    packed_j = jrast._pack_attrs(jnp.asarray(m2d), jnp.asarray(conics), jnp.asarray(colors),
                                 jnp.asarray(depths), jnp.asarray(opac))
    out_j = splat_pallas.splat_fwd(packed_j, jb.gids, jnp.asarray(px), jnp.asarray(py),
                                   jnp.asarray(ref_t), 0.1, 4, True)
    packed_t = trast._pack_attrs(*(torch.as_tensor(a) for a in (m2d, conics, colors,
                                                                depths, opac)))
    np.testing.assert_array_equal(packed_t.numpy(), np.asarray(packed_j))
    out_t = trast.splat_fwd(packed_t, torch.as_tensor(np.asarray(jb.gids)),
                            torch.as_tensor(px), torch.as_tensor(py),
                            torch.as_tensor(ref_t), 0.1, 4)
    assert out_t[:, 4].max() > 0.5
    _close(out_t, out_j, rtol=2e-4, atol=1e-4)


def _splat_tiles_inputs(rng):
    """The _splat_scene binned in both packages (port: the exact active
    tiles; JAX: padded to its cap with null slots), with pixel planes,
    per-tile reference depth and a random cotangent of the tile sums."""
    m2d, conics, colors, opac, depths, radii, ref = _splat_scene(rng)
    jb = jrast.bin_gaussians_active(jnp.asarray(m2d), jnp.asarray(radii), 16, 4, 3,
                                    64, 9, 32, 12)
    tb = trast.bin_gaussians_active(torch.as_tensor(m2d), torch.as_tensor(radii), 16,
                                    4, 3, 64, 9, 32, 12, segments=True)
    tiles = np.asarray(jb.tiles)
    tsafe = np.where(tiles < 12, tiles, 0)
    pp = np.arange(256)
    px = ((tsafe % 4)[:, None] * 16 + pp % 16 + 0.5).astype(np.float32)
    py = ((tsafe // 4)[:, None] * 16 + pp // 16 + 0.5).astype(np.float32)
    ref_t = ref.reshape(3, 16, 4, 16).transpose(0, 2, 1, 3).reshape(12, 256)[tsafe]
    v_out = rng.normal(size=(tiles.shape[0], 5, 256)).astype(np.float32)
    return (m2d, conics, colors, opac, depths), jb, tb, px, py, ref_t, v_out


def test_splat_bwd_plain_matches_pallas_interpret():
    """K5's plain version against splat_pallas.splat_bwd(interpret=True)
    on a random cotangent.  The TPU kernel sums through pixel moments
    (x^2 S0 - 2x Sx + Sxx ...), which cancel for Gaussians centred tiles
    away and round differently from the port's direct per-pixel sum, so
    each column is held within 1e-4 of that column's largest |value|
    (measured: at most 6e-5)."""
    rng = np.random.default_rng(13)
    attrs, jb, tb, px, py, ref_t, v_out = _splat_tiles_inputs(rng)
    packed_j = jrast._pack_attrs(*(jnp.asarray(a) for a in attrs))
    out_j = np.asarray(splat_pallas.splat_bwd(
        packed_j, jb.gids, jnp.asarray(px), jnp.asarray(py), jnp.asarray(ref_t),
        jnp.asarray(v_out), 0.1, 4, True))[..., :10]
    packed_t = trast._pack_attrs(*(torch.as_tensor(a) for a in attrs))
    out_t = trast.splat_bwd(packed_t, torch.as_tensor(np.array(jb.gids)),
                            torch.as_tensor(px), torch.as_tensor(py),
                            torch.as_tensor(ref_t), torch.as_tensor(v_out), 0.1, 4).numpy()
    assert out_t.shape == out_j.shape
    scale = np.abs(out_j).max(axis=(0, 1))
    assert (scale > 0).all()
    err = np.abs(out_t - out_j).max(axis=(0, 1))
    assert (err <= 1e-4 * scale).all(), err / scale


def test_ges_splat_grads_match_jax():
    """Per-Gaussian gradients of sum(out * v_out): GesSplat (K5's plain
    version + the sorted segment sum) against jax.grad through the JAX
    custom VJP _ges_splat with its Pallas kernels in interpret mode.  The
    forward outputs agree as in the K4 test; the grads within 1e-4 of
    each attribute's largest |grad| (moment-form rounding, see the K5
    test, then a cumsum over the pairs in both packages)."""
    rng = np.random.default_rng(14)
    attrs, jb, tb, px, py, ref_t, v_out = _splat_tiles_inputs(rng)
    A = tb.tiles.shape[0]
    static = (0.1, 64, "pallas_interpret", 9)

    def loss_j(m2d, cn, col, op):
        out = jrast._ges_splat(static, m2d, cn, col, op, jnp.asarray(attrs[4]), jb.gids,
                               jb.valid, jnp.asarray(ref_t), jnp.asarray(px),
                               jnp.asarray(py), jb.pair_order, jb.seg_lo, jb.seg_hi)
        return jnp.sum(out * jnp.asarray(v_out))

    gj = jax.grad(loss_j, argnums=(0, 1, 2, 3))(*(jnp.asarray(a) for a in attrs[:4]))
    leaves = [torch.as_tensor(a).requires_grad_(True) for a in attrs[:4]]
    out = trast.GesSplat.apply(*leaves, torch.as_tensor(attrs[4]), tb.gids,
                               torch.as_tensor(ref_t[:A]), torch.as_tensor(px[:A]),
                               torch.as_tensor(py[:A]), tb.pair_order, tb.seg_lo,
                               tb.seg_hi, 0.1)
    (out * torch.as_tensor(v_out[:A])).sum().backward()
    for name, t, j in zip(("means2d", "conics", "colors", "opacities"), leaves, gj):
        j = np.asarray(j)
        scale = np.abs(j).max()
        assert scale > 0 and (np.abs(j) > 1e-3 * scale).sum() > 20, name
        _close(t.grad, j, rtol=0, atol=1e-4 * scale, err_msg=name)


def test_ges_splat_segments_from_the_backward_match_the_binning():
    """A binning made without segments (eval and spawn renders) still
    differentiates: GesSplat's backward sorts the lists itself and gives
    the same gradients, bit for bit, as segments the binning precomputed."""
    rng = np.random.default_rng(15)
    attrs, _, tb, px, py, ref_t, v_out = _splat_tiles_inputs(rng)
    A = tb.tiles.shape[0]
    grads = []
    for segs in ((tb.pair_order, tb.seg_lo, tb.seg_hi), (None, None, None)):
        leaves = [torch.as_tensor(a).requires_grad_(True) for a in attrs[:4]]
        out = trast.GesSplat.apply(*leaves, torch.as_tensor(attrs[4]), tb.gids,
                                   torch.as_tensor(ref_t[:A]), torch.as_tensor(px[:A]),
                                   torch.as_tensor(py[:A]), *segs, 0.1)
        (out * torch.as_tensor(v_out[:A])).sum().backward()
        grads.append([t.grad for t in leaves])
    for a, b in zip(*grads):
        assert a.abs().max() > 0
        assert torch.equal(a, b)


# ---------------------------------------------------------------- GES render

def _pool_pair(rng, n=150, sh_degree=1):
    pj = jparams.create(256, sh_degree)
    k = (sh_degree + 1) ** 2
    attrs = {
        "means": rng.uniform([-1.0, -0.7, 1.5], [1.0, 0.7, 3.0], (n, 3)),
        "scales": np.log(rng.uniform(0.01, 0.06, (n, 3))),
        "quats": rng.normal(size=(n, 4)),
        "features_dc": rng.normal(0, 0.5, (n, 3)),
        "features_rest": rng.normal(0, 0.1, (n, k - 1, 3)),
        "opacities": rng.uniform(-2, 2, (n, 1)),
    }
    attrs = {kk: jnp.asarray(np.asarray(v, np.float32)) for kk, v in attrs.items()}
    pj = jparams.add(pj, attrs, jnp.asarray(n, jnp.int32))
    pt = convert.pool_from_numpy({kk: np.asarray(v) for kk, v in pj.params.items()},
                                 np.asarray(pj.alive), "cpu")
    return pj, pt


def test_ges_forward_matches_jax_pallas_interpret():
    """The port's ges_forward against the JAX ges_forward with the splat
    in interpret mode, on a pool carried across with pool_from_numpy:
    rgb/depth/alpha within 1e-4 (rtol 2e-4), radii and counters equal."""
    rng = np.random.default_rng(10)
    pj, pt = _pool_pair(rng)
    H, W = 72, 96
    st_j = jmodel.RenderStatics(width=W, height=H, sh_degree=1, tile_size=16,
                                max_gs_radii=100, delta_depth=0.1, use_exposure=False,
                                visible_cap=256, tiles_per_gaussian_cap=9, tile_cap=32,
                                active_tile_cap=20, splat_impl="pallas_interpret")
    st_t = tmodel.RenderStatics(*st_j[:-1])
    K = np.array([[70.0, 0, 47.5], [0, 70.0, 35.5], [0, 0, 1]], np.float32)
    c2w = np.eye(4, dtype=np.float32)
    ref = rng.uniform(1.0, 3.5, (H, W)).astype(np.float32)
    ref[:10] = 0.0
    base = rng.uniform(size=(H, W, 3)).astype(np.float32)
    rj = jmodel.ges_forward(pj.params, pj.alive, jnp.asarray(c2w), jnp.asarray(K),
                            jnp.asarray(ref), jnp.asarray(base), jnp.asarray(-1), st_j)
    rt = tmodel.ges_forward(pt.params, pt.alive, torch.as_tensor(c2w), K,
                            torch.as_tensor(ref), torch.as_tensor(base), -1, st_t)
    assert float(np.asarray(rj["alpha"]).max()) > 0.5
    np.testing.assert_array_equal(rt["radii"].numpy(), np.asarray(rj["radii"]))
    for k in ("rgb", "depth", "alpha"):
        _close(rt[k], rj[k], rtol=2e-4, atol=1e-4, err_msg=k)
    for k in ("n_pairs", "n_tile_overflow", "n_span_overflow", "n_active_overflow"):
        assert rt[k] == int(rj[k]), k


def test_model_files_load_across_packages(tmp_path):
    """model.npz / model.pt / PLY written by the JAX model load into the
    port's model with identical parameters, and back."""
    from gps_slam_tpu.config import Config as JConfig
    from gps_slam_tpu.data import synthetic
    from gps_slam_torch.config import Config as TConfig

    rng = np.random.default_rng(11)
    pj, _ = _pool_pair(rng, n=40, sh_degree=1)
    node = {"input_dir": "mem", "image_path": "c", "pose_path": "c", "depth_path": "d",
            "pcd_name": "n", "depth_scale": 1.0, "scene_scale": 1.0, "start_frame": 0,
            "end_frame": 1, "frame_step": 1, "intrinsics": [50.0, 50.0, 31.5, 23.5],
            "image_shape": [64, 48], "downscale_factor": 1, "test_split_interval": -1}
    d = synthetic.default_config_dict(str(tmp_path), node)
    jm = jmodel.GaussianModel(JConfig.from_dict(d), 64, 48)
    jm.pool = pj
    jm.save(str(tmp_path / "j"))
    tm = tmodel.GaussianModel(TConfig.from_dict(d), 64, 48, device="cpu")
    for name in ("model.npz", "model.pt", "point_cloud.ply"):
        sub = tmp_path / name.replace(".", "_")
        sub.mkdir()
        (sub / name).write_bytes((tmp_path / "j" / name).read_bytes())
        tm.load(str(sub))
        assert tm.num_gaussians == 40
        for k in tparams.ROW_KEYS:
            _close(getattr(tm.pool, k)[:40], np.asarray(getattr(pj, k))[:40],
                   err_msg=f"{name}:{k}")
    tm.save(str(tmp_path / "t"))
    jm2 = jmodel.GaussianModel(JConfig.from_dict(d), 64, 48)
    jm2.load(str(tmp_path / "t"))
    assert jm2.num_gaussians == 40
    np.testing.assert_allclose(np.asarray(jm2.pool.means[:40]), np.asarray(pj.means[:40]))


def test_add_gaussians_count_matches_jax():
    """Spawning takes floor(ratio x masked pixels) samples in both packages
    (the random choice of pixels differs: jax.random vs torch.Generator),
    and every new Gaussian sits on a masked pixel's vertex."""
    rng = np.random.default_rng(12)
    H, W = 24, 32
    vertex = rng.uniform(-1, 1, (H, W, 3)).astype(np.float32)
    color = rng.uniform(size=(H, W, 3)).astype(np.float32)
    normal = rng.normal(size=(H, W, 3)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    mask = rng.random((H, W)) > 0.6
    pj = jparams.create(512, 1)
    pj, nj, oj = jmodel.add_gaussians(pj, jnp.asarray(vertex), jnp.asarray(color),
                                      jnp.asarray(normal), jnp.asarray(mask), 0.25, 100,
                                      0.5, (-1.0, 0.05), jax.random.PRNGKey(0))
    pt = tparams.create(512, 1, device="cpu")
    pt, nt, ot = tmodel.add_gaussians(pt, torch.as_tensor(vertex), torch.as_tensor(color),
                                      torch.as_tensor(normal), torch.as_tensor(mask), 0.25,
                                      100, 0.5, (-1.0, 0.05), torch.Generator().manual_seed(0))
    assert nt == int(nj) == pt.n_alive == int(pj.n_alive)
    assert ot == int(oj)
    on_mask = {tuple(v) for v in vertex[mask]}
    assert all(tuple(v) in on_mask for v in pt.means[:nt].numpy())
