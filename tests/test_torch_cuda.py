"""The port's CUDA kernels held against their plain PyTorch versions on the
card.  This file imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Without a card every test skips inside its fixture."""

import pytest
import torch

from gps_slam_torch import convert
from gps_slam_torch.data import synthetic
from gps_slam_torch.gs import rasterize as trz
from gps_slam_torch.tsdf import integrate as tint
from gps_slam_torch.tsdf import raycast_tiles as trc
from gps_slam_torch.tsdf import volume as tvol
from gps_slam_torch.utils.se3 import pose_inv


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: runs on the card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def fused(cuda_device):
    """8 synthetic frames fused by the port on the CPU (plain path); asks
    for the card first so that the fusion is skipped without one."""
    cams = synthetic.make_cameras(n_frames=8, width=128, height=96)
    p = tvol.TsdfParams(voxel_size=0.02, mu=0.08, hash_size=1 << 16,
                        block_capacity=1 << 13, visible_capacity=1 << 12)
    vol = tvol.create(p, "cpu")
    for cam in cams:
        tint.fuse_frame(vol, torch.as_tensor(cam.depth[..., 0]),
                        torch.as_tensor(cam.image), torch.as_tensor(cam.c2w), cam.K)
    return vol, cams


def _to(vol, device):
    arrays = {k: getattr(vol, k).numpy() for k in (
        "table_keys", "table_ptrs", "block_coords", "state", "color",
        "summary", "last_seen")}
    arrays["n_blocks"] = vol.n_blocks
    return convert.volume_from_numpy(arrays, vol.params, device)


@pytest.mark.cuda
def test_integrate_cuda_matches_plain(cuda_device, fused):
    """integrate_cuda against its plain version over the whole pools: both
    round the same f32 expressions (nvcc -fmad=false), so rows outside the
    integration set come back untouched, weights are equal, sdf and colour
    channels within one step everywhere (a value on a rounding tie may
    flip) and state and colour words equal on >= 99.9% of the integrated
    voxels; summary rows within 1e-6."""
    vol, cams = fused
    vol = _to(vol, cuda_device)
    cam = cams[3]
    d = torch.as_tensor(cam.depth[..., 0], device=cuda_device)
    rgbp = tint.pack_rgb(torch.as_tensor(cam.image, device=cuda_device))
    n = vol.n_blocks
    keys = vol.block_coords[:n].contiguous()
    ptrs = torch.arange(n, dtype=torch.int32, device=cuda_device)
    w2c = pose_inv(torch.as_tensor(cam.c2w, device=cuda_device))
    outs = []
    for fn in (tint.integrate_blocks_packed, tint.integrate_blocks_packed_plain):
        st, co, su = (x.clone() for x in (vol.state, vol.color, vol.summary))
        fn(d, rgbp, keys, ptrs, st, co, su, w2c, cam.fx, cam.fy, cam.cx, cam.cy,
           vol.params.voxel_size, vol.params.mu, vol.params.max_w)
        torch.cuda.synchronize()
        outs.append((st.cpu(), co.cpu(), su.cpu()))
    (sk, ck, uk), (sp, cp, up) = outs
    rows = torch.zeros(sk.shape[0], dtype=torch.bool)
    rows[:n] = True
    for x, y, orig in zip((sk, ck, uk), (sp, cp, up), (vol.state, vol.color, vol.summary)):
        orig = orig.cpu()
        assert torch.equal(x[~rows], orig[~rows]) and torch.equal(y[~rows], orig[~rows])
    assert torch.equal(sk >> 16, sp >> 16)
    sdf = lambda w: ((w & 0xFFFF) ^ 0x8000) - 0x8000  # noqa: E731
    assert (sdf(sk) - sdf(sp)).abs().max() <= 1
    for sh in (0, 8, 16):
        assert (((ck >> sh) & 0xFF) - ((cp >> sh) & 0xFF)).abs().max() <= 1
    assert torch.equal(ck >> 24, cp >> 24)
    assert (sk[rows] == sp[rows]).float().mean() >= 0.999
    assert (ck[rows] == cp[rows]).float().mean() >= 0.999
    torch.testing.assert_close(uk, up, rtol=0, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("k_blocks", [1, 2])
def test_raycast_cuda_matches_plain(cuda_device, fused, k_blocks):
    """raycast_cuda against its plain version: both evaluate the same f32
    expressions in the same order (nvcc -fmad=false, device-tensor
    divisions in the plain version), so hit masks are equal and t*,
    confidence and colour agree within 1e-4 wherever both hit."""
    vol, cams = fused
    vol = _to(vol, cuda_device)
    cam = cams[2]
    c2w = torch.as_tensor(cam.c2w, device=cuda_device)
    tw = -(-cam.width // trc.TILE)
    gids, _ = trc._tile_bins(vol, pose_inv(c2w), cam.fx, cam.fy, cam.cx, cam.cy,
                             cam.width, cam.height, vol.params.visible_capacity, 24, 6)
    camd = {"fx": cam.fx, "fy": cam.fy, "cx": cam.cx, "cy": cam.cy,
            "R": c2w[:3, :3], "t": c2w[:3, 3], "inv_vox": 1.0 / vol.params.voxel_size,
            "ext": vol.params.voxel_size * 8, "fmin": vol.params.frustum_min,
            "fmax": vol.params.frustum_max}
    args = (gids, vol.state, vol.color, vol.summary, vol.block_coords, camd, tw,
            4, 8, k_blocks)
    ok = trc.march(*args)
    op = trc.march_plain(*args)
    torch.cuda.synchronize()
    hk, hp = ok[:, 5] > 0, op[:, 5] > 0
    assert hk.float().mean() > 0.5
    assert torch.equal(hk, hp)
    err = (ok[:, :5] - op[:, :5]).abs().amax(1)[hk & hp]
    assert err.max() < 1e-4


@pytest.mark.cuda
def test_splat_fwd_cuda_matches_plain(cuda_device):
    """splat_fwd_cuda against its plain version (both sum the list slots
    in order in f32): rtol 1e-5 / atol 1e-5."""
    g = torch.Generator().manual_seed(3)
    H, W, n, L = 64, 96, 300, 64
    m2d = torch.rand((n, 2), generator=g) * torch.tensor([W, H])
    conics = torch.rand((n, 3), generator=g) * torch.tensor([0.3, 0.02, 0.3]) \
        + torch.tensor([0.02, -0.01, 0.02])
    colors = torch.rand((n, 4), generator=g)
    opac = torch.rand(n, generator=g)
    depth = torch.rand(n, generator=g) + 0.5
    radii = torch.full((n,), 12, dtype=torch.int32)
    bins = trz.bin_gaussians_active(m2d, radii, 16, W // 16, H // 16, n, 9, L, 64)
    packed = trz._pack_attrs(m2d, conics, colors, depth, opac).to(cuda_device)
    tiles = bins.tiles
    pp = torch.arange(256)
    px = ((tiles % (W // 16))[:, None] * 16 + pp % 16 + 0.5).float().to(cuda_device)
    py = ((tiles // (W // 16))[:, None] * 16 + pp // 16 + 0.5).float().to(cuda_device)
    ref = (torch.rand(px.shape, generator=g) + 0.8).to(cuda_device)
    gids = bins.gids.to(cuda_device)
    ok = trz.splat_fwd(packed, gids, px, py, ref, 0.1, 4)
    op = trz.splat_fwd_plain(packed, gids, px, py, ref, 0.1, 4)
    torch.cuda.synchronize()
    assert ok[:, 4].max() > 0.5
    torch.testing.assert_close(ok, op, rtol=1e-5, atol=1e-5)


def _splat_inputs(device, seed=3, H=64, W=96, n=300, L=64):
    """Random Gaussians binned over a W x H image: the packed rows, lists,
    pixel planes and reference depth of splat_fwd / splat_bwd, on
    `device`."""
    g = torch.Generator().manual_seed(seed)
    m2d = torch.rand((n, 2), generator=g) * torch.tensor([W, H])
    conics = torch.rand((n, 3), generator=g) * torch.tensor([0.3, 0.02, 0.3]) \
        + torch.tensor([0.02, -0.01, 0.02])
    colors = torch.rand((n, 4), generator=g)
    opac = torch.rand(n, generator=g)
    depth = torch.rand(n, generator=g) + 0.5
    radii = torch.full((n,), 12, dtype=torch.int32)
    bins = trz.bin_gaussians_active(m2d, radii, 16, W // 16, H // 16, n, 9, L, 64)
    packed = trz._pack_attrs(m2d, conics, colors, depth, opac).to(device)
    px, py = trz._tile_pixels(bins.tiles, W // 16, 16)
    ref = torch.rand(px.shape, generator=g) + 0.8
    return packed, bins.gids.to(device), px.to(device), py.to(device), ref.to(device)


@pytest.mark.cuda
def test_splat_bwd_cuda_matches_plain(cuda_device):
    """splat_bwd_cuda against its plain version on a random cotangent:
    both round each pair term alike (nvcc -fmad=false) but sum the 256
    pixels in another order (lane partial sums + a shuffle tree against
    torch's reduction), so each column agrees within 1e-4 of its largest
    |value|; the kernel gives the same bits on a second launch."""
    packed, gids, px, py, ref = _splat_inputs(cuda_device)
    v_out = torch.randn((gids.shape[0], 5, 256), generator=torch.Generator()
                        .manual_seed(4)).to(cuda_device)
    ok = trz.splat_bwd(packed, gids, px, py, ref, v_out, 0.1, 4)
    again = trz.splat_bwd(packed, gids, px, py, ref, v_out, 0.1, 4)
    op = trz.splat_bwd_plain(packed, gids, px, py, ref, v_out, 0.1, 4)
    torch.cuda.synchronize()
    assert ok.shape == op.shape == (gids.shape[0], 64, 10)
    assert torch.equal(ok, again)
    scale = op.abs().amax((0, 1))
    assert (scale > 0).all()
    assert ((ok - op).abs().amax((0, 1)) <= 1e-4 * scale).all()


@pytest.mark.cuda
def test_window_optimize_cuda_matches_cpu(cuda_device, tmp_path):
    """One window of 10 Adam steps over three synthetic cameras on the card
    (K4 + K5) against the same window on the CPU (their plain versions),
    from the same pool.  The first step's loss within 1e-5 relative; every
    step's within 5e-3 (Adam moves rows whose gradients are near zero by
    up to +-lr on either side, see tests/test_torch_train.py); final rows
    within 2 lr x 10 steps, fewer than 10% of them more than one lr
    apart."""
    import numpy as np

    from gps_slam_torch.config import Config
    from gps_slam_torch.gs import model as tmodel

    W, H, iters = 64, 48, 10
    cams = synthetic.make_cameras(n_frames=3, width=W, height=H)
    c0 = cams[0]
    node = {"input_dir": "mem", "image_path": "c", "pose_path": "c", "depth_path": "d",
            "pcd_name": "n", "depth_scale": 6553.5, "scene_scale": 1.0,
            "start_frame": 0, "end_frame": 2, "frame_step": 1,
            "intrinsics": [c0.fx, c0.fy, c0.cx, c0.cy], "image_shape": [W, H],
            "downscale_factor": 1, "test_split_interval": -1}
    cfg = Config.from_dict(synthetic.default_config_dict(str(tmp_path), node))
    model = tmodel.GaussianModel(cfg, W, H, device="cpu")
    mask = torch.zeros((H, W), dtype=torch.bool)
    mask[::4, ::4] = True
    for i, cam in enumerate(cams):
        fm = cam.get_frame_maps("cpu")
        tmodel.add_gaussians(model.pool, fm["vertex_map"], fm["color_map"],
                             fm["normal_map"], mask, 0.6, 1024,
                             cfg.model.default_opacities,
                             (cfg.model.min_init_scale, cfg.model.max_init_scale),
                             torch.Generator().manual_seed(i))
    pool_np = {k: v.numpy() for k, v in model.pool.params.items()}
    alive = model.pool.alive.numpy()
    g = np.random.default_rng(5)
    ref = np.stack([c.depth[..., 0] * g.uniform(0.98, 1.02, (H, W)) for c in cams])
    base = np.clip(np.stack([c.image for c in cams]) + g.normal(0, 0.1, (3, H, W, 3)), 0, 1)
    arrs = {"c2w": np.stack([c.c2w for c in cams]), "gt_rgb": np.stack([c.image for c in cams]),
            "ref_depth": ref, "base_color": base}
    idx = [0, 2, 1, 1, 0, 2, 2, 0, 1, 0]
    out = {}
    for dev in ("cpu", cuda_device):
        batch = {k: torch.as_tensor(np.asarray(v, np.float32), device=dev)
                 for k, v in arrs.items()}
        batch["K"] = torch.as_tensor(np.stack([c.K for c in cams]), dtype=torch.float32)
        batch["cam_id"] = [0, 0, 0]
        pool = convert.pool_from_numpy(pool_np, alive, dev)
        pool, aux = tmodel.window_optimize(
            pool, batch, idx, model.statics, cfg.model,
            cfg.pipe.max_iterations, 0.0, 0.0, model.opt_cap())
        out[str(dev)] = (pool, aux["loss_hist"].cpu().numpy())
    (pc, hc), (pg, hg) = out["cpu"], out[str(cuda_device)]
    assert np.isfinite(hg).all()
    rel = np.abs(hg - hc) / np.abs(hc)
    assert rel[0] <= 1e-5 and rel.max() <= 5e-3, rel
    n = int(alive.sum())
    m = cfg.model
    for k, lr in (("means", m.means_lr), ("scales", m.scales_lr), ("quats", m.quats_lr),
                  ("features_dc", m.featuresDc_lr), ("opacities", m.opacities_lr)):
        d = (getattr(pg, k)[:n].cpu() - getattr(pc, k)[:n]).abs().reshape(n, -1).amax(1) / lr
        assert d.max() <= 2 * iters and (d > 1).float().mean() < 0.1, (k, d.max())


@pytest.mark.cuda
def test_wrappers_refuse_bad_input(cuda_device):
    """Wrappers check dtype and device and raise instead of running."""
    x = torch.zeros((4, 64), device=cuda_device)
    gids = torch.zeros((4, 8), dtype=torch.int64, device=cuda_device)
    with pytest.raises(ValueError):
        trz.splat_fwd(torch.zeros((2, 16), device=cuda_device), gids,
                      torch.zeros((4, 256), device=cuda_device), x, x, 0.1, 4)
    with pytest.raises(ValueError):
        tint.integrate_blocks_packed(
            torch.zeros((32, 32), device=cuda_device), None, None, None, None,
            None, None, None, 1.0, 1.0, 1.0, 1.0, 0.01, 0.02, 100)


def test_check_tensor_refuses_what_the_kernels_do_not_take():
    """The wrappers' argument check (runs without a card): a CPU tensor, a
    wrong dtype, a strided view or a wrong shape raises ValueError."""
    from gps_slam_torch import kernels

    k = kernels.SPLAT_FWD
    x = torch.zeros((4, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.check_tensor(k, "gids", x, torch.int32, (4, 8))
    if not torch.cuda.is_available():
        return
    x = x.cuda()
    kernels.check_tensor(k, "gids", x, torch.int32, (4, 8))
    for t, dtype, shape in ((x, torch.float32, None), (x.t(), torch.int32, None),
                            (x, torch.int32, (8, 4))):
        with pytest.raises(ValueError):
            kernels.check_tensor(k, "gids", t, dtype, shape)


def test_entry_points_never_fall_back_to_the_cpu():
    """The default device is the card; asking for it without one raises."""
    from gps_slam_torch import resolve_device

    assert resolve_device("cpu").type == "cpu"
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device(None)
