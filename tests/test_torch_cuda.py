"""The port's CUDA kernels held against their plain PyTorch versions on the
card.  This file imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Without a card every test skips inside its fixture."""

import numpy as np
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


def _k1_inputs(vol, cam, device):
    """K1's arguments for frame `cam` over every block of `vol` (pool row
    i for block i): depth, packed rgb, keys, ptrs and the pose tail."""
    d = torch.as_tensor(cam.depth[..., 0], device=device)
    rgbp = tint.pack_rgb(torch.as_tensor(cam.image, device=device))
    n = vol.n_blocks
    keys = vol.block_coords[:n].contiguous()
    ptrs = torch.arange(n, dtype=torch.int32, device=device)
    w2c = pose_inv(torch.as_tensor(cam.c2w, device=device))
    tail = (w2c, cam.fx, cam.fy, cam.cx, cam.cy, vol.params.voxel_size,
            vol.params.mu, vol.params.max_w)
    return d, rgbp, keys, ptrs, tail


def _k1_check(vol, d, rgbp, keys, ptrs, tail):
    """Run integrate_cuda and its plain version on copies of the pools and
    hold them to each other over the whole pools: both round the same f32
    expressions (nvcc -fmad=false), so rows outside the integration set
    (ptrs -1 included) come back untouched, weights are equal, sdf and
    colour channels within one step everywhere (a value on a rounding tie
    may flip) and state and colour words equal on >= 99.9% of the
    integrated voxels; summary rows within 1e-6.  Returns the card's
    state pool and the integrated rows."""
    outs = []
    for fn in (tint.integrate_blocks_packed, tint.integrate_blocks_packed_plain):
        st, co, su = (x.clone() for x in (vol.state, vol.color, vol.summary))
        fn(d, rgbp, keys, ptrs, st, co, su, *tail)
        torch.cuda.synchronize()
        outs.append((st.cpu(), co.cpu(), su.cpu()))
    (sk, ck, uk), (sp, cp, up) = outs
    rows = torch.zeros(sk.shape[0], dtype=torch.bool)
    rows[ptrs[ptrs >= 0].long().cpu()] = True
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
    return sk, rows


@pytest.mark.cuda
def test_integrate_cuda_matches_plain(cuda_device, fused):
    """integrate_cuda against its plain version over the whole pools, every
    block integrated (see `_k1_check` for the limits)."""
    vol, cams = fused
    vol = _to(vol, cuda_device)
    _k1_check(vol, *_k1_inputs(vol, cams[3], cuda_device))


@pytest.mark.cuda
def test_integrate_cuda_dropped_rows_and_max_w(cuda_device, fused):
    """integrate_cuda with every third candidate dropped (ptrs -1) and the
    depth and colour weights of half the blocks at max_w - 1 or max_w:
    dropped rows come back untouched, weights clamp at max_w, and the
    pools agree with the plain version as in `_k1_check`."""
    vol, cams = fused
    vol = _to(vol, cuda_device)
    d, rgbp, keys, ptrs, tail = _k1_inputs(vol, cams[3], cuda_device)
    n = keys.shape[0]
    i = torch.arange(n, device=cuda_device)
    ptrs = torch.where(i % 3 == 0, -1, ptrs).to(torch.int32)
    max_w = vol.params.max_w
    w = torch.where(i % 4 == 1, max_w - 1, max_w).to(torch.int32)[:, None]
    heavy = (i % 4 == 1) | (i % 4 == 2)
    st = vol.state[:n]
    vol.state[:n] = torch.where(heavy[:, None], (st & 0xFFFF) | (w << 16) | (w << 24), st)
    sk, rows = _k1_check(vol, d, rgbp, keys, ptrs, tail)
    wk = (sk >> 16) & 0xFF
    assert wk.max() == max_w
    lifted = rows[:n] & (i % 4 == 1).cpu()  # integrated, from max_w - 1
    assert (wk[:n][lifted] == max_w).any()


@pytest.mark.cuda
def test_integrate_cuda_permuted_rows(cuda_device, fused):
    """integrate_cuda on candidates whose pool rows are a random
    permutation (every CTA writes another pool row than its index), one
    candidate short of the pool and every fifth dropped: the pools agree
    with the plain version as in `_k1_check`, the rows left out included."""
    vol, cams = fused
    vol = _to(vol, cuda_device)
    d, rgbp, keys, ptrs, tail = _k1_inputs(vol, cams[5], cuda_device)
    n = keys.shape[0]
    g = torch.Generator().manual_seed(11)
    perm = torch.randperm(n, generator=g).to(cuda_device)
    keys = keys[perm][:n - 1].contiguous()
    ptrs = torch.where(torch.arange(n - 1, device=cuda_device) % 5 == 2, -1,
                       ptrs[perm][:n - 1]).to(torch.int32).contiguous()
    _k1_check(vol, d, rgbp, keys, ptrs, tail)


def _k2_args(device, width, height, blocks, valid_frac=0.9, seed=7):
    """integrate_blocks' arguments for an identity camera (fx = fy = width,
    principal point in the middle) looking at a noisy depth plane at 1.1 m
    (5% holes) over the blocks `blocks` [V, 3] (5 mm voxels, mu 2 cm,
    max_w 100): random old planes (weights 0..49, colour bytes and
    weights random) and a fraction `valid_frac` of the rows valid."""
    import numpy as np

    from gps_slam_torch.tsdf import hash as thash

    rng = np.random.default_rng(seed)
    f = float(width)
    depth = rng.normal(1.1, 0.01, (height, width)).astype(np.float32)
    depth[rng.random((height, width)) < 0.05] = 0.0
    rgbp = rng.integers(0, 2 ** 24, (height, width), dtype=np.int32)
    V = blocks.shape[0]
    keys = thash.pack(*(torch.as_tensor(blocks[:, k]) for k in range(3)))
    valid = rng.random(V) < valid_frac
    planes = (rng.uniform(-1, 1, (V, 512)), rng.integers(0, 50, (V, 512)),
              rng.integers(0, 2 ** 24, (V, 512), dtype=np.int32),
              rng.integers(0, 50, (V, 512)))
    args = [torch.as_tensor(depth), torch.as_tensor(rgbp), keys, torch.as_tensor(valid)]
    args += [torch.as_tensor(p if p.dtype == np.int32 else p.astype(np.float32))
             for p in planes]
    return [a.to(device) for a in args] + [
        torch.eye(4, device=device), f, f, width / 2, height / 2, width, height,
        0.005, 0.02, 100]


def _k2_grid(x, y, z):
    import numpy as np

    return np.stack(np.meshgrid(np.arange(*x), np.arange(*y), np.arange(*z),
                                indexing="ij"), -1).reshape(-1, 3)


def _k2_check(args):
    """integrate_f32_cuda against its plain version on the valid rows:
    both evaluate the same f32 expressions in the same order (nvcc
    -fmad=false, device-tensor divisors in the plain version), so every
    output is the same bits.  Returns the kernel's outputs on the valid
    rows, on the CPU."""
    ok = tint.integrate_blocks(*args)
    op = tint.integrate_blocks_plain(*args)
    torch.cuda.synchronize()
    sel = args[3]
    outs = [[x[sel].cpu() for x in o] for o in (ok, op)]
    for xk, xp in zip(*outs):
        assert torch.equal(xk.view(torch.int32), xp.view(torch.int32))
    return outs[0]


@pytest.mark.cuda
@pytest.mark.parametrize("width,height", [(1296, 968), (1920, 1080)])
def test_integrate_f32_cuda_matches_plain(cuda_device, width, height):
    """integrate_f32_cuda against its plain version at the two frame sizes
    that take the f32 route (the JAX package's K2a and K2b): a grid of
    blocks across the frustum of an identity camera, a noisy depth plane
    behind it, random old planes and 10% of the rows invalid.  On valid
    rows both evaluate the same f32 expressions (`_k2_check`): the same
    bits, weights and colour weights updated on a real share of voxels."""
    args = _k2_args(cuda_device, width, height,
                    _k2_grid((-13, 13), (-10, 10), (26, 30)))
    fk, wk, ck, wck = _k2_check(args)
    sel = args[3]
    assert (wk != args[5][sel].cpu()).float().mean() > 0.1
    assert (wck != args[7][sel].cpu()).float().mean() > 0.01


def _k2_raw(args, sentinel):
    """integrate_f32_cuda's C entry launched on output planes filled with
    `sentinel` (the wrapper allocates them with torch.empty): shows which
    rows the kernel writes."""
    from gps_slam_torch import kernels

    depth, rgbp, keys, valid, f, w, c, wc, w2c, fx, fy, cx, cy, W, H, vs, mu, mw = args
    k = kernels.INTEGRATE_F32
    V = keys.shape[0]
    outs = [torch.full_like(f, sentinel) for _ in range(3)]
    col = torch.full((V, 512, 3), sentinel, device=f.device)
    pose = kernels.pose_rows(w2c)
    err = k.fn(depth.data_ptr(), rgbp.data_ptr(), keys.data_ptr(), valid.data_ptr(),
               f.data_ptr(), w.data_ptr(), c.data_ptr(), wc.data_ptr(),
               outs[0].data_ptr(), outs[1].data_ptr(), col.data_ptr(),
               outs[2].data_ptr(), pose.data_ptr(), V, W, H, float(fx), float(fy),
               float(cx), float(cy), float(vs), float(mu), int(mw),
               kernels.stream_ptr())
    kernels.check(k, err)
    torch.cuda.synchronize()
    return outs[0], outs[1], col, outs[2]


@pytest.mark.cuda
def test_integrate_f32_cuda_invalid_and_single_rows(cuda_device):
    """K2 on its smallest inputs at 1920x1080: with every row invalid the
    kernel writes nothing (output planes filled with a sentinel come back
    untouched); with one valid row among invalid ones it writes that row
    alone, the plain version's bits; a single row (V = 1) likewise."""
    grid = _k2_grid((-2, 2), (-2, 2), (26, 28))
    args = _k2_args(cuda_device, 1920, 1080, grid, valid_frac=0.0)
    assert not args[3].any()
    for out in _k2_raw(args, -7.0):
        assert (out == -7.0).all()
    args[3][5] = True
    raw = _k2_raw(args, -7.0)
    _k2_check(args)
    ref = tint.integrate_blocks_plain(*args)
    for out, r in zip(raw, ref):
        assert (out[~args[3]] == -7.0).all()
        assert torch.equal(out[5].view(torch.int32), r[5].view(torch.int32))
    one = _k2_args(cuda_device, 1920, 1080, grid[5:6], valid_frac=1.0)
    assert one[3].all() and one[2].shape == (1,)
    fk, wk, _, _ = _k2_check(one)
    assert (wk != one[5].cpu()).any()


@pytest.mark.cuda
def test_integrate_f32_cuda_taps_past_the_edge(cuda_device):
    """K2 at 1920x1080 on blocks around the frame's bottom-right corner:
    1080 rows fill 33.75 tiles of 32 px, so the windows of the last tile
    row reach past the image, where a tap reads 0 (the TPU's zero-padded
    tiles); voxels there project past the edge and others integrate.  The
    plain version's bits on every valid row."""
    W, H = 1920, 1080
    grid = _k2_grid((9, 15), (4, 10), (26, 30))
    args = _k2_args(cuda_device, W, H, grid)
    # each block's first corner in pixels (identity camera, fx = fy = W)
    lo = grid * 0.04
    u = W * lo[:, 0] / lo[:, 2] + W / 2
    v = W * lo[:, 1] / lo[:, 2] + H / 2
    assert (u > W - 1).any() and (v > H - 1).any() and (v < H - 2).any()
    fk, wk, _, _ = _k2_check(args)
    assert (wk != args[5][args[3]].cpu()).float().mean() > 0.01


@pytest.mark.cuda
def test_integrate_f32_cuda_weights_at_max_w(cuda_device):
    """K2 with the old depth and colour weights of every other row at
    max_w and of the rest at max_w - 1: updated weights clamp at max_w and
    every valid row is the plain version's bits."""
    args = _k2_args(cuda_device, 1920, 1080, _k2_grid((-13, 13), (-10, 10), (26, 30)))
    V = args[2].shape[0]
    mw = args[-1]
    heavy = torch.where(torch.arange(V, device=cuda_device) % 2 == 0, mw, mw - 1)
    args[5] = heavy[:, None].expand(V, 512).to(torch.float32).contiguous()
    args[7] = args[5].clone()
    fk, wk, _, wck = _k2_check(args)
    assert wk.max() == mw and wck.max() == mw
    lifted = (args[5][args[3]].cpu() == mw - 1) & (wk == mw)
    assert lifted.any()


@pytest.mark.cuda
def test_integrate_f32_cuda_refuses_misaligned_planes(cuda_device):
    """K2 reads its old planes as 8-byte words: a plane that starts 4
    bytes into its storage (a [1:] view) is refused before any launch, and
    one that starts 8 bytes in (a [2:] view) gives the plain version's bits."""
    args = _k2_args(cuda_device, 1920, 1080, _k2_grid((-2, 2), (-2, 2), (26, 28)))
    V = args[2].shape[0]
    for i in (4, 5, 6, 7):
        for skip, refused in ((1, True), (2, False)):
            moved = list(args)
            flat = torch.zeros(V * 512 + skip, dtype=args[i].dtype, device=cuda_device)
            moved[i] = flat[skip:].view(V, 512)
            moved[i].copy_(args[i])
            assert moved[i].is_contiguous() and moved[i].data_ptr() % 16 == 4 * skip
            if refused:
                with pytest.raises(ValueError, match="8-byte"):
                    tint.integrate_blocks(*moved)
            else:
                _k2_check(moved)


@pytest.mark.cuda
def test_narrow_frames_cuda_match_cpu(cuda_device):
    """Frames below 64 px run on the card: 6 synthetic frames at 48x40
    fused on the card and on the CPU take the torch branch of narrow
    frames on both (no integrate kernel launches) and give the same block
    keys and, by key, equal weights, sdf within 1 quantum and colour
    within 1; a raycast of one view (K3 on partial 16 px tiles) gives
    equal hit masks and depths within a voxel; and K4 on a 48x40 frame's
    tiles (the last tile row half outside the frame) matches its plain
    version (rtol 1e-5 / atol 1e-5)."""
    from gps_slam_torch import kernels

    W, H = 48, 40
    cams = synthetic.make_cameras(n_frames=6, width=W, height=H)
    p = tvol.TsdfParams(voxel_size=0.02, mu=0.08, hash_size=1 << 16,
                        block_capacity=1 << 13, visible_capacity=1 << 12)
    vols, depth = {}, {}
    kernels.build_all()
    for dev in (cuda_device, torch.device("cpu")):
        vol = tvol.create(p, dev)
        kernels.reset_counts()
        for c in cams:
            tint.fuse_frame(vol, torch.as_tensor(c.depth[..., 0], device=dev),
                            torch.as_tensor(c.image, device=dev),
                            torch.as_tensor(c.c2w, device=dev), c.K)
        assert kernels.counts()["integrate_cuda"] == 0
        assert kernels.counts()["integrate_f32_cuda"] == 0
        m = trc.raycast(vol, cams[3].c2w, cams[3].K, W, H, 24, 4, 8, 2)
        if dev.type == "cuda":
            assert kernels.counts()["raycast_cuda"] == 1
        depth[dev.type] = m["depth_map"][..., 0].cpu()
        n = vol.n_blocks
        order = torch.argsort(vol.block_coords[:n].cpu())
        vols[dev.type] = tuple(x[:n].cpu()[order] for x in
                               (vol.block_coords, vol.state, vol.color))
    (kc, sc, cc), (kp, sp, cp) = vols["cuda"], vols["cpu"]
    assert torch.equal(kc, kp)
    assert torch.equal(sc >> 16, sp >> 16)
    assert ((sc >> 16) & 0xFF).gt(0).float().mean() > 0.3
    sdf = lambda w: ((w & 0xFFFF) ^ 0x8000) - 0x8000  # noqa: E731
    assert (sdf(sc) - sdf(sp)).abs().max() <= 1
    for sh in (0, 8, 16):
        assert (((cc >> sh) & 0xFF) - ((cp >> sh) & 0xFF)).abs().max() <= 1
    dc, dp = depth["cuda"], depth["cpu"]
    assert torch.equal(dc > 0, dp > 0) and (dc > 0).float().mean() > 0.2
    both = dc > 0
    assert ((dc - dp).abs()[both] < p.voxel_size).all()

    g = torch.Generator().manual_seed(9)
    n, L = 60, 64
    tw, th = -(-W // 16), -(-H // 16)
    m2d = torch.rand((n, 2), generator=g) * torch.tensor([W, H])
    conics = torch.rand((n, 3), generator=g) * torch.tensor([0.3, 0.02, 0.3]) \
        + torch.tensor([0.02, -0.01, 0.02])
    bins = trz.bin_gaussians_active(m2d, torch.full((n,), 12, dtype=torch.int32), 16,
                                    tw, th, n, 9, L, 64)
    packed = trz._pack_attrs(m2d, conics, torch.rand((n, 4), generator=g),
                             torch.rand(n, generator=g) + 0.5, torch.rand(n, generator=g))
    px, py = trz._tile_pixels(bins.tiles, tw, 16)
    assert (py > H).any()
    ref = torch.rand(px.shape, generator=g) + 0.8
    a = [x.to(cuda_device).contiguous() for x in (packed, bins.gids, px, py, ref)]
    kernels.reset_counts()
    ok = trz.splat_fwd(*a, 0.1, 4)
    op = trz.splat_fwd_plain(*a, 0.1, 4)
    torch.cuda.synchronize()
    assert kernels.counts()["splat_fwd_cuda"] == 1
    assert ok[:, 4].max() > 0.5
    torch.testing.assert_close(ok, op, rtol=1e-5, atol=1e-5)


def _march_args(vol, cam, lb, s_refine, k_blocks, need_color, device):
    c2w = torch.as_tensor(cam.c2w, device=device)
    tw = -(-cam.width // trc.TILE)
    gids = trc._tile_bins(vol, pose_inv(c2w), cam.fx, cam.fy, cam.cx, cam.cy,
                          cam.width, cam.height, vol.params.visible_capacity, lb, 6)[0]
    camd = {"fx": cam.fx, "fy": cam.fy, "cx": cam.cx, "cy": cam.cy,
            "R": c2w[:3, :3], "t": c2w[:3, 3], "inv_vox": 1.0 / vol.params.voxel_size,
            "ext": vol.params.voxel_size * 8, "fmin": vol.params.frustum_min,
            "fmax": vol.params.frustum_max}
    return (gids, vol.state, vol.color, vol.summary, vol.block_coords, camd, tw,
            4, s_refine, k_blocks, need_color)


@pytest.mark.cuda
@pytest.mark.parametrize("lb,s_refine,k_blocks,need_color", [
    pytest.param(24, 8, 1, True, id="1"), pytest.param(24, 8, 2, True, id="2"),
    *(pytest.param(lb, sr, kb, lb != 16, id=f"lb{lb}-sr{sr}-k{kb}")
      for lb in (1, 16, 32) for sr in (2, 16) for kb in (1, 2))])
def test_raycast_cuda_matches_plain(cuda_device, fused, lb, s_refine, k_blocks,
                                    need_color):
    """raycast_cuda against its plain version over the kernel's range (LB
    1 to 32, s_refine 2 to 16, k_blocks 1 and 2, with and without colour):
    both evaluate the same f32 expressions in the same order (nvcc
    -fmad=false, device-tensor divisions in the plain version), so hit
    masks are equal and t*, confidence and colour agree within 1e-4
    wherever both hit; a second launch gives the same bits.  From LB 16
    on, most pixels hit; at LB 1 each tile keeps only its nearest block,
    a band block in front of the surface, so almost none do."""
    vol, cams = fused
    vol = _to(vol, cuda_device)
    args = _march_args(vol, cams[2], lb, s_refine, k_blocks, need_color, cuda_device)
    ok = trc.march(*args)
    again = trc.march(*args)
    op = trc.march_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(ok, again)
    hk, hp = ok[:, 5] > 0, op[:, 5] > 0
    if lb >= 16:
        assert hk.float().mean() > 0.5
    assert torch.equal(hk, hp)
    err = (ok[:, :5] - op[:, :5]).abs().amax(1)[hk & hp]
    assert err.numel() == 0 or err.max() < 1e-4
    miss = ~(hk & hp)[:, None].expand(-1, 5, -1)
    assert torch.equal(ok[:, :5][miss], op[:, :5][miss])
    if not need_color:
        assert not ok[:, 2:5].any()


@pytest.mark.cuda
@pytest.mark.parametrize("lb,s_refine,k_blocks,need_color", [
    pytest.param(lb, sr, kb, nc, id=f"lb{lb}-sr{sr}-k{kb}" + ("-color" if nc else ""))
    for lb in (1, 16, 32) for sr in (2, 6) for kb in (1, 2, 4) for nc in (False, True)])
def test_raycast_cuda_tracking_mode_matches_plain(cuda_device, fused, lb, s_refine,
                                                  k_blocks, need_color):
    """raycast_cuda's tracking mode (per-pixel ranking and picks, two
    bracket stages) against its plain version (`march_plain` with
    raycast_tiles.TRACK) over LB 1 to 32, s_refine 2 and 6 and 1 to 4
    picks, with and without colour at every LB (the colour and composite
    trackers' prepare raycast reads colour at LB 16): the same f32
    expressions in the same order, and the work the kernel skips is work
    whose result nothing reads, so all five channels are equal at every
    pixel, bit for bit; a second launch gives the same bits."""
    vol, cams = fused
    vol = _to(vol, cuda_device)
    args = _march_args(vol, cams[2], lb, s_refine, k_blocks, need_color, cuda_device)
    ok = trc.march(*args, track=True)
    again = trc.march(*args, track=True)
    op = trc.march_plain(*args, xla=trc.TRACK)
    torch.cuda.synchronize()
    assert torch.equal(ok, again)
    if lb >= 16:
        assert (ok[:, 5] > 0).float().mean() > 0.5
    assert torch.equal(ok, op)
    with pytest.raises(ValueError):
        trc.march(*args[:9], trc.MAX_TRACK_K + 1, need_color, track=True)


@pytest.fixture(scope="module")
def tracking_fixture(cuda_device):
    """tests/test_tracking.py's fixture (160x120, look in, arc 0.025, 2 cm
    voxels) after 4 gt-pose fusions by the port on the CPU, on the card,
    and the tracking-prepare march's arguments at the last pose with that
    file's config's 32-slot tile lists."""
    cams = synthetic.make_cameras(n_frames=4, width=160, height=120, look="in",
                                  arc=0.025)
    p = tvol.TsdfParams(voxel_size=0.02, mu=0.08, hash_size=1 << 16,
                        block_capacity=1 << 13, visible_capacity=1 << 12)
    vol = tvol.create(p, "cpu")
    for c in cams:
        tint.fuse_frame(vol, torch.as_tensor(c.depth[..., 0]), torch.as_tensor(c.image),
                        torch.as_tensor(c.c2w), c.K)
    vol = _to(vol, cuda_device)
    return _march_args(vol, cams[-1], 32, 6, trc.TRACK_K_BLOCKS, False, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("mips", ["as fused", "no negative sample", "tied keys"])
def test_raycast_cuda_tracking_mode_dense_and_no_negative(tracking_fixture, mips):
    """The tracking mode bit for bit with its plain version on dense
    lists and where some of its skips cannot fire: 32-slot lists, most of
    them full, on tests/test_tracking.py's fixture (most listed pairs
    miss; tests/test_torch_raycast_track_skips.py counts the work the
    kernel leaves out); then the same volume with its mips made
    non-negative, so that no pixel has a negative coarse sample (no pair
    stops its samples early, every pick's first stage spans its whole
    segment); then with its non-negative mip values set to 0, so that
    every pair without a negative sample keys 0 (ties: the picks are the
    smallest keys, the first slot on a tie, also where an insert pushes a
    pick down onto an equal key)."""
    args = list(tracking_fixture)
    gids = args[0]
    assert (gids >= 0).float().mean() > 0.8
    if mips == "no negative sample":
        args[3] = args[3].clone()
        args[3][:, :64] = args[3][:, :64].abs()
    elif mips == "tied keys":
        args[3] = args[3].clone()
        args[3][:, :64] = torch.clamp(args[3][:, :64], max=0.0)
    ok = trc.march(*args, track=True)
    op = trc.march_plain(*args, xla=trc.TRACK)
    has_neg = trc._coarse(torch.arange(gids.shape[0], device=gids.device), gids,
                          args[3], args[4], args[5], args[6], args[7], per_pixel=True)[6]
    torch.cuda.synchronize()
    assert has_neg.any() == (mips != "no negative sample")
    assert (op[:, 5] > 0).float().mean() > 0.3
    assert torch.equal(ok, op)


@pytest.mark.cuda
def test_wrappers_never_read_back(cuda_device, fused):
    """The K1, K2 and K3 wrappers (K3 also in its tracking mode) and the
    trackers' Gauss-Newton levels (`icp_gn_cuda`, `color_gn_cuda`, each a
    whole level's loop in one launch) launch under
    torch.cuda.set_sync_debug_mode("error"): none of them copies a CUDA
    tensor to the host or otherwise waits on the card (the pose goes to
    the kernels as a device pointer, the level's exit test stays on the
    card)."""
    from gps_slam_torch import kernels
    from gps_slam_torch.slam import color_gn
    from gps_slam_torch.slam import tracker as ttrk

    vol, cams = fused
    vol = _to(vol, cuda_device)
    d, rgbp, keys, ptrs, tail = _k1_inputs(vol, cams[3], cuda_device)
    n = keys.shape[0]
    st = vol.state[:n]
    f32 = (tvol.state_sdf_f32(st), tvol.state_w_depth(st).to(torch.float32),
           vol.color[:n].contiguous(), tvol.state_w_color(st).to(torch.float32))
    valid = torch.ones(n, dtype=torch.bool, device=cuda_device)
    margs = _march_args(vol, cams[2], 16, 6, 2, True, cuda_device)
    kernels.build_all()
    # a tracking level: frame 3's depth against frame 2's camera rays
    c2w = torch.as_tensor(cams[2].c2w, device=cuda_device)
    rays = torch.as_tensor(cams[2].depth, device=cuda_device).expand(-1, -1, 3).contiguous()
    lv = ttrk._StaticLevel(torch.as_tensor(cams[3].c2w, device=cuda_device), d, rays, rays,
                           torch.as_tensor(ttrk._level_cam(cams[3].K, 0, True),
                                           device=cuda_device),
                           50, False, pose_inv(c2w), ttrk._scalar(0.015, cuda_device),
                           ttrk._scalar(0.02, cuda_device))
    # a colour level: points made of frame 2's depth, projected into frame 3's image
    img = torch.as_tensor(cams[3].image, device=cuda_device)
    gx, gy = (g.contiguous() for g in ttrk._gradients(img))
    pts = rays[::4, ::4].reshape(-1, 3).contiguous()
    cargs = (pts, img[::4, ::4].reshape(-1, 3).contiguous(), pts[:, 2] > 0, img, gx, gy,
             torch.as_tensor(ttrk._level_cam(cams[3].K, 0, False), device=cuda_device),
             False, 50, ttrk._STEP_EXIT, _color_state(pose_inv(c2w)),
             torch.zeros((), dtype=torch.int64, device=cuda_device),
             torch.zeros((), dtype=torch.bool, device=cuda_device),
             color_gn.partials_buffer(pts.shape[0], cuda_device))
    color_gn.load()
    kernels.reset_counts()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tint.integrate_blocks_packed(d, rgbp, keys, ptrs, vol.state, vol.color,
                                     vol.summary, *tail)
        w2c, fx, fy, cx, cy, vs, mu, max_w = tail
        tint.integrate_blocks(d, rgbp, keys, valid, *f32, w2c, fx, fy, cx, cy,
                              d.shape[1], d.shape[0], vs, mu, max_w)
        trc.march(*margs)
        trc.march(*margs, track=True)
        lv.iterate(50)
        color_gn.iterate(*cargs, first=True, budget=50)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert kernels.counts() == {"integrate_cuda": 1, "integrate_f32_cuda": 1,
                                "raycast_cuda": 2, "splat_fwd_cuda": 0,
                                "splat_bwd_cuda": 0,
                                "icp_gn_cuda": 1, "color_gn_cuda": 1,
                                "project_sh_fwd_cuda": 0, "project_sh_bwd_cuda": 0,
                                "window_adam_cuda": 0}


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
def test_splat_fwd_cuda_skips_dead_slots(cuda_device):
    """splat_fwd_cuda on lists whose NULL padding is shuffled between the
    live slots and where a fifth of the Gaussians have an opacity below
    1/255 (zero among them) and a tenth exactly 1/255; tile 0's list holds
    two Gaussians centred on a pixel (sigma exactly 0 there), one of
    opacity exactly 1/255 and one just above it, so that both add their
    opacity to that pixel.  The kernel drops only the slots that cannot
    contribute and sums the rest in list order, so it gives the plain
    version's bits, and the same bits on a second launch."""
    packed, gids, px, py, ref = _splat_inputs(cuda_device, seed=5)
    g = torch.Generator().manual_seed(6)
    A, L = gids.shape
    order = torch.argsort(torch.rand((A, L), generator=g), 1).to(cuda_device)
    gids = torch.gather(gids, 1, order).contiguous()
    n = packed.shape[0] - 1
    pick = torch.rand(n, generator=g).to(cuda_device)
    opac = torch.where(pick < 0.1, 0.0,
                       torch.where(pick < 0.2, 0.5 / 255.0, packed[:n, 10]))
    gmin = torch.tensor(1.0 / 255.0, device=cuda_device)
    packed[:n, 10] = torch.where((pick >= 0.2) & (pick < 0.3), gmin, opac)
    assert (gids == n).any(1).float().mean() > 0.5
    # the edge: rows 0 and 1 sit on tile 0's pixels 0 and 17, narrow and
    # in front of the reference depth
    above = torch.nextafter(gmin, torch.tensor(1.0, device=cuda_device))
    for row, pix, op_r in ((0, 0, gmin), (1, 17, above)):
        packed[row, :2] = torch.stack((px[0, pix], py[0, pix]))
        packed[row, 2:5] = torch.tensor([0.5, 0.0, 0.5], device=cuda_device)
        packed[row, 9] = 0.5
        packed[row, 10] = op_r
    gids[0] = n
    gids[0, 3], gids[0, 40] = 0, 1
    ok = trz.splat_fwd(packed, gids, px, py, ref, 0.1, 4)
    again = trz.splat_fwd(packed, gids, px, py, ref, 0.1, 4)
    op = trz.splat_fwd_plain(packed, gids, px, py, ref, 0.1, 4)
    torch.cuda.synchronize()
    assert torch.equal(ok, again)
    assert ok[:, 4].max() > 0.5
    assert op[0, 4, 0] == gmin and op[0, 4, 17] == above
    assert torch.equal(ok, op)


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


def _dead_slot_scene(device):
    """One 16x16 tile whose list holds 8 narrow Gaussians (C = 4), each
    centred on its own pixel in front of the reference depth, at opacities
    0, 0.5/255, just below 1/255, exactly 1/255, just above it, 0.3, 0.5
    and 0.9, shuffled between two NULL slots; and a random cotangent.
    Returns the splat_bwd arguments, the opacity of each slot's row and
    the slot, pixel and row of the Gaussian at exactly 1/255."""
    g = torch.Generator().manual_seed(21)
    gmin = torch.tensor(1.0 / 255.0)
    opac = torch.stack([torch.tensor(0.0), torch.tensor(0.5 / 255.0),
                        torch.nextafter(gmin, torch.tensor(0.0)), gmin,
                        torch.nextafter(gmin, torch.tensor(1.0)),
                        torch.tensor(0.3), torch.tensor(0.5), torch.tensor(0.9)])
    n = opac.shape[0]
    pix = torch.tensor([0, 17, 34, 51, 68, 85, 102, 119])
    px, py = trz._tile_pixels(torch.tensor([0]), 1, 16)
    m2d = torch.stack((px[0, pix], py[0, pix]), 1)
    conics = torch.tensor([0.5, 0.0, 0.5]).expand(n, 3)
    packed = trz._pack_attrs(m2d, conics, torch.rand((n, 4), generator=g),
                             torch.full((n,), 0.5), opac)
    gids = torch.cat([torch.randperm(n, generator=g), torch.tensor([n, n])])
    gids = gids[torch.randperm(n + 2, generator=g)].to(torch.int32)[None]
    v_out = torch.randn((1, 5, 256), generator=g)
    ref = torch.ones((1, 256))
    args = tuple(x.to(device).contiguous() for x in (packed, gids, px, py, ref, v_out))
    slot = int((gids[0] == 3).nonzero()[0, 0])
    return args, packed[gids[0].long(), 10], (slot, int(pix[3]))


def test_splat_bwd_plain_dead_slots_are_exact_zeros():
    """The rule K5's skip rests on, in its plain version (runs without a
    card): a slot whose row has opacity below 1/255 (the NULL row's is 0)
    keeps no pixel, so its [6+C] output row is exactly zero; a Gaussian at
    exactly 1/255 keeps the one pixel it is centred on (alpha = 1/255
    there), so its colour columns are exactly 1/255 times that pixel's
    cotangent."""
    args, op, (slot, p) = _dead_slot_scene("cpu")
    out = trz.splat_bwd_plain(*args, 0.1, 4)[0]
    dead = op < 1.0 / 255.0
    assert int(dead.sum()) == 5  # 3 rows below 1/255 and 2 NULL slots
    assert torch.equal(out[dead], torch.zeros_like(out[dead]))
    assert (out[~dead].abs().amax(1) > 0).all()
    v_out = args[5]
    gmin = torch.tensor(1.0 / 255.0)
    assert torch.equal(out[slot, 5:9], gmin * v_out[0, :4, p])


@pytest.mark.cuda
def test_splat_bwd_cuda_dead_slot_edge(cuda_device):
    """splat_bwd_cuda on `_dead_slot_scene`: the slots below 1/255 and the
    NULL slots come back as exact zeros, the Gaussians at exactly 1/255 and
    just above it are computed, and every column is within 1e-4 of its
    largest |value| of the plain version."""
    args, op, (slot, p) = _dead_slot_scene(cuda_device)
    ok = trz.splat_bwd(*args, 0.1, 4)
    pl = trz.splat_bwd_plain(*args, 0.1, 4)
    torch.cuda.synchronize()
    ok, pl, op = ok[0].cpu(), pl[0].cpu(), op.cpu()
    dead = op < 1.0 / 255.0
    assert torch.equal(ok[dead], torch.zeros_like(ok[dead]))
    assert (ok[~dead].abs().amax(1) > 0).all()
    assert ((ok - pl).abs().amax(0) <= 1e-4 * pl.abs().amax(0)).all()


@pytest.mark.cuda
@pytest.mark.parametrize("L,C", [(1, 1), (1, 4), (64, 1), (64, 4), (256, 1), (256, 4)])
def test_splat_bwd_cuda_live_slots(cuda_device, L, C):
    """splat_bwd_cuda against its plain version over the kernel's range of
    list lengths and colour counts (L 1, 64, 256; C 1, 4; L (6+C) both a
    multiple of 4 and not): NULL padding shuffled between the live slots,
    a fifth of the Gaussians below opacity 1/255 (0 among them), a tenth
    at exactly 1/255 and a tenth just above it; tile 0's list holds no live
    slot and tile 1's L slots are all live.  Each column within 1e-4 of its
    largest |value| (the pixels are summed in another order), the same
    bits on a second launch, dead slots exact zeros."""
    g = torch.Generator().manual_seed(30 + L + C)
    H, W, n = 64, 96, 300
    m2d = torch.rand((n, 2), generator=g) * torch.tensor([W, H])
    conics = torch.rand((n, 3), generator=g) * torch.tensor([0.3, 0.02, 0.3]) \
        + torch.tensor([0.02, -0.01, 0.02])
    pick = torch.rand(n, generator=g)
    gmin = torch.tensor(1.0 / 255.0)
    opac = torch.where(pick < 0.1, 0.0, torch.where(pick < 0.2, 0.5 / 255.0,
                                                      torch.rand(n, generator=g)))
    opac = torch.where((pick >= 0.2) & (pick < 0.3), gmin, opac)
    opac = torch.where((pick >= 0.3) & (pick < 0.4),
                       torch.nextafter(gmin, torch.tensor(1.0)), opac)
    radii = torch.full((n,), 12, dtype=torch.int32)
    bins = trz.bin_gaussians_active(m2d, radii, 16, W // 16, H // 16, n, 9, L, 64)
    packed = trz._pack_attrs(m2d, conics, torch.rand((n, C), generator=g),
                             torch.rand(n, generator=g) + 0.5, opac)
    A = bins.gids.shape[0]
    order = torch.argsort(torch.rand((A, L), generator=g), 1)
    gids = torch.gather(bins.gids, 1, order)
    dead_rows = torch.nonzero(opac < gmin)[:, 0]
    live_rows = torch.nonzero(opac >= gmin)[:, 0]
    gids[0] = torch.where(torch.rand(L, generator=g) < 0.5, n,
                          dead_rows[torch.randint(len(dead_rows), (L,), generator=g)])
    gids[1] = live_rows[torch.randint(len(live_rows), (L,), generator=g)]
    px, py = trz._tile_pixels(bins.tiles, W // 16, 16)
    ref = torch.rand(px.shape, generator=g) + 0.8
    v_out = torch.randn((A, C + 1, 256), generator=g)
    args = tuple(x.to(cuda_device).contiguous() for x in
                 (packed, gids.to(torch.int32), px, py, ref, v_out))
    ok = trz.splat_bwd(*args, 0.1, C)
    again = trz.splat_bwd(*args, 0.1, C)
    op = trz.splat_bwd_plain(*args, 0.1, C)
    torch.cuda.synchronize()
    assert ok.shape == op.shape == (A, L, 6 + C)
    assert torch.equal(ok, again)
    dead = packed[gids.long(), 6 + C].to(cuda_device) < gmin.to(cuda_device)
    assert dead.any() and (~dead).any() and dead[0].all() and not dead[1].any()
    assert torch.equal(ok[dead], torch.zeros_like(ok[dead]))
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
    gids = torch.zeros((4, 8), dtype=torch.int32, device=cuda_device)
    px, v_out = torch.zeros((4, 256), device=cuda_device), torch.zeros((4, 5, 256), device=cuda_device)
    for packed in (torch.zeros(3 * 16 + 1, device=cuda_device)[1:].view(3, 16),  # misaligned
                   torch.zeros((3, 14), device=cuda_device)):                    # cols % 4
        with pytest.raises(ValueError):
            trz.splat_bwd(packed, gids, px, px, px, v_out, 0.1, 4)
    d = torch.zeros((72, 96), device=cuda_device)
    planes = [torch.zeros((4, 512), device=cuda_device)] * 4
    with pytest.raises(ValueError):  # an int32 colour plane given as f32
        tint.integrate_blocks(d, d.int(), x[:, 0].int(), x[:, 0].bool(), *planes,
                              torch.eye(4, device=cuda_device), 1.0, 1.0, 1.0, 1.0,
                              96, 72, 0.01, 0.02, 100)


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


def test_library_name_follows_included_headers(tmp_path, monkeypatch):
    """A kernel's library is named by its source and the csrc/ headers it
    includes (runs without a card): editing either renames the library, so
    a stale build is never loaded; the shipped sources that stage rows
    include the shared TMA header."""
    from gps_slam_torch import kernels

    for k in (kernels.RAYCAST, kernels.SPLAT_FWD):
        assert '#include "tma.cuh"' in k.path.read_text()
    monkeypatch.setattr(kernels, "CSRC", tmp_path)
    k = kernels.Kernel("k", "k.cu", "k", [], "test")
    (tmp_path / "k.cu").write_text('#include <stdint.h>\n#include "h.cuh"\nint x;\n')
    (tmp_path / "h.cuh").write_text("int y;\n")
    first = k.lib_path()
    (tmp_path / "h.cuh").write_text("int z;\n")
    second = k.lib_path()
    (tmp_path / "k.cu").write_text('#include <stdint.h>\n#include "h.cuh"\nint w;\n')
    assert len({first, second, k.lib_path()}) == 3
    assert first.name.startswith("libk_") and first.parent == kernels.BUILD


def test_library_name_follows_nvcc_flags(tmp_path, monkeypatch):
    """A kernel's flags take part in its library's name (runs without a
    card), so a library built with other flags is never loaded; every
    kernel is built without multiply-add contraction, so that it rounds
    like its plain version, except K5, which is held to a tolerance."""
    from gps_slam_torch import kernels

    for k in kernels.ALL:
        fl = k.nvcc_flags()
        assert fl[:len(kernels.NVCC_FLAGS)] == kernels.NVCC_FLAGS
        if k is kernels.SPLAT_BWD:
            assert "-fmad=true" in fl and "-fmad=false" not in fl
        else:
            assert "-fmad=false" in fl and "-fmad=true" not in fl
    monkeypatch.setattr(kernels, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text("int x;\n")
    exact = kernels.Kernel("k", "k.cu", "k", [], "test")
    fused = kernels.Kernel("k", "k.cu", "k", [], "test", flags=("-fmad=true",))
    assert exact.flags == kernels.EXACT
    assert exact.lib_path() != fused.lib_path()
    assert exact.lib_path() == kernels.Kernel("k", "k.cu", "k", [], "other").lib_path()


def _tracking_engines(cuda_device, W=128, H=96):
    """Port engines on the CPU and on the card in tracked mode (2 cm voxels,
    ICP), the 8 frames of chip_smoke's `[reference tracked]` phase."""
    from gps_slam_torch.config import Config
    from gps_slam_torch.slam.tracker import ICPTracker
    from gps_slam_torch.tsdf.engine import TsdfEngine

    cams = synthetic.make_cameras(n_frames=8, width=W, height=H, look="in", arc=0.0125)
    c0 = cams[0]
    node = {"input_dir": "mem", "image_path": "c", "pose_path": "c", "depth_path": "d",
            "pcd_name": "n", "depth_scale": 6553.5, "scene_scale": 1.0,
            "start_frame": 0, "end_frame": 7, "frame_step": 1,
            "intrinsics": [c0.fx, c0.fy, c0.cx, c0.cy], "image_shape": [W, H],
            "downscale_factor": 1, "test_split_interval": -1}
    d = synthetic.default_config_dict("build/test_ws", node)
    d["PIPE"]["TSDF"]["use_gt_pose"] = False
    cfg = Config.from_dict(d)
    out = []
    for dev in ("cpu", cuda_device):
        e = TsdfEngine(cfg, W, H, c0.K, device=dev)
        e.set_gt_poses([c0.c2w])
        e.attach_tracker(ICPTracker(cfg, W, H))
        out.append(e)
    return cams, out


@pytest.mark.cuda
def test_tracked_step_cuda_matches_cpu(cuda_device):
    """One tracked step (frame 0 fused at its gt pose, its tracking-prepare
    raycast, frame 1 tracked) on the card against the CPU: the same
    quality, the pose within the `[reference tracked]` tolerance (1 voxel
    and 0.1 degree)."""
    from gps_slam_torch.utils.se3 import rot_angle_deg

    cams, engines = _tracking_engines(cuda_device)
    for e in engines:
        for c in cams[:2]:
            e.process_frame(c.image, c.depth)
    cpu, card = engines
    assert card._tracking_quality == cpu._tracking_quality
    p, q = card.cam_poses[1], cpu.cam_poses[1]
    assert np.linalg.norm(p[:3, 3] - q[:3, 3]) < cpu.params.voxel_size
    assert float(rot_angle_deg(torch.as_tensor(p[:3, :3]), torch.as_tensor(q[:3, :3]))) < 0.1


@pytest.mark.cuda
def test_track_level_reads_back_once_per_iteration(cuda_device):
    """A tracking level on the card under torch.cuda.set_sync_debug_mode
    ("warn"): the level's loop is one launch whose exit test stays on the
    card, and its only synchronising call is the planned read of the
    iterations run, once a level whatever their number."""
    import warnings

    from gps_slam_torch.slam import tracker as ttrk

    cams, (cpu, _) = _tracking_engines(cuda_device)
    cpu.process_frame(cams[0].image, cams[0].depth)
    maps = cpu._last_raycast_for_tracking
    dev = cuda_device
    ref_v, ref_n = (maps[k].to(dev) for k in ("vertex_map", "normal_map"))
    depth = torch.as_tensor(cams[1].depth[..., 0], device=dev)
    K = cams[0].K
    cam = torch.as_tensor(ttrk._level_cam(K, 0, True), device=dev)
    T0 = torch.as_tensor(cams[0].c2w, device=dev)
    rpi = torch.as_tensor(np.linalg.inv(cams[0].c2w), device=dev)
    st, tk = ttrk._scalar(0.015, dev), ttrk._scalar(0.02, dev)
    ttrk._track_level(T0, depth, ref_v, ref_n, cam, 2, False, rpi, st, tk)  # warm up
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            _, _, _, n_iters = ttrk._track_level(T0, depth, ref_v, ref_n, cam, 50, False,
                                                 rpi, st, tk)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    # the one message torch gives per synchronising call (the first call
    # of set_sync_debug_mode in a process also warns that the mode is a
    # prototype, in other words)
    syncs = [w for w in caught if "called a synchronizing CUDA operation" in str(w.message)]
    assert n_iters >= 2
    assert len(syncs) == 1, [str(w.message) for w in syncs]


@pytest.mark.cuda
def test_native_mesher_on_the_card_machine(cuda_device):
    """The mesher built by that machine's g++ meshes a volume fused on the
    card as the numpy route does (the comparison of test_native.py)."""
    from gps_slam_torch.tsdf import meshing, native

    cams = synthetic.make_cameras(n_frames=4, width=96, height=72)
    p = tvol.TsdfParams(voxel_size=0.02, mu=0.08, hash_size=1 << 15,
                        block_capacity=1 << 12, visible_capacity=1 << 11)
    vol = tvol.create(p, cuda_device)
    for c in cams:
        tint.fuse_frame(vol, torch.as_tensor(c.depth[..., 0], device=cuda_device),
                        torch.as_tensor(c.image, device=cuda_device),
                        torch.as_tensor(c.c2w, device=cuda_device), c.K)
    native.load()
    assert native.loaded_path().exists()
    vn, cn = meshing.extract_mesh(vol, use_native=True)
    vp, cp = meshing.extract_mesh(vol, use_native=False)
    assert vn.shape == vp.shape and vn.shape[0] > 0
    np.testing.assert_allclose(np.sort(vn.reshape(-1, 9), 0), np.sort(vp.reshape(-1, 9), 0),
                               atol=1e-5)
    np.testing.assert_allclose(np.sort(cn.reshape(-1, 9), 0), np.sort(cp.reshape(-1, 9), 0),
                               atol=2e-2)


def test_mesher_library_name_follows_source_and_flags(tmp_path, monkeypatch):
    """The mesher's libraries (runs without a card) lie in build/ and are
    named by the hash of native/mesher.cpp, of their g++ flags and of the
    host's name, so an edited source or flag is rebuilt, a -march=native
    build is never loaded on another host, and the OpenMP and serial
    builds never share a name; the tracked native/libmesher.so is never
    the one loaded."""
    from gps_slam_torch.tsdf import native

    libs = [native.lib_path(f) for f in native.VARIANTS]
    assert "-fopenmp" in native.VARIANTS[0] and "-fopenmp" not in native.VARIANTS[1]
    assert len(set(libs)) == 2
    for lib in libs:
        assert lib.parent == native.BUILD and lib.name.startswith("libmesher_")
        assert lib != native.ROOT / "native" / "libmesher.so"
    src = tmp_path / "mesher.cpp"
    src.write_bytes(native.SOURCE.read_bytes() + b"\n")
    monkeypatch.setattr(native, "SOURCE", src)
    edited = native.lib_path()
    assert edited not in libs
    monkeypatch.setattr(native.platform, "node", lambda: "another-host")
    assert native.lib_path() not in libs + [edited]


@pytest.mark.cuda
def test_swapping_cuda_matches_cpu(cuda_device):
    """tests/test_swapping.py's fixture shortened to 16 frames (a full
    outward turn at 128x96, 1024-block pool, check every 2 frames, waters
    0.80 / 0.50) on the card and on the CPU: after every frame the same
    allocated, spill and reload counts and the same store keys; at the end
    the same block keys, and by key the state words' weights equal, sdf
    within 1 quantum, colour within 1 (fusion's tolerance: the host merge
    then works on words that agree that far)."""
    from gps_slam_torch.config import Config
    from gps_slam_torch.tsdf.engine import TsdfEngine

    W, H = 128, 96
    cams = synthetic.make_cameras(n_frames=24, width=W, height=H, look="out", arc=1.0)[:16]
    c0 = cams[0]
    node = {"input_dir": "mem", "image_path": "c", "pose_path": "c", "depth_path": "d",
            "pcd_name": "n", "depth_scale": 6553.5, "scene_scale": 1.0,
            "start_frame": 0, "end_frame": 15, "frame_step": 1,
            "intrinsics": [c0.fx, c0.fy, c0.cx, c0.cy], "image_shape": [W, H],
            "downscale_factor": 1, "test_split_interval": -1}
    d = synthetic.default_config_dict("build/test_ws", node)
    d["TPU"].update(block_capacity=1024, hash_size=2 ** 15, visible_block_capacity=2 ** 12,
                    alloc_candidate_cap=2 ** 13, enable_swapping=1, swap_check_interval=2,
                    swap_high_water=0.80, swap_low_water=0.50)
    engines = []
    for dev in (cuda_device, "cpu"):
        e = TsdfEngine(Config.from_dict(d), W, H, c0.K, device=dev)
        e.set_gt_poses([c.c2w for c in cams])
        e.turn_off_tracking()
        engines.append(e)
    for c in cams:
        counts = []
        for e in engines:
            e.process_frame(c.image, c.depth)
            counts.append((e.vol.n_blocks, e.swap.n_spilled_total,
                           e.swap.n_reloaded_total, sorted(e.swap.store)))
        assert counts[0] == counts[1]
    card, cpu = engines
    assert card.swap.n_spilled_total > 0
    n = cpu.vol.n_blocks
    kc, kp = (e.vol.block_coords[:n].cpu() for e in engines)
    assert torch.equal(torch.sort(kc).values, torch.sort(kp).values)
    sc, sp = card.vol.state[:n].cpu()[torch.argsort(kc)], cpu.vol.state[:n][torch.argsort(kp)]
    cc, cp = card.vol.color[:n].cpu()[torch.argsort(kc)], cpu.vol.color[:n][torch.argsort(kp)]
    assert torch.equal(sc >> 16, sp >> 16)
    sdf = lambda w: ((w & 0xFFFF) ^ 0x8000) - 0x8000  # noqa: E731
    assert int((sdf(sc) - sdf(sp)).abs().max()) <= 1
    for s in (0, 8, 16):
        assert int((((cc >> s) & 0xFF) - ((cp >> s) & 0xFF)).abs().max()) <= 1


@pytest.mark.cuda
def test_classic_rasterize_cuda_matches_cpu(cuda_device):
    """The classic compositor at 96x72 over 300 wide Gaussians (some pixels
    past T < 1e-4) on the card against the CPU: the same lists, render
    and alpha within 1e-5, and the gradients of sum(render * R) +
    sum(alpha * A) within 1e-4 of each input's largest |gradient| plus
    2e-4 of its own value (sums in another order; the gathers' gradients
    are summed by atomics on the card)."""
    from gps_slam_torch.gs import rasterize_classic as trc_

    rng = np.random.default_rng(4)
    n, W, H = 300, 96, 72
    a, c = rng.uniform(0.005, 0.05, n), rng.uniform(0.005, 0.05, n)
    g = {"means2d": np.stack([rng.uniform(-10, W + 10, n), rng.uniform(-10, H + 10, n)], -1),
         "conics": np.stack([a, rng.uniform(-0.5, 0.5, n) * np.sqrt(a * c), c], -1),
         "colors": rng.uniform(0, 1, (n, 4)), "opac": rng.uniform(0.5, 0.99, n)}
    g = {k: v.astype(np.float32) for k, v in g.items()}
    radii = rng.integers(1, 40, n).astype(np.int32)
    depths = (rng.integers(1, 12, n) * 0.25).astype(np.float32)
    R = rng.normal(size=(H, W, 4)).astype(np.float32)
    A = rng.normal(size=(H, W)).astype(np.float32)
    out = []
    for dev in (cuda_device, "cpu"):
        xs = [torch.tensor(g[k], device=dev, requires_grad=True)
              for k in ("means2d", "conics", "colors", "opac")]
        bins = trc_.bin_gaussians_depth(xs[0], torch.as_tensor(radii, device=dev),
                                        torch.as_tensor(depths, device=dev), 16, 6, 5, n, 16, 64)
        r, al = trc_.classic_rasterize(*xs, bins, W, H, 16)
        ((r * torch.as_tensor(R, device=dev)).sum()
         + (al * torch.as_tensor(A, device=dev)).sum()).backward()
        out.append((bins, r.detach().cpu(), al.detach().cpu(), [x.grad.cpu() for x in xs]))
    (bk, rk, ak, gk), (bp, rp, ap, gp) = out
    assert torch.equal(bk.valid.cpu(), bp.valid) and torch.equal(bk.gids.cpu()[bp.valid],
                                                                 bp.gids[bp.valid])
    assert float((ap > 0.9999).float().mean()) > 0.01
    torch.testing.assert_close(rk, rp, rtol=0, atol=1e-5)
    torch.testing.assert_close(ak, ap, rtol=0, atol=1e-5)
    for x, y in zip(gk, gp):
        torch.testing.assert_close(x, y, rtol=2e-4, atol=1e-4 * float(y.abs().max()))


@pytest.mark.cuda
def test_sharded_fusion_and_raycast_cuda_match_cpu(cuda_device):
    """8 frames at 128x96 fused into 2 space shards on the card and on the
    CPU: each shard holds the same block keys, and by key the state words'
    weights are equal, sdf within 1 quantum and colour within 1 (fusion's
    tolerance, test_swapping_cuda_matches_cpu); the merged raycast from
    frame 3 has equal hit masks and depths within 1e-4 m."""
    from gps_slam_torch.parallel import spatial

    cams = synthetic.make_cameras(n_frames=8, width=128, height=96)
    p = tvol.TsdfParams(voxel_size=0.02, mu=0.08, hash_size=1 << 15,
                        block_capacity=1 << 12, visible_capacity=1 << 12)
    shards = {}
    for dev in (cuda_device, torch.device("cpu")):
        s = spatial.create_sharded(p, 2, dev)
        for cam in cams:
            spatial.fuse_frame_sharded(
                s, torch.as_tensor(cam.depth[..., 0], device=dev),
                torch.as_tensor(cam.image, device=dev),
                torch.as_tensor(cam.c2w, device=dev), cam.K)
        shards[dev.type] = s
    sdf = lambda w: ((w & 0xFFFF) ^ 0x8000) - 0x8000  # noqa: E731
    for vc, vp in zip(shards["cuda"], shards["cpu"]):
        assert vc.n_blocks == vp.n_blocks > 0
        n = vp.n_blocks
        kc, kp = vc.block_coords[:n].cpu(), vp.block_coords[:n]
        oc, op = torch.argsort(kc), torch.argsort(kp)
        assert torch.equal(kc[oc], kp[op])
        sc, sp = vc.state[:n].cpu()[oc], vp.state[:n][op]
        cc, cp = vc.color[:n].cpu()[oc], vp.color[:n][op]
        assert torch.equal(sc >> 16, sp >> 16)
        assert int((sdf(sc) - sdf(sp)).abs().max()) <= 1
        for b in (0, 8, 16):
            assert int((((cc >> b) & 0xFF) - ((cp >> b) & 0xFF)).abs().max()) <= 1
    cam = cams[3]
    mc, mp = (spatial.raycast_sharded(shards[k], cam.c2w, cam.K, 128, 96, 16, 4, 6, 2)
              for k in ("cuda", "cpu"))
    dc, dp = mc["depth_map"].cpu(), mp["depth_map"]
    assert torch.equal(dc > 0, dp > 0) and float((dp > 0).float().mean()) > 0.5
    assert float((dc - dp).abs().max()) <= 1e-4


@pytest.mark.cuda
def test_dp_render_and_prefetch_cuda(cuda_device):
    """`dp_render` over [cuda, cuda] equals `render_eval_batch` on the card
    bit for bit (4 cameras), and `FramePrefetcher` on the card yields 6
    frames in order, each equal to `DeviceFrameCache`'s tensors bit for
    bit after the consumer stream's wait."""
    from gps_slam_torch.data.device_cache import DeviceFrameCache
    from gps_slam_torch.data.prefetch import FramePrefetcher
    from gps_slam_torch.gs.model import RenderStatics, render_eval_batch
    from gps_slam_torch.gs.params import create
    from gps_slam_torch.parallel import mesh as pmesh

    rng = np.random.default_rng(0)
    W, H, n, cap = 64, 48, 256, 512
    pool = create(cap, 1, device=cuda_device)
    with torch.no_grad():
        pool.means[:n] = torch.as_tensor(rng.uniform(-1, 1, (n, 3)) + [0, 0, 2.0],
                                         dtype=torch.float32, device=cuda_device)
        pool.scales[:n] = -3.0
        pool.quats[:n, 0] = 1.0
        pool.features_dc[:n] = torch.as_tensor(rng.uniform(-0.5, 0.5, (n, 3)),
                                               dtype=torch.float32, device=cuda_device)
        pool.opacities[:n] = 1.0
        pool.alive[:n] = True
    st = RenderStatics(width=W, height=H, sh_degree=1, tile_size=16, max_gs_radii=100,
                       delta_depth=0.1, use_exposure=False, visible_cap=cap,
                       tiles_per_gaussian_cap=16, tile_cap=64)
    K = torch.tensor([[48.0, 0, 32], [0, 48.0, 24], [0, 0, 1]], device=cuda_device)
    poses = torch.eye(4, device=cuda_device).repeat(4, 1, 1)
    poses[:, :3, 3] = torch.as_tensor(rng.normal(0, 0.05, (4, 3)), dtype=torch.float32,
                                      device=cuda_device)
    batch = {"c2w": poses, "K": K.repeat(4, 1, 1),
             "ref_depth": torch.zeros((4, H, W), device=cuda_device),
             "base_color": torch.zeros((4, H, W, 3), device=cuda_device),
             "cam_id": torch.full((4,), -1, dtype=torch.int32)}
    ref = render_eval_batch(pool.params, pool.alive, batch, st)
    dp = pmesh.dp_render([cuda_device, cuda_device], pool.params, pool.alive, batch, st)
    for k in ("rgb", "alpha", "depth"):
        assert torch.equal(dp[k], ref[k]), k
    assert float(ref["alpha"].sum()) > 0

    cams = synthetic.make_cameras(6, 160, 120)
    cache = DeviceFrameCache(cuda_device)
    seen = []
    for cam, depth, rgb in FramePrefetcher(cams, cuda_device):
        r, d = cache.get(cam)
        assert depth.is_cuda and torch.equal(depth, d) and torch.equal(rgb, r)
        seen.append(cam.id)
    assert seen == [c.id for c in cams]


@pytest.mark.cuda
def test_lpips_cuda_matches_cpu(cuda_device):
    """LPIPS(vgg) with seeded random weights on a batch of 2 pairs at
    64x48: the card (cuDNN convolutions, TF32 off) within 1e-5 relative of
    the CPU."""
    from gps_slam_torch.eval import lpips_torch

    w = lpips_torch.random_weights(np.random.default_rng(0))
    rng = np.random.default_rng(1)
    a = rng.uniform(0, 1, (2, 48, 64, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    got = lpips_torch.LpipsTorch(w, cuda_device)(a, b)
    want = lpips_torch.LpipsTorch(w, "cpu")(a, b)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


ROW_KEYS_CUDA = ("means", "scales", "quats", "features_dc", "features_rest", "opacities")


def _megastep_window(cuda_device, fused, tmp_path):
    """One window megastep's state and inputs on the card: the fixture's
    volume, a pool spawned on the CPU from three frames' maps, the
    synthetic config's statics (128 x 96), M = 4 padded poses."""
    from gps_slam_torch.config import Config
    from gps_slam_torch.gs import model as tmodel
    from gps_slam_torch.slam import megastep as ms

    vol, cams = fused
    W, H = cams[0].width, cams[0].height
    c0 = cams[0]
    node = {"input_dir": "mem", "image_path": "c", "pose_path": "c", "depth_path": "d",
            "pcd_name": "n", "depth_scale": 6553.5, "scene_scale": 1.0,
            "start_frame": 0, "end_frame": 7, "frame_step": 1,
            "intrinsics": [c0.fx, c0.fy, c0.cx, c0.cy], "image_shape": [W, H],
            "downscale_factor": 1, "test_split_interval": -1}
    cfg = Config.from_dict(synthetic.default_config_dict(str(tmp_path), node))
    model = tmodel.GaussianModel(cfg, W, H, device="cpu")
    mask = torch.zeros((H, W), dtype=torch.bool)
    mask[::6, ::6] = True
    for i, cam in enumerate(cams[:3]):
        fm = cam.get_frame_maps("cpu")
        tmodel.add_gaussians(model.pool, fm["vertex_map"], fm["color_map"],
                             fm["normal_map"], mask, 0.6, 1024, 0.5, (0.001, 0.05),
                             torch.Generator().manual_seed(i))
    p, m, tpu = cfg.pipe, cfg.model, cfg.tpu
    opt_cap = model.opt_cap(extra=tpu.max_new_gaussians)
    st = model.statics
    n_tiles = -(-W // st.tile_size) * -(-H // st.tile_size)
    vp = vol.params
    statics = dict(
        K=np.asarray(c0.K, np.float32), st=st, mcfg=m, spawn_idx=1, opt_cap=opt_cap,
        st_spawn=st._replace(visible_cap=min(st.visible_cap, opt_cap),
                             active_tile_cap=min(n_tiles, max(st.active_tile_cap,
                                                              opt_cap // 8))),
        sc=ms.WindowScalars(
            p.depth_vis_min, p.depth_vis_max, p.color_error_thres, p.alpha_vis_max,
            p.new_gs_sample_ratio, tpu.max_new_gaussians, m.default_opacities,
            m.min_init_scale, m.max_init_scale, p.remove_small_scale_thres,
            p.remove_large_scale_thres, p.remove_low_opac_thres, p.ssim_weight,
            p.depth_weight, p.max_iterations),
        rk=ms.RayKnobs(W, H, 16, 4, 6),
        pool_prefix=trc.pool_prefix(vol.n_blocks, vp.block_capacity))
    pool_np = {k: v.numpy() for k, v in model.pool.params.items()}
    return (_to(vol, cuda_device), pool_np, model.pool.alive.numpy(), cams, statics)


def _window_inputs(cams, device, seed):
    """A window's data: M = 4 poses of 3 cameras (the last repeated), their
    gt frames, 6 steps over them and the spawn priorities."""
    rng = np.random.default_rng(seed)
    sel = list(rng.choice(len(cams), 3, replace=False))
    sel.append(sel[-1])
    H, W = cams[0].height, cams[0].width
    return {"poses": torch.as_tensor(np.stack([cams[i].c2w for i in sel]), device=device),
            "gt_rgb": [torch.as_tensor(cams[i].image, device=device) for i in sel],
            "iter_cam_idx": torch.as_tensor(rng.integers(0, 3, 6), device=device),
            "spawn_noise": torch.as_tensor(rng.random(H * W).astype(np.float32),
                                           device=device)}


def _uncaptured(vol, pool, inp, statics):
    from gps_slam_torch.slam import megastep as ms

    st = dict(statics)
    return ms.window_megastep(vol, pool, inp["poses"], st.pop("K"),
                              torch.stack(inp["gt_rgb"]), inp["iter_cam_idx"],
                              inp["spawn_noise"], **st)


@pytest.mark.cuda
def test_megastep_graph_replays_equal_uncaptured(cuda_device, fused, tmp_path):
    """Three windows with other poses, camera sequences and spawn
    priorities through `WindowGraphs` (one capture, then two replays of the
    same graph) against the same windows run uncaptured on a copy of the
    pool: pools, loss histories and counts bit for bit.  The graph's
    recorded launches: K3 once per pose, K4 once for the spawn render and
    once per step, K5 once per step."""
    from gps_slam_torch import kernels
    from gps_slam_torch.slam import megastep as ms

    vol, pool_np, alive, cams, statics = _megastep_window(cuda_device, fused, tmp_path)
    ref = convert.pool_from_numpy(pool_np, alive, cuda_device)
    pool = convert.pool_from_numpy(pool_np, alive, cuda_device)
    graphs = ms.WindowGraphs()
    key = ("test", statics["opt_cap"], statics["pool_prefix"])
    for w in range(3):
        inp = _window_inputs(cams, cuda_device, seed=10 + w)
        want = _uncaptured(vol, ref, inp, statics)
        got = graphs.run(key, vol, pool, inp, **statics)
        torch.cuda.synchronize()
        assert graphs.last == (key, "capture" if w == 0 else "replay")
        for k in want:
            assert torch.equal(got[k], want[k]), (w, k)
        for k in (*ROW_KEYS_CUDA, "alive"):
            assert torch.equal(getattr(pool, k), getattr(ref, k)), (w, k)
        assert int(got["n_alive"]) == int(pool.alive.sum()) > 0
    assert (graphs.captures, graphs.replays) == (1, 2)
    (g,) = graphs.graphs.values()
    assert g.launches[kernels.RAYCAST.name] == 4
    assert g.launches[kernels.SPLAT_FWD.name] == 1 + 6
    assert g.launches[kernels.SPLAT_BWD.name] == 6
    assert graphs.replayed_launches[kernels.SPLAT_BWD.name] == 12
    assert g.memory_bytes > 0



@pytest.mark.cuda
def test_megastep_graphs_drop_on_rebinding(cuda_device, fused, tmp_path):
    """A pool tensor rebound to new storage drops the captured graphs: the
    next run captures again (and equals the uncaptured window)."""
    from gps_slam_torch.slam import megastep as ms

    vol, pool_np, alive, cams, statics = _megastep_window(cuda_device, fused, tmp_path)
    pool = convert.pool_from_numpy(pool_np, alive, cuda_device)
    graphs = ms.WindowGraphs()
    key = ("test",)
    graphs.run(key, vol, pool, _window_inputs(cams, cuda_device, 1), **statics)
    graphs.run(key, vol, pool, _window_inputs(cams, cuda_device, 2), **statics)
    assert (graphs.captures, graphs.replays, graphs.dropped) == (1, 1, 0)
    pool.means = pool.means.clone()
    ref = convert.pool_from_numpy({k: v.cpu().numpy() for k, v in pool.params.items()},
                                  pool.alive.cpu().numpy(), cuda_device)
    inp = _window_inputs(cams, cuda_device, 3)
    got = graphs.run(key, vol, pool, inp, **statics)
    want = _uncaptured(vol, ref, inp, statics)
    assert (graphs.captures, graphs.dropped, graphs.last[1]) == (2, 1, "capture")
    assert torch.equal(got["loss_hist"], want["loss_hist"])
    assert torch.equal(pool.means, ref.means)


@pytest.mark.cuda
def test_megastep_graphs_keep_the_last_keys(cuda_device, fused, tmp_path):
    """With room for one graph, a window under a second key drops the
    first key's graph, and a window under the first key captures it
    again; every window equals its uncaptured run."""
    from gps_slam_torch.slam import megastep as ms

    vol, pool_np, alive, cams, statics = _megastep_window(cuda_device, fused, tmp_path)
    ref = convert.pool_from_numpy(pool_np, alive, cuda_device)
    pool = convert.pool_from_numpy(pool_np, alive, cuda_device)
    graphs = ms.WindowGraphs(max_graphs=1)
    events = []
    for w, key in enumerate(("a", "a", "b", "a")):
        inp = _window_inputs(cams, cuda_device, seed=20 + w)
        want = _uncaptured(vol, ref, inp, statics)
        got = graphs.run((key,), vol, pool, inp, **statics)
        events.append(graphs.last[1])
        assert torch.equal(got["loss_hist"], want["loss_hist"]), w
        assert torch.equal(pool.means, ref.means), w
        assert list(graphs.graphs) == [(key,)]
    assert events == ["capture", "replay", "capture", "capture"]
    assert (graphs.captures, graphs.replays, graphs.dropped) == (3, 1, 2)
    assert graphs.peak_resident == 1


@pytest.mark.cuda
@pytest.mark.parametrize("ssim_weight", [0.0, 0.2], ids=["tile_loss", "ssim"])
def test_megastep_reads_nothing_back_on_the_card(cuda_device, fused, tmp_path,
                                                 ssim_weight):
    """The whole window, uncaptured, under
    torch.cuda.set_sync_debug_mode("error"): any call that synchronises
    with the host (a read-back, a pageable copy) raises.  Its constants
    are made first, as `WindowGraphs` makes them before a capture.  With
    PIPE.ssim_weight > 0 the window takes the image-space loss (stacked
    SSIM moments, the gathered render over padded tile lists)."""
    from gps_slam_torch.slam import megastep as ms

    vol, pool_np, alive, cams, statics = _megastep_window(cuda_device, fused, tmp_path)
    statics["sc"] = statics["sc"]._replace(ssim_weight=ssim_weight)
    pool = convert.pool_from_numpy(pool_np, alive, cuda_device)
    inp = _window_inputs(cams, cuda_device, 4)
    ms.hoist_constants(statics["mcfg"], statics["sc"], inp["iter_cam_idx"].shape[0],
                       cuda_device)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = _uncaptured(vol, pool, inp, statics)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.isfinite(out["loss_hist"]).all() and int(out["n_alive"]) > 0


# ------------------------------------- chunked gt fusion, tracked megastep

VOL_FIELDS = ("table_keys", "table_ptrs", "block_coords", "state", "color", "summary",
              "last_seen")


def _gt_engine(device, cams, route="packed"):
    """A gt-pose engine (2 cm voxels) over `cams`, fusion on `route`
    ("f32": the budget of the packed route lowered to 0 by the caller)."""
    from gps_slam_torch.config import Config
    from gps_slam_torch.tsdf.engine import TsdfEngine

    c0 = cams[0]
    W, H = c0.width, c0.height
    node = {"input_dir": "mem", "image_path": "c", "pose_path": "c", "depth_path": "d",
            "pcd_name": "n", "depth_scale": 6553.5, "scene_scale": 1.0,
            "start_frame": 0, "end_frame": len(cams) - 1, "frame_step": 1,
            "intrinsics": [c0.fx, c0.fy, c0.cx, c0.cy], "image_shape": [W, H],
            "downscale_factor": 1, "test_split_interval": -1}
    d = synthetic.default_config_dict("build/test_ws", node)
    e = TsdfEngine(Config.from_dict(d), W, H, c0.K, device=device)
    e.set_gt_poses([c.c2w for c in cams])
    e.turn_off_tracking()
    return e


def _frames_on(cams, device):
    return [(torch.as_tensor(c.image, device=device),
             torch.as_tensor(c.depth[..., 0], device=device)) for c in cams]


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["packed", "f32"])
def test_fusion_frame_graph_replays_equal_uncaptured(cuda_device, route, monkeypatch):
    """A group of 4 frames through `process_frames_gt` (the frame body
    captured once, then replayed 3 times) against the same frames through
    the uncaptured body on another card volume: every volume tensor and
    the counts bit for bit; the graph recorded one integrate launch."""
    from gps_slam_torch import kernels

    if route == "f32":
        monkeypatch.setattr(tint, "_RESIDENT_BYTES", 0)
    cams = synthetic.make_cameras(n_frames=4, width=128, height=96)
    frames = _frames_on(cams, cuda_device)
    e = _gt_engine(cuda_device, cams)
    ref = _gt_engine(cuda_device, cams)
    ref._fusion_graphs = None
    for eng in (e, ref):
        eng.process_frames_gt(frames)
    torch.cuda.synchronize()
    g = e._fusion_graphs
    assert (g.captures, g.replays) == (1, 3)
    for k in VOL_FIELDS:
        assert torch.equal(getattr(e.vol, k), getattr(ref.vol, k)), k
    assert (e.vol.n_blocks, e.vol.n_visible, e.peak_visible) == (
        ref.vol.n_blocks, ref.vol.n_visible, ref.peak_visible)
    assert e.vol.n_blocks > 100
    k = kernels.INTEGRATE if route == "packed" else kernels.INTEGRATE_F32
    (cap,) = g.graphs.values()
    assert cap.launches[k.name] == 1 and g.replayed_launches[k.name] == 3


@pytest.mark.cuda
def test_fusion_graphs_drop_on_rebinding(cuda_device):
    """A volume tensor rebound to new storage drops the fusion graph: the
    next group captures again, and the volume still equals the uncaptured
    one's."""
    cams = synthetic.make_cameras(n_frames=4, width=128, height=96)
    frames = _frames_on(cams, cuda_device)
    e = _gt_engine(cuda_device, cams)
    ref = _gt_engine(cuda_device, cams)
    ref._fusion_graphs = None
    for eng in (e, ref):
        eng.process_frames_gt(frames[:2])
    e.vol.state = e.vol.state.clone()
    for eng in (e, ref):
        eng.process_frames_gt(frames[2:])
    g = e._fusion_graphs
    assert (g.captures, g.replays, g.dropped) == (2, 2, 1)
    for k in VOL_FIELDS:
        assert torch.equal(getattr(e.vol, k), getattr(ref.vol, k)), k


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["packed", "f32", "tracked"])
def test_fixed_shape_bodies_never_synchronise(cuda_device, route, monkeypatch):
    """The chunk's frame body (K1's and K2's route) and the tracked
    megastep's frame, uncaptured on the card, under
    torch.cuda.set_sync_debug_mode("error"): any call that synchronises
    with the host (a read-back, a pageable copy) raises."""
    from gps_slam_torch.tsdf import engine as teng

    if route == "f32":
        monkeypatch.setattr(tint, "_RESIDENT_BYTES", 0)
    if route == "tracked":
        cams, (_, e) = _tracking_engines(cuda_device)
        e.process_frame(cams[0].image, cams[0].depth)
        tr, p, c = e._tracker, e.params, cams[1]
        maps = e._last_raycast_for_tracking
        args = (e.vol, e._n_blocks_dev, e._last_pose_dev,
                torch.as_tensor(c.depth[..., 0], device=cuda_device),
                torch.as_tensor(c.image, device=cuda_device),
                maps["vertex_map"], maps["normal_map"])
        kw = dict(K=e.K, level_iters=tuple(tr.level_iters), space_thresh=tr.space_thresh,
                  tukey_c=tr.tukey_c, bilateral=True,
                  ray=(c.width, c.height, p.raycast_lb, p.raycast_samples,
                       max(p.raycast_bisect, 3)), prefix=p.block_capacity)
        e._n_blocks_dev.fill_(e.vol.n_blocks)
        run = lambda: teng.track_fuse_step(*args, **kw)["pose"]
    else:
        cams = synthetic.make_cameras(n_frames=2, width=128, height=96)
        e = _gt_engine(cuda_device, cams)
        (rgb0, d0), (rgb1, d1) = _frames_on(cams, cuda_device)
        nb = e._n_blocks_dev
        poses = torch.as_tensor(np.stack([c.c2w for c in cams]), device=cuda_device)
        tint.fuse_frame_static(e.vol, d0, rgb0, poses[0], e.K, nb)
        run = lambda: tint.fuse_frame_static(e.vol, d1, rgb1, poses[1], e.K, nb,
                                             bilateral=True)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = run()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert bool(torch.isfinite(out.float()).all())


@pytest.mark.cuda
def test_tracked_graph_replays_equal_uncaptured(cuda_device):
    """Five frames of the tracked loop on two card engines: frame 0 eager,
    then the megastep, on one as its graph (captured once, replayed 3
    times), on the other uncaptured: the poses, quality labels, iteration
    counts, volumes and the last prepare raycast's maps bit for bit."""
    cams, (_, e) = _tracking_engines(cuda_device)
    _, (_, ref) = _tracking_engines(cuda_device)
    ref._track_graphs = None
    labels = {id(e): [], id(ref): []}
    for c in cams[:5]:
        for eng in (e, ref):
            eng.process_frame(c.image, c.depth)
            labels[id(eng)].append((eng._tracking_quality, eng._tracker.last_iters))
    g = e._track_graphs
    assert (g.captures, g.replays) == (1, 3)
    assert labels[id(e)] == labels[id(ref)]
    np.testing.assert_array_equal(np.stack(e.cam_poses), np.stack(ref.cam_poses))
    for k in VOL_FIELDS:
        assert torch.equal(getattr(e.vol, k), getattr(ref.vol, k)), k
    for k in ("vertex_map", "normal_map"):
        assert torch.equal(e._last_raycast_for_tracking[k],
                           ref._last_raycast_for_tracking[k]), k


@pytest.mark.cuda
def test_tracked_pyramid_while_nodes_replay_equal_uncaptured(cuda_device):
    """`track_pyramid_static` at 160x120 captured (budgets 50/10/30/20:
    each level one kernel node, `icp_gn_cuda` launched once a level, no
    conditional node) and replayed on two inputs: frame 1 against frame
    0's maps (every level exits early) and frame 2 (level 1 runs to its
    cap of 10).  Poses, inlier shares, residuals and the iterations per
    level bit for bit equal to the uncaptured run; the iterations also
    equal the eager `track_pyramid`'s."""
    from gps_slam_torch import kernels
    from gps_slam_torch.slam import tracker as ttrk
    from gps_slam_torch.tsdf import engine as teng
    from gps_slam_torch.utils import graphs
    from gps_slam_torch.utils import se3 as tse3

    dev, budgets = cuda_device, (50, 10, 30, 20)
    cams = synthetic.make_cameras(n_frames=16, width=160, height=120, look="in", arc=0.025)
    a = cams[0]
    vm = tse3.compute_vertex_map(torch.as_tensor(a.depth[..., 0], device=dev),
                                 a.fx, a.fy, a.cx, a.cy)
    nm = tse3.compute_normal_map(vm)
    ok = vm[..., 2:3] > 0
    c2w = torch.as_tensor(a.c2w, device=dev)
    vw = torch.where(ok, vm @ c2w[:3, :3].T + c2w[:3, 3], 0.0)
    nw = torch.where(ok, nm @ c2w[:3, :3].T, 0.0)
    depths = [torch.as_tensor(cams[k].depth[..., 0], device=dev) for k in (1, 2)]
    kernels.build_all()
    T_buf, d_buf = c2w.clone(), depths[0].clone()
    teng._before_tracked_capture({"depth": d_buf}, {})
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph(keep_graph=True)
    n0 = kernels.ICP_GN.launches
    with graphs.capture(g):
        out = ttrk.track_pyramid_static(T_buf, d_buf, vw, nw, a.K, budgets)
    nodes = graphs.node_counts(g)
    g.instantiate()
    assert nodes["conditional"] == 0 and kernels.ICP_GN.launches - n0 == 4
    runs = []
    for d in depths:
        d_buf.copy_(d)
        g.replay()
        ref = ttrk.track_pyramid_static(c2w, d, vw, nw, a.K, budgets)
        _, _, _, eager = ttrk.track_pyramid(c2w, d, vw, nw, a.K, tse3.pose_inv(c2w), budgets)
        torch.cuda.synchronize()
        for x, y in zip(out, ref):
            assert torch.equal(x, y)
        assert out[3].tolist() == eager
        runs.append(eager)
    assert all(n < b for n, b in zip(runs[0], budgets)), runs
    assert any(n == b for n, b in zip(runs[1], budgets)), runs


# ------------------------------------- icp_gn_cuda, the Gauss-Newton iteration

@pytest.fixture(scope="module")
def icp_levels(cuda_device):
    """The 4 pyramid levels of one tracking step at 1200x680 on the card
    (tests/test_torch_tracking.py's `ref_maps` at the tracked path's size:
    frame 0's world vertices and normals, frame 1's depth, frame 1's pose
    perturbed by a small twist): each level's `_track_level` arguments."""
    from gps_slam_torch.slam import tracker as ttrk
    from gps_slam_torch.utils import se3 as tse3

    dev = cuda_device
    # two frames at the per-frame motion of the 16-frame arc-0.025 fixture
    a, b = synthetic.make_cameras(n_frames=2, width=1200, height=680, look="in",
                                  arc=0.025 / 8)
    vm = tse3.compute_vertex_map(torch.as_tensor(a.depth[..., 0], device=dev),
                                 a.fx, a.fy, a.cx, a.cy)
    nm = tse3.compute_normal_map(vm)
    ok = vm[..., 2:3] > 0
    c2w = torch.as_tensor(a.c2w, device=dev)
    vw = torch.where(ok, vm @ c2w[:3, :3].T + c2w[:3, 3], 0.0).contiguous()
    nw = torch.where(ok, nm @ c2w[:3, :3].T, 0.0).contiguous()
    twist = torch.tensor([0.004, -0.003, 0.006, 0.004, -0.006, 0.003], device=dev)
    T0 = (tse3.se3_exp(twist) @ torch.as_tensor(b.c2w, device=dev)).contiguous()
    rpi = pose_inv(c2w)
    d = torch.as_tensor(b.depth[..., 0], device=dev)
    levels = []
    for lvl in range(4):
        cam = torch.as_tensor(ttrk._level_cam(a.K, lvl, True), device=dev)
        levels.append((T0, d, vw, nw, cam, ttrk.LEVEL_ITERS[lvl],
                       lvl >= ttrk.ROTATION_ONLY_FROM_LEVEL, rpi,
                       ttrk._scalar(ttrk.SPACE_THRESH[lvl], dev),
                       ttrk._scalar(ttrk.TUKEY_C[lvl], dev)))
        d = ttrk._subsample_depth(d)
    return levels


# the three exits of a level's launch: (name, n_iters, budget): by
# convergence (the step below the exit), at n_iters, after budget passes
GN_EXITS = (("converged", 100, 100), ("n_iters", 2, 100), ("budget", 100, 1))


def _barrier_idle(p, grid: int) -> bool:
    """The grid barrier's 64-bit count of arrivals (the scratch's last
    slot) at a multiple of the launch's grid: every barrier complete."""
    return int(p[-1:].view(torch.int64)[0]) % grid == 0


def _plain_level(iterate_plain, inputs, s, n, m, first, budget):
    """The plain level loop (`run_plain`'s) on (s, n, m) in place; returns
    the state its last pass started from."""
    before = s.clone()
    for k in range(budget):
        if k and not bool(m):
            break
        before = s.clone()
        iterate_plain(*inputs, s, n, m, first=first and k == 0)
    return before


def _level_runs(wrapper, iterate_plain, inputs, state, n_run, more, partials, first,
                budget):
    """The level kernel twice and its plain level loop once from the same
    state: [(state, n_run, more, partials)] and the state the plain loop's
    last pass started from."""
    runs = []
    for how in ("cuda", "cuda", "plain"):
        s, n, m, p = state.clone(), n_run.clone(), more.clone(), partials.clone()
        p[:-1].fill_(float("nan"))
        if how == "cuda":
            wrapper(*inputs, s, n, m, p, first=first, budget=budget)
        else:
            before = _plain_level(iterate_plain, inputs, s, n, m, first, budget)
        runs.append((s, n, m, p))
    torch.cuda.synchronize()
    return runs, before


def _assert_level_runs(runs, rows, kernel, n_terms, case):
    """Both launches of `kernel` and the plain loop: state, count and test
    bit for bit (a NaN equal to a NaN); the launches' scratch the same
    bits, its first half the last pass's per-CTA rows of the logical
    grid, the barrier idle."""
    from gps_slam_torch.slam import icp_gn

    (s1, n1, m1, p1), (s2, n2, m2, p2), (s3, n3, m3, _) = runs
    for a_, b_ in ((s1, s3), (n1, n3), (m1, m3), (s1, s2), (n1, n2), (m1, m2), (p1, p2)):
        assert _same(a_, b_), case
    assert _same(p1[:n_terms * rows.shape[0]].view(n_terms, -1).T, rows), case
    assert _barrier_idle(p1, icp_gn.grid(kernel, rows.shape[0])), case


@pytest.mark.cuda
@pytest.mark.parametrize("lvl", [0, 1, 2, 3])
def test_icp_gn_cuda_matches_plain(icp_levels, lvl):
    """`icp_gn_cuda`, a level's loop in one launch, against its plain level
    loop (`run_plain`: `iterate_plain` pass after pass while `more` holds)
    on the card at each level of a 1200x680 tracking step, in both
    rotation modes, and at the three exits (`GN_EXITS`): by
    convergence, at n_iters, and after a budget of one pass (from the
    level's start, `first`, and from the state its pass 0 left: one pass
    of the per-pass kernel this design replaced).  The state (T, T_acc,
    H, g, err, lam, step, inlier share, mean residual), the iteration count
    and the loop's test bit for bit; the last pass's per-CTA rows bit for
    bit with `cta_rows` of the plain terms at the state that pass started
    from; a second launch the same bits."""
    from gps_slam_torch import kernels
    from gps_slam_torch.slam import icp_gn
    from gps_slam_torch.slam import tracker as ttrk

    T0, d, vw, nw, cam, _, rot, rpi, st, tc = icp_levels[lvl]
    pts, has_depth = icp_gn.level_points(d, cam)
    n0 = kernels.ICP_GN.launches
    launches = 0
    for rot_mode in (rot, not rot):
        for exit_, n_iters, budget in GN_EXITS:
            inputs = (d, vw, nw, cam, rpi, st, tc, rot_mode, n_iters, ttrk._STEP_EXIT)
            # the level's start, and the state its pass 0 leaves
            fresh = torch.cat([T0.reshape(-1), T0.reshape(-1),
                               torch.eye(6, device=d.device).reshape(-1),
                               torch.zeros(6, device=d.device),
                               torch.tensor([float("inf"), 1e-3, 0.0, 0.0, 0.0],
                                            device=d.device)])
            lv = ttrk._StaticLevel(T0, d, vw, nw, cam, n_iters, rot_mode, rpi, st, tc)
            launches += 1
            starts = [(True, fresh, torch.zeros_like(lv.n_run), torch.zeros_like(lv.more))]
            if exit_ == "budget":
                starts.append((False, lv.state, lv.n_run, lv.more))
            for first, s0, r0, m0 in starts:
                case = (rot_mode, exit_, first)
                runs, before = _level_runs(icp_gn.iterate, icp_gn.iterate_plain, inputs,
                                           s0, r0, m0, lv.partials, first, budget)
                launches += 2
                x = icp_gn.terms(before[:16].view(4, 4), pts, has_depth, vw, nw, cam, rpi,
                                 st, tc, rot_mode)
                _assert_level_runs(runs, icp_gn.cta_rows(x), kernels.ICP_GN, icp_gn.N_TERMS,
                                   case)
                s1, n1, m1, _ = runs[0]
                ran = int(n1) - int(r0)
                if exit_ == "converged":
                    assert 1 < ran < n_iters and not bool(m1), case
                elif exit_ == "n_iters":
                    assert int(n1) == n_iters and not bool(m1), case
                else:
                    assert ran == 1 and bool(m1), case
    assert kernels.ICP_GN.launches - n0 == launches
    with pytest.raises(ValueError):   # an f64 state
        icp_gn.iterate(*inputs, lv.state.double(), lv.n_run, lv.more, lv.partials)


@pytest.mark.cuda
@pytest.mark.parametrize("lvl", [0, 3])
def test_icp_gn_while_level_runs_the_eager_iterations(icp_levels, lvl):
    """One level of the 1200x680 step captured (`_track_level_static` in
    `graphs.capture`: one launch, no conditional node) and replayed
    twice: the estimate, inlier share, residual and iteration count bit for
    bit with the eager level (`_track_level`, one read-back a level) and
    with the same level uncaptured, which exit before the budget."""
    from gps_slam_torch import kernels
    from gps_slam_torch.slam import tracker as ttrk
    from gps_slam_torch.utils import graphs

    args = icp_levels[lvl]
    T, inl, mr, n = ttrk._track_level(*args)
    un = ttrk._track_level_static(*args)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph(keep_graph=True)
    n0 = kernels.ICP_GN.launches
    with graphs.capture(g):
        out = ttrk._track_level_static(*args)
    nodes = graphs.node_counts(g)
    g.instantiate()
    assert nodes["conditional"] == 0 and kernels.ICP_GN.launches - n0 == 1
    for _ in range(2):
        g.replay()
        torch.cuda.synchronize()
        assert 1 < int(out[3]) == n == int(un[3]) < args[5]
        for a_, b_, c_ in zip(out[:3], (T, inl, mr), un[:3]):
            assert torch.equal(a_, b_) and torch.equal(a_, c_)


def _capacity_key(kernel):
    """`icp_gn._CAPACITY`'s key of `kernel` on the current card, its
    capacity queried first (a test then overrides it)."""
    from gps_slam_torch.slam import icp_gn

    icp_gn.capacity(kernel)
    return kernel.name, torch.cuda.current_device()


@pytest.fixture(scope="module")
def color_points_1080p(cuda_device):
    """The colour tracker's points at 1920x1080 (stride 4: 129,600 points,
    a logical grid of 254 CTAs where the card holds 132 of the colour
    kernel resident) from frame 0, frame 1's rgb pyramid and Sobel
    gradients at levels 0 and 3, and frame 0's w2c under a small twist:
    `color_levels` at the size chip_smoke.py fuses at."""
    from gps_slam_torch.slam import tracker as ttrk
    from gps_slam_torch.utils import se3 as tse3

    dev = cuda_device
    a, b = synthetic.make_cameras(n_frames=2, width=1920, height=1080, look="in",
                                  arc=0.025 / 8)
    vm = tse3.compute_vertex_map(torch.as_tensor(a.depth[..., 0], device=dev),
                                 a.fx, a.fy, a.cx, a.cy)
    c2w = torch.as_tensor(a.c2w, device=dev)
    vw = torch.where(vm[..., 2:3] > 0, vm @ c2w[:3, :3].T + c2w[:3, 3], 0.0)
    pts = vw[::4, ::4].reshape(-1, 3).contiguous()
    col = torch.as_tensor(a.image, device=dev)[::4, ::4].reshape(-1, 3).contiguous()
    valid = pts.abs().sum(-1) > 0
    twist = torch.tensor([0.004, -0.003, 0.006, 0.004, -0.006, 0.003], device=dev)
    M0 = (tse3.se3_exp(twist) @ pose_inv(c2w)).contiguous()
    img = torch.as_tensor(b.image, device=dev)
    levels = {}
    for lvl in range(4):
        if lvl in (0, 3):
            gx, gy = ttrk._gradients(img)
            cam = torch.as_tensor(ttrk._level_cam(a.K, lvl, False), device=dev)
            levels[lvl] = (M0, pts, col, valid, img.contiguous(), gx.contiguous(),
                           gy.contiguous(), cam)
        img = ttrk._downsample_rgb(img)
    return levels


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["icp", "color"])
def test_gn_level_runs_more_ctas_than_the_card_holds(icp_levels, color_points_1080p, which,
                                                      monkeypatch):
    """A logical grid larger than the CTAs the card holds resident: each
    resident CTA takes the logical CTAs b, b + grid, ... in turn, and the
    level matches its plain level loop bit for bit at the three exits
    (`GN_EXITS`), with the last pass's per-CTA rows of the whole logical
    grid.  Colour: the 1920x1080 point set (254 logical CTAs, 132
    resident); ICP: the 1200x680 step's 4 levels (228, 200, 100 and 25
    logical CTAs) with the card's capacity taken as 64."""
    from gps_slam_torch import kernels
    from gps_slam_torch.slam import color_gn, icp_gn
    from gps_slam_torch.slam import tracker as ttrk

    if which == "icp":
        monkeypatch.setitem(icp_gn._CAPACITY, _capacity_key(kernels.ICP_GN), 64)
        for lvl in range(4):
            T0, d, vw, nw, cam, _, rot, rpi, st, tc = icp_levels[lvl]
            pts, has_depth = icp_gn.level_points(d, cam)
            fresh = torch.cat([T0.reshape(-1), T0.reshape(-1),
                               torch.eye(6, device=d.device).reshape(-1),
                               torch.zeros(6, device=d.device),
                               torch.tensor([float("inf"), 1e-3, 0.0, 0.0, 0.0],
                                            device=d.device)])
            for exit_, n_iters, budget in GN_EXITS:
                inputs = (d, vw, nw, cam, rpi, st, tc, rot, n_iters, ttrk._STEP_EXIT)
                # a buffer of its own: its barrier count is kept at multiples of 64
                runs, before = _level_runs(
                    icp_gn.iterate, icp_gn.iterate_plain, inputs, fresh,
                    torch.zeros((), dtype=torch.int64, device=d.device),
                    torch.zeros((), dtype=torch.bool, device=d.device),
                    icp_gn.partials_buffer(d.numel(), d.device), True, budget)
                x = icp_gn.terms(before[:16].view(4, 4), pts, has_depth, vw, nw, cam, rpi,
                                 st, tc, rot)
                rows = icp_gn.cta_rows(x)
                assert icp_gn.grid(kernels.ICP_GN, rows.shape[0]) == min(rows.shape[0], 64)
                _assert_level_runs(runs, rows, kernels.ICP_GN, icp_gn.N_TERMS, (lvl, exit_))
                assert int(runs[0][1]) > (1 if exit_ != "budget" else 0), (lvl, exit_)
    else:
        for lvl, (M0, pts, col, valid, rgb, gx, gy, cam) in color_points_1080p.items():
            n = pts.shape[0]
            assert icp_gn.n_ctas(n) > icp_gn.capacity(kernels.COLOR_GN)
            for exit_, n_iters, budget in GN_EXITS:
                inputs = (pts, col, valid, rgb, gx, gy, cam, False, n_iters, ttrk._STEP_EXIT)
                runs, before = _color_runs(inputs, _color_state(M0), True, budget)
                rows = icp_gn.cta_rows(color_gn.terms(before[:16].view(4, 4), *inputs[:7],
                                                      False))
                _assert_level_runs(runs, rows, kernels.COLOR_GN, color_gn.N_TERMS,
                                   (lvl, exit_))
                assert int(runs[0][1]) > (1 if exit_ != "budget" else 0), (lvl, exit_)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["icp", "color"])
def test_gn_level_grid_beyond_the_card_raises(icp_levels, color_points_1080p, which,
                                              monkeypatch):
    """A level kernel's grid barrier is sound only with every CTA resident:
    a launch whose grid is larger than the card holds at once (the card's
    capacity taken as the whole logical grid: ICP's finest level with the
    grid's cap doubled, 399 CTAs; colour's 1920x1080 point set, 254) is
    refused by the CUDA runtime and raises."""
    from gps_slam_torch import kernels
    from gps_slam_torch.slam import color_gn, icp_gn
    from gps_slam_torch.slam import tracker as ttrk

    if which == "icp":
        k = kernels.ICP_GN
        T0, d, vw, nw, cam, n_iters, rot, rpi, st, tc = icp_levels[0]
        monkeypatch.setattr(icp_gn, "MAX_CTAS", 2 * icp_gn.MAX_CTAS)
        n = d.numel()
    else:
        k = kernels.COLOR_GN
        M0, pts, col, valid, rgb, gx, gy, cam = color_points_1080p[0]
        n = pts.shape[0]
    held = icp_gn.capacity(k)
    assert icp_gn.n_ctas(n) > held
    monkeypatch.setitem(icp_gn._CAPACITY, _capacity_key(k), icp_gn.n_ctas(n))
    dev = cam.device
    n_run = torch.zeros((), dtype=torch.int64, device=dev)
    more = torch.zeros((), dtype=torch.bool, device=dev)
    with pytest.raises(RuntimeError, match="launch failed"):
        if which == "icp":
            state = torch.cat([T0.reshape(-1), T0.reshape(-1),
                               torch.eye(6, device=dev).reshape(-1), torch.zeros(6, device=dev),
                               torch.tensor([float("inf"), 1e-3, 0.0, 0.0, 0.0], device=dev)])
            icp_gn.iterate(d, vw, nw, cam, rpi, st, tc, rot, n_iters, ttrk._STEP_EXIT, state,
                           n_run, more, icp_gn.partials_buffer(n, dev), first=True,
                           budget=n_iters)
        else:
            color_gn.iterate(pts, col, valid, rgb, gx, gy, cam, False, 20, ttrk._STEP_EXIT,
                             _color_state(M0), n_run, more, color_gn.partials_buffer(n, dev),
                             first=True, budget=20)
    torch.cuda.synchronize()
    assert int(n_run) == 0


# ---------------------------------- color_gn_cuda, the colour tracker's iteration

@pytest.fixture(scope="module")
def color_levels(cuda_device):
    """The 4 pyramid levels of one colour-tracking step at 1200x680 on the
    card (tests/test_tracking.py's colour setup at the tracked path's
    size): frame 0's world points and colours at the tracker's stride 4
    (51,000 points), frame 1's rgb pyramid and Sobel gradients, and frame
    0's w2c under a small twist; each level's `_track_level_color`
    arguments but the budget and the rotation mode."""
    from gps_slam_torch.slam import tracker as ttrk
    from gps_slam_torch.utils import se3 as tse3

    dev = cuda_device
    a, b = synthetic.make_cameras(n_frames=2, width=1200, height=680, look="in",
                                  arc=0.025 / 8)
    vm = tse3.compute_vertex_map(torch.as_tensor(a.depth[..., 0], device=dev),
                                 a.fx, a.fy, a.cx, a.cy)
    c2w = torch.as_tensor(a.c2w, device=dev)
    vw = torch.where(vm[..., 2:3] > 0, vm @ c2w[:3, :3].T + c2w[:3, 3], 0.0)
    pts = vw[::4, ::4].reshape(-1, 3).contiguous()
    col = torch.as_tensor(a.image, device=dev)[::4, ::4].reshape(-1, 3).contiguous()
    valid = pts.abs().sum(-1) > 0
    twist = torch.tensor([0.004, -0.003, 0.006, 0.004, -0.006, 0.003], device=dev)
    M0 = (tse3.se3_exp(twist) @ pose_inv(c2w)).contiguous()
    img = torch.as_tensor(b.image, device=dev)
    levels = []
    for lvl in range(4):
        gx, gy = ttrk._gradients(img)
        cam = torch.as_tensor(ttrk._level_cam(a.K, lvl, False), device=dev)
        levels.append((M0, pts, col, valid, img.contiguous(), gx.contiguous(),
                       gy.contiguous(), cam))
        img = ttrk._downsample_rgb(img)
    return levels


def _color_state(M0, M_acc=None, err_acc=float("inf")):
    M_acc = M0 if M_acc is None else M_acc
    return torch.cat([M0.reshape(-1), M_acc.reshape(-1),
                      torch.tensor([err_acc, 1e-3, 0.0, 0.0, 0.0], device=M0.device)])


def _color_runs(inputs, state, first, budget=1):
    """color_gn_cuda twice and its plain level loop once from the same
    state (`_level_runs`): [(state, n_run, more, partials)] and the state
    the plain loop's last pass started from."""
    from gps_slam_torch.slam import color_gn

    dev = state.device
    return _level_runs(color_gn.iterate, color_gn.iterate_plain, inputs, state,
                       torch.zeros((), dtype=torch.int64, device=dev),
                       torch.zeros((), dtype=torch.bool, device=dev),
                       color_gn.partials_buffer(inputs[0].shape[0], dev), first, budget)


def _same(a, b) -> bool:
    """Equal values, a NaN equal to a NaN (their payload bits aside)."""
    if not a.is_floating_point():
        return torch.equal(a, b)
    return a.shape == b.shape and bool(((a == b) | (a.isnan() & b.isnan())).all())


def _assert_color_runs_equal(runs, rows, case):
    """`_assert_level_runs` of one pass."""
    from gps_slam_torch import kernels
    from gps_slam_torch.slam import color_gn

    _assert_level_runs(runs, rows, kernels.COLOR_GN, color_gn.N_TERMS, case)
    assert int(runs[0][1]) == 1, case


@pytest.mark.cuda
@pytest.mark.parametrize("lvl", [0, 1, 2, 3])
def test_color_gn_cuda_matches_plain(color_levels, lvl):
    """`color_gn_cuda`, a level's loop in one launch, against its plain
    level loop (`run_plain`) on the card at each level of a 1200x680
    colour-tracking step, in both rotation modes: one pass (budget 1) from
    the start
    (`first`), from the state it left, and as a reject (the accepted error
    set below any error: the new system damped from the accepted estimate
    at 10x damping); then the whole level from its start at the three
    exits (`GN_EXITS`).  The state (M, M_acc, err, lam, step, inlier share,
    residual), the iteration count and the loop's test bit for bit; the
    last pass's per-CTA rows bit for bit with `cta_rows` of the plain
    terms at the state that pass started from; a second launch the same
    bits."""
    from gps_slam_torch import kernels
    from gps_slam_torch.slam import color_gn, icp_gn
    from gps_slam_torch.slam import tracker as ttrk

    M0, pts, col, valid, rgb, gx, gy, cam = color_levels[lvl]
    n0 = kernels.COLOR_GN.launches
    launches = 0
    for rot in (False, True):
        inputs = (pts, col, valid, rgb, gx, gy, cam, rot, 20, ttrk._STEP_EXIT)
        state = _color_state(M0)
        for case in ("first", "next", "reject"):
            first = case == "first"
            if case == "reject":
                state = state.clone()
                state[32] = 0.0
            M = state[:16].view(4, 4)
            rows = icp_gn.cta_rows(color_gn.terms(M, *inputs[:7], rot))
            runs, _ = _color_runs(inputs, state, first)
            launches += 2
            _assert_color_runs_equal(runs, rows, (rot, case))
            new = runs[0][0]
            if case == "reject":
                assert torch.equal(new[16:32], state[16:32]) and float(new[32]) == 0.0
                assert float(new[33]) > float(state[33])
            assert float(new[35]) > 0.5 and float(new[34]) > 0.0, (rot, case)
            state = new
        for exit_, n_iters, budget in GN_EXITS:
            inputs = (pts, col, valid, rgb, gx, gy, cam, rot, n_iters, ttrk._STEP_EXIT)
            runs, before = _color_runs(inputs, _color_state(M0), True, budget)
            launches += 2
            case = (rot, exit_)
            rows = icp_gn.cta_rows(color_gn.terms(before[:16].view(4, 4), *inputs[:7], rot))
            _assert_level_runs(runs, rows, kernels.COLOR_GN, color_gn.N_TERMS, case)
            ran, more = int(runs[0][1]), bool(runs[0][2])
            if exit_ == "converged":
                assert 1 < ran < n_iters and not more, case
            elif exit_ == "n_iters":
                assert ran == n_iters and not more, case
            else:
                assert ran == 1 and more, case
    assert kernels.COLOR_GN.launches - n0 == launches
    with pytest.raises(ValueError):   # an f64 state
        color_gn.iterate(*inputs, state.double(), torch.zeros((), dtype=torch.int64,
                                                             device=state.device),
                         torch.zeros((), dtype=torch.bool, device=state.device),
                         color_gn.partials_buffer(pts.shape[0], state.device))


@pytest.mark.cuda
def test_color_gn_cuda_zero_steps(color_levels):
    """The step's guards on the card, bit for bit with the plain version
    (a NaN equal to a NaN): a NaN point (its terms NaN, and so the system
    and the error: a non-finite solution) and no valid point (no inliers:
    the error is inf) both give a zero step, M = M_acc."""
    from gps_slam_torch.slam import color_gn, icp_gn
    from gps_slam_torch.slam import tracker as ttrk

    M0, pts, col, valid, rgb, gx, gy, cam = color_levels[0]
    nan_pts = pts.clone()
    nan_pts[7, 1] = float("nan")
    for case, p_, v_ in (("nan", nan_pts, valid), ("none valid", pts, torch.zeros_like(valid))):
        inputs = (p_, col, v_, rgb, gx, gy, cam, False, 20, ttrk._STEP_EXIT)
        state = _color_state(M0)
        rows = icp_gn.cta_rows(color_gn.terms(state[:16].view(4, 4), *inputs[:7], False))
        runs, _ = _color_runs(inputs, state, True)
        _assert_color_runs_equal(runs, rows, case)
        new = runs[0][0]
        assert torch.equal(new[:16], state[16:32]) and float(new[34]) == 0.0, case
        assert not bool(runs[0][2]), case


# ------------------------------- the Adam step's per-Gaussian kernels


def _bits_equal(a, b) -> bool:
    """The same shape, dtype and bits (a NaN equal to a NaN of its bits)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def _gauss_inputs(n: int, degree: int, device, seed: int, kind: str = "random",
                  n_rest: int | None = None, offset: bool = False):
    """n Gaussians around a 1200x680 camera (some behind it, some far to
    the side, 10% dead), random SH of `degree`, and random cotangents of
    every output of `project_sh_fwd`.  `kind` "sparse": ~4% of the rows
    visible, the main path's share (the others behind the camera);
    "culled": every row behind the camera; "visible": every row alive and
    in front, inside the frame.  `n_rest`: features_rest's coefficients
    (default: the degree's).  `offset`: every array a view one row into
    its storage, so that no base is 16-byte aligned but quats'."""
    from gps_slam_torch.gs import model as tmodel

    rng = np.random.default_rng(seed)
    m = n + 1 if offset else n
    a = 0.2
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
    c2w[:3, 3] = [0.2, -0.1, -0.4]
    z = rng.uniform(-0.5, 5.0, m)
    lat = rng.uniform(-1.0, 1.0, (m, 2)) * np.maximum(z, 0.2)[:, None]
    lat[: m // 8] *= 4.0
    if kind == "sparse":
        z = np.where(rng.random(m) < 0.06, np.abs(z) + 0.5, -np.abs(z) - 0.1)
    elif kind == "culled":
        z = -np.abs(z) - 0.1
    elif kind == "visible":
        z = rng.uniform(1.0, 4.0, m)
        lat = rng.uniform(-0.5, 0.5, (m, 2)) * z[:, None]
    means = np.concatenate([lat, z[:, None]], 1) @ c2w[:3, :3].T + c2w[:3, 3]
    nb = (degree + 1) ** 2
    f = lambda x: torch.as_tensor(np.ascontiguousarray(x, np.float32), device=device)  # noqa: E731
    p = {"means": f(means), "quats": f(rng.normal(size=(m, 4))),
         "scales": f(rng.uniform(-6.0, -0.5, (m, 3))),
         "features_dc": f(rng.normal(0, 0.5, (m, 3))),
         "features_rest": f(rng.normal(0, 0.3, (m, nb - 1 if n_rest is None else n_rest, 3)))}
    alive = torch.as_tensor(rng.random(m) > 0.1, device=device)
    if kind == "visible":
        alive = torch.ones_like(alive)
    cot = [f(rng.normal(size=s)) for s in ((m, 2), (m, 3), (m,), (m, 3))]
    if offset:
        p = {k: v[1:] for k, v in p.items()}
        alive, cot = alive[1:], [v[1:] for v in cot]
    K = np.array([[600.0, 0, 599.5], [0, 600.0, 339.5], [0, 0, 1]], np.float32)
    st = tmodel.RenderStatics(width=1200, height=680, sh_degree=degree, tile_size=16,
                              max_gs_radii=64, delta_depth=0.1, use_exposure=False,
                              visible_cap=n, tiles_per_gaussian_cap=9, tile_cap=64)
    return p, alive, f(c2w), K, st, cot


# the tiles of csrc/gauss_step.cu: FWD_ROWS rows a CTA of the forward,
# BWD_ROWS of the backward
_FWD_ROWS, _BWD_ROWS = 64, 32
# (rows, SH degree, inputs, features_rest coefficients, offset views)
_PROJECT_SH_CASES = [
    pytest.param(131072, 3, "random", None, False, id="131072-3"),
    *(pytest.param(5003, d, "random", None, False, id=f"5003-{d}") for d in range(5)),
    *(pytest.param(n, 3, "random", None, False, id=f"{n}-3")
      for n in (1, _BWD_ROWS - 1, _BWD_ROWS, _BWD_ROWS + 1, _FWD_ROWS - 1, _FWD_ROWS,
                _FWD_ROWS + 1)),
    pytest.param(32768, 3, "sparse", None, False, id="32768-3-sparse"),
    pytest.param(5003, 3, "culled", None, False, id="5003-3-culled"),
    pytest.param(5003, 4, "visible", None, False, id="5003-4-visible"),
    pytest.param(5003, 2, "random", 15, False, id="5003-2-rest15"),
    pytest.param(1003, 0, "random", 8, False, id="1003-0-rest8"),
    pytest.param(4099, 3, "random", None, True, id="4099-3-offset"),
    pytest.param(97, 4, "visible", 30, True, id="97-4-visible-rest30-offset"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("n,degree,kind,n_rest,offset", _PROJECT_SH_CASES)
def test_project_sh_kernels_match_plain(cuda_device, n, degree, kind, n_rest, offset):
    """project_sh_fwd_cuda and project_sh_bwd_cuda against their plain
    versions on the card, bit for bit: at 131,072 random rows and at a
    ragged 5,003 at every SH degree; at 1 row and one row either side of
    each kernel's tile; at 32,768 rows with the main path's ~4% visible;
    with every row culled and every row visible; with features_rest wider
    than the degree needs (its grads zero past the degree); with inputs
    whose bases are not 16-byte aligned.  Each with and without the SH
    ramp's active degree (one below `degree`), with every cotangent and
    with the projection's, the colours' or all cotangents missing (None:
    zero).  A second launch of either kernel gives the same bits."""
    from gps_slam_torch import kernels
    from gps_slam_torch.gs import gauss_step as gs
    from gps_slam_torch.gs import projection as tproj

    p, alive, c2w, K, st, cot = _gauss_inputs(n, degree, cuda_device, 40 + degree, kind,
                                              n_rest, offset)
    if offset:
        assert p["means"].data_ptr() % 16 and p["features_rest"].data_ptr() % 16
    cam = tproj.camera(K, st.width, st.height)
    viewmat = pose_inv(c2w)
    args = (p["means"], p["quats"], p["scales"], p["features_dc"], p["features_rest"])
    for active in (None, torch.tensor(max(degree - 1, 0), dtype=torch.int32,
                                      device=cuda_device)):
        n0 = (kernels.PROJECT_SH_FWD.launches, kernels.PROJECT_SH_BWD.launches)
        k_out = gs.project_sh_fwd(*args, alive, viewmat, c2w, active, cam, st)
        again = gs.project_sh_fwd(*args, alive, viewmat, c2w, active, cam, st)
        p_out = gs.project_sh_fwd_plain(*args, alive, viewmat, c2w, active, cam, st)
        torch.cuda.synchronize()
        for i, (a, b, c) in enumerate(zip(k_out, again, p_out)):
            assert _bits_equal(a, c) and _bits_equal(a, b), (active, i)
        radii = k_out[3]
        vis = int((radii > 0).sum())
        if kind == "culled":
            assert vis == 0
        elif kind == "visible":
            assert vis == n
        elif kind == "sparse":
            assert 0.02 * n < vis < 0.06 * n, vis
        elif n > 64:
            assert 0 < vis < n
        drops = ((), (0, 1, 2), (3,), (0, 1, 2, 3))
        for drop in drops:
            vs = [None if i in drop else v for i, v in enumerate(cot)]
            k_g = gs.project_sh_bwd(*args, radii, viewmat, c2w, active, cam, st, *vs)
            k_again = gs.project_sh_bwd(*args, radii, viewmat, c2w, active, cam, st, *vs)
            p_g = gs.project_sh_bwd_plain(*args, radii, viewmat, c2w, active, cam, st, *vs)
            torch.cuda.synchronize()
            for i, (a, b, c) in enumerate(zip(k_g, k_again, p_g)):
                assert _bits_equal(a, c) and _bits_equal(a, b), (active, drop, i)
                assert bool(torch.isfinite(a).all()), (active, drop, i)
            if n_rest is not None and n_rest > (degree + 1) ** 2 - 1:
                assert not bool(k_g[4][:, (degree + 1) ** 2 - 1:].any()), (active, drop)
        assert (kernels.PROJECT_SH_FWD.launches - n0[0],
                kernels.PROJECT_SH_BWD.launches - n0[1]) == (2, 2 * len(drops))


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [131072, 5003])
def test_window_adam_cuda_matches_plain(cuda_device, rows):
    """window_adam_cuda against `WindowAdam._step_plain` on the card over
    20 steps of a 7-attribute pool (SH degree 3, two exposure cameras
    learning), the grads of some attributes missing at some steps: params
    and both moments bit for bit after every step; one launch a step."""
    from types import SimpleNamespace

    from gps_slam_torch import kernels
    from gps_slam_torch.gs import optim as toptim

    rng = np.random.default_rng(rows)
    shapes = {"means": (rows, 3), "scales": (rows, 3), "quats": (rows, 4),
              "features_dc": (rows, 3), "features_rest": (rows, 15, 3),
              "opacities": (rows, 1), "exposure": (2, 3, 4)}
    base = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    mcfg = SimpleNamespace(means_lr=1.6e-4, scales_lr=5e-3, quats_lr=1e-3,
                           featuresDc_lr=2.5e-3, featuresRest_lr=1.25e-4,
                           opacities_lr=5e-2, exposure_lr=1e-3, use_exposure=True)
    opts = [toptim.WindowAdam({k: torch.as_tensor(v, device=cuda_device)
                               for k, v in base.items()}, mcfg, 100, steps=20)
            for _ in range(2)]
    n0 = kernels.WINDOW_ADAM.launches
    for step in range(20):
        for k, s in shapes.items():
            g = (None if (step + len(k)) % 5 == 0 else
                 torch.as_tensor(rng.normal(size=s).astype(np.float32), device=cuda_device))
            for o in opts:
                o.params[k].grad = None if g is None else g.clone()
        opts[0].step()
        opts[1]._step_plain()
        opts[1].count += 1
        torch.cuda.synchronize()
        for k in shapes:
            for a, b in ((opts[0].params[k], opts[1].params[k]),
                         (opts[0].mu[k], opts[1].mu[k]), (opts[0].nu[k], opts[1].nu[k])):
                assert _bits_equal(a, b), (step, k)
    assert kernels.WINDOW_ADAM.launches - n0 == 20


@pytest.mark.cuda
def test_megastep_graph_replays_under_sync_debug(cuda_device, fused, tmp_path):
    """A window graph captured, then replayed twice with other inputs under
    torch.cuda.set_sync_debug_mode("error") (a read-back or a pageable
    copy raises), against the same windows run uncaptured under the same
    mode: pools, loss histories and counts bit for bit.  The graph's
    launches per window: project_sh_fwd_cuda 1 + 4 + 6 (the spawn render,
    the 4 cameras' binning, the 6 steps), project_sh_bwd_cuda and
    window_adam_cuda 6 (one each a step)."""
    from gps_slam_torch import kernels
    from gps_slam_torch.slam import megastep as ms

    vol, pool_np, alive, cams, statics = _megastep_window(cuda_device, fused, tmp_path)
    ref = convert.pool_from_numpy(pool_np, alive, cuda_device)
    pool = convert.pool_from_numpy(pool_np, alive, cuda_device)
    graphs = ms.WindowGraphs()
    key = ("sync debug",)
    inputs = [_window_inputs(cams, cuda_device, seed=30 + w) for w in range(3)]
    for w, inp in enumerate(inputs):
        if w == 0:
            want = _uncaptured(vol, ref, inp, statics)
            got = graphs.run(key, vol, pool, inp, **statics)
        else:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                want = _uncaptured(vol, ref, inp, statics)
                got = graphs.run(key, vol, pool, inp, **statics)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        assert graphs.last == (key, "capture" if w == 0 else "replay")
        for k in want:
            assert torch.equal(got[k], want[k]), (w, k)
        for k in (*ROW_KEYS_CUDA, "alive"):
            assert torch.equal(getattr(pool, k), getattr(ref, k)), (w, k)
    (g,) = graphs.graphs.values()
    assert g.launches[kernels.PROJECT_SH_FWD.name] == 1 + 4 + 6
    assert g.launches[kernels.PROJECT_SH_BWD.name] == 6
    assert g.launches[kernels.WINDOW_ADAM.name] == 6
    assert graphs.replayed_launches[kernels.WINDOW_ADAM.name] == 12
