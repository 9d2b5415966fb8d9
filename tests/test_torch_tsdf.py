"""The port's TSDF modules held against the JAX package: hash, fusion with
its integrate kernel (K1), and the raycast march (K3).

Inputs are made with numpy from a seed and handed to both packages; the
JAX side runs on the CPU (its Pallas kernels in interpret mode), the port
on the CPU through each kernel's plain PyTorch version (the CUDA kernels
are held against those plain versions in test_torch_cuda.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gps_slam_tpu.data import synthetic
from gps_slam_tpu.tsdf import hash as jhash
from gps_slam_tpu.tsdf import integrate as jint
from gps_slam_tpu.tsdf import volume as jvol
from gps_slam_torch import convert
from gps_slam_torch.tsdf import hash as thash
from gps_slam_torch.tsdf import integrate as tint
from gps_slam_torch.tsdf import raycast_tiles as trc
from gps_slam_torch.tsdf import volume as tvol


def _params_pair(**kw):
    d = dict(voxel_size=0.02, mu=0.08, hash_size=1 << 16, block_capacity=1 << 13,
             visible_capacity=1 << 12, frustum_min=0.2, frustum_max=10.0)
    d.update(kw)
    return jvol.TsdfParams(raycast_steps=64, **d), tvol.TsdfParams(**d)


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint32)


def _jax_arrays(vol) -> dict:
    """The in-memory fields of a JAX TsdfVolume as numpy."""
    return {k: np.asarray(getattr(vol, k)) for k in
            ("table_keys", "table_ptrs", "block_coords", "state", "color",
             "summary", "n_blocks", "last_seen")}


def _by_key(block_coords, n, *planes):
    """{packed key: (row of each plane)} over the allocated prefix."""
    keys = np.asarray(block_coords)[:n]
    return {int(k): tuple(np.asarray(p)[i] for p in planes)
            for i, k in enumerate(keys)}


# ---------------------------------------------------------------- hash

@pytest.mark.parametrize("P", [8, 4])
def test_hash_insert_lookup_key_for_key(P):
    """insert + lookup agree with the JAX hash key for key: the same keys
    land in the same buckets, get the same pool rows (claim order) and
    the same lookups hit and miss.  Exact: integer ops."""
    rng = np.random.default_rng(7)
    H, B = 1 << 12, 1 << 10
    coords = np.unique(rng.integers(-100, 100, size=(600, 3)).astype(np.int32), axis=0)
    stream = np.concatenate([coords, coords[::2], coords[::3]])
    jp = jhash.pack(*[jnp.asarray(stream[:, k]) for k in range(3)])
    tp = thash.pack(*[torch.as_tensor(stream[:, k]) for k in range(3)])
    np.testing.assert_array_equal(np.asarray(jp), _u32(tp))
    np.testing.assert_array_equal(
        np.asarray(jhash.hash_packed(jp, H)), thash.hash_packed(tp, H).numpy())
    jc = jhash.dedup_candidates(jp, 2 * len(coords))
    tc = thash.dedup_candidates(tp, 2 * len(coords))
    np.testing.assert_array_equal(np.asarray(jc), _u32(tc))

    W = max(P, 128)
    jk = jnp.full((H // W, W), jhash.EMPTY, dtype=jnp.uint32)
    jptr = jnp.full((H // W, W), -1, dtype=jnp.int32)
    jbc = jnp.full((B,), jhash.EMPTY, dtype=jnp.uint32)
    jk, jptr, jnb, jbc, jret = jhash.insert(jk, jptr, jnp.zeros((), jnp.int32), jbc,
                                            jc, P, B, claim_rounds=2, return_ptrs=True)
    tk = torch.full((H // W, W), thash.EMPTY, dtype=torch.int32)
    tptr = torch.full((H // W, W), -1, dtype=torch.int32)
    tbc = torch.full((B,), thash.EMPTY, dtype=torch.int32)
    tnb, tret = thash.insert(tk, tptr, 0, tbc, tc, P, B, claim_rounds=2)
    assert tnb == int(jnb)
    np.testing.assert_array_equal(np.asarray(jret), tret.numpy())
    np.testing.assert_array_equal(np.asarray(jk), _u32(tk))
    np.testing.assert_array_equal(np.asarray(jptr), tptr.numpy())
    np.testing.assert_array_equal(np.asarray(jbc), _u32(tbc))
    other = np.concatenate([coords[:50], np.full((5, 3), 400, np.int32)])
    jq = jhash.lookup(jk, jptr, jhash.pack(*[jnp.asarray(other[:, k]) for k in range(3)]), P)
    tq = thash.lookup(tk, tptr, thash.pack(*[torch.as_tensor(other[:, k]) for k in range(3)]), P)
    np.testing.assert_array_equal(np.asarray(jq), tq.numpy())
    assert (tq.numpy()[-5:] == -1).all()


# ---------------------------------------------------------------- K1

def test_integrate_plain_matches_pallas_interpret():
    """K1's plain version against integrate_blocks_packed(interpret=True)
    on valid rows (inputs of test_tsdf.py's integrate test).  Weights are
    exact.  sdf within 20 i16 quanta (6e-4): the TPU kernel reads depth as
    a bf16 hi+lo pair, |dd| <= d * 2^-17 ~ 10 um at the scene's 1.3 m,
    which moves eta/mu = dd/2cm by <= 5e-4, where the port reads f32.
    Colour within 1 of 255.  The mip within 2e-3: the TPU mip is a bf16
    matmul over sdf values in [-1, 1] (rounding <= 2^-9), the port's an f32
    mean."""
    import gps_slam_tpu.tsdf.integrate_pallas as ipk

    rng = np.random.default_rng(0)
    W, H = 96, 72
    depth_np = np.abs(rng.normal(1.0, 0.1, (H, W))).astype(np.float32)
    rgbp_np = rng.integers(0, 2 ** 24, (H, W), dtype=np.uint32)
    vox, mu, maxw = 0.01, 0.02, 100
    bxyz = np.stack(np.meshgrid(np.arange(-3, 3), np.arange(-2, 2),
                                np.arange(10, 14), indexing="ij"),
                    -1).reshape(-1, 3).astype(np.int32)
    keys = jhash.pack(jnp.asarray(bxyz[:, 0]), jnp.asarray(bxyz[:, 1]),
                      jnp.asarray(bxyz[:, 2]))
    V = keys.shape[0]
    valid = rng.random(V) > 0.1
    old_sdf = rng.uniform(-1, 1, (V, 512)).astype(np.float32)
    old_w = rng.integers(0, 50, (V, 512)).astype(np.uint32)
    old_wc = rng.integers(0, 50, (V, 512)).astype(np.uint32)
    old_cp = rng.integers(0, 2 ** 24, (V, 512), dtype=np.uint32)
    q = np.round(np.clip(old_sdf, -1, 1) * 32767).astype(np.int32) & 0xFFFF
    old_packed = (q.astype(np.uint32) | (old_w << 16) | (old_wc << 24))
    fx = fy = 80.0
    cx, cy = W / 2, H / 2
    j_state, j_col, j_sum = ipk.integrate_blocks_packed(
        jnp.asarray(depth_np), jnp.asarray(rgbp_np), keys, jnp.asarray(valid),
        jnp.asarray(old_packed), jnp.asarray(old_cp), jnp.eye(4),
        fx, fy, cx, cy, W, H, vox, mu, maxw, interpret=True)

    state = torch.as_tensor(old_packed.view(np.int32).copy())
    color = torch.as_tensor(old_cp.view(np.int32).copy())
    summary = tvol.init_summary(V)
    ptrs = torch.where(torch.as_tensor(valid), torch.arange(V, dtype=torch.int32), -1)
    tint.integrate_blocks_packed(
        torch.as_tensor(depth_np), torch.as_tensor(rgbp_np.view(np.int32)),
        torch.as_tensor(np.asarray(keys).view(np.int32)), ptrs, state, color,
        summary, torch.eye(4), fx, fy, cx, cy, vox, mu, maxw)

    vm = valid
    js, ts = np.asarray(j_state)[vm], _u32(state)[vm]
    np.testing.assert_array_equal((js >> 16) & 0xFF, (ts >> 16) & 0xFF)
    np.testing.assert_array_equal(js >> 24, ts >> 24)
    sdf_j = (js & 0xFFFF).astype(np.int32)
    sdf_t = (ts & 0xFFFF).astype(np.int32)
    sdf_j = np.where(sdf_j >= 32768, sdf_j - 65536, sdf_j)
    sdf_t = np.where(sdf_t >= 32768, sdf_t - 65536, sdf_t)
    assert np.abs(sdf_j - sdf_t).max() <= 20
    jc, tc = np.asarray(j_col)[vm], _u32(color)[vm]
    for ch in range(3):
        d = np.abs(((jc >> (8 * ch)) & 0xFF).astype(int) - ((tc >> (8 * ch)) & 0xFF).astype(int))
        assert d.max() <= 1
    np.testing.assert_allclose(np.asarray(j_sum)[vm, :64], summary.numpy()[vm, :64], atol=2e-3)
    np.testing.assert_allclose(np.asarray(j_sum)[vm, 64], summary.numpy()[vm, 64], atol=2e-4)
    np.testing.assert_array_equal(np.asarray(j_sum)[vm, 65], summary.numpy()[vm, 65])
    # the scene really exercises updates
    assert (((ts >> 16) & 0xFF) != (old_packed[vm] >> 16) & 0xFF).mean() > 0.3


@pytest.fixture(scope="module")
def fused_pair():
    """8 synthetic frames fused by both packages (JAX XLA fusion, the port's
    plain K1) from the same inputs."""
    cams = synthetic.make_cameras(n_frames=8, width=128, height=96)
    jp, tp = _params_pair()
    jv = jvol.create(jp)
    tv = tvol.create(tp, "cpu")
    for cam in cams:
        jv = jint.fuse_frame(jv, jnp.asarray(cam.depth[..., 0]), jnp.asarray(cam.image),
                             jnp.asarray(cam.c2w), jnp.asarray(cam.K))
        tint.fuse_frame(tv, torch.as_tensor(cam.depth[..., 0]),
                        torch.as_tensor(cam.image), torch.as_tensor(cam.c2w), cam.K)
    return jv, tv, cams, tp


def test_fusion_matches_jax_by_block_key(fused_pair):
    """After 8 frames both packages hold the same blocks.  Compared by
    block key (pool rows follow claim order).  The JAX CPU fusion anchors
    each block's window at the min projection of its 512 voxels, the port
    (like the TPU kernel) at its 8 corners; voxels near a window edge can
    differ, so weights agree on >= 99.5% of voxels and sdf within 2e-3 on
    >= 99% of the voxels both integrated."""
    jv, tv, _, _ = fused_pair
    n = int(jv.n_blocks)
    assert tv.n_blocks == n
    jmap = _by_key(jv.block_coords, n, jv.state, jv.color)
    tmap = _by_key(_u32(tv.block_coords), n, _u32(tv.state), _u32(tv.color))
    assert set(jmap) == set(tmap)
    ks = sorted(jmap)
    js = np.stack([jmap[k][0] for k in ks])
    ts = np.stack([tmap[k][0] for k in ks])
    jw, tw = (js >> 16) & 0xFF, (ts >> 16) & 0xFF
    assert np.mean(jw == tw) >= 0.995
    both = (jw > 0) & (tw > 0)
    fj = np.asarray(jvol.state_sdf_f32(jnp.asarray(js)))
    ft = np.asarray(jvol.state_sdf_f32(jnp.asarray(ts)))
    assert np.mean(np.abs(fj - ft)[both] < 2e-3) >= 0.99


@pytest.mark.parametrize("width,height", [(48, 40), (96, 40)])
def test_narrow_frame_fusion_matches_jax_by_block_key(width, height):
    """Frames narrower or shorter than 64 px (both sides, then the height
    only): 6 synthetic frames through the JAX package's XLA branch
    (nearest depth, bilinear colour, no window) and the port's torch
    branch, compared by block key.  The JAX branch projects by a matmul
    and inverts the pose its own way, the port sums both term by term (so
    that card and CPU round alike), so a voxel on a rounding tie (a half
    pixel, the 1 px rim, |eta / mu| = 0.25) may go the other way in one
    frame.  Measured: the same key sets; weights differ on 1 of 926,208
    voxels (48x40) and 2 of 515,072 (96x40), sdf by more than 1 quantum
    on 2 and 1, colour words on 9 and 19.  Required: the same key set,
    weights equal and sdf within 1 quantum on >= 99.999% of the voxels,
    colour channels within 1 on >= 99.99%."""
    cams = synthetic.make_cameras(n_frames=6, width=width, height=height)
    jp, tp = _params_pair()
    jv = jvol.create(jp)
    tv = tvol.create(tp, "cpu")
    for cam in cams:
        jv = jint.fuse_frame(jv, jnp.asarray(cam.depth[..., 0]), jnp.asarray(cam.image),
                             jnp.asarray(cam.c2w), jnp.asarray(cam.K))
        tint.fuse_frame(tv, torch.as_tensor(cam.depth[..., 0]),
                        torch.as_tensor(cam.image), torch.as_tensor(cam.c2w), cam.K)
    n = int(jv.n_blocks)
    assert tv.n_blocks == n
    jmap = _by_key(jv.block_coords, n, jv.state, jv.color)
    tmap = _by_key(_u32(tv.block_coords), n, _u32(tv.state), _u32(tv.color))
    assert set(jmap) == set(tmap)
    ks = sorted(jmap)
    js, jc = (np.stack([jmap[k][i] for k in ks]) for i in (0, 1))
    ts, tc = (np.stack([tmap[k][i] for k in ks]) for i in (0, 1))
    assert ((ts >> 16) & 0xFF).astype(bool).mean() > 0.3  # the frames integrate
    assert np.mean((js >> 16) == (ts >> 16)) >= 0.99999
    sdf = lambda w: ((w & 0xFFFF).astype(np.int64) ^ 0x8000) - 0x8000  # noqa: E731
    assert np.mean(np.abs(sdf(js) - sdf(ts)) <= 1) >= 0.99999
    for sh in (0, 8, 16):
        d = np.abs(((jc >> sh) & 0xFF).astype(int) - ((tc >> sh) & 0xFF).astype(int))
        assert np.mean(d <= 1) >= 0.9999


# ---------------------------------------------------------------- K3

def _jax_fused_volume():
    cams = synthetic.make_cameras(n_frames=8, width=128, height=96)
    jp, tp = _params_pair()
    jv = jvol.create(jp)
    for cam in cams:
        jv = jint.fuse_frame(jv, jnp.asarray(cam.depth[..., 0]), jnp.asarray(cam.image),
                             jnp.asarray(cam.c2w), jnp.asarray(cam.K))
    return jv, convert.volume_from_numpy(_jax_arrays(jv), tp, "cpu"), cams


@pytest.mark.parametrize("lb,s_refine,k_blocks", [
    pytest.param(24, 8, 1, id="1"), pytest.param(24, 8, 2, id="2"),
    # the main path's window raycast (engine.run_raycast_batch at the
    # smoke's bench config: LB 16, s_coarse 4, s_refine 6, k_blocks 1)
    pytest.param(16, 6, 1, id="window")])
def test_raycast_plain_matches_pallas_interpret(lb, s_refine, k_blocks):
    """K3's plain version against raycast_pallas.raycast(interpret=True) on
    the same fused volume (carried across with volume_from_numpy).  The
    TPU kernel reads sdf and mip as bf16, the port as f32, so: hit masks
    differ on < 1% of pixels, depth within one voxel on >= 99% of the
    pixels both hit, confidence (block level: the winning block's max
    weight + 1) equal on all of them, colour within 2/255 on >= 99% of
    them."""
    from gps_slam_tpu.tsdf import raycast_pallas as rcp

    jv, tv, cams = _jax_fused_volume()
    cam = cams[2]
    out_p = rcp.raycast(jv, jnp.asarray(cam.c2w), jnp.asarray(cam.K),
                        cam.width, cam.height, lb, 4, s_refine, k_blocks, 4,
                        interpret=True)
    out_t = trc.raycast(tv, cam.c2w, cam.K, cam.width, cam.height, lb, 4,
                        s_refine, k_blocks)
    dp = np.asarray(out_p["depth_map"])[..., 0]
    dt = out_t["depth_map"].numpy()[..., 0]
    assert np.mean((dp > 0) != (dt > 0)) < 0.01
    both = (dp > 0) & (dt > 0)
    assert both.mean() > 0.8
    assert np.mean(np.abs(dp - dt)[both] < tv.params.voxel_size) >= 0.99
    cp = np.asarray(out_p["confidence_map"])[..., 0]
    ct = out_t["confidence_map"].numpy()[..., 0]
    np.testing.assert_array_equal(ct[both], cp[both])
    colp = np.asarray(out_p["color_map"])[both]
    colt = out_t["color_map"].numpy()[both]
    assert np.mean(np.abs(colp - colt).max(-1) < 2 / 255) >= 0.99
    np.testing.assert_allclose(out_t["vertex_map"].numpy()[both],
                               np.asarray(out_p["vertex_map"])[both],
                               atol=2 * tv.params.voxel_size)


def test_raycast_batch_matches_single():
    """raycast_batch stacks the per-pose raycasts exactly."""
    _, tv, cams = _jax_fused_volume()
    picks = [cams[1], cams[5]]
    b = trc.raycast_batch(tv, np.stack([c.c2w for c in picks]), picks[0].K,
                          picks[0].width, picks[0].height, 24, 4, 8, 1)
    for i, cam in enumerate(picks):
        s = trc.raycast(tv, cam.c2w, cam.K, cam.width, cam.height, 24, 4, 8, 1,
                        need_normals=False)
        for k in ("depth_map", "color_map", "confidence_map", "vertex_map"):
            torch.testing.assert_close(b[k][i], s[k], rtol=0, atol=0)


def test_scene_npz_roundtrip_between_packages(tmp_path):
    """A scene.npz written by the JAX engine loads into the port's engine
    and the port's scene.npz loads back into the JAX engine unchanged."""
    from gps_slam_tpu.config import Config as JConfig
    from gps_slam_tpu.tsdf.engine import TsdfEngine as JEngine
    from gps_slam_torch.config import Config as TConfig
    from gps_slam_torch.tsdf.engine import TsdfEngine as TEngine

    cams = synthetic.make_cameras(n_frames=3, width=96, height=72)
    node = {"input_dir": "mem", "image_path": "c", "pose_path": "c", "depth_path": "d",
            "pcd_name": "n", "depth_scale": 6553.5, "scene_scale": 1.0,
            "start_frame": 0, "end_frame": 2, "frame_step": 1,
            "intrinsics": [cams[0].fx, cams[0].fy, cams[0].cx, cams[0].cy],
            "image_shape": [96, 72], "downscale_factor": 1, "test_split_interval": -1}
    d = synthetic.default_config_dict(str(tmp_path), node)
    je = JEngine(JConfig.from_dict(d), 96, 72, cams[0].K)
    je.set_gt_poses([c.c2w for c in cams])
    je.turn_off_tracking()
    for c in cams:
        je.process_frame(c.image, c.depth)
    je.save_scene(str(tmp_path / "j"))
    te = TEngine(TConfig.from_dict(d), 96, 72, cams[0].K, device="cpu")
    te.load_scene(str(tmp_path / "j"))
    assert te.vol.n_blocks == int(je.vol.n_blocks)
    np.testing.assert_array_equal(_u32(te.vol.state), np.asarray(je.vol.state))
    np.testing.assert_array_equal(_u32(te.vol.table_keys), np.asarray(je.vol.table_keys))
    te.save_scene(str(tmp_path / "t"))
    je2 = JEngine(JConfig.from_dict(d), 96, 72, cams[0].K)
    je2.load_scene(str(tmp_path / "t"))
    np.testing.assert_array_equal(np.asarray(je2.vol.state), np.asarray(je.vol.state))
    np.testing.assert_array_equal(np.asarray(je2.vol.color), np.asarray(je.vol.color))
    np.testing.assert_array_equal(np.asarray(je2.vol.summary), np.asarray(je.vol.summary))
    assert len(te.cam_poses) == 3
