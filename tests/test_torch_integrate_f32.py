"""The port's f32-I/O integrate route (K2a/K2b) held against the JAX
package: the route rule, the plain version of `integrate_f32_cuda`
against `integrate_pallas.integrate_blocks(interpret=True)`, the packed
fallback of `integrate_blocks_packed`, and whole frames fused by both
`fuse_frame`s on that route.

Inputs are made with numpy from a seed and handed to both packages; the
JAX Pallas kernels run in interpret mode on the CPU, the port through its
plain PyTorch versions (the CUDA kernel is held against those in
test_torch_cuda.py).  Both packages read the budget `_RESIDENT_BYTES` at
call time, so a test lowers it to take the f32 route at 96x72.

The JAX reference divides by 255 and by mu in its kernel source; XLA's
CPU compile of the interpret-mode kernel turns a division by a constant
into a multiplication by its reciprocal, so its f32 results may sit one
or two units in the last place from the port's divisions (measured:
1.2e-7 in sdf, 1.8e-7 in colour)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gps_slam_tpu.tsdf.integrate_pallas as ipk
from gps_slam_tpu.data import synthetic
from gps_slam_tpu.tsdf import hash as jhash
from gps_slam_tpu.tsdf import integrate as jint
from gps_slam_tpu.tsdf import volume as jvol
from gps_slam_torch.tsdf import integrate as tint
from gps_slam_torch.tsdf import volume as tvol

W, H = 96, 72
VOX, MU, MAXW = 0.01, 0.02, 100
FX = FY = 80.0
CX, CY = W / 2, H / 2
# 96x72 pads to 3 x 3 tiles: 92,160 bytes of packed planes, 73,728 of f32
# ones; a budget between the two takes the resident route, 0 the pre-gather
BUDGET = {"resident": 80_000, "pregather": 0}


def _sdf_i16(words: np.ndarray) -> np.ndarray:
    s = (words & 0xFFFF).astype(np.int64)
    return np.where(s >= 32768, s - 65536, s)


def _budget(mp, route):
    mp.setattr(ipk, "_RESIDENT_BYTES", BUDGET[route])
    mp.setattr(tint, "_RESIDENT_BYTES", BUDGET[route])
    assert tint.integrate_route(W, H) == route


def _blocks(rng):
    """The block grid, depth and packed colour of test_tsdf.py's integrate
    test: 96 blocks in front of an identity camera, depth ~1 m."""
    depth = np.abs(rng.normal(1.0, 0.1, (H, W))).astype(np.float32)
    rgbp = rng.integers(0, 2 ** 24, (H, W), dtype=np.uint32)
    bxyz = np.stack(np.meshgrid(np.arange(-3, 3), np.arange(-2, 2),
                                np.arange(10, 14), indexing="ij"),
                    -1).reshape(-1, 3).astype(np.int32)
    keys = jhash.pack(*(jnp.asarray(bxyz[:, k]) for k in range(3)))
    return depth, rgbp, keys


@pytest.mark.parametrize("width,height,route", [
    (96, 72, "packed"), (1200, 680, "packed"), (1280, 720, "packed"),
    (1296, 968, "resident"), (1920, 1080, "pregather")])
def test_integrate_route_matches_jax_predicates(width, height, route):
    """integrate_route against the two predicates of the JAX package
    (integrate_pallas.py:427 and :543), computed from its own PT and
    _RESIDENT_BYTES, and against the route each frame size is known to
    take there."""
    assert (tint.PT, tint.WIN, tint._RESIDENT_BYTES) == (ipk.PT, ipk.WIN, ipk._RESIDENT_BYTES)
    tiles = -(-width // ipk.PT) * -(-height // ipk.PT)
    if tiles * ipk.PT * ipk.PT * 10 <= ipk._RESIDENT_BYTES:
        jax_route = "packed"
    elif tiles * ipk.PT * ipk.PT * 8 <= ipk._RESIDENT_BYTES:
        jax_route = "resident"
    else:
        jax_route = "pregather"
    assert tint.integrate_route(width, height) == jax_route == route


@pytest.mark.parametrize("route", ["resident", "pregather"])
def test_integrate_blocks_plain_matches_pallas_interpret(route, monkeypatch):
    """integrate_blocks_plain against integrate_blocks(interpret=True) on
    the inputs of test_tsdf.py's integrate test, through the JAX kernel of
    `route` (K2a `_kernel_resident`, K2b `_kernel_pregather`).  On valid
    rows: weights exact; sdf and colour within 1e-6 (see the module
    docstring)."""
    rng = np.random.default_rng(0)
    depth, rgbp, keys = _blocks(rng)
    V = keys.shape[0]
    valid = rng.random(V) > 0.1
    old_sdf = rng.uniform(-1, 1, (V, 512)).astype(np.float32)
    old_w = rng.integers(0, 50, (V, 512)).astype(np.float32)
    old_cp = rng.integers(0, 2 ** 24, (V, 512), dtype=np.uint32)
    old_wc = rng.integers(0, 50, (V, 512)).astype(np.float32)
    _budget(monkeypatch, route)
    rj = ipk.integrate_blocks(
        jnp.asarray(depth), jnp.asarray(rgbp), keys, jnp.asarray(valid),
        jnp.asarray(old_sdf), jnp.asarray(old_w), jnp.asarray(old_cp),
        jnp.asarray(old_wc), jnp.eye(4), FX, FY, CX, CY, W, H, VOX, MU, MAXW,
        interpret=True)
    rt = tint.integrate_blocks(
        torch.as_tensor(depth), torch.as_tensor(rgbp.view(np.int32)),
        torch.as_tensor(np.asarray(keys).view(np.int32)), torch.as_tensor(valid),
        torch.as_tensor(old_sdf), torch.as_tensor(old_w),
        torch.as_tensor(old_cp.view(np.int32)), torch.as_tensor(old_wc),
        torch.eye(4), FX, FY, CX, CY, W, H, VOX, MU, MAXW)
    (fj, wj, cj, wcj), (ft, wt, ct, wct) = ([np.asarray(x)[valid] for x in r]
                                            for r in (rj, [x.numpy() for x in rt]))
    assert ct.shape == cj.shape == (valid.sum(), 512, 3)
    np.testing.assert_array_equal(wt, wj)
    np.testing.assert_array_equal(wct, wcj)
    np.testing.assert_allclose(ft, fj, rtol=0, atol=1e-6)
    np.testing.assert_allclose(ct, cj, rtol=0, atol=1e-6)
    # the inputs exercise both updates
    assert (wt != old_w[valid]).mean() > 0.3 and (wct != old_wc[valid]).mean() > 0.01


def test_integrate_blocks_packed_f32_route_matches_pallas_interpret(monkeypatch):
    """The port's integrate_blocks_packed with its budget lowered to the
    resident route against integrate_blocks_packed(interpret=True) with
    the JAX budget lowered alike (its f32 fallback: unpack, K2a, repack,
    XLA summary), on the inputs of test_torch_tsdf.py's K1 test.  Valid
    rows: weights exact, sdf within 1 i16 quantum, colour channels within
    1 of 255, summary within 1e-6.  Tighter than K1's test, since both
    sides read f32 depth here."""
    rng = np.random.default_rng(0)
    depth, rgbp, keys = _blocks(rng)
    V = keys.shape[0]
    valid = rng.random(V) > 0.1
    old_sdf = rng.uniform(-1, 1, (V, 512)).astype(np.float32)
    old_w = rng.integers(0, 50, (V, 512)).astype(np.uint32)
    old_wc = rng.integers(0, 50, (V, 512)).astype(np.uint32)
    old_cp = rng.integers(0, 2 ** 24, (V, 512), dtype=np.uint32)
    q = np.round(np.clip(old_sdf, -1, 1) * 32767).astype(np.int32) & 0xFFFF
    old_packed = q.astype(np.uint32) | (old_w << 16) | (old_wc << 24)
    _budget(monkeypatch, "resident")
    js, jc, jsum = (np.asarray(x) for x in ipk.integrate_blocks_packed(
        jnp.asarray(depth), jnp.asarray(rgbp), keys, jnp.asarray(valid),
        jnp.asarray(old_packed), jnp.asarray(old_cp), jnp.eye(4),
        FX, FY, CX, CY, W, H, VOX, MU, MAXW, interpret=True))

    state = torch.as_tensor(old_packed.view(np.int32).copy())
    color = torch.as_tensor(old_cp.view(np.int32).copy())
    summary = tvol.init_summary(V)
    ptrs = torch.where(torch.as_tensor(valid), torch.arange(V, dtype=torch.int32), -1)
    tint.integrate_blocks_packed(
        torch.as_tensor(depth), torch.as_tensor(rgbp.view(np.int32)),
        torch.as_tensor(np.asarray(keys).view(np.int32)), ptrs, state, color,
        summary, torch.eye(4), FX, FY, CX, CY, VOX, MU, MAXW)
    ts, tc, tsum = (x.numpy()[valid] for x in (state, color, summary))
    ts, tc = ts.view(np.uint32), tc.view(np.uint32)
    js, jc, jsum = js[valid], jc[valid], jsum[valid]
    np.testing.assert_array_equal(ts >> 16, js >> 16)
    assert np.abs(_sdf_i16(ts) - _sdf_i16(js)).max() <= 1
    for sh in (0, 8, 16):
        d = np.abs(((tc >> sh) & 0xFF).astype(int) - ((jc >> sh) & 0xFF).astype(int))
        assert d.max() <= 1
    np.testing.assert_allclose(tsum, jsum, rtol=0, atol=1e-6)
    # rows outside the integration set keep their state
    np.testing.assert_array_equal(state.numpy()[~valid], old_packed.view(np.int32)[~valid])
    assert (((ts >> 16) & 0xFF) != old_w[valid]).mean() > 0.3


def test_fuse_frame_f32_route_matches_jax_by_block_key(monkeypatch):
    """Four synthetic 96x72 frames fused by both packages with both
    budgets at 0 (the pre-gather route: the JAX fuse_frame on its kernel
    branch with integrate_blocks_packed in interpret mode, the port
    through integrate_blocks_plain).  By block key: the same key sets,
    weights equal on >= 99.5% of voxels (measured: all of them), sdf
    within 1 i16 quantum on >= 99.9% of the voxels both integrated."""
    cams = synthetic.make_cameras(n_frames=4, width=W, height=H)
    # a visible capacity of 512 rows bounds the interpret-mode grid
    kw = dict(voxel_size=0.02, mu=0.08, hash_size=1 << 16, block_capacity=1 << 13,
              visible_capacity=512, frustum_min=0.2, frustum_max=10.0)
    jv = jvol.create(jvol.TsdfParams(raycast_steps=64, **kw))
    tv = tvol.create(tvol.TsdfParams(**kw), "cpu")
    _budget(monkeypatch, "pregather")
    monkeypatch.setattr(ipk, "integrate_blocks_packed",
                        functools.partial(ipk.integrate_blocks_packed, interpret=True))
    # a jit of its own: fuse_frame's cache may hold a trace of the K1 route
    fuse = jax.jit(jint._fuse_frame_impl, static_argnums=(5, 6, 8, 10, 11))
    for cam in cams:
        jv = fuse(jv, jnp.asarray(cam.depth[..., 0]), jnp.asarray(cam.image),
                  jnp.asarray(cam.c2w), jnp.asarray(cam.K), False, True, None, 1,
                  None, None, None)
        tint.fuse_frame(tv, torch.as_tensor(cam.depth[..., 0]),
                        torch.as_tensor(cam.image), torch.as_tensor(cam.c2w), cam.K)
    n = int(jv.n_blocks)
    assert tv.n_blocks == n > 50
    kj = np.asarray(jv.block_coords)[:n]
    kt = tv.block_coords.numpy()[:n].view(np.uint32)
    assert set(kj.tolist()) == set(kt.tolist())
    sj = np.asarray(jv.state)[:n][np.argsort(kj)]
    st = tv.state.numpy()[:n].view(np.uint32)[np.argsort(kt)]
    wj, wt = (sj >> 16) & 0xFF, (st >> 16) & 0xFF
    assert np.mean(wj == wt) >= 0.995
    assert (wt > 0).mean() > 0.1
    both = (wj > 0) & (wt > 0)
    assert np.mean(np.abs(_sdf_i16(sj) - _sdf_i16(st))[both] <= 1) >= 0.999
