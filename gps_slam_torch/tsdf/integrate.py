"""Depth-driven block allocation + TSDF fusion — the port of
gps_slam_tpu/tsdf/integrate.py (gt-pose band path).

Per frame: mu-band block candidates (`alloc_candidates`) -> dedup ->
hash insert; the insert's per-candidate pool rows are the integration set
(a prefix, since dedup parks EMPTY keys last); then the per-block voxel
update.  On the card the update is the CUDA kernel `integrate_cuda`
(csrc/integrate.cu); on the CPU it is `integrate_blocks_packed_plain`,
the same function step by step in f32.  Both write the voxel state,
colour and summary rows back into the pool in place.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..utils.se3 import pose_inv
from . import hash as vhash
from .volume import (BLOCK, BLOCK_VOL, TsdfVolume, pack_state,
                     state_sdf_f32, state_w_color, state_w_depth, unpack_rgb)

PT = 32        # image tile edge of the per-block sampling window
WIN = 2 * PT   # window edge: a block samples a 64x64 pixel window


def pack_rgb(rgb: torch.Tensor) -> torch.Tensor:
    """[H, W, 3] float in [0,1] -> packed rgb888 int32 [H, W]."""
    q = torch.clamp(rgb * 255.0 + 0.5, 0, 255).to(torch.int32)
    return q[..., 0] | (q[..., 1] << 8) | (q[..., 2] << 16)


def alloc_candidates(depth, c2w, fx, fy, cx, cy, voxel_size, mu, frustum_min,
                     frustum_max, n_steps, stride=2) -> torch.Tensor:
    """Per-pixel mu-band block candidates (packed keys, EMPTY = none),
    marched at each stride x stride quad's max and valid-min depth."""
    H, W = depth.shape
    Hs, Ws = (H // stride) * stride, (W // stride) * stride
    quads = depth[:Hs, :Ws].reshape(Hs // stride, stride, Ws // stride, stride)
    z_max = quads.amax(dim=(1, 3))
    z_min = torch.where(quads > 0, quads, torch.inf).amin(dim=(1, 3))
    z_min = torch.where(torch.isfinite(z_min), z_min, 0.0)
    Hh, Ww = z_max.shape
    one_over_block = 1.0 / (voxel_size * BLOCK)
    dev = depth.device
    i = (torch.arange(Ww, dtype=torch.float32, device=dev) * stride)[None, :]
    j = (torch.arange(Hh, dtype=torch.float32, device=dev) * stride)[:, None]
    R, t = c2w[:3, :3], c2w[:3, 3]
    inv = 1.0 / max(n_steps - 1, 1)
    # device-tensor divisors: torch on CUDA divides by a host scalar as a
    # multiplication by its reciprocal, and `scalar / tensor` is that
    # multiplication on every device; the JAX package divides
    fx_d, fy_d, mu_d = (torch.tensor(v, dtype=torch.float32, device=dev)
                        for v in (fx, fy, mu))

    def band_keys(z):
        valid = (z > 0) & ((z - mu) >= frustum_min) & ((z + mu) <= frustum_max)
        x = z * (i - cx) / fx_d
        y = z * (j - cy) / fy_d
        norm = torch.clamp(torch.sqrt(x * x + y * y + z * z), min=1e-6)
        s0 = 1.0 - mu_d / norm
        s1 = 1.0 + mu_d / norm
        wx = R[0, 0] * x + R[0, 1] * y + R[0, 2] * z
        wy = R[1, 0] * x + R[1, 1] * y + R[1, 2] * z
        wz = R[2, 0] * x + R[2, 1] * y + R[2, 2] * z
        sx0 = (wx * s0 + t[0]) * one_over_block
        sy0 = (wy * s0 + t[1]) * one_over_block
        sz0 = (wz * s0 + t[2]) * one_over_block
        dx = (wx * s1 + t[0]) * one_over_block - sx0
        dy = (wy * s1 + t[1]) * one_over_block - sy0
        dz = (wz * s1 + t[2]) * one_over_block - sz0
        keys = []
        for s in range(n_steps):
            f = s * inv
            bx = torch.floor(sx0 + f * dx)
            by = torch.floor(sy0 + f * dy)
            bz = torch.floor(sz0 + f * dz)
            ok = valid & vhash.coords_in_range(bx, by, bz)
            big = 4 * vhash.COORD_OFFSET  # keep the int cast of masked rows finite
            k = vhash.pack(*(torch.clamp(b, -big, big).to(torch.int32)
                             for b in (bx, by, bz)))
            keys.append(torch.where(ok, k, vhash.EMPTY))
        return keys

    keys = band_keys(z_max) + band_keys(z_min)
    return torch.stack(keys, dim=-1).reshape(-1)


# ---------------------------------------------------------------------------
# the per-block voxel update (K1)
# ---------------------------------------------------------------------------

def _window_anchor(keys, w2c, fx, fy, cx, cy, tw, th, voxel_size):
    """Per-block 64x64 window anchor (tile units) from the min projection
    of the block's 8 corners — the JAX kernel's `_block_window_meta`."""
    bx, by, bz = (c.to(torch.float32) * BLOCK for c in vhash.unpack(keys))
    R, t = w2c[:3, :3], w2c[:3, 3]
    ext = voxel_size * BLOCK
    umin = torch.full_like(bx, torch.inf)
    vmin = torch.full_like(bx, torch.inf)
    for ox in (0.0, ext):
        for oy in (0.0, ext):
            for oz in (0.0, ext):
                px = bx * voxel_size + ox
                py = by * voxel_size + oy
                pz = bz * voxel_size + oz
                zc = R[2, 0] * px + R[2, 1] * py + R[2, 2] * pz + t[2]
                zs = torch.clamp(zc, min=1e-6)
                uu = fx * (R[0, 0] * px + R[0, 1] * py + R[0, 2] * pz + t[0]) / zs + cx
                vv = fy * (R[1, 0] * px + R[1, 1] * py + R[1, 2] * pz + t[1]) / zs + cy
                umin = torch.minimum(umin, uu)
                vmin = torch.minimum(vmin, vv)
    ax = torch.clamp(torch.floor(umin / PT), 0, tw - 2).to(torch.int64)
    ay = torch.clamp(torch.floor(vmin / PT), 0, th - 2).to(torch.int64)
    return ax, ay


def integrate_blocks_packed_plain(depth, rgb_packed, keys, ptrs, state, color,
                                  summary, w2c, fx, fy, cx, cy, voxel_size,
                                  mu, max_w) -> None:
    """Plain PyTorch version of `integrate_cuda`: for each row with
    ptrs >= 0, project the block's 512 voxels, take the nearest depth and
    rgb tap inside the block's 64x64 window (anchored at the 2x2 32-px
    tile pair of its 8-corner min projection), run the running-average
    TSDF/colour update and write state, colour and the summary row back at
    pool row ptrs[i].  f32 throughout; the mip is the f32 mean of the
    unquantized new sdf."""
    H, W = depth.shape
    tw, th = -(-W // PT), -(-H // PT)
    sel = ptrs >= 0
    if not bool(sel.any()):
        return
    rows = ptrs[sel].to(torch.int64)
    k = keys[sel]
    ax, ay = _window_anchor(k, w2c, fx, fy, cx, cy, tw, th, voxel_size)
    dev = depth.device
    lin = torch.arange(BLOCK_VOL, device=dev)
    vlx = (lin % BLOCK).to(torch.float32)
    vly = ((lin // BLOCK) % BLOCK).to(torch.float32)
    vlz = (lin // (BLOCK * BLOCK)).to(torch.float32)
    bx, by, bz = (c.to(torch.float32)[:, None] * BLOCK for c in vhash.unpack(k))
    px = (bx + vlx) * voxel_size
    py = (by + vly) * voxel_size
    pz = (bz + vlz) * voxel_size
    R, t = w2c[:3, :3], w2c[:3, 3]
    zc = R[2, 0] * px + R[2, 1] * py + R[2, 2] * pz + t[2]
    xc = R[0, 0] * px + R[0, 1] * py + R[0, 2] * pz + t[0]
    yc = R[1, 0] * px + R[1, 1] * py + R[1, 2] * pz + t[1]
    zs = torch.where(zc.abs() < 1e-9, 1e-9, zc)
    u = fx * xc / zs + cx
    v = fy * yc / zs + cy
    in_img = (zc > 0) & (u >= 1) & (u <= W - 2) & (v >= 1) & (v <= H - 2)
    ru = torch.round(u.clamp(-1e7, 1e7)).to(torch.int64)
    rv = torch.round(v.clamp(-1e7, 1e7)).to(torch.int64)
    iu = ru - (ax * PT)[:, None]
    iv = rv - (ay * PT)[:, None]
    in_win = (iu >= 0) & (iu < WIN) & (iv >= 0) & (iv < WIN)
    inside = in_win & (ru >= 0) & (ru < W) & (rv >= 0) & (rv < H)
    pix = (rv.clamp(0, H - 1) * W + ru.clamp(0, W - 1))
    d_meas = torch.where(inside, depth.reshape(-1)[pix], 0.0)
    c_meas = torch.where(inside[..., None],
                         unpack_rgb(rgb_packed.reshape(-1)[pix]), 0.0)

    st = state[rows]
    old_f = state_sdf_f32(st)
    old_w = state_w_depth(st).to(torch.float32)
    old_wc = state_w_color(st).to(torch.float32)
    eta = d_meas - zc
    update = in_img & in_win & (d_meas > 0) & (eta >= -mu)
    # a device-tensor divisor: on CUDA torch multiplies by the reciprocal
    # of a host scalar, which rounds differently from the kernel's division
    eta_mu = eta / torch.full_like(eta, mu)
    new_obs = torch.clamp(eta_mu, max=1.0)
    den = old_w + 1.0
    new_f = torch.where(update, (old_w * old_f + new_obs) / den, old_f)
    new_w = torch.where(update, torch.clamp(den, max=float(max_w)), old_w)
    cu = update & (eta <= mu) & (eta_mu.abs() < 0.25)
    oc = unpack_rgb(color[rows])
    wc_den = old_wc + 1.0
    nc = torch.where(cu[..., None], (oc * old_wc[..., None] + c_meas)
                     / wc_den[..., None], oc)
    q = torch.clamp(nc + 0.5, 0.0, 255.0).to(torch.int32)
    new_wc = torch.where(cu, torch.clamp(wc_den, max=float(max_w)), old_wc)

    state[rows] = pack_state(new_f, new_w, new_wc)
    color[rows] = q[..., 0] | (q[..., 1] << 8) | (q[..., 2] << 16)
    mip = new_f.reshape(-1, 4, 2, 4, 2, 4, 2).mean(dim=(2, 4, 6)).reshape(-1, 64)
    srow = torch.zeros((rows.shape[0], 128), dtype=torch.float32, device=dev)
    srow[:, :64] = mip
    srow[:, 64] = torch.where(new_w > 0, new_f, 1.0).amin(dim=1)
    srow[:, 65] = new_w.amax(dim=1)
    summary[rows] = srow


def integrate_blocks_packed(depth, rgb_packed, keys, ptrs, state, color,
                            summary, w2c, fx, fy, cx, cy, voxel_size, mu,
                            max_w) -> None:
    """The per-block voxel update in place on the pool (see the plain
    version for the semantics).  CPU tensors take the plain version; CUDA
    tensors launch `integrate_cuda` or raise."""
    if depth.device.type != "cuda":
        return integrate_blocks_packed_plain(
            depth, rgb_packed, keys, ptrs, state, color, summary, w2c,
            fx, fy, cx, cy, voxel_size, mu, max_w)
    H, W = depth.shape
    if H < WIN or W < WIN:
        raise ValueError(f"integrate_cuda: frames below {WIN}x{WIN} px are "
                         f"not supported (got {W}x{H})")
    V = keys.shape[0]
    B = state.shape[0]
    k = kernels.INTEGRATE
    for name, t, dtype, shape in (
            ("depth", depth, torch.float32, None),
            ("rgb_packed", rgb_packed, torch.int32, (H, W)),
            ("keys", keys, torch.int32, (V,)), ("ptrs", ptrs, torch.int32, (V,)),
            ("state", state, torch.int32, (B, BLOCK_VOL)),
            ("color", color, torch.int32, (B, BLOCK_VOL)),
            ("summary", summary, torch.float32, (B, 128))):
        kernels.check_tensor(k, name, t, dtype, shape)
    if V == 0:
        return
    m = w2c.detach().to("cpu", torch.float32).tolist()
    err = k.fn(depth.data_ptr(), rgb_packed.data_ptr(), keys.data_ptr(),
               ptrs.data_ptr(), state.data_ptr(), color.data_ptr(),
               summary.data_ptr(), V, W, H, B,
               float(fx), float(fy), float(cx), float(cy),
               float(voxel_size), float(mu), int(max_w),
               m[0][0], m[0][1], m[0][2], m[1][0], m[1][1], m[1][2],
               m[2][0], m[2][1], m[2][2], m[0][3], m[1][3], m[2][3],
               kernels.stream_ptr())
    k.launches += 1
    kernels.check(k, err)


# ---------------------------------------------------------------------------
# narrow frames: the JAX package's XLA branch (bilinear colour, no window)
# ---------------------------------------------------------------------------

def _integrate_small_frame(vol, depth, rgb_packed, keys, ptrs, w2c, fx, fy,
                           cx, cy):
    """Frames narrower or shorter than two 32-px tiles: the JAX package
    runs its XLA branch there (nearest depth over the whole image, bilinear
    colour, integrate.py:442-528).  CPU only."""
    p = vol.params
    H, W = depth.shape
    sel = ptrs >= 0
    if not bool(sel.any()):
        return
    rows = ptrs[sel].to(torch.int64)
    bx, by, bz = (c.to(torch.float32) * BLOCK for c in vhash.unpack(keys[sel]))
    lin = torch.arange(BLOCK_VOL, device=depth.device)
    local = torch.stack([lin % BLOCK, (lin // BLOCK) % BLOCK,
                         lin // (BLOCK * BLOCK)], -1).to(torch.float32)
    base = torch.stack([bx, by, bz], -1)
    pos_w = (base[:, None, :] + local[None]) * p.voxel_size
    pc = pos_w @ w2c[:3, :3].T + w2c[:3, 3]
    z = pc[..., 2]
    u = fx * pc[..., 0] / z + cx
    v = fy * pc[..., 1] / z + cy
    in_img = (z > 0) & (u >= 1) & (u <= W - 2) & (v >= 1) & (v <= H - 2)
    ui = torch.round(u.nan_to_num(0).clamp(-1e7, 1e7)).to(torch.int64).clamp(0, W - 1)
    vi = torch.round(v.nan_to_num(0).clamp(-1e7, 1e7)).to(torch.int64).clamp(0, H - 1)
    d_meas = depth[vi, ui]
    eta = d_meas - z
    update = in_img & (d_meas > 0) & (eta >= -p.mu)
    st = vol.state[rows]
    old_f = state_sdf_f32(st)
    old_w = state_w_depth(st).to(torch.float32)
    new_f = torch.where(update, (old_w * old_f + torch.clamp(eta / p.mu, max=1.0))
                        / (old_w + 1.0), old_f)
    new_w = torch.where(update, torch.clamp(old_w + 1.0, max=float(p.max_w)), old_w)
    cu = update & (eta <= p.mu) & ((eta / p.mu).abs() < 0.25)
    uc = u.nan_to_num(0).clamp(-1e7, 1e7)
    vc = v.nan_to_num(0).clamp(-1e7, 1e7)
    u0 = torch.floor(uc).to(torch.int64).clamp(0, W - 2)
    v0 = torch.floor(vc).to(torch.int64).clamp(0, H - 2)
    du = (uc - u0).clamp(0.0, 1.0)[..., None]
    dv = (vc - v0).clamp(0.0, 1.0)[..., None]

    def tap(vv, uu):
        return unpack_rgb(rgb_packed[vv, uu]) / 255.0

    c_meas = (tap(v0, u0) * (1 - du) * (1 - dv) + tap(v0, u0 + 1) * du * (1 - dv)
              + tap(v0 + 1, u0) * (1 - du) * dv + tap(v0 + 1, u0 + 1) * du * dv)
    old_c = unpack_rgb(vol.color[rows]) / 255.0
    old_wc = state_w_color(st).to(torch.float32)
    new_c = torch.where(cu[..., None], (old_c * old_wc[..., None] + c_meas)
                        / (old_wc[..., None] + 1.0), old_c)
    new_wc = torch.where(cu, torch.clamp(old_wc + 1.0, max=float(p.max_w)), old_wc)
    vol.state[rows] = pack_state(new_f, new_w, new_wc)
    vol.color[rows] = pack_rgb(new_c)
    mip = new_f.reshape(-1, 4, 2, 4, 2, 4, 2).mean(dim=(2, 4, 6)).reshape(-1, 64)
    srow = torch.zeros((rows.shape[0], 128), device=depth.device)
    srow[:, :64] = mip
    srow[:, 64] = torch.where(new_w > 0, new_f, 1.0).amin(dim=1)
    srow[:, 65] = new_w.amax(dim=1)
    vol.summary[rows] = srow


def fuse_frame(vol: TsdfVolume, depth: torch.Tensor, rgb: torch.Tensor,
               c2w: torch.Tensor, K) -> TsdfVolume:
    """One frame of allocation + integration, updating `vol` in place
    (the JAX version returns a new volume; here the pools are written in
    place and the same object is returned)."""
    p = vol.params
    Kf = [[float(x) for x in r] for r in K.tolist()] if torch.is_tensor(K) \
        else [[float(x) for x in r] for r in K]
    fx, fy, cx, cy = Kf[0][0], Kf[1][1], Kf[0][2], Kf[1][2]
    H, W = depth.shape
    cand = alloc_candidates(depth, c2w, fx, fy, cx, cy, p.voxel_size, p.mu,
                            p.frustum_min, p.frustum_max, p.alloc_steps,
                            stride=p.alloc_stride)
    cand = vhash.dedup_candidates(cand, p.alloc_candidate_cap)
    vol.n_blocks, cand_ptrs = vhash.insert(
        vol.table_keys, vol.table_ptrs, vol.n_blocks, vol.block_coords, cand,
        p.max_probes, p.block_capacity, claim_rounds=2, return_ptrs=True)
    # the valid candidates are a prefix (dedup parks EMPTY keys last); the
    # integration set is that prefix, capped at the visible capacity
    n_cand = int((cand != vhash.EMPTY).sum())
    V = min(p.visible_capacity, p.alloc_candidate_cap, n_cand)
    keys = cand[:V].contiguous()
    ptrs = cand_ptrs[:V].contiguous()
    w2c = pose_inv(c2w)
    rgb_packed = pack_rgb(rgb)
    if W < WIN or H < WIN:
        if depth.device.type == "cuda":
            raise ValueError(f"frames below {WIN}x{WIN} px are not supported "
                             f"on the card (got {W}x{H})")
        _integrate_small_frame(vol, depth, rgb_packed, keys, ptrs, w2c,
                               fx, fy, cx, cy)
    else:
        integrate_blocks_packed(depth.contiguous(), rgb_packed.contiguous(),
                                keys, ptrs, vol.state, vol.color, vol.summary,
                                w2c, fx, fy, cx, cy, p.voxel_size, p.mu, p.max_w)
    return vol
