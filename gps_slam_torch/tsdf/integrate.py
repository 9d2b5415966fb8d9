"""Depth-driven block allocation + TSDF fusion — the port of
gps_slam_tpu/tsdf/integrate.py (gt-pose band path).

Per frame: mu-band block candidates (`alloc_candidates`) -> dedup ->
hash insert; the insert's per-candidate pool rows are the integration set
(a prefix, since dedup parks EMPTY keys last); then the per-block voxel
update, by the route the JAX package takes for the frame's size
(`integrate_route`):

  * "packed" (frames whose tile planes fit the JAX kernels' 10 MiB VMEM
    budget, up to 1280x720): the packed-I/O update, on the card the CUDA
    kernel `integrate_cuda` (csrc/integrate.cu), on the CPU
    `integrate_blocks_packed_plain`;
  * "resident" / "pregather" (larger frames): the f32-I/O update
    `integrate_blocks` (colour in 0..1, exact f32 depth taps), on the card
    the CUDA kernel `integrate_f32_cuda` (csrc/integrate_f32.cu), on the
    CPU `integrate_blocks_plain`, with the repack and summary row in torch.

Either way the voxel state, colour and summary rows are written back into
the pool in place.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..utils.se3 import bilateral_filter_depth, pose_inv
from ..utils.static_shape import set_rows
from . import hash as vhash
from .volume import (BLOCK, BLOCK_VOL, TsdfVolume, pack_state,
                     state_sdf_f32, state_w_color, state_w_depth, unpack_rgb)

PT = 32        # image tile edge of the per-block sampling window
WIN = 2 * PT   # window edge: a block samples a 64x64 pixel window
# the JAX package's VMEM budget for its integrate kernels' resident tile
# planes (integrate_pallas._RESIDENT_BYTES); the port reads it only to take
# the same route as the JAX package on a frame of the same size
_RESIDENT_BYTES = 10 * 2 ** 20


def integrate_route(width: int, height: int) -> str:
    """The JAX package's integrate route for a width x height frame:
    "packed" (K1) while its bf16 hi/lo + rgb tile planes, 10 bytes per
    padded pixel, fit `_RESIDENT_BYTES`; else the f32-I/O update, from
    "resident" f32 + u32 tile planes (8 bytes per padded pixel, K2a) while
    those fit, else from "pregather"ed windows (K2b)."""
    n_px = -(-width // PT) * -(-height // PT) * PT * PT
    if n_px * 10 <= _RESIDENT_BYTES:
        return "packed"
    return "resident" if n_px * 8 <= _RESIDENT_BYTES else "pregather"


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
    # multiplication on every device; the JAX package divides.  Made by
    # fills: no host-to-device copy
    fx_d, fy_d, mu_d = (torch.full((), v, dtype=torch.float32, device=dev)
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
# the per-block voxel update: K1 (packed I/O), K2 (f32 I/O)
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


def _voxel_taps(keys, w2c, fx, fy, cx, cy, W, H, voxel_size):
    """Project the 512 voxels of each block of `keys` into a W x H frame.
    Returns [V, 512] planes: camera z; `seen`, the voxel projects inside
    the image (1 px rim excluded) and its nearest pixel inside the block's
    64x64 window (anchored at the 2x2 32-px tile pair of its 8-corner min
    projection); the flat index of that pixel; and `inside`, the pixel
    also lies in the frame (the TPU kernels read zero-padded tiles past
    its edge, so a tap there reads 0)."""
    ax, ay = _window_anchor(keys, w2c, fx, fy, cx, cy, -(-W // PT), -(-H // PT),
                            voxel_size)
    lin = torch.arange(BLOCK_VOL, device=keys.device)
    vlx = (lin % BLOCK).to(torch.float32)
    vly = ((lin // BLOCK) % BLOCK).to(torch.float32)
    vlz = (lin // (BLOCK * BLOCK)).to(torch.float32)
    bx, by, bz = (c.to(torch.float32)[:, None] * BLOCK for c in vhash.unpack(keys))
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
    pix = rv.clamp(0, H - 1) * W + ru.clamp(0, W - 1)
    return zc, in_img & in_win, pix, inside


def _summary_rows(new_f, new_w) -> torch.Tensor:
    """The raycaster's per-block summary rows [V, 128]: the f32 mean 2x2x2
    sdf mip in lanes 0..63, the min sdf over voxels with weight in lane 64
    (1 where none has), the max weight in lane 65, zeros after."""
    srow = torch.zeros((new_f.shape[0], 128), dtype=torch.float32,
                       device=new_f.device)
    srow[:, :64] = new_f.reshape(-1, 4, 2, 4, 2, 4, 2).mean(dim=(2, 4, 6)).reshape(-1, 64)
    srow[:, 64] = torch.where(new_w > 0, new_f, 1.0).amin(dim=1)
    srow[:, 65] = new_w.amax(dim=1)
    return srow


def integrate_blocks_packed_plain(depth, rgb_packed, keys, ptrs, state, color,
                                  summary, w2c, fx, fy, cx, cy, voxel_size,
                                  mu, max_w) -> None:
    """Plain PyTorch version of `integrate_cuda`: for each row with
    ptrs >= 0, project the block's 512 voxels, take the nearest depth and
    rgb tap inside the block's 64x64 window (`_voxel_taps`), run the
    running-average TSDF/colour update in 0..255 colour units and write
    state, colour and the summary row back at pool row ptrs[i].  f32
    throughout; the mip is the f32 mean of the unquantized new sdf.  Every
    row is computed, in fixed shapes; the rows with ptrs < 0 are not
    written."""
    H, W = depth.shape
    sel = ptrs >= 0
    rows = torch.where(sel, ptrs, 0).to(torch.int64)
    zc, seen, pix, inside = _voxel_taps(keys, w2c, fx, fy, cx, cy, W, H,
                                        voxel_size)
    d_meas = torch.where(inside, depth.reshape(-1)[pix], 0.0)
    c_meas = torch.where(inside[..., None],
                         unpack_rgb(rgb_packed.reshape(-1)[pix]), 0.0)

    st = state[rows]
    old_f = state_sdf_f32(st)
    old_w = state_w_depth(st).to(torch.float32)
    old_wc = state_w_color(st).to(torch.float32)
    eta = d_meas - zc
    update = seen & (d_meas > 0) & (eta >= -mu)
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

    set_rows(state, rows, pack_state(new_f, new_w, new_wc), sel)
    set_rows(color, rows, q[..., 0] | (q[..., 1] << 8) | (q[..., 2] << 16), sel)
    set_rows(summary, rows, _summary_rows(new_f, new_w), sel)


def integrate_blocks_packed(depth, rgb_packed, keys, ptrs, state, color,
                            summary, w2c, fx, fy, cx, cy, voxel_size, mu,
                            max_w) -> None:
    """The per-block voxel update in place on the pool, by the frame's
    `integrate_route`.  "packed": see the plain version for the semantics;
    CPU tensors take it, CUDA tensors launch `integrate_cuda` or raise.
    Otherwise the f32-I/O update (`_integrate_f32_route`)."""
    H, W = depth.shape
    if integrate_route(W, H) != "packed":
        return _integrate_f32_route(depth, rgb_packed, keys, ptrs, state, color,
                                    summary, w2c, fx, fy, cx, cy, voxel_size,
                                    mu, max_w)
    if depth.device.type != "cuda":
        return integrate_blocks_packed_plain(
            depth, rgb_packed, keys, ptrs, state, color, summary, w2c,
            fx, fy, cx, cy, voxel_size, mu, max_w)
    if H < WIN or W < WIN:
        raise ValueError(f"integrate_cuda: frames below {WIN}x{WIN} px are "
                         f"not supported (got {W}x{H})")
    V = keys.shape[0]
    B = state.shape[0]
    k = kernels.INTEGRATE
    pose = kernels.pose_rows(w2c)
    for name, t, dtype, shape in (
            ("depth", depth, torch.float32, None),
            ("rgb_packed", rgb_packed, torch.int32, (H, W)),
            ("keys", keys, torch.int32, (V,)), ("ptrs", ptrs, torch.int32, (V,)),
            ("state", state, torch.int32, (B, BLOCK_VOL)),
            ("color", color, torch.int32, (B, BLOCK_VOL)),
            ("summary", summary, torch.float32, (B, 128)),
            ("w2c", pose, torch.float32, (3, 4))):
        kernels.check_tensor(k, name, t, dtype, shape)
    if any(t.data_ptr() % 16 for t in (state, color, summary)):
        raise ValueError("integrate_cuda: the state, colour and summary pools "
                         "must be 16-byte aligned (read and written as 16-byte "
                         "words)")
    if V == 0:
        return
    err = k.fn(depth.data_ptr(), rgb_packed.data_ptr(), keys.data_ptr(),
               ptrs.data_ptr(), state.data_ptr(), color.data_ptr(),
               summary.data_ptr(), pose.data_ptr(), V, W, H,
               float(fx), float(fy), float(cx), float(cy),
               float(voxel_size), float(mu), int(max_w), kernels.stream_ptr())
    k.launches += 1
    kernels.check(k, err)


def integrate_blocks_plain(depth, rgb_packed, keys, valid, old_sdf, old_w,
                           old_color, old_wc, w2c, fx, fy, cx, cy, width,
                           height, voxel_size, mu, max_w):
    """Plain PyTorch version of `integrate_f32_cuda`: the JAX package's
    `integrate_pallas.integrate_blocks` (K2a/K2b, `_voxel_update`) on
    f32 planes.  depth [H, W] f32, rgb_packed [H, W] int32, keys [V],
    valid [V] bool, old_sdf / old_w / old_wc [V, 512] f32, old_color
    [V, 512] packed rgb888.  Returns (new_f, new_w [V, 512], new_c
    [V, 512, 3] in 0..1, new_wc [V, 512]).  The taps are K1's
    (`_voxel_taps`), the depth read exactly; colour is in 0..1 units: the
    old colour is its byte divided by 255, a new tap its byte times
    f32(1/255), as the TPU kernels compute them.  `valid`, `width` and
    `height` keep the JAX function's signature, against which the tests
    hold this one; the fusion route (`_integrate_f32_route`) passes every
    row with its integration rows valid, and the depth image's own size.  Rows
    with valid False are computed all the same (the kernel leaves them
    unwritten): callers drop them."""
    zc, seen, pix, inside = _voxel_taps(keys, w2c, fx, fy, cx, cy, width,
                                        height, voxel_size)
    d_meas = torch.where(inside, depth.reshape(-1)[pix], 0.0)
    c_meas = torch.where(inside[..., None],
                         unpack_rgb(rgb_packed.reshape(-1)[pix]) * (1.0 / 255.0),
                         0.0)
    # device-tensor divisors: on CUDA torch multiplies by the reciprocal of
    # a host scalar, where the JAX package and the kernel divide
    mu_d, c255 = (torch.full((), x, dtype=torch.float32, device=depth.device)
                  for x in (mu, 255.0))
    eta = d_meas - zc
    update = seen & (d_meas > 0) & (eta >= -mu)
    eta_mu = eta / mu_d
    den = old_w + 1.0
    new_f = torch.where(update, (old_w * old_sdf + torch.clamp(eta_mu, max=1.0))
                        / den, old_sdf)
    new_w = torch.where(update, torch.clamp(den, max=float(max_w)), old_w)
    cu = update & (eta <= mu) & (eta_mu.abs() < 0.25)
    oc = unpack_rgb(old_color) / c255
    wc_den = old_wc + 1.0
    new_c = torch.where(cu[..., None], (oc * old_wc[..., None] + c_meas)
                        / wc_den[..., None], oc)
    new_wc = torch.where(cu, torch.clamp(wc_den, max=float(max_w)), old_wc)
    return new_f, new_w, new_c, new_wc


def integrate_blocks(depth, rgb_packed, keys, valid, old_sdf, old_w,
                     old_color, old_wc, w2c, fx, fy, cx, cy, width, height,
                     voxel_size, mu, max_w):
    """The f32-I/O per-block update (see the plain version for arguments
    and semantics).  CPU tensors take the plain version; CUDA tensors
    launch `integrate_f32_cuda` or raise.  On the card, rows with valid
    False come back unwritten."""
    if depth.device.type != "cuda":
        return integrate_blocks_plain(
            depth, rgb_packed, keys, valid, old_sdf, old_w, old_color, old_wc,
            w2c, fx, fy, cx, cy, width, height, voxel_size, mu, max_w)
    W, H = int(width), int(height)
    if H < WIN or W < WIN:
        raise ValueError(f"integrate_f32_cuda: frames below {WIN}x{WIN} px are "
                         f"not supported (got {W}x{H})")
    V = keys.shape[0]
    k = kernels.INTEGRATE_F32
    pose = kernels.pose_rows(w2c)
    plane = (V, BLOCK_VOL)
    for name, t, dtype, shape in (
            ("depth", depth, torch.float32, (H, W)),
            ("rgb_packed", rgb_packed, torch.int32, (H, W)),
            ("keys", keys, torch.int32, (V,)), ("valid", valid, torch.bool, (V,)),
            ("old_sdf", old_sdf, torch.float32, plane),
            ("old_w", old_w, torch.float32, plane),
            ("old_color", old_color, torch.int32, plane),
            ("old_wc", old_wc, torch.float32, plane),
            ("w2c", pose, torch.float32, (3, 4))):
        kernels.check_tensor(k, name, t, dtype, shape)
    if any(t.data_ptr() % 8 for t in (old_sdf, old_w, old_color, old_wc)):
        raise ValueError("integrate_f32_cuda: the old sdf, weight, colour and "
                         "colour weight planes must be 8-byte aligned (read "
                         "as 8-byte words)")
    new_f, new_w, new_wc = (torch.empty_like(old_sdf) for _ in range(3))
    new_c = old_sdf.new_empty((V, BLOCK_VOL, 3))
    if V == 0:
        return new_f, new_w, new_c, new_wc
    err = k.fn(depth.data_ptr(), rgb_packed.data_ptr(), keys.data_ptr(),
               valid.data_ptr(), old_sdf.data_ptr(), old_w.data_ptr(),
               old_color.data_ptr(), old_wc.data_ptr(), new_f.data_ptr(),
               new_w.data_ptr(), new_c.data_ptr(), new_wc.data_ptr(),
               pose.data_ptr(), V, W, H, float(fx), float(fy), float(cx),
               float(cy), float(voxel_size), float(mu), int(max_w),
               kernels.stream_ptr())
    k.launches += 1
    kernels.check(k, err)
    return new_f, new_w, new_c, new_wc


def _integrate_f32_route(depth, rgb_packed, keys, ptrs, state, color,
                         summary, w2c, fx, fy, cx, cy, voxel_size, mu,
                         max_w) -> None:
    """The JAX package's route for frames above the packed budget
    (`integrate_blocks_packed`, integrate_pallas.py:427-451): unpack every
    row to f32 planes, run `integrate_blocks` with the integration rows
    (ptrs >= 0) valid, repack (sdf round(clip(f) * 32767), colour
    clip(c * 255 + 0.5)), build the summary rows and write the integration
    rows' three back into the pool in place, in fixed shapes."""
    H, W = depth.shape
    sel = ptrs >= 0
    rows = torch.where(sel, ptrs, 0).to(torch.int64)
    st = state[rows]
    new_f, new_w, new_c, new_wc = integrate_blocks(
        depth, rgb_packed, keys, sel, state_sdf_f32(st),
        state_w_depth(st).to(torch.float32), color[rows],
        state_w_color(st).to(torch.float32), w2c, fx, fy, cx, cy, W, H,
        voxel_size, mu, max_w)
    set_rows(state, rows, pack_state(new_f, new_w, new_wc), sel)
    set_rows(color, rows, pack_rgb(new_c), sel)
    set_rows(summary, rows, _summary_rows(new_f, new_w), sel)


# ---------------------------------------------------------------------------
# narrow frames: the JAX package's XLA branch (bilinear colour, no window)
# ---------------------------------------------------------------------------

def _integrate_small_frame(vol, depth, rgb_packed, keys, ptrs, w2c, fx, fy,
                           cx, cy):
    """Frames narrower or shorter than two 32-px tiles: the JAX package
    runs its XLA branch there (nearest depth over the whole image, bilinear
    colour, integrate.py:442-528), on every device; so does the port, in
    plain torch on the card and on the CPU alike.  Both round the same:
    the camera point is summed term by term (a matmul may sum in another
    order on the card) and every division is by a device tensor."""
    p = vol.params
    H, W = depth.shape
    sel = ptrs >= 0
    rows = torch.where(sel, ptrs, 0).to(torch.int64)
    dev = depth.device
    bx, by, bz = (c.to(torch.float32) * BLOCK for c in vhash.unpack(keys))
    lin = torch.arange(BLOCK_VOL, device=dev)
    px = (bx[:, None] + (lin % BLOCK).to(torch.float32)) * p.voxel_size
    py = (by[:, None] + ((lin // BLOCK) % BLOCK).to(torch.float32)) * p.voxel_size
    pz = (bz[:, None] + (lin // (BLOCK * BLOCK)).to(torch.float32)) * p.voxel_size
    R, t = w2c[:3, :3], w2c[:3, 3]
    z = R[2, 0] * px + R[2, 1] * py + R[2, 2] * pz + t[2]
    u = fx * (R[0, 0] * px + R[0, 1] * py + R[0, 2] * pz + t[0]) / z + cx
    v = fy * (R[1, 0] * px + R[1, 1] * py + R[1, 2] * pz + t[1]) / z + cy
    # device-tensor divisors: on CUDA torch multiplies by the reciprocal of
    # a host scalar, where the JAX package divides
    mu_d, c255 = (torch.full((), x, dtype=torch.float32, device=dev)
                  for x in (p.mu, 255.0))
    in_img = (z > 0) & (u >= 1) & (u <= W - 2) & (v >= 1) & (v <= H - 2)
    uc = u.nan_to_num(0).clamp(-1e7, 1e7)
    vc = v.nan_to_num(0).clamp(-1e7, 1e7)
    ui = torch.round(uc).to(torch.int64).clamp(0, W - 1)
    vi = torch.round(vc).to(torch.int64).clamp(0, H - 1)
    d_meas = depth[vi, ui]
    eta = d_meas - z
    eta_mu = eta / mu_d
    update = in_img & (d_meas > 0) & (eta >= -p.mu)
    st = vol.state[rows]
    old_f = state_sdf_f32(st)
    old_w = state_w_depth(st).to(torch.float32)
    new_f = torch.where(update, (old_w * old_f + torch.clamp(eta_mu, max=1.0))
                        / (old_w + 1.0), old_f)
    new_w = torch.where(update, torch.clamp(old_w + 1.0, max=float(p.max_w)), old_w)
    cu = update & (eta <= p.mu) & (eta_mu.abs() < 0.25)
    u0 = torch.floor(uc).to(torch.int64).clamp(0, W - 2)
    v0 = torch.floor(vc).to(torch.int64).clamp(0, H - 2)
    du = (uc - u0).clamp(0.0, 1.0)
    dv = (vc - v0).clamp(0.0, 1.0)

    def tap(vv, uu, wgt):
        # each corner's weight is the product of its two, as the JAX
        # package weights it
        return unpack_rgb(rgb_packed[vv, uu]) / c255 * wgt[..., None]

    c_meas = (tap(v0, u0, (1 - du) * (1 - dv)) + tap(v0, u0 + 1, du * (1 - dv))
              + tap(v0 + 1, u0, (1 - du) * dv) + tap(v0 + 1, u0 + 1, du * dv))
    old_c = unpack_rgb(vol.color[rows]) / c255
    old_wc = state_w_color(st).to(torch.float32)
    new_c = torch.where(cu[..., None], (old_c * old_wc[..., None] + c_meas)
                        / (old_wc[..., None] + 1.0), old_c)
    new_wc = torch.where(cu, torch.clamp(old_wc + 1.0, max=float(p.max_w)), old_wc)
    set_rows(vol.state, rows, pack_state(new_f, new_w, new_wc), sel)
    set_rows(vol.color, rows, pack_rgb(new_c), sel)
    set_rows(vol.summary, rows, _summary_rows(new_f, new_w), sel)


def _intrinsics(K) -> tuple[float, float, float, float]:
    Kf = [[float(x) for x in r] for r in (K.tolist() if torch.is_tensor(K) else K)]
    return Kf[0][0], Kf[1][1], Kf[0][2], Kf[1][2]


def frame_candidates(params, depth: torch.Tensor, c2w: torch.Tensor, K) -> torch.Tensor:
    """The frame's raw block-candidate stream (`alloc_candidates` with the
    volume's settings), before any shard mask or dedup."""
    fx, fy, cx, cy = _intrinsics(K)
    p = params
    return alloc_candidates(depth, c2w, fx, fy, cx, cy, p.voxel_size, p.mu,
                            p.frustum_min, p.frustum_max, p.alloc_steps,
                            stride=p.alloc_stride)


def shard_owner(keys: torch.Tensor, shard_n: int) -> torch.Tensor:
    """The space shard that owns each packed key (parallel/spatial.py).
    Ownership takes hash bits above the table index (>> 21, clear of the
    default 2^21 table's index bits): low bits would make every key of
    shard s hash to a home slot = s (mod S) and leave each shard table only
    H/S reachable home slots.  The bits equal the JAX package's, whose
    int32 product wraps where the port masks an int64 one."""
    return (vhash.hash_packed(keys, 1 << 30) >> 21) % shard_n


def fuse_frame(vol: TsdfVolume, depth: torch.Tensor, rgb: torch.Tensor,
               c2w: torch.Tensor, K, frame_idx: int | None = None,
               shard_sid: int | None = None, shard_n: int = 1,
               cand: torch.Tensor | None = None) -> TsdfVolume:
    """One frame of allocation + integration, updating `vol` in place
    (the JAX version returns a new volume; here the pools are written in
    place and the same object is returned).  With `frame_idx` (host
    swapping on) every row of the integration set gets it as its
    `last_seen` stamp, on every route; without it `last_seen` is not
    touched.  With `shard_n` > 1 `vol` is space shard `shard_sid`: the
    candidates another shard owns are dropped before dedup.  `cand` is the
    frame's `frame_candidates` when the caller has them already (the
    sharded fusion computes them once for every shard)."""
    p = vol.params
    if cand is None:
        cand = frame_candidates(p, depth, c2w, K)
    if shard_n > 1:
        cand = torch.where((shard_owner(cand, shard_n) == shard_sid)
                           & (cand != vhash.EMPTY), cand, vhash.EMPTY)
    cand = vhash.dedup_candidates(cand, p.alloc_candidate_cap)
    vol.n_blocks, cand_ptrs = vhash.insert(
        vol.table_keys, vol.table_ptrs, vol.n_blocks, vol.block_coords, cand,
        p.max_probes, p.block_capacity, claim_rounds=2)
    # the valid candidates are a prefix (dedup parks EMPTY keys last); the
    # integration set is that prefix, capped at the visible capacity
    n_cand = int((cand != vhash.EMPTY).sum())
    vol.n_visible = n_cand
    V = min(p.visible_capacity, p.alloc_candidate_cap, n_cand)
    ptrs = cand_ptrs[:V].contiguous()
    _integrate_set(vol, depth, rgb, c2w, K, cand[:V].contiguous(), ptrs)
    if frame_idx is not None:
        vol.last_seen[ptrs[ptrs >= 0].to(torch.int64)] = frame_idx
    return vol


def _integrate_set(vol: TsdfVolume, depth, rgb, c2w, K, keys, ptrs) -> None:
    """The per-block update of the integration set (`keys`, their pool rows
    `ptrs`, -1 for a row not to integrate) by the frame's route."""
    p = vol.params
    fx, fy, cx, cy = _intrinsics(K)
    H, W = depth.shape
    w2c = pose_inv(c2w)
    rgb_packed = pack_rgb(rgb)
    if W < WIN or H < WIN:
        _integrate_small_frame(vol, depth, rgb_packed, keys, ptrs, w2c,
                               fx, fy, cx, cy)
    else:
        integrate_blocks_packed(depth.contiguous(), rgb_packed.contiguous(),
                                keys, ptrs, vol.state, vol.color, vol.summary,
                                w2c, fx, fy, cx, cy, p.voxel_size, p.mu, p.max_w)


def static_rows(params, height: int, width: int) -> int:
    """The integration rows of `fuse_frame_static` for a height x width
    frame: the visible capacity, or the frame's whole deduplicated
    candidate list when that is shorter."""
    p = params
    n_stream = (height // p.alloc_stride) * (width // p.alloc_stride) * 2 * p.alloc_steps
    return min(p.visible_capacity, p.alloc_candidate_cap, n_stream)


def fuse_frame_static(vol: TsdfVolume, depth: torch.Tensor, rgb: torch.Tensor,
                      c2w: torch.Tensor, K, n_blocks: torch.Tensor,
                      bilateral: bool = False) -> torch.Tensor:
    """`fuse_frame` in fixed shapes, reading nothing back to the host: the
    body of the chunked gt fusion and of the tracked megastep, which a CUDA
    graph captures.  `n_blocks` is the volume's allocated count as a 0-d
    int64 device tensor, updated in place (`vol.n_blocks` is left to the
    caller, which reads the count once per chunk); `K` stays host numpy.
    With `bilateral` the depth is filtered first.

    The integration set has `static_rows` rows whatever the frame's count:
    the rows past the frame's candidates hold EMPTY with pool row -1, which
    the integrate kernels return on at once and the plain versions compute
    and do not write, so the volume is `fuse_frame`'s bit for bit.
    Returns the frame's candidate count (`vol.n_visible`) on the device."""
    p = vol.params
    if bilateral:
        depth = bilateral_filter_depth(depth)
    cand = vhash.dedup_candidates(frame_candidates(p, depth, c2w, K),
                                  p.alloc_candidate_cap)
    nb, cand_ptrs = vhash.insert_static(
        vol.table_keys, vol.table_ptrs, n_blocks, vol.block_coords, cand,
        p.max_probes, p.block_capacity, claim_rounds=2)
    n_blocks.copy_(nb)
    V = static_rows(p, *depth.shape)
    _integrate_set(vol, depth, rgb, c2w, K, cand[:V].contiguous(),
                   cand_ptrs[:V].contiguous())
    return (cand != vhash.EMPTY).sum()
