"""Plain TSDF fusion: the reference the benchmark holds the program's
fusion to.

Plain PyTorch, no import of the program.  A volume is a dict of tensors
over its allocated blocks, sorted by packed key: `keys` int64 [N], and per
voxel (x + 8 y + 64 z inside an 8^3 block) `sdf` int32 [N, 512] in
1/32767 of the truncation band mu, the depth and colour weights `w`, `wc`
int32 [N, 512] and `rgb` int32 [N, 512, 3] in 0..255.

Semantics, frame by frame, as the configuration states them:

  * allocation: each 2x2 pixel quad marches its largest and its smallest
    valid depth through the band [d - mu, d + mu] along its ray in
    `alloc_steps` samples; every block a sample falls in is a candidate;
    the unique candidates in key order, at most `alloc_candidate_cap`,
    are allocated; the first `visible_block_capacity` of them are
    integrated;
  * integration: each voxel of an integrated block projects into the
    frame and reads the depth and colour of its nearest pixel, if that
    pixel lies in the block's 64 x 64 pixel window (anchored at the 32 px
    tile pair of the block's least corner projection) and 1 px inside the
    image; eta = depth - z; where eta >= -mu the sdf takes the running
    average of min(eta / mu, 1) over weights capped at max_w; the colour
    takes the running average where |eta| < mu / 4, in 0..255 units.

`dtype` is the arithmetic of the geometry (float32 as the configuration
states; bfloat16 for the control).
"""

from __future__ import annotations

import torch

BLOCK = 8
VOX = BLOCK ** 3
SDF_SCALE = 32767.0
COORD_OFFSET = 512
PT = 32
WIN = 64


def pack_keys(bx, by, bz) -> torch.Tensor:
    """Signed block coordinates -> the 30-bit key (10 bits an axis, +512),
    which orders blocks as the configuration's key order does."""
    m = (1 << 10) - 1
    return (((bx.to(torch.int64) + COORD_OFFSET) & m)
            | (((by.to(torch.int64) + COORD_OFFSET) & m) << 10)
            | (((bz.to(torch.int64) + COORD_OFFSET) & m) << 20))


def unpack_keys(keys: torch.Tensor):
    m = (1 << 10) - 1
    return ((keys & m) - COORD_OFFSET, ((keys >> 10) & m) - COORD_OFFSET,
            ((keys >> 20) & m) - COORD_OFFSET)


def from_words(keys, state, color) -> dict:
    """A volume from packed words (sdf i16 | w_depth << 16 | w_color << 24,
    rgb888), sorted by key."""
    k = keys.to(torch.int64)
    order = torch.argsort(k)
    st, co = state[order].to(torch.int64), color[order].to(torch.int64)
    su = st & 0xFFFF
    return {"keys": k[order], "sdf": torch.where(su >= 32768, su - 65536, su).to(torch.int32),
            "w": ((st >> 16) & 0xFF).to(torch.int32), "wc": ((st >> 24) & 0xFF).to(torch.int32),
            "rgb": torch.stack([co & 0xFF, (co >> 8) & 0xFF, (co >> 16) & 0xFF],
                               -1).to(torch.int32)}


def empty(device) -> dict:
    i32 = dict(dtype=torch.int32, device=device)
    return {"keys": torch.zeros(0, dtype=torch.int64, device=device),
            "sdf": torch.zeros((0, VOX), **i32), "w": torch.zeros((0, VOX), **i32),
            "wc": torch.zeros((0, VOX), **i32), "rgb": torch.zeros((0, VOX, 3), **i32)}


def candidates(depth, c2w, K, p: dict, dtype=torch.float32) -> torch.Tensor:
    """Unique candidate keys of one frame, in key order, cut to
    alloc_candidate_cap."""
    dev = depth.device
    s = int(p["alloc_stride"])
    H, W = depth.shape
    Hs, Ws = (H // s) * s, (W // s) * s
    q = depth[:Hs, :Ws].reshape(Hs // s, s, Ws // s, s).to(dtype)
    z_max = q.amax(dim=(1, 3))
    z_min = torch.where(q > 0, q, torch.full_like(q, float("inf"))).amin(dim=(1, 3))
    z_min = torch.where(torch.isfinite(z_min), z_min, torch.zeros_like(z_min))
    fx, fy, cx, cy = (torch.tensor(float(v), dtype=dtype, device=dev)
                      for v in (K[0][0], K[1][1], K[0][2], K[1][2]))
    mu = torch.tensor(float(p["mu"]), dtype=dtype, device=dev)
    i = (torch.arange(z_max.shape[1], device=dev) * s).to(dtype)[None, :]
    j = (torch.arange(z_max.shape[0], device=dev) * s).to(dtype)[:, None]
    c2w = torch.as_tensor(c2w, device=dev).to(dtype)
    R, t = c2w[:3, :3], c2w[:3, 3]
    n = int(p["alloc_steps"])
    inv_block = 1.0 / (float(p["voxel_size"]) * BLOCK)
    keys = []
    for z in (z_max, z_min):
        valid = (z > 0) & ((z - mu) >= p["frustum_min"]) & ((z + mu) <= p["frustum_max"])
        x = z * (i - cx) / fx
        y = z * (j - cy) / fy
        norm = torch.clamp(torch.sqrt(x * x + y * y + z * z), min=1e-6)
        s0, s1 = 1.0 - mu / norm, 1.0 + mu / norm
        w = [R[r, 0] * x + R[r, 1] * y + R[r, 2] * z for r in range(3)]
        a = [(w[r] * s0 + t[r]) * inv_block for r in range(3)]
        d = [(w[r] * s1 + t[r]) * inv_block - a[r] for r in range(3)]
        for k in range(n):
            f = k / max(n - 1, 1)
            b = [torch.floor(a[r] + f * d[r]) for r in range(3)]
            ok = valid & (b[0].abs() <= 511) & (b[1].abs() <= 511) & (b[2].abs() <= 511)
            bi = [torch.clamp(v, -2048, 2048).to(torch.int64) for v in b]
            keys.append(pack_keys(*bi)[ok])
    cand = torch.unique(torch.cat(keys))      # sorted
    return cand[:int(p["alloc_candidate_cap"])]


def _allocate(vol: dict, new_keys: torch.Tensor) -> dict:
    fresh = new_keys[~torch.isin(new_keys, vol["keys"])]
    if fresh.numel() == 0:
        return vol
    n = fresh.numel()
    dev = fresh.device
    i32 = dict(dtype=torch.int32, device=dev)
    keys = torch.cat([vol["keys"], fresh])
    order = torch.argsort(keys)
    out = {"keys": keys[order]}
    for name, init in (("sdf", 32767), ("w", 0), ("wc", 0)):
        out[name] = torch.cat([vol[name], torch.full((n, VOX), init, **i32)])[order]
    out["rgb"] = torch.cat([vol["rgb"], torch.zeros((n, VOX, 3), **i32)])[order]
    return out


def _integrate(vol: dict, rows: torch.Tensor, keys: torch.Tensor, depth, rgb_u8q,
               c2w, K, p: dict, dtype) -> None:
    """The voxel update of blocks `keys` (volume rows `rows`), in place."""
    dev = depth.device
    H, W = depth.shape
    vs = float(p["voxel_size"])
    c2w = torch.as_tensor(c2w, device=dev).to(torch.float32)
    Rt = c2w[:3, :3].T
    w2c = torch.eye(4, device=dev)
    w2c[:3, :3] = Rt
    w2c[:3, 3] = -(Rt @ c2w[:3, 3])
    w2c = w2c.to(dtype)
    R, t = w2c[:3, :3], w2c[:3, 3]
    fx, fy, cx, cy = (float(v) for v in (K[0][0], K[1][1], K[0][2], K[1][2]))
    bx, by, bz = (c.to(dtype) * BLOCK for c in unpack_keys(keys))
    # the 64 x 64 window: anchored at the tile pair of the least corner projection
    ext = vs * BLOCK
    umin = torch.full_like(bx, float("inf"))
    vmin = torch.full_like(bx, float("inf"))
    for ox in (0.0, ext):
        for oy in (0.0, ext):
            for oz in (0.0, ext):
                px, py, pz = bx * vs + ox, by * vs + oy, bz * vs + oz
                zc = R[2, 0] * px + R[2, 1] * py + R[2, 2] * pz + t[2]
                zs = torch.clamp(zc, min=1e-6)
                umin = torch.minimum(umin, fx * (R[0, 0] * px + R[0, 1] * py + R[0, 2] * pz
                                                 + t[0]) / zs + cx)
                vmin = torch.minimum(vmin, fy * (R[1, 0] * px + R[1, 1] * py + R[1, 2] * pz
                                                 + t[1]) / zs + cy)
    tw, th = -(-W // PT), -(-H // PT)
    ax = torch.clamp(torch.floor(umin / PT), 0, tw - 2).to(torch.int64)
    ay = torch.clamp(torch.floor(vmin / PT), 0, th - 2).to(torch.int64)
    lin = torch.arange(VOX, device=dev)
    lx, ly, lz = ((lin % BLOCK).to(dtype), ((lin // BLOCK) % BLOCK).to(dtype),
                  (lin // (BLOCK * BLOCK)).to(dtype))
    px = (bx[:, None] + lx) * vs
    py = (by[:, None] + ly) * vs
    pz = (bz[:, None] + lz) * vs
    zc = R[2, 0] * px + R[2, 1] * py + R[2, 2] * pz + t[2]
    xc = R[0, 0] * px + R[0, 1] * py + R[0, 2] * pz + t[0]
    yc = R[1, 0] * px + R[1, 1] * py + R[1, 2] * pz + t[1]
    zs = torch.where(zc.abs() < 1e-9, torch.full_like(zc, 1e-9), zc)
    u = fx * xc / zs + cx
    v = fy * yc / zs + cy
    in_img = (zc > 0) & (u >= 1) & (u <= W - 2) & (v >= 1) & (v <= H - 2)
    ru = torch.round(u.float().clamp(-1e7, 1e7)).to(torch.int64)
    rv = torch.round(v.float().clamp(-1e7, 1e7)).to(torch.int64)
    iu, iv = ru - (ax * PT)[:, None], rv - (ay * PT)[:, None]
    in_win = (iu >= 0) & (iu < WIN) & (iv >= 0) & (iv < WIN)
    inside = in_win & (ru >= 0) & (ru < W) & (rv >= 0) & (rv < H)
    pix = rv.clamp(0, H - 1) * W + ru.clamp(0, W - 1)
    d = torch.where(inside, depth.reshape(-1)[pix].to(dtype), torch.zeros((), dtype=dtype,
                                                                          device=dev))
    c = torch.where(inside[..., None], rgb_u8q.reshape(-1, 3)[pix].to(torch.float32), 0.0)
    mu = float(p["mu"])
    max_w = float(p["max_w"])
    old_q = vol["sdf"][rows]
    old_f = (old_q.to(torch.float32) * (1.0 / SDF_SCALE)).to(dtype)
    old_w = vol["w"][rows].to(dtype)
    old_wc = vol["wc"][rows].to(torch.float32)
    eta = (d - zc)
    upd = in_img & in_win & (d > 0) & (eta >= -mu)
    eta_mu = eta / torch.full_like(eta, mu)
    obs = torch.clamp(eta_mu, max=1.0)
    new_f = torch.where(upd, (old_w * old_f + obs) / (old_w + 1.0), old_f).to(torch.float32)
    new_w = torch.where(upd, torch.clamp(old_w + 1.0, max=max_w), old_w)
    cu = upd & (eta <= mu) & (eta_mu.abs() < 0.25)
    oc = vol["rgb"][rows].to(torch.float32)
    nc = torch.where(cu[..., None], (oc * old_wc[..., None] + c) / (old_wc + 1.0)[..., None], oc)
    new_wc = torch.where(cu, torch.clamp(old_wc + 1.0, max=max_w), old_wc)
    vol["sdf"][rows] = torch.where(
        upd, torch.round(new_f.clamp(-1.0, 1.0) * SDF_SCALE).to(torch.int32), old_q)
    vol["w"][rows] = new_w.to(torch.int32)
    vol["wc"][rows] = new_wc.to(torch.int32)
    vol["rgb"][rows] = torch.clamp(nc + 0.5, 0.0, 255.0).to(torch.int32)


def fuse(vol: dict, depth, rgb, c2w, K, p: dict, dtype=torch.float32,
         chunk: int = 2048) -> tuple[dict, torch.Tensor]:
    """One frame (depth f32 [H, W] m, rgb f32 [H, W, 3] in [0, 1]) at pose
    c2w into `vol`.  Returns the volume and the keys it integrated."""
    cand = candidates(depth, c2w, K, p, dtype)
    vol = _allocate(vol, cand)
    V = min(int(p["visible_capacity"]), int(p["alloc_candidate_cap"]), cand.numel())
    keys = cand[:V]
    rows = torch.searchsorted(vol["keys"], keys)
    q = torch.clamp(rgb * 255.0 + 0.5, 0, 255).to(torch.int32)
    for a in range(0, V, chunk):
        _integrate(vol, rows[a:a + chunk], keys[a:a + chunk], depth, q, c2w, K, p, dtype)
    return vol, keys
