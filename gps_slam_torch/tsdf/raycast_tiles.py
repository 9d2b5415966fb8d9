"""Tile-based TSDF raycaster — the port of gps_slam_tpu/tsdf/raycast_tiles.py
(`_tile_bins`) and of the output-map assembly of
gps_slam_tpu/tsdf/raycast_pallas.py (`raycast`, `raycast_batch`).

Candidate binning stays plain tensor ops: surface blocks are projected,
expanded to (block, tile) pairs and sorted by (tile, quantized depth), so
each 16x16 tile gets its LB nearest candidate blocks.  The per-pixel march
over those candidates is the CUDA kernel `raycast_cuda`
(csrc/raycast.cu) on the card and `march_plain` on the CPU.  Both read the
sdf, mip and colour rows straight from the pool by block id.

Semantics are those of the TPU kernel `raycast_pallas._kernel`: ranking at
2x2-pixel-quad resolution (blocks with a negative mip sample first by
ray-entry depth, then dips below NEAR by their minimum), refinement of the
best `k_blocks` candidates with `s_refine` trilinear samples + a virtual
entry crossing + a secant step, and block-level confidence (the winning
block's max weight + 1).  The tracking-prepare raycast runs the march's
tracking mode (`TRACK`), which ranks per pixel and brackets in two stages
as the JAX XLA march does.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .. import kernels
from ..utils.se3 import pose_inv, sobel_normals
from ..utils.static_shape import nonzero_static
from . import hash as vhash
from .volume import BLOCK, TsdfVolume

TILE = 16
P = TILE * TILE
NEAR = 0.9
N_OUT = 6   # march output channels: t*, confidence, r, g, b, found
COUNTS = ("n_tile_overflow", "n_visible")  # the map dict's host ints
# The tracking mode of the march: the tracking-prepare raycast of both
# tracked routes.  It takes the JAX XLA march's semantics
# (gps_slam_tpu/tsdf/raycast_tiles.py `raycast`, the march under which the
# JAX package meets its own tracking gates) on the points where the TPU
# kernel departs from it: blocks ranked and picked per pixel, not per 2x2
# quad ("pixel_rank"); a pixel's hit kept where any of its own blocks
# dipped below NEAR, not its quad's ("pixel_cand": with per-pixel picks,
# each of which dipped below NEAR, it never masks a hit); two stages
# (a first over the mip bracket widened by 1.25 / 0.25 coarse spacings,
# then one over the sample pair it found) in place of one widened by
# 1.5 / 0.5 ("two_stage").  It refines TRACK_K_BLOCKS picks, the XLA
# march's default.
TRACK = frozenset({"pixel_rank", "pixel_cand", "two_stage"})
TRACK_K_BLOCKS = 2


def pool_prefix(n_blocks: int, capacity: int) -> int:
    """The static block prefix that a window megastep's raycasts bin: the
    smallest power of two from 2^14 that covers the allocated blocks,
    capped at the pool's capacity (the JAX engine's `_pool_prefix` bucket,
    on the port's exact block count).  Rows past `n_blocks` hold the
    initial summary and are never surface blocks."""
    b = 1 << 14
    while b < n_blocks and b < capacity:
        b <<= 1
    return min(b, capacity)


def _tile_bins(vol: TsdfVolume, w2c, fx, fy, cx, cy, width, height,
               vis_cap: int, lb: int, span_cap: int, prefix: int | None = None):
    """Per-tile candidate block lists.  Returns (gids int32 [T, LB] with
    -1 for empty slots, n_overflow, n_visible): the surface blocks in
    depth range number n_visible, of which the first vis_cap in pool order
    are binned.  With a static block `prefix` (`pool_prefix`, the window
    megastep) every shape is fixed and nothing is read back to the host:
    the first vis_cap surface blocks of the prefix, padded with empty rows,
    give the same lists, and the counts are device scalars."""
    p = vol.params
    dev = vol.device
    tw = -(-width // TILE)
    th = -(-height // TILE)
    T = tw * th
    static = prefix is not None
    B = prefix if static else vol.n_blocks
    ext = p.voxel_size * BLOCK
    summ = vol.summary[:B]
    surf = (summ[:, 65] > 0) & (summ[:, 64] < 0.99)
    bx, by, bz = vhash.unpack(vol.block_coords[:B])
    corner = torch.stack([bx, by, bz], -1).to(torch.float32) * ext
    center = corner + 0.5 * ext
    cc = center @ w2c[:3, :3].T + w2c[:3, 3]
    zc = cc[:, 2]
    radius = 0.87 * ext
    surf = surf & (zc > p.frustum_min - radius) & (zc < p.frustum_max + radius)
    if static:
        vis_idx = nonzero_static(surf, vis_cap, B)
        row_ok = vis_idx < B
        vis_idx = torch.where(row_ok, vis_idx, 0)
    else:
        vis_idx = torch.nonzero(surf)[:, 0][:vis_cap]
        if vis_idx.shape[0] == 0:
            return torch.full((T, lb), -1, dtype=torch.int32, device=dev), 0, 0

    # the 8 corner offsets (x, y, z in {0, 1}, x slowest), made on the device
    c8 = torch.arange(8, device=dev)
    offs = torch.stack([c8 >> 2, (c8 >> 1) & 1, c8 & 1], -1).to(torch.float32) * ext
    pts = corner[vis_idx][:, None, :] + offs[None]
    pc = pts @ w2c[:3, :3].T + w2c[:3, 3]
    z = pc[..., 2]
    behind = z <= 1e-6
    zsafe = torch.where(behind, 1.0, z)
    u = fx * pc[..., 0] / zsafe + cx
    v = fy * pc[..., 1] / zsafe + cy
    u = torch.where(behind, torch.where(pc[..., 0] >= 0, 1e6, -1e6), u)
    v = torch.where(behind, torch.where(pc[..., 1] >= 0, 1e6, -1e6), v)
    u0 = torch.floor(u.amin(1) / TILE)
    u1 = torch.floor(u.amax(1) / TILE)
    v0 = torch.floor(v.amin(1) / TILE)
    v1 = torch.floor(v.amax(1) / TILE)
    on_screen = (u1 >= 0) & (u0 <= tw - 1) & (v1 >= 0) & (v0 <= th - 1)
    vmask = on_screen & (z > p.frustum_min).any(1)
    if static:
        vmask = vmask & row_ok
    u0 = u0.clamp(0, tw - 1).to(torch.int64)
    u1 = u1.clamp(0, tw - 1).to(torch.int64)
    v0 = v0.clamp(0, th - 1).to(torch.int64)
    v1 = v1.clamp(0, th - 1).to(torch.int64)
    span_x = torch.clamp(u1 - u0 + 1, max=span_cap)
    span_y = torch.clamp(v1 - v0 + 1, max=span_cap)
    span_overflow = vmask & (((u1 - u0 + 1) > span_cap) | ((v1 - v0 + 1) > span_cap))

    slot = torch.arange(span_cap * span_cap, device=dev)
    dx = slot % span_cap
    dy = slot // span_cap
    ok = vmask[:, None] & (dx[None] < span_x[:, None]) & (dy[None] < span_y[:, None])
    tile_id = torch.where(ok, (v0[:, None] + dy[None]) * tw + u0[:, None] + dx[None], T)
    zv = zc[vis_idx]
    if T < 4096:
        # tile id | 20-bit quantized block depth (the JAX combined key)
        zq = torch.clamp(zv / p.frustum_max * ((1 << 20) - 1), 0,
                         (1 << 20) - 1).to(torch.int64)
    else:
        # wide images: the JAX path sorts by the raw f32 depth bits
        zq = torch.clamp(zv, min=0.0).view(torch.int32).to(torch.int64)
    key = (tile_id << 32) | zq[:, None]
    order = torch.sort(key.reshape(-1), stable=True).indices
    tiles_s = tile_id.reshape(-1)[order]
    gids_s = vis_idx[:, None].expand(-1, slot.shape[0]).reshape(-1)[order]
    if static:
        # tiles_s is sorted: each tile's pairs start where it is first found
        bounds = torch.searchsorted(tiles_s, torch.arange(T + 1, device=dev))
        start, counts = bounds[:T], bounds[1:] - bounds[:T]
    else:
        counts = torch.bincount(tiles_s, minlength=T + 1)[:T]
        start = torch.cumsum(counts, 0) - counts
    l = torch.arange(lb, device=dev)
    idx = (start[:, None] + l[None]).clamp(max=gids_s.shape[0] - 1)
    gids = torch.where(l[None] < counts[:, None], gids_s[idx],
                       -1).to(torch.int32)
    counts2 = torch.stack([torch.clamp(counts - lb, min=0).sum() + span_overflow.sum(),
                           surf.sum()])
    n_overflow, n_visible = counts2 if static else counts2.tolist()
    return gids.contiguous(), n_overflow, n_visible


# ---------------------------------------------------------------------------
# the march (K3)
# ---------------------------------------------------------------------------

def _pixel_dirs(tiles: torch.Tensor, tw: int, cam: dict):
    """World ray directions (camera z = 1) of every pixel of `tiles`,
    each [n, P]."""
    R = cam["R"]
    tx0 = (tiles % tw).to(torch.float32) * TILE
    ty0 = (tiles // tw).to(torch.float32) * TILE
    pp = torch.arange(P, device=tiles.device)
    px = tx0[:, None] + (pp % TILE).to(torch.float32)[None] + 0.5
    py = ty0[:, None] + (pp // TILE).to(torch.float32)[None] + 0.5
    # divide by a device tensor, not a Python scalar: on CUDA, torch turns
    # division by a host scalar into multiplication by its reciprocal,
    # which rounds differently from the kernel's (and the CPU's) division
    dirx = (px - cam["cx"]) / torch.full_like(px, cam["fx"])
    diry = (py - cam["cy"]) / torch.full_like(py, cam["fy"])
    return tuple(dirx * R[a, 0] + diry * R[a, 1] + R[a, 2] for a in range(3))


def _hat2(l: torch.Tensor, n: int):
    """The two non-zero taps of the hat weights max(0, 1 - |l - i|),
    i = 0..n-1, for l in [0, n-1]: (i0, i1, w0, w1) with i1 clamped (its
    weight is 0 when it would fall off the grid)."""
    i0f = torch.floor(l)
    w0 = torch.clamp(1.0 - (l - i0f).abs(), min=0.0)
    w1 = torch.clamp(1.0 - (l - (i0f + 1.0)).abs(), min=0.0)
    i0 = i0f.to(torch.int64)
    ok1 = i0 + 1 <= n - 1
    return i0, torch.where(ok1, i0 + 1, i0), w0, torch.where(ok1, w1, 0.0)


def _trilinear(grid: torch.Tensor, lx, ly, lz, n: int):
    """Trilinear read of `grid` [..., n^3] (cell x + n*y + n^2*z) at local
    coords of the same leading shape, summed x first, then y, then z,
    two taps per axis."""
    xs, ys, zs = _hat2(lx, n), _hat2(ly, n), _hat2(lz, n)
    acc_z = None
    for iz, wz in ((zs[0], zs[2]), (zs[1], zs[3])):
        acc_y = None
        for iy, wy in ((ys[0], ys[2]), (ys[1], ys[3])):
            base = iy * n + iz * n * n
            a = torch.gather(grid, -1, base + xs[0]) * xs[2]
            b = torch.gather(grid, -1, base + xs[1]) * xs[3]
            row = (a + b) * wy
            acc_y = row if acc_y is None else acc_y + row
        term = acc_y * wz
        acc_z = term if acc_z is None else acc_z + term
    return acc_z


def _slab(bmins, dirs, ext, fmin, fmax):
    t0 = t1 = None
    for bmin, da in zip(bmins, dirs):
        ds = torch.where(da.abs() < 1e-9, 1e-9, da)
        ta = bmin / ds
        tb = (bmin + ext) / ds
        lo, hi = torch.minimum(ta, tb), torch.maximum(ta, tb)
        t0 = torch.clamp(lo, min=fmin) if t0 is None else torch.maximum(t0, lo)
        t1 = torch.clamp(hi, max=fmax) if t1 is None else torch.minimum(t1, hi)
    return t0, t1


def _coarse(tiles, gids, summary, block_coords, cam, tw, s_coarse,
            per_pixel: bool = False):
    """The coarse pass of the march over `tiles` (lists `gids` [n, LB]),
    at 2x2-pixel-quad resolution (R = 64 rays a tile, each the mean of
    its quad's four pixel directions), or per pixel (R = 256).  Returns
    the pixel directions (3 x [n, P]), the clamped block ids [n, LB], the
    block origins relative to the camera (3 x [n, LB], 1e9 for an empty
    slot), and per (slot, ray) [n, LB, R] the slab hit, the ranking key
    (inf where the block is no candidate), the first negative coarse
    sample and whether there is one, and per ray [n, R] whether any block
    dipped below NEAR."""
    dev = gids.device
    n, LB = gids.shape
    ext, inv_vox = cam["ext"], cam["inv_vox"]
    fmin, fmax = cam["fmin"], cam["fmax"]
    dxp, dyp, dzp = _pixel_dirs(tiles, tw, cam)                  # [n, P]
    valid = gids >= 0
    gsafe = gids.clamp(min=0).to(torch.int64)
    bxi, byi, bzi = vhash.unpack(block_coords[gsafe])
    t_cam = cam["t"]
    borg = [torch.where(valid, c.to(torch.float32) * ext - t_cam[a], 1e9)
            for a, c in enumerate((bxi, byi, bzi))]                 # [n, LB]
    mip = summary[gsafe, :64]                                       # [n, LB, 64]

    if per_pixel:
        dq = [dxp, dyp, dzp]
    else:
        # quad-resolution directions: mean of each 2x2 pixel quad
        q = torch.arange(64, device=dev)
        p0 = (q // 8) * 2 * TILE + (q % 8) * 2
        dq = [(((d[:, p0] + d[:, p0 + 1]) + d[:, p0 + TILE]) + d[:, p0 + TILE + 1]) * 0.25
              for d in (dxp, dyp, dzp)]                             # [n, 64]
    R = dq[0].shape[1]
    t0, t1 = _slab([b[:, :, None] for b in borg], [d[:, None, :] for d in dq],
                   ext, fmin, fmax)                                  # [n, LB, R]
    hit = t1 > t0
    minval = torch.full_like(t0, torch.inf)
    has_neg = torch.zeros_like(t0, dtype=torch.bool)
    cand = torch.zeros((n, R), dtype=torch.bool, device=dev)
    s_first = torch.zeros_like(t0)
    half = inv_vox * 0.5
    mip_b = mip[:, :, None, :].expand(n, LB, R, 64)
    for s in range(s_coarse):
        cs = (s + 0.5) / s_coarse
        ts = t0 + (t1 - t0) * cs
        lq = [torch.clamp((d[:, None, :] * ts - b[:, :, None]) * half - 0.5, 0.0, 3.0)
              for d, b in zip(dq, borg)]
        v = _trilinear(mip_b, *(l_[..., None] for l_ in lq), 4)[..., 0]
        neg = (v < 0.0) & hit
        s_first = torch.where(neg & ~has_neg, float(s), s_first)
        minval = torch.minimum(minval, torch.where(hit, v, torch.inf))
        has_neg = has_neg | neg
        cand = cand | ((v < NEAR) & hit).any(1)
    key = torch.where(has_neg, t0 - 1e4,
                      torch.where(minval < NEAR, minval, torch.inf))  # [n, LB, R]
    return (dxp, dyp, dzp), gsafe, borg, hit, key, s_first, has_neg, cand


def _bracket(cube, dirs, bsel, lo, hi, fr, inv_vox, entry: bool):
    """Samples of the selected cube at the fractions `fr` of [lo, hi],
    after a virtual entry sample (lo, 1e-3) if `entry` (a block entered
    with sdf already below 0 hides a crossing in the seam before it):
    (found, t and sdf on both sides of the first crossing)."""
    ts_l = [lo + (hi - lo) * f for f in fr]
    vs_l = []
    for tq in ts_l:
        ls = [torch.clamp((d * tq - b) * inv_vox, 0.0, BLOCK - 1.0)
              for d, b in zip(dirs, bsel)]
        vs_l.append(_trilinear(cube, *(l_[..., None] for l_ in ls), BLOCK)[..., 0])
    if entry:
        ts_l = [lo] + ts_l
        vs_l = [torch.full_like(lo, 1e-3)] + vs_l
    fk = torch.zeros_like(lo, dtype=torch.bool)
    tlo = thi = vlo = vhi = torch.zeros_like(lo)
    for i in range(len(vs_l) - 1):
        cr = (~fk) & (vs_l[i] >= 0) & (vs_l[i] < 1e9) & (vs_l[i + 1] < 0)
        tlo = torch.where(cr, ts_l[i], tlo)
        thi = torch.where(cr, ts_l[i + 1], thi)
        vlo = torch.where(cr, vs_l[i], vlo)
        vhi = torch.where(cr, vs_l[i + 1], vhi)
        fk = fk | cr
    return fk, tlo, thi, vlo, vhi


def _march_chunk(tiles, gids, state, color, summary, block_coords, cam, tw,
                 s_coarse, s_refine, k_blocks, need_color, xla=frozenset()):
    dev = gids.device
    n, LB = gids.shape
    ext, inv_vox = cam["ext"], cam["inv_vox"]
    fmin, fmax = cam["fmin"], cam["fmax"]
    rank_px, cand_px = "pixel_rank" in xla, "pixel_cand" in xla
    passes = {px: _coarse(tiles, gids, summary, block_coords, cam, tw, s_coarse,
                          per_pixel=px) for px in {rank_px, cand_px}}
    (dxp, dyp, dzp), gsafe, borg, _, key, s_first, has_neg, _ = passes[rank_px]
    cand = passes[cand_px][7]
    maxw = torch.where(gids >= 0, summary[gsafe, 65], 0.0)

    quad_of_p = ((torch.arange(P, device=dev) // TILE) // 2) * 8 \
        + (torch.arange(P, device=dev) % TILE) // 2

    def to_px(x, px):   # [n, R] per quad or per pixel -> [n, P]
        return x if px else x[:, quad_of_p]

    found = torch.zeros((n, P), dtype=torch.bool, device=dev)
    t_star = torch.zeros((n, P), device=dev)
    win = torch.full((n, P), -1, dtype=torch.int64, device=dev)
    rows = torch.arange(n, device=dev)[:, None]
    fr = [(qq / (s_refine - 1)) for qq in range(s_refine)]
    dirs = (dxp, dyp, dzp)
    for _ in range(k_blocks):
        kmin = key.amin(1)                                           # [n, R]
        slot_r = torch.where(torch.isfinite(kmin), key.argmin(1), LB)
        key = torch.where(torch.arange(LB, device=dev)[None, :, None]
                          == slot_r[:, None, :], torch.inf, key)
        slot = to_px(slot_r, rank_px)                                # [n, P]
        has = slot < LB
        sl = slot.clamp(max=LB - 1)
        bsel = [torch.gather(b, 1, sl) for b in borg]                # [n, P]
        t0s, t1s = _slab(bsel, dirs, ext, fmin, fmax)
        t1s = torch.maximum(t1s, t0s)
        sr = slot_r.clamp(max=LB - 1)                                # [n, R]
        sf = to_px(torch.gather(s_first, 1, sr[:, None, :])[:, 0], rank_px)
        an = to_px(torch.gather(has_neg, 1, sr[:, None, :])[:, 0], rank_px) & has
        dt = (t1s - t0s) / s_coarse
        ts_neg = t0s + (sf + 0.5) * dt
        gsel = gsafe[rows, sl]                                       # [n, P]
        su = state[gsel] & 0xFFFF
        cube = torch.where(su >= 32768, su - 65536, su).to(torch.float32) \
            * (1.0 / 32767.0)                                        # [n, P, 512]
        if "two_stage" in xla:
            # the XLA march: a first stage over the mip bracket widened by
            # 1.25 / 0.25 coarse spacings (the whole segment without a
            # negative sample), then a second over the sample pair it found
            # (the whole segment if it found none)
            lo = torch.where(an, torch.maximum(ts_neg - 1.25 * dt, t0s), t0s)
            hi = torch.where(an, ts_neg + 0.25 * dt, t1s)
            f1, lo1, hi1, _, _ = _bracket(cube, dirs, bsel, lo, hi, fr, inv_vox, False)
            lo = torch.where(f1, lo1, t0s)
            hi = torch.where(f1, hi1, t1s)
        else:
            lo = torch.where(an, torch.maximum(ts_neg - 1.5 * dt, t0s), t0s)
            hi = torch.where(an, torch.minimum(ts_neg + 0.5 * dt, t1s), t1s)
        fk, tlo, thi, vlo, vhi = _bracket(cube, dirs, bsel, lo, hi, fr, inv_vox, True)
        denom = vlo - vhi
        alpha = torch.clamp(vlo / torch.where(denom.abs() < 1e-9, 1e-9, denom), 0.0, 1.0)
        tk = tlo + alpha * (thi - tlo)
        fk = fk & has
        better = fk & (~found | (tk < t_star))
        t_star = torch.where(better, tk, t_star)
        win = torch.where(better, sl, win)
        found = found | fk
    found = found & to_px(cand, cand_px)

    fm = found.to(torch.float32)
    out = torch.zeros((n, N_OUT, P), device=dev)
    wsafe = win.clamp(min=0)
    has_w = win >= 0
    conf = torch.where(has_w, torch.gather(maxw, 1, wsafe), 0.0)
    out[:, 0] = t_star * fm
    out[:, 1] = (conf + 1.0) * fm
    if need_color:
        bw = [torch.where(has_w, torch.gather(b, 1, wsafe), 0.0) for b in borg]
        ls = [torch.clamp((d * t_star - b) * inv_vox, 0.0, BLOCK - 1.0)
              for d, b in zip((dxp, dyp, dzp), bw)]
        cp = color[gsafe[rows, wsafe]]                               # [n, P, 512]
        for ch in range(3):
            cv = ((cp >> (8 * ch)) & 0xFF).to(torch.float32)
            val = _trilinear(cv, *(l_[..., None] for l_ in ls), BLOCK)[..., 0]
            out[:, 2 + ch] = torch.where(has_w, val, 0.0) * (1.0 / 255.0) * fm
    out[:, 5] = fm
    return out


def march_plain(gids, state, color, summary, block_coords, cam: dict, tw: int,
                s_coarse: int, s_refine: int, k_blocks: int,
                need_color: bool = True, tile_chunk: int = 128,
                xla=frozenset()) -> torch.Tensor:
    """Plain PyTorch version of `raycast_cuda`: gids [T, LB] (-1 = empty
    slot) -> out f32 [T, 6, P] = (t*, confidence, r, g, b, found), each
    masked by found.  `cam` holds fx, fy, cx, cy (floats), R (c2w rotation
    [3, 3]) and t (camera origin [3]) tensors, inv_vox, ext, fmin, fmax.
    `xla` names the points on which the march takes the JAX XLA march's
    semantics in place of the TPU kernel's (`TRACK`, the tracking mode,
    names them all)."""
    T = gids.shape[0]
    out = torch.empty((T, N_OUT, P), device=gids.device)
    for a in range(0, T, tile_chunk):
        b = min(T, a + tile_chunk)
        tiles = torch.arange(a, b, device=gids.device)
        out[a:b] = _march_chunk(tiles, gids[a:b], state, color, summary,
                                block_coords, cam, tw, s_coarse, s_refine,
                                k_blocks, need_color, xla)
    return out


MAX_LB = 32
MAX_REFINE = 16
MAX_TRACK_K = 4


def march(gids, state, color, summary, block_coords, cam: dict, tw: int,
          s_coarse: int, s_refine: int, k_blocks: int,
          need_color: bool = True, track: bool = False) -> torch.Tensor:
    """The per-tile march (see `march_plain`), in the tracking mode if
    `track`.  CPU tensors take the plain version; CUDA tensors launch
    `raycast_cuda` or raise."""
    if gids.device.type != "cuda":
        return march_plain(gids, state, color, summary, block_coords, cam, tw,
                           s_coarse, s_refine, k_blocks, need_color,
                           xla=TRACK if track else frozenset())
    T, LB = gids.shape
    B = state.shape[0]
    if not (1 <= LB <= MAX_LB and 2 <= s_refine <= MAX_REFINE and s_coarse >= 1
            and (not track or k_blocks <= MAX_TRACK_K)):
        raise ValueError(f"raycast_cuda: LB={LB} s_refine={s_refine} "
                         f"s_coarse={s_coarse} k_blocks={k_blocks} track={track} "
                         "out of the kernel's range")
    k = kernels.RAYCAST
    pose = kernels.pose_rows(torch.cat((cam["R"], cam["t"][:, None]), 1))
    for name, t, dtype, shape in (
            ("gids", gids, torch.int32, None), ("state", state, torch.int32, (B, 512)),
            ("color", color, torch.int32, (B, 512)),
            ("summary", summary, torch.float32, (B, 128)),
            ("block_coords", block_coords, torch.int32, (B,)),
            ("c2w", pose, torch.float32, (3, 4))):
        kernels.check_tensor(k, name, t, dtype, shape)
    if state.data_ptr() % 16:
        raise ValueError("raycast_cuda: state rows must be 16-byte aligned "
                         "(the kernel copies them with TMA)")
    out = torch.empty((T, N_OUT, P), dtype=torch.float32, device=gids.device)
    if T == 0:
        return out
    err = k.fn(gids.data_ptr(), state.data_ptr(), color.data_ptr(),
               summary.data_ptr(), block_coords.data_ptr(), pose.data_ptr(),
               out.data_ptr(), T, LB, tw, s_coarse, s_refine, k_blocks,
               int(need_color), int(track), float(cam["fx"]), float(cam["fy"]),
               float(cam["cx"]), float(cam["cy"]), float(cam["inv_vox"]),
               float(cam["ext"]), float(cam["fmin"]), float(cam["fmax"]),
               kernels.stream_ptr())
    k.launches += 1
    kernels.check(k, err)
    return out


# ---------------------------------------------------------------------------
# output maps
# ---------------------------------------------------------------------------

def _unpack_img(x: torch.Tensor, th: int, tw: int, height: int, width: int):
    """[T, P, *ch] tile-major -> [H, W, *ch] image."""
    ch = x.shape[2:]
    img = x.reshape(th, tw, TILE, TILE, *ch).transpose(1, 2)
    return img.reshape(th * TILE, tw * TILE, *ch)[:height, :width]


def raycast(vol: TsdfVolume, c2w, K, width: int, height: int, lb: int = 24,
            s_coarse: int = 4, s_refine: int = 8, k_blocks: int = 2,
            need_color: bool = True, need_normals: bool = True,
            prefix: int | None = None, track: bool = False) -> dict:
    """Raycast the volume from `c2w`; the same map dict as the JAX
    `raycast_pallas.raycast` (with `track`, the march's tracking mode:
    see `TRACK`).  A static block `prefix` bins in fixed shapes with
    device-scalar counts (`_tile_bins`); `K` is read on the host."""
    p = vol.params
    dev = vol.device
    c2w = torch.as_tensor(c2w, dtype=torch.float32, device=dev)
    Kl = K.tolist() if isinstance(K, np.ndarray) else torch.as_tensor(K).tolist()
    fx, fy, cx, cy = (float(Kl[0][0]), float(Kl[1][1]), float(Kl[0][2]),
                      float(Kl[1][2]))
    w2c = pose_inv(c2w)
    tw = -(-width // TILE)
    th = -(-height // TILE)
    T = tw * th
    gids, n_overflow, n_visible = _tile_bins(vol, w2c, fx, fy, cx, cy, width, height,
                                             p.visible_capacity, lb, span_cap=6,
                                             prefix=prefix)
    cam = {"fx": fx, "fy": fy, "cx": cx, "cy": cy, "R": c2w[:3, :3],
           "t": c2w[:3, 3], "inv_vox": 1.0 / p.voxel_size,
           "ext": p.voxel_size * BLOCK, "fmin": p.frustum_min,
           "fmax": p.frustum_max}
    out = march(gids, vol.state, vol.color, vol.summary, vol.block_coords, cam,
                tw, s_coarse, s_refine, k_blocks, need_color, track=track)
    t_star, conf, found = out[:, 0], out[:, 1], out[:, 5]
    dirs = torch.stack(_pixel_dirs(torch.arange(T, device=dev), tw, cam), -1)
    depth = t_star * found
    vertex = (c2w[:3, 3] + dirs * t_star[..., None]) * found[..., None]
    depth_img = _unpack_img(depth, th, tw, height, width)
    vertex_img = _unpack_img(vertex, th, tw, height, width)
    color_img = _unpack_img(out[:, 2:5].transpose(1, 2), th, tw, height, width)
    conf_img = _unpack_img(conf * found, th, tw, height, width)
    return {
        "vertex_map": vertex_img.contiguous(),
        "color_map": color_img.contiguous(),
        "confidence_map": conf_img[..., None].contiguous(),
        "depth_map": depth_img[..., None].contiguous(),
        "normal_map": (hit_normals(vertex_img, depth_img) if need_normals
                       else torch.zeros_like(vertex_img)),
        "n_tile_overflow": n_overflow,
        "n_visible": n_visible,
    }


def hit_normals(vertex_img: torch.Tensor, depth_img: torch.Tensor) -> torch.Tensor:
    """Sobel normals of the world vertex map [H, W, 3], kept where the 3x3
    neighbourhood of the depth map [H, W] is all hits.  The JAX package
    also zeroes every normal whose world-space z <= 0 (compute_normal_map's
    camera-depth test applied to world vertices), which drops a whole wall
    lying in the plane z = 0; the port keeps those normals (see
    ROADMAP.md, faults of the reference)."""
    normal_img = sobel_normals(vertex_img.contiguous())
    hit = (depth_img > 0).to(torch.float32)
    # 3x3 min-pool of the hit mask ('SAME', pad value 1)
    nb = -F.max_pool2d(-F.pad(hit[None, None], (1, 1, 1, 1), value=1.0),
                       3, stride=1)[0, 0]
    return torch.where(nb[..., None] > 0.5, normal_img, 0.0).contiguous()


def raycast_batch(vol: TsdfVolume, c2ws, K, width: int, height: int,
                  lb: int = 24, s_coarse: int = 4, s_refine: int = 8,
                  k_blocks: int = 2, need_normals: bool = False,
                  prefix: int | None = None) -> dict:
    """`raycast` over M poses, stacked [M, ...] (overflow counts summed,
    the largest visible count kept; device scalars with a static
    `prefix`)."""
    return stack_maps([raycast(vol, c2w, K, width, height, lb, s_coarse,
                               s_refine, k_blocks, need_normals=need_normals,
                               prefix=prefix)
                       for c2w in c2ws])


def stack_maps(outs: list[dict]) -> dict:
    """`raycast` map dicts -> one [M, ...] dict (overflow counts summed,
    the largest visible count kept)."""
    res = {k: torch.stack([o[k] for o in outs]) for k in outs[0]
           if k not in COUNTS}
    if torch.is_tensor(outs[0]["n_visible"]):   # device scalars: no host read
        res["n_tile_overflow"] = torch.stack([o["n_tile_overflow"] for o in outs]).sum()
        res["n_visible"] = torch.stack([o["n_visible"] for o in outs]).amax()
    else:
        res["n_tile_overflow"] = sum(o["n_tile_overflow"] for o in outs)
        res["n_visible"] = max(o["n_visible"] for o in outs)
    return res
