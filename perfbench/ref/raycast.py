"""Plain TSDF ray casting: the reference the benchmark holds the
program's raycasts to.

Plain PyTorch, no import of the program.  The volume is `ref.fusion`'s
dict.  The configuration's tile raycaster (TPU.raycast_lb blocks a tile,
raycast_samples coarse samples, raycast_bisect refinement samples), as
it states it:

  * blocks: every allocated block with an observed voxel whose least
    observed sdf is below 0.99 and whose centre lies in the depth range
    (padded by 0.87 of a block) is a surface block; the first
    `visible_capacity` of them are binned.  Each is projected by its 8
    corners onto the 16 x 16 px tiles of its bounding box (at most 6 x 6
    tiles from its least corner), and each tile keeps its `lb` nearest
    blocks by the quantised camera depth of their centres;
  * ranking: each block of a tile is sampled at `s_coarse` points of its
    slab along a ray, trilinear over the block's 4^3 mip of 2x2x2 sdf
    means; a block with a negative sample ranks first, by its entry
    depth, then blocks that dip below 0.9, by their least sample.  The
    window raycast ranks per 2x2 pixel quad (the mean of its four
    rays) and keeps a hit where a block of the quad dipped below 0.9;
    the tracking raycast ranks per pixel;
  * refinement: the best `k_blocks` blocks of a ray are sampled
    `s_refine` times across a bracket around their first negative mip
    sample (1.5 / 0.5 coarse spacings before / after it; the tracking
    raycast two stages, 1.25 / 0.25, then the pair found), after a
    virtual entry sample of sdf 1e-3, trilinear over the block's voxels;
    the first crossing to a negative sdf is refined by one secant step;
    the nearest crossing over the refined blocks is the hit;
  * colour: the hit block's colour, trilinear; tracking normals: Sobel
    gradients of the vertex map, kept where the 3 x 3 neighbourhood all
    hit.

Rays leave the camera through pixel centres (u + 0.5, v + 0.5) and are
parametrised by camera depth.  Blocks of equal quantised depth keep key
order (the program's pool order is its own).  `dtype` is the arithmetic
of the sdf samples (float32 as the configuration states; bfloat16 for
the control).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import fusion as rfusion

BLOCK = rfusion.BLOCK
TILE = 16
P = TILE * TILE
NEAR = 0.9
SPAN = 6


def summary(vol: dict) -> dict:
    """Per block: the 4^3 mip of 2x2x2 sdf means [N, 64] (x + 4 y + 16 z),
    the least sdf over observed voxels and the largest depth weight."""
    f = vol["sdf"].to(torch.float32) * (1.0 / rfusion.SDF_SCALE)
    mip = f.reshape(-1, 4, 2, 4, 2, 4, 2).mean(dim=(2, 4, 6)).reshape(-1, 64)
    w = vol["w"]
    least = torch.where(w > 0, f, torch.ones_like(f)).amin(1)
    return {"mip": mip, "least": least, "maxw": w.amax(1).to(torch.float32)}


def _inverse(c2w: torch.Tensor):
    R = c2w[:3, :3].T
    return R, -(R[:, 0] * c2w[0, 3] + R[:, 1] * c2w[1, 3] + R[:, 2] * c2w[2, 3])


def tile_lists(vol: dict, summ: dict, c2w, K, width: int, height: int, p: dict,
               lb: int) -> torch.Tensor:
    """Per tile its `lb` nearest candidate blocks (volume rows, -1 empty),
    [T, lb]."""
    dev = vol["keys"].device
    tw, th = -(-width // TILE), -(-height // TILE)
    T = tw * th
    R, t = _inverse(c2w)
    fx, fy, cx, cy = (float(v) for v in (K[0][0], K[1][1], K[0][2], K[1][2]))
    ext = float(p["voxel_size"]) * BLOCK
    fmin, fmax = float(p["frustum_min"]), float(p["frustum_max"])
    corner = torch.stack(rfusion.unpack_keys(vol["keys"]), -1).to(torch.float32) * ext
    zc = (corner + 0.5 * ext) @ R[2] + t[2]
    surf = ((summ["maxw"] > 0) & (summ["least"] < 0.99)
            & (zc > fmin - 0.87 * ext) & (zc < fmax + 0.87 * ext))
    rows = torch.nonzero(surf)[:, 0][:int(p["visible_capacity"])]
    if rows.numel() == 0:
        return torch.full((T, lb), -1, dtype=torch.int64, device=dev)
    c8 = torch.arange(8, device=dev)
    offs = torch.stack([c8 >> 2, (c8 >> 1) & 1, c8 & 1], -1).to(torch.float32) * ext
    pc = (corner[rows][:, None] + offs) @ R.T + t                   # [n, 8, 3]
    z = pc[..., 2]
    behind = z <= 1e-6
    zs = torch.where(behind, torch.ones_like(z), z)
    far = lambda c: torch.where(c >= 0, 1e6, -1e6)  # noqa: E731
    u = torch.where(behind, far(pc[..., 0]), fx * pc[..., 0] / zs + cx)
    v = torch.where(behind, far(pc[..., 1]), fy * pc[..., 1] / zs + cy)
    u0, u1 = torch.floor(u.amin(1) / TILE), torch.floor(u.amax(1) / TILE)
    v0, v1 = torch.floor(v.amin(1) / TILE), torch.floor(v.amax(1) / TILE)
    seen = (u1 >= 0) & (u0 <= tw - 1) & (v1 >= 0) & (v0 <= th - 1) & (z > fmin).any(1)
    u0, u1 = u0.clamp(0, tw - 1).long(), u1.clamp(0, tw - 1).long()
    v0, v1 = v0.clamp(0, th - 1).long(), v1.clamp(0, th - 1).long()
    sx, sy = (u1 - u0 + 1).clamp(max=SPAN), (v1 - v0 + 1).clamp(max=SPAN)
    s = torch.arange(SPAN * SPAN, device=dev)
    dx, dy = s % SPAN, s // SPAN
    ok = seen[:, None] & (dx < sx[:, None]) & (dy < sy[:, None])
    tile = ((v0[:, None] + dy) * tw + u0[:, None] + dx)[ok]
    blk = rows[:, None].expand(-1, s.numel())[ok]
    zr = zc[blk]
    if T < 4096:
        zq = torch.clamp(zr / fmax * ((1 << 20) - 1), 0, (1 << 20) - 1).long()
    else:
        zq = torch.clamp(zr, min=0.0).view(torch.int32).long()
    # nearest first; equal depths in key order (blk ascends, the sort is stable)
    order = torch.sort((tile << 32) | zq, stable=True).indices
    tile, blk = tile[order], blk[order]
    rank = torch.arange(tile.numel(), device=dev) - torch.searchsorted(tile, tile)
    keep = rank < lb
    out = torch.full((T, lb), -1, dtype=torch.int64, device=dev)
    out[tile[keep], rank[keep]] = blk[keep]
    return out


def _lerp_taps(l: torch.Tensor, n: int):
    i0f = torch.floor(l)
    w0 = torch.clamp(1.0 - (l - i0f).abs(), min=0.0)
    w1 = torch.clamp(1.0 - (l - i0f - 1.0).abs(), min=0.0)
    i0 = i0f.long()
    on = i0 + 1 <= n - 1
    return i0, torch.where(on, i0 + 1, i0), w0, torch.where(on, w1, torch.zeros_like(w1))


def trilinear(grid: torch.Tensor, lx, ly, lz, n: int):
    """grid [..., n^3] (x + n y + n^2 z) at local coordinates of the
    leading shape, x summed first, then y, then z."""
    tx, ty, tz = _lerp_taps(lx, n), _lerp_taps(ly, n), _lerp_taps(lz, n)
    acc = None
    for iz, wz in ((tz[0], tz[2]), (tz[1], tz[3])):
        row_sum = None
        for iy, wy in ((ty[0], ty[2]), (ty[1], ty[3])):
            base = iy * n + iz * n * n
            a = torch.gather(grid, -1, (base + tx[0])[..., None])[..., 0] * tx[2]
            b = torch.gather(grid, -1, (base + tx[1])[..., None])[..., 0] * tx[3]
            r = (a + b) * wy
            row_sum = r if row_sum is None else row_sum + r
        r = row_sum * wz
        acc = r if acc is None else acc + r
    return acc


def _slab(org, dirs, ext, fmin, fmax):
    t0 = t1 = None
    for o, d in zip(org, dirs):
        ds = torch.where(d.abs() < 1e-9, torch.full_like(d, 1e-9), d)
        a, b = o / ds, (o + ext) / ds
        lo, hi = torch.minimum(a, b), torch.maximum(a, b)
        t0 = torch.clamp(lo, min=fmin) if t0 is None else torch.maximum(t0, lo)
        t1 = torch.clamp(hi, max=fmax) if t1 is None else torch.minimum(t1, hi)
    return t0, t1


def _first_crossing(cube, dirs, org, lo, hi, n_samples, inv_vox, entry, dtype):
    """Samples of each ray's block at n_samples points across [lo, hi]
    (after a virtual entry sample of sdf 1e-3 with `entry`): the first
    sign change to negative, as (found, t and sdf on both sides)."""
    ts = [lo + (hi - lo) * (q / (n_samples - 1)) for q in range(n_samples)]
    vs = []
    for tq in ts:
        ls = [torch.clamp((d * tq - o) * inv_vox, 0.0, BLOCK - 1.0).to(dtype)
              for d, o in zip(dirs, org)]
        vs.append(trilinear(cube, *ls, BLOCK).float())
    if entry:
        ts, vs = [lo] + ts, [torch.full_like(lo, 1e-3)] + vs
    found = torch.zeros_like(lo, dtype=torch.bool)
    tlo, thi, vlo, vhi = (torch.zeros_like(lo) for _ in range(4))
    for i in range(len(vs) - 1):
        c = ~found & (vs[i] >= 0) & (vs[i] < 1e9) & (vs[i + 1] < 0)
        tlo, thi = torch.where(c, ts[i], tlo), torch.where(c, ts[i + 1], thi)
        vlo, vhi = torch.where(c, vs[i], vlo), torch.where(c, vs[i + 1], vhi)
        found |= c
    return found, tlo, thi, vlo, vhi


def _march(tiles, lists, vol, summ, cam, tw, s_coarse, s_refine, k_blocks, track,
           need_color, dtype):
    """(t*, found, winning row, pixel directions) of the tiles' pixels."""
    dev = lists.device
    n, LB = lists.shape
    ext, inv_vox, fmin, fmax = cam["ext"], cam["inv_vox"], cam["fmin"], cam["fmax"]
    pp = torch.arange(P, device=dev)
    px = ((tiles % tw) * TILE)[:, None].float() + (pp % TILE).float() + 0.5
    py = ((tiles // tw) * TILE)[:, None].float() + (pp // TILE).float() + 0.5
    a = (px - cam["cx"]) / cam["fx"]
    b = (py - cam["cy"]) / cam["fy"]
    Rm = cam["R"]
    dirs = [a * Rm[i, 0] + b * Rm[i, 1] + Rm[i, 2] for i in range(3)]        # [n, P]
    has_blk = lists >= 0
    rows = lists.clamp(min=0)
    bc = torch.stack(rfusion.unpack_keys(vol["keys"][rows]), -1).float() * ext
    org = [torch.where(has_blk, bc[..., i] - cam["t"][i], torch.full_like(bc[..., i], 1e9))
           for i in range(3)]                                                 # [n, LB]
    if track:
        rd = dirs
        to_px = lambda x: x  # noqa: E731
    else:
        q = torch.arange(64, device=dev)
        p0 = (q // 8) * 2 * TILE + (q % 8) * 2
        rd = [(((d[:, p0] + d[:, p0 + 1]) + d[:, p0 + TILE]) + d[:, p0 + TILE + 1]) * 0.25
              for d in dirs]                                                  # [n, 64]
        quad = ((pp // TILE) // 2) * 8 + (pp % TILE) // 2
        to_px = lambda x: x[:, quad]  # noqa: E731
    mip = summ["mip"][rows].to(dtype)                                       # [n, LB, 64]
    t0, t1 = _slab([o[:, :, None] for o in org], [d[:, None, :] for d in rd], ext, fmin, fmax)
    hit = t1 > t0                                                            # [n, LB, R]
    R = rd[0].shape[1]
    mipx = mip[:, :, None, :].expand(n, LB, R, 64)
    least = torch.full_like(t0, float("inf"))
    neg_any = torch.zeros_like(hit)
    first_neg = torch.zeros_like(t0)
    dips = torch.zeros((n, R), dtype=torch.bool, device=dev)
    for s in range(s_coarse):
        ts = t0 + (t1 - t0) * ((s + 0.5) / s_coarse)
        ls = [torch.clamp((d[:, None, :] * ts - o[:, :, None]) * (inv_vox * 0.5) - 0.5,
                          0.0, 3.0).to(dtype) for d, o in zip(rd, org)]
        v = trilinear(mipx, *ls, 4).float()
        neg = (v < 0) & hit
        first_neg = torch.where(neg & ~neg_any, float(s), first_neg)
        least = torch.minimum(least, torch.where(hit, v, torch.full_like(v, float("inf"))))
        neg_any |= neg
        dips |= ((v < NEAR) & hit).any(1)
    key = torch.where(neg_any, t0 - 1e4,
                      torch.where(least < NEAR, least, torch.full_like(least, float("inf"))))
    found = torch.zeros((n, P), dtype=torch.bool, device=dev)
    t_star = torch.zeros((n, P), device=dev)
    win = torch.full((n, P), -1, dtype=torch.int64, device=dev)
    slots = torch.arange(LB, device=dev)[None, :, None]
    for _ in range(k_blocks):
        best = torch.where(torch.isfinite(key.amin(1)), key.argmin(1), LB)  # [n, R]
        key = torch.where(slots == best[:, None, :], float("inf"), key)
        slot = to_px(best)
        has = slot < LB
        sl = slot.clamp(max=LB - 1)
        o_sel = [torch.gather(o, 1, sl) for o in org]
        ts0, ts1 = _slab(o_sel, dirs, ext, fmin, fmax)
        ts1 = torch.maximum(ts1, ts0)
        bb = best.clamp(max=LB - 1)[:, None, :]
        fneg = to_px(torch.gather(first_neg, 1, bb)[:, 0])
        aneg = to_px(torch.gather(neg_any, 1, bb)[:, 0]) & has
        dt = (ts1 - ts0) / s_coarse
        tn = ts0 + (fneg + 0.5) * dt
        rsel = torch.gather(rows, 1, sl)
        cube = (vol["sdf"][rsel].to(torch.float32) * (1.0 / rfusion.SDF_SCALE)).to(dtype)
        if track:
            lo = torch.where(aneg, torch.maximum(tn - 1.25 * dt, ts0), ts0)
            hi = torch.where(aneg, tn + 0.25 * dt, ts1)
            f1, lo1, hi1, _, _ = _first_crossing(cube, dirs, o_sel, lo, hi, s_refine, inv_vox,
                                                 False, dtype)
            lo, hi = torch.where(f1, lo1, ts0), torch.where(f1, hi1, ts1)
        else:
            lo = torch.where(aneg, torch.maximum(tn - 1.5 * dt, ts0), ts0)
            hi = torch.where(aneg, torch.minimum(tn + 0.5 * dt, ts1), ts1)
        fk, tlo, thi, vlo, vhi = _first_crossing(cube, dirs, o_sel, lo, hi, s_refine, inv_vox,
                                                 True, dtype)
        den = vlo - vhi
        alpha = torch.clamp(vlo / torch.where(den.abs() < 1e-9, torch.full_like(den, 1e-9), den),
                            0.0, 1.0)
        tk = tlo + alpha * (thi - tlo)
        fk &= has
        better = fk & (~found | (tk < t_star))
        t_star = torch.where(better, tk, t_star)
        win = torch.where(better, rsel, win)
        found |= fk
    found &= to_px(dips)
    color = None
    if need_color:
        has_w = win >= 0
        wr = win.clamp(min=0)
        bw = torch.stack(rfusion.unpack_keys(vol["keys"][wr]), -1).float() * ext
        ls = [torch.clamp((d * t_star - (bw[..., i] - cam["t"][i])) * inv_vox, 0.0,
                          BLOCK - 1.0).to(dtype) for i, d in enumerate(dirs)]
        rgb = vol["rgb"][wr].to(dtype)                                       # [n, P, 512, 3]
        color = torch.stack([trilinear(rgb[..., c], *ls, BLOCK).float() for c in range(3)], -1)
        color = torch.where((has_w & found)[..., None], color / 255.0, 0.0)
    return t_star, found, color, dirs


def raycast(vol: dict, c2w, K, width: int, height: int, p: dict, lb: int = 16,
            s_coarse: int = 4, s_refine: int = 6, k_blocks: int = 1, track: bool = False,
            need_color: bool = False, dtype=torch.float32, tile_chunk: int = 64) -> dict:
    """Depth [H, W] (0: no hit), world vertices [H, W, 3] (0: no hit),
    colour [H, W, 3] (with `need_color`) and, for the tracking raycast
    (`track`: per-pixel ranking and the two-stage bracket), the normals
    [H, W, 3] of the volume seen from c2w."""
    dev = vol["keys"].device
    c2w = torch.as_tensor(c2w, device=dev).to(torch.float32)
    fx, fy, cx, cy = (float(v) for v in (K[0][0], K[1][1], K[0][2], K[1][2]))
    tw, th = -(-width // TILE), -(-height // TILE)
    T = tw * th
    summ = summary(vol)
    lists = tile_lists(vol, summ, c2w, K, width, height, p, lb)
    vs = float(p["voxel_size"])
    cam = {"fx": fx, "fy": fy, "cx": cx, "cy": cy, "R": c2w[:3, :3], "t": c2w[:3, 3],
           "ext": vs * BLOCK, "inv_vox": 1.0 / vs, "fmin": float(p["frustum_min"]),
           "fmax": float(p["frustum_max"])}
    t_all = torch.zeros((T, P), device=dev)
    f_all = torch.zeros((T, P), dtype=torch.bool, device=dev)
    c_all = torch.zeros((T, P, 3), device=dev)
    d_all = torch.zeros((T, P, 3), device=dev)
    for a in range(0, T, tile_chunk):
        tiles = torch.arange(a, min(T, a + tile_chunk), device=dev)
        ts, fd, col, dirs = _march(tiles, lists[a:a + tile_chunk], vol, summ, cam, tw,
                                   s_coarse, s_refine, k_blocks, track, need_color, dtype)
        t_all[a:a + tile_chunk], f_all[a:a + tile_chunk] = ts, fd
        d_all[a:a + tile_chunk] = torch.stack(dirs, -1)
        if col is not None:
            c_all[a:a + tile_chunk] = col

    def image(x):
        ch = x.shape[2:]
        return x.reshape(th, tw, TILE, TILE, *ch).transpose(1, 2).reshape(
            th * TILE, tw * TILE, *ch)[:height, :width]

    depth = image(t_all * f_all)
    vert = image((c2w[:3, 3] + d_all * t_all[..., None]) * f_all[..., None])
    out = {"depth": depth, "vertex": vert}
    if need_color:
        out["color"] = image(c_all)
    if track:
        out["normal"] = normals(vert, depth)
    return out


def sobel(vert: torch.Tensor) -> torch.Tensor:
    """Unit normals [H, W, 3] of a vertex map from its Sobel gradients
    (edges replicated), cross(dy, dx), at every pixel."""
    d = torch.tensor([-1.0, 0.0, 1.0], device=vert.device)
    s = torch.tensor([1.0, 2.0, 1.0], device=vert.device)
    x = F.pad(vert.permute(2, 0, 1)[:, None], (1, 1, 1, 1), mode="replicate")
    gx = F.conv2d(x, (s[:, None] * d[None, :])[None, None])[:, 0].permute(1, 2, 0)
    gy = F.conv2d(x, (d[:, None] * s[None, :])[None, None])[:, 0].permute(1, 2, 0)
    n = torch.linalg.cross(gy, gx, dim=-1)
    return n / (torch.linalg.norm(n, dim=-1, keepdim=True) + 1e-8)


def normals(vert: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """`sobel` normals kept where the 3 x 3 neighbourhood all hit
    (outside the image counts as a hit)."""
    n = sobel(vert)
    hit = F.pad((depth > 0).float()[None, None], (1, 1, 1, 1), value=1.0)
    all_hit = -F.max_pool2d(-hit, 3, stride=1)[0, 0] > 0.5
    return torch.where(all_hit[..., None], n, torch.zeros_like(n))
