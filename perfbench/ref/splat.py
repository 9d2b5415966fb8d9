"""Plain GES render: the reference the benchmark holds the program's
Gaussian render to.

Plain PyTorch, no import of the program.  The configuration's render
(`render_method: ges`): each live Gaussian is projected (EWA with the
perspective Jacobian's tangents clamped at 1.3 half fields of view, a
0.3 px blur, radius ceil(3 sqrt(the larger eigenvalue)) capped at
max_gs_radii, culled outside the image, before the 0.01 m near plane or
with a degenerate footprint), coloured by its SH at the view direction
(+0.5, clamped at 0), and binned into 16 x 16 px tiles: the first
`visible_cap` visible Gaussians in pool order, each over its tile
bounding box (at most 6 x 6 tiles, centred on its own tile where wider),
each tile's first `tile_gaussian_cap` Gaussians in pool order, the first
`active_tile_cap` tiles with a Gaussian.  A pixel sums, over its tile's
Gaussians, alpha = min(0.999, opacity exp(-sigma)) where sigma >= 0,
alpha >= 1/255 and the Gaussian's depth lies within delta_depth behind
the raycast depth (no depth: none behind); no ordering, no
transmittance.  Output: the alpha-weighted colour and the weight sum.

The binning is a chain of roundings (a radius rounded up, tile
coordinates rounded down, caps in pool order): where a Gaussian's centre
or radius lies within rounding of a tile's edge or an integer, a sound
render may bin it either way, and a large Gaussian then covers another
column of tiles, or a full tile keeps another Gaussian.  A depth within
rounding of the depth cut is such a rounding too.  `unsettled` marks the
pixels whose render turns on one by more than SETTLE_TOL.
"""

from __future__ import annotations

import math

import torch

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)
BUCKETS = (4096, 16384, 32768, 65536, 131072)
TILE = 16
# how far (px) a centre or a radius before its rounding is moved to find
# the pixels whose render turns on a rounding: four times the widest gap
# between the program's projected centres and this reference's on the
# H100 (2.4e-4 px, two float32 steps at 1,024-2,048 px), far below a
# bfloat16 projection's error
SETTLE_PX = 1e-3
# how far a Gaussian's depth is moved, as a share of itself, to find the
# pixels where it lies within rounding of the depth cut (the frame's depth,
# quantised at 0.2 mm, plus delta_depth: over a flat patch one rounding
# flips the Gaussian at every pixel of one depth): some eight float32 steps
DEPTH_REL = 1e-6
# a pixel is unsettled where a moved binning moves its weight or any
# channel by more than this, a fifth of the check's limits: what moves a
# pixel by less (the faint rim of a Gaussian at its tile box's edge) stays
# compared, and cannot carry a gap past its limit alone
SETTLE_TOL = 0.01


def caps(n_live: int, capacity: int, width: int, height: int, tpu: dict) -> dict:
    """The eval render's caps for a pool of n_live Gaussians: its prefix
    bucket fixes the visible cap and raises the active-tile cap to an
    eighth of it."""
    cap = next((b for b in BUCKETS if n_live <= b <= capacity), capacity)
    T = -(-width // TILE) * -(-height // TILE)
    return {"visible": min(int(tpu["visible_gaussian_cap"]), cap),
            "active": min(T, max(int(tpu["active_tile_cap"]), cap // 8)),
            "tile": int(tpu["tile_gaussian_cap"]),
            "per_gaussian": int(tpu["tiles_per_gaussian_cap"])}


def sh_colors(deg: int, dirs, coeffs):
    d = dirs / dirs.norm(dim=-1, keepdim=True).clamp(min=1e-10)
    x, y, z = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    c = SH_C0 * coeffs[:, 0]
    if deg >= 1:
        c = c + SH_C1 * (-y * coeffs[:, 1] + z * coeffs[:, 2] - x * coeffs[:, 3])
    if deg >= 2:
        xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
        c = c + (SH_C2[0] * xy * coeffs[:, 4] + SH_C2[1] * yz * coeffs[:, 5]
                 + SH_C2[2] * (2 * zz - xx - yy) * coeffs[:, 6] + SH_C2[3] * xz * coeffs[:, 7]
                 + SH_C2[4] * (xx - yy) * coeffs[:, 8])
    if deg >= 3:
        c = c + (SH_C3[0] * y * (3 * xx - yy) * coeffs[:, 9] + SH_C3[1] * xy * z * coeffs[:, 10]
                 + SH_C3[2] * y * (4 * zz - xx - yy) * coeffs[:, 11]
                 + SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy) * coeffs[:, 12]
                 + SH_C3[4] * x * (4 * zz - xx - yy) * coeffs[:, 13]
                 + SH_C3[5] * z * (xx - yy) * coeffs[:, 14]
                 + SH_C3[6] * x * (xx - 3 * yy) * coeffs[:, 15])
    if deg >= 4:
        raise ValueError("SH degree above 3")
    return torch.clamp(c + 0.5, min=0.0)


def project(pool: dict, c2w, K, width: int, height: int, max_radius: int, dtype,
            shift: tuple = (0.0, 0.0)):
    """(means2d [N, 2], conics [N, 3], depths [N], radii [N] int); with
    `shift` (du, dr), each centre moved by du px along both axes and each
    radius by dr px before it is rounded up."""
    dev = pool["means"].device
    c2w = torch.as_tensor(c2w, device=dev).to(torch.float32)
    # a pose is a rigid motion: its inverse is [R^T | -R^T t]
    w2c = torch.eye(4, device=dev)
    w2c[:3, :3] = c2w[:3, :3].T
    w2c[:3, 3] = -(c2w[:3, :3].T @ c2w[:3, 3])
    w2c = w2c.to(dtype)
    fx, fy, cx, cy = (float(v) for v in (K[0][0], K[1][1], K[0][2], K[1][2]))
    m = pool["means"].to(dtype)
    mc = m @ w2c[:3, :3].T + w2c[:3, 3]
    q = pool["quats"].to(dtype)
    q = q / q.norm(dim=-1, keepdim=True).clamp(min=1e-10)
    w, x, y, z = q.unbind(1)
    Rq = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1).view(-1, 3, 3)
    M = Rq * torch.exp(pool["scales"].to(torch.float32)).to(dtype)[:, None, :]
    cov = w2c[:3, :3] @ (M @ M.transpose(1, 2)) @ w2c[:3, :3].T
    X, Y, Z = mc.unbind(1)
    Zs = torch.where(Z.abs() < 1e-8, torch.full_like(Z, 1e-8), Z)
    lim_x = (cx / fx + 0.3 * 0.5 * width / fx, (width - cx) / fx + 0.3 * 0.5 * width / fx)
    lim_y = (cy / fy + 0.3 * 0.5 * height / fy, (height - cy) / fy + 0.3 * 0.5 * height / fy)
    tx = Zs * torch.clamp(X / Zs, -lim_x[0], lim_x[1])
    ty = Zs * torch.clamp(Y / Zs, -lim_y[0], lim_y[1])
    J = torch.zeros((m.shape[0], 2, 3), dtype=dtype, device=dev)
    J[:, 0, 0], J[:, 0, 2] = fx / Zs, -fx * tx / (Zs * Zs)
    J[:, 1, 1], J[:, 1, 2] = fy / Zs, -fy * ty / (Zs * Zs)
    c2 = J @ cov @ J.transpose(1, 2)
    a00, a01, a11 = c2[:, 0, 0] + 0.3, c2[:, 0, 1], c2[:, 1, 1] + 0.3
    det = a00 * a11 - a01 * a01
    ok = det > 0
    ds = torch.where(ok, det, torch.ones_like(det))
    conic = torch.stack([a11 / ds, -a01 / ds, a00 / ds], -1)
    b = 0.5 * (a00 + a11)
    radius = torch.ceil(3.0 * torch.sqrt(b + torch.sqrt(torch.clamp(b * b - ds, min=0.01)))
                        + shift[1])
    u = fx * X / Zs + cx + shift[0]
    v = fy * Y / Zs + cy + shift[0]
    cull = ((Z < 0.01) | ~ok | (radius <= 0) | (u + radius <= 0) | (u - radius >= width)
            | (v + radius <= 0) | (v - radius >= height) | ~pool["alive"])
    radii = torch.where(cull, 0, radius.float().clamp(max=2 ** 30).to(torch.int64))
    radii = radii.clamp(max=max_radius)
    return torch.stack([u, v], -1), conic, Z, radii


def colors(pool: dict, c2w, sh_degree: int, radii, dtype):
    """SH colours at the view direction, +0.5 and clamped at 0; 0.5 where
    the Gaussian is culled (its SH read as 0)."""
    c2w_t = torch.as_tensor(c2w, device=pool["means"].device).to(torch.float32)
    coeffs = torch.cat([pool["features_dc"][:, None], pool["features_rest"]], 1).to(dtype)
    col = sh_colors(sh_degree, (pool["means"] - c2w_t[:3, 3]).to(dtype), coeffs)
    return torch.where((radii > 0)[:, None], col, torch.full_like(col, 0.5))


@torch.no_grad()
def bins(m2d, radii, width: int, height: int, cp: dict, margin: float = 0.0):
    """(tile, gaussian) pairs, tile-major, of the render's lists: the first
    cp["visible"] visible Gaussians in pool order, each over its tile
    bounding box (its radius plus `margin` px; at most cp["per_gaussian"]
    tiles, a square window centred on its own tile where wider), each
    tile's first cp["tile"] Gaussians in pool order, the first cp["active"]
    tiles with a Gaussian."""
    dev = m2d.device
    n = m2d.shape[0]
    tw, th = -(-width // TILE), -(-height // TILE)
    vis = torch.nonzero(radii > 0)[:, 0][:cp["visible"]]
    S = max(int(math.isqrt(cp["per_gaussian"])), 1)
    mx, my = m2d[vis, 0].float(), m2d[vis, 1].float()
    r = radii[vis].float() + margin

    def tc(a, lim):
        return torch.clamp(torch.floor(a / TILE), 0, lim - 1).to(torch.int64)

    x0, x1, y0, y1 = tc(mx - r, tw), tc(mx + r, tw), tc(my - r, th), tc(my + r, th)
    sx, sy = x1 - x0 + 1, y1 - y0 + 1
    cxt, cyt = tc(mx, tw), tc(my, th)
    x0 = torch.where(sx > S, torch.minimum(torch.maximum(cxt - S // 2, x0),
                                           torch.clamp(x1 - (S - 1), min=0)), x0)
    y0 = torch.where(sy > S, torch.minimum(torch.maximum(cyt - S // 2, y0),
                                           torch.clamp(y1 - (S - 1), min=0)), y0)
    sx, sy = sx.clamp(max=S), sy.clamp(max=S)
    slot = torch.arange(S * S, device=dev)
    dx, dy = slot % S, slot // S
    pok = (dx[None] < sx[:, None]) & (dy[None] < sy[:, None])
    tile = ((y0[:, None] + dy[None]) * tw + x0[:, None] + dx[None])[pok]
    gid = vis[:, None].expand(-1, S * S)[pok]
    # pool order within a tile: sort by (tile, gaussian)
    order = torch.argsort(tile * (n + 1) + gid)
    tile, gid = tile[order], gid[order]
    first = torch.searchsorted(tile, tile)
    rank = torch.arange(tile.numel(), device=dev) - first
    keep = rank < cp["tile"]
    act = torch.unique(tile)[:cp["active"]]
    keep &= torch.isin(tile, act)
    return tile[keep], gid[keep]


def splat(m2d, conic, depth, col, opac, tile, gid, ref_depth, width: int, height: int,
          delta: float, dtype, chunk: int = 1 << 14):
    """(alpha-weighted colour [H, W, 3], weight sum [H, W]) over the pairs;
    differentiable in the Gaussians' attributes (none through the depth
    cut or the 0.999 clamp)."""
    dev = m2d.device
    tw, th = -(-width // TILE), -(-height // TILE)
    ref = torch.where(ref_depth < 0.01, torch.full_like(ref_depth, 1000.0), ref_depth)
    ref_pad = torch.full((th * TILE, tw * TILE), 1e9, device=dev)
    ref_pad[:height, :width] = ref
    p = torch.arange(TILE * TILE, device=dev)
    acc = torch.zeros((tw * th, TILE * TILE, 4), dtype=torch.float32, device=dev)
    m2d, conic, col, opac = m2d.to(dtype), conic.to(dtype), col.to(dtype), opac.to(dtype)
    depth = depth.detach()
    for a in range(0, tile.numel(), chunk):
        t_, g = tile[a:a + chunk], gid[a:a + chunk]
        tx = (t_ % tw) * TILE
        ty = (t_ // tw) * TILE
        px = (tx[:, None] + p[None] % TILE).to(dtype) + 0.5
        py = (ty[:, None] + p[None] // TILE).to(dtype) + 0.5
        refp = ref_pad[ty[:, None] + p[None] // TILE, tx[:, None] + p[None] % TILE]
        ddx = m2d[g, 0:1] - px
        ddy = m2d[g, 1:2] - py
        cn = conic[g]
        sig = 0.5 * (cn[:, 0:1] * ddx * ddx + cn[:, 2:3] * ddy * ddy) + cn[:, 1:2] * ddx * ddy
        al = torch.clamp(opac[g][:, None] * torch.exp(-sig), max=0.999)
        ok = (sig >= 0) & (al >= 1.0 / 255.0) & (depth[g][:, None].float() <= refp + delta)
        wgt = torch.where(ok, al, torch.zeros_like(al)).float()
        contrib = torch.cat([wgt[..., None] * col[g].float()[:, None, :], wgt[..., None]], -1)
        acc = acc.index_add(0, t_, contrib)
    img = acc.view(th, tw, TILE, TILE, 4).permute(0, 2, 1, 3, 4).reshape(
        th * TILE, tw * TILE, 4)[:height, :width]
    return img[..., :3], img[..., 3]


def render(pool: dict, c2w, K, width: int, height: int, ref_depth, mcfg: dict, tpu: dict,
           dtype=torch.float32, cp: dict | None = None, lists=None) -> dict:
    """{"raw": alpha-weighted colour [H, W, 3], "weight": [H, W]} under the
    caps `cp` (the eval render's, `caps`, by default) and the pairs
    `lists` (binned now by default)."""
    if cp is None:
        cp = caps(pool["means"].shape[0], int(tpu["gaussian_capacity"]), width, height, tpu)
    m2d, conic, depth, radii = project(pool, c2w, K, width, height,
                                       int(mcfg["max_gs_radii"]), dtype)
    col = colors(pool, c2w, int(mcfg["sh_degree"]), radii, dtype)
    opac = torch.sigmoid(pool["opacities"][:, 0].to(torch.float32)).to(dtype)
    tile, gid = bins(m2d, radii, width, height, cp) if lists is None else lists
    raw, weight = splat(m2d, conic, depth, col, opac, tile, gid, ref_depth, width, height,
                        float(mcfg["delta_depth"]), dtype)
    return {"raw": raw, "weight": weight}


@torch.no_grad()
def unsettled(pool: dict, c2w, K, width: int, height: int, ref_depth, mcfg: dict,
              tpu: dict, eps: float = SETTLE_PX) -> torch.Tensor:
    """[H, W] bool: the pixels whose float32 render turns on a rounding of
    the binning.  The tile lists are binned again with every centre moved
    by +-eps px and every radius, before it is rounded up, by +-eps px (the
    four combinations, so that each edge of a Gaussian's tile box and its
    centre's tile cross a nearby boundary in one of them) and splatted with
    the Gaussians as they are; the lists as binned are splatted again with
    every depth moved by +-DEPTH_REL of itself, across the depth cut where
    it lies within rounding of it.  A pixel that any of them moves by more
    than SETTLE_TOL is unsettled."""
    cp = caps(pool["means"].shape[0], int(tpu["gaussian_capacity"]), width, height, tpu)
    r = int(mcfg["max_gs_radii"])
    m2d, conic, depth, radii = project(pool, c2w, K, width, height, r, torch.float32)
    col = colors(pool, c2w, int(mcfg["sh_degree"]), radii, torch.float32)
    opac = torch.sigmoid(pool["opacities"][:, 0].to(torch.float32))
    delta = float(mcfg["delta_depth"])

    def splatted(lists, d=depth):
        return splat(m2d, conic, d, col, opac, *lists, ref_depth, width, height, delta,
                     torch.float32)

    lists0 = bins(m2d, radii, width, height, cp)
    raw0, w0 = splatted(lists0)
    moved = []
    for du in (eps, -eps):
        for dr in (eps, -eps):
            m2v, _, _, rv = project(pool, c2w, K, width, height, r, torch.float32, (du, dr))
            moved.append(splatted(bins(m2v, rv, width, height, cp)))
    for dz in (DEPTH_REL, -DEPTH_REL):
        moved.append(splatted(lists0, depth * (1.0 + dz)))
    out = torch.zeros((height, width), dtype=torch.bool, device=m2d.device)
    for raw, w in moved:
        out |= ((w - w0).abs() > SETTLE_TOL) | ((raw - raw0).abs().amax(-1) > SETTLE_TOL)
    return out
