"""Classic 3DGS rasterization for the offline `raw` render method — the
port of gps_slam_tpu/gs/rasterize_classic.py.

Per pixel, over the Gaussians of its 16x16 tile in front-to-back order:
    alpha_i = min(0.999, opac_i exp(-sigma_i)), zero below 1/255
    T_i = prod_{j<i} (1 - alpha_j), zero once below 1e-4
    out = sum_i [colour_i, 1] alpha_i T_i
`bin_gaussians_depth` lists each tile's Gaussians sorted by depth;
`classic_rasterize` takes the exclusive product as exp of an exclusive
cumsum of log1p(-alpha), the JAX package's formula, so autograd gives the
same gradients as `jax.grad` of it.  The JAX package runs both as XLA code
(no Pallas kernel), and the port runs them as plain torch on the card and
on the CPU alike, over the whole frame at once with the lists cut to the
longest one: at 1200x680 with 64-slot lists each [T, L, P] f32 plane is
at most 211 MB, which one card holds with the backward's saved planes.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class TileBins(NamedTuple):
    """Fixed-width per-tile lists over every tile of the frame."""

    gids: torch.Tensor   # int64 [T, L] gaussian rows (in range, unused where ~valid)
    valid: torch.Tensor  # bool [T, L]
    n_pairs: int         # (gaussian, tile) pairs binned
    n_tile_overflow: int  # pairs dropped by the per-tile cap L
    n_span_overflow: int  # gaussians whose tile bbox was clipped


def bin_gaussians_depth(means2d, radii, depths, tile_size: int, tile_w: int,
                        tile_h: int, visible_cap: int,
                        tiles_per_gaussian_cap: int, tile_cap: int) -> TileBins:
    """(gaussian, tile) pairs of the first `visible_cap` visible Gaussians,
    each bbox clipped to sqrt(tiles_per_gaussian_cap) tiles a side, sorted
    by (tile, depth) and cut into `tile_cap`-slot lists.  The JAX package
    sorts twice, stably, by depth bits and then by tile; one stable sort
    by tile << 32 | depth bits gives the same order."""
    dev = means2d.device
    T = tile_w * tile_h
    S = max(int(math.isqrt(tiles_per_gaussian_cap)), 1)
    vis_idx = torch.nonzero(radii > 0)[:, 0][:visible_cap]
    m2d = means2d.detach()[vis_idx]
    r = radii[vis_idx].to(torch.float32)
    d = depths.detach()[vis_idx]

    def tcoord(x, n):
        return torch.clamp(torch.floor(x / tile_size), 0, n - 1).to(torch.int64)

    tmin_x, tmax_x = tcoord(m2d[:, 0] - r, tile_w), tcoord(m2d[:, 0] + r, tile_w)
    tmin_y, tmax_y = tcoord(m2d[:, 1] - r, tile_h), tcoord(m2d[:, 1] + r, tile_h)
    overflow = ((tmax_x - tmin_x + 1) > S) | ((tmax_y - tmin_y + 1) > S)
    span_x = torch.clamp(tmax_x - tmin_x + 1, max=S)
    span_y = torch.clamp(tmax_y - tmin_y + 1, max=S)

    slot = torch.arange(S * S, device=dev)
    dx, dy = slot % S, slot // S
    pair_ok = (dx[None] < span_x[:, None]) & (dy[None] < span_y[:, None])
    tile_id = torch.where(pair_ok, (tmin_y[:, None] + dy[None]) * tile_w
                          + tmin_x[:, None] + dx[None], T).reshape(-1)
    # the JAX sort key: the int32 bits of max(depth, 0), which order as the
    # floats do; signed, so they are added, not or-ed, below the tile id
    dbits = torch.clamp(d, min=0.0).view(torch.int32).to(torch.int64)
    key = tile_id * (1 << 32) + dbits[:, None].expand(-1, S * S).reshape(-1)
    _, order = torch.sort(key, stable=True)
    tile_s = tile_id[order]
    gids_s = vis_idx[:, None].expand(-1, S * S).reshape(-1)[order]
    counts = torch.bincount(tile_s, minlength=T + 1)[:T]
    start = torch.cumsum(counts, 0) - counts
    l = torch.arange(tile_cap, device=dev)
    valid = l[None] < counts[:, None]
    if gids_s.shape[0] == 0:
        gids_t = torch.zeros((T, tile_cap), dtype=torch.int64, device=dev)
    else:
        gids_t = gids_s[(start[:, None] + l[None]).clamp(max=gids_s.shape[0] - 1)]
    return TileBins(gids_t, valid, int(pair_ok.sum()),
                    int(torch.clamp(counts - tile_cap, min=0).sum()),
                    int(overflow.sum()))


def classic_rasterize(means2d, conics, colors, opacities, bins: TileBins,
                      width: int, height: int, tile_size: int = 16):
    """Front-to-back compositing of the depth-ordered lists `bins`.
    colors [N, C] (rgb and a depth channel).  Returns (render [H, W, C],
    alpha [H, W]); differentiable in means2d, conics, colors and
    opacities."""
    tile_w = -(-width // tile_size)
    tile_h = -(-height // tile_size)
    T = tile_w * tile_h
    C = colors.shape[1]
    P = tile_size * tile_size
    dev = means2d.device
    tids = torch.arange(T, device=dev)
    tx = (tids % tile_w).to(torch.float32) * tile_size
    ty = (tids // tile_w).to(torch.float32) * tile_size
    pp = torch.arange(P, device=dev, dtype=torch.float32)
    px = tx[:, None] + (pp % tile_size)[None, :] + 0.5
    py = ty[:, None] + torch.div(pp, tile_size, rounding_mode="floor")[None, :] + 0.5

    colors_ext = torch.cat([colors, torch.ones_like(colors[:, :1])], 1)
    # slots past the longest list add log1p(-0) = 0 to every transmittance
    # and nothing to the sums: drop them
    L = max(int(bins.valid.sum(1).max()), 1)
    gid, valid = bins.gids[:, :L], bins.valid[:, :L]
    xy = means2d[gid]
    cn = conics[gid]
    op = opacities[gid]
    ce = colors_ext[gid]                                   # [T, L, C+1]
    dx = xy[..., None, 0] - px[:, None, :]                 # [T, L, P]
    dy = xy[..., None, 1] - py[:, None, :]
    sigma = (0.5 * (cn[..., None, 0] * dx * dx + cn[..., None, 2] * dy * dy)
             + cn[..., None, 1] * dx * dy)
    alpha = torch.clamp(op[..., None] * torch.exp(-sigma), max=0.999)
    keep = valid[..., None] & (sigma >= 0.0) & (alpha >= 1.0 / 255.0)
    a = torch.where(keep, alpha, 0.0)
    # exclusive transmittance along the depth-ordered list axis
    log1m = torch.log1p(-torch.clamp(a, max=0.999))
    t_excl = torch.exp(torch.cumsum(log1m, 1) - log1m)
    # contributions once T < 1e-4 vanish (the reference stops the list)
    w = torch.where(t_excl >= 1e-4, a * t_excl, 0.0)
    out = torch.bmm(w.transpose(1, 2), ce)                 # [T, P, C+1]
    img = (out.reshape(tile_h, tile_w, tile_size, tile_size, C + 1)
           .permute(0, 2, 1, 3, 4)
           .reshape(tile_h * tile_size, tile_w * tile_size, C + 1))[:height, :width]
    return img[..., :C], img[..., C]
