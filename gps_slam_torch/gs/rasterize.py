"""GES rasterization — the port of gps_slam_tpu/gs/rasterize.py.

For every pixel, over the Gaussians binned into its 16x16 tile:
    skip when gaussian_depth > ref_depth + delta_depth   (SDF depth cut)
    sigma = 0.5 (A dx^2 + C dy^2) + B dx dy
    alpha = min(0.999, opac * exp(-sigma)),  skip when alpha < 1/255
    out += [colours, 1] * alpha
No transmittance and no ordering.  Binning (`bin_gaussians_active`) is
plain tensor ops.  The per-tile weighted sum is the CUDA kernel
`splat_fwd_cuda` (csrc/splat_fwd.cu) on the card and `splat_fwd_plain` on
the CPU, both in f32 (the JAX XLA scan path contracts in bf16; the port
follows the f32 TPU kernel instead).  Its gradient (`GesSplat`, the
counterpart of the JAX custom VJP `_ges_splat`) recomputes the pair terms
per (tile, slot) in `splat_bwd_cuda` (csrc/splat_bwd.cu) or
`splat_bwd_plain`, then sums pairs into Gaussians with one sorted cumsum
(`_segment_to_grads`): deterministic, no atomics.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .. import kernels

GMIN_ALPHA = 1.0 / 255.0


class ActiveBins(NamedTuple):
    """Per-tile lists restricted to tiles that contain Gaussians."""

    tiles: torch.Tensor      # int64 [A] active tile ids (A <= active_cap)
    gids: torch.Tensor       # int32 [A, L] gaussian rows; N (null row) where empty
    valid: torch.Tensor      # bool [A, L]
    n_pairs: int
    n_tile_overflow: int     # pairs dropped by the per-tile cap L
    n_span_overflow: int     # gaussians whose tile bbox was clipped
    n_active_overflow: int   # active tiles dropped by the cap A
    # pair -> gaussian segments for the backward's segment sum (see
    # `pair_segments`), fixed for as long as the binning is reused (a
    # window's Adam steps); None unless asked for
    pair_order: torch.Tensor | None = None  # int64 [A*L]
    seg_lo: torch.Tensor | None = None      # int64 [N]
    seg_hi: torch.Tensor | None = None      # int64 [N]


def bin_gaussians_active(means2d, radii, tile_size: int, tile_w: int,
                         tile_h: int, visible_cap: int,
                         tiles_per_gaussian_cap: int, tile_cap: int,
                         active_cap: int, margin_px: float = 0.0,
                         segments: bool = False) -> ActiveBins:
    """(gaussian, tile) pair expansion with a per-Gaussian tile cap, one
    stable sort by tile id, fixed-width per-tile lists over the tiles that
    received at least one Gaussian.  Every cap that bites is counted.
    With `segments`, also the backward's `pair_segments` of the lists."""
    dev = means2d.device
    N = means2d.shape[0]
    T = tile_w * tile_h
    S = max(int(math.isqrt(tiles_per_gaussian_cap)), 1)
    vis_idx = torch.nonzero(radii > 0)[:, 0][:visible_cap]
    m2d = means2d[vis_idx].detach()
    r = radii[vis_idx].to(torch.float32) + margin_px

    def tcoord(x, n):
        return torch.clamp(torch.floor(x / tile_size), 0, n - 1).to(torch.int64)

    tmin_x, tmax_x = tcoord(m2d[:, 0] - r, tile_w), tcoord(m2d[:, 0] + r, tile_w)
    tmin_y, tmax_y = tcoord(m2d[:, 1] - r, tile_h), tcoord(m2d[:, 1] + r, tile_h)
    span_x = tmax_x - tmin_x + 1
    span_y = tmax_y - tmin_y + 1
    overflow = (span_x > S) | (span_y > S)
    # an over-span bbox keeps a window centred on the gaussian's tile
    tc_x, tc_y = tcoord(m2d[:, 0], tile_w), tcoord(m2d[:, 1], tile_h)
    tmin_x = torch.where(span_x > S, torch.minimum(torch.maximum(
        tc_x - S // 2, tmin_x), torch.clamp(tmax_x - (S - 1), min=0)), tmin_x)
    tmin_y = torch.where(span_y > S, torch.minimum(torch.maximum(
        tc_y - S // 2, tmin_y), torch.clamp(tmax_y - (S - 1), min=0)), tmin_y)
    span_x = torch.clamp(span_x, max=S)
    span_y = torch.clamp(span_y, max=S)

    slot = torch.arange(S * S, device=dev)
    dx, dy = slot % S, slot // S
    pair_ok = (dx[None] < span_x[:, None]) & (dy[None] < span_y[:, None])
    tile_id = torch.where(pair_ok, (tmin_y[:, None] + dy[None]) * tile_w
                          + tmin_x[:, None] + dx[None], T).reshape(-1)
    gid = vis_idx[:, None].expand(-1, S * S).reshape(-1)
    tile_s, order = torch.sort(tile_id, stable=True)
    gids_s = gid[order]
    counts = torch.bincount(tile_s, minlength=T + 1)[:T]
    start = torch.cumsum(counts, 0) - counts
    act = torch.nonzero(counts > 0)[:, 0]
    n_active = act.shape[0]
    act = act[:active_cap]
    l = torch.arange(tile_cap, device=dev)
    a_cnt = counts[act]
    valid = l[None] < a_cnt[:, None]
    idx = (start[act][:, None] + l[None]).clamp(max=max(gids_s.shape[0] - 1, 0))
    if gids_s.shape[0] == 0:
        gids_a = torch.full((act.shape[0], tile_cap), N, dtype=torch.int32,
                            device=dev)
    else:
        gids_a = torch.where(valid, gids_s[idx], N).to(torch.int32)
    gids_a = gids_a.contiguous()
    seg = pair_segments(gids_a, N) if segments else (None, None, None)
    return ActiveBins(
        tiles=act, gids=gids_a, valid=valid,
        n_pairs=int(pair_ok.sum()),
        n_tile_overflow=int(torch.clamp(counts - tile_cap, min=0).sum()),
        n_span_overflow=int(overflow.sum()),
        n_active_overflow=max(n_active - active_cap, 0),
        pair_order=seg[0], seg_lo=seg[1], seg_hi=seg[2],
    )


def pair_segments(gids, N: int):
    """(pair_order, seg_lo, seg_hi) of the lists gids [A, L]: the stable
    argsort [A*L] of the flat gids and, per gaussian row of N, its first
    sorted pair and one past its last (lo == hi == 0: no pair).  The null
    row N sorts after every gaussian, so each gaussian's pairs are one
    contiguous run."""
    gsorted, pair_order = torch.sort(gids.reshape(-1), stable=True)
    rows = torch.arange(N, dtype=gids.dtype, device=gids.device)
    lo = torch.searchsorted(gsorted, rows)
    hi = torch.searchsorted(gsorted, rows, right=True)
    present = hi > lo
    return pair_order, torch.where(present, lo, 0), torch.where(present, hi, 0)


def _pack_attrs(means2d, conics, colors, gauss_depth, opacities):
    """One row per gaussian: [xy(2) | conic(3) | colors(C) | depth(1) |
    opac(1) | one(1) | pad to a multiple of 8], plus the all-zero NULL row
    N, whose opacity 0 kills every slot that points at it."""
    n = means2d.shape[0]
    packed = torch.cat([means2d, conics, colors, gauss_depth[:, None],
                        opacities[:, None], torch.ones((n, 1), device=means2d.device)], 1)
    pad_cols = (-packed.shape[1]) % 8
    if pad_cols:
        packed = torch.cat([packed, packed.new_zeros((n, pad_cols))], 1)
    return torch.cat([packed, packed.new_zeros((1, packed.shape[1]))], 0).contiguous()


def splat_fwd_plain(packed, gids, px, py, ref_tiles, delta_depth: float,
                    C: int) -> torch.Tensor:
    """Plain PyTorch version of `splat_fwd_cuda`: [A, C+1, P] tile sums,
    accumulated over the L list slots in order, in the dtype of `packed`
    (f32, as the kernel)."""
    A, L = gids.shape
    P = px.shape[1]
    out = torch.zeros((A, C + 1, P), dtype=packed.dtype, device=px.device)
    for l in range(L):
        g = packed[gids[:, l].to(torch.int64)]                  # [A, cols]
        dx = g[:, 0:1] - px
        dy = g[:, 1:2] - py
        sigma = 0.5 * (g[:, 2:3] * dx * dx + g[:, 4:5] * dy * dy) + g[:, 3:4] * dx * dy
        alpha = torch.clamp(g[:, 6 + C:7 + C] * torch.exp(-sigma), max=0.999)
        keep = (sigma >= 0.0) & (alpha >= GMIN_ALPHA) & (
            g[:, 5 + C:6 + C] <= ref_tiles + delta_depth)
        w = torch.where(keep, alpha, 0.0)                       # [A, P]
        for k in range(C):
            out[:, k] = out[:, k] + w * g[:, 5 + k:6 + k]
        out[:, C] = out[:, C] + w
    return out


def splat_fwd(packed, gids, px, py, ref_tiles, delta_depth: float,
              C: int) -> torch.Tensor:
    """[A, C+1, P] channel-major tile sums (see `splat_fwd_plain`).  CPU
    tensors take the plain version; CUDA tensors launch `splat_fwd_cuda`
    or raise."""
    if packed.device.type != "cuda":
        return splat_fwd_plain(packed, gids, px, py, ref_tiles, delta_depth, C)
    A, L = gids.shape
    P = px.shape[1]
    rows, cols = packed.shape
    if P != 256 or L > 256 or C + 1 > 8 or cols < 7 + C:
        raise ValueError(f"splat_fwd_cuda: unsupported shape P={P} L={L} C={C} "
                         f"cols={cols}")
    k = kernels.SPLAT_FWD
    for name, t, dtype, shape in (("packed", packed, torch.float32, None),
                                  ("gids", gids, torch.int32, (A, L)),
                                  ("px", px, torch.float32, (A, P)),
                                  ("py", py, torch.float32, (A, P)),
                                  ("ref_tiles", ref_tiles, torch.float32, (A, P))):
        kernels.check_tensor(k, name, t, dtype, shape)
    out = torch.empty((A, C + 1, P), dtype=torch.float32, device=packed.device)
    if A == 0:
        return out
    err = k.fn(packed.data_ptr(), gids.data_ptr(), px.data_ptr(), py.data_ptr(),
               ref_tiles.data_ptr(), out.data_ptr(), A, L, C, cols,
               float(delta_depth), kernels.stream_ptr())
    k.launches += 1
    kernels.check(k, err)
    return out


def splat_bwd_plain(packed, gids, px, py, ref_tiles, v_out, delta_depth: float,
                    C: int) -> torch.Tensor:
    """Plain PyTorch version of `splat_bwd_cuda`: per (tile, list slot) the
    gradient components reduced over the tile's pixels, [A, L, 6+C] =
    v_x, v_y, v_cA, v_cB, v_cC, v_ce[0..C-1], v_op, for the cotangent
    v_out [A, C+1, P] of `splat_fwd`.  Follows the XLA body of the JAX
    `_ges_splat_bwd` in the dtype of `packed` (f32, as the kernel), one
    slot at a time: v_w = ce . v_out,
    d_alpha = v_w where the pair is kept and raw alpha < 0.999 (no
    gradient through the depth cut or the clamp), v_sigma = -d_alpha *
    raw alpha."""
    A, L = gids.shape
    out = torch.zeros((A, L, 6 + C), dtype=packed.dtype, device=px.device)
    for l in range(L):
        g = packed[gids[:, l].to(torch.int64)]                  # [A, cols]
        cA, cB, cC = g[:, 2:3], g[:, 3:4], g[:, 4:5]
        dx = g[:, 0:1] - px
        dy = g[:, 1:2] - py
        sigma = 0.5 * (cA * dx * dx + cC * dy * dy) + cB * dx * dy
        e = torch.exp(-sigma)
        raw = g[:, 6 + C:7 + C] * e
        alpha = torch.clamp(raw, max=0.999)
        keep = (sigma >= 0.0) & (alpha >= GMIN_ALPHA) & (
            g[:, 5 + C:6 + C] <= ref_tiles + delta_depth)
        w = torch.where(keep, alpha, 0.0)
        v_w = torch.zeros_like(px)
        for k in range(C):
            v_w = v_w + g[:, 5 + k:6 + k] * v_out[:, k]
        v_w = v_w + v_out[:, C]
        dalpha = torch.where(keep & (raw < 0.999), v_w, 0.0)
        v_sigma = -dalpha * raw
        cols = [(v_sigma * (cA * dx + cB * dy)).sum(1),
                (v_sigma * (cC * dy + cB * dx)).sum(1),
                (v_sigma * 0.5 * dx * dx).sum(1),
                (v_sigma * dx * dy).sum(1),
                (v_sigma * 0.5 * dy * dy).sum(1)]
        cols += [(w * v_out[:, k]).sum(1) for k in range(C)]
        cols.append((dalpha * e).sum(1))
        out[:, l] = torch.stack(cols, 1)
    return out


def splat_bwd(packed, gids, px, py, ref_tiles, v_out, delta_depth: float,
              C: int) -> torch.Tensor:
    """[A, L, 6+C] per-pair gradient components (see `splat_bwd_plain`).
    CPU tensors take the plain version; CUDA tensors launch
    `splat_bwd_cuda` or raise."""
    if packed.device.type != "cuda":
        return splat_bwd_plain(packed, gids, px, py, ref_tiles, v_out,
                               delta_depth, C)
    A, L = gids.shape
    P = px.shape[1]
    rows, cols = packed.shape
    if P != 256 or L > 256 or C + 1 > 8 or cols < 7 + C:
        raise ValueError(f"splat_bwd_cuda: unsupported shape P={P} L={L} C={C} "
                         f"cols={cols}")
    k = kernels.SPLAT_BWD
    for name, t, dtype, shape in (("packed", packed, torch.float32, None),
                                  ("gids", gids, torch.int32, (A, L)),
                                  ("px", px, torch.float32, (A, P)),
                                  ("py", py, torch.float32, (A, P)),
                                  ("ref_tiles", ref_tiles, torch.float32, (A, P)),
                                  ("v_out", v_out, torch.float32, (A, C + 1, P))):
        kernels.check_tensor(k, name, t, dtype, shape)
    out = torch.empty((A, L, 6 + C), dtype=torch.float32, device=packed.device)
    if A == 0:
        return out
    err = k.fn(packed.data_ptr(), gids.data_ptr(), px.data_ptr(), py.data_ptr(),
               ref_tiles.data_ptr(), v_out.data_ptr(), out.data_ptr(), A, L, C,
               cols, float(delta_depth), kernels.stream_ptr())
    k.launches += 1
    kernels.check(k, err)
    return out


def _segment_to_grads(contribs, pair_order, seg_lo, seg_hi, C: int):
    """Per-pair contributions [A, L, 6+C] -> per-gaussian grads (means2d
    [N, 2], conics [N, 3], colors [N, C], opacities [N]): a gather into
    gaussian-sorted pair order, an f32 cumsum and boundary differences, as
    the JAX package does.  Deterministic: no scatter-add.  The scan runs
    along the contiguous dimension of a [6+C, A*L] copy: torch's CUDA
    cumsum over the outer dimension of [A*L, 6+C] took ~13 ms per call at
    the main path's 131k pairs (profiled on an H100)."""
    K = 6 + C
    N = seg_lo.shape[0]
    flat = contribs.reshape(-1, K)
    if flat.shape[0] == 0:
        seg = flat.new_zeros((N, K))
    else:
        cs = torch.cumsum(flat[pair_order].T.contiguous(), 1)    # [K, A*L]
        top = cs[:, (seg_hi - 1).clamp(min=0)]
        bot = torch.where(seg_lo > 0, cs[:, (seg_lo - 1).clamp(min=0)], 0.0)
        seg = torch.where(seg_hi > seg_lo, top - bot, 0.0).T      # [N, K]
    return seg[:, 0:2], seg[:, 2:5], seg[:, 5:5 + C], seg[:, 5 + C]


class GesSplat(torch.autograd.Function):
    """Active-tile GES sums [A, C+1, P] with a recomputing backward — the
    counterpart of the JAX custom VJP `_ges_splat`.  Forward: pack the
    attribute rows, K4.  Backward: re-pack, K5, `_segment_to_grads`.
    Only the inputs are saved; gradients reach means2d, conics, colors and
    opacities, none reaches gauss_depth (the depth cut), the lists, the
    reference depth or the pixel planes.  Segments of None are computed
    from the lists in the backward."""

    @staticmethod
    def forward(ctx, means2d, conics, colors, opacities, gauss_depth, gids,
                ref_tiles, px, py, pair_order, seg_lo, seg_hi, delta_depth):
        ctx.save_for_backward(means2d, conics, colors, opacities, gauss_depth,
                              gids, ref_tiles, px, py, pair_order, seg_lo, seg_hi)
        ctx.delta_depth = delta_depth
        packed = _pack_attrs(means2d, conics, colors, gauss_depth, opacities)
        return splat_fwd(packed, gids, px, py, ref_tiles, delta_depth,
                         colors.shape[1])

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, v_out):
        (means2d, conics, colors, opacities, gauss_depth, gids, ref_tiles, px,
         py, pair_order, seg_lo, seg_hi) = ctx.saved_tensors
        C = colors.shape[1]
        packed = _pack_attrs(means2d, conics, colors, gauss_depth, opacities)
        contribs = splat_bwd(packed, gids, px, py, ref_tiles,
                             v_out.contiguous(), ctx.delta_depth, C)
        if pair_order is None:
            pair_order, seg_lo, seg_hi = pair_segments(gids, means2d.shape[0])
        grads = _segment_to_grads(contribs, pair_order, seg_lo, seg_hi, C)
        return (*grads, None, None, None, None, None, None, None, None, None)


def _tile_pixels(tiles, tile_w: int, tile_size: int):
    """Pixel-centre coordinates [A, P] of the active tiles."""
    P = tile_size * tile_size
    tx = (tiles % tile_w).to(torch.float32) * tile_size
    ty = (tiles // tile_w).to(torch.float32) * tile_size
    pp = torch.arange(P, device=tiles.device)
    px = tx[:, None] + (pp % tile_size).to(torch.float32)[None] + 0.5
    py = ty[:, None] + (pp // tile_size).to(torch.float32)[None] + 0.5
    return px.contiguous(), py.contiguous()


def _tile_view(img, tile_h: int, tile_w: int, tile_size: int, height: int,
               width: int, pad_value: float = 0.0) -> torch.Tensor:
    """[H, W, C] image -> [T, C, P] per-tile channel-major view."""
    C = img.shape[-1]
    pad = img.new_full((tile_h * tile_size, tile_w * tile_size, C), pad_value)
    pad[:height, :width] = img
    return pad.reshape(tile_h, tile_size, tile_w, tile_size, C) \
        .permute(0, 2, 4, 1, 3).reshape(tile_h * tile_w, C, tile_size * tile_size)


def ges_rasterize_active(means2d, conics, colors, opacities, bins: ActiveBins,
                         ref_depth, gauss_depth, delta_depth: float,
                         width: int, height: int, tile_size: int = 16):
    """Active-tile GES weighted sums -> (render [H, W, C], weight_sum
    [H, W]); inactive tiles are exact zeros.  Differentiable in means2d,
    conics, colors and opacities through `GesSplat`."""
    tile_w = -(-width // tile_size)
    tile_h = -(-height // tile_size)
    T = tile_w * tile_h
    C = colors.shape[1]
    P = tile_size * tile_size
    tiles = bins.tiles
    ref_tiles = _tile_view(ref_depth[..., None], tile_h, tile_w, tile_size,
                           height, width, pad_value=1e9)[tiles, 0].contiguous()
    px, py = _tile_pixels(tiles, tile_w, tile_size)
    out = GesSplat.apply(means2d, conics, colors, opacities, gauss_depth,
                         bins.gids, ref_tiles, px, py, bins.pair_order,
                         bins.seg_lo, bins.seg_hi, delta_depth)
    full = out.new_zeros((T, C + 1, P))
    full[tiles] = out
    img = full.reshape(tile_h, tile_w, C + 1, tile_size, tile_size) \
        .permute(0, 3, 1, 4, 2).reshape(tile_h * tile_size, tile_w * tile_size,
                                         C + 1)[:height, :width]
    return img[..., :C], img[..., C]


def hoist_window_tiles(bins: ActiveBins, ref_clamped, gt_rgb, base_color,
                       width: int, height: int, tile_size: int) -> dict:
    """Per-window constants of the tile-space L1 loss path.

    With the binning fixed for a window's Adam steps, tiles outside
    `bins.tiles` always render the SDF base layer exactly, so their L1
    share is a per-camera constant (`inactive_sum`) and each step only
    evaluates the active tiles.  Returns the lists and segments, the
    per-tile reference depth, gt and base rows, pixel coordinates, the
    crop mask of edge tiles (`pxmask`: pixels past the image edge carry no
    loss) and `inactive_sum`.  The JAX package pads A to a multiple of 64
    for its chunked scan; padding tiles contribute exact zeros, so the
    port keeps the exact A."""
    tile_w = -(-width // tile_size)
    tile_h = -(-height // tile_size)
    tiles = bins.tiles
    view = lambda img, pad=0.0: _tile_view(img, tile_h, tile_w, tile_size,  # noqa: E731
                                           height, width, pad)[tiles]
    ref_tiles = view(ref_clamped[..., None], 1e9)[:, 0].contiguous()
    gt_t = view(gt_rgb)
    base_t = view(base_color)
    px, py = _tile_pixels(tiles, tile_w, tile_size)
    pxmask = ((px < width) & (py < height)).to(torch.float32)
    full_sum = (base_color - gt_rgb).abs().sum()
    active_base_sum = ((base_t - gt_t).abs() * pxmask[:, None, :]).sum()
    return {
        "gids": bins.gids, "ref_tiles": ref_tiles, "px": px, "py": py,
        "gt_t": gt_t, "base_t": base_t, "pxmask": pxmask,
        "inactive_sum": full_sum - active_base_sum,
        "pair_order": bins.pair_order, "seg_lo": bins.seg_lo,
        "seg_hi": bins.seg_hi,
    }


def ges_splat_tiles(means2d, conics, colors, opacities, gauss_depth,
                    hoist: dict, delta_depth: float) -> torch.Tensor:
    """Active-tile GES sums [A, C+1, P] against hoisted per-window tensors
    (the per-step core of the tile-space loss path; last channel = weight
    sum)."""
    return GesSplat.apply(means2d, conics, colors, opacities, gauss_depth,
                          hoist["gids"], hoist["ref_tiles"], hoist["px"],
                          hoist["py"], hoist["pair_order"], hoist["seg_lo"],
                          hoist["seg_hi"], delta_depth)
