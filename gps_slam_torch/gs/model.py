"""Gaussian model — the port of gps_slam_tpu/gs/model.py: the GES render
(`ges_forward`, with `ges_bin` for a binning reused across a window), the
classic render of the offline `raw` method (`raw_forward`), batched eval
renders, the per-window Adam loop (`window_optimize`), SLAM-mode spawning
(`add_gaussians`), redundancy pruning and the `GaussianModel` host facade
with the offline trainers' optimizer state and model.npz / model.pt / PLY
persistence.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..config import Config
from ..utils.se3 import pose_inv
from . import gauss_step, losses, optim, params as pmod, projection, rasterize
from .params import GaussianPool


class RenderStatics(NamedTuple):
    """Render settings from the MODEL / TPU config sections."""

    width: int
    height: int
    sh_degree: int
    tile_size: int
    max_gs_radii: int
    delta_depth: float
    use_exposure: bool
    visible_cap: int
    tiles_per_gaussian_cap: int
    tile_cap: int
    eps2d: float = 0.3
    near_plane: float = 0.01
    far_plane: float = 1e10
    radius_clip: float = 0.0
    active_tile_cap: int = 2048
    bin_margin_px: float = 2.0


class ProjectSH(torch.autograd.Function):
    """Projection and SH colours of every row (`gauss_step.project_sh_fwd`)
    with the analytic backward (`gauss_step.project_sh_bwd`): on the card
    one launch of each of `project_sh_fwd_cuda` and `project_sh_bwd_cuda`.
    Only the inputs and the radii are saved; the backward recomputes the
    rest.  Gradients reach the means, quats, log-scales and both SH
    arrays; the camera and the active degree take none, the radii are not
    differentiable."""

    @staticmethod
    def forward(ctx, means, quats, log_scales, features_dc, features_rest, alive,
                viewmat, c2w, active_degree, cam, st):
        if ctx.needs_input_grad[6] or ctx.needs_input_grad[7]:
            raise NotImplementedError("ProjectSH: no gradient reaches the camera")
        out = gauss_step.project_sh_fwd(means, quats, log_scales, features_dc,
                                        features_rest, alive, viewmat, c2w,
                                        active_degree, cam, st)
        radii = out[3]
        ctx.mark_non_differentiable(radii)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(means, quats, log_scales, features_dc, features_rest,
                              radii, viewmat, c2w, active_degree)
        ctx.cam, ctx.st = cam, st
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, v_means2d, v_conics, v_depths, _v_radii, v_colors):
        g_means, g_quats, g_scales, g_dc, g_rest = gauss_step.project_sh_bwd(
            *ctx.saved_tensors, ctx.cam, ctx.st,
            *(None if v is None else v.contiguous()
              for v in (v_means2d, v_conics, v_depths, v_colors)))
        # what the loss does not reach takes no grad, as in autograd
        if v_means2d is None and v_conics is None and v_depths is None:
            g_quats = g_scales = None
        if v_colors is None:
            g_dc = g_rest = None
        return g_means, g_quats, g_scales, g_dc, g_rest, None, None, None, None, None, None


def _project_and_colors(params, alive, c2w, K, st: RenderStatics,
                        active_sh_degree=None):
    """Projection and SH colours (+0.5, clamped at 0) shared by the GES and
    classic renders (`ProjectSH`); `active_sh_degree` is the offline SH
    ramp."""
    cam = projection.camera(K, st.width, st.height)
    means2d, conics, depths, radii, colors = ProjectSH.apply(
        params["means"], params["quats"], params["scales"], params["features_dc"],
        params["features_rest"], alive, pose_inv(c2w), c2w, active_sh_degree, cam, st)
    proj = projection.Projection(radii=radii, means2d=means2d, depths=depths,
                                 conics=conics)
    return proj, radii, colors


def ges_bin(params, alive, c2w, K, st: RenderStatics,
            margin_px: float = 0.0, static: bool = False) -> rasterize.ActiveBins:
    """Active-tile binning of the current parameters, split out so that one
    binning serves a window's Adam steps (`margin_px` inflates every radius
    to keep the lists conservative while the Gaussians drift); `static`:
    the fixed-shape binning of the window megastep."""
    proj, radii, _ = _project_and_colors(params, alive, c2w, K, st)
    tile_w = -(-st.width // st.tile_size)
    tile_h = -(-st.height // st.tile_size)
    return rasterize.bin_gaussians_active(
        proj.means2d, radii, st.tile_size, tile_w, tile_h, st.visible_cap,
        st.tiles_per_gaussian_cap, st.tile_cap, st.active_tile_cap,
        margin_px=margin_px, segments=True, static=static)


def ges_forward(params: dict, alive, c2w, K, ref_depth, base_color,
                cam_id: int, st: RenderStatics,
                bins: rasterize.ActiveBins | None = None,
                active_sh_degree=None, static: bool = False) -> dict:
    """project -> SH -> bin -> weighted-sum rasterize -> blend with the
    SDF base layer: rgb = (raw + base) / (weight + 1).  Pass `bins` to
    reuse an earlier binning (the window loop); `active_sh_degree` (an int
    tensor) is the offline SH ramp; `static` bins in fixed shapes with no
    host read (the window megastep).  Differentiable in the params."""
    ref = ref_depth
    ref_clamped = torch.where(ref < 0.01, 1000.0, ref)
    proj, radii, colors = _project_and_colors(params, alive, c2w, K, st,
                                              active_sh_degree)
    colors4 = torch.cat([colors, proj.depths[:, None]], 1)
    if bins is None:
        tile_w = -(-st.width // st.tile_size)
        tile_h = -(-st.height // st.tile_size)
        bins = rasterize.bin_gaussians_active(
            proj.means2d, radii, st.tile_size, tile_w, tile_h, st.visible_cap,
            st.tiles_per_gaussian_cap, st.tile_cap, st.active_tile_cap,
            static=static)
    raw, weight_sum = rasterize.ges_rasterize_active(
        proj.means2d, proj.conics, colors4,
        torch.sigmoid(params["opacities"][:, 0]), bins, ref_clamped,
        proj.depths, st.delta_depth, st.width, st.height, st.tile_size)
    raw_rgb, raw_depth = raw[..., :3], raw[..., 3]
    rgb = (raw_rgb + base_color) / (weight_sum[..., None] + 1.0)
    depth_w = (ref > 0).to(torch.float32)
    den = weight_sum + depth_w
    depth = torch.where(den > 0, (raw_depth + ref * depth_w)
                        / torch.clamp(den, min=1e-12), 0.0)
    if st.use_exposure:
        E = params["exposure"].shape[0]
        if 0 <= cam_id < E:
            exp = params["exposure"][cam_id]
            rgb = rgb @ exp[:, :3].T + exp[:, 3]
    return {
        "rgb": rgb, "depth": depth, "alpha": weight_sum, "radii": radii,
        "means2d": proj.means2d, "n_pairs": bins.n_pairs,
        "n_tile_overflow": bins.n_tile_overflow,
        "n_span_overflow": bins.n_span_overflow,
        "n_active_overflow": bins.n_active_overflow,
    }


def raw_forward(params: dict, alive, c2w, K, cam_id: int, st: RenderStatics,
                means2d_probe=None, active_sh_degree=None) -> dict:
    """The classic 3DGS render of the offline `raw` method: project -> SH ->
    depth-ordered binning -> front-to-back compositing; depth = blended
    depth / alpha.  `means2d_probe` ([C, 2] zeros with requires_grad) is
    added to the projected means, so its .grad after backward is
    d(loss)/d(means2d), the densify statistic.  `cam_id` is unused, as in
    the JAX package (the raw method has no exposure)."""
    from . import rasterize_classic as rcl

    proj, radii, colors = _project_and_colors(params, alive, c2w, K, st,
                                              active_sh_degree)
    means2d = proj.means2d
    if means2d_probe is not None:
        means2d = means2d + means2d_probe
    colors4 = torch.cat([colors, proj.depths[:, None]], 1)
    tile_w = -(-st.width // st.tile_size)
    tile_h = -(-st.height // st.tile_size)
    bins = rcl.bin_gaussians_depth(
        means2d, radii, proj.depths, st.tile_size, tile_w, tile_h,
        st.visible_cap, st.tiles_per_gaussian_cap, st.tile_cap)
    render, alpha = rcl.classic_rasterize(
        means2d, proj.conics, colors4, torch.sigmoid(params["opacities"][:, 0]),
        bins, st.width, st.height, st.tile_size)
    rgb, raw_depth = render[..., :3], render[..., 3]
    depth = raw_depth / torch.clamp(alpha, min=1e-10)
    return {"rgb": rgb, "depth": depth, "alpha": alpha, "radii": radii,
            "means2d": means2d, "n_pairs": bins.n_pairs,
            "n_tile_overflow": bins.n_tile_overflow,
            "n_span_overflow": bins.n_span_overflow}


def render_eval_batch(params, alive, cam_batch: dict, st: RenderStatics) -> dict:
    """Eval renders of stacked [M, ...] cameras (c2w, K, ref_depth,
    base_color, cam_id) -> stacked clipped rgb, alpha and depth."""
    outs = []
    for i in range(cam_batch["c2w"].shape[0]):
        res = ges_forward(params, alive, cam_batch["c2w"][i], cam_batch["K"][i],
                          cam_batch["ref_depth"][i], cam_batch["base_color"][i],
                          int(cam_batch["cam_id"][i]), st)
        outs.append({"rgb": torch.clamp(res["rgb"], 0.0, 1.0),
                     "alpha": res["alpha"], "depth": res["depth"]})
    return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


def _tile_loss(params: dict, alive, c2w, K, st: RenderStatics, h: dict):
    """The tile-space L1 of one camera against its hoisted tiles `h`."""
    proj, _, colors = _project_and_colors(params, alive, c2w, K, st)
    colors4 = torch.cat([colors, proj.depths[:, None]], 1)
    out = rasterize.ges_splat_tiles(
        proj.means2d, proj.conics, colors4,
        torch.sigmoid(params["opacities"][:, 0]), proj.depths, h,
        st.delta_depth)                                       # [A, 5, P]
    rgb_t = (out[:, :3] + h["base_t"]) / (out[:, 4:5] + 1.0)
    diff = (rgb_t - h["gt_t"]).abs() * h["pxmask"][:, None, :]
    return (diff.sum() + h["inactive_sum"]) / float(st.width * st.height * 3)


def window_loss(params: dict, alive, cam_batch: dict, st: RenderStatics,
                ssim_weight: float, depth_weight: float, tile_space: bool):
    """(per-camera bins, loss(m)) of the window loop: each camera of the
    stacked [M, ...] batch (c2w and ref_depth / base_color / gt_rgb /
    optional gt_depth on the device, K on the host, cam_id a list) is
    binned once for the window (`ges_bin` with `bin_margin_px`); loss(m)
    is the differentiable loss of camera m under `params`.  With
    `tile_space` it is the tile-space L1 of `rasterize.hoist_window_tiles`
    (needs ssim and depth weights 0 and no exposure), else
    `losses.compute_loss` on the assembled image."""
    c2w, K = cam_batch["c2w"], cam_batch["K"]
    M = c2w.shape[0]
    with torch.no_grad():
        bins = [ges_bin(params, alive, c2w[m], K[m], st,
                        margin_px=st.bin_margin_px) for m in range(M)]
    if tile_space:
        hoists = [rasterize.hoist_window_tiles(
            bins[m], torch.where(cam_batch["ref_depth"][m] < 0.01, 1000.0,
                                 cam_batch["ref_depth"][m]),
            cam_batch["gt_rgb"][m], cam_batch["base_color"][m],
            st.width, st.height, st.tile_size) for m in range(M)]

        def loss(m):
            return _tile_loss(params, alive, c2w[m], K[m], st, hoists[m])

        return bins, loss
    gt_moments = ([losses.ssim_gt_moments(cam_batch["gt_rgb"][m]) for m in range(M)]
                  if ssim_weight > 0 else [None] * M)

    def loss(m):
        res = ges_forward(params, alive, c2w[m], K[m], cam_batch["ref_depth"][m],
                          cam_batch["base_color"][m], int(cam_batch["cam_id"][m]),
                          st, bins=bins[m])
        gt_depth = cam_batch["gt_depth"][m] if "gt_depth" in cam_batch else None
        return losses.compute_loss(
            res["rgb"], res["depth"], cam_batch["gt_rgb"][m], gt_depth,
            ssim_weight, depth_weight, gt_ssim_moments=gt_moments[m])["total"]

    return bins, loss


def _pick(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """x[m] for a one-element device index `m`: a gather, no host read."""
    return x.index_select(0, m)[0]


def window_loss_static(params: dict, alive, cam_batch: dict, st: RenderStatics,
                       ssim_weight: float, depth_weight: float, tile_space: bool):
    """`window_loss` in fixed shapes (the JAX package's form): the cameras'
    `ges_bin(static=True)` binnings and hoists stacked [M, ...], and
    loss(m) for camera m given as a one-element int64 device tensor, which
    gathers its rows: nothing is read back to the host.  `cam_batch` holds
    c2w, ref_depth, base_color, gt_rgb (and gt_depth) stacked on the
    device and K, the [3, 3] intrinsics that every camera shares, on the
    host; there is no exposure."""
    c2w, K = cam_batch["c2w"], cam_batch["K"]
    M = c2w.shape[0]
    with torch.no_grad():
        per = [ges_bin(params, alive, c2w[m], K, st, margin_px=st.bin_margin_px,
                       static=True) for m in range(M)]
    bins = rasterize.ActiveBins(*(torch.stack(f) for f in zip(*per)))
    if tile_space:
        hoists = [rasterize.hoist_window_tiles(
            per[m], torch.where(cam_batch["ref_depth"][m] < 0.01, 1000.0,
                                cam_batch["ref_depth"][m]),
            cam_batch["gt_rgb"][m], cam_batch["base_color"][m],
            st.width, st.height, st.tile_size) for m in range(M)]
        hoist = {k: torch.stack([h[k] for h in hoists]) for k in hoists[0]}
        del per, hoists

        def loss(m):
            return _tile_loss(params, alive, _pick(c2w, m), K, st,
                              {k: _pick(v, m) for k, v in hoist.items()})

        return bins, loss
    del per
    gt_moments = None
    if ssim_weight > 0:
        mom = [losses.ssim_gt_moments(cam_batch["gt_rgb"][m]) for m in range(M)]
        gt_moments = tuple(torch.stack(f) for f in zip(*mom))

    def loss(m):
        b = rasterize.ActiveBins(*(_pick(x, m) for x in bins))
        res = ges_forward(params, alive, _pick(c2w, m), K,
                          _pick(cam_batch["ref_depth"], m),
                          _pick(cam_batch["base_color"], m), -1, st, bins=b)
        gt_depth = _pick(cam_batch["gt_depth"], m) if "gt_depth" in cam_batch else None
        return losses.compute_loss(
            res["rgb"], res["depth"], _pick(cam_batch["gt_rgb"], m), gt_depth,
            ssim_weight, depth_weight,
            gt_ssim_moments=(None if gt_moments is None
                             else tuple(_pick(x, m) for x in gt_moments)))["total"]

    return bins, loss


def window_optimize(pool: GaussianPool, cam_batch: dict, iter_cam_idx,
                    st: RenderStatics, mcfg, max_iterations: int,
                    ssim_weight: float, depth_weight: float,
                    opt_cap: int, static: bool = False) -> tuple[GaussianPool, dict]:
    """The reference's localOptimize loop: one Adam step per entry of
    `iter_cam_idx`, each on that camera of `cam_batch` (see
    `window_loss`), with optimizer state fresh for the window and the
    learning rates of `mcfg` (the config's ModelConfig).  The pool
    is compact (live rows first), so the steps work on leaf copies of its
    `opt_cap`-row prefix, written back at the end; the render caps are the
    prefix and the configured active-tile cap.  Release configs (ssim and
    depth weights 0, no exposure) take the tile-space L1 path.  Updates
    the pool in place; returns it with the loss of each step, the
    binning overflows summed over the window's cameras and, per camera,
    its (tile, span, active) overflows.

    With `static` (the window megastep) the window takes
    `window_loss_static`: `iter_cam_idx` is an int64 device tensor read by
    each step on the device, every count is a device scalar, and no
    per-camera lists are returned.  Its parameters are those of the
    dynamic form, bit for bit: the lists are the same padded with empty
    rows, which add exact zeros (only the loss value's sum runs over the
    padding, in another order)."""
    tile_w = -(-st.width // st.tile_size)
    tile_h = -(-st.height // st.tile_size)
    st = st._replace(visible_cap=min(st.visible_cap, opt_cap),
                     active_tile_cap=min(tile_w * tile_h, st.active_tile_cap))
    cparams = {k: (v if k == "exposure" else v[:opt_cap]).detach().clone()
               .requires_grad_(True) for k, v in pool.params.items()}
    steps = len(iter_cam_idx)
    opt = optim.WindowAdam(cparams, mcfg, max_iterations, steps=steps)
    tile_space = (ssim_weight == 0.0 and depth_weight == 0.0
                  and not st.use_exposure)
    make_loss = window_loss_static if static else window_loss
    bins, loss_fn = make_loss(cparams, pool.alive[:opt_cap], cam_batch, st,
                              ssim_weight, depth_weight, tile_space)
    hist = []
    for k in range(steps):
        loss = loss_fn(iter_cam_idx[k:k + 1] if static else int(iter_cam_idx[k]))
        opt.zero_grad()
        loss.backward()
        opt.step()
        hist.append(loss.detach())
    with torch.no_grad():
        for k, v in cparams.items():
            if k == "exposure":
                pool.exposure.copy_(v)
            else:
                getattr(pool, k)[:opt_cap] = v
    loss_hist = torch.stack(hist) if hist else pool.means.new_zeros((0,))
    if static:
        return pool, {
            "loss_hist": loss_hist,
            "n_tile_overflow": bins.n_tile_overflow.sum(),
            "n_span_overflow": bins.n_span_overflow.sum(),
            "n_active_overflow": bins.n_active_overflow.sum(),
        }
    return pool, {
        "loss_hist": loss_hist,
        "n_tile_overflow": sum(b.n_tile_overflow for b in bins),
        "n_span_overflow": sum(b.n_span_overflow for b in bins),
        "n_active_overflow": sum(b.n_active_overflow for b in bins),
        "bin_overflow": [(b.n_tile_overflow, b.n_span_overflow, b.n_active_overflow)
                         for b in bins],
        # per camera; a step whose camera has none launches no splat kernel
        "active_tiles": [int(b.tiles.shape[0]) for b in bins],
    }


def add_gaussians(pool: GaussianPool, vertex_map, color_map, normal_map,
                  sample_mask, sample_ratio: float, max_new: int,
                  default_opacity: float, scale_limits: tuple,
                  generator, host_count: bool = True):
    """SLAM-mode spawning: take `sample_ratio` of the masked pixels at
    random (uniform priorities from `generator`, or the [H*W] priorities
    themselves when it is a tensor: the window megastep draws them outside
    its graph), init attributes from the vertex/colour/normal maps and add
    them to the pool (`params.add_rows`).  Returns (pool, n_added,
    n_overflow), device scalars; nothing is read back to the host unless
    `host_count`, which brings `pool.n_alive` up to date."""
    flat_mask = sample_mask.reshape(-1)
    max_new = min(max_new, flat_mask.shape[0])
    n_valid = flat_mask.sum()
    prio = (generator if torch.is_tensor(generator) else
            torch.rand(flat_mask.shape, generator=generator, device=flat_mask.device))
    prio = torch.where(flat_mask, prio, torch.inf)
    idx = torch.argsort(prio, stable=True)[:max_new]
    # floor of the f32 product, as the JAX package takes it
    n_want = (n_valid.to(torch.float32) * sample_ratio).to(torch.int64)
    n_select = torch.clamp(n_want, max=max_new)
    xyz = vertex_map.reshape(-1, 3)[idx]
    rgb = color_map.reshape(-1, 3)[idx]
    nrm = normal_map.reshape(-1, 3)[idx]
    taken = (torch.arange(max_new, device=xyz.device) < n_select)[:, None]
    xyz = torch.where(taken, xyz, 1e6)
    min_s, max_s = scale_limits
    attrs = pmod.init_attributes(xyz, rgb, nrm, pool.sh_degree,
                                 default_opacity, max_s, min_s)
    n_added = pmod.add_rows(pool, attrs, n_select)
    if host_count:
        pool.n_alive += int(n_added)
    return pool, n_added, n_want - n_select


def remove_redundant(pool: GaussianPool, small_scale_thres: float,
                     large_scale_thres: float, low_opac_thres: float,
                     host_count: bool = True):
    """Prune too small, too large and too transparent Gaussians; returns
    (pool, the count pruned as a device scalar).  Only `host_count` reads
    it back, to bring `pool.n_alive` up to date."""
    max_scale = torch.exp(pool.scales).amax(-1)
    opac = torch.sigmoid(pool.opacities[:, 0])
    mask = ((max_scale < small_scale_thres) | (max_scale > large_scale_thres)
            | (opac < low_opac_thres)) & pool.alive
    n = pmod.remove_rows(pool, mask)
    if host_count:
        pool.n_alive -= int(n)
    return pool, n


class GaussianModel:
    """Host-side facade holding pool + config."""

    # prefix-size buckets of the compact pool: they fix the render caps
    # (visible and active-tile) exactly as the JAX package chooses them
    BUCKETS = (4096, 16384, 32768, 65536, 131072)

    def __init__(self, cfg: Config, width: int, height: int,
                 exposure_num: int = 0, device=None):
        m = cfg.model
        self.cfg = cfg
        self.device = resolve_device(device)
        self.pool = pmod.create(cfg.tpu.gaussian_capacity, m.sh_degree,
                                exposure_num, device=self.device)
        self.statics = RenderStatics(
            width=width, height=height, sh_degree=m.sh_degree,
            tile_size=cfg.tpu.tile_size, max_gs_radii=m.max_gs_radii,
            delta_depth=m.delta_depth, use_exposure=m.use_exposure,
            visible_cap=min(cfg.tpu.gaussian_capacity, cfg.tpu.visible_gaussian_cap),
            tiles_per_gaussian_cap=cfg.tpu.tiles_per_gaussian_cap,
            tile_cap=cfg.tpu.tile_gaussian_cap,
            active_tile_cap=cfg.tpu.active_tile_cap,
        )
        # spawn draws: one CPU generator seeded from dev_id hands each
        # window a fresh device generator, in call order
        self._rng = torch.Generator("cpu").manual_seed(cfg.dev_id)
        # the offline trainers' optimizer (init_optimizers)
        self.opt_state: optim.WindowAdam | None = None
        # the SLAM path keeps the live rows a prefix (spawn fills the free
        # tail, prune compacts); offline densify keeps rows in place, since
        # its Adam state is aligned to them
        self.pool_compact = True

    @property
    def num_gaussians(self) -> int:
        return self.pool.n_alive

    def opt_cap(self, extra: int = 0) -> int:
        """Smallest bucket covering the live prefix plus `extra` rows; the
        whole pool when it is not kept compact."""
        cap = self.pool.capacity
        if not self.pool_compact:
            return cap
        need = self.num_gaussians + extra
        for b in self.BUCKETS:
            if need <= b <= cap:
                return b
        return cap

    def init_optimizers(self, cfg: Config | None = None) -> None:
        """Fresh offline Adam state over the pool's own tensors, with the
        learning rates and PIPE.max_iterations of `cfg` (the trainer's; the
        model's own by default): one state across the run, the means
        learning rate decaying by the global step."""
        cfg = cfg or self.cfg
        self.opt_state = optim.WindowAdam(self.pool.params, cfg.model,
                                          cfg.pipe.max_iterations)

    def eval_slice(self, height: int | None = None, width: int | None = None):
        """(params, alive, statics) over the compact live prefix."""
        st = self.statics
        if height is not None and (height, width) != (st.height, st.width):
            st = st._replace(height=height, width=width)
        cap = self.opt_cap()
        tile_w = -(-st.width // st.tile_size)
        tile_h = -(-st.height // st.tile_size)
        st = st._replace(active_tile_cap=min(
            tile_w * tile_h, max(st.active_tile_cap, cap // 8)))
        if cap < self.pool.capacity:
            params = {k: (v if k == "exposure" else v[:cap])
                      for k, v in self.pool.params.items()}
            alive = self.pool.alive[:cap]
            st = st._replace(visible_cap=min(st.visible_cap, cap))
        else:
            params, alive = self.pool.params, self.pool.alive
        return params, alive, st

    def forward(self, c2w, K, ref_depth, base_color, cam_id: int = -1) -> dict:
        dev = self.device
        ref = torch.as_tensor(ref_depth, device=dev)
        if ref.ndim == 3:
            ref = ref[..., 0]
        params, alive, st = self.eval_slice(ref.shape[0], ref.shape[1])
        return ges_forward(
            params, alive, torch.as_tensor(c2w, dtype=torch.float32, device=dev),
            torch.as_tensor(K), ref, torch.as_tensor(base_color, device=dev),
            int(cam_id), st)

    def forward_batch(self, cam_batch: dict) -> dict:
        H, W = cam_batch["ref_depth"].shape[1:3]
        params, alive, st = self.eval_slice(H, W)
        return render_eval_batch(params, alive, cam_batch, st)

    def next_rng(self) -> torch.Generator:
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=self._rng))
        return torch.Generator(self.device).manual_seed(seed)

    # -- persistence ---------------------------------------------------------

    def save(self, model_dir: str) -> None:
        """model.npz + model.pt + 3DGS-viewer binary PLY of the live rows."""
        from ..utils import io as uio

        os.makedirs(model_dir, exist_ok=True)
        alive = self.pool.alive.cpu().numpy()
        sel = np.nonzero(alive)[0]
        arrs = {}
        for k, v in self.pool.params.items():
            a = v.detach().cpu().numpy()
            arrs[k] = a[sel] if a.shape[0] == alive.shape[0] else a
        np.savez(os.path.join(model_dir, "model.npz"), **arrs)
        uio.save_model_pt(os.path.join(model_dir, "model.pt"), arrs)
        uio.save_gaussian_ply(
            os.path.join(model_dir, "point_cloud.ply"),
            arrs["means"], arrs["scales"], arrs["quats"],
            arrs["features_dc"], arrs["features_rest"], arrs["opacities"])

    def _load_attrs(self, attrs: dict) -> None:
        n = attrs["means"].shape[0]
        attrs = dict(attrs)
        if attrs["opacities"].ndim == 1:
            attrs["opacities"] = attrs["opacities"][:, None]
        exposure = attrs.pop("exposure", None)
        self.pool = pmod.create(
            self.pool.capacity, self.pool.sh_degree,
            exposure.shape[0] if exposure is not None else 0, device=self.device)
        if exposure is not None:
            self.pool.exposure = torch.as_tensor(exposure, device=self.device)
        pmod.add(self.pool, {k: torch.as_tensor(np.asarray(attrs[k], np.float32),
                                                device=self.device)
                             for k in pmod.ROW_KEYS}, n)

    def load(self, model_dir: str) -> None:
        """Open model.npz, model.pt or point_cloud.ply, in that order."""
        from ..utils import io as uio

        npz = os.path.join(model_dir, "model.npz")
        pt = os.path.join(model_dir, "model.pt")
        ply = os.path.join(model_dir, "point_cloud.ply")
        if os.path.exists(npz):
            z = np.load(npz)
            attrs = {k: z[k] for k in z.files}
        elif os.path.exists(pt):
            attrs = uio.load_model_pt(pt)
        elif os.path.exists(ply):
            attrs = uio.load_gaussian_ply(ply)
        else:
            raise FileNotFoundError(
                f"no model.npz / model.pt / point_cloud.ply under {model_dir}")
        self._load_attrs(attrs)
