"""Offline trainer — the port of gps_slam_tpu/slam/offline.py (the
reference's Pipeline, src/pipeline.cpp).

`raw_train_cams`: classic 3DGS training, PIPE.max_iterations Adam steps,
each on one camera drawn by `RandomSelector`, rendered by `raw_forward`
(depth-ordered front-to-back compositing); with PIPE.enable_densify the
screen-space gradients of the projected means accumulate into densify
statistics, and every `densify_interval` iterations `densify_step` clones,
splits and prunes (except for PAUSE_REFINE_AFTER_RESET iterations after
an opacity reset), with the touched rows' Adam moments zeroed.
`ges_train_cams`: the same loop with the GES render against precomputed
raycast targets, through the splat kernels.  The whole pool is trained
(no compact prefix): densify keeps rows in place.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..config import Config
from ..data.reader import DatasetReader, RandomSelector
from ..gs import densify as dmod, losses, model as gmodel, optim
from ..gs.model import GaussianModel
from ..utils import io as uio


def _train_iter(pool, opt: optim.WindowAdam, cam: dict, st, ssim_weight: float,
                method: str, ref_depth=None, base_color=None,
                want_probe_grad: bool = False, active_sh_degree=None):
    """One offline iteration on `pool`, in place: render (`method` "raw" or
    "ges"), loss, backward, one Adam step of `opt`.  Returns (loss, the
    gradient of the loss in the projected means [C, 2] when
    `want_probe_grad` on the raw method, else None, radii)."""
    params = pool.params
    probe = None
    if method == "raw" and want_probe_grad:
        probe = torch.zeros((pool.capacity, 2), device=pool.device,
                            requires_grad=True)
    for v in params.values():
        v.requires_grad_(True)
    try:
        if method == "raw":
            res = gmodel.raw_forward(params, pool.alive, cam["c2w"], cam["K"],
                                     cam["cam_id"], st, means2d_probe=probe,
                                     active_sh_degree=active_sh_degree)
        else:
            res = gmodel.ges_forward(params, pool.alive, cam["c2w"], cam["K"],
                                     ref_depth, base_color, cam["cam_id"], st,
                                     active_sh_degree=active_sh_degree)
        loss = losses.compute_loss(res["rgb"], res["depth"], cam["gt_rgb"], None,
                                   ssim_weight, 0.0)["total"]
        opt.zero_grad()
        loss.backward()
    finally:
        for v in params.values():
            v.requires_grad_(False)
    opt.step()
    return loss.detach(), probe.grad if probe is not None else None, res["radii"]


class OfflinePipeline:
    """Pipeline base (src/pipeline.cpp:5-54 loadConfig/save)."""

    def __init__(self, cfg: Config, workspace_dir: str):
        self.cfg = cfg
        self.workspace_dir = workspace_dir
        self.model_path = workspace_dir + cfg.pipe.model_path
        self.eval_path = workspace_dir + cfg.pipe.eval_path
        self.log_path = workspace_dir + cfg.pipe.log_path
        self.curr_iter = 0
        self.scene_scale = 1.0
        # camera draws: the JAX package's numpy generator and seed
        self._rng = np.random.default_rng(cfg.dev_id + 7)
        os.makedirs(self.log_path, exist_ok=True)
        try:  # TensorBoard scalars are optional, as in the JAX package
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            self._tb = None
        else:
            self._tb = SummaryWriter(self.log_path)
        self._loss_buf: list = []  # (iteration, device scalar) pairs

    # -- logging (logResults / logScalars, src/pipeline.cpp:57-152) -----------

    def _log_scalar_lazy(self, lval) -> None:
        """Keep the device loss scalar; read at the next image log, so the
        loop does not wait for the card every iteration."""
        self._loss_buf.append((self.curr_iter, lval))

    def _flush_scalars(self) -> None:
        if self._tb is not None:
            for it, lv in self._loss_buf:
                self._tb.add_scalar("loss/total", float(lv), it)
        self._loss_buf.clear()

    def log_results(self, model: GaussianModel, cam, render_res: dict,
                    log_mode: str = "auto") -> None:
        """TensorBoard scalars every call; comparison images (colour, alpha
        jet, depth) to log_path as frame{ID}_iter{N}.*.jpg every log_iter
        iterations and at the last."""
        from ..utils import vis

        p = self.cfg.pipe
        self._flush_scalars()
        if self._tb is not None:
            self._tb.add_scalar("gs_num", model.num_gaussians, self.curr_iter)
        if log_mode == "only scalar":
            return
        log_image = (log_mode == "scaler and image"
                     or (log_mode == "auto"
                         and (self.curr_iter % p.log_iter == 0
                              or self.curr_iter + 1 == p.max_iterations)))
        if not log_image:
            return
        frame_id = getattr(cam, "get_frame_id", lambda: str(getattr(cam, "id", 0)))()
        base = os.path.join(self.log_path, f"frame{frame_id}_iter{self.curr_iter}")

        def host(x):
            return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)

        rgb = np.clip(host(render_res["rgb"]), 0.0, 1.0)
        vis.imwrite_rgb(base + ".color.jpg",
                        vis.color_comp_img(rgb, np.asarray(cam.image), 0.0,
                                           p.color_error_max))
        if render_res.get("alpha") is not None:
            vis.imwrite_rgb(base + ".alpha.jpg",
                            vis.jet(host(render_res["alpha"]), 0.0, p.alpha_vis_max))
        if render_res.get("depth") is not None:
            dep = host(render_res["depth"])
            if getattr(cam, "depth", None) is not None:
                gtd = np.asarray(cam.depth)
                gtd = gtd[..., 0] if gtd.ndim == 3 else gtd
                vis.imwrite_rgb(base + ".depth.jpg",
                                vis.depth_comp_img(dep, gtd, p.depth_vis_min,
                                                   p.depth_vis_max, 0.0,
                                                   p.depth_error_max))
            else:
                vis.imwrite_rgb(base + ".depth.jpg",
                                vis.jet(dep, p.depth_vis_min, p.depth_vis_max))

    # -- shared ---------------------------------------------------------------

    def _cams_on_device(self, model: GaussianModel, cams: list) -> list[dict]:
        dev = model.device
        return [{"c2w": torch.as_tensor(c.c2w, dtype=torch.float32, device=dev),
                 "K": torch.as_tensor(c.K), "cam_id": int(c.id),
                 "gt_rgb": torch.as_tensor(c.image, dtype=torch.float32, device=dev)}
                for c in cams]

    def _next_cam(self, selector: RandomSelector) -> int:
        if self.cfg.pipe.selected_cam_idx >= 0:
            return self.cfg.pipe.selected_cam_idx
        return selector.get_next()[1]

    def _sh_degree(self, model: GaussianModel) -> torch.Tensor:
        """The SH warm-up ramp: one band every sh_degree_interval
        iterations, up to MODEL.sh_degree."""
        m = self.cfg.model
        return torch.tensor(min(self.curr_iter // max(m.sh_degree_interval, 1),
                                m.sh_degree), dtype=torch.int32, device=model.device)

    # -- raw mode -------------------------------------------------------------

    def raw_train_cams(self, model: GaussianModel, cams: list) -> None:
        cfg, m = self.cfg, self.cfg.model
        dev = model.device
        model.init_optimizers(cfg)
        selector = RandomSelector(list(range(len(cams))), self._rng)
        C = model.pool.capacity
        grad_2d = torch.zeros(C, device=dev)
        vis_count = torch.zeros(C, device=dev)
        densify_on = cfg.pipe.enable_densify
        if densify_on:
            # densify's Adam-moment surgery is aligned to fixed pool rows
            model.pool_compact = False
        f32 = dict(dtype=torch.float32, device=dev)
        img_scale = torch.tensor([model.statics.width / 2.0,
                                  model.statics.height / 2.0], **f32)
        thresholds = torch.tensor([m.densify_grad_thres, m.densify_large_thres,
                                   m.split_screen_size, m.prune_opacity_thres], **f32)
        cam_dev = self._cams_on_device(model, cams)
        while self.curr_iter < cfg.pipe.max_iterations:
            it = self.curr_iter
            ci = self._next_cam(selector)
            want_grad = densify_on and it < m.densify_end_iter
            sh_deg = self._sh_degree(model)
            lval, probe_grad, radii = _train_iter(
                model.pool, model.opt_state, cam_dev[ci], model.statics,
                cfg.pipe.ssim_weight, "raw", want_probe_grad=want_grad,
                active_sh_degree=sh_deg)
            self._log_scalar_lazy(lval)
            if it % cfg.pipe.log_iter == 0 or it + 1 == cfg.pipe.max_iterations:
                with torch.no_grad():
                    res = gmodel.raw_forward(
                        model.pool.params, model.pool.alive, cam_dev[ci]["c2w"],
                        cam_dev[ci]["K"], cam_dev[ci]["cam_id"], model.statics,
                        active_sh_degree=sh_deg)
                self.log_results(model, cams[ci], res)
            if want_grad:
                # updateDensifyGrad (raw_gs_model.cpp:459-503)
                vis = radii > 0
                gnorm = torch.linalg.vector_norm(probe_grad * img_scale, dim=-1)
                grad_2d = torch.where(vis, grad_2d + gnorm, grad_2d)
                vis_count = torch.where(vis, vis_count + 1.0, vis_count)
                if it % m.densify_interval == 0 and it > m.densify_start_iter:
                    if it % m.reset_opacity_interval >= dmod.PAUSE_REFINE_AFTER_RESET:
                        _, touched, _ = dmod.densify_step(
                            model.pool, grad_2d, vis_count, model.next_rng(),
                            torch.tensor(self.scene_scale, **f32), thresholds,
                            cfg.tpu.max_new_gaussians,
                            it > m.reset_opacity_interval)
                        optim.zero_state_rows(model.opt_state, touched)
                    grad_2d = torch.zeros_like(grad_2d)
                    vis_count = torch.zeros_like(vis_count)
                if it > 0 and it % m.reset_opacity_interval == 0:
                    dmod.reset_opacities(
                        model.pool, torch.tensor(2.0 * m.prune_opacity_thres, **f32))
            self.curr_iter += 1

    # -- ges mode (offline, precomputed raycast targets) -----------------------

    def ges_train_cams(self, model: GaussianModel, cams: list,
                       raycast_targets: list[dict]) -> None:
        """The raw loop with the GES render against each camera's raycast
        depth and colour (`raycast_targets[i]`: "depth_map" [H, W(, 1)],
        "color_map" [H, W, 3])."""
        cfg = self.cfg
        dev = model.device
        model.init_optimizers(cfg)
        selector = RandomSelector(list(range(len(cams))), self._rng)
        cam_dev = self._cams_on_device(model, cams)
        targets = []
        for rt in raycast_targets:
            d = torch.as_tensor(rt["depth_map"], dtype=torch.float32, device=dev)
            targets.append((d[..., 0] if d.ndim == 3 else d,
                            torch.as_tensor(rt["color_map"], dtype=torch.float32,
                                            device=dev)))
        while self.curr_iter < cfg.pipe.max_iterations:
            ci = self._next_cam(selector)
            ref_depth, base_color = targets[ci]
            sh_deg = self._sh_degree(model)
            lval, _, _ = _train_iter(
                model.pool, model.opt_state, cam_dev[ci], model.statics,
                cfg.pipe.ssim_weight, "ges", ref_depth=ref_depth,
                base_color=base_color, active_sh_degree=sh_deg)
            self._log_scalar_lazy(lval)
            if (self.curr_iter % cfg.pipe.log_iter == 0
                    or self.curr_iter + 1 == cfg.pipe.max_iterations):
                with torch.no_grad():
                    res = gmodel.ges_forward(
                        model.pool.params, model.pool.alive, cam_dev[ci]["c2w"],
                        cam_dev[ci]["K"], ref_depth, base_color,
                        cam_dev[ci]["cam_id"], model.statics, active_sh_degree=sh_deg)
                self.log_results(model, cams[ci], res)
            self.curr_iter += 1

    def save(self, model: GaussianModel, reader: DatasetReader) -> None:
        self._flush_scalars()
        model.save(self.model_path)
        uio.save_cameras_json(reader.train_vec,
                              os.path.join(self.model_path, "cameras.json"))
        uio.save_cfg_args(os.path.join(self.model_path, "cfg_args"),
                          self.cfg.model.sh_degree)
