"""SLAM orchestration, eager gt-pose path — the port of
gps_slam_tpu/slam/pipeline.py (`slam_train_cams` per-frame branch) and of
the spawn masks of gps_slam_tpu/slam/megastep.py.

Per frame: fuse with the gt pose, then local-window / keyframe
bookkeeping; every `local_opt_interval` frames: raycast the window and
the sampled keyframes, spawn Gaussians where the render's colour error is
high, run `local_opt_iters` Adam steps over the window's cameras
(`window_optimize`), prune.  Emits the reference's `time_log.txt` line
format (read by run/read_results.py).
"""

from __future__ import annotations

import os
import time
from collections import OrderedDict

import numpy as np
import torch

from ..config import Config
from ..gs import losses, model as gmodel, params as pmod
from ..gs.model import GaussianModel
from ..tsdf.engine import TsdfEngine
from ..utils import io as uio, vis
from ..utils.camera import Camera
from ..utils.se3 import compute_normal_map

DEPTH_SCALE = 5000.0  # frame-cache u16 depth quantization: 0.2 mm steps


class FrameCache:
    """Device-resident frames, quantized like the JAX package's
    DeviceFrameCache (rgb888 + u16 depth at 0.2 mm) so both packages fuse
    and compare against the same values."""

    def __init__(self, device, capacity: int = 256):
        self.device = device
        self.capacity = capacity
        self._cache: OrderedDict = OrderedDict()

    def get(self, cam: Camera):
        key = cam.id if cam.id >= 0 else id(cam)
        if key in self._cache:
            self._cache.move_to_end(key)
            return self._cache[key]
        rgb_u8 = np.clip(np.asarray(cam.image) * 255.0 + 0.5, 0, 255).astype(np.uint8)
        if cam.depth is not None:
            d = np.asarray(cam.depth)
            if d.ndim == 3:
                d = d[..., 0]
            depth_u16 = np.clip(d * DEPTH_SCALE + 0.5, 0, 65535).astype(np.uint16)
        else:
            depth_u16 = np.zeros(rgb_u8.shape[:2], np.uint16)
        rgb = torch.as_tensor(rgb_u8, device=self.device).to(torch.float32) / 255.0
        depth = torch.as_tensor(depth_u16.astype(np.int32),
                                device=self.device).to(torch.float32) / DEPTH_SCALE
        self._cache[key] = (rgb, depth)
        while len(self._cache) > self.capacity:
            self._cache.popitem(last=False)
        return rgb, depth


def _spawn_mask_bootstrap(depth, vertex, color, gt, vis_min, vis_max,
                          color_thres):
    """(mask, normal) for the spawn on an empty model."""
    valid = (depth > vis_min) & (depth < vis_max) & (vertex.abs().sum(-1) > 0)
    color_error = (color - gt).abs().mean(-1)
    return (color_error > color_thres) & valid, compute_normal_map(vertex)


def _spawn_mask(depth, vertex, rgb_render, alpha, gt, vis_min, vis_max,
                color_thres, alpha_max):
    """(mask, normal) for the alpha-gated spawn."""
    valid = (depth > vis_min) & (depth < vis_max) & (vertex.abs().sum(-1) > 0)
    color_error = (rgb_render - gt).abs().mean(-1)
    mask = (color_error > color_thres) & valid & (alpha < alpha_max)
    return mask, compute_normal_map(vertex)


class SLAMPipeline:
    def __init__(self, cfg: Config, tsdf_engine: TsdfEngine, workspace_dir: str,
                 is_train: bool = True):
        self.cfg = cfg
        self.pipe = cfg.pipe
        self.engine = tsdf_engine
        self.device = tsdf_engine.device
        self.workspace_dir = workspace_dir
        self.eval_path = workspace_dir + cfg.pipe.eval_path
        self.model_path = workspace_dir + cfg.pipe.model_path
        self.log_path = workspace_dir + cfg.pipe.log_path
        self.curr_iter = 0
        self.curr_frame_id = 0
        self.curr_cam: Camera | None = None
        self.localframe_cam_window: list[Camera] = []
        self.localframe_raycast_window: list[dict] = []
        self.keyframe_cam_list: list[Camera] = []
        self.opt_cam_list: list[Camera] = []
        self.opt_raycast_list: list[dict] = []
        self.keyframe_loss_dict: dict[str, list[float]] = {}
        self._rng = np.random.default_rng(cfg.dev_id + 1)
        self.frame_cache = FrameCache(self.device)
        if is_train:
            os.makedirs(self.log_path, exist_ok=True)
            os.makedirs(os.path.join(workspace_dir, cfg.pipe.tsdf.saved_images),
                        exist_ok=True)
            os.makedirs(os.path.join(workspace_dir, "before_opt"), exist_ok=True)
        self._pose_idx: dict[int, int] = {}
        self._spawn_overflow = 0
        self._bin_overflow = [0, 0, 0]   # tile, span and active caps
        self._last_loss_hist = None
        self.t_fusion = self.t_local_raycast = self.t_key_raycast = 0.0
        self.t_init_gs = self.t_opt = self.t_remove = 0.0

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------ loop

    def slam_train_cams(self, model: GaussianModel, cams: list[Camera]) -> None:
        """SLAMTrainCams (slam_pipeline.cpp:52-173), one frame at a time."""
        p = self.pipe
        total = len(cams)
        t_start = time.monotonic()
        for i, cam in enumerate(cams):
            t0 = time.monotonic()
            rgb, depth = self.frame_cache.get(cam)
            pose = self.engine.process_frame(rgb, depth)
            self.curr_frame_id = i
            cam.c2w_slam = np.asarray(pose)
            self._pose_idx[cam.id] = len(self.engine.cam_poses) - 1
            self.curr_cam = cam
            self.update_frame_list()
            self._sync()
            self.t_fusion += (time.monotonic() - t0) * 1000.0
            if self.cfg.work_mode == "recon":
                continue
            if i % p.local_opt_interval == 0 and i > 0:
                t1 = time.monotonic()
                self._raycast_opt_set()
                self._write_window_raycast_artifacts()
                self._sync()
                t2 = time.monotonic()
                self.init_new_gaussians(model, self.localframe_raycast_window[-1])
                self._sync()
                t3 = time.monotonic()
                self.local_optimize(model)
                self._sync()
                t4 = time.monotonic()
                self.remove_redundant(model)
                if p.kf_sample_method == "ours":
                    self.check_key_frame_error(model)
                self._sync()
                t5 = time.monotonic()
                self.t_local_raycast += (t2 - t1) * 1000
                self.t_init_gs += (t3 - t2) * 1000
                self.t_opt += (t4 - t3) * 1000
                self.t_remove += (t5 - t4) * 1000
        self._sync()
        self.write_time_log(model, total, (time.monotonic() - t_start) * 1000.0)

    def write_time_log(self, model: GaussianModel, total_frames: int,
                       total_ms: float) -> None:
        """[PIPELINE AVG TIME] line (slam_pipeline.cpp:166-172)."""
        n = max(total_frames, 1)
        fps = total_frames / (total_ms / 1000.0) if total_ms > 0 else 0.0
        line = (
            "[PIPELINE AVG TIME] GS num: %d, per frame fusion time: %f, "
            "localFrameRaycast time: %f, keyFrameRaycast time: %f, "
            "initNewGaussians time: %f, localOptimize time: %f, FPS: %f\n"
            % (model.num_gaussians, self.t_fusion / n, self.t_local_raycast / n,
               self.t_key_raycast / n, self.t_init_gs / n, self.t_opt / n, fps))
        mem_mb = (int(torch.cuda.max_memory_allocated(self.device) // 2 ** 20)
                  if self.device.type == "cuda" else 0)
        print(line, end="")
        print(f"GPU memory usage: {mem_mb} MB")
        if self._spawn_overflow > 0:
            print(f"[SPAWN OVERFLOW] {self._spawn_overflow} masked samples "
                  f"beyond max_new_gaussians were dropped")
        tile_o, span_o, act_o = self._bin_overflow
        bin_overflow = tile_o + span_o + act_o
        if bin_overflow > 0:
            print(f"[BIN OVERFLOW] {bin_overflow} optimizer binning entries "
                  f"dropped (tile cap: {tile_o}, span cap: {span_o}, "
                  f"active cap: {act_o})")
        os.makedirs(self.workspace_dir, exist_ok=True)
        with open(os.path.join(self.workspace_dir, "time_log.txt"), "w") as f:
            f.write(line)
            f.write(f"GPU memory usage: {mem_mb} MB\n")
            f.write(f"Spawn overflow: {self._spawn_overflow}\n")
            f.write(f"Bin overflow: {bin_overflow}\n")

    # --------------------------------------------------------------- windows

    def update_frame_list(self) -> None:
        """(updateFrameList, slam_pipeline.cpp:319-360)."""
        p = self.pipe
        if self.curr_frame_id == 0:
            return
        if self.curr_frame_id % p.localframe_cam_window_interval == 0:
            self.localframe_cam_window.append(self.curr_cam)
            if len(self.localframe_cam_window) == p.localframe_cam_window_length + 1:
                self.localframe_cam_window.pop(0)
        is_keyframe = not self.keyframe_cam_list
        if not is_keyframe:
            last = self.keyframe_cam_list[-1]
            prev_R, prev_t = last.c2w_slam[:3, :3], last.c2w_slam[:3, 3]
            cur_R, cur_t = self.curr_cam.c2w_slam[:3, :3], self.curr_cam.c2w_slam[:3, 3]
            cos = np.clip((np.trace(prev_R.T @ cur_R) - 1) / 2, -1, 1)
            theta = np.degrees(np.arccos(cos))
            trans = float(np.linalg.norm(prev_t - cur_t))
            if theta > p.keyframe_theta_thres or trans > p.keyframe_trans_thres:
                is_keyframe = True
        if is_keyframe:
            self.keyframe_cam_list.append(self.curr_cam)
            self.keyframe_loss_dict[self.curr_cam.get_frame_id()] = [
                0.1, float(self.curr_frame_id), 0.0, 0.0, 0.0]

    # --------------------------------------------------------------- raycast

    def _recorded_pose(self, cam: Camera) -> np.ndarray:
        k = self._pose_idx.get(cam.id, -1)
        if self.engine.cam_poses and 0 <= k < len(self.engine.cam_poses):
            return self.engine.cam_poses[k]
        return np.asarray(cam.c2w, np.float32)

    def run_raycast_by_cam(self, cam: Camera, quality: bool = False) -> dict:
        """(runRaycastByCam, slam_pipeline.cpp:362-415)."""
        return self.engine.run_raycast(self._recorded_pose(cam), cam.K,
                                       cam.width, cam.height, quality=quality)

    def _raycast_opt_set(self) -> None:
        """localFrameRaycast + keyFrameRaycast: the opt set is the local
        window plus up to keyframe_select_max random keyframes ('random'
        sampling only), drawn from the same numpy stream as the JAX
        package."""
        self.opt_cam_list = list(self.localframe_cam_window)
        n_sel = (min(self.pipe.keyframe_select_max, len(self.keyframe_cam_list))
                 if self.pipe.kf_sample_method == "random" else 0)
        if n_sel > 0:
            sel = self._rng.permutation(len(self.keyframe_cam_list))[:n_sel]
            for k in sel:
                self.opt_cam_list.append(self.keyframe_cam_list[int(k)])
        n_local = len(self.localframe_cam_window)
        if not self.opt_cam_list:
            self.localframe_raycast_window = []
            self.opt_raycast_list = []
            return
        uniform = all(
            cam.width == self.engine.width and cam.height == self.engine.height
            and np.allclose(np.asarray(cam.K), self.engine.K)
            for cam in self.opt_cam_list)
        if not uniform:
            rows = [self.run_raycast_by_cam(c) for c in self.opt_cam_list]
        else:
            maps = self.engine.run_raycast_batch(
                np.stack([self._recorded_pose(c) for c in self.opt_cam_list]))
            rows = [{k: v[i] for k, v in maps.items() if k != "n_tile_overflow"}
                    for i in range(len(self.opt_cam_list))]
        self.localframe_raycast_window = rows[:n_local]
        self.opt_raycast_list = rows

    def _write_window_raycast_artifacts(self) -> None:
        """Per-window raycast comparison images (log_slam_state)."""
        if not self.pipe.log_slam_state:
            return
        p = self.pipe
        out_dir = os.path.join(self.workspace_dir, p.tsdf.saved_images)
        cur = self.curr_cam.get_frame_id()
        for cam, rays in zip(self.localframe_cam_window,
                             self.localframe_raycast_window):
            rc = np.clip(rays["color_map"].cpu().numpy(), 0, 1)
            fid = cam.get_frame_id()
            vis.imwrite_rgb(os.path.join(out_dir, f"frame{cur}_{fid}.color.jpg"),
                            vis.color_comp_img(rc, cam.image, 0, p.color_error_max))
            vis.imwrite_rgb(
                os.path.join(out_dir, f"frame{cur}_{fid}.depth.jpg"),
                vis.depth_comp_img(rays["depth_map"].cpu().numpy(), cam.depth,
                                   0, p.depth_vis_max, 0, p.depth_error_max))

    # ----------------------------------------------------------------- spawn

    def init_new_gaussians(self, model: GaussianModel, raycast_maps: dict) -> None:
        """(initNewGaussians :450-526)."""
        p = self.pipe
        cam = self.curr_cam
        depth = raycast_maps["depth_map"][..., 0]
        vertex = raycast_maps["vertex_map"]
        color = raycast_maps["color_map"]
        gt, _ = self.frame_cache.get(cam)
        if model.num_gaussians == 0:
            mask, normal = _spawn_mask_bootstrap(
                depth, vertex, color, gt, p.depth_vis_min, p.depth_vis_max,
                p.color_error_thres)
        else:
            res = model.forward(cam.c2w_slam, cam.K, depth, color)
            mask, normal = _spawn_mask(
                depth, vertex, res["rgb"], res["alpha"], gt, p.depth_vis_min,
                p.depth_vis_max, p.color_error_thres, p.alpha_vis_max)
            if p.log_slam_state:
                vis.imwrite_rgb(
                    os.path.join(self.workspace_dir, "before_opt",
                                 f"frame{cam.get_frame_id()}.jpg"),
                    vis.color_comp_img(np.clip(res["rgb"].cpu().numpy(), 0, 1),
                                       cam.image, 0, p.color_error_max))
        raycast_maps["normal_map"] = normal
        _, _, n_overflow = gmodel.add_gaussians(
            model.pool, vertex, gt, normal, mask, p.new_gs_sample_ratio,
            self.cfg.tpu.max_new_gaussians, self.cfg.model.default_opacities,
            (self.cfg.model.min_init_scale, self.cfg.model.max_init_scale),
            model.next_rng())
        self._spawn_overflow += n_overflow

    # -------------------------------------------------------------- optimize

    def local_optimize(self, model: GaussianModel) -> None:
        """(localOptimize :195-291): `local_opt_iters` Adam steps over the
        window's cameras, in shuffled epochs of the opt set drawn from the
        same numpy stream as the JAX package, on the compact pool prefix
        (the live count plus the spawn bound, read exactly).  Zero steps
        still bin the cameras, as the JAX call does, for the overflow
        counts."""
        p = self.pipe
        cams = self.opt_cam_list
        n_valid = len(cams)
        if n_valid == 0:
            return
        dev = self.device
        batch = {
            "c2w": torch.as_tensor(np.stack([c.c2w_slam for c in cams]),
                                   dtype=torch.float32, device=dev),
            "K": torch.as_tensor(np.stack([np.asarray(c.K, np.float32) for c in cams])),
            "cam_id": [c.id for c in cams],
            "gt_rgb": torch.stack([self.frame_cache.get(c)[0] for c in cams]),
            "ref_depth": torch.stack([r["depth_map"][..., 0]
                                      for r in self.opt_raycast_list]),
            "base_color": torch.stack([r["color_map"] for r in self.opt_raycast_list]),
        }
        if p.depth_weight > 0:
            batch["gt_depth"] = torch.stack([self.frame_cache.get(c)[1] for c in cams])
        # shuffled without replacement, reset every epoch, so a short
        # window visits every camera evenly
        idx_seq: list[int] = []
        while len(idx_seq) < p.local_opt_iters:
            idx_seq.extend(int(v) for v in self._rng.permutation(n_valid))
        model.pool, aux = gmodel.window_optimize(
            model.pool, batch, idx_seq[:p.local_opt_iters], model.statics,
            self.cfg.model, p.max_iterations,
            p.ssim_weight, p.depth_weight,
            model.opt_cap(extra=self.cfg.tpu.max_new_gaussians))
        self.curr_iter += p.local_opt_iters
        self._last_loss_hist = aux["loss_hist"]
        for i, k in enumerate(("n_tile_overflow", "n_span_overflow",
                               "n_active_overflow")):
            self._bin_overflow[i] += aux[k]

    def check_key_frame_error(self, model: GaussianModel) -> None:
        """(checkKeyFrameError :293-317): re-evaluate the sampled
        keyframes' masked L1 after the window and record [loss, frame id,
        mean confidence, opt count].  In 'ours' mode the opt set holds no
        keyframes (they join only in 'random' mode), so the loop is empty
        there, as in the reference."""
        p = self.pipe
        n_local = len(self.localframe_cam_window)
        for cam, ray in zip(self.opt_cam_list[n_local:],
                            self.opt_raycast_list[n_local:]):
            res = model.forward(cam.c2w_slam, cam.K, ray["depth_map"][..., 0],
                                ray["color_map"])
            mask = (ray["depth_map"][..., 0] > 0)[..., None]
            loss = float(losses.l1(self.frame_cache.get(cam)[0], res["rgb"], mask))
            fid = cam.get_frame_id()
            prev = self.keyframe_loss_dict.get(fid, [0.1, 0.0, 0.0, 0.0, 0.0])
            opt_count = prev[3] + (1.0 if loss > p.kf_loss_thres else 0.0)
            self.keyframe_loss_dict[fid] = [
                loss, float(self.curr_frame_id),
                float(ray["confidence_map"].mean()), opt_count]

    def remove_redundant(self, model: GaussianModel) -> None:
        """(removeRedundantGs :564-586) + compaction to the pool prefix."""
        if model.num_gaussians == 0:
            return
        p = self.pipe
        gmodel.remove_redundant(model.pool, p.remove_small_scale_thres,
                                p.remove_large_scale_thres,
                                p.remove_low_opac_thres)
        pmod.compact(model.pool)

    # ------------------------------------------------------------------ eval

    def render_eval(self, model: GaussianModel, cams: list[Camera],
                    chunk: int = 0):
        """Yield (cams, raycast maps, render or None) per chunk of eval
        cameras: one batched raycast (k_blocks=2) + one batched render."""
        chunk = chunk or int(self.cfg.tpu.eval_chunk)
        n_gs = model.num_gaussians
        dev = self.device
        for a in range(0, len(cams), chunk):
            cs = cams[a:a + chunk]
            poses = np.stack([self._recorded_pose(c) for c in cs]).astype(np.float32)
            rays = self.engine.run_raycast_batch(poses, K=np.asarray(cs[0].K),
                                                 quality=True)
            res = None
            if n_gs > 0:
                batch = {
                    "c2w": torch.as_tensor(np.stack([c.c2w_slam for c in cs]),
                                           dtype=torch.float32, device=dev),
                    "K": torch.as_tensor(np.stack([c.K for c in cs]), device=dev),
                    "ref_depth": rays["depth_map"][..., 0],
                    "base_color": rays["color_map"],
                    "cam_id": torch.full((len(cs),), -1, dtype=torch.int32),
                }
                res = model.forward_batch(batch)
            yield cs, rays, res

    def render_eval_imgs(self, model: GaussianModel, cams: list[Camera],
                         names: tuple = ("rgb",), chunk: int = 0) -> None:
        """(renderEvalImgs :588-695): writes val/{gt,render,comp,
        raycast_color,raycast_depth} artifacts with the reference's names."""
        for sub in ("gt", "render", "comp", "raycast_color", "raycast_depth"):
            os.makedirs(os.path.join(self.eval_path, sub), exist_ok=True)
        for cs, rays, res in self.render_eval(model, cams, chunk):
            self._write_eval_chunk(cs, rays, res, names)

    def _write_eval_chunk(self, cs, rays, res, names) -> None:
        import cv2

        p = self.pipe
        rc_color_b = rays["color_map"].cpu().numpy()
        rc_depth_b = rays["depth_map"].cpu().numpy()
        res_np = None if res is None else {k: v.cpu().numpy() for k, v in res.items()}
        for i, cam in enumerate(cs):
            fid = cam.get_frame_id()
            fname = f"frame{fid}_iter{self.curr_iter}"
            rc_color, rc_depth = rc_color_b[i], rc_depth_b[i]
            vis.imwrite_rgb(os.path.join(self.eval_path, "raycast_color",
                                         f"frame{fid}.color.jpg"),
                            vis.to_u8_rgb(np.clip(rc_color, 0, 1)))
            vis.imwrite_rgb(os.path.join(self.eval_path, "raycast_color",
                                         f"frame{fid}_comp.color.jpg"),
                            vis.color_comp_img(np.clip(rc_color, 0, 1), cam.image,
                                               0, p.color_error_max))
            cv2.imwrite(os.path.join(self.eval_path, "raycast_depth",
                                     f"frame{fid}.depth.png"),
                        vis.depth_to_png16(rc_depth))
            vis.imwrite_rgb(os.path.join(self.eval_path, "raycast_depth",
                                         f"frame{fid}_comp.depth.png"),
                            vis.depth_comp_img(rc_depth, cam.depth, 0, p.depth_vis_max,
                                               0, p.depth_error_max))
            if res_np is None:
                continue
            if "rgb" in names:
                rendered = np.clip(res_np["rgb"][i], 0, 1)
                vis.imwrite_rgb(os.path.join(self.eval_path, "gt", fname + ".color.jpg"),
                                vis.to_u8_rgb(cam.image))
                vis.imwrite_rgb(os.path.join(self.eval_path, "render",
                                             fname + ".color.jpg"),
                                vis.to_u8_rgb(rendered))
                vis.imwrite_rgb(os.path.join(self.eval_path, "comp", fname + ".color.jpg"),
                                vis.color_comp_img(rendered, cam.image, 0,
                                                   p.color_error_max))
            if "alpha" in names:
                vis.imwrite_rgb(os.path.join(self.eval_path, "render",
                                             fname + ".alpha.jpg"),
                                vis.jet(res_np["alpha"][i], 0, 1))
            if "depth" in names:
                vis.imwrite_rgb(os.path.join(self.eval_path, "render",
                                             fname + ".depth.jpg"),
                                vis.jet(res_np["depth"][i], 0, p.depth_vis_max, True))

    # ------------------------------------------------------------------ save

    def save(self, model: GaussianModel, reader) -> None:
        """Model + viewer artifacts (Pipeline::save, src/pipeline.cpp:38-54)."""
        model.save(self.model_path)
        uio.save_cameras_json(reader.train_vec,
                              os.path.join(self.model_path, "cameras.json"))
        uio.save_cfg_args(os.path.join(self.model_path, "cfg_args"),
                          self.cfg.model.sh_degree)

    def save_engine(self) -> None:
        self.engine.save_scene(os.path.join(self.workspace_dir,
                                            self.pipe.tsdf.saved_engine))

    def load_engine(self) -> None:
        self.engine.load_scene(os.path.join(self.workspace_dir,
                                            self.pipe.tsdf.saved_engine))
