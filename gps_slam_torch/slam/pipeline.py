"""SLAM orchestration, gt-pose path — the port of
gps_slam_tpu/slam/pipeline.py (`slam_train_cams` per-frame branch and its
window megastep routing).

Fusion, then local-window / keyframe bookkeeping, per frame or, in
gt-pose mode, per group of up to `TPU.fuse_chunk` frames
(`_fusion_groups`: the engine fuses a group with one read of its counts,
`TsdfEngine.process_frames_gt`, each frame a replayed CUDA graph on the
card); every `local_opt_interval` frames: raycast the window and
the sampled keyframes, spawn Gaussians where the render's colour error is
high, run `local_opt_iters` Adam steps over the window's cameras
(`window_optimize`), prune.  Unless PIPE.log_pipeline_time asks for
per-phase times, a window that passes the JAX package's gates
(`_can_megastep`: past the bootstrap window, no per-window host hook)
runs as one `slam/megastep.py` window, replayed as a CUDA graph on the
card.  Emits the reference's `time_log.txt` line format (read by
run/read_results.py).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..config import Config
from ..data.device_cache import DeviceFrameCache
from ..gs import losses, model as gmodel, params as pmod
from ..gs.model import GaussianModel
from ..tsdf import raycast_tiles
from ..tsdf.engine import TsdfEngine
from ..utils import io as uio, vis
from ..utils.camera import Camera
from . import megastep as ms


def padded_overflow(per_cam, n_padded: int) -> list[int]:
    """The window's (tile, span, active) binning overflows as the JAX
    package counts them: it pads the opt set to `n_padded` cameras with
    copies of the last one and sums over all of them.  The port bins each
    camera once (`per_cam`, one triple each) and adds the last camera's
    triple once more for every copy."""
    extra = max(n_padded - len(per_cam), 0)
    return [sum(c[i] for c in per_cam) + extra * per_cam[-1][i] for i in range(3)]


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
        self.frame_cache = DeviceFrameCache(self.device)
        # the devices the eval renders split over: every card when there
        # are several (one `forward_batch` otherwise)
        self.eval_devices = None
        if self.device.type == "cuda" and torch.cuda.device_count() > 1:
            from ..parallel.mesh import make_mesh

            self.eval_devices = make_mesh()
        if is_train:
            os.makedirs(self.log_path, exist_ok=True)
            os.makedirs(os.path.join(workspace_dir, cfg.pipe.tsdf.saved_images),
                        exist_ok=True)
            os.makedirs(os.path.join(workspace_dir, "before_opt"), exist_ok=True)
        self.scene_scale = 1.0  # the reader's; read by offline densify only
        self._pose_idx: dict[int, int] = {}
        self._spawn_overflow = 0
        self._bin_overflow = [0, 0, 0]   # tile, span and active caps
        self._last_loss_hist = None
        # LOG_PIPELINE_TIME (slam_pipeline.cpp:7,54-66): per-phase times,
        # so every window takes the per-phase path; off by default
        self.log_pipeline_time = bool(
            (cfg.raw.get("PIPE", {}) or {}).get("log_pipeline_time", False))
        self._megastep_ran = False
        self._window_graphs = ms.WindowGraphs() if self.device.type == "cuda" else None
        self.t_fusion = self.t_local_raycast = self.t_key_raycast = 0.0
        self.t_init_gs = self.t_opt = self.t_remove = 0.0

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------ loop

    def _fusion_groups(self, total: int, p, can_chunk: bool, chunk_n: int):
        """Frame indices in fusion groups (gps_slam_tpu/slam/pipeline.py
        :159-177): one frame a group unless `can_chunk`; else up to
        `chunk_n` frames, ending at an optimisation frame (i % interval
        == 0, i > 0), whose window must see exactly the frames fused so
        far (outside `recon` mode, which runs no window)."""
        i = 0
        while i < total:
            if not can_chunk:
                yield [i]
                i += 1
                continue
            group = []
            for j in range(i, min(i + chunk_n, total)):
                group.append(j)
                if (self.cfg.work_mode != "recon" and j > 0
                        and j % p.local_opt_interval == 0):
                    break
            yield group
            i = group[-1] + 1

    def slam_train_cams(self, model: GaussianModel, cams: list[Camera]) -> None:
        """SLAMTrainCams (slam_pipeline.cpp:52-173), in fusion groups
        (`_fusion_groups`): in gt-pose mode, unless per-phase times are
        asked for, groups of `TPU.fuse_chunk` frames through
        `process_frames_gt` (the fusion time is taken per group), else one
        frame at a time through `process_frame`.  A window runs as the
        megastep when `_can_megastep` allows it and per-phase times are not
        asked for; its whole time lands in the localOptimize column."""
        p = self.pipe
        total = len(cams)
        sync = self.log_pipeline_time
        chunk_n = max(int(self.cfg.tpu.fuse_chunk), 1)
        can_chunk = not sync and chunk_n > 1 and self.engine.can_chunk_fusion()
        t_start = time.monotonic()
        for group in self._fusion_groups(total, p, can_chunk, chunk_n):
            t0 = time.monotonic()
            i = group[-1]
            if can_chunk:
                poses = self.engine.process_frames_gt(
                    [self.frame_cache.get(cams[k]) for k in group])
            else:
                poses = [self.engine.process_frame(*self.frame_cache.get(cams[i]))]
            base = len(self.engine.cam_poses) - len(group)
            for k, idx in enumerate(group):
                cam = cams[idx]
                self.curr_frame_id = idx
                cam.c2w_slam = np.asarray(poses[k])
                self._pose_idx[cam.id] = base + k
                self.curr_cam = cam
                self.update_frame_list()
            self._sync()
            self.t_fusion += (time.monotonic() - t0) * 1000.0
            if self.cfg.work_mode == "recon":
                continue
            if i % p.local_opt_interval == 0 and i > 0:
                t1 = time.monotonic()
                if not sync and self._can_megastep(model):
                    self._run_window_megastep(model)
                    self.t_opt += (time.monotonic() - t1) * 1000
                    continue
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
            rows = [{k: v[i] for k, v in maps.items() if k not in raycast_tiles.COUNTS}
                    for i in range(len(self.opt_cam_list))]
        self.localframe_raycast_window = rows[:n_local]
        self.opt_raycast_list = rows

    def _debug_artifacts_on(self) -> bool:
        """The reference writes per-window debug images only when not
        profiling (#ifndef LOG_PIPELINE_TIME, slam_pipeline.cpp:429,499)."""
        return self.pipe.log_slam_state and not self.log_pipeline_time

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

    # -------------------------------------------------------------- megastep

    def _can_megastep(self, model: GaussianModel) -> bool:
        """The JAX package's gates (gps_slam_tpu/slam/pipeline.py:494-523):
        the one-dispatch window applies when every per-window host hook is
        a no-op: no debug artifacts, no exposure or depth loss, no swapping
        or space shards, a model past its bootstrap window (the empty
        model's spawn stays eager), the current frame owning the window's
        last slot and the engine's intrinsics for every camera."""
        eng = self.engine
        if getattr(self, "disable_megastep", False):
            return False
        if model.statics.use_exposure or self.pipe.depth_weight > 0:
            return False
        if self._debug_artifacts_on():
            return False
        if eng.swap is not None or eng.space_shards > 1:
            return False
        if model.num_gaussians == 0:
            return False
        if (not self.localframe_cam_window
                or self.localframe_cam_window[-1] is not self.curr_cam):
            return False
        cams = self.localframe_cam_window + self.keyframe_cam_list
        return all(cam.width == eng.width and cam.height == eng.height
                   and np.allclose(np.asarray(cam.K), eng.K) for cam in cams)

    def _megastep_window(self, model: GaussianModel) -> tuple:
        """A window megastep's (key, inputs, statics) for the current state
        (gps_slam_tpu/slam/pipeline.py:525-596): the keyframe sample, the
        spawn priorities and the iteration camera sequence drawn from the
        eager path's streams in its order, the opt set padded to window
        length + keyframe_select_max cameras with its last one, and the
        static caps.  Only static values make the key: the shapes, the
        intrinsics, the config and the caps."""
        p = self.pipe
        eng = self.engine
        dev = self.device
        self.opt_cam_list = list(self.localframe_cam_window)
        n_sel = (min(p.keyframe_select_max, len(self.keyframe_cam_list))
                 if p.kf_sample_method == "random" else 0)
        if n_sel > 0:
            sel = self._rng.permutation(len(self.keyframe_cam_list))[:n_sel]
            for k in sel:
                self.opt_cam_list.append(self.keyframe_cam_list[int(k)])
        n_local = len(self.localframe_cam_window)
        n_valid = len(self.opt_cam_list)
        M = p.localframe_cam_window_length + p.keyframe_select_max
        cams = [self.opt_cam_list[min(i, n_valid - 1)] for i in range(M)]
        poses = torch.as_tensor(np.stack([self._recorded_pose(c) for c in cams]),
                                dtype=torch.float32, device=dev)
        gt_rgb = [self.frame_cache.get(c)[0] for c in cams]
        # the eager spawn's draw, from the model's stream
        noise = torch.rand((eng.height * eng.width,), generator=model.next_rng(),
                           device=dev)
        idx_seq: list[int] = []
        while len(idx_seq) < p.local_opt_iters:
            idx_seq.extend(int(v) for v in self._rng.permutation(n_valid))
        iter_idx = torch.as_tensor(idx_seq[:p.local_opt_iters], dtype=torch.int64,
                                   device=dev)
        m = self.cfg.model
        tpu = self.cfg.tpu
        sc = ms.WindowScalars(
            depth_vis_min=p.depth_vis_min, depth_vis_max=p.depth_vis_max,
            color_error_thres=p.color_error_thres, alpha_vis_max=p.alpha_vis_max,
            new_gs_sample_ratio=p.new_gs_sample_ratio,
            max_new=tpu.max_new_gaussians, default_opacity=m.default_opacities,
            min_init_scale=m.min_init_scale, max_init_scale=m.max_init_scale,
            remove_small=p.remove_small_scale_thres,
            remove_large=p.remove_large_scale_thres,
            remove_low_opac=p.remove_low_opac_thres,
            ssim_weight=p.ssim_weight, depth_weight=p.depth_weight,
            max_iterations=p.max_iterations)
        vp = eng.vol.params
        rk = ms.RayKnobs(width=eng.width, height=eng.height, lb=vp.raycast_lb,
                         samples=vp.raycast_samples, bisect=max(vp.raycast_bisect, 3))
        # the opt prefix covers the spawn: taken before it, with its bound
        opt_cap = model.opt_cap(extra=tpu.max_new_gaussians)
        st = model.statics
        tw = -(-st.width // st.tile_size)
        th = -(-st.height // st.tile_size)
        st_spawn = st._replace(
            visible_cap=min(st.visible_cap, opt_cap),
            active_tile_cap=min(tw * th, max(st.active_tile_cap, opt_cap // 8)))
        prefix = raycast_tiles.pool_prefix(eng.vol.n_blocks, vp.block_capacity)
        statics = dict(K=np.asarray(eng.K, np.float32), st=st, st_spawn=st_spawn,
                       sc=sc, rk=rk, mcfg=m, spawn_idx=n_local - 1,
                       pool_prefix=prefix, opt_cap=opt_cap,
                       cam_ids=tuple(c.id for c in cams))
        key = (M, int(iter_idx.shape[0]), eng.height, eng.width,
               tuple(statics["K"].ravel().tolist()), vp, st, st_spawn, sc, rk, m,
               n_local - 1, prefix, opt_cap, False)
        inputs = {"poses": poses, "gt_rgb": gt_rgb, "iter_cam_idx": iter_idx,
                  "spawn_noise": noise}
        return key, inputs, statics

    def _run_window_megastep(self, model: GaussianModel) -> None:
        """Host half of the window megastep (gps_slam_tpu/slam/pipeline.py
        :525-619): `_megastep_window`, then one window (a CUDA graph
        capture or replay on the card) and one read of its counts."""
        p = self.pipe
        eng = self.engine
        key, inputs, statics = self._megastep_window(model)
        if self._window_graphs is None:
            st = dict(statics)
            out = ms.window_megastep(eng.vol, model.pool, inputs["poses"], st.pop("K"),
                                     torch.stack(inputs["gt_rgb"]),
                                     inputs["iter_cam_idx"], inputs["spawn_noise"], **st)
        else:
            out = self._window_graphs.run(key, eng.vol, model.pool, inputs, **statics)
        n_alive, n_spawn, tile_o, span_o, act_o, n_vis = torch.stack([
            out["n_alive"], out["n_spawn_overflow"], out["n_tile_overflow"],
            out["n_span_overflow"], out["n_active_overflow"], out["n_visible"]]).tolist()
        model.pool.n_alive = n_alive
        self._spawn_overflow += n_spawn
        for i, n in enumerate((tile_o, span_o, act_o)):
            self._bin_overflow[i] += n
        eng.peak_visible["raycast"] = max(eng.peak_visible["raycast"], n_vis)
        self._last_loss_hist = out["loss_hist"].clone()
        self.localframe_raycast_window = []
        self.opt_raycast_list = []
        self.curr_iter += p.local_opt_iters
        self._megastep_ran = True

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
            mask, normal = ms.spawn_mask_bootstrap(
                depth, vertex, color, gt, p.depth_vis_min, p.depth_vis_max,
                p.color_error_thres)
        else:
            res = model.forward(cam.c2w_slam, cam.K, depth, color)
            mask, normal = ms.spawn_mask(
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
        self._spawn_overflow += int(n_overflow)

    # -------------------------------------------------------------- optimize

    def local_optimize(self, model: GaussianModel) -> None:
        """(localOptimize :195-291): `local_opt_iters` Adam steps over the
        window's cameras, in shuffled epochs of the opt set drawn from the
        same numpy stream as the JAX package, on the compact pool prefix
        (the live count plus the spawn bound, read exactly).  Zero steps
        still bin the cameras, as the JAX call does, for the overflow
        counts, which are counted over the JAX package's padded opt set
        (`padded_overflow`)."""
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
        counts = padded_overflow(
            aux["bin_overflow"], p.localframe_cam_window_length + p.keyframe_select_max)
        for i, n in enumerate(counts):
            self._bin_overflow[i] += n

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
                res = self._eval_render_batch(model, batch)
            yield cs, rays, res

    def _eval_render_batch(self, model: GaussianModel, batch: dict) -> dict:
        """Render a stacked camera batch: data-parallel over
        `eval_devices` (the batch padded with copies of its last camera to
        a multiple of their count, then cut back), else one
        `forward_batch`."""
        devs = self.eval_devices
        if not devs or len(devs) <= 1:
            return model.forward_batch(batch)
        from ..parallel.mesh import dp_render

        H, W = batch["ref_depth"].shape[1:3]
        params, alive, st = model.eval_slice(H, W)
        M = batch["c2w"].shape[0]
        pad = (-M) % len(devs)
        if pad:
            batch = {k: torch.cat([v, v[-1:].expand(pad, *v.shape[1:])])
                     for k, v in batch.items()}
        out = dp_render(devs, params, alive, batch, st)
        return {k: v[:M] for k, v in out.items()}

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

    def save_mesh(self) -> None:
        self.engine.save_mesh(os.path.join(self.workspace_dir,
                                           self.pipe.tsdf.saved_mesh))

    def save_engine(self) -> None:
        self.engine.save_scene(os.path.join(self.workspace_dir,
                                            self.pipe.tsdf.saved_engine))

    def load_engine(self) -> None:
        self.engine.load_scene(os.path.join(self.workspace_dir,
                                            self.pipe.tsdf.saved_engine))
