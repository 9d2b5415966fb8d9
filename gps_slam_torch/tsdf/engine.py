"""TSDF engine facade — the port of gps_slam_tpu/tsdf/engine.py.

Per frame: optional bilateral depth filter -> the pose (the ground truth
in gt-pose mode; in tracked mode the attached tracker's estimate against
the previous tracking-prepare raycast, with the behaviour-on-failure
policy: pose revert, `stop_integration` or `relocalise`) -> fuse -> record
the pose and intrinsics for later raycasts -> in tracked mode the next
frame's tracking-prepare raycast.  With `TPU.enable_swapping` fusion
stamps each integrated block with the frame index, every
`swap_check_interval` frames the host swap engine merges re-allocated
stored blocks back and spills the coldest ones, and every raycast first
brings back the stored blocks in its view (`tsdf/swapping.py`); when that
leaves the pool at or past its high-water mark, the next frame spills
before it fuses (the JAX package fuses into the full pool and drops the
frame's new blocks).  With `TPU.space_shards` = S > 1 the block pool
splits S ways by key-hash ownership (`parallel/spatial.py`) into S volumes
at capacity / S each, every frame fuses into each shard and every raycast
merges the shards' maps by nearest hit; swapping and sharding exclude each
other.  `shards` is the list of volumes (one without sharding) and `vol`
the one volume of an unsharded engine.

Two routes run a frame in fixed shapes, with no read-back inside it, as
the JAX package's jitted programs do (`integrate.fuse_frame_static`):

  * chunked gt fusion (`process_frames_gt`, when `can_chunk_fusion`):
    the pipeline hands over a group of frames whose poses are known; each
    frame is one fixed-shape fusion and the host reads the counts once
    per group;
  * the tracked megastep (`_process_frame_fast_tracked`, when
    `_can_fast_track`): ICP (`tracker.track_pyramid_static`), the pose
    revert on a failed track, fusion at the chosen pose and the next
    frame's tracking-prepare raycast as one function; the host reads
    (pose, inlier, residual, counts) once per frame and labels the
    quality.

On the CPU they run eagerly; on the card each is captured as a CUDA graph
once per static key (`slam/megastep.GraphCache`) and replayed.  In the
tracked megastep's graph each pyramid level's Gauss-Newton loop is one
kernel node (`icp_gn_cuda`, a cooperative launch that runs the level's
passes, the JAX `lax.while_loop`): the device tests the exit after each
iteration, and a replay runs the iterations that the eager route runs,
not the levels' budgets.
Everything else (the gt-pose frame of `log_pipeline_time`, the colour
and composite trackers, the other failure policies, swapping, sharding)
runs per frame with its counts read exactly every frame.  The JAX
package's visible-list bucket (`_vis_cap`) is not ported: the fixed-shape
frame integrates `visible_capacity` rows, whose rows past the frame's
candidates the kernels skip at once.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from .. import resolve_device
from ..config import Config
from ..parallel import spatial
from ..utils.se3 import bilateral_filter_depth
from . import integrate, raycast_tiles
from .volume import TsdfParams, TsdfVolume


class TrackingResult:
    """behaviourOnFailure policy surface."""

    GOOD = 2
    POOR = 1
    FAILED = 0


def _tsdf_node(cfg: Config) -> dict:
    return cfg.raw.get("PIPE", {}).get("TSDF", {}) or {}


def track_fuse_step(vol: TsdfVolume, n_blocks: torch.Tensor, T_prev, depth, rgb,
                    ref_vertex, ref_normal, *, K, level_iters: tuple,
                    space_thresh: tuple, tukey_c: tuple, bilateral: bool,
                    ray: tuple, prefix: int) -> dict:
    """One tracked frame in fixed shapes, reading nothing back to the host:
    the tracked megastep's body (the JAX `_track_fuse_step` and the
    raycast that follows it).  Tracks `depth` against the previous
    prepare raycast's maps from `T_prev` (`track_pyramid_static`), keeps
    `T_prev` where the track failed (not finite, inlier share below
    FAIL_MIN_INLIER or mean residual above FAIL_MAX_RESIDUAL: the eager
    policy's revert), fuses the frame at the chosen pose
    (`integrate.fuse_frame_static`, `n_blocks` updated in place) and
    raycasts the next frame's maps from it (K3's tracking mode, normals,
    no colour; `ray` = (width, height, lb, samples, bisect)) over the
    static block `prefix`, which must cover the blocks this frame may
    allocate.
    Returns device tensors."""
    from ..slam import tracker as trk

    if bilateral:
        depth = bilateral_filter_depth(depth)
    T, inl, mr, iters = trk.track_pyramid_static(
        T_prev, depth, ref_vertex, ref_normal, K, level_iters, space_thresh,
        tukey_c)
    bad = ((~torch.isfinite(T).all()) | (inl < trk.FAIL_MIN_INLIER)
           | (mr > trk.FAIL_MAX_RESIDUAL))
    pose = torch.where(bad, T_prev, T)
    n_vis = integrate.fuse_frame_static(vol, depth, rgb, pose, K, n_blocks)
    width, height, lb, samples, bisect = ray
    maps = raycast_tiles.raycast(vol, pose, K, width, height, lb, samples, bisect,
                                 raycast_tiles.TRACK_K_BLOCKS, need_color=False,
                                 need_normals=True, prefix=prefix, track=True)
    return {"pose": pose, "inlier": inl, "residual": mr, "iters": iters,
            "n_visible": n_vis, "raycast_visible": maps["n_visible"],
            "vertex_map": maps["vertex_map"], "normal_map": maps["normal_map"]}


def _fuse_gt_frame(vol, n_blocks, depth, rgb, c2w, *, K, bilateral) -> dict:
    return {"n_visible": integrate.fuse_frame_static(vol, depth, rgb, c2w, K,
                                                     n_blocks, bilateral)}


def _before_tracked_capture(buf: dict, statics: dict) -> None:
    """What the tracked frame's capture needs made first, which a graph
    cannot capture: the cuBLAS handle of the f32 matrix products (the
    tracking-prepare raycast's block binning), made by their first call,
    and both Gauss-Newton level kernels loaded (`icp_gn_cuda`, each level
    of the frame one launch, and `color_gn_cuda`), the ICP kernel's
    largest grid checked to fit the card resident."""
    from ..slam import color_gn, icp_gn

    x = torch.ones((8, 6), dtype=torch.float32, device=buf["depth"].device)
    x.T @ x
    icp_gn.load()
    color_gn.load()


class TsdfEngine:
    def __init__(self, cfg: Config, width: int, height: int, K: np.ndarray,
                 device=None):
        t = cfg.pipe.tsdf
        tpu = cfg.tpu
        self.device = resolve_device(device)
        self.params = TsdfParams(
            voxel_size=t.voxel_size, mu=t.trunc_dist, max_w=tpu.max_weight,
            frustum_min=t.viewFrustum_min, frustum_max=t.viewFrustum_max,
            hash_size=tpu.hash_size, block_capacity=tpu.block_capacity,
            max_probes=tpu.max_probes,
            visible_capacity=tpu.visible_block_capacity,
            alloc_steps=tpu.alloc_steps, alloc_stride=tpu.alloc_stride,
            alloc_candidate_cap=tpu.alloc_candidate_cap,
            raycast_lb=tpu.raycast_lb,
            raycast_samples=tpu.raycast_samples,
            raycast_bisect=tpu.raycast_bisect,
        )
        self.space_shards = S = int(tpu.space_shards)
        if S > 1:
            if tpu.enable_swapping:
                raise ValueError("enable_swapping and space_shards are mutually exclusive")
            self.params = dataclasses.replace(
                self.params, hash_size=max(self.params.hash_size // S, 1 << 12),
                block_capacity=max(self.params.block_capacity // S, 1 << 9))
        self.shards: list[TsdfVolume] = spatial.create_sharded(self.params, S, self.device)
        self.width, self.height = int(width), int(height)
        self.K = np.asarray(K, dtype=np.float32)
        self.use_gt_pose = bool(t.use_gt_pose)
        self.tracking_active = not self.use_gt_pose
        self.gt_c2w_poses: list[np.ndarray] = []
        self.cam_poses: list[np.ndarray] = []
        self.cam_intrinsics: list[np.ndarray] = []
        self.current_frame = 0
        self._last_pose = np.eye(4, dtype=np.float32)
        self.mesh_algo = str(tpu.mesh_algo)
        self._tracker = None  # set by attach_tracker (slam.tracker)
        self._last_raycast_for_tracking = None
        # optional YAML keys PIPE.TSDF.behaviour_on_failure (default
        # ignore) and PIPE.TSDF.use_bilateral_filter (default off)
        self.failure_policy = str(_tsdf_node(cfg).get("behaviour_on_failure", "ignore"))
        self.use_bilateral_filter = bool(_tsdf_node(cfg).get("use_bilateral_filter", False))
        self.relocalizer = None
        if self.failure_policy == "relocalise":
            from ..slam.relocalizer import FernRelocalizer

            self.relocalizer = FernRelocalizer()
        self._tracking_quality = TrackingResult.GOOD
        # largest per-frame visible set seen: fusion's candidate blocks and
        # the raycasts' surface blocks in depth range, both before the
        # visible_capacity cap
        self.peak_visible = {"fusion": 0, "raycast": 0}
        # the fixed-shape routes: the allocated count on the device, the
        # last pose on the device, and the CUDA graphs of the chunk's
        # fusion frame and of the tracked frame on the card
        self._n_blocks_dev = torch.zeros((), dtype=torch.int64, device=self.device)
        self._last_pose_dev = None
        self._fusion_graphs = self._track_graphs = None
        if self.device.type == "cuda":
            from ..slam.megastep import GraphCache

            self._fusion_graphs = GraphCache(_fuse_gt_frame)
            self._track_graphs = GraphCache(track_fuse_step, prepare=_before_tracked_capture)
        self.swap = None
        self.swap_check_interval = int(tpu.swap_check_interval)
        if tpu.enable_swapping:
            from .swapping import HostSwapEngine

            self.swap = HostSwapEngine(high_water=tpu.swap_high_water,
                                       low_water=tpu.swap_low_water)

    @property
    def vol(self) -> TsdfVolume:
        """The volume of an unsharded engine."""
        if len(self.shards) != 1:
            raise RuntimeError(f"the engine holds {len(self.shards)} space shards, "
                               "not one volume: read `shards`")
        return self.shards[0]

    # -- configuration -------------------------------------------------------

    def set_gt_poses(self, poses: list[np.ndarray]) -> None:
        self.gt_c2w_poses = [np.asarray(p, dtype=np.float32) for p in poses]

    def turn_off_tracking(self) -> None:
        self.tracking_active = False

    def attach_tracker(self, tracker) -> None:
        self._tracker = tracker
        self.tracking_active = not self.use_gt_pose

    # -- per-frame processing -------------------------------------------------

    def process_frame(self, rgb, depth) -> np.ndarray:
        """Track (or inject the gt pose) and fuse one RGB-D frame; returns
        the c2w pose.  `rgb` [H, W, 3] / `depth` [H, W(, 1)] may be numpy
        arrays or tensors."""
        i = self.current_frame
        if (i > 0 and self._tracker is not None
                and self._last_raycast_for_tracking is not None
                and self._last_pose_dev is not None and self._can_fast_track()):
            return self._process_frame_fast_tracked(rgb, depth)
        d = torch.as_tensor(depth, dtype=torch.float32, device=self.device)
        if d.ndim == 3:
            d = d[..., 0]
        if self.use_bilateral_filter:
            d = bilateral_filter_depth(d)
        c = torch.as_tensor(rgb, dtype=torch.float32, device=self.device)
        skip_fusion = False
        if self.tracking_active and self._tracker is not None and i > 0:
            pose, quality = self._tracker.track(
                self._last_pose, d, self._last_raycast_for_tracking, self.K, rgb=c)
            self._tracking_quality = quality
            if quality == TrackingResult.FAILED:
                pose = self._last_pose  # pose revert
                if self.failure_policy == "stop_integration":
                    skip_fusion = True
                elif self.failure_policy == "relocalise" and self.relocalizer:
                    # fern retrieval, then re-track from the retrieved pose
                    cand = self.relocalizer.relocalize(d)
                    if cand is not None:
                        reloc_maps = self.run_raycast(cand)
                        pose, quality = self._tracker.track(
                            cand, d, reloc_maps, self.K, rgb=c)
                        if quality == TrackingResult.FAILED:
                            pose = self._last_pose
                            skip_fusion = True
            if self.relocalizer is not None:
                self.relocalizer.process_frame(d, pose, quality == TrackingResult.GOOD)
        elif self.gt_c2w_poses:
            # frames beyond the supplied gt trajectory keep the last pose
            pose = self.gt_c2w_poses[min(i, len(self.gt_c2w_poses) - 1)]
        else:
            pose = self._last_pose

        if not skip_fusion:
            if self.swap is not None and self.swap.over_high_water:
                # a raycast's swap-in filled the pool: make room first
                self.swap.maybe_spill(self.vol)
            pose_t = torch.as_tensor(pose, device=self.device)
            spatial.fuse_frame_sharded(self.shards, d, c, pose_t, self.K,
                                       frame_idx=i if self.swap is not None else None)
            n_visible = sum(v.n_visible for v in self.shards)
            self.peak_visible["fusion"] = max(self.peak_visible["fusion"], n_visible)
            if self.swap is not None and i % self.swap_check_interval == 0:
                self.swap.maybe_reload(self.vol)
                self.swap.maybe_spill(self.vol)
        self._record(np.asarray(pose, dtype=np.float32))
        self._last_pose_dev = torch.as_tensor(self._last_pose, device=self.device)

        if self.tracking_active and self._tracker is not None:
            # the next frame's tracking-prepare raycast: the march's
            # tracking mode, normals on, colour only for a tracker that
            # reads it
            need_rgb = bool(getattr(self._tracker, "needs_color", False))
            self._last_raycast_for_tracking = self.run_raycast(
                self._last_pose, need_color=need_rgb, track=True)
        return self._last_pose

    # -- the fixed-shape routes ---------------------------------------------------

    def _can_fast_track(self) -> bool:
        """The JAX package's gates (gps_slam_tpu/tsdf/engine.py:273-285):
        the tracked megastep applies when every per-frame host hook is a
        no-op: a tracker with a read-back-free form (`device_pure`: ICP),
        the default `ignore` failure policy (whose only action, the pose
        revert on FAILED, the megastep takes on the device), no swapping,
        no space shards."""
        return (self.tracking_active
                and getattr(self._tracker, "device_pure", False)
                and self.failure_policy == "ignore"
                and self.swap is None
                and self.space_shards == 1)

    def _frame_tensors(self, rgb, depth):
        d = torch.as_tensor(depth, dtype=torch.float32, device=self.device)
        if d.ndim == 3:
            d = d[..., 0]
        return torch.as_tensor(rgb, dtype=torch.float32, device=self.device), d

    def _record(self, pose: np.ndarray) -> None:
        self._last_pose = pose
        self.cam_poses.append(pose.copy())
        self.cam_intrinsics.append(self.K.copy())
        self.current_frame += 1

    def _process_frame_fast_tracked(self, rgb, depth) -> np.ndarray:
        """One tracked frame as the megastep (`track_fuse_step`; on the
        card a replay of its graph), then one read of (pose, inlier,
        residual, counts, iterations per level) and the quality label on
        the host with the thresholds of the JAX engine (:319-324)."""
        from ..slam import tracker as trk
        from ..slam.megastep import held_tensors, volume_tensors

        vol, p, tr = self.vol, self.params, self._tracker
        c, d = self._frame_tensors(rgb, depth)
        nb = self._n_blocks_dev
        nb.fill_(vol.n_blocks)
        # no frame allocates more than alloc_candidate_cap blocks: the
        # prefix covers the pool after this frame's fusion
        prefix = raycast_tiles.pool_prefix(vol.n_blocks + p.alloc_candidate_cap,
                                           p.block_capacity)
        ref = self._last_raycast_for_tracking
        inputs = {"T_prev": self._last_pose_dev, "depth": d, "rgb": c,
                  "ref_vertex": ref["vertex_map"], "ref_normal": ref["normal_map"]}
        statics = dict(K=self.K, level_iters=tuple(tr.level_iters),
                       space_thresh=tuple(tr.space_thresh), tukey_c=tuple(tr.tukey_c),
                       bilateral=self.use_bilateral_filter,
                       ray=(self.width, self.height, p.raycast_lb, p.raycast_samples,
                            max(p.raycast_bisect, 3)),
                       prefix=prefix)
        if self._track_graphs is None:
            out = track_fuse_step(vol, nb, **inputs, **statics)
        else:
            key = (self.height, self.width, tuple(self.K.ravel().tolist()), p,
                   statics["level_iters"], statics["space_thresh"], statics["tukey_c"],
                   integrate.integrate_route(self.width, self.height),
                   integrate.static_rows(p, self.height, self.width), prefix,
                   self.use_bilateral_filter)
            out = self._track_graphs.run(key, held_tensors(*volume_tensors(vol), nb),
                                         inputs, vol=vol, n_blocks=nb, **statics)
        vals = torch.cat([out["pose"].reshape(-1).double(), torch.stack([
            out["inlier"].double(), out["residual"].double(), nb.double(),
            out["n_visible"].double(), out["raycast_visible"].double()]),
            out["iters"].double()]).tolist()
        T = np.asarray(vals[:16], np.float32).reshape(4, 4)
        inlier, mean_r = vals[16], vals[17]
        vol.n_blocks, vol.n_visible = int(vals[18]), int(vals[19])
        self.peak_visible["fusion"] = max(self.peak_visible["fusion"], vol.n_visible)
        self.peak_visible["raycast"] = max(self.peak_visible["raycast"], int(vals[20]))
        tr.last_inlier, tr.last_residual = inlier, mean_r
        tr.last_iters = [int(v) for v in vals[21:]]
        if (not np.all(np.isfinite(T)) or inlier < trk.FAIL_MIN_INLIER
                or mean_r > trk.FAIL_MAX_RESIDUAL):
            self._tracking_quality = trk.TrackerQuality.FAILED
        elif inlier > trk.GOOD_MIN_INLIER and mean_r < trk.GOOD_MAX_RESIDUAL:
            self._tracking_quality = trk.TrackerQuality.GOOD
        else:
            self._tracking_quality = trk.TrackerQuality.POOR
        self._last_pose_dev = out["pose"]
        self._last_raycast_for_tracking = {"vertex_map": out["vertex_map"],
                                           "normal_map": out["normal_map"]}
        self._record(T)
        return T

    def can_chunk_fusion(self) -> bool:
        """The JAX package's gate (gps_slam_tpu/tsdf/engine.py:432-445):
        fusion may take a group of frames at once when every pose is known
        up front (gt poses, no tracking) and no per-frame host hook fires
        (no swapping, no space shards); the bilateral filter runs inside."""
        return (not self.tracking_active and bool(self.gt_c2w_poses)
                and self.swap is None and self.space_shards == 1)

    def process_frames_gt(self, frames: list) -> list[np.ndarray]:
        """Fuse a group of consecutive frames at their gt poses
        (`can_chunk_fusion`): `frames` = [(rgb [H, W, 3], depth [H, W] or
        [H, W, 1])] in order.  Each frame is `integrate.fuse_frame_static`
        (on the card a replay of its graph, captured once per frame size,
        route and row count); the host reads the allocated and candidate
        counts once, after the group.  Returns the poses and records them
        as `process_frame` does."""
        from ..slam.megastep import held_tensors, volume_tensors

        i0, vol, p = self.current_frame, self.vol, self.params
        poses = [np.asarray(self.gt_c2w_poses[min(i0 + k, len(self.gt_c2w_poses) - 1)],
                            dtype=np.float32) for k in range(len(frames))]
        poses_dev = torch.as_tensor(np.stack(poses), device=self.device)
        nb = self._n_blocks_dev
        nb.fill_(vol.n_blocks)
        peak = torch.zeros((), dtype=torch.int64, device=self.device)
        held = held_tensors(*volume_tensors(vol), nb)
        for k, frame in enumerate(frames):
            c, d = self._frame_tensors(*frame)
            if self._fusion_graphs is None:
                out = _fuse_gt_frame(vol, nb, d, c, poses_dev[k], K=self.K,
                                     bilateral=self.use_bilateral_filter)
            else:
                H, W = d.shape
                key = (H, W, tuple(self.K.ravel().tolist()), p,
                       integrate.integrate_route(W, H), integrate.static_rows(p, H, W),
                       self.use_bilateral_filter)
                out = self._fusion_graphs.run(
                    key, held, {"depth": d, "rgb": c, "c2w": poses_dev[k]}, vol=vol,
                    n_blocks=nb, K=self.K, bilateral=self.use_bilateral_filter)
            peak = torch.maximum(peak, out["n_visible"])
        n_blocks, n_visible, peak_h = torch.stack([nb, out["n_visible"], peak]).tolist()
        vol.n_blocks, vol.n_visible = n_blocks, n_visible
        self.peak_visible["fusion"] = max(self.peak_visible["fusion"], peak_h)
        for pose in poses:
            self._record(pose)
        self._last_pose_dev = poses_dev[-1]
        return poses

    # -- raycast service -------------------------------------------------------

    def run_raycast(self, c2w, K=None, width: int | None = None,
                    height: int | None = None, quality: bool = True,
                    need_color: bool = True, need_normals: bool = True,
                    track: bool = False) -> dict:
        """Raycast from an arbitrary pose; `quality` refines k_blocks=2
        candidates per pixel, otherwise 1 (window raycasts); `track` runs
        the march's tracking mode (the tracking-prepare raycast,
        `raycast_tiles.TRACK`) at its own pick count.  With swapping on,
        the stored blocks in view come back into the pool first; a sharded
        volume raycasts each shard and merges by nearest hit."""
        p = self.params
        c2w = np.asarray(c2w, np.float32)
        K = self.K if K is None else np.asarray(K, np.float32)
        width, height = width or self.width, height or self.height
        if self.swap is not None:
            self.swap.reload_visible(self.vol, c2w, K, width, height)
        maps = spatial.raycast_sharded(
            self.shards, c2w, K, width, height, p.raycast_lb, p.raycast_samples,
            max(p.raycast_bisect, 3),
            raycast_tiles.TRACK_K_BLOCKS if track else 2 if quality else 1,
            need_color=need_color, need_normals=need_normals, track=track)
        self.peak_visible["raycast"] = max(self.peak_visible["raycast"],
                                           maps["n_visible"])
        return maps

    def run_raycast_batch(self, c2ws, K=None, quality: bool = False,
                          need_normals: bool = False) -> dict:
        """Raycast M poses; stacked [M, ...] map dict.  With swapping on,
        one `run_raycast` per pose (each swaps in its own view), and so
        with sharding (each merges its shards)."""
        p = self.params
        if self.swap is not None or len(self.shards) > 1:
            return raycast_tiles.stack_maps([
                self.run_raycast(c, K, quality=quality, need_normals=need_normals)
                for c in np.asarray(c2ws, np.float32)])
        maps = raycast_tiles.raycast_batch(
            self.vol, np.asarray(c2ws, np.float32),
            self.K if K is None else np.asarray(K, np.float32),
            self.width, self.height, p.raycast_lb, p.raycast_samples,
            max(p.raycast_bisect, 3), 2 if quality else 1,
            need_normals=need_normals)
        self.peak_visible["raycast"] = max(self.peak_visible["raycast"],
                                           maps["n_visible"])
        return maps

    # -- persistence -----------------------------------------------------------

    def save_scene(self, out_dir: str) -> None:
        """Scene checkpoint in the JAX package's scene.npz format.  A
        sharded volume writes every volume field with a leading [S] axis
        and records `space_shards` (the JAX package's sharded save slices
        the summary on the wrong axis and flattens the table across the
        shards, so its file does not load back)."""
        os.makedirs(out_dir, exist_ok=True)
        parts = [_scene_arrays(v) for v in self.shards]
        if len(parts) > 1:
            arrays = {k: np.stack([a[k] for a in parts]) for k in parts[0]}
            arrays["space_shards"] = np.int32(len(parts))
        else:
            arrays = parts[0]
        np.savez_compressed(
            os.path.join(out_dir, "scene.npz"), **arrays,
            cam_poses=np.stack(self.cam_poses) if self.cam_poses else np.zeros((0, 4, 4)),
            cam_intrinsics=np.stack(self.cam_intrinsics)
            if self.cam_intrinsics else np.zeros((0, 3, 3)),
        )

    def load_scene(self, in_dir: str) -> None:
        """Reset, then load a scene.npz written by either package (a
        sharded one only by the port, into an engine of as many shards)."""
        from ..convert import volume_from_numpy

        z = np.load(os.path.join(in_dir, "scene.npz"))
        n_shards = int(z["space_shards"]) if "space_shards" in z.files else 1
        if n_shards != self.space_shards:
            raise ValueError(f"scene.npz holds {n_shards} space shards, the "
                             f"engine {self.space_shards}")
        fields = [k for k in z.files
                  if k not in ("cam_poses", "cam_intrinsics", "space_shards")]
        parts = ([{k: z[k][s] for k in fields} for s in range(n_shards)] if n_shards > 1
                 else [{k: z[k] for k in fields}])
        self.shards = [volume_from_numpy(a, self.params, v.device)
                       for a, v in zip(parts, self.shards)]
        self.cam_poses = [p.astype(np.float32) for p in z["cam_poses"]]
        self.cam_intrinsics = [k.astype(np.float32) for k in z["cam_intrinsics"]]
        self.current_frame = len(self.cam_poses)

    def save_mesh(self, path: str) -> None:
        """Iso-surface -> coloured triangle-soup PLY (TPU.mesh_algo: "mt"
        or "mc"), meshed on the host by the native mesher.  A sharded
        volume meshes each shard and concatenates the triangles (blocks
        are disjoint by ownership; a cell whose neighbour block lives in
        another shard is skipped, a sub-voxel seam)."""
        from ..utils import io as uio
        from .meshing import extract_mesh

        parts = [extract_mesh(v, algo=self.mesh_algo) for v in self.shards]
        uio.save_mesh_ply(path, np.concatenate([v for v, _ in parts], 0),
                          np.concatenate([c for _, c in parts], 0))


def _scene_arrays(v: TsdfVolume) -> dict:
    """A volume's scene.npz fields: the flat hash table, the reference's
    separate voxel planes, the mip and per-block min sdf / max weight."""
    st_np = v.state.cpu().numpy().view(np.uint32)
    sdf_i = (st_np & 0xFFFF).astype(np.int32)
    sdf_i = np.where(sdf_i >= 32768, sdf_i - 65536, sdf_i).astype(np.int16)
    summ = v.summary.cpu().numpy()
    return dict(
        table_keys=v.table_keys.cpu().numpy().view(np.uint32).reshape(-1),
        table_ptrs=v.table_ptrs.cpu().numpy().reshape(-1),
        block_coords=v.block_coords.cpu().numpy().view(np.uint32),
        sdf=sdf_i,
        w_depth=((st_np >> 16) & 0xFF).astype(np.uint8),
        color=v.color.cpu().numpy().view(np.uint32),
        w_color=(st_np >> 24).astype(np.uint8),
        n_blocks=np.asarray(v.n_blocks, np.int32),
        mip=summ[:, :64],
        block_min_sdf=summ[:, 64],
        block_max_w=summ[:, 65].astype(np.int32),
        last_seen=v.last_seen.cpu().numpy(),
    )
