"""One run of a cell: set-up, the timed window, the profiled slice and the
check step, on the program's own objects, built as
`slam_trainer_torch.py` builds them."""

from __future__ import annotations

import gc
import os
import time

import numpy as np
import torch

from . import frames as pbframes, stream as pbstream, trace as pbtrace
from .cell import Cell

# frames the stream may hold beyond set-up: a bound no run reaches
MAX_FPS = 2000


def intrinsics(cfg_dict: dict):
    r = cfg_dict["READER"]
    fx, fy, cx, cy = (float(v) for v in r["intrinsics"])
    W, H = (int(v) for v in r["image_shape"])
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)
    return W, H, K


def volume_rows(vol) -> dict:
    """The allocated blocks of a volume (keys, voxel words, colours),
    copied."""
    n = int(vol.n_blocks)
    return {"keys": vol.block_coords[:n].clone(), "state": vol.state[:n].clone(),
            "color": vol.color[:n].clone()}


def pool_rows(model, n: int | None = None) -> dict:
    """The first n rows of the Gaussian pool (the live ones by default),
    copied."""
    n = int(model.num_gaussians) if n is None else n
    out = {k: v[:n].detach().clone() for k, v in model.pool.params.items()
           if k != "exposure"}
    out["alive"] = model.pool.alive[:n].clone()
    return out


class Run:
    """Build the program for `cell` on `device` and drive the stream."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool, device,
                 workspace: str, t_process: float):
        from gps_slam_torch.config import Config
        from gps_slam_torch.data import device_cache
        from gps_slam_torch.gs.model import GaussianModel
        from gps_slam_torch.slam.pipeline import SLAMPipeline
        from gps_slam_torch.slam.tracker import make_tracker
        from gps_slam_torch.tsdf.engine import TsdfEngine
        from gps_slam_torch.utils.camera import Camera

        self.cell, self.seed, self.device = cell, int(seed), torch.device(device)
        self.t_process = t_process
        # where set-up goes, s from process start
        self.setup_marks = {"imports": time.perf_counter() - t_process}
        tr = self.traffic = dict(cell.traffic)
        d = self.cfg_dict = cell.program_config(workspace)
        cfg = self.cfg = Config.from_dict(d)
        W, H, K = intrinsics(d)
        self.W, self.H, self.K = W, H, K
        tracked = not cfg.pipe.tsdf.use_gt_pose
        if tr["poses"] not in ("gt", "first"):
            raise ValueError(f"traffic poses {tr['poses']!r}: gt or first")
        if tracked != (tr["poses"] == "first"):
            raise ValueError(f"traffic {cell.workload['traffic']} hands poses "
                             f"{tr['poses']!r} to a config with use_gt_pose "
                             f"{cfg.pipe.tsdf.use_gt_pose}")
        self.tracked = tracked
        sync = pbstream.device_sync(self.device)
        self.store = pbframes.FrameStore(self.seed, tr["period_frames"], tr["look"],
                                         W, H, K, self.device)
        self.setup_marks["frames"] = time.perf_counter() - t_process
        warm, trace_frames = int(tr["warmup_frames"]), int(tr["trace_frames"]) if trace else 0
        n_stream = warm + trace_frames + int((seconds + 5) * MAX_FPS) + 64
        self.engine = engine = TsdfEngine(cfg, W, H, K, device=self.device)
        if tracked:
            # frame 0 at its pose, so the map and the stream share a frame
            engine.set_gt_poses([self.store.pose(0)])
            engine.attach_tracker(make_tracker(cfg, W, H))
        else:
            engine.set_gt_poses([self.store.pose(k) for k in range(n_stream)])
            engine.turn_off_tracking()
        self.model = GaussianModel(cfg, W, H, device=self.device)
        self.pipe = SLAMPipeline(cfg, engine, cfg.workspace_dir, is_train=False)
        fx, fy, cx, cy = (float(v) for v in (K[0, 0], K[1, 1], K[0, 2], K[1, 2]))

        def make_cam(k):
            c2w = np.eye(4, dtype=np.float32) if tracked else self.store.pose(k)
            return Camera(W, H, fx, fy, cx, cy, True, c2w, cam_id=k)

        self.cams = pbstream.LazyCams(n_stream, make_cam)
        self.prof = None
        self.acc = {}
        # (opt cap, Adam steps so far) at the start of each step of the slice
        self._trace_caps = []
        self.snap = {}
        self.memory_peak = None
        self._closed = False
        hooks = {"window": self._on_window, "trace": self._on_trace,
                 "check": self._on_check, "check_again": self._check_again,
                 "done": self._on_done}
        self.source = pbstream.StreamSource(
            self.store, device_cache.to_f32, warm, seconds, trace_frames, hooks, sync,
            on_boundary=self._on_boundary)
        self.pipe.frame_cache = self.source
        pbstream.wrap_engine(engine, self.source)
        self._wrap_window()
        self.setup_marks["program"] = time.perf_counter() - t_process

    # accumulators -------------------------------------------------------------

    def _counters(self) -> dict:
        p, g = self.pipe, self.pipe._window_graphs
        return {"t": time.perf_counter(), "t_fusion_ms": p.t_fusion, "t_opt_ms": p.t_opt,
                "adam_steps": p.curr_iter,
                "captures": g.captures if g is not None else 0,
                "frames": self.engine.current_frame}

    def _on_window(self):
        self.setup_s = time.perf_counter() - self.t_process
        self.setup_marks["window"] = self.setup_s
        self.acc["window_start"] = self._counters()

    def _window_closed(self):
        self.acc["window_end"] = self._counters()
        if self.device.type == "cuda":
            self.memory_peak = int(torch.cuda.max_memory_allocated(self.device))

    def _on_trace(self):
        self._window_closed()
        self.prof = pbtrace.start()
        self.acc["trace_start"] = self._counters()

    def _on_boundary(self, phase: str):
        # the window a step runs takes the opt prefix of the pool as it
        # stands when the step starts (fusion adds no Gaussian)
        if phase == pbstream.Phases.TRACE:
            self._trace_caps.append((self.model.opt_cap(extra=self.cfg.tpu.max_new_gaussians),
                                     self.pipe.curr_iter))

    def _on_check(self):
        """At each check step's start: the window (or the slice) closes
        at the first; the state before the step."""
        if not self._closed:
            self._closed = True
            if self.prof is not None:
                self.prof.stop()
                self.acc["trace_end"] = self._counters()
                t = self.acc["trace_end"]["t"] - self.acc["trace_start"]["t"]
                self.trace_red = pbtrace.reduce(self.prof, t)
                self.prof = None
            else:
                self._window_closed()
        self.snap["before"] = {"volume": volume_rows(self.engine.vol),
                               "pose": self.engine.cam_poses[-1].copy(),
                               "frame": self.engine.current_frame}

    def _check_again(self) -> bool:
        """Another check step, until one has run an optimisation window
        (a cell that runs windows)."""
        return self.cfg.work_mode != "recon" and "window" not in self.snap

    def _wrap_window(self) -> None:
        """Note the check step's window: its inputs, as the program drew
        them, and the pool's rows that it optimises, before it runs."""
        make = self.pipe._megastep_window

        def megastep_window(model):
            key, inputs, statics = make(model)
            if self.source.phase == pbstream.Phases.CHECK:
                rk = statics["rk"]
                self.snap["window"] = {
                    "pool": pool_rows(model, statics["opt_cap"]),
                    "poses": inputs["poses"].clone(), "cam_ids": list(statics["cam_ids"]),
                    "iter_idx": inputs["iter_cam_idx"].tolist(),
                    "noise": inputs["spawn_noise"].clone(),
                    "spawn_idx": int(statics["spawn_idx"]),
                    "ray": (int(rk.lb), int(rk.samples), int(rk.bisect))}
            return key, inputs, statics

        self.pipe._megastep_window = megastep_window

    def _on_done(self):
        eng = self.engine
        g = self.pipe._window_graphs
        self.diag = {"blocks": int(eng.vol.n_blocks), "gaussians": int(self.model.num_gaussians),
                     "peak_visible": dict(eng.peak_visible),
                     "window_graph_captures": g.captures if g is not None else 0,
                     "fusion_graph_captures": (eng._fusion_graphs.captures
                                               if eng._fusion_graphs is not None else 0),
                     "graph_nodes": {name: [c["nodes"] for c in gc.node_counts]
                                     for name, gc in (("window", g),
                                                      ("fusion", eng._fusion_graphs),
                                                      ("tracked", eng._track_graphs))
                                     if gc is not None},
                     "frames": eng.current_frame,
                     "opt_cap": self.model.opt_cap(extra=self.cfg.tpu.max_new_gaussians),
                     "setup_marks": self.setup_marks}
        if self.tracked:
            k = eng.current_frame - 1
            self.diag["pose_err_mm_vs_true"] = float(np.linalg.norm(
                eng.cam_poses[-1][:3, 3] - self.store.pose(k)[:3, 3]) * 1e3)
        n = eng.current_frame - self.snap["before"]["frame"]
        after = {"volume": volume_rows(eng.vol), "frames": list(range(
            self.snap["before"]["frame"], eng.current_frame)),
            "poses": [p.copy() for p in eng.cam_poses[-n:]]}
        if self.tracked:
            ref = eng._last_raycast_for_tracking
            after["track_maps"] = {k: ref[k].clone() for k in ("vertex_map", "normal_map")}
        if "window" in self.snap:
            after["window"] = {"pool": pool_rows(self.model),
                               "losses": self.pipe._last_loss_hist.tolist()}
        pose = after["poses"][-1]
        maps = eng.run_raycast_batch(pose[None], quality=False)
        after["raycast"] = {"pose": pose, "vertex": maps["vertex_map"][0].clone()}
        if self.cfg.work_mode != "recon" and self.model.num_gaussians > 0:
            # the render of the pool as the window left it, at the step's
            # last pose, over the benchmark's own depth of that frame and a
            # black base layer: the same inputs for the reference
            _, depth = self.store.f32(after["frames"][-1])
            base = torch.zeros((self.H, self.W, 3), device=self.device)
            with torch.no_grad():
                res = self.model.forward(pose, self.K, depth, base)
            after["render"] = {"rgb": res["rgb"].clone(), "alpha": res["alpha"].clone(),
                               "depth": depth, "pool": pool_rows(self.model)}
        self.snap["after"] = after

    # the run ------------------------------------------------------------------

    def drive(self) -> None:
        try:
            self.pipe.slam_train_cams(self.model, self.cams)
        except pbstream.EndOfStream:
            return
        raise RuntimeError("the stream ran out before the window closed")

    def record(self) -> dict:
        """What the metric readers read."""
        s0, s1 = self.acc["window_start"], self.acc["window_end"]
        steps = self.source.window_steps()
        n_frames = sum(n for _, _, n in steps)
        rec = {
            "tracked": self.tracked, "work_mode": self.cfg.work_mode,
            "setup_s": self.setup_s,
            "window": {
                "seconds": self.source.t_window_end - self.source.t_window,
                "frames": n_frames, "steps": steps,
                "t_fusion_ms": s1["t_fusion_ms"] - s0["t_fusion_ms"],
                "t_opt_ms": s1["t_opt_ms"] - s0["t_opt_ms"],
                "windows": (s1["adam_steps"] - s0["adam_steps"])
                // max(self.cfg.pipe.local_opt_iters, 1),
                "captures": s1["captures"] - s0["captures"],
            },
            "sh_degree": self.cfg.model.sh_degree,
            "diag": self.diag,
        }
        if "trace_end" in self.acc:
            t0, t1 = self.acc["trace_start"], self.acc["trace_end"]
            caps = self._trace_caps
            wins = []
            for (cap, it0), (_, it1) in zip(caps, caps[1:] + [(None, t1["adam_steps"])]):
                if it1 > it0:
                    wins.append((cap, it1 - it0))
            rec["trace"] = dict(self.trace_red, frames=t1["frames"] - t0["frames"],
                                windows=wins)
            rec["diag"]["trace"] = {k: rec["trace"][k]
                                    for k in ("frames", "events", "busy_s", "window_s")}
        return rec

    def release(self) -> dict:
        """Drop the program's objects; return the check's snapshots."""
        snap = self.snap
        self.pipe = self.model = self.engine = self.source = self.cams = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return snap
