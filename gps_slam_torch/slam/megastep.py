"""One-dispatch optimisation window — the port of
gps_slam_tpu/slam/megastep.py.

The per-window phase chain (localFrameRaycast + keyFrameRaycast ->
initNewGaussians -> localOptimize -> removeRedundantGs,
slam_pipeline.cpp:417-586) needs nothing from the host between the
batched raycast and the post-prune compaction.  `window_megastep` runs
it as one function of tensors with static shapes that reads nothing
back to the host:

    raycast_batch (M poses, K3, k_blocks 1, no normals)
      -> spawn mask on the current frame's raycast (+ GES render, K4)
      -> add_gaussians
      -> window_optimize (the Adam steps: K4 and K5 in every step)
      -> remove_redundant + compact

On the CPU it runs eagerly.  On a CUDA device `WindowGraphs` captures it
as a CUDA graph once per static key and replays the graph for every
later window with that key (the port's counterpart of the JAX
`jax.jit`): a window's host work is then the copy of its inputs into the
graph's buffers and one launch.

The host keeps what it owns in the eager path: the keyframe sample, the
iteration camera sequence, the spawn priorities (drawn with the model's
generator, outside the graph, in the eager path's order) and the static
choices (prefix buckets).  It reads the counts once per window, after
the window has run.

The pipeline routes here only when every per-window host hook is a
no-op (`SLAMPipeline._can_megastep`).
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import NamedTuple

import torch

from .. import kernels
from ..gs import model as gmodel, optim, params as pmod
from ..gs.params import GaussianPool
from ..tsdf import raycast_tiles
from ..tsdf.volume import TsdfVolume
from ..utils import graphs
from ..utils.se3 import compute_normal_map


def spawn_mask_bootstrap(depth, vertex, color, gt, vis_min, vis_max,
                         color_thres):
    """(mask, normal) for the spawn on an empty model."""
    valid = (depth > vis_min) & (depth < vis_max) & (vertex.abs().sum(-1) > 0)
    color_error = (color - gt).abs().mean(-1)
    return (color_error > color_thres) & valid, compute_normal_map(vertex)


def spawn_mask(depth, vertex, rgb_render, alpha, gt, vis_min, vis_max,
               color_thres, alpha_max):
    """(mask, normal) for the alpha-gated spawn."""
    valid = (depth > vis_min) & (depth < vis_max) & (vertex.abs().sum(-1) > 0)
    color_error = (rgb_render - gt).abs().mean(-1)
    mask = (color_error > color_thres) & valid & (alpha < alpha_max)
    return mask, compute_normal_map(vertex)


class WindowScalars(NamedTuple):
    """Static per-window config scalars (PIPE.* + MODEL.*)."""

    depth_vis_min: float
    depth_vis_max: float
    color_error_thres: float
    alpha_vis_max: float
    new_gs_sample_ratio: float
    max_new: int
    default_opacity: float
    min_init_scale: float
    max_init_scale: float
    remove_small: float
    remove_large: float
    remove_low_opac: float
    ssim_weight: float
    depth_weight: float
    max_iterations: int


class RayKnobs(NamedTuple):
    """Static knobs of the window's batched raycast."""

    width: int
    height: int
    lb: int
    samples: int
    bisect: int


def window_megastep(vol: TsdfVolume, pool: GaussianPool, poses, K, gt_rgb,
                    iter_cam_idx, spawn_noise, *, st, st_spawn, sc: WindowScalars,
                    rk: RayKnobs, mcfg, spawn_idx: int, pool_prefix: int,
                    opt_cap: int, bootstrap: bool = False,
                    cam_ids: tuple | None = None) -> dict:
    """One optimisation window on `pool`, in place.

    poses f32 [M, 4, 4] (the opt set padded to M with its last camera),
    K the shared [3, 3] intrinsics on the host (numpy), gt_rgb [M, H, W, 3],
    iter_cam_idx int64 [iters] (< the unpadded count), spawn_noise f32
    [H * W] (the spawn's priorities); `mcfg` the ModelConfig of the
    learning rates; `cam_ids` the cameras' ids (the eager batch's, unused
    without exposure).  Returns device tensors: the loss of each step, the
    binning overflows summed over the M cameras, the spawn overflow, the
    raycasts' largest visible count and the live count after the prune."""
    M = poses.shape[0]
    maps = raycast_tiles.raycast_batch(
        vol, poses, K, rk.width, rk.height, rk.lb, rk.samples,
        max(rk.bisect, 3), 1, need_normals=False, prefix=pool_prefix)
    depth_b = maps["depth_map"][..., 0]                    # [M, H, W]
    color_b = maps["color_map"]                            # [M, H, W, 3]
    s_depth = depth_b[spawn_idx]
    s_vertex = maps["vertex_map"][spawn_idx]
    s_color = color_b[spawn_idx]
    gt_s = gt_rgb[spawn_idx]

    # spawn (initNewGaussians :450-526) on the current frame's raycast
    if bootstrap:
        mask, normal = spawn_mask_bootstrap(
            s_depth, s_vertex, s_color, gt_s, sc.depth_vis_min,
            sc.depth_vis_max, sc.color_error_thres)
    else:
        params_sp = {k: (v if k == "exposure" else v[:opt_cap])
                     for k, v in pool.params.items()}
        res = gmodel.ges_forward(params_sp, pool.alive[:opt_cap], poses[spawn_idx],
                                 K, s_depth, s_color, -1, st_spawn, static=True)
        mask, normal = spawn_mask(
            s_depth, s_vertex, res["rgb"], res["alpha"], gt_s, sc.depth_vis_min,
            sc.depth_vis_max, sc.color_error_thres, sc.alpha_vis_max)
    _, _, n_spawn_ofl = gmodel.add_gaussians(
        pool, s_vertex, gt_s, normal, mask, sc.new_gs_sample_ratio, sc.max_new,
        sc.default_opacity, (sc.min_init_scale, sc.max_init_scale), spawn_noise,
        host_count=False)

    # the Adam steps (localOptimize :195-291)
    batch = {"c2w": poses, "K": K, "cam_id": list(cam_ids or (-1,) * M),
             "gt_rgb": gt_rgb, "ref_depth": depth_b, "base_color": color_b}
    _, aux = gmodel.window_optimize(
        pool, batch, iter_cam_idx, st, mcfg, sc.max_iterations, sc.ssim_weight,
        sc.depth_weight, opt_cap, static=True)

    # prune + restore the compact-prefix invariant (:564-586)
    gmodel.remove_redundant(pool, sc.remove_small, sc.remove_large,
                            sc.remove_low_opac, host_count=False)
    pmod.compact(pool)
    return {
        "loss_hist": aux["loss_hist"],
        "n_tile_overflow": aux["n_tile_overflow"],
        "n_span_overflow": aux["n_span_overflow"],
        "n_active_overflow": aux["n_active_overflow"],
        "n_spawn_overflow": n_spawn_ofl,
        "n_visible": maps["n_visible"],
        "n_alive": pool.alive.sum(),
    }


def hoist_constants(mcfg, sc: WindowScalars, iters: int, device) -> None:
    """Make the device constants that `window_megastep` reads and never
    writes before a capture (a graph cannot capture their host-to-device
    copy): the Adam schedule of the window's steps."""
    if iters > 0:
        gamma = 0.01 ** (1.0 / max(sc.max_iterations, 1))
        optim.window_schedule(float(mcfg.means_lr), gamma, iters, torch.device(device))


def held_tensors(*ts: torch.Tensor) -> tuple:
    """The address and shape of each tensor that a captured graph reads
    or writes in place."""
    return tuple((t.data_ptr(), tuple(t.shape)) for t in ts)


def volume_tensors(vol: TsdfVolume) -> tuple:
    return (vol.table_keys, vol.table_ptrs, vol.block_coords, vol.state, vol.color,
            vol.summary, vol.last_seen)


@dataclass
class Captured:
    """One captured graph: the graph, the buffers its inputs are copied
    into, its outputs (rewritten by every replay), the kernel launches
    recorded while it was captured, its replays and the device memory its
    capture reserved."""

    graph: torch.cuda.CUDAGraph
    inputs: dict
    outputs: dict
    launches: dict
    replays: int = 0
    memory_bytes: int = 0


class GraphCache:
    """CUDA graphs of one function `fn`, one per static key, at most
    `max_graphs` of them: the window megastep's (`WindowGraphs`), the
    chunked gt fusion's frame and the tracked megastep's frame
    (`tsdf/engine.py`).

    `run` captures `fn(**inputs, **statics)` the first time it meets a key
    and replays it for every later call with that key, after copying the
    call's inputs into the graph's buffers (an input given as a list of
    tensors is stacked).  A key is made of static values only (the
    shapes, buckets and config), never of the data.  Buckets grow over a
    run and rarely come back, so before a capture that would exceed
    `max_graphs` the graph used least recently is dropped, and with it the
    memory its capture reserved.  The graphs read and write the `held`
    tensors (the volume, the pool, a device counter) at the addresses they
    had when captured: when any of them has moved (a reallocated pool, a
    loaded scene or model) every graph is dropped before the next run.
    `prepare(buffers, statics)`, when given, runs before each capture and
    makes what the function needs that a graph cannot capture (a constant
    copied from the host, a library's first call).  A capture that fails
    raises; nothing falls back to an eager run.  A capture goes through
    `graphs.capture` (the garbage collector held off);
    `node_counts` records each capture's nodes: all of the graph's
    (`nodes`) and its conditional ones (`conditional`).

    The kernel wrappers count their launches while a graph is captured,
    and the capture's first execution is its replay right after; a later
    replay launches the same kernels again without calling a wrapper: its
    graph's `launches` are added to `replayed_launches`."""

    def __init__(self, fn, max_graphs: int = 2, prepare=None):
        self.fn, self.prepare = fn, prepare
        self.graphs: OrderedDict = OrderedDict()   # least recently used first
        self.max_graphs = max_graphs
        self.captures = 0
        self.replays = 0
        self.dropped = 0
        self.memory_bytes = 0   # reserved by all captures so far
        self.peak_resident = 0  # most graphs held at once
        self.node_counts: list[dict] = []   # per capture, in order
        self.replayed_launches = {k.name: 0 for k in kernels.ALL}
        self.last: tuple | None = None   # (key, "capture" or "replay")
        self._held = None

    def run(self, key: tuple, held: tuple, inputs: dict, **statics) -> dict:
        """`fn` at `key` on `inputs`; `held` is `held_tensors` of the
        tensors it reads or writes in place; `statics` are its other
        arguments, fixed by the key."""
        if held != self._held:
            self.dropped += len(self.graphs)
            self.graphs.clear()
            self._held = held
        g = self.graphs.get(key)
        if g is None:
            while len(self.graphs) >= self.max_graphs:
                self.graphs.popitem(last=False)
                self.dropped += 1
            self.graphs[key] = self._capture(inputs, statics)
            self.captures += 1
            self.memory_bytes += self.graphs[key].memory_bytes
            self.peak_resident = max(self.peak_resident, len(self.graphs))
            self.last = (key, "capture")
            return self.graphs[key].outputs
        self.graphs.move_to_end(key)
        for name, v in inputs.items():
            if isinstance(v, (list, tuple)):
                torch.stack(v, out=g.inputs[name])
            else:
                g.inputs[name].copy_(v)
        g.graph.replay()
        g.replays += 1
        self.replays += 1
        for name, n in g.launches.items():
            self.replayed_launches[name] += n
        self.last = (key, "replay")
        return g.outputs

    def _capture(self, inputs: dict, statics: dict) -> Captured:
        buf = {k: (torch.stack(v) if isinstance(v, (list, tuple)) else v.clone())
               for k, v in inputs.items()}
        if self.prepare is not None:
            self.prepare(buf, statics)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        mem0 = torch.cuda.memory_reserved()
        before = kernels.counts()
        # kept until counted, then instantiated
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with graphs.capture(graph):
            outputs = self.fn(**buf, **statics)
        launches = {k: n - before[k] for k, n in kernels.counts().items()}
        nodes = graphs.node_counts(graph)
        self.node_counts.append(nodes)
        graph.instantiate()
        graph.replay()
        return Captured(graph, buf, outputs, launches,
                        memory_bytes=torch.cuda.memory_reserved() - mem0)


def _window(vol, pool, poses, gt_rgb, iter_cam_idx, spawn_noise, K, **statics):
    return window_megastep(vol, pool, poses, K, gt_rgb, iter_cam_idx, spawn_noise,
                           **statics)


def _hoist_window_constants(buf: dict, statics: dict) -> None:
    hoist_constants(statics["mcfg"], statics["sc"], buf["iter_cam_idx"].shape[0],
                    statics["pool"].device)


class WindowGraphs(GraphCache):
    """The window megastep's CUDA graphs (`GraphCache` of
    `window_megastep`), on the volume and the pool; the opt prefix and the
    pool prefix make its keys, and a capture reserves up to ~2 GB at
    1920x1080."""

    def __init__(self, max_graphs: int = 2):
        super().__init__(_window, max_graphs, prepare=_hoist_window_constants)

    def run(self, key: tuple, vol: TsdfVolume, pool: GaussianPool,
            inputs: dict, **statics) -> dict:
        """Window `key` on (vol, pool) with `inputs` (poses, gt_rgb as a
        list of [H, W, 3] frames, iter_cam_idx, spawn_noise); `statics` are
        the other arguments of `window_megastep`, fixed by the key."""
        held = held_tensors(*volume_tensors(vol),
                            *(pool.params[k] for k in pmod.PARAM_KEYS), pool.alive)
        return super().run(key, held, inputs, vol=vol, pool=pool, **statics)
