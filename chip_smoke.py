#!/usr/bin/env python
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--seed 0] [--profile]

Phases (any failure exits non-zero before the final line):
  1. build: compile the CUDA kernels (csrc/*.cu, nvcc sm_90a, in parallel)
     and print the card's name and power limit;
  2. forward-only path: the gt-pose `train` loop with PIPE.local_opt_iters
     = 0 (fusion, window raycasts, spawns, prunes) at 1200x680 for 30
     frames on the synthetic scene, then an eval render; K1 (once per
     frame), K3 and K4 must launch and K2 must not, and its eval PSNR is
     the trained path's lower bound;
  3. main path: the same loop with the Adam window (`local_opt_iters` 20
     per window, as bench.py runs it: bench.py's Replica-equivalent
     config), >= 2 optimization windows, then an eval render; fusion, on
     every gt-pose path but swap and sharded, in `_fusion_groups` groups
     of up to TPU.fuse_chunk 8 frames, each frame a replay of the fusion
     frame's CUDA graph (captured once per frame size), counts read once
     per group (each path line's `fusion_route`, `fusion_graphs` and
     `fusion_ms_per_frame`), then `[chunk witness]`: the same frames with
     fuse_chunk 1, volumes, poses and PSNR bit for bit; K1, K3, K4
     and K5 must launch and K2 must not, each window's loss must fall from
     its first epoch of cameras to its last, and the eval PSNR must clear
     both the 15 dB floor and the forward-only PSNR.  The first window
     (empty model) is eager, every later one the window megastep
     (slam/megastep.py: a CUDA graph captured once per static key and
     replayed), on every path but the swap and sharded ones, which the
     pipeline keeps eager.  K5 launches once per Adam step whose camera has
     an active tile in an eager window and once per Adam step in a
     megastep window (its lists always hold act_cap rows); a replay calls
     no wrapper, so each path adds its graphs' launches x replays to the
     wrappers' counts;
  4. resident-route path: the forward-only loop at 1296x968 for 21 frames
     (2 windows), the frame size at which the JAX package integrates with
     K2a; K2 (`integrate_f32_cuda`) once per frame, K1 never;
  5. large-frame path: the main path's loop at 1920x1080 for 30 frames,
     2 windows x 20 Adam steps, where the JAX package takes K2b; K2 once
     per frame, K1 never, K3, K4, K5 as in the main path, the same loss
     and 15 dB gates; then the same frames once more on K1's route (the
     port's budget raised), whose eval PSNR must lie within
     ROUTE_PSNR_GAP_DB of the f32 route's: a gap to the 1200x680 PSNR is
     then the frame size's, not the route's;
  6. tracked path: tracked `train` mode (PIPE.TSDF.use_gt_pose false,
     make_tracker's ICP, policy ignore) at 1200x680 for 30 frames of an
     inward-looking orbit (look="in", arc 0.05: ~0.6 degrees a frame),
     frame 0 seeded with its gt pose, 2 windows x 20 Adam steps, each
     frame after the first the tracked megastep (one CUDA graph: ICP,
     the revert, fusion, the next prepare raycast; one read a frame; each
     pyramid level's Gauss-Newton loop one cooperative launch of
     icp_gn_cuda, one kernel node, whose exit the card tests after each
     iteration), then the same frames on the eager route as its witness
     (one launch and one read a level): K1 and the tracking-prepare K3
     (its tracking mode: the JAX XLA march's semantics, k_blocks 2,
     need_color False) once per frame, icp_gn_cuda once a level run on
     both routes;
     each run: ATE below 3 voxels, the last pose within 2 cm and 2
     degrees, GOOD on >= 70% of the tracked frames, eval PSNR above 15 dB;
     `[tracked routes]` gives both routes' ms per tracked frame over the
     same scope (engine.process_frame: ICP, revert, fusion, the next
     prepare raycast; median, mean, least, most, first) and the eager
     route's split, the replay ms, the iterations per level of both
     routes, each capture's nodes and the WHILE nodes left (none),
     icp_gn_cuda's launches and the iterations the card ran, and the CUDA
     versions; then `[tracking fixture]`: tests/test_tracking.py's
     three tracking fixtures at 160x120 (its fixture, the same at half
     the arc, its noisy stress fixture) on both routes, with that file's
     gates and icp_gn_cuda once a level run; then `[color tracked path]`: the same 30 frames with
     PIPE.TSDF.tracker.type composite (colour refine, then ICP), on the
     eager route the JAX engine's gate gives it: the colour stage's ms per
     frame, iterations per level, labels, inliers and residuals,
     color_gn_cuda and icp_gn_cuda once a level run, no torch.linalg
     solve or inverse in the colour stage, the
     tracking-prepare raycast with colour at LB 16, and the tracked gates
     and the 15 dB floor; `[color tracker fixture]`:
     tests/test_tracking.py's colour test (160x120, the old view's exact
     points and colours, a new rgb 2.2 cm away) on the card: not FAILED,
     the translation error at most half the initial one;
  7. swap path: gt-pose `train` at 1200x680 on a full outward turn (40
     frames) with the block pool cut to 16,384 rows and host swapping on
     (check every 2 frames, waters 0.80 / 0.50): blocks spill and reload,
     fusion never fills the pool (no allocation dropped), K1 once per
     frame, K3 once per raycast pose, K4/K5 and the loss and 15 dB gates
     as on the main path; the raycast from pose 0 after the turn against
     the same frames fused into a 2^17-block pool: depth error below
     max(3x its, 1 cm), coverage above 0.8x (tests/test_swapping.py);
  8. offline raw: the classic 3DGS trainer (`render_method: raw`) at
     1200x680 on the main path's cameras, from frame 0's backprojection
     (at most 16,384 Gaussians), 300 iterations with densify at 150 and
     200: camera 0's PSNR rises by more than 1 dB, densify changes rows;
  9. offline GES: `ges_train_cams` at 1200x680 for 200 iterations from
     the main path's pool against its engine's raycasts: K4 and K5 once
     per iteration with an active tile, the L1 of the first camera that
     sees a Gaussian falls, the eval views' PSNR does not;
 10. kernels: each kernel against its plain PyTorch version on the inputs
     of its last call on its path (K1 on the main and the sharded path, K2
     once per route, K3 on the main path, on the 1920x1080 path, on the
     tracked path's last tracking-prepare call (its tracking mode, bit
     for bit, and beside it the same inputs at k_blocks 1 on the TPU kernel's
     semantics: a [kernel] line left out of the JSON line, not a launch
     of the path) and on the sharded path's last shard raycast), with
     CUDA-event timings, the least time the card
     could take for the same work and the kernel's design; K4 and K5 also
     on the tiles of their lists with a live slot alone (the same bits,
     and its time), and their bounds count only those tiles' pixels and
     outputs (a tile with none sums nothing; the window megastep's padded
     lists are mostly such tiles); icp_gn_cuda on the eager witness's
     last frame at each pyramid level (the level from its start, one
     launch: ms a launch, passes, ms a pass; the state, count, test and
     last pass's rows bit for bit with its plain level loop);
     color_gn_cuda likewise on the colour tracked path's last frame, and
     K3's tracking mode on that path's last prepare call (with colour);
     `[window step]`: project_sh_fwd_cuda, project_sh_bwd_cuda and
     window_adam_cuda (one launch each an Adam step, checked on every
     path; each path line's `window_nodes_per_step` counts the nodes a
     step adds to a window graph: the path's last captured window
     captured again with all and with half its steps) on the main path's
     last window step, bit for bit with their plain versions (each row
     with the megastep path's launches too, the first two with their
     first design's ms), then the nodes per step and the megastep path's
     replay ms beside the parent's records;
 11. mesh: the main path's volume meshed on the host by the native mesher
     (native/mesher.cpp, built with g++ into build/, with OpenMP where the
     compiler has it) and by the numpy
     route: equal triangle counts, sorted triangles within 1e-5 m, sorted
     colours within 2e-2;
 12. reference: fusion at 128x96 on the card against the plain CPU path,
     on K1's route and on the f32 route (budget 0), and at 48x40 (the
     torch branch of frames below 64 px, on both devices): the same block
     set and, by key, every state word's weights equal, sdf within 1
     quantum and colour within 1; on K1's route and at 48x40 also a
     raycast (equal hit masks, depths within a voxel); then the tracked
     loop at 128x96 (8 frames, look="in") on the card and the CPU in
     lockstep (the card fuses at the CPU's poses): equal quality labels,
     each frame's estimates within 1 voxel and 0.1 degree, all but one
     within 1 mm; `[reference color tracked]`: the same loop with the
     composite tracker, the card's trackers also run on the CPU engine's
     maps: equal labels of both stages, on the same maps equal colour
     iterations per level, each frame within 1 voxel and 0.1 degree (on
     every tracked fixture and reference, each Gauss-Newton kernel
     launches once a level run);
     `[reference chunked]`: the fusion fixtures through the
     chunk route (a capture and 5 replays on the card) on both devices,
     with the gates above; `[tracked megastep reference]`: 4 tracked
     frames at 128x96 through the megastep's graph (a capture, 2
     replays) and uncaptured, bit for bit, each frame's iterations per
     level equal to the eager loop's on its inputs and not the budgets;
     the swap fixture of
     tests/test_swapping.py (128x96, 24
     frames, 1024-block pool) on both devices: equal counts, key sets and
     store keys at every check, words within fusion's tolerance; and the
     offline raw path at 128x96: one render and its gradients, then 20
     iterations with densify and one injected split noise, equal alive
     rows after each densify;
 13. sharded path (run right after phase 9, on the main path's volume and
     model): the main path's loop with the raycasts' visible cap at 4x
     (then also 32 blocks per tile list), then its loop and frames with
     TPU.space_shards 4 (per shard a 2^19 hash and 32,768 blocks, all on
     the one card): K1 once per shard and frame, K3 once per shard and
     raycast pose, K5 and the loss gates as on the main path, eval PSNR
     above 15 dB and within ROUTE_PSNR_GAP_DB of the main path's and of
     both raised-cap runs'; the last sharded K1 and K3 calls held against
     their plain versions in phase 10 (K3 bit for bit); every key owned by its
     shard and >= 99.9% of the keys with the main path's state, colour and
     summary words bit for bit; the pose-0 raycast within
     tests/test_parallel.py's gates; the scene.npz round trip bit for bit;
     the per-shard mesh's triangles and time;
 14. dp: the pipeline's data-parallel eval render over [cuda:0, cuda:0]
     equals forward_batch bit for bit; a 2-replica dp_train_step equals
     the single-replica step within 1e-6; over 2 replicas of 2 different
     cameras its averaged gradient equals one replica's gradient of the
     mean loss over both within 1e-6 of each parameter's largest
     |gradient|, and its loss the per-camera mean within 1e-6;
 15. viewer: viewer.server.serve answers 3 requests on localhost (2 at
     1200x680, 1 at 800x600) with the model's render bytes, bit for bit;
 16. lpips: seeded random LPIPS(vgg) weights on the card and the CPU within
     1e-5 relative on a 300x170 crop, the card's ms per 1200x680 pair, and
     metrics.lpips None without a weight file;
 17. prefetch: FramePrefetcher yields the main path's 30 frames in order,
     equal to DeviceFrameCache's tensors bit for bit;
 18. megastep path (run right after phase 17): 110 frames of the outward
     arc at the main path's motion per frame (1 bootstrap + 9 megastep
     windows), once with every window eager, then with the megastep: per
     window its route, static key, capture or replay and ms beside the
     eager ms; after the first megastep window the pools equal (every
     live row within 0.01 lr), at the end counts within 0.5%, eval PSNRs
     within 0.05 dB, one camera's renders > 45 dB apart, >= 1 replay, at
     most the pipeline's 2 graphs held at once; then
     `[megastep reference]`: two windows of that state through a fresh
     graph (capture, replay) and uncaptured: bit for bit.
The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.  Without a CUDA device the
script exits with code 2 and prints no result.
"""

from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_F32_FLOP_PER_S = 67e12     # f32 outside the tensor cores
H100_F64_FLOP_PER_S = 34e12     # f64 outside the tensor cores, the same data sheet

N_FRAMES = 30   # >= 2 optimization windows at local_opt_interval 10
RESIDENT_FRAMES = 21  # the fewest frames that still hold 2 windows
ADAM_STEPS = 20  # PIPE.local_opt_iters of bench.py and the release configs
# the JAX package gates its own CPU train run at 15 dB (tests/test_slam.py:86)
PSNR_FLOOR_DB = 15.0
# K1 and K2 differ in depth precision (bf16 hi + lo against f32), colour
# rounding (0..255 against 0..1 units) and the mip (bf16 matmul against an
# f32 mean): far below what moves an eval render by half a dB
ROUTE_PSNR_GAP_DB = 0.5
# the tracked path: bench.py's configuration with use_gt_pose false on an
# inward-looking orbit (every view holds the box corners, the floor and the
# far wall: fully constrained point-to-plane ICP), ~0.6 degrees a frame
TRACKED_ARC = 0.05
# views across the room see more blocks than bench.py's outward orbit, for
# which its visible cap of 8192 was sized; the tracked path alone raises it
TRACKED_VISIBLE_CAP = 2 ** 16
# the JAX package's own tracking gates (tests/test_tracking.py), in voxels
# of 5 mm: ATE below 3 voxels, the last pose within 4 voxels (2 cm) and
# 2 degrees, GOOD on >= 70% of the tracked frames
ATE_MAX_VOXELS = 3.0
LAST_MAX_M = 0.02
LAST_MAX_DEG = 2.0
GOOD_MIN_SHARE = 0.7
# tests/test_tracking.py's own fixtures at 160x120 with 2 cm voxels (name,
# frames, arc, noisy depth): its tracked fixture, the same at half the arc,
# and its stress fixture (depth noise of 5 mm sigma and 10% dropout drawn
# frame by frame from default_rng(7)), each with that file's gates in
# voxels: ATE, the last pose and GOOD as above on the first two; ATE below
# 6 voxels and FAILED on <= 20% of the tracked frames on the stress one
TRACK_FIXTURES = (("arc 0.025", 16, 0.025, False), ("arc 0.0125", 16, 0.0125, False),
                  ("stress", 32, 0.05, True))
LAST_MAX_VOXELS = 4.0
STRESS_ATE_MAX_VOXELS = 6.0
STRESS_FAILED_MAX_SHARE = 0.2
# the swap path: bench.py's configuration on a full outward turn (40
# frames, 9 degrees a frame as on the main path) with the block pool cut
# below the turn's ~28k blocks and the waters and check interval of
# tests/test_swapping.py; its raycast gate compares with a 2^17-block pool
SWAP_FRAMES = 40
SWAP_TPU = {"block_capacity": 16384, "enable_swapping": 1, "swap_check_interval": 2,
            "swap_high_water": 0.80, "swap_low_water": 0.50}
SWAP_BIG_POOL = 2 ** 17
# the offline trainers: release knobs but max_iterations (10,000 in the
# release configs) and, for raw, densify's start, interval and end scaled
# into the cut run (the opacity reset stays at 3000: no reset here)
OFFLINE_RAW_ITERS = 300
OFFLINE_GES_ITERS = 200
OFFLINE_DENSIFY = {"densify_start_iter": 100, "densify_interval": 50,
                   "densify_end_iter": 250}
OFFLINE_REF_ITERS = 20  # the card-against-CPU raw run at 128x96
# the tests/test_native.py comparison of two meshes of one volume
MESH_TRI_ATOL, MESH_COL_ATOL = 1e-5, 2e-2
# the sharded path: the main path's configuration with TPU.space_shards 4
# (per shard a 2^19 hash and 32,768 blocks); the share of the main path's
# blocks whose words it must give bit for bit (a claim round may drop a
# key in one table and not in the other)
SHARDS = 4
SHARD_KEY_SHARE = 0.999
# the main path with the raycasts' caps raised towards what the shards'
# raycasts hold together (each shard bins up to the visible capacity of its
# own blocks and keeps up to LB of them per tile): SHARDS x the visible
# capacity, then also K3's largest tile list
WIDE_CAP_RUNS = (("main path, visible cap x4", {"visible_block_capacity": SHARDS * 2 ** 13}),
                 ("main path, visible cap x4, LB 32",
                  {"visible_block_capacity": SHARDS * 2 ** 13, "raycast_lb": 32}))
# the viewer's requests: two at the main path's size and one of another
VIEWER_REQUESTS = ((1200, 680), (1200, 680), (800, 600))
LPIPS_CROP = (170, 300)  # rows, columns of the card-against-CPU LPIPS crop
# the megastep path: 110 frames (1 bootstrap window and 9 more at
# local_opt_interval 10) of the outward arc at the main path's motion per
# frame; gates against the same frames with every window eager: counts
# within 0.5%, eval PSNR within 0.05 dB, one camera's renders more than
# 45 dB apart (tests/test_slam.py's bound for the JAX megastep)
MEGASTEP_FRAMES = 110
MEGASTEP_ARC = 0.75 * MEGASTEP_FRAMES / N_FRAMES
MEGASTEP_COUNT_GAP = 0.005
MEGASTEP_PSNR_GAP_DB = 0.05
MEGASTEP_RENDER_DB = 45.0


def log(*a):
    print(*a, flush=True)


def sdf_of(words: torch.Tensor) -> torch.Tensor:
    """The signed i16 sdf in the low half of packed state words."""
    return ((words & 0xFFFF) ^ 0x8000) - 0x8000


def live_slots(packed: torch.Tensor, gids: torch.Tensor, C: int) -> tuple:
    """(live slots per tile, the tiles with one) of a splat kernel's lists:
    a slot whose opacity is below 1/255 adds exactly zero, and a splat
    kernel skips it; a tile with none is skipped whole."""
    from gps_slam_torch.gs import rasterize as trz

    live = (packed[gids.long(), 6 + C] >= trz.GMIN_ALPHA).sum(1)
    return live, torch.nonzero(live > 0)[:, 0]


def live_rows(packed: torch.Tensor, gids: torch.Tensor) -> int:
    """Distinct Gaussian rows of `packed` that the tile lists name (the null
    row N excluded): the rows a splat kernel reads, each counted once."""
    return torch.unique(gids[gids < packed.shape[0] - 1]).numel()


def tap_pixels(keys, w2c, fx, fy, cx, cy, W, H, voxel_size) -> int:
    """Distinct image pixels that the voxels of the blocks `keys` tap (a
    voxel that projects inside the image and its block's window reads one
    depth and one rgb word): the pixels an integrate kernel must read."""
    from gps_slam_torch.tsdf import integrate as tint

    _, seen, pix, _ = tint._voxel_taps(keys, w2c, fx, fy, cx, cy, W, H, voxel_size)
    return torch.unique(pix[seen]).numel()


def march_work(margs, track: bool = False, chunk: int = 128) -> dict:
    """What a `march` call's data asks of it, from the plain version's own
    coarse pass (`raycast_tiles._coarse`) and pick rule: the (ray, block)
    pairs whose slab test hits (only they take the coarse mip samples), the
    picks the rays make (min(k_blocks, their keys < inf): only they are
    refined, at each of the ray's pixels), and the distinct blocks that
    any ray picks (only their state rows are read).  A ray is a 2x2 quad,
    or in the tracking mode (`track`) a pixel."""
    from gps_slam_torch.tsdf import raycast_tiles as trc

    gids, _, _, summary, bc, cam, tw, s_c, _, k_b = margs[:10]
    T, LB = gids.shape
    hit_pairs = picks = 0
    picked_rows = []
    slots = torch.arange(LB, device=gids.device)[None, :, None]
    for a in range(0, T, chunk):
        g = gids[a:a + chunk]
        tiles = torch.arange(a, a + g.shape[0], device=gids.device)
        _, gsafe, _, hit, key, _, _, _ = trc._coarse(tiles, g, summary, bc, cam, tw, s_c,
                                                     per_pixel=track)
        hit_pairs += int(hit.sum().item())
        picked = torch.zeros(g.shape, dtype=torch.bool, device=g.device)
        for _ in range(k_b):
            kmin = key.amin(1)                                       # [n, R]
            slot = torch.where(torch.isfinite(kmin), key.argmin(1), LB)
            mark = slots == slot[:, None, :]                         # [n, LB, R]
            picked |= mark.any(2)
            key = torch.where(mark, torch.inf, key)
            picks += int((slot < LB).sum().item())
        picked_rows.append(gsafe[picked])
    return {"hit_pairs": hit_pairs, "picks": picks, "rays": key.shape[2],
            "picked_rows": torch.unique(torch.cat(picked_rows)).numel()}


def plain_march(*a, track: bool = False, **kw):
    """`raycast_tiles.march` on its plain version whatever the tensors'
    device (the tracking mode: `march_plain` with raycast_tiles.TRACK)."""
    from gps_slam_torch.tsdf import raycast_tiles as trc

    return trc.march_plain(*a, xla=trc.TRACK if track else frozenset(), **kw)


def bound_ms(n_bytes: float, n_ops: float, n_f64_ops: float = 0.0) -> tuple[float, str]:
    """The larger of the bytes' time at the card's memory rate and the
    operations' time at its peak rates (f32 ops, then f64 ops beside
    them)."""
    tb = n_bytes / H100_BYTES_PER_S * 1e3
    to = (n_ops / H100_F32_FLOP_PER_S + n_f64_ops / H100_F64_FLOP_PER_S) * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


_L2_FLUSH = None


# cycles the card spins before each timed launch (~1 ms at H100 clocks),
# so that the host has queued the launch before the start event runs
_HOST_LEAD_CYCLES = 2_000_000


def spread_ms(ms: list) -> dict:
    """Mean, median, least and most of host-clock times (ms), and the
    first (which holds a capture or a warm-up)."""
    return {"mean": float(np.mean(ms)), "median": float(np.median(ms)),
            "min": float(np.min(ms)), "max": float(np.max(ms)), "first": float(ms[0]),
            "n": len(ms)}


def time_ms(fn, reps: int, warmup: int = 2, before=None) -> float:
    """Mean CUDA-event time of fn over `reps` launches, each after a write
    of 128 MiB that evicts the 50 MB L2 (the main path reaches each kernel
    with its pool rows cold) and a spin of the card that keeps it busy
    while the host runs the wrapper: the events then time the device work
    of fn alone, not the host's Python before the launch.  `before`, when
    given, runs ahead of each launch and its flush, outside the events
    (it restores what fn updates in place).  The garbage collector is
    off meanwhile: a full collection of the script's heap, late in the
    run, can outlast the spin and stall the card between the events."""
    global _L2_FLUSH
    if _L2_FLUSH is None:
        _L2_FLUSH = torch.empty(32 << 20, dtype=torch.float32, device="cuda")
    gc_was = gc.isenabled()
    gc.disable()
    try:
        return _time_ms(fn, reps, warmup, before)
    finally:
        if gc_was:
            gc.enable()


def _time_ms(fn, reps: int, warmup: int, before) -> float:
    for _ in range(warmup):
        if before is not None:
            before()
        fn()
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(reps)]
    for a, b in ev:
        if before is not None:
            before()
        _L2_FLUSH.zero_()
        torch.cuda._sleep(_HOST_LEAD_CYCLES)
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in ev) / reps


def bench_config(n_frames: int, width: int, height: int, cam0,
                 local_opt_iters: int) -> dict:
    """bench.py's Replica-equivalent gt-pose config (bench.py:63-98) with
    `local_opt_iters` Adam steps per optimization window."""
    from gps_slam_torch.data import synthetic

    node = {
        "input_dir": "mem", "image_path": "c", "pose_path": "c", "depth_path": "d",
        "pcd_name": "n", "depth_scale": 6553.5, "scene_scale": 1.0,
        "start_frame": 0, "end_frame": n_frames - 1, "frame_step": 1,
        "intrinsics": [cam0.fx, cam0.fy, cam0.cx, cam0.cy],
        "image_shape": [width, height], "downscale_factor": 1,
        "test_split_interval": -1,
    }
    d = synthetic.default_config_dict("build/smoke_ws", node)
    d["PIPE"].update(localframe_cam_window_length=2, localframe_cam_window_interval=5,
                     local_opt_iters=local_opt_iters, local_opt_interval=10,
                     keyframe_select_max=7,
                     keyframe_theta_thres=30, keyframe_trans_thres=0.3)
    d["PIPE"]["TSDF"].update(voxel_size=0.005, trunc_dist=0.02)
    d["MODEL"].update(sh_degree=3)
    d["TPU"] = {
        "gaussian_capacity": 2 ** 18, "hash_size": 2 ** 21,
        "block_capacity": 2 ** 17, "visible_block_capacity": 2 ** 13,
        "max_isects": 2 ** 20, "tile_gaussian_cap": 64, "raycast_lb": 16,
        "tiles_per_gaussian_cap": 9, "alloc_stride": 3,
        "visible_sort_overflow": False,
    }
    return d


class Recorder:
    """Keeps the arguments of the last call of each kernel wrapper (of
    `icp_gn.iterate` and `color_gn.iterate`, one per pyramid level size,
    uncaptured calls only); not of the calls made while `Recorder.paused`
    holds (the extra window captures of `window_nodes_per_step`)."""

    paused = False

    def __init__(self):
        from gps_slam_torch.gs import rasterize as trz
        from gps_slam_torch.tsdf import integrate as tint
        from gps_slam_torch.tsdf import raycast_tiles as trc

        self.last = {}
        for mod, name in ((tint, "integrate_blocks_packed"), (tint, "integrate_blocks"),
                          (trc, "march"), (trz, "splat_fwd"), (trz, "splat_bwd")):
            orig = getattr(mod, name)

            def wrap(*args, _orig=orig, _name=name, **kw):
                if not Recorder.paused:
                    self.last[_name] = (args, kw)
                return _orig(*args, **kw)

            setattr(mod, name, wrap)
        from gps_slam_torch.gs import gauss_step, optim

        # the Adam step's per-Gaussian kernels: the forward of a step (its
        # means require a grad; binning, spawn and eval renders do not),
        # the backward, and the optimizer (its state after the call)
        for mod, name, keep in ((gauss_step, "project_sh_fwd", lambda a: a[0].requires_grad),
                                (gauss_step, "project_sh_bwd", lambda a: True),
                                (optim, "window_adam", lambda a: True)):
            orig = getattr(mod, name)

            def step_wrap(*args, _orig=orig, _name=name, _keep=keep, **kw):
                if not Recorder.paused and _keep(args):
                    self.last[_name] = (args, kw)
                return _orig(*args, **kw)

            setattr(mod, name, step_wrap)
        from gps_slam_torch.slam import color_gn, icp_gn

        # one entry per level size: ("icp_gn", (h, w)) of the depth,
        # ("color_gn", (h, w)) of the image; each with the state, count
        # and test the level started from (a level runs in place), and
        # only for launches that run now (a captured launch's tensors hold
        # nothing yet)
        for mod, name, image in ((icp_gn, "icp_gn", 0), (color_gn, "color_gn", 3)):
            iterate = mod.iterate

            def gn_wrap(*args, _iterate=iterate, _name=name, _image=image, **kw):
                if not Recorder.paused and not torch.cuda.is_current_stream_capturing():
                    start = tuple(t.clone() for t in args[10:13])
                    self.last[(_name, tuple(args[_image].shape[:2]))] = (args, kw, start)
                return _iterate(*args, **kw)

            mod.iterate = gn_wrap


def epoch_means(hist: np.ndarray, n_cams: int) -> tuple[float, float]:
    """Mean loss over the first and over the last full epoch of a window:
    the steps visit the opt set's cameras in shuffled epochs, so only
    whole epochs compare."""
    k = len(hist) // n_cams
    if k < 2:
        raise RuntimeError(f"window of {len(hist)} steps has < 2 epochs of {n_cams}")
    return float(hist[:n_cams].mean()), float(hist[(k - 1) * n_cams:k * n_cams].mean())


def window_nodes_per_step(key: tuple, inputs: dict, statics: dict, vol, pool) -> float:
    """The kernel nodes one Adam step adds to a window graph: a window
    (`SLAMPipeline._megastep_window`'s key, inputs and statics) captured
    in a fresh `WindowGraphs` with all its steps and with half of them,
    each on its own copy of the pool; the difference of the two captures'
    nodes (`node_counts`) over the steps between them, as
    tools/window_step_time.py counts it.  The volume is only read, and
    the `Recorder` keeps none of these calls."""
    import dataclasses

    from gps_slam_torch.gs import params as pmod
    from gps_slam_torch.slam import megastep as ms

    steps, half = key[1], key[1] // 2
    nodes = []
    Recorder.paused = True
    try:
        for n in (steps, half):
            copy = dataclasses.replace(pool, **{
                k: getattr(pool, k).clone() for k in (*pmod.PARAM_KEYS, "alive")})
            graphs = ms.WindowGraphs()
            graphs.run((key[0], n, *key[2:]), vol, copy,
                       dict(inputs, iter_cam_idx=inputs["iter_cam_idx"][:n]), **statics)
            nodes.append(graphs.node_counts[0]["nodes"])
            del graphs, copy
        torch.cuda.synchronize()
    finally:
        Recorder.paused = False
    torch.cuda.empty_cache()
    return (nodes[0] - nodes[1]) / (steps - half)


def run_path(args, cams, iters: int, tag: str, fusion, tracked=None, swap=None,
             shards: int = 1, tpu: dict | None = None, megastep: bool = True,
             extras: dict | None = None, fast_track: bool = True,
             tracker: str | None = None):
    """Drive the train loop with `iters` Adam steps per window over `cams`,
    then the eval render, with every kernel count set to 0 just before and
    read just after; check the output and return the numbers of the
    `[tag]` line, the engine and the model.  `fusion` is the integrate
    kernel of the frame size's route: it must launch once per frame, the
    other one never.  Poses are the gt ones, or with `tracked` (the
    Recorder of the kernel wrappers' calls) the ICP tracker's (frame 0
    seeded with its gt pose): each later frame the tracked megastep (a
    CUDA graph: track, revert, fuse, prepare raycast), or with
    `fast_track` False the eager route (the tracker timed apart from
    fusion); `tracker` sets PIPE.TSDF.tracker.type (a composite tracker
    takes the eager route, as the JAX engine's gate says).  Gt-pose
    fusion runs in `_fusion_groups` groups (each frame a replay of the
    fusion frame's graph) unless TPU.fuse_chunk is 1, shards
    or swapping make it per frame: `fusion_route`.  `swap` (TPU
    settings) turns host swapping on, instrumented by `SwapStats`.  With
    `shards` > 1 the pool splits into that many space shards
    (`TPU.space_shards`): fusion launches once per shard and frame, K3 once
    per shard and raycast pose.  `tpu` overrides other TPU settings.
    Windows past the bootstrap one take the window megastep (a CUDA graph,
    captured once per static key and replayed) where the pipeline's gates
    allow it, unless `megastep` is False; each window's route, graph event
    and wall ms are in `windows_route`, and the launches include those of
    the replays.  `extras`, when given, receives the pipeline and the pool
    (on the host) after the second window."""
    from gps_slam_torch import kernels
    from gps_slam_torch.config import Config
    from gps_slam_torch.eval import metrics as M
    from gps_slam_torch.gs import model as gmodel
    from gps_slam_torch.gs.model import GaussianModel
    from gps_slam_torch.slam.pipeline import SLAMPipeline
    from gps_slam_torch.slam.tracker import make_tracker
    from gps_slam_torch.tsdf.engine import TsdfEngine

    N, W, H = len(cams), cams[0].width, cams[0].height
    d = bench_config(N, W, H, cams[0], iters)
    if tracked is not None:
        d["PIPE"]["TSDF"]["use_gt_pose"] = False
        d["TPU"]["visible_block_capacity"] = TRACKED_VISIBLE_CAP
        if tracker is not None:
            d["PIPE"]["TSDF"]["tracker"] = {"type": tracker}
    d["TPU"].update(swap or {})
    d["TPU"].update(tpu or {})
    if shards > 1:
        d["TPU"]["space_shards"] = shards
    cfg = Config.from_dict(d)
    engine = TsdfEngine(cfg, W, H, cams[0].K, device="cuda")
    track = swapped = None
    if tracked is not None:
        engine.set_gt_poses([cams[0].c2w])
        if not fast_track:
            engine._can_fast_track = lambda: False
        track = TrackedStats(engine, make_tracker(cfg, W, H), tracked)
    else:
        engine.set_gt_poses([c.c2w for c in cams])
        engine.turn_off_tracking()
    if swap is not None:
        swapped = SwapStats(engine)
    vols = engine.shards
    raycast_poses = [0]
    if shards > 1:
        run_raycast = engine.run_raycast

        def counted_raycast(*a, **kw):
            raycast_poses[0] += 1
            return run_raycast(*a, **kw)

        engine.run_raycast = counted_raycast
    model = GaussianModel(cfg, W, H, device="cuda")
    model._rng.manual_seed(args.seed)
    pipe = SLAMPipeline(cfg, engine, cfg.workspace_dir, is_train=False)
    pipe.disable_megastep = not megastep
    # (cameras, step losses, K5 launches) per window: an eager window's
    # steps launch K5 when their camera has an active tile, a megastep
    # window's every step (its static lists always hold act_cap rows)
    windows = []
    window_log = []   # route, graph event, static key and wall ms per window
    window_optimize = gmodel.window_optimize

    def record_window(pool, batch, idx, *a, **kw):
        pool, aux = window_optimize(pool, batch, idx, *a, **kw)
        if not kw.get("static"):   # the megastep's call runs inside its graph
            windows.append((len(batch["cam_id"]), aux["loss_hist"].cpu().numpy(),
                            sum(1 for m in idx if aux["active_tiles"][m] > 0)))
        return pool, aux

    def snapshot():
        if extras is not None and len(window_log) == 2:
            extras["pool_after_window_2"] = {
                k: v.detach().cpu() for k, v in (*model.pool.params.items(),
                                                 ("alive", model.pool.alive))}

    # the window of each graph capture (its key, inputs and statics), for
    # `window_nodes_per_step`
    drawn, captured = [None], []
    draw_window = pipe._megastep_window

    def recorded_draw(model_):
        drawn[0] = draw_window(model_)
        return drawn[0]

    t_window = [0.0]
    raycast_opt_set, remove_redundant = pipe._raycast_opt_set, pipe.remove_redundant
    run_megastep = pipe._run_window_megastep

    def eager_start():
        torch.cuda.synchronize()
        t_window[0] = time.monotonic()
        raycast_opt_set()

    def eager_end(model_):
        remove_redundant(model_)
        torch.cuda.synchronize()
        window_log.append({"frame": pipe.curr_frame_id, "route": "eager",
                           "ms": (time.monotonic() - t_window[0]) * 1e3})
        snapshot()

    def megastep_window(model_):
        t = time.monotonic()
        run_megastep(model_)   # ends in the read of the window's counts
        ms_ = (time.monotonic() - t) * 1e3
        hist = pipe._last_loss_hist.cpu().numpy()
        windows.append((len(pipe.opt_cam_list), hist, len(hist)))
        key, event = pipe._window_graphs.last
        if event == "capture":
            captured.append(drawn[0])
        window_log.append({"frame": pipe.curr_frame_id, "route": "megastep",
                           "graph": event, "ms": ms_,
                           "key": {"M": key[0], "steps": key[1], "spawn_idx": key[11],
                                   "pool_prefix": key[12], "opt_cap": key[13]}})
        snapshot()

    pipe._raycast_opt_set = eager_start
    pipe.remove_redundant = eager_end
    pipe._run_window_megastep = megastep_window
    pipe._megastep_window = recorded_draw
    gmodel.window_optimize = record_window
    for c in cams:
        pipe.frame_cache.get(c)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    eval_cams = cams[::6]
    renders = []

    def drive():
        t0 = time.monotonic()
        pipe.slam_train_cams(model, cams)
        torch.cuda.synchronize()
        t1 = time.monotonic()
        for cs, rays, res in pipe.render_eval(model, eval_cams):
            if res is None:
                raise RuntimeError("eval render produced no Gaussian render")
            renders.append((cs, res["rgb"]))
        torch.cuda.synchronize()
        return t1 - t0, time.monotonic() - t1

    kernels.reset_counts()
    try:
        if args.profile and iters > 0:
            (train_s, eval_s), busy_ms = profiled(drive)
        else:
            train_s, eval_s = drive()
    finally:
        gmodel.window_optimize = window_optimize
        del pipe._megastep_window
        if swapped is not None:
            swapped.detach()
    launches = kernels.counts()
    graphs = pipe._window_graphs
    # a replay launches without calling a wrapper
    for g in (graphs, engine._fusion_graphs, engine._track_graphs):
        for name, n in g.replayed_launches.items():
            launches[name] += n
    fg = engine._fusion_graphs
    # the kernel nodes one Adam step adds to a window graph (None: no
    # window was captured)
    nodes_per_step = (window_nodes_per_step(*captured[-1], engine.vol, model.pool)
                      if captured and iters > 1 else None)
    psnrs = []
    for cs, rgb in renders:
        if tuple(rgb.shape) != (len(cs), H, W, 3) or not bool(torch.isfinite(rgb).all()):
            raise RuntimeError(f"eval render: bad output {tuple(rgb.shape)}")
        for i, c in enumerate(cs):
            psnrs.append(M.psnr(rgb[i].cpu().numpy(), c.image))
    n_windows = sum(1 for i in range(N) if i > 0 and i % cfg.pipe.local_opt_interval == 0)
    out = {
        "frames": N, "width": W, "height": H, "windows": n_windows,
        "local_opt_iters": iters,
        "train_s": train_s, "fps": N / train_s,
        "fusion_route": ("chunked" if cfg.tpu.fuse_chunk > 1 and engine.can_chunk_fusion()
                         else "per frame"),
        "fusion_ms_per_frame": pipe.t_fusion / N,
        "fusion_graphs": {"captures": fg.captures, "replays": fg.replays,
                          "dropped": fg.dropped, "graph_mb": fg.memory_bytes / 2 ** 20},
        "window_raycast_ms_total": pipe.t_local_raycast,
        "spawn_ms_total": pipe.t_init_gs, "window_opt_ms_total": pipe.t_opt,
        "prune_ms_total": pipe.t_remove,
        "adam_steps": int(sum(len(h) for _, h, _ in windows)),
        "adam_steps_with_tiles": int(sum(t for _, _, t in windows)),
        "windows_loss": [
            {"cams": n, "loss_first": float(h[0]), "loss_last": float(h[-1]),
             "epoch_first": e[0], "epoch_last": e[1]}
            for n, h, _ in windows if iters > 0 for e in [epoch_means(h, n)]],
        "bin_overflow": dict(zip(("tile", "span", "active"), pipe._bin_overflow)),
        "windows_route": window_log,
        "megastep": {"captures": graphs.captures, "replays": graphs.replays,
                     "dropped": graphs.dropped, "graph_mb": graphs.memory_bytes / 2 ** 20,
                     "graphs_held_max": graphs.peak_resident,
                     "graphs_held_end": len(graphs.graphs),
                     "graph_nodes": [c["nodes"] for c in graphs.node_counts]},
        "window_nodes_per_step": nodes_per_step,
        "eval_views": len(eval_cams), "eval_s": eval_s,
        "n_blocks": sum(v.n_blocks for v in vols), "gaussians": model.num_gaussians,
        "psnr_mean": float(np.mean(psnrs)), "psnr_min": float(np.min(psnrs)),
        "max_memory_allocated_mb": torch.cuda.max_memory_allocated() / 2 ** 20,
        "peak_visible": dict(engine.peak_visible),
        "visible_capacity": cfg.tpu.visible_block_capacity,
        "raycast_lb": cfg.tpu.raycast_lb,
        "block_capacity": cfg.tpu.block_capacity,
        "launches": launches,
    }
    if track is not None:
        out.update(track.summary(cams))
        out["fusion_ms_per_frame"] = (pipe.t_fusion - track.track_ms
                                      - track.prepare_ms - track.megastep_ms) / N
    if swapped is not None:
        out.update(swapped.summary())
    if shards > 1:
        out.update(space_shards=shards, shard_blocks=[v.n_blocks for v in vols],
                   raycast_poses=raycast_poses[0])
    if args.profile and iters > 0:
        # share of the train + eval wall time during which the card ran
        # device work (an upper bound where device events overlap)
        out["device_busy_share"] = busy_ms / ((train_s + eval_s) * 1e3)
    log(f"[{tag}] " + json.dumps(out))
    if n_windows < 2 or len(windows) != n_windows:
        raise RuntimeError(f"{tag}: ran {len(windows)} of >= 2 optimization windows")
    for k in (kernels.RAYCAST, kernels.SPLAT_FWD):
        if launches[k.name] <= 0:
            raise RuntimeError(f"{tag}: kernel {k.name} was not launched")
    want_route = ("chunked" if tracked is None and swap is None and shards == 1
                  and cfg.tpu.fuse_chunk > 1 else "per frame")
    if out["fusion_route"] != want_route or (
            want_route == "chunked") != (fg.captures + fg.replays == N):
        raise RuntimeError(f"{tag}: fusion took the route {out['fusion_route']} with "
                           f"{out['fusion_graphs']}, not {want_route}")
    idle = kernels.INTEGRATE_F32 if fusion is kernels.INTEGRATE else kernels.INTEGRATE
    if launches[fusion.name] != N * shards or launches[idle.name] != 0:
        raise RuntimeError(f"{tag}: {launches[fusion.name]} {fusion.name} launches for "
                           f"{N} frames x {shards} shards and {launches[idle.name]} of "
                           f"{idle.name}")
    if shards > 1 and launches[kernels.RAYCAST.name] != shards * raycast_poses[0]:
        raise RuntimeError(f"{tag}: {launches[kernels.RAYCAST.name]} K3 launches for "
                           f"{raycast_poses[0]} raycast poses x {shards} shards")
    # in an eager window a step on a camera that sees no Gaussian has no
    # active tile and no splat to differentiate, every other step launches
    # K5 once; in a megastep window every step launches K5 once
    if launches[kernels.SPLAT_BWD.name] != out["adam_steps_with_tiles"]:
        raise RuntimeError(f"{tag}: {launches[kernels.SPLAT_BWD.name]} K5 launches "
                           f"for {out['adam_steps_with_tiles']} Adam steps with "
                           f"active tiles (eager) or in a megastep window")
    # every Adam step launches the step's backward and the optimizer once,
    # its forward at least once (binning, spawn and eval renders add more)
    steps = out["adam_steps"]
    step_launches = [launches[k.name] for k in (kernels.PROJECT_SH_FWD,
                                                kernels.PROJECT_SH_BWD, kernels.WINDOW_ADAM)]
    if not (step_launches[0] >= max(steps, 1) and step_launches[1:] == [steps, steps]):
        raise RuntimeError(f"{tag}: project_sh_fwd/bwd and window_adam launched "
                           f"{step_launches} times for {steps} Adam steps")
    routes = [w["route"] for w in window_log]
    want = (["eager"] * n_windows if not megastep or swap is not None or shards > 1
            else ["eager"] + ["megastep"] * (n_windows - 1))
    if routes != want:
        raise RuntimeError(f"{tag}: windows took the routes {routes}, not {want}")
    if extras is not None:
        extras["pipe"] = pipe
    for _, h, _ in windows:
        if not np.isfinite(h).all():
            raise RuntimeError(f"{tag}: non-finite window loss {h}")
    for w in out["windows_loss"]:
        if not w["epoch_last"] < w["epoch_first"]:
            raise RuntimeError(f"{tag}: window loss did not fall over its epochs: {w}")
    if not (np.isfinite(out["psnr_mean"]) and out["psnr_mean"] > PSNR_FLOOR_DB):
        raise RuntimeError(f"{tag}: eval PSNR {out['psnr_mean']} below floor {PSNR_FLOOR_DB}")
    if model.num_gaussians <= 0:
        raise RuntimeError(f"{tag}: no Gaussians were spawned")
    for k, cap in (("fusion", cfg.tpu.visible_block_capacity),
                   ("raycast", cfg.tpu.visible_block_capacity)):
        if track is not None and out["peak_visible"][k] > cap:
            raise RuntimeError(f"{tag}: {out['peak_visible'][k]} visible blocks "
                               f"({k}) above the cap {cap}")
    if swapped is None and any(v.n_blocks >= v.params.block_capacity for v in vols):
        raise RuntimeError(f"{tag}: a block pool is full ({out['n_blocks']})")
    if track is not None:
        track.check(tag, out)
    if swapped is not None:
        swapped.check(tag, out)
    return out, engine, model


class TrackedStats:
    """Times a tracked run's frames and counts their tracking-prepare K3
    launches.  On both routes it times each `engine.process_frame` call
    whole (ICP, revert, fusion, the next prepare raycast: the same scope
    on both routes); on the eager route it also wraps the tracker and the
    engine's single-view raycast (in this path only the tracking-prepare
    raycast) to time them apart from fusion; on the megastep route it
    wraps the engine's megastep frame (track, revert, fuse, prepare
    raycast and the one read) and the run of its graph (the copy of the
    inputs and the replay, synchronised).  Keeps the arguments of the last prepare
    `march` call as `rec.last["tracking prepare"]` (on the megastep route
    those of the call recorded at the graph's capture, whose tensors hold
    the last replay's values).  With a composite tracker (colour refine,
    then ICP: eager) it also times the colour stage apart and keeps its
    labels, inlier shares, residuals and iterations per level; `iters`
    are the ICP stage's."""

    def __init__(self, engine, tracker, rec):
        from gps_slam_torch import kernels
        from gps_slam_torch.slam.tracker import ColorTracker

        self.track_ms = self.prepare_ms = self.megastep_ms = 0.0
        self.prepare_k3 = 0
        self.quality, self.iters, self.frame_ms = [], [], []
        self.graph_ms = {"capture": [], "replay": []}
        stages = getattr(tracker, "trackers", [tracker])
        self.icp = stages[-1]
        self.color = next((t for t in stages if isinstance(t, ColorTracker)), None)
        self.color_log = {"ms": [], "quality": [], "inlier": [], "residual": [], "iters": []}
        if self.color is not None:
            color_track = self.color.track

            def timed_color(*a, **kw):
                torch.cuda.synchronize()
                t = time.monotonic()
                pose, q = color_track(*a, **kw)
                torch.cuda.synchronize()
                log_ = self.color_log
                log_["ms"].append((time.monotonic() - t) * 1e3)
                log_["quality"].append(q)
                log_["inlier"].append(self.color.last_inlier)
                log_["residual"].append(self.color.last_residual)
                log_["iters"].append(list(self.color.last_iters))
                return pose, q

            self.color.track = timed_color
        track, run_raycast = tracker.track, engine.run_raycast
        process = engine.process_frame
        fast = engine._process_frame_fast_tracked
        graphs = engine._track_graphs
        graph_run = graphs.run

        def timed_frame(*a, **kw):
            torch.cuda.synchronize()
            t = time.monotonic()
            pose = process(*a, **kw)
            torch.cuda.synchronize()
            self.frame_ms.append((time.monotonic() - t) * 1e3)
            return pose

        def timed_track(*a, **kw):
            torch.cuda.synchronize()
            t = time.monotonic()
            pose, q = track(*a, **kw)
            torch.cuda.synchronize()
            self.track_ms += (time.monotonic() - t) * 1e3
            self.quality.append(q)
            self.iters.append(list(self.icp.last_iters))
            return pose, q

        def timed_prepare(*a, **kw):
            torch.cuda.synchronize()
            t, n0 = time.monotonic(), kernels.RAYCAST.launches
            maps = run_raycast(*a, **kw)
            torch.cuda.synchronize()
            self.prepare_ms += (time.monotonic() - t) * 1e3
            self.prepare_k3 += kernels.RAYCAST.launches - n0
            rec.last["tracking prepare"] = rec.last["march"]
            return maps

        def timed_fast(*a, **kw):
            torch.cuda.synchronize()
            n0 = kernels.RAYCAST.launches + graphs.replayed_launches[kernels.RAYCAST.name]
            t = time.monotonic()
            pose = fast(*a, **kw)   # ends in the read of the frame's results
            self.megastep_ms += (time.monotonic() - t) * 1e3
            self.prepare_k3 += (kernels.RAYCAST.launches
                                + graphs.replayed_launches[kernels.RAYCAST.name] - n0)
            self.quality.append(engine._tracking_quality)
            self.iters.append(list(self.icp.last_iters))
            if graphs.last[1] == "capture":
                rec.last["tracking prepare"] = rec.last["march"]
            return pose

        def timed_graph(*a, **kw):
            torch.cuda.synchronize()
            t = time.monotonic()
            out = graph_run(*a, **kw)
            torch.cuda.synchronize()
            self.graph_ms[graphs.last[1]].append((time.monotonic() - t) * 1e3)
            return out

        tracker.track = timed_track
        engine.attach_tracker(tracker)
        engine.process_frame = timed_frame
        engine.run_raycast = timed_prepare
        engine._process_frame_fast_tracked = timed_fast
        graphs.run = timed_graph
        self.engine, self.graphs = engine, graphs

    def summary(self, cams) -> dict:
        from gps_slam_torch.eval import metrics as M
        from gps_slam_torch.slam.tracker import TrackerQuality

        est, gt = self.engine.cam_poses, [c.c2w for c in cams]
        R = est[-1][:3, :3].T @ gt[-1][:3, :3]
        n = len(self.quality)
        g = self.graphs
        mega = g.captures + g.replays > 0
        labels = lambda qs: {name: sum(q == v for q in qs) for name, v in (  # noqa: E731
            ("GOOD", TrackerQuality.GOOD), ("POOR", TrackerQuality.POOR),
            ("FAILED", TrackerQuality.FAILED))}
        cl = self.color_log
        color = None if self.color is None else {
            # the colour stage of each tracked frame (its pyramid, Sobel
            # and Gauss-Newton levels, one read a level and the final one)
            "ms_per_frame": spread_ms(cl["ms"]),
            "ms_total": float(np.sum(cl["ms"])),
            "iters_per_frame": cl["iters"],
            "iters_mean_per_level": [float(v) for v in np.mean(cl["iters"], 0)],
            "iters_total": int(np.sum(cl["iters"])),
            "iters_budget_per_level": list(self.color.level_iters),
            "quality": labels(cl["quality"]),
            "inlier": cl["inlier"], "residual": cl["residual"]}
        return {
            "tracked_frames": n,
            "tracking_route": "megastep" if mega else "eager",
            # the ICP alone: eager route only (inside the graph it is not
            # timed apart from the frame's fusion and prepare raycast)
            "tracking_ms_per_frame": None if mega else self.track_ms / max(n, 1),
            # engine.process_frame of each tracked frame, on either route:
            # ICP, revert, fusion, the next prepare raycast (megastep: the
            # first holds the graph's capture)
            "tracked_frame_ms": spread_ms(self.frame_ms[1:]),
            "megastep_graphs": {"captures": g.captures, "replays": g.replays,
                                "dropped": g.dropped, "graph_mb": g.memory_bytes / 2 ** 20,
                                "nodes": g.node_counts,
                                "capture_ms": self.graph_ms["capture"],
                                "replay_ms_mean": float(np.mean(self.graph_ms["replay"]))
                                if self.graph_ms["replay"] else None},
            "tracking_prepare_raycast_ms_total": self.prepare_ms,
            "tracking_prepare_k3_launches": self.prepare_k3,
            "gn_iters_mean_per_level": [float(v) for v in np.mean(self.iters, 0)],
            # the Gauss-Newton iterations the card ran, all levels and frames
            "gn_iters_total": int(np.sum(self.iters)),
            "gn_iters_budget_per_level": list(self.icp.level_iters),
            "quality": labels(self.quality),
            "color_stage": color,
            "ate_cm": M.ate_rmse_cm(est, gt),
            "last_translation_err_cm": float(np.linalg.norm(est[-1][:3, 3] - gt[-1][:3, 3]) * 100),
            "last_rotation_err_deg": float(np.degrees(np.arccos(np.clip(
                (np.trace(R) - 1) / 2, -1, 1)))),
        }

    def check(self, tag: str, out: dict) -> None:
        vox_cm = self.engine.params.voxel_size * 100
        n = out["frames"]
        g = out["megastep_graphs"]
        if g["captures"] + g["replays"] not in (0, n - 1):
            raise RuntimeError(f"{tag}: {g} megastep frames for {n - 1} tracked frames")
        if out["tracking_prepare_k3_launches"] != n:
            raise RuntimeError(f"{tag}: {out['tracking_prepare_k3_launches']} tracking-"
                               f"prepare K3 launches for {n} frames")
        if not out["ate_cm"] < ATE_MAX_VOXELS * vox_cm:
            raise RuntimeError(f"{tag}: ATE {out['ate_cm']} cm above {ATE_MAX_VOXELS} voxels")
        if not (out["last_translation_err_cm"] < LAST_MAX_M * 100
                and out["last_rotation_err_deg"] < LAST_MAX_DEG):
            raise RuntimeError(f"{tag}: last pose off by {out['last_translation_err_cm']} cm, "
                               f"{out['last_rotation_err_deg']} deg")
        if not out["quality"]["GOOD"] >= GOOD_MIN_SHARE * out["tracked_frames"]:
            raise RuntimeError(f"{tag}: GOOD on {out['quality']} of "
                               f"{out['tracked_frames']} tracked frames")


class SwapStats:
    """Instruments a swapping engine: the pool's allocated count right
    after each fusion (a drop for want of a row leaves it at capacity),
    the raycast poses and their K3 launches, and the time of the swap
    work (each call synchronised), by kind: the checks after fusion
    (`maybe_reload` + `maybe_spill`), the spills before fusion after a
    filling swap-in, and the raycasts' swap-ins (`reload_visible`)."""

    def __init__(self, engine):
        from gps_slam_torch import kernels
        from gps_slam_torch.tsdf import integrate as tint

        self.engine, self.tint = engine, tint
        self.fused_blocks = []
        self.raycasts = self.raycast_k3 = 0
        self.ms = {"reload": 0.0, "spill": 0.0, "reload_visible": 0.0}
        self.calls = {k: 0 for k in self.ms}
        self.spills_done = 0
        swap, fuse, run_raycast = engine.swap, tint.fuse_frame, engine.run_raycast
        self._fuse = fuse

        def timed(kind, fn):
            def call(vol, *a, **kw):
                torch.cuda.synchronize()
                t, n0 = time.monotonic(), swap.n_spilled_total
                out = fn(vol, *a, **kw)
                torch.cuda.synchronize()
                self.ms[kind] += (time.monotonic() - t) * 1e3
                self.calls[kind] += 1
                self.spills_done += swap.n_spilled_total > n0
                return out
            return call

        def fused(vol, *a, **kw):
            out = fuse(vol, *a, **kw)
            self.fused_blocks.append(vol.n_blocks)
            return out

        def raycast(*a, **kw):
            n0 = kernels.RAYCAST.launches
            maps = run_raycast(*a, **kw)
            self.raycasts += 1
            self.raycast_k3 += kernels.RAYCAST.launches - n0
            return maps

        swap.maybe_reload = timed("reload", swap.maybe_reload)
        swap.maybe_spill = timed("spill", swap.maybe_spill)
        swap.reload_visible = timed("reload_visible", swap.reload_visible)
        tint.fuse_frame = fused
        engine.run_raycast = raycast

    def detach(self) -> None:
        self.tint.fuse_frame = self._fuse

    def summary(self) -> dict:
        e = self.engine
        n = len(self.fused_blocks)
        checks = sum(1 for i in range(n) if i % e.swap_check_interval == 0)
        # maybe_spill also runs before a fusion that follows a filling
        # swap-in; those calls are the ones beyond one per check
        return {
            "n_spilled_total": e.swap.n_spilled_total,
            "n_reloaded_total": e.swap.n_reloaded_total,
            "stored_blocks_end": len(e.swap.store), "checks": checks,
            "spill_episodes": self.spills_done,
            "spills_before_fusion": self.calls["spill"] - checks,
            "swap_ms_per_check": (self.ms["reload"] + self.ms["spill"]) / max(checks, 1),
            "swap_ms_total": self.ms["reload"] + self.ms["spill"],
            "reload_visible_ms_total": self.ms["reload_visible"],
            "reload_visible_calls": self.calls["reload_visible"],
            "peak_blocks_after_fusion": max(self.fused_blocks),
            "blocks_after_fusion": self.fused_blocks,
            "raycast_poses": self.raycasts, "raycast_k3_launches": self.raycast_k3,
        }

    def check(self, tag: str, out: dict) -> None:
        from gps_slam_torch import kernels

        B = self.engine.params.block_capacity
        if not (out["n_spilled_total"] > 0 and out["n_reloaded_total"] > 0):
            raise RuntimeError(f"{tag}: spilled {out['n_spilled_total']}, reloaded "
                               f"{out['n_reloaded_total']}: the pool never swapped")
        if not out["peak_blocks_after_fusion"] < B:
            raise RuntimeError(f"{tag}: fusion filled the pool ({out['peak_blocks_after_fusion']} "
                               f"of {B}): allocations were dropped")
        if len(self.fused_blocks) != out["frames"]:
            raise RuntimeError(f"{tag}: {len(self.fused_blocks)} fusions for {out['frames']} frames")
        k3 = out["launches"][kernels.RAYCAST.name]
        if not (k3 == out["raycast_poses"] == out["raycast_k3_launches"]):
            raise RuntimeError(f"{tag}: {k3} K3 launches for {out['raycast_poses']} raycast poses")


def synthetic_cams(n: int, width: int, height: int, look: str = "out",
                   arc: float = 0.75):
    from gps_slam_torch.data import synthetic

    t0 = time.monotonic()
    cams = synthetic.make_cameras(n_frames=n, width=width, height=height, look=look,
                                  arc=arc)
    log(f"[data] {n} synthetic frames {width}x{height} (look {look}) in "
        f"{time.monotonic() - t0:.1f} s")
    return cams


def main_path(args, rec) -> tuple:
    """The forward-only path (no Adam steps), then the main path with
    ADAM_STEPS per window over the same frames, at 1200x680 (K1's route),
    fusion in `_fusion_groups` groups; the main path's eval PSNR must be
    at least the forward-only one's.  Then `[chunk witness]`: the main
    path once more with TPU.fuse_chunk 1 (every frame fused on its own,
    counts read every frame): the volumes (hash table, block keys, state,
    colour, summary and last-seen rows), the poses and the eval PSNR bit
    for bit.  Returns the main path's numbers, engine, model and cameras,
    its `AllocFrames` (taken on the witness, whose pool rows are the main
    path's) and the last kernel calls of the chunked run."""
    from gps_slam_torch import kernels

    cams = synthetic_cams(N_FRAMES, 1200, 680)
    fwd, _, _ = run_path(args, cams, 0, "forward-only path", kernels.INTEGRATE)
    out, engine, model = run_path(args, cams, ADAM_STEPS, "main path", kernels.INTEGRATE)
    last = dict(rec.last)
    if out["adam_steps"] != ADAM_STEPS * out["windows"]:
        raise RuntimeError(f"main path ran {out['adam_steps']} Adam steps")
    if not out["psnr_mean"] >= fwd["psnr_mean"]:
        raise RuntimeError(f"trained eval PSNR {out['psnr_mean']} below the "
                           f"forward-only {fwd['psnr_mean']}")
    out["forward_only_psnr_mean"] = fwd["psnr_mean"]
    alloc = AllocFrames()
    try:
        wit, w_engine, _ = run_path(args, cams, ADAM_STEPS, "main path, per-frame fusion",
                                    kernels.INTEGRATE, tpu={"fuse_chunk": 1})
    finally:
        alloc.detach()
    alloc.marks[id(engine.vol)] = alloc.marks.pop(id(w_engine.vol))
    fields = ("table_keys", "table_ptrs", "block_coords", "state", "color", "summary",
              "last_seen")
    res = {"fusion_ms_per_frame": {"chunked": out["fusion_ms_per_frame"],
                                   "per_frame": wit["fusion_ms_per_frame"]},
           "fusion_graphs": out["fusion_graphs"],
           "n_blocks": [engine.vol.n_blocks, w_engine.vol.n_blocks],
           "not_equal": [k for k in fields
                         if not torch.equal(getattr(engine.vol, k), getattr(w_engine.vol, k))],
           "poses_equal": bool(np.array_equal(np.stack(engine.cam_poses),
                                              np.stack(w_engine.cam_poses))),
           "psnr_mean": [out["psnr_mean"], wit["psnr_mean"]]}
    log("[chunk witness] " + json.dumps(res))
    if (res["not_equal"] or not res["poses_equal"] or res["n_blocks"][0] != res["n_blocks"][1]
            or res["psnr_mean"][0] != res["psnr_mean"][1]):
        raise RuntimeError(f"chunk witness: chunked fusion differs from per-frame: {res}")
    out["chunk_witness"] = res
    return out, engine, model, cams, alloc, last


def _pool_rows_apart(a: dict, b: dict, mcfg) -> dict:
    """Largest row difference of two pools (host tensors by attribute) over
    the live rows of `a`, per attribute in units of its learning rate."""
    n = int(a["alive"].sum())
    lrs = {"means": mcfg.means_lr, "scales": mcfg.scales_lr, "quats": mcfg.quats_lr,
           "features_dc": mcfg.featuresDc_lr, "features_rest": mcfg.featuresRest_lr,
           "opacities": mcfg.opacities_lr}
    return {k: float((a[k][:n] - b[k][:n]).abs().max() / lr) for k, lr in lrs.items()}


def megastep_path(args) -> dict:
    """`[megastep path]`: MEGASTEP_FRAMES frames of the outward arc at the
    main path's motion per frame, 1200x680, bench.py's configuration, 20
    Adam steps a window: 1 bootstrap window and 9 more.  The frames run
    twice, first with every window eager (`disable_megastep`, the witness),
    then with the megastep (a CUDA graph per static key, replayed while
    the key holds).  Gates: after the second window (the first megastep
    window) the pools have equal alive masks and every live row within
    0.01 x its attribute's learning rate; at the end Gaussian counts within
    0.5% and eval PSNRs within 0.05 dB; one camera's renders from the two
    runs more than 45 dB apart; at least one window replays.  Then
    `[megastep reference]`: two more windows of the megastep run's state,
    each through a fresh `WindowGraphs` (a capture, then a replay) and
    uncaptured on a copy of the pool, bit for bit."""
    from gps_slam_torch import kernels
    from gps_slam_torch.eval import metrics as M

    cams = synthetic_cams(MEGASTEP_FRAMES, 1200, 680, arc=MEGASTEP_ARC)
    runs = {}
    for name, mega in (("eager", False), ("megastep", True)):
        extras = {}
        tag = "megastep path" + ("" if mega else ", eager witness")
        out, engine, model = run_path(args, cams, ADAM_STEPS, tag, kernels.INTEGRATE,
                                      megastep=mega, extras=extras)
        runs[name] = (out, engine, model, extras)
    (eo, ee, em, ex), (mo, me, mm, mx) = runs["eager"], runs["megastep"]
    cam = cams[MEGASTEP_FRAMES // 2]
    imgs = []
    for eng, model in ((ee, em), (me, mm)):
        ray = eng.run_raycast(cam.c2w, cam.K, cam.width, cam.height)
        with torch.no_grad():
            res = model.forward(cam.c2w, cam.K, ray["depth_map"][..., 0], ray["color_map"])
        imgs.append(torch.clamp(res["rgb"], 0, 1).cpu().numpy())
    a, b = ex["pool_after_window_2"], mx["pool_after_window_2"]
    apart = _pool_rows_apart(a, b, mm.cfg.model)
    bitwise = all(torch.equal(a[k], b[k]) for k in a)
    render_db = M.psnr(imgs[1], imgs[0])
    per_window = [{"frame": w["frame"], "route": w["route"], "graph": w.get("graph"),
                   "key": w.get("key"), "ms": w["ms"], "eager_ms": e["ms"]}
                  for w, e in zip(mo["windows_route"], eo["windows_route"])]
    res = {
        "frames": MEGASTEP_FRAMES, "width": 1200, "height": 680, "arc": MEGASTEP_ARC,
        "windows": per_window,
        "train_s": mo["train_s"], "fps": mo["fps"],
        "eager_train_s": eo["train_s"], "eager_fps": eo["fps"],
        "window_ms_total": sum(w["ms"] for w in per_window),
        "eager_window_ms_total": sum(w["eager_ms"] for w in per_window),
        "replay_ms_mean": float(np.mean([w["ms"] for w in per_window
                                         if w["graph"] == "replay"] or [np.nan])),
        "capture_ms_mean": float(np.mean([w["ms"] for w in per_window
                                          if w["graph"] == "capture"] or [np.nan])),
        **{k: mo["megastep"][k] for k in ("captures", "replays", "dropped", "graph_mb",
                                          "graphs_held_max", "graphs_held_end")},
        "window_nodes_per_step": mo["window_nodes_per_step"],
        "graph_nodes": mo["megastep"]["graph_nodes"],
        "max_memory_allocated_mb": mo["max_memory_allocated_mb"],
        "eager_max_memory_allocated_mb": eo["max_memory_allocated_mb"],
        "psnr_mean": mo["psnr_mean"], "eager_psnr_mean": eo["psnr_mean"],
        "gaussians": mo["gaussians"], "eager_gaussians": eo["gaussians"],
        "window_2_alive_equal": bool(torch.equal(a["alive"], b["alive"])),
        "window_2_rows_apart_lr": apart, "window_2_bit_for_bit": bitwise,
        "render_psnr_db": render_db, "render_camera": MEGASTEP_FRAMES // 2,
        "launches": mo["launches"],
    }
    log("[megastep path] " + json.dumps(res))
    if not res["window_2_alive_equal"] or max(apart.values()) > 0.01:
        raise RuntimeError(f"megastep path: the first megastep window's pool is off "
                           f"the eager one's: {apart}")
    if abs(mo["gaussians"] - eo["gaussians"]) > MEGASTEP_COUNT_GAP * eo["gaussians"]:
        raise RuntimeError(f"megastep path: {mo['gaussians']} Gaussians against "
                           f"{eo['gaussians']} eager")
    if not abs(mo["psnr_mean"] - eo["psnr_mean"]) <= MEGASTEP_PSNR_GAP_DB:
        raise RuntimeError(f"megastep path: PSNR {mo['psnr_mean']} against "
                           f"{eo['psnr_mean']} eager")
    if not render_db > MEGASTEP_RENDER_DB:
        raise RuntimeError(f"megastep path: renders {render_db} dB apart")
    if mo["megastep"]["replays"] < 1:
        raise RuntimeError("megastep path: no window replayed a graph")
    if mo["megastep"]["graphs_held_max"] > mx["pipe"]._window_graphs.max_graphs:
        raise RuntimeError(f"megastep path: {mo['megastep']['graphs_held_max']} graphs "
                           f"held at once")
    megastep_reference(mx["pipe"], mm)
    return res


def megastep_reference(pipe, model) -> None:
    """`[megastep reference]`: two windows drawn from the state at the end
    of the megastep path (`SLAMPipeline._megastep_window`: another keyframe
    sample, camera sequence and spawn draw each), through a fresh
    `WindowGraphs` on one copy of the pool (a capture, then a replay of the
    same graph) and through `window_megastep` uncaptured on another:
    outputs and pools bit for bit."""
    import dataclasses

    from gps_slam_torch.gs import params as pmod
    from gps_slam_torch.slam import megastep as ms

    def copy_pool():
        return dataclasses.replace(model.pool, **{
            k: getattr(model.pool, k).clone() for k in (*pmod.PARAM_KEYS, "alive")})

    eng = pipe.engine
    ref, pool = copy_pool(), copy_pool()
    graphs = ms.WindowGraphs()
    rows = []
    for _ in range(2):
        key, inputs, statics = pipe._megastep_window(model)
        st = dict(statics)
        K = st.pop("K")
        t0 = time.monotonic()
        want = ms.window_megastep(eng.vol, ref, inputs["poses"], K,
                                  torch.stack(inputs["gt_rgb"]), inputs["iter_cam_idx"],
                                  inputs["spawn_noise"], **st)
        torch.cuda.synchronize()
        t1 = time.monotonic()
        got = graphs.run(key, eng.vol, pool, inputs, **statics)
        torch.cuda.synchronize()
        t2 = time.monotonic()
        diff = [k for k in want if not torch.equal(got[k], want[k])]
        diff += [k for k in (*pmod.ROW_KEYS, "alive")
                 if not torch.equal(getattr(pool, k), getattr(ref, k))]
        rows.append({"graph": graphs.last[1], "uncaptured_ms": (t1 - t0) * 1e3,
                     "graph_ms": (t2 - t1) * 1e3, "n_alive": int(got["n_alive"]),
                     "not_equal": diff})
    log("[megastep reference] " + json.dumps(
        {"windows": rows, "captures": graphs.captures, "replays": graphs.replays,
         "graph_mb": graphs.memory_bytes / 2 ** 20}))
    if [r["graph"] for r in rows] != ["capture", "replay"] or any(r["not_equal"] for r in rows):
        raise RuntimeError(f"megastep reference: {rows}")


def large_frame_paths(args, rec) -> tuple[list, tuple]:
    """The frames above the JAX kernels' packed budget, on K2
    (`integrate_f32_cuda`): 1296x968 forward only (the K2a route), then
    1920x1080 with ADAM_STEPS per window (the K2b route), then the same
    1920x1080 frames on K1's route as a witness of the f32 route's PSNR.
    Returns, per K2 route, K2's row label, the TPU kernel it stands in
    for, the arguments of the path's last `integrate_blocks` call and its
    launch count; and K3's (tag, last `march` call, launches) on the
    1920x1080 path, its largest device consumer."""
    from gps_slam_torch import kernels
    from gps_slam_torch.tsdf import integrate as tint

    out = []
    for n, w, h, iters, tag, route, tpu, body in (
            (RESIDENT_FRAMES, 1296, 968, 0, "resident-route path", "resident",
             "K2a", "gps_slam_tpu/tsdf/integrate_pallas.py:160"),
            (N_FRAMES, 1920, 1080, ADAM_STEPS, "large-frame path", "pregather",
             "K2b", "gps_slam_tpu/tsdf/integrate_pallas.py:112")):
        if tint.integrate_route(w, h) != route:
            raise RuntimeError(f"{w}x{h} takes route {tint.integrate_route(w, h)}")
        cams = synthetic_cams(n, w, h)
        r, _, _ = run_path(args, cams, iters, tag, kernels.INTEGRATE_F32)
        if r["adam_steps"] != iters * r["windows"]:
            raise RuntimeError(f"{tag} ran {r['adam_steps']} Adam steps")
        out.append((tpu, body, rec.last["integrate_blocks"][0],
                    r["launches"][kernels.INTEGRATE_F32.name]))
    k3 = (f"{w}x{h}", rec.last["march"], r["launches"][kernels.RAYCAST.name])

    saved = tint._RESIDENT_BYTES
    tint._RESIDENT_BYTES = 2 ** 25
    try:
        if tint.integrate_route(w, h) != "packed":
            raise RuntimeError("the raised budget did not select K1's route")
        k1, _, _ = run_path(args, cams, ADAM_STEPS, "large-frame path, K1 route",
                            kernels.INTEGRATE)
    finally:
        tint._RESIDENT_BYTES = saved
    gap = r["psnr_mean"] - k1["psnr_mean"]
    log("[route witness] " + json.dumps({
        "width": w, "height": h, "psnr_f32_route": r["psnr_mean"],
        "psnr_k1_route": k1["psnr_mean"], "gap_db": gap}))
    if not abs(gap) <= ROUTE_PSNR_GAP_DB:
        raise RuntimeError(f"{w}x{h}: the f32 route's PSNR is {gap} dB off K1's")
    return out, k3


def k1_row(tag: str | None, call: tuple, launches: int) -> dict:
    """K1 (`integrate_cuda`) against `integrate_blocks_packed_plain` on the
    arguments of one `integrate_blocks_packed` call (`call`: args, kwargs),
    each on its own copy of the pools; `tag` names the path when it is not
    the main path."""
    from gps_slam_torch import kernels
    from gps_slam_torch.tsdf import integrate as tint
    from gps_slam_torch.tsdf.volume import BLOCK_VOL

    (a, _) = call
    depth, rgbp, keys, ptrs, state, color, summary = a[:7]
    rest = a[7:]
    pools = {}
    for name, fn in (("cuda", tint.integrate_blocks_packed),
                     ("plain", tint.integrate_blocks_packed_plain)):
        st, co, su = state.clone(), color.clone(), summary.clone()
        fn(depth, rgbp, keys, ptrs, st, co, su, *rest)
        torch.cuda.synchronize()
        pools[name] = (st, co, su)
    sk, ck, uk = pools["cuda"]
    sp, cp, up = pools["plain"]
    sel = ptrs[ptrs >= 0].long()
    touched = torch.zeros(state.shape[0], dtype=torch.bool, device=state.device)
    touched[sel] = True
    # whole pools: rows outside the integration set come back untouched by
    # both versions; inside it a value on a rounding tie may move one step
    untouched_equal = all(torch.equal(x[~touched], ref[~touched]) for x, ref in (
        (sk, state), (sp, state), (ck, color), (cp, color), (uk, summary), (up, summary)))
    sdf_err = (sdf_of(sk) - sdf_of(sp)).abs().max().item()
    weights_equal = torch.equal(sk >> 16, sp >> 16)
    col_err = max((((ck >> s) & 0xFF) - ((cp >> s) & 0xFF)).abs().max().item()
                  for s in (0, 8, 16))
    word_match = (sk[sel] == sp[sel]).float().mean().item()
    col_match = (ck[sel] == cp[sel]).float().mean().item()
    sum_err = (uk - up).abs().max().item()
    ok = (untouched_equal and weights_equal and sdf_err <= 1 and col_err <= 1
          and torch.equal(ck >> 24, cp >> 24) and word_match >= 0.999
          and col_match >= 0.999 and sum_err <= 1e-6)
    st, co, su = state.clone(), color.clone(), summary.clone()
    ms = time_ms(lambda: tint.integrate_blocks_packed(depth, rgbp, keys, ptrs, st, co, su, *rest), 50)
    st, co, su = state.clone(), color.clone(), summary.clone()
    plain_ms = time_ms(lambda: tint.integrate_blocks_packed_plain(depth, rgbp, keys, ptrs, st, co, su, *rest), 5, 1)
    # the same launch on the rows to integrate alone: the padded rows'
    # cost is the difference, and the pools the same bits
    live = torch.nonzero(ptrs >= 0)[:, 0]
    keys_l, ptrs_l = keys[live].contiguous(), ptrs[live].contiguous()
    st, co, su = state.clone(), color.clone(), summary.clone()
    tint.integrate_blocks_packed(depth, rgbp, keys_l, ptrs_l, st, co, su, *rest)
    ok = ok and all(torch.equal(x, y) for x, y in ((st, sk), (co, ck), (su, uk)))
    st, co, su = state.clone(), color.clone(), summary.clone()
    ms_live = time_ms(lambda: tint.integrate_blocks_packed(depth, rgbp, keys_l, ptrs_l, st, co, su, *rest), 50)
    V, Vv = keys.shape[0], sel.shape[0]
    # the tapped pixels' depth and rgb words, the integrated rows' keys and
    # pool rows, state and colour read and written, and summary rows (a
    # padded row, pool row -1, is not work the function needs)
    w2c, fx, fy, cx, cy, vs = rest[:6]
    n_px = tap_pixels(keys[ptrs >= 0], w2c, fx, fy, cx, cy, depth.shape[1],
                      depth.shape[0], vs)
    n_bytes = (n_px * 8 + Vv * 8
               + Vv * BLOCK_VOL * 4 * 4 + Vv * 128 * 4)
    n_ops = Vv * BLOCK_VOL * 110
    b, by = bound_ms(n_bytes, n_ops)
    return {"name": "integrate_cuda" + (f" ({tag})" if tag else ""), "tpu": "K1",
            "design": kernels.INTEGRATE.design, "route": "cuda",
            "source": "gps_slam_torch/csrc/integrate.cu",
            "replaces": "gps_slam_tpu/tsdf/integrate_pallas.py:239",
            "launches": launches,
            "max_abs_err": float(max(sdf_err / 32767.0, col_err / 255.0, sum_err)),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
            "library_ms": None, "ok": ok,
            "bytes": n_bytes, "ops": n_ops, "ms_live_rows": ms_live,
            "shapes": {"V": V, "valid_rows": Vv, "image": list(depth.shape),
                       "pool_rows": state.shape[0], "tap_pixels": n_px},
            "tolerance": "whole pools: rows outside the integration set "
                         "unchanged; weights equal, sdf within 1 quantum, "
                         "colour channels within 1, >= 99.9% of the "
                         "integrated rows' state and colour words equal; "
                         "summary within 1e-6; the launch on the integrated "
                         "rows alone gives the same bits",
            "word_match": word_match, "color_match": col_match}


def k2_row(tag: str, replaces: str, args: tuple, launches: int) -> dict:
    """K2 (`integrate_f32_cuda`) against `integrate_blocks_plain` on the
    arguments of one `integrate_blocks` call; the output of rows with
    valid False is unwritten by the kernel and not compared."""
    from gps_slam_torch import kernels
    from gps_slam_torch.tsdf import integrate as tint
    from gps_slam_torch.tsdf.volume import BLOCK_VOL

    depth, rgbp, keys, valid = args[:4]
    ok_out = tint.integrate_blocks(*args)
    pl_out = tint.integrate_blocks_plain(*args)
    torch.cuda.synchronize()
    (fk, wk, ck, wck), (fp, wp, cp, wcp) = ([x[valid] for x in o] for o in (ok_out, pl_out))
    f_err = (fk - fp).abs().max().item()
    c_err = (ck - cp).abs().max().item()
    bitwise_equal = all(torch.equal(x.view(torch.int32), y.view(torch.int32))
                        for x, y in ((fk, fp), (wk, wp), (ck, cp), (wck, wcp)))
    ms = time_ms(lambda: tint.integrate_blocks(*args), 50)
    plain_ms = time_ms(lambda: tint.integrate_blocks_plain(*args), 5, 1)
    # the same launch on the valid rows alone (the padded rows' cost is the
    # difference), with the same bits on those rows
    live = torch.nonzero(valid)[:, 0]
    args_l = (depth, rgbp, keys[live].contiguous(), valid[live].contiguous(),
              *(x[live].contiguous() for x in args[4:8]), *args[8:])
    live_out = tint.integrate_blocks(*args_l)
    bitwise_equal = bitwise_equal and all(
        torch.equal(x.view(torch.int32), y.view(torch.int32))
        for x, y in zip(live_out, (fk, wk, ck, wck)))
    ms_live = time_ms(lambda: tint.integrate_blocks(*args_l), 50)
    V, Vv = keys.shape[0], int(valid.sum().item())
    w2c, fx, fy, cx, cy, W, H, vs = args[8:16]
    n_px = tap_pixels(keys[valid], w2c, fx, fy, cx, cy, W, H, vs)
    # live rows only: the depth and rgb words of the pixels their voxels
    # tap, each row's key and valid flag, four [512] input planes and six
    # f32 output planes (sdf, weight, r, g, b, colour weight)
    n_bytes = (n_px * 8 + Vv * 5
               + Vv * BLOCK_VOL * 4 * 4 + Vv * BLOCK_VOL * 4 * 6)
    n_ops = Vv * BLOCK_VOL * 110
    b, by = bound_ms(n_bytes, n_ops)
    return {"name": f"integrate_f32_cuda ({tag})", "tpu": tag,
            "design": kernels.INTEGRATE_F32.design, "route": "cuda",
            "source": "gps_slam_torch/csrc/integrate_f32.cu", "replaces": replaces,
            "launches": launches, "max_abs_err": float(max(f_err, c_err)),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
            "library_ms": None, "ok": bitwise_equal, "bytes": n_bytes, "ops": n_ops,
            "ms_live_rows": ms_live,
            "shapes": {"V": V, "valid_rows": Vv, "image": list(depth.shape),
                       "tap_pixels": n_px},
            "tolerance": "valid rows: bit for bit; the launch on the valid "
                         "rows alone gives the same bits",
            "sdf_err": f_err, "color_err": c_err, "bitwise_equal": bitwise_equal}


def k3_row(tag: str | None, call: tuple, launches: int, extra: dict | None = None,
           exact: bool = False) -> dict:
    """K3 (`raycast_cuda`) against `march_plain` on the arguments of one
    `march` call (`call`: args, kwargs), in the call's mode (the tracking
    mode against the plain version with raycast_tiles.TRACK); `tag` names
    the path when it is not the main path; `extra` is added to the row.
    With `exact` the hit pixels' words must equal the plain version's bit
    for bit."""
    from gps_slam_torch import kernels
    from gps_slam_torch.tsdf import raycast_tiles as trc

    a, kw = call
    gids, state, color, summary, bc, cam, tw, s_c, s_r, k_b = a[:10]
    need_color = a[10] if len(a) > 10 else kw.get("need_color", True)
    track = bool(a[11] if len(a) > 11 else kw.get("track", False))
    margs = (gids, state, color, summary, bc, cam, tw, s_c, s_r, k_b, need_color)
    ok_out = trc.march(*margs, track=track)
    pl_out = plain_march(*margs, track=track)
    torch.cuda.synchronize()
    hk, hp = ok_out[:, 5] > 0, pl_out[:, 5] > 0
    hit_flips = int((hk != hp).sum().item())
    px_err = (ok_out[:, :5] - pl_out[:, :5]).abs().amax(1)[hk & hp]
    max_err = px_err.max().item() if px_err.numel() else 0.0
    ok3 = hit_flips == 0 and (max_err == 0.0 if exact else max_err < 1e-4)
    ms = time_ms(lambda: trc.march(*margs, track=track), 20)
    plain_ms = time_ms(lambda: plain_march(*margs, track=track), 2, 1)
    T, LB = gids.shape
    valid = gids[gids >= 0]
    n_rows = torch.unique(valid).numel()
    n_slots = valid.numel()
    work = march_work(margs, track)
    rays, px_per_ray = work["rays"], 256 // work["rays"]
    stages = 2 if track else 1
    n_hit = int(hp.sum().item())
    # colour words: the hit pixels' 8 corner words, at most each picked
    # block's whole row
    col_words = min(work["picked_rows"] * 512, n_hit * 8) if need_color else 0
    # the lists, each listed block's mip row, max weight and coordinate
    # key, the picked blocks' state rows, the colour words, the output
    n_bytes = (gids.numel() * 4 + n_rows * (64 + 1 + 1) * 4
               + work["picked_rows"] * 512 * 4 + col_words * 4 + ok_out.numel() * 4)
    n_ops = (n_slots * rays * 20                      # ray slab test, every listed pair
             + work["hit_pairs"] * s_c * 60           # coarse mip samples, pairs that hit
             # refine, the picked rays' pixels, one or two bracket stages
             + work["picks"] * px_per_ray * (20 + stages * s_r * 60)
             + (n_hit * 3 * 60 if need_color else 0))  # colour read, pixels that hit
    b, by = bound_ms(n_bytes, n_ops)
    return {"name": "raycast_cuda" + (f" ({tag})" if tag else ""), "tpu": "K3",
            "design": kernels.RAYCAST_TRACK_DESIGN if track else kernels.RAYCAST.design,
            "route": "cuda", "track": track,
            "source": "gps_slam_torch/csrc/raycast.cu",
            "replaces": "gps_slam_tpu/tsdf/raycast_pallas.py:51",
            "launches": launches, "max_abs_err": max_err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
            "library_ms": None, "ok": ok3,
            "bytes": n_bytes, "ops": n_ops,
            "shapes": {"T": T, "LB": LB, "valid_slots": n_slots,
                       "distinct_blocks": n_rows, "hit_pairs": work["hit_pairs"],
                       "picks": work["picks"], "picked_rows": work["picked_rows"],
                       "hit_pixels": n_hit, "k_blocks": k_b, "rays_per_tile": rays,
                       "s_coarse": s_c, "s_refine": s_r, "need_color": bool(need_color)},
            "tolerance": "hit masks equal; t*, confidence, colour "
                         + ("bit for bit" if exact else "within 1e-4") + " wherever both hit",
            "hit_flips": hit_flips, "hit_ratio": hk.float().mean().item(), **(extra or {})}


def kernel_phase(last: dict, launches: dict, k1: list, k2: list, k3: list) -> list[dict]:
    """Each kernel against its plain version: K4 and K5 on the inputs of
    their last main-path call (`last`, with the main path's `launches`),
    K1 on the last call of the main path and of the sharded path (`k1`:
    `k1_row`'s arguments per path), K2 on each route's last call (`k2`:
    (tag, replaces, arguments, launches) per route), K3 on the last call
    of the main path, of the 1920x1080 path, of the tracked path's
    tracking-prepare raycasts and of the sharded path (`k3`: `k3_row`'s
    arguments per path)."""
    from gps_slam_torch import kernels
    from gps_slam_torch.gs import rasterize as trz

    rows = []

    # ---- K1: integrate, on the last fused frame's inputs of each path
    rows += [k1_row(*r) for r in k1]

    # ---- K2a / K2b: the f32-I/O update, on each route's last call
    rows += [k2_row(*r) for r in k2]

    # ---- K3: raycast march, on the last raycast's inputs of each path
    rows += [k3_row(*r) for r in k3]

    # ---- K4: splat forward, on the last render's inputs
    (a, _) = last["splat_fwd"]
    packed, gids, px, py, ref, delta, C = a[:7]
    ok_out = trz.splat_fwd(packed, gids, px, py, ref, delta, C)
    pl_out = trz.splat_fwd_plain(packed, gids, px, py, ref, delta, C)
    torch.cuda.synchronize()
    max_err = (ok_out - pl_out).abs().max().item() if ok_out.numel() else 0.0
    rel_ok = bool(torch.allclose(ok_out, pl_out, rtol=1e-5, atol=1e-5))
    ms = time_ms(lambda: trz.splat_fwd(packed, gids, px, py, ref, delta, C), 50)
    plain_ms = time_ms(lambda: trz.splat_fwd_plain(packed, gids, px, py, ref, delta, C), 5, 1)
    A, L = gids.shape
    live, t_live = live_slots(packed, gids, C)
    # the same launch on the tiles with a live slot alone: the padded
    # tiles' cost is the difference, and each live tile's bits the same
    cut = [x.index_select(0, t_live).contiguous() for x in (gids, px, py, ref)]
    cut_out = trz.splat_fwd(packed, cut[0], cut[1], cut[2], cut[3], delta, C)
    rel_ok = (rel_ok and torch.equal(cut_out, ok_out.index_select(0, t_live))
              and not ok_out.index_select(0, torch.nonzero(live == 0)[:, 0]).any())
    ms_live = time_ms(lambda: trz.splat_fwd(packed, cut[0], cut[1], cut[2], cut[3],
                                            delta, C), 50)
    n_pairs = int(live.sum().item()) * 256
    n_rows = live_rows(packed, gids)
    # a tile with no live slot sums nothing: its pixels and its zero
    # output are not work the function needs
    a_live = t_live.numel()
    n_bytes = (n_rows * packed.shape[1] * 4 + gids.numel() * 4
               + a_live * (3 + C + 1) * 256 * 4)
    n_ops = n_pairs * (25 + 2 * (C + 1))
    b, by = bound_ms(n_bytes, n_ops)
    rows.append({"name": "splat_fwd_cuda", "tpu": "K4",
                 "design": kernels.SPLAT_FWD.design, "route": "cuda",
                 "source": "gps_slam_torch/csrc/splat_fwd.cu",
                 "replaces": "gps_slam_tpu/gs/splat_pallas.py:83",
                 "launches": launches["splat_fwd_cuda"], "max_abs_err": max_err,
                 "ms": ms, "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
                 "library_ms": None, "ok": rel_ok,
                 "bytes": n_bytes, "ops": n_ops,
                 "ms_live_tiles": ms_live,
                 "shapes": {"A": A, "L": L, "C": C, "gaussians": packed.shape[0] - 1,
                            "live_rows": n_rows, "live_pairs": n_pairs,
                            "tiles_no_live_slot": A - a_live},
                 "tolerance": "rtol 1e-5 / atol 1e-5; the live tiles alone give "
                              "the same bits, the others exact zeros"})

    # ---- K5: splat backward, on the last Adam step's inputs
    (a, _) = last["splat_bwd"]
    packed, gids, px, py, ref, v_out, delta, C = a[:8]
    bargs = (packed, gids, px, py, ref, v_out, delta, C)
    ok_out = trz.splat_bwd(*bargs)
    again = trz.splat_bwd(*bargs)
    pl_out = trz.splat_bwd_plain(*bargs)
    torch.cuda.synchronize()
    col_err = (ok_out - pl_out).abs().amax((0, 1))
    col_max = pl_out.abs().amax((0, 1))
    max_err = col_err.max().item() if ok_out.numel() else 0.0
    ok5 = bool((col_err <= 1e-4 * col_max).all()) and torch.equal(ok_out, again)
    ms = time_ms(lambda: trz.splat_bwd(*bargs), 50)
    plain_ms = time_ms(lambda: trz.splat_bwd_plain(*bargs), 5, 1)
    A, L = gids.shape
    live, t_live = live_slots(packed, gids, C)
    empty = torch.nonzero(live == 0)[:, 0]
    cut = [x.index_select(0, t_live).contiguous() for x in (gids, px, py, ref, v_out)]
    cargs = (packed, *cut, delta, C)
    cut_out = trz.splat_bwd(*cargs)
    # a tile with no live slot: exact zeros, as in the plain version; a
    # live tile: the same bits whether or not padded tiles share its launch
    ok5 = (ok5 and torch.equal(cut_out, ok_out.index_select(0, t_live))
           and not ok_out.index_select(0, empty).any()
           and not pl_out.index_select(0, empty).any())
    ms_live = time_ms(lambda: trz.splat_bwd(*cargs), 50)
    n_pairs = int(live.sum().item()) * 256
    n_rows = live_rows(packed, gids)
    # a tile with no live slot has a zero gradient whatever its planes
    # hold: its planes and its zero output are not work the function needs
    a_live = t_live.numel()
    n_bytes = (n_rows * packed.shape[1] * 4 + gids.numel() * 4
               + a_live * (3 + C + 1) * 256 * 4 + a_live * L * (6 + C) * 4)
    # per live pair: the pair terms (as K4), v_w, d_alpha, v_sigma and the
    # 6 + C running sums
    n_ops = n_pairs * (55 + 4 * C)
    b, by = bound_ms(n_bytes, n_ops)
    rows.append({"name": "splat_bwd_cuda", "tpu": "K5",
                 "design": kernels.SPLAT_BWD.design, "route": "cuda",
                 "source": "gps_slam_torch/csrc/splat_bwd.cu",
                 "replaces": "gps_slam_tpu/gs/splat_pallas.py:99",
                 "launches": launches["splat_bwd_cuda"], "max_abs_err": max_err,
                 "ms": ms, "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
                 "library_ms": None, "ok": ok5,
                 "bytes": n_bytes, "ops": n_ops, "ms_live_tiles": ms_live,
                 "shapes": {"A": A, "L": L, "C": C, "gaussians": packed.shape[0] - 1,
                            "live_rows": n_rows, "live_pairs": n_pairs,
                            "live_slots_mean": live.float().mean().item(),
                            "live_slots_max": int(live.max().item()),
                            "tiles_no_live_slot": int((live == 0).sum().item())},
                 "max_rel_col_err": (col_err / col_max.clamp(min=1e-30)).max().item(),
                 "tolerance": "each column within 1e-4 of its largest |value| "
                              "(pixel sums in another order, built with "
                              "multiply-add contraction); the same bits on a "
                              "second launch and on the live tiles alone; "
                              "exact zeros on the others"})
    for r in rows:
        log("[kernel] " + json.dumps(r))
    bad = [r["name"] for r in rows if not r["ok"]]
    if bad:
        raise RuntimeError(f"kernels disagree with their plain versions: {bad}")
    return rows


def by_key(vol):
    """(keys, state words, colour words) of the allocated blocks on the
    host, sorted by key."""
    keys = vol.block_coords[:vol.n_blocks].cpu()
    order = torch.argsort(keys)
    return (keys[order], vol.state[:vol.n_blocks].cpu()[order],
            vol.color[:vol.n_blocks].cpu()[order])


def state_diff(a, b) -> dict:
    """Two `by_key` results (card, CPU): the same keys and, by key, every
    state word's weights equal, sdf within 1 quantum, colour within 1."""
    (kc, sc, cc), (kp, sp, cp) = a, b
    out = {"n_blocks_cuda": kc.numel(), "n_blocks_cpu": kp.numel(),
           "same_keys": torch.equal(kc, kp)}
    if out["same_keys"]:
        out.update(
            weight_mismatches=int(((sc >> 16) != (sp >> 16)).sum().item()),
            max_sdf_quanta=(sdf_of(sc) - sdf_of(sp)).abs().max().item(),
            max_color_step=max((((cc >> s) & 0xFF) - ((cp >> s) & 0xFF)).abs().max().item()
                               for s in (0, 8, 16)),
            integrated_voxels=int(((sc >> 16) & 0xFF).gt(0).sum().item()))
    out["ok"] = (out["same_keys"] and out["weight_mismatches"] == 0
                 and out["max_sdf_quanta"] <= 1 and out["max_color_step"] <= 1
                 and out["integrated_voxels"] > 0)
    return out


def reference_phase() -> dict:
    """Fusion + raycast at small sizes on the card against the CPU plain
    path: K1's route at 128x96; the f32 route at 128x96 with the port's
    `_RESIDENT_BYTES` lowered to 0, so that K2 runs on the card; and 48x40,
    below the 64 px that the window kernels need, where both devices take
    the torch branch of narrow frames (no integrate kernel) and the raycast
    runs K3 on partial 16 px tiles.  Fusion's math divides by device
    tensors and sums the camera pose term by term on both devices, and the
    hash claim picks each slot's winner explicitly, so each route requires
    the same block keys and, by key, every state word's weights equal, its
    sdf within 1 quantum and colour channels within 1.  K1's route and the
    narrow frames also raycast one view: equal hit masks and depth within
    a voxel on every pixel both hit."""
    from gps_slam_torch import kernels
    from gps_slam_torch.data import synthetic
    from gps_slam_torch.tsdf import integrate as tint
    from gps_slam_torch.tsdf import raycast_tiles as trc
    from gps_slam_torch.tsdf import volume as tvol

    p = tvol.TsdfParams(voxel_size=0.02, mu=0.08, hash_size=1 << 16,
                        block_capacity=1 << 13, visible_capacity=1 << 12)

    def fuse(cams, dev):
        vol = tvol.create(p, dev)
        for c in cams:
            tint.fuse_frame(vol, torch.as_tensor(c.depth[..., 0], device=dev),
                            torch.as_tensor(c.image, device=dev),
                            torch.as_tensor(c.c2w, device=dev), c.K)
        return vol

    def fused_and_raycast(cams, tag) -> dict:
        width, height = cams[0].width, cams[0].height
        maps, states, launches = {}, {}, {}
        for dev in ("cuda", "cpu"):
            kernels.reset_counts()
            vol = fuse(cams, dev)
            launches[dev] = kernels.counts()
            m = trc.raycast(vol, cams[3].c2w, cams[3].K, width, height, 24, 4, 8, 2)
            maps[dev] = m["depth_map"][..., 0].cpu().numpy()
            states[dev] = by_key(vol)
        torch.cuda.synchronize()
        d_c, d_p = maps["cuda"], maps["cpu"]
        both = (d_c > 0) & (d_p > 0)
        gt = cams[3].depth[..., 0]
        res = {**state_diff(states["cuda"], states["cpu"]),
               "width": width, "height": height,
               "fusion_launches_cuda": launches["cuda"],
               "hit_xor": float(np.mean((d_c > 0) != (d_p > 0))),
               "hit_pixels": int(both.sum()),
               "depth_within_voxel": float(np.mean(np.abs(d_c - d_p)[both] < p.voxel_size)),
               "max_depth_diff": float(np.abs(d_c - d_p)[both].max()),
               "median_depth_err_vs_gt": float(np.median(np.abs(d_c - gt)[d_c > 0]))}
        log(f"[{tag}] " + json.dumps(res))
        if (not res["ok"] or res["hit_xor"] > 0.0 or res["depth_within_voxel"] < 1.0
                or res["median_depth_err_vs_gt"] > p.voxel_size):
            raise RuntimeError(f"{tag}: the card run disagrees with the CPU reference")
        return res

    cams = synthetic.make_cameras(n_frames=6, width=128, height=96)
    res = fused_and_raycast(cams, "reference")

    saved = tint._RESIDENT_BYTES
    tint._RESIDENT_BYTES = 0
    try:
        if tint.integrate_route(128, 96) != "pregather":
            raise RuntimeError("the lowered budget did not select the f32 route")
        f32 = state_diff(*(by_key(fuse(cams, dev)) for dev in ("cuda", "cpu")))
    finally:
        tint._RESIDENT_BYTES = saved
    log("[reference f32 route] " + json.dumps(f32))
    if not f32["ok"]:
        raise RuntimeError("card run on the f32 route disagrees with the CPU reference")
    res["f32_route"] = f32

    narrow = fused_and_raycast(synthetic.make_cameras(n_frames=6, width=48, height=40),
                               "reference narrow")
    fused_kernels = {k: n for k, n in narrow["fusion_launches_cuda"].items()
                     if k in (kernels.INTEGRATE.name, kernels.INTEGRATE_F32.name)}
    if any(fused_kernels.values()):
        raise RuntimeError(f"narrow frames launched an integrate kernel: {fused_kernels}")
    res["narrow"] = narrow
    return res


def tracked_path(args, rec, cams) -> tuple[dict, tuple]:
    """The tracked path at 1200x680 (phase 6) on `cams`: the tracked
    megastep, then the same frames on the eager route as its witness
    (`_can_fast_track` off on that engine alone); both held to the path's
    gates.  Returns the megastep run's line numbers and `k3_row`'s
    arguments for its last tracking-prepare call (launches: the prepare
    raycasts'; `launches_path`: every K3 launch of the path)."""
    from gps_slam_torch import kernels
    from gps_slam_torch.utils import graphs

    out, _, _ = run_path(args, cams, ADAM_STEPS, "tracked path", kernels.INTEGRATE,
                         tracked=rec)
    call = rec.last["tracking prepare"]
    eager, _, _ = run_path(args, cams, ADAM_STEPS, "tracked path, eager witness",
                           kernels.INTEGRATE, tracked=rec, fast_track=False)
    # the eager witness's last frame's Gauss-Newton levels, finest first
    # (the megastep's run inside its graph, where nothing is recorded)
    gn_calls = [(f"level {lvl}, {1200 >> lvl}x{680 >> lvl}",
                 rec.last[("icp_gn", (680 >> lvl, 1200 >> lvl))]) for lvl in range(4)]
    budgets = out["gn_iters_budget_per_level"]
    for r in (out, eager):
        if r["adam_steps"] != ADAM_STEPS * r["windows"]:
            raise RuntimeError(f"tracked path ran {r['adam_steps']} Adam steps")
        # one icp_gn_cuda launch a level run (a replay's counted as its capture's)
        if r["launches"][kernels.ICP_GN.name] != len(budgets) * r["tracked_frames"]:
            raise RuntimeError(f"tracked path ({r['tracking_route']}): "
                               f"{r['launches'][kernels.ICP_GN.name]} icp_gn_cuda launches for "
                               f"{r['tracked_frames']} frames of {len(budgets)} levels")
    if (out["tracking_route"], eager["tracking_route"]) != ("megastep", "eager"):
        raise RuntimeError(f"tracked path: routes {out['tracking_route']} and "
                           f"{eager['tracking_route']}")
    mega_ms, eager_ms = out["tracked_frame_ms"], eager["tracked_frame_ms"]
    n_eager = eager["tracked_frames"]
    # no conditional (WHILE) node left in a capture: each level is one
    # kernel node; the replays run fewer iterations than the budgets
    while_nodes = sum(n["conditional"] for n in out["megastep_graphs"]["nodes"])
    if while_nodes or not sum(out["gn_iters_mean_per_level"]) < sum(budgets):
        raise RuntimeError(f"tracked path: {while_nodes} WHILE nodes in "
                           f"{out['megastep_graphs']['nodes']}, iterations "
                           f"{out['gn_iters_mean_per_level']} of {budgets}")
    log("[tracked routes] " + json.dumps({
        # the same scope on both routes: engine.process_frame of a tracked
        # frame (ICP, revert, fusion, the next prepare raycast), ms
        "tracked_frame_ms": {"megastep": mega_ms, "eager": eager_ms},
        "megastep_over_eager_median": mega_ms["median"] / eager_ms["median"],
        "megastep_pays": mega_ms["median"] < eager_ms["median"],
        "eager_ms_per_tracked_frame": {
            "track": eager["tracking_ms_per_frame"],
            "fusion": eager["fusion_ms_per_frame"],
            "prepare_raycast": eager["tracking_prepare_raycast_ms_total"] / eager["frames"],
            "frames": n_eager},
        "megastep_replay_ms_mean": out["megastep_graphs"]["replay_ms_mean"],
        "megastep_capture_ms": out["megastep_graphs"]["capture_ms"],
        "megastep_graph_mb": out["megastep_graphs"]["graph_mb"],
        # a replay runs the iterations its level kernels let through (the
        # device tests the exit after each), the eager loop likewise with
        # one read a level: each route on its own trajectory
        "gn_iters_mean_per_level": {"megastep": out["gn_iters_mean_per_level"],
                                    "eager": eager["gn_iters_mean_per_level"]},
        "gn_iters_budget_per_level": out["gn_iters_budget_per_level"],
        "megastep_graph_nodes": out["megastep_graphs"]["nodes"],
        # WHILE nodes left in the captures: 0, each level one kernel node
        "while_nodes": while_nodes,
        # icp_gn_cuda: the wrappers' launches (the megastep's: 4 a graph
        # run, one a level) and the iterations the card ran
        "icp_gn_launches": {"megastep": out["launches"][kernels.ICP_GN.name],
                            "eager": eager["launches"][kernels.ICP_GN.name]},
        "gn_iters_total": {"megastep": out["gn_iters_total"], "eager": eager["gn_iters_total"]},
        "torch_cuda": torch.version.cuda, "versions": graphs.versions(),
        "ate_cm": {"megastep": out["ate_cm"], "eager": eager["ate_cm"]},
        "last_translation_err_cm": {"megastep": out["last_translation_err_cm"],
                                    "eager": eager["last_translation_err_cm"]},
        "psnr_mean": {"megastep": out["psnr_mean"], "eager": eager["psnr_mean"]},
        "train_s": {"megastep": out["train_s"], "eager": eager["train_s"]}}))
    from gps_slam_torch.tsdf import raycast_tiles as trc

    a, kw = call
    need_color = a[10] if len(a) > 10 else kw.get("need_color", True)
    track = a[11] if len(a) > 11 else kw.get("track", False)
    if need_color or not track or a[9] != trc.TRACK_K_BLOCKS:
        raise RuntimeError("the tracking-prepare raycast did not run in the tracking "
                           f"mode at k_blocks {trc.TRACK_K_BLOCKS} without colour")
    # the same call as the tracking prepare ran it before the tracking mode
    # (the TPU kernel's semantics, k_blocks 1), timed beside it; printed as
    # a [kernel] line, not a launch of the path
    parent = ((*a[:9], 1, False), {})
    out["gn_calls"] = [(tag, c, eager["launches"][kernels.ICP_GN.name],
                        {"launches_megastep": out["launches"][kernels.ICP_GN.name],
                         "gn_iters_total": {"megastep": out["gn_iters_total"],
                                            "eager": eager["gn_iters_total"]}})
                       for tag, c in gn_calls]
    return out, [("tracking prepare, 1200x680", call, out["tracking_prepare_k3_launches"],
                  {"launches_path": out["launches"][kernels.RAYCAST.name]}, True),
                 ("tracking prepare, 1200x680, the TPU kernel's semantics at k_blocks 1",
                  parent, 0, {"comparison": "the prepare call before the tracking mode, "
                                            "on the same inputs; not launched on the path"})]


def color_tracked_path(args, rec, cams) -> tuple[dict, list, list]:
    """`[color tracked path]` (phase 6b): the tracked path's frames and
    config (1200x680, inward orbit, arc TRACKED_ARC, raycast LB 16, 2
    windows x 20 Adam steps) with PIPE.TSDF.tracker.type composite: each
    frame the colour tracker refines the pose (its pyramid and Sobel, then
    one `color_gn_cuda` launch and one 8-byte read a pyramid level), then
    ICP (`icp_gn_cuda`, one launch a level), on the eager route the JAX
    engine's gate
    gives a tracker that is not device-pure; the tracking-prepare raycast
    (K3's tracking mode) carries colour.  Held to the tracked path's gates
    (ATE, last pose, GOOD share, 15 dB), both Gauss-Newton kernels
    launched once a level run, no torch.linalg solve or inverse inside the
    colour stage.  Returns the line's numbers, `k3_row`'s arguments for
    the last prepare call and `color_gn_row`'s for the last frame's four
    levels."""
    from gps_slam_torch import kernels
    from gps_slam_torch.slam import tracker as ttrk
    from gps_slam_torch.tsdf import raycast_tiles as trc

    # count torch.linalg's solves and inverses while the colour stage runs
    in_color, linalg_calls = [False], [0]
    color_track = ttrk.ColorTracker.track

    def flagged(self, *a, **kw):
        in_color[0] = True
        try:
            return color_track(self, *a, **kw)
        finally:
            in_color[0] = False

    names = ("solve", "solve_ex", "inv", "inv_ex", "lstsq", "cholesky", "lu_factor")
    saved = {name: getattr(torch.linalg, name) for name in names}

    def counted(fn):
        def wrap(*a, **kw):
            linalg_calls[0] += in_color[0]
            return fn(*a, **kw)
        return wrap

    ttrk.ColorTracker.track = flagged
    for name, fn in saved.items():
        setattr(torch.linalg, name, counted(fn))
    try:
        out, _, _ = run_path(args, cams, ADAM_STEPS, "color tracked path", kernels.INTEGRATE,
                             tracked=rec, tracker="composite")
    finally:
        ttrk.ColorTracker.track = color_track
        for name, fn in saved.items():
            setattr(torch.linalg, name, fn)
    cs = out["color_stage"]
    res = {"frames": out["frames"], "width": out["width"], "height": out["height"],
           "tracker": "composite", "route": out["tracking_route"],
           "raycast_lb": out["raycast_lb"],
           "color_stage_ms_per_frame": cs["ms_per_frame"],
           "color_stage_ms_total": cs["ms_total"],
           "color_iters_per_frame": cs["iters_per_frame"],
           "color_iters_mean_per_level": cs["iters_mean_per_level"],
           "color_iters_budget_per_level": cs["iters_budget_per_level"],
           "color_quality": cs["quality"], "color_inlier": cs["inlier"],
           "color_residual": cs["residual"],
           "tracking_ms_per_frame": out["tracking_ms_per_frame"],
           "icp_iters_mean_per_level": out["gn_iters_mean_per_level"],
           "quality": out["quality"],
           "launches": {k.name: out["launches"][k.name]
                        for k in (kernels.COLOR_GN, kernels.ICP_GN, kernels.RAYCAST)},
           "linalg_calls_in_color_stage": linalg_calls[0],
           "ate_cm": out["ate_cm"], "last_translation_err_cm": out["last_translation_err_cm"],
           "last_rotation_err_deg": out["last_rotation_err_deg"],
           "psnr_mean": out["psnr_mean"], "train_s": out["train_s"]}
    log("[color tracked path] " + json.dumps(res))
    if out["tracking_route"] != "eager":
        raise RuntimeError(f"color tracked path: route {out['tracking_route']}, not eager")
    # one launch of each Gauss-Newton kernel a level run
    levels_run = len(cs["iters_budget_per_level"]) * len(cs["iters_per_frame"])
    icp_levels_run = len(out["gn_iters_budget_per_level"]) * out["tracked_frames"]
    if (out["launches"][kernels.COLOR_GN.name] != levels_run
            or out["launches"][kernels.ICP_GN.name] != icp_levels_run):
        raise RuntimeError(f"color tracked path: launches {res['launches']} for "
                           f"{levels_run} colour and {icp_levels_run} ICP levels run")
    if linalg_calls[0]:
        raise RuntimeError(f"color tracked path: {linalg_calls[0]} torch.linalg calls in the "
                           "colour stage")
    call = rec.last["tracking prepare"]
    a, kw = call
    need_color = a[10] if len(a) > 10 else kw.get("need_color", True)
    track = a[11] if len(a) > 11 else kw.get("track", False)
    if not (need_color and track and a[9] == trc.TRACK_K_BLOCKS and a[0].shape[1] == 16):
        raise RuntimeError("the colour path's tracking-prepare raycast did not run in the "
                           f"tracking mode at k_blocks {trc.TRACK_K_BLOCKS}, LB 16, "
                           "with colour")
    n = out["launches"][kernels.COLOR_GN.name]
    gn_calls = [(f"level {lvl}, {1200 >> lvl}x{680 >> lvl}",
                 rec.last[("color_gn", (680 >> lvl, 1200 >> lvl))], n) for lvl in range(4)]
    k3 = [("tracking prepare with colour, 1200x680, color tracked path", call,
           out["tracking_prepare_k3_launches"],
           {"launches_path": out["launches"][kernels.RAYCAST.name]}, True)]
    return res, k3, gn_calls


# f32 operations of project_sh_fwd_cuda and project_sh_bwd_cuda at SH
# degree 3, counted from their expressions.  A row's projection: the camera
# point, the quaternion's rotation, the scales' exp, M, Cw, Rc Cw Rc^T
# (~180), the Jacobian, 2D covariance, conic, radius and cull (~80); the
# backward recomputes it and runs its chain back (~300).  A visible row's
# SH (a culled row's colour is 0.5 and its SH grads are 0, whatever its
# coefficients): the direction and 3 channels of 16 coefficients (~210);
# the backward recomputes them and runs the SH's chain back (15
# coefficients x ~17, the basis and its derivatives, ~330)
PROJECT_FWD_OPS, SH_FWD_OPS = 260, 210
PROJECT_BWD_OPS, SH_BWD_OPS = 560, 540
# records of the parent tree for the `[window step]` line (PERF.md
# section 5): tools/window_step_time.py on the parent and on this tree in
# one call on an NVIDIA H100 80GB HBM3 at 700 W (the kernel nodes one Adam
# step adds to a window graph, and the device ms of the tool's replayed
# window), and the `[megastep path]` replays of an earlier tree's run
PARENT_RECORDS = {
    "window_nodes_per_step": 1284,
    "tool_replay_device_ms": [73.28, 73.53],
    "tool_source": "tools/window_step_time.py on the parent tree, NVIDIA H100 80GB HBM3, "
                   "700.00 W",
    "megastep_path_replay_ms": [86.0, 102.0],
    "megastep_path_source": "chip_smoke.py [megastep path] replays (host clock) before "
                            "the window step's kernels, NVIDIA H100 80GB HBM3, 700.00 W",
    # the step kernels' first design (one thread a row): their `[kernel]`
    # ms at the main path's 32,768 rows (1,299 visible), and at 131,072
    # random rows (tests/test_torch_cuda.py's inputs)
    "first_design_ms": {"project_sh_fwd_cuda": 0.01078, "project_sh_bwd_cuda": 0.04103},
    "first_design_ms_131072_rows": {"project_sh_fwd_cuda": 0.02673,
                                    "project_sh_bwd_cuda": 0.13677},
    "first_design_source": "the tree before the tiled design: chip_smoke.py [kernel] rows "
                           "(32,768 rows), its 131,072-row inputs timed alike, NVIDIA H100 "
                           "80GB HBM3, 700.00 W",
}


def _step_row(name: str, kernel, source: str, replaces: str, launches: int, ok: bool,
              max_err: float, ms: float, plain_ms: float, n_bytes: float, n_ops: float,
              library_ms, extra: dict) -> dict:
    b, by = bound_ms(n_bytes, n_ops)
    row = {"name": name, "tpu": None, "design": kernel.design, "route": "cuda",
           "source": source, "replaces": replaces, "launches": launches,
           "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b,
           "bound_by": by, "library_ms": library_ms, "ok": ok, "bytes": n_bytes,
           "ops": n_ops, **extra}
    log("[kernel] " + json.dumps(row))
    return row


def _bits_equal(a, b) -> bool:
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def _max_err(a, b) -> float:
    if a.dtype != torch.float32 or a.numel() == 0:
        return float((a != b).sum().item())
    same = a.view(torch.int32) == b.view(torch.int32)
    return float(torch.where(same, 0.0, (a - b).abs()).nan_to_num(float("inf")).max().item())


def window_step_phase(last: dict, launches: dict, mega: dict) -> list[dict]:
    """`[window step]`: the Adam step's three kernels against their plain
    versions on the main path's last window (the last step of its last
    window, a captured megastep window: the tensors hold its last run):
    project_sh_fwd_cuda on that step's forward, project_sh_bwd_cuda on its
    backward (its radii and cotangents), window_adam_cuda on the
    optimizer's state after it (the last step's schedule row, on copies);
    each bit for bit with its plain version and a second launch the same
    bits.  `ms` by CUDA events after an L2 flush; the bound: each input
    row read once, each output written once, over the card's memory rate
    (the operations take less); the SH coefficients, and the colours'
    cotangents, count only for the rows with a radius (a culled row's
    colour is 0.5 and its SH grads are 0 whatever they hold): the function
    needs no more, though the backward reads every row's.  window_adam's
    library column times torch._fused_adam_ on the same seven groups (its
    own Adam, timed only).  Each row also carries the megastep path's
    launches of its kernel and, for project_sh_fwd_cuda and
    project_sh_bwd_cuda, the first design's ms (PARENT_RECORDS).  Then one
    line of the window graph's kernel nodes per Adam step and the megastep
    path's replay ms, beside the parent's records (PARENT_RECORDS)."""
    import copy

    from gps_slam_torch import kernels
    from gps_slam_torch.gs import gauss_step as gs
    from gps_slam_torch.gs import optim

    def step_extra(kernel) -> dict:
        # the megastep path's launches beside the main path's, and the
        # first design's ms where the kernel had one before this design
        out = {"launches_megastep_path": mega["launches"][kernel.name]}
        if kernel.name in PARENT_RECORDS["first_design_ms"]:
            out["first_design_ms"] = PARENT_RECORDS["first_design_ms"][kernel.name]
        return out

    rows = []
    # ---- project_sh_fwd_cuda: the last step's forward
    a, _ = last["project_sh_fwd"]
    means, quats, ls, fdc, frest, alive, viewmat, c2w, active, cam, st = a
    outs = [gs.project_sh_fwd(*a), gs.project_sh_fwd(*a), gs.project_sh_fwd_plain(*a)]
    torch.cuda.synchronize()
    ok = all(_bits_equal(x, z) and _bits_equal(x, y) for x, y, z in zip(*outs))
    err = max(_max_err(x, z) for x, z in zip(outs[0], outs[2]))
    N, nc = means.shape[0], frest.shape[1] + 1
    vis = int((outs[0][3] > 0).sum().item())
    if vis == 0:
        raise RuntimeError("window step: the recorded step's forward has no visible row")
    # inputs: means, quats, log-scales and alive of every row, the SH of
    # the visible rows; outputs: means2d, conics, depths, radii, colours;
    # the two 4 x 4 poses
    fwd_bytes = (N * ((3 + 4 + 3) * 4 + 1) + vis * 3 * nc * 4
                 + N * (2 + 3 + 1 + 1 + 3) * 4 + 2 * 64)
    fwd_ops = N * PROJECT_FWD_OPS + vis * SH_FWD_OPS
    shapes = {"rows": N, "sh_coeffs": nc, "sh_degree": st.sh_degree, "visible": vis}
    rows.append(_step_row(
        kernels.PROJECT_SH_FWD.name, kernels.PROJECT_SH_FWD, "gps_slam_torch/csrc/gauss_step.cu",
        "gps_slam_tpu/gs/model.py:58-79 (XLA: projection.py:72, sh.py:44)",
        launches[kernels.PROJECT_SH_FWD.name], ok, err,
        time_ms(lambda: gs.project_sh_fwd(*a), 50), time_ms(lambda: gs.project_sh_fwd_plain(*a), 5, 1),
        fwd_bytes, fwd_ops, None,
        {"shapes": shapes, "tolerance": "every output bit for bit; a second launch the same bits",
         **step_extra(kernels.PROJECT_SH_FWD)}))

    # ---- project_sh_bwd_cuda: the last step's backward
    a, _ = last["project_sh_bwd"]
    outs = [gs.project_sh_bwd(*a), gs.project_sh_bwd(*a), gs.project_sh_bwd_plain(*a)]
    torch.cuda.synchronize()
    ok = all(_bits_equal(x, z) and _bits_equal(x, y) for x, y, z in zip(*outs))
    err = max(_max_err(x, z) for x, z in zip(outs[0], outs[2]))
    cots = [v for v in a[11:] if v is not None]
    # inputs: means, quats, log-scales and radii of every row, the SH of
    # the visible rows; the cotangents of means2d, conics and depths of
    # every row, of the colours (the last) of the visible rows; outputs:
    # the grads of means, quats, log-scales and SH
    cot_floats = sum(v.numel() for v in a[11:14] if v is not None)
    cot_floats += 3 * vis if a[14] is not None else 0
    bwd_bytes = (N * (3 + 4 + 3 + 1) * 4 + vis * 3 * nc * 4 + cot_floats * 4
                 + N * (3 + 4 + 3 + 3 * nc) * 4 + 2 * 64)
    bwd_ops = N * PROJECT_BWD_OPS + vis * SH_BWD_OPS
    rows.append(_step_row(
        kernels.PROJECT_SH_BWD.name, kernels.PROJECT_SH_BWD, "gps_slam_torch/csrc/gauss_step.cu",
        "gps_slam_tpu/gs/model.py:357-374,396 (XLA: jax.grad of model.py:58-79)",
        launches[kernels.PROJECT_SH_BWD.name], ok, err,
        time_ms(lambda: gs.project_sh_bwd(*a), 50), time_ms(lambda: gs.project_sh_bwd_plain(*a), 5, 1),
        bwd_bytes, bwd_ops, None,
        {"shapes": {**shapes, "cotangents": len(cots)},
         "tolerance": "every grad bit for bit; a second launch the same bits",
         **step_extra(kernels.PROJECT_SH_BWD)}))

    # ---- window_adam_cuda: the optimizer's state after the last step,
    # stepped once more with that step's schedule row, on copies
    (opt,), _ = last["window_adam"]
    row_idx = opt.count - 1

    def clone_opt():
        o = copy.copy(opt)
        o.params = {}
        for k, p in opt.params.items():
            q = p.detach().clone()
            q.grad = None if p.grad is None else p.grad.clone()
            o.params[k] = q
        o.mu = {k: v.clone() for k, v in opt.mu.items()}
        o.nu = {k: v.clone() for k, v in opt.nu.items()}
        o.count = row_idx
        return o

    ka, kb, pl = clone_opt(), clone_opt(), clone_opt()
    optim.window_adam(ka)
    optim.window_adam(kb)
    pl._step_plain()
    torch.cuda.synchronize()
    pairs = [(ka.params[k], pl.params[k]) for k in opt.params]
    pairs += [(ka.mu[k], pl.mu[k]) for k in opt.mu] + [(ka.nu[k], pl.nu[k]) for k in opt.nu]
    ok = all(_bits_equal(x, y) for x, y in pairs) and all(
        _bits_equal(ka.params[k], kb.params[k]) for k in opt.params)
    err = max(_max_err(x, y) for x, y in pairs)
    t = clone_opt()
    saved = clone_opt()

    def restore():
        for k in t.params:
            t.params[k].copy_(saved.params[k])
            t.mu[k].copy_(saved.mu[k])
            t.nu[k].copy_(saved.nu[k])

    ms = time_ms(lambda: optim.window_adam(t), 50, before=restore)
    plain_ms = time_ms(lambda: t._step_plain(), 5, 1, before=restore)
    numel = sum(p.numel() for p in opt.params.values())
    with_grad = sum(p.numel() for p in opt.params.values() if p.grad is not None)
    # p, mu, nu read and written, the grads read (a missing one is zero)
    adam_bytes = numel * 6 * 4 + with_grad * 4 + 3 * 4
    # the library's fused Adam over the same groups (timed only)
    lib = clone_opt()
    plist = [p for p in lib.params.values() if p.numel()]
    glist = [p.grad if p.grad is not None else torch.zeros_like(p) for p in plist]
    keys = [k for k, p in lib.params.items() if p.numel()]
    steps_t = [torch.full((), float(row_idx + 1), device=plist[0].device) for _ in plist]
    mus, nus = [lib.mu[k] for k in keys], [lib.nu[k] for k in keys]
    library_ms = time_ms(lambda: torch._fused_adam_(
        plist, glist, mus, nus, [], steps_t, lr=1e-3, beta1=optim.B1, beta2=optim.B2,
        weight_decay=0.0, eps=optim.EPS, amsgrad=False, maximize=False), 50)
    rows.append(_step_row(
        kernels.WINDOW_ADAM.name, kernels.WINDOW_ADAM, "gps_slam_torch/csrc/window_adam.cu",
        "gps_slam_tpu/gs/optim.py:24-53 (XLA: model.py:398)",
        launches[kernels.WINDOW_ADAM.name], ok, err, ms, plain_ms, adam_bytes, numel * 12,
        library_ms,
        {"shapes": {"elements": numel, "with_grad": with_grad, "attributes": len(opt.params),
                    "schedule_row": row_idx},
         "library_call": "torch._fused_adam_ over the same groups (one lr)",
         "tolerance": "params and both moments bit for bit; a second launch the same bits",
         **step_extra(kernels.WINDOW_ADAM)}))
    bad = [r["name"] for r in rows if not r["ok"]]
    summary = {
        "window_nodes_per_step": mega["window_nodes_per_step"],
        "window_graph_nodes": mega["graph_nodes"],
        "replay_ms_mean": mega["replay_ms_mean"],
        "replay_ms": [w["ms"] for w in mega["windows"] if w["graph"] == "replay"],
        "parent_records": PARENT_RECORDS,
        "step_launches": {k: launches[k] for k in (
            kernels.PROJECT_SH_FWD.name, kernels.PROJECT_SH_BWD.name, kernels.WINDOW_ADAM.name)}}
    log("[window step] " + json.dumps(summary))
    if bad:
        raise RuntimeError(f"window step kernels disagree with their plain versions: {bad}")
    return rows


# f32 and f64 operations of icp_gn_cuda's first kernel a pixel, counted
# from its expressions: the point, its two transforms and projection, two
# 4-corner bilinear reads, the normal, residual, Tukey weight and Jacobian
# (~270 f32); 42 f64 products and ~45 adds of the sums
ICP_GN_F32_OPS, ICP_GN_F64_OPS = 270, 90


def icp_gn_texels(depth, refv, cam, T, rpi) -> int:
    """The reference-map pixels that one Gauss-Newton pass reads: the 4
    bilinear corners of every pixel's projection (the plain version's
    arithmetic), distinct."""
    from gps_slam_torch.slam import icp_gn

    Hf, Wf = refv.shape[:2]
    pts, _ = icp_gn.level_points(depth, cam)
    pw = icp_gn._affine(T, *pts.unbind(1))
    pr = icp_gn._affine(rpi, *pw)
    zs = torch.clamp(pr[2], min=1e-6)
    u = torch.clamp(cam[4] * pr[0] / zs + cam[6], 0.0, Wf - 1.0).floor().long()
    v = torch.clamp(cam[5] * pr[1] / zs + cam[7], 0.0, Hf - 1.0).floor().long()
    u1, v1 = torch.clamp(u + 1, max=Wf - 1), torch.clamp(v + 1, max=Hf - 1)
    idx = torch.cat([v * Wf + u, v * Wf + u1, v1 * Wf + u, v1 * Wf + u1])
    return int(torch.unique(idx).numel())


def gn_level_check(kind: str, call: tuple) -> dict:
    """A recorded Gauss-Newton level (`icp_gn.iterate` or
    `color_gn.iterate` with the state, count and test it started from)
    launched twice from its start and run once by its plain level loop
    (`iterate_plain` pass after pass while `more` holds) on the card: the
    state, count and test bit for bit, the launches' scratch the same bits,
    its first half the last pass's per-CTA rows (`cta_rows` of the plain
    terms at the state that pass started from), the barrier idle.  Then
    `ms`, a launch from the start each time (restored outside the events),
    and `plain_ms`, the plain level."""
    from gps_slam_torch import kernels
    from gps_slam_torch.slam import color_gn, icp_gn

    mod = icp_gn if kind == "icp" else color_gn
    kernel = kernels.ICP_GN if kind == "icp" else kernels.COLOR_GN
    a, kw, (s0, r0, m0) = call
    inputs, partials = a[:10], a[13]
    first = bool(a[14] if len(a) > 14 else kw.get("first", False))
    budget = int(a[15] if len(a) > 15 else kw.get("budget", 1))

    def plain_level(s, n, m):
        before = s.clone()
        for i in range(budget):
            if i and not bool(m):
                break
            before = s.clone()
            mod.iterate_plain(*inputs, s, n, m, first=first and i == 0)
        return before

    runs = []
    for how in ("cuda", "cuda", "plain"):
        s, n, m, p = s0.clone(), r0.clone(), m0.clone(), partials.clone()
        p[:-1].fill_(float("nan"))
        if how == "cuda":
            mod.iterate(*inputs, s, n, m, p, first=first, budget=budget)
        else:
            before = plain_level(s, n, m)
        runs.append((s, n, m, p))
    torch.cuda.synchronize()
    T = before[:16].view(4, 4)
    if kind == "icp":
        depth, refv, refn, cam, rpi, st, tc, rot = inputs[:8]
        pts, has_depth = icp_gn.level_points(depth, cam)
        x = icp_gn.terms(T, pts, has_depth, refv, refn, cam, rpi, st, tc, rot)
    else:
        x = color_gn.terms(T, *inputs[:7], inputs[7])
    rows = icp_gn.cta_rows(x)
    (s1, n1, m1, p1), (s2, n2, m2, p2), (s3, n3, m3, _) = runs
    half = mod.N_TERMS * rows.shape[0]
    # the scratch compared by its bits (the second half, unwritten by a
    # one-pass level, holds the NaN fill); the barrier's count of arrivals
    # at a multiple of the grid
    ok = (torch.equal(s1, s3) and torch.equal(n1, n3) and torch.equal(m1, m3)
          and torch.equal(s1, s2) and torch.equal(n1, n2) and torch.equal(m1, m2)
          and torch.equal(p1.view(torch.int64), p2.view(torch.int64))
          and torch.equal(p1[:half].view(mod.N_TERMS, -1).T, rows)
          and int(p1[-1:].view(torch.int64)[0]) % icp_gn.grid(kernel, rows.shape[0]) == 0)
    # where the bits differ (an inf on both sides is equal)
    max_err = float(torch.where(s1 == s3, 0.0, (s1 - s3).abs()).max().item())
    s, n, m, p = s0.clone(), r0.clone(), m0.clone(), partials.clone()

    def restore():
        s.copy_(s0)
        n.copy_(r0)
        m.copy_(m0)

    ms = time_ms(lambda: mod.iterate(*inputs, s, n, m, p, first=first, budget=budget), 50,
                 before=restore)
    plain_ms = time_ms(lambda: plain_level(s, n, m), 3, 1, before=restore)
    return {"ok": ok, "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "passes": int(n1) - int(r0), "budget": budget, "first": first,
            "more_after": bool(m1), "state": s1, "s0": s0}


def icp_gn_row(tag: str, call: tuple, launches: int, extra: dict | None = None) -> dict:
    """icp_gn_cuda, a pyramid level's loop in one launch, against its plain
    level loop on one recorded level (`gn_level_check`): the eager
    witness's last frame.  `ms` a launch, its `passes` and `ms_per_pass`.
    The bound: `passes` x a pass's (the depth, the reference-map pixels
    the pass reads at the level's start, each once, the state and the
    CTAs' rows; ICP_GN_F32_OPS and ICP_GN_F64_OPS a pixel)."""
    from gps_slam_torch import kernels
    from gps_slam_torch.slam import icp_gn

    c = gn_level_check("icp", call)
    depth, refv, refn, cam, rpi, st, tc, rot = call[0][:8]
    s0 = c["s0"]
    h, w = depth.shape
    N, C = h * w, icp_gn.n_ctas(h * w)
    texels = icp_gn_texels(depth, refv, cam, s0[:16].view(4, 4), rpi)
    # depth, the two maps' pixels read (3 f32 each), cam, w2c, the two
    # thresholds, the state in and out, the CTAs' rows out and in: a pass
    n_bytes = (N * 4 + 2 * texels * 12 + (8 + 16 + 2) * 4 + 2 * icp_gn.STATE_SIZE * 4
               + 2 * C * icp_gn.N_TERMS * 8)
    b, by = bound_ms(n_bytes, N * ICP_GN_F32_OPS, N * ICP_GN_F64_OPS)
    passes = c["passes"]
    row = {"name": kernels.ICP_GN.name + f" ({tag})", "tpu": None,
           "design": kernels.ICP_GN.design, "route": "cuda",
           "source": "gps_slam_torch/csrc/icp_gn.cu",
           "replaces": "gps_slam_tpu/slam/tracker.py:150-233 (XLA)",
           "launches": launches, "max_abs_err": c["max_abs_err"], "ms": c["ms"],
           "plain_ms": c["plain_ms"], "bound_ms": passes * b, "bound_by": by,
           "library_ms": None, "ok": c["ok"], "passes": passes,
           "ms_per_pass": c["ms"] / max(passes, 1), "bound_ms_per_pass": b,
           "budget": c["budget"], "more_after": c["more_after"],
           "bytes_per_pass": n_bytes, "f32_ops_per_pass": N * ICP_GN_F32_OPS,
           "f64_ops_per_pass": N * ICP_GN_F64_OPS,
           "shapes": {"h": h, "w": w, "ref": list(refv.shape[:2]), "texels_read": texels,
                      "rotation_only": bool(rot), "ctas": C,
                      "pixels_per_thread": icp_gn.PIX * icp_gn.rounds(N),
                      "inliers": round(float(c["state"][77].item()) * N)},
           "tolerance": "the level from its start: state, count, loop test and the last "
                        "pass's per-CTA rows bit for bit with the plain level loop; a "
                        "second launch the same bits",
           **(extra or {})}
    log("[kernel] " + json.dumps(row))
    if not c["ok"] or passes < 1:
        raise RuntimeError(f"icp_gn_cuda disagrees with its plain level loop: {row}")
    return row


# f32 and f64 operations of color_gn_cuda a point, counted from its
# expressions: the camera point and projection (~30), three 4-corner
# bilinear reads of 3 channels (~80 each), the residual, the projection
# Jacobians and their cross products (~40), J over 3 channels x 6 (54);
# the 36 + 6 entries of the system summed over 3 channels in f64 (~210),
# conversions and the sums' adds (~90)
COLOR_GN_F32_OPS, COLOR_GN_F64_OPS = 390, 300


def color_gn_texels(pts, rgb, cam, M) -> int:
    """The image pixels that one colour pass reads in each of its three
    images: the 4 bilinear corners of every point's projection (the plain
    version's arithmetic), distinct."""
    from gps_slam_torch.slam import icp_gn

    h, w = rgb.shape[:2]
    pc = icp_gn._affine(M, *pts.unbind(1))
    z = torch.clamp(pc[2], min=1e-6)
    u = torch.clamp(cam[0] * pc[0] / z + cam[2], 0.0, w - 1.0).floor().long()
    v = torch.clamp(cam[1] * pc[1] / z + cam[3], 0.0, h - 1.0).floor().long()
    u1, v1 = torch.clamp(u + 1, max=w - 1), torch.clamp(v + 1, max=h - 1)
    idx = torch.cat([v * w + u, v * w + u1, v1 * w + u, v1 * w + u1])
    return int(torch.unique(idx).numel())


def color_gn_row(tag: str, call: tuple, launches: int, extra: dict | None = None) -> dict:
    """color_gn_cuda, a colour pyramid level's loop in one launch, against
    its plain level loop on one recorded level (`gn_level_check`): the
    colour tracked path's last frame.  `ms` a launch, its `passes` and
    `ms_per_pass`.  The bound: `passes` x a pass's (the points, colours
    and flags, the three images' pixels the pass reads at the level's
    start, each once, the state and the CTAs' rows; COLOR_GN_F32_OPS and
    COLOR_GN_F64_OPS a point)."""
    from gps_slam_torch import kernels
    from gps_slam_torch.slam import color_gn, icp_gn

    c = gn_level_check("color", call)
    pts, col, valid, rgb, gx, gy, cam, rot = call[0][:8]
    s0 = c["s0"]
    h, w = rgb.shape[:2]
    N, C = pts.shape[0], icp_gn.n_ctas(pts.shape[0])
    texels = color_gn_texels(pts, rgb, cam, s0[:16].view(4, 4))
    # points, colours and flags; the three images' pixels read (3 f32
    # each); cam; the state in and out; the CTAs' rows out and in: a pass
    n_bytes = (N * (12 + 12 + 1) + 3 * texels * 12 + 4 * 4 + 2 * color_gn.STATE_SIZE * 4
               + 2 * C * color_gn.N_TERMS * 8)
    b, by = bound_ms(n_bytes, N * COLOR_GN_F32_OPS, N * COLOR_GN_F64_OPS)
    passes = c["passes"]
    row = {"name": kernels.COLOR_GN.name + f" ({tag})", "tpu": None,
           "design": kernels.COLOR_GN.design, "route": "cuda",
           "source": "gps_slam_torch/csrc/color_gn.cu",
           "replaces": "gps_slam_tpu/slam/tracker.py:322-388 (XLA)",
           "launches": launches, "max_abs_err": c["max_abs_err"], "ms": c["ms"],
           "plain_ms": c["plain_ms"], "bound_ms": passes * b, "bound_by": by,
           "library_ms": None, "ok": c["ok"], "passes": passes,
           "ms_per_pass": c["ms"] / max(passes, 1), "bound_ms_per_pass": b,
           "budget": c["budget"], "more_after": c["more_after"],
           "bytes_per_pass": n_bytes, "f32_ops_per_pass": N * COLOR_GN_F32_OPS,
           "f64_ops_per_pass": N * COLOR_GN_F64_OPS,
           "shapes": {"points": N, "image": [h, w], "texels_read": texels,
                      "rotation_only": bool(rot), "ctas": C,
                      "points_per_thread": icp_gn.PIX * icp_gn.rounds(N),
                      "inliers": round(float(c["state"][35].item()) * N)},
           "tolerance": "the level from its start: state, count, loop test and the last "
                        "pass's per-CTA rows bit for bit with the plain level loop; a "
                        "second launch the same bits",
           **(extra or {})}
    log("[kernel] " + json.dumps(row))
    if not c["ok"] or passes < 1:
        raise RuntimeError(f"color_gn_cuda disagrees with its plain level loop: {row}")
    return row


def color_tracker_fixture_phase() -> dict:
    """`[color tracker fixture]`: tests/test_tracking.py's colour test
    (test_color_tracker_converges: 160x120, the old view's exact world
    points from compute_vertex_map and its colours as the maps, the new
    rgb rendered 2.2 cm away) through ColorTracker on the card: not
    FAILED, the translation error at most half the initial one (so its
    accept steps moved the pose), `color_gn_cuda` launched once a level;
    beside it the same inputs on the CPU (pose difference printed)."""
    from gps_slam_torch import kernels
    from gps_slam_torch.config import Config
    from gps_slam_torch.data import synthetic
    from gps_slam_torch.slam import tracker as trk
    from gps_slam_torch.utils import se3 as tse3

    W, H = 160, 120
    cams = synthetic.make_cameras(n_frames=2, width=W, height=H, look="in")
    cam = cams[0]
    cfg = Config.from_dict(small_config(cams, tracked=True))
    true_pose = cam.c2w.copy()
    true_pose[:3, 3] += np.array([0.012, 0.0, 0.018], np.float32)
    rgb_new, _ = synthetic.render_frame(true_pose, W, H, cam.fx, cam.fy, cam.cx, cam.cy)
    res = {}
    for dev in ("cuda", "cpu"):
        vm = tse3.compute_vertex_map(torch.as_tensor(cam.depth[..., 0], device=dev),
                                     cam.fx, cam.fy, cam.cx, cam.cy)
        c2w = torch.as_tensor(cam.c2w, device=dev)
        vw = (vm.reshape(-1, 3) @ c2w[:3, :3].T + c2w[:3, 3]).reshape(vm.shape)
        maps = {"vertex_map": vw, "color_map": torch.as_tensor(cam.image, device=dev)}
        tr = trk.ColorTracker(cfg, W, H)
        n0 = kernels.COLOR_GN.launches
        t = time.monotonic()
        est, q = tr.track(cam.c2w, None, maps, cam.K,
                          rgb=torch.as_tensor(rgb_new, device=dev))
        res[dev] = {"quality": q, "est": est, "ms": (time.monotonic() - t) * 1e3,
                    "iters": tr.last_iters, "inlier": tr.last_inlier,
                    "residual": tr.last_residual,
                    "launches": kernels.COLOR_GN.launches - n0}
    err0 = float(np.linalg.norm(cam.c2w[:3, 3] - true_pose[:3, 3]))
    card = res["cuda"]
    out = {"width": W, "height": H, "quality": card["quality"],
           "quality_cpu": res["cpu"]["quality"],
           "translation_err_cm": {"before": err0 * 100, "after": float(np.linalg.norm(
               card["est"][:3, 3] - true_pose[:3, 3])) * 100},
           "iters_per_level": card["iters"], "iters_per_level_cpu": res["cpu"]["iters"],
           "inlier": card["inlier"], "residual": card["residual"],
           "color_gn_launches": card["launches"], "ms": card["ms"],
           "pose_diff_card_cpu": float(np.abs(card["est"] - res["cpu"]["est"]).max()),
           "gate": "not FAILED; translation error <= half the initial 2.2 cm; "
                   "color_gn_cuda once a level"}
    log("[color tracker fixture] " + json.dumps(out))
    err = out["translation_err_cm"]
    if (card["quality"] == trk.TrackerQuality.FAILED
            or not err["after"] <= 0.5 * err["before"]
            or card["launches"] != len(card["iters"]) or res["cpu"]["launches"] != 0):
        raise RuntimeError(f"color tracker fixture: {out}")
    return out


def gn_launches(*caches) -> dict:
    """Each Gauss-Newton kernel's launches so far, a graph replay's (of the
    GraphCaches `caches`, None skipped) counted as its capture's."""
    from gps_slam_torch import kernels

    return {k.name: k.launches + sum(g.replayed_launches[k.name] for g in caches
                                     if g is not None)
            for k in (kernels.ICP_GN, kernels.COLOR_GN)}


def check_gn_launches(tag: str, before: dict, after: dict, icp: int, color: int = 0) -> dict:
    """Raise unless icp_gn_cuda and color_gn_cuda launched `icp` and
    `color` times between the counts `before` and `after` (`gn_launches`):
    once a level run, not once a pass."""
    got = {k: after[k] - before[k] for k in after}
    want = {"icp_gn_cuda": icp, "color_gn_cuda": color}
    if got != want:
        raise RuntimeError(f"{tag}: Gauss-Newton launches {got}, not one a level run: {want}")
    return got


def tracking_fixture_phase() -> dict:
    """tests/test_tracking.py's three tracking fixtures (TRACK_FIXTURES) on
    the card, on both tracked routes (the megastep: a graph captured once
    and replayed each frame; the eager route), each held to that file's
    gates: the port's tracking-prepare raycast on the JAX XLA march's
    semantics meets them where the TPU kernel's semantics ended 8.5-17 cm
    off the last pose."""
    from gps_slam_torch.config import Config
    from gps_slam_torch.data import synthetic
    from gps_slam_torch.eval import metrics
    from gps_slam_torch.slam import tracker as trk
    from gps_slam_torch.tsdf.engine import TsdfEngine

    W, H = 160, 120
    res, bad = {}, []
    for name, n, arc, noisy in TRACK_FIXTURES:
        cams = synthetic.make_cameras(n_frames=n, width=W, height=H, look="in", arc=arc)
        depths = [c.depth for c in cams]
        if noisy:
            rng = np.random.default_rng(7)
            depths = []
            for c in cams:
                d = np.asarray(c.depth).copy()
                d += rng.normal(0.0, 0.005, d.shape).astype(np.float32)
                d[rng.random(d.shape) < 0.10] = 0.0
                depths.append(np.maximum(d, 0.0))
        cfg = Config.from_dict(small_config(cams, tracked=True))
        vox = cfg.pipe.tsdf.voxel_size
        for route in ("megastep", "eager"):
            e = TsdfEngine(cfg, W, H, cams[0].K, device="cuda")
            if route == "eager":
                e._can_fast_track = lambda: False
            e.set_gt_poses([cams[0].c2w])
            e.attach_tracker(trk.ICPTracker(cfg, W, H))
            q = []
            n0 = gn_launches()
            t = time.monotonic()
            for c, d in zip(cams, depths):
                e.process_frame(c.image, d)
                q.append(e._tracking_quality)
            ms = (time.monotonic() - t) * 1e3 / n
            # one icp_gn_cuda launch a level of each tracked frame
            gn = check_gn_launches(f"tracking fixture {name}, {route}", n0,
                                   gn_launches(e._track_graphs),
                                   e._tracker.n_levels * (n - 1))
            gt = [c.c2w for c in cams]
            est = e.cam_poses
            R = est[-1][:3, :3].T @ gt[-1][:3, :3]
            r = {"ate_cm": metrics.ate_rmse_cm(est, gt),
                 "last_translation_err_cm": float(np.linalg.norm(
                     est[-1][:3, 3] - gt[-1][:3, 3]) * 100),
                 "last_rotation_err_deg": float(np.degrees(np.arccos(
                     np.clip((np.trace(R) - 1) / 2, -1, 1)))),
                 "good": sum(x == trk.TrackerQuality.GOOD for x in q[1:]),
                 "failed": sum(x == trk.TrackerQuality.FAILED for x in q[1:]),
                 "tracked_frames": n - 1, "ms_per_frame": ms, "gn_launches": gn,
                 "graphs": (None if e._track_graphs is None else
                            {"captures": e._track_graphs.captures,
                             "replays": e._track_graphs.replays})}
            if noisy:
                ok = (r["ate_cm"] < STRESS_ATE_MAX_VOXELS * vox * 100
                      and r["failed"] <= STRESS_FAILED_MAX_SHARE * (n - 1))
            else:
                ok = (r["ate_cm"] < ATE_MAX_VOXELS * vox * 100
                      and r["last_translation_err_cm"] < LAST_MAX_VOXELS * vox * 100
                      and r["last_rotation_err_deg"] < LAST_MAX_DEG
                      and r["good"] >= GOOD_MIN_SHARE * (n - 1))
            r["ok"] = ok
            res[f"{name}, {route}"] = r
            if not ok:
                bad.append(f"{name}, {route}")
    res["gates"] = {
        "plain": f"ATE < {ATE_MAX_VOXELS} voxels, last pose < {LAST_MAX_VOXELS} voxels "
                 f"and {LAST_MAX_DEG} deg, GOOD >= {GOOD_MIN_SHARE} of tracked frames",
        "stress": f"ATE < {STRESS_ATE_MAX_VOXELS} voxels, FAILED <= "
                  f"{STRESS_FAILED_MAX_SHARE} of tracked frames", "voxel_cm": vox * 100}
    log("[tracking fixture] " + json.dumps(res))
    if bad:
        raise RuntimeError(f"tracking fixtures outside tests/test_tracking.py's gates: {bad}")
    return res


def raycast_vs_gt(engine, cam) -> tuple[float, float]:
    """(mean |depth - gt| over pixels both hit, their share) of a raycast
    from `cam`'s pose: tests/test_swapping.py's measure."""
    d = engine.run_raycast(cam.c2w, cam.K, cam.width, cam.height)["depth_map"]
    d = d[..., 0].cpu().numpy()
    gt = cam.depth[..., 0]
    both = (d > 0) & (gt > 0)
    return float(np.abs(d - gt)[both].mean()), float(both.mean())


def swap_path(args) -> dict:
    """The swap path (phase 7): gt-pose `train` at 1200x680 on a full
    outward turn with the block pool cut to SWAP_TPU's 16,384 rows, host
    swapping on; then the same frames fused into a pool of 2^17 blocks
    (no swapping, no Gaussians), and a raycast from pose 0 of both held to
    tests/test_swapping.py's gates."""
    from gps_slam_torch import kernels
    from gps_slam_torch.config import Config
    from gps_slam_torch.tsdf.engine import TsdfEngine

    cams = synthetic_cams(SWAP_FRAMES, 1200, 680, arc=1.0)
    out, engine, _ = run_path(args, cams, ADAM_STEPS, "swap path", kernels.INTEGRATE,
                              swap=SWAP_TPU)
    if out["adam_steps"] != ADAM_STEPS * out["windows"]:
        raise RuntimeError(f"swap path ran {out['adam_steps']} Adam steps")
    W, H = cams[0].width, cams[0].height
    d = bench_config(len(cams), W, H, cams[0], ADAM_STEPS)
    d["TPU"]["block_capacity"] = SWAP_BIG_POOL
    big = TsdfEngine(Config.from_dict(d), W, H, cams[0].K, device="cuda")
    big.set_gt_poses([c.c2w for c in cams])
    big.turn_off_tracking()
    for c in cams:
        big.process_frame(c.image, c.depth)
    e_swap, cov_swap = raycast_vs_gt(engine, cams[0])
    e_big, cov_big = raycast_vs_gt(big, cams[0])
    res = {"depth_err_m": e_swap, "coverage": cov_swap, "big_pool_depth_err_m": e_big,
           "big_pool_coverage": cov_big, "big_pool_blocks": big.vol.n_blocks,
           "block_capacity": SWAP_TPU["block_capacity"],
           "tolerance": "error < max(3 x the big pool's, 1 cm); coverage > 0.8 x"}
    log("[swap roundtrip] " + json.dumps(res))
    if not (e_swap < max(3.0 * e_big, 0.01) and cov_swap > 0.8 * cov_big
            and big.vol.n_blocks > SWAP_TPU["block_capacity"]):
        raise RuntimeError("swap path: the raycast after the turn lost the view")
    out["roundtrip"] = res
    return out


def offline_config(cams, method: str, iters: int) -> dict:
    """bench.py's configuration with the offline trainer's settings:
    `render_method` and PIPE.max_iterations; the raw method densifies
    (start, interval and end of OFFLINE_DENSIFY, every other knob at its
    release value)."""
    d = bench_config(len(cams), cams[0].width, cams[0].height, cams[0], ADAM_STEPS)
    d["MODEL"]["render_method"] = method
    d["PIPE"]["max_iterations"] = iters
    d["PIPE"]["enable_densify"] = method == "raw"
    if method == "raw":
        d["MODEL"].update(OFFLINE_DENSIFY)
    return d


def offline_raw_phase(args, cams) -> dict:
    """The offline raw trainer (phase 8) at 1200x680 on the main path's
    cameras: the Gaussians of frame 0's backprojection at a pixel stride
    that gives at most 16,384 (bench.py's spawn cap), OFFLINE_RAW_ITERS
    iterations with densify; camera 0's PSNR must rise by more than 1 dB
    (tests/test_raw_mode.py's gate) and densify must add or prune rows."""
    from gps_slam_torch.config import Config
    from gps_slam_torch.gs import densify as dmod
    from gps_slam_torch.gs import losses
    from gps_slam_torch.gs import model as gmodel
    from gps_slam_torch.gs.model import GaussianModel
    from gps_slam_torch.slam.offline import OfflinePipeline

    W, H = cams[0].width, cams[0].height
    cfg = Config.from_dict(offline_config(cams, "raw", OFFLINE_RAW_ITERS))
    model = GaussianModel(cfg, W, H, device="cuda")
    model._rng.manual_seed(args.seed)
    fm = cams[0].get_frame_maps(device="cuda")
    stride = next(s for s in range(1, 64) if -(-W // s) * -(-H // s) <= 16384)
    mask = torch.zeros((H, W), dtype=torch.bool, device="cuda")
    mask[::stride, ::stride] = True
    gmodel.add_gaussians(model.pool, fm["vertex_map"], fm["color_map"], fm["normal_map"],
                         mask, 1.0, 16384, cfg.model.default_opacities,
                         (cfg.model.min_init_scale, cfg.model.max_init_scale),
                         model.next_rng())
    n0 = model.num_gaussians
    cam0 = cams[0]
    gt0 = torch.as_tensor(cam0.image, device="cuda")

    def psnr0():
        with torch.no_grad():
            r = gmodel.raw_forward(model.pool.params, model.pool.alive,
                                   torch.as_tensor(cam0.c2w, device="cuda"), cam0.K, 0,
                                   model.statics)
        return float(losses.psnr(torch.clamp(r["rgb"], 0, 1), gt0))

    rounds, step = [], dmod.densify_step

    def densify(pool, *a, **kw):
        n_before = pool.n_alive
        out = step(pool, *a, **kw)
        rounds.append({**out[2], "alive_before": n_before, "alive_after": pool.n_alive})
        return out

    p0 = psnr0()
    pipe = OfflinePipeline(cfg, cfg.workspace_dir)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dmod.densify_step = densify
    try:
        t0 = time.monotonic()
        pipe.raw_train_cams(model, cams)
        torch.cuda.synchronize()
        train_s = time.monotonic() - t0
    finally:
        dmod.densify_step = step
    p1 = psnr0()
    out = {"width": W, "height": H, "cameras": len(cams), "iterations": OFFLINE_RAW_ITERS,
           **OFFLINE_DENSIFY, "spawn_stride": stride, "gaussians_before": n0,
           "gaussians_after": model.num_gaussians, "densify_rounds": rounds,
           "ms_per_iteration": train_s * 1e3 / OFFLINE_RAW_ITERS,
           "max_memory_allocated_mb": torch.cuda.max_memory_allocated() / 2 ** 20,
           "psnr_cam0_before": p0, "psnr_cam0_after": p1}
    log("[offline raw] " + json.dumps(out))
    if not p1 > p0 + 1.0:
        raise RuntimeError(f"offline raw: camera 0's PSNR {p0} -> {p1}, not +1 dB")
    if not any(r["n_dup"] + r["n_split"] + r["n_pruned"] > 0 for r in rounds):
        raise RuntimeError(f"offline raw: densify changed no row: {rounds}")
    return out


def offline_ges_phase(args, engine, model, cams) -> dict:
    """The offline GES trainer (phase 9) at 1200x680: OFFLINE_GES_ITERS
    iterations from the main path's trained pool against its engine's
    raycasts of its training cameras.  K4 and K5 launch once per training
    iteration whose camera has an active tile (K4 also once per such log
    render); the L1 to the ground truth of the first camera that sees a
    Gaussian falls (tests/test_aux.py's gate, there on camera 0, which
    its spawn comes from: the main path spawns at its windows, and no
    Gaussian of its pool projects into camera 0); the eval views' PSNR
    does not fall."""
    from gps_slam_torch import kernels
    from gps_slam_torch.config import Config
    from gps_slam_torch.eval import metrics as M
    from gps_slam_torch.gs import model as gmodel
    from gps_slam_torch.slam.offline import OfflinePipeline

    cfg = Config.from_dict(offline_config(cams, "ges", OFFLINE_GES_ITERS))
    targets = []
    with torch.no_grad():
        for c in cams:
            m = engine.run_raycast(c.c2w, c.K)
            targets.append({"depth_map": m["depth_map"], "color_map": m["color_map"]})
    eval_ids = list(range(0, len(cams), 6))

    def render(i):
        with torch.no_grad():
            return model.forward(cams[i].c2w, cams[i].K, targets[i]["depth_map"],
                                 targets[i]["color_map"])

    l1_cam = next(i for i in range(len(cams)) if render(i)["n_pairs"] > 0)

    def renders():
        l1 = [float((render(i)["rgb"] - torch.as_tensor(cams[i].image, device="cuda"))
                    .abs().mean()) for i in (0, l1_cam)]
        psnr = float(np.mean([M.psnr(torch.clamp(render(i)["rgb"], 0, 1).cpu().numpy(),
                                     cams[i].image) for i in eval_ids]))
        return l1, psnr

    l1_0, psnr_0 = renders()
    active = {"train": 0, "log": 0}
    forward = gmodel.ges_forward

    def counted(*a, **kw):
        res = forward(*a, **kw)
        if res["n_pairs"] > 0:
            active["train" if torch.is_grad_enabled() else "log"] += 1
        return res

    pipe = OfflinePipeline(cfg, cfg.workspace_dir)
    torch.cuda.synchronize()
    gmodel.ges_forward = counted
    kernels.reset_counts()
    try:
        t0 = time.monotonic()
        pipe.ges_train_cams(model, cams, targets)
        torch.cuda.synchronize()
        train_s = time.monotonic() - t0
    finally:
        gmodel.ges_forward = forward
    launches = kernels.counts()
    l1_1, psnr_1 = renders()
    out = {"width": cams[0].width, "height": cams[0].height, "cameras": len(cams),
           "iterations": OFFLINE_GES_ITERS, "gaussians": model.num_gaussians,
           "ms_per_iteration": train_s * 1e3 / OFFLINE_GES_ITERS,
           "iterations_with_tiles": active["train"], "log_renders_with_tiles": active["log"],
           "l1_camera": l1_cam, "l1_before": l1_0[1], "l1_after": l1_1[1],
           "l1_cam0_before": l1_0[0], "l1_cam0_after": l1_1[0],
           "eval_psnr_before": psnr_0, "eval_psnr_after": psnr_1, "launches": launches}
    log("[offline ges] " + json.dumps(out))
    k4, k5 = launches[kernels.SPLAT_FWD.name], launches[kernels.SPLAT_BWD.name]
    if not (k5 == active["train"] > 0 and k4 == active["train"] + active["log"]):
        raise RuntimeError(f"offline ges: K4 {k4}, K5 {k5} for {active} active renders")
    if not l1_1[1] < l1_0[1]:
        raise RuntimeError(f"offline ges: camera {l1_cam}'s L1 {l1_0[1]} -> {l1_1[1]}")
    if not psnr_1 >= psnr_0:
        raise RuntimeError(f"offline ges: eval PSNR fell {psnr_0} -> {psnr_1}")
    return out


def mesh_phase(engine) -> dict:
    """The TSDF mesh of a path's volume (phase 11), by the native mesher and
    by the numpy route, each timed from the device volume (its host copy
    included)."""
    from gps_slam_torch.tsdf import meshing, native

    t0 = time.monotonic()
    native.load()
    build_s = time.monotonic() - t0
    times, meshes = {}, {}
    for route, use_native in (("native", True), ("numpy", False)):
        t0 = time.monotonic()
        meshes[route] = meshing.extract_mesh(engine.vol, use_native=use_native)
        times[route] = (time.monotonic() - t0) * 1e3
    (vn, cn), (vp, cp) = meshes["native"], meshes["numpy"]
    lib = native.loaded_path()
    res = {"route": "native", "library": lib.name,
           "openmp": lib == native.lib_path(native.VARIANTS[0]), "build_s": build_s,
           "n_blocks": engine.vol.n_blocks, "triangles_native": vn.shape[0] // 3,
           "triangles_numpy": vp.shape[0] // 3, "native_ms": times["native"],
           "numpy_ms": times["numpy"],
           "tolerance": f"equal triangle counts; sorted triangles within {MESH_TRI_ATOL} m, "
                        f"sorted colours within {MESH_COL_ATOL}"}
    same = vn.shape == vp.shape and vn.shape[0] > 0
    if same:
        res["max_triangle_diff"] = float(np.abs(np.sort(vn.reshape(-1, 9), 0)
                                                - np.sort(vp.reshape(-1, 9), 0)).max())
        res["max_color_diff"] = float(np.abs(np.sort(cn.reshape(-1, 9), 0)
                                             - np.sort(cp.reshape(-1, 9), 0)).max())
    log("[mesh] " + json.dumps(res))
    if not (same and res["max_triangle_diff"] <= MESH_TRI_ATOL
            and res["max_color_diff"] <= MESH_COL_ATOL):
        raise RuntimeError("the native and numpy meshes of the volume disagree")
    return res


def small_config(cams, tracked: bool = False, tsdf: dict | None = None,
                 tpu: dict | None = None) -> dict:
    """The synthetic config of the reference phases (`cams` at their size)."""
    from gps_slam_torch.data import synthetic

    c0 = cams[0]
    node = {"input_dir": "mem", "image_path": "c", "pose_path": "c", "depth_path": "d",
            "pcd_name": "n", "depth_scale": 6553.5, "scene_scale": 1.0,
            "start_frame": 0, "end_frame": len(cams) - 1, "frame_step": 1,
            "intrinsics": [c0.fx, c0.fy, c0.cx, c0.cy], "image_shape": [c0.width, c0.height],
            "downscale_factor": 1, "test_split_interval": -1}
    d = synthetic.default_config_dict("build/smoke_ws", node)
    d["PIPE"]["TSDF"]["use_gt_pose"] = not tracked
    d["PIPE"]["TSDF"].update(tsdf or {})
    d["TPU"].update(tpu or {})
    return d


def reference_chunked() -> dict:
    """`[reference chunked]`: the reference phase's fixtures (6 frames at
    128x96 on K1's route and, with `_RESIDENT_BYTES` lowered to 0, on the
    f32 route; 6 frames at 48x40) through the chunk route
    (`process_frames_gt`, one group of 6: on the card one capture of the
    fusion frame and 5 replays) on the card and on the CPU, with the
    reference phase's volume settings and gates: the same block keys and,
    by key, every state word's weights equal, sdf within 1 quantum and
    colour within 1."""
    from gps_slam_torch import kernels
    from gps_slam_torch.config import Config
    from gps_slam_torch.data import synthetic
    from gps_slam_torch.tsdf import integrate as tint
    from gps_slam_torch.tsdf.engine import TsdfEngine

    def fused(cams, dev):
        d = small_config(cams, tsdf={"voxel_size": 0.02, "trunc_dist": 0.08},
                         tpu={"hash_size": 1 << 16, "block_capacity": 1 << 13,
                              "visible_block_capacity": 1 << 12})
        e = TsdfEngine(Config.from_dict(d), cams[0].width, cams[0].height, cams[0].K,
                       device=dev)
        e.set_gt_poses([c.c2w for c in cams])
        e.turn_off_tracking()
        kernels.reset_counts()
        e.process_frames_gt([(torch.as_tensor(c.image, device=dev),
                              torch.as_tensor(c.depth[..., 0], device=dev)) for c in cams])
        return e

    res = {}
    for tag, (w, h), budget, k in (("K1 route", (128, 96), None, kernels.INTEGRATE),
                                    ("f32 route", (128, 96), 0, kernels.INTEGRATE_F32),
                                    ("narrow", (48, 40), None, None)):
        cams = synthetic.make_cameras(n_frames=6, width=w, height=h)
        saved = tint._RESIDENT_BYTES
        if budget is not None:
            tint._RESIDENT_BYTES = budget
        try:
            card = fused(cams, "cuda")
            launches = kernels.counts()
            cpu = fused(cams, "cpu")
        finally:
            tint._RESIDENT_BYTES = saved
        g = card._fusion_graphs
        for name, n in g.replayed_launches.items():
            launches[name] += n
        r = {**state_diff(by_key(card.vol), by_key(cpu.vol)), "width": w, "height": h,
             "captures": g.captures, "replays": g.replays,
             "integrate_launches": {n: launches[n] for n in (kernels.INTEGRATE.name,
                                                             kernels.INTEGRATE_F32.name)}}
        want = {n: (6 if k is not None and n == k.name else 0)
                for n in r["integrate_launches"]}
        r["ok"] = (r["ok"] and (g.captures, g.replays) == (1, 5)
                   and r["integrate_launches"] == want)
        res[tag] = r
    log("[reference chunked] " + json.dumps(res))
    if not all(r["ok"] for r in res.values()):
        raise RuntimeError("the card's chunked fusion disagrees with the CPU reference")
    return res


def reference_tracked_megastep() -> dict:
    """`[tracked megastep reference]`: the `[reference tracked]` fixture's
    first 4 frames (128x96) on two card engines: frame 0 eager, then the
    tracked megastep, on one as its graph (a capture, then 2 replays), on
    the other uncaptured: poses, quality labels, iteration counts, the
    volumes and the last prepare raycast's maps bit for bit; on every
    megastep frame the graph's iterations per level (its level kernels')
    equal to the eager loop's on the same inputs, and not the budgets."""
    from gps_slam_torch.config import Config
    from gps_slam_torch.data import synthetic
    from gps_slam_torch.slam import tracker as trk
    from gps_slam_torch.slam.tracker import ICPTracker
    from gps_slam_torch.tsdf.engine import TsdfEngine
    from gps_slam_torch.utils.se3 import bilateral_filter_depth, pose_inv

    W, H = 128, 96
    cams = synthetic.make_cameras(n_frames=8, width=W, height=H, look="in", arc=0.0125)[:4]
    cfg = Config.from_dict(small_config(cams, tracked=True))
    engines = []
    for captured in (True, False):
        e = TsdfEngine(cfg, W, H, cams[0].K, device="cuda")
        e.set_gt_poses([cams[0].c2w])
        e.attach_tracker(ICPTracker(cfg, W, H))
        if not captured:
            e._track_graphs = None
        engines.append(e)
    ms_, labels = {0: [], 1: []}, {0: [], 1: []}
    e = engines[0]
    tr = e._tracker
    eager_iters = []   # the eager loop on each megastep frame's inputs
    n0 = gn_launches()
    for k, c in enumerate(cams):
        if k > 0:
            T_prev = e._last_pose_dev.clone()
            maps = {n: e._last_raycast_for_tracking[n].clone()
                    for n in ("vertex_map", "normal_map")}
        for i, eng in enumerate(engines):
            torch.cuda.synchronize()
            t = time.monotonic()
            eng.process_frame(c.image, c.depth)
            ms_[i].append((time.monotonic() - t) * 1e3)
            labels[i].append((eng._tracking_quality, eng._tracker.last_iters))
        if k > 0:
            d = torch.as_tensor(c.depth[..., 0], dtype=torch.float32, device="cuda")
            if e.use_bilateral_filter:
                d = bilateral_filter_depth(d)
            eager_iters.append(trk.track_pyramid(
                T_prev, d, maps["vertex_map"], maps["normal_map"], e.K, pose_inv(T_prev),
                tuple(tr.level_iters), tr.space_thresh, tr.tukey_c)[3])
    g, ref = e._track_graphs, engines[1]
    # one icp_gn_cuda launch a level run: each engine's megastep frames and
    # the eager loop beside them
    gn = check_gn_launches("tracked megastep reference", n0, gn_launches(g),
                           tr.n_levels * 3 * (len(cams) - 1))
    graph_iters = [it for _, it in labels[0][1:]]
    fields = ("table_keys", "table_ptrs", "block_coords", "state", "color", "summary")
    res = {"width": W, "height": H, "frames": len(cams),
           "captures": g.captures, "replays": g.replays, "graph_mb": g.memory_bytes / 2 ** 20,
           "graph_frame_ms": ms_[0][1:], "uncaptured_frame_ms": ms_[1][1:],
           "labels_equal": labels[0] == labels[1], "labels": [q for q, _ in labels[0]],
           "graph_nodes": g.node_counts,
           # per megastep frame: the replay's iterations per level (finest
           # first), the eager loop's on the same inputs, the budgets
           "gn_iters": graph_iters, "gn_iters_eager": eager_iters,
           "gn_iters_budget": list(tr.level_iters), "gn_launches": gn,
           "poses_equal": bool(np.array_equal(np.stack(e.cam_poses), np.stack(ref.cam_poses))),
           "not_equal": [k for k in fields if not torch.equal(getattr(e.vol, k),
                                                                getattr(ref.vol, k))]
           + [k for k in ("vertex_map", "normal_map")
              if not torch.equal(e._last_raycast_for_tracking[k],
                                 ref._last_raycast_for_tracking[k])]}
    log("[tracked megastep reference] " + json.dumps(res))
    if not ((g.captures, g.replays) == (1, 2) and res["labels_equal"] and res["poses_equal"]
            and not res["not_equal"] and graph_iters == eager_iters
            and all(it != list(tr.level_iters) for it in graph_iters)):
        raise RuntimeError(f"tracked megastep reference: {res}")
    return res


def reference_tracked() -> dict:
    """The tracked loop at 128x96 (8 frames, look="in", ~1.6 cm a frame,
    2 cm voxels) on the card and on the CPU, in lockstep: the card engine
    fuses at the CPU engine's poses, so both track every frame against maps
    of the same history; each frame's two estimates are compared.  ICP
    answers the card's raycast differences (hit masks equal, depths within
    1e-4 of the plain march) within a millimetre except on a frame where a
    Levenberg-Marquardt accept/reject flips: equal quality labels, every
    frame within 1 voxel and 0.1 degree, all but one within 1 mm."""
    from gps_slam_torch.config import Config
    from gps_slam_torch.data import synthetic
    from gps_slam_torch.slam.tracker import ICPTracker
    from gps_slam_torch.tsdf.engine import TsdfEngine

    W, H, N = 128, 96, 8
    cams = synthetic.make_cameras(n_frames=N, width=W, height=H, look="in", arc=0.0125)
    c0 = cams[0]
    cfg = Config.from_dict(small_config(cams, tracked=True))
    cpu = TsdfEngine(cfg, W, H, c0.K, device="cpu")
    card = TsdfEngine(cfg, W, H, c0.K, device="cuda")
    for e in (cpu, card):
        e.set_gt_poses([c0.c2w])
    cpu.attach_tracker(ICPTracker(cfg, W, H))
    tracker, own = ICPTracker(cfg, W, H), []

    class Lockstep:
        needs_color = False

        def track(self, last_pose, depth, maps, K, rgb=None):
            own.append(tracker.track(last_pose, depth, maps, K))
            return cpu.cam_poses[len(own)], own[-1][1]

    card.attach_tracker(Lockstep())
    q_cpu = []
    n0 = gn_launches()
    for c in cams:
        cpu.process_frame(c.image, c.depth)
        q_cpu.append(cpu._tracking_quality)
        card.process_frame(c.image, c.depth)
    # one icp_gn_cuda launch a level of each card-tracked frame (the CPU's
    # run the plain version)
    gn = check_gn_launches("reference tracked", n0, gn_launches(),
                           tracker.n_levels * len(own))
    d_mm, d_deg = [], []
    for k, (pose, _) in enumerate(own, 1):
        ref = cpu.cam_poses[k]
        d_mm.append(float(np.linalg.norm(pose[:3, 3] - ref[:3, 3]) * 1e3))
        R = pose[:3, :3].T @ ref[:3, :3]
        d_deg.append(float(np.degrees(np.arccos(np.clip((np.trace(R) - 1) / 2, -1, 1)))))
    vox_mm = cfg.pipe.tsdf.voxel_size * 1e3
    res = {"width": W, "height": H, "frames": N, "max_pose_diff_mm": max(d_mm),
           "max_pose_diff_deg": max(d_deg), "pose_diff_mm": d_mm,
           "frames_over_1mm": sum(v > 1.0 for v in d_mm), "gn_launches": gn,
           "labels_equal": [q for _, q in own] == q_cpu[1:], "labels_cpu": q_cpu[1:],
           "tolerance": f"labels equal; every frame within {vox_mm} mm (1 voxel) and "
                        "0.1 deg, all but one within 1 mm"}
    log("[reference tracked] " + json.dumps(res))
    if not (res["labels_equal"] and res["max_pose_diff_mm"] < vox_mm
            and res["max_pose_diff_deg"] < 0.1 and res["frames_over_1mm"] <= 1):
        raise RuntimeError("the card's tracked loop disagrees with the CPU's")
    return res


def _stage_log(comp) -> list:
    """Wraps each stage of a composite tracker to log (stage, label,
    iterations per level) per call; returns the log."""
    got = []
    for t in comp.trackers:
        def track(*a, _track=t.track, _t=t, **kw):
            pose, q = _track(*a, **kw)
            got.append((type(_t).__name__, q, list(_t.last_iters)))
            return pose, q
        t.track = track
    return got


def reference_color_tracked() -> dict:
    """`[reference color tracked]`: the composite tracker (colour refine,
    then ICP) on `[reference tracked]`'s loop (128x96, 8 frames, look="in",
    2 cm voxels) on the card and on the CPU in lockstep: the card engine
    fuses at the CPU engine's poses, and each frame the card's composite
    tracks on the card's own maps and, beside it, on the CPU engine's maps
    moved to the card (the same inputs, so only the trackers' devices
    differ).  Gates: equal labels of both stages on both; on the same maps
    the colour stage's iterations per level equal to the CPU's; each
    frame's estimates within 1 voxel and 0.1 degree of the CPU's.  The
    ICP stage's iterations are printed, not held: its se3_exp takes sin
    and cos from each device's library, and an accept/reject on last bits
    may then turn (one level of 28 did once, on the CPU's maps)."""
    from gps_slam_torch.config import Config
    from gps_slam_torch.data import synthetic
    from gps_slam_torch.slam.tracker import make_tracker
    from gps_slam_torch.tsdf.engine import TsdfEngine

    W, H, N = 128, 96, 8
    cams = synthetic.make_cameras(n_frames=N, width=W, height=H, look="in", arc=0.0125)
    c0 = cams[0]
    cfg = Config.from_dict(small_config(cams, tracked=True,
                                        tsdf={"tracker": {"type": "composite"}}))
    cpu = TsdfEngine(cfg, W, H, c0.K, device="cpu")
    card = TsdfEngine(cfg, W, H, c0.K, device="cuda")
    for e in (cpu, card):
        e.set_gt_poses([c0.c2w])
    cpu_trk, own_trk, same_trk = (make_tracker(cfg, W, H) for _ in range(3))
    logs = {name: _stage_log(t) for name, t in (("cpu", cpu_trk), ("card", own_trk),
                                                  ("card, CPU maps", same_trk))}
    inputs, poses = [], {"card": [], "card, CPU maps": []}
    cpu_track = cpu_trk.track

    def keep(last_pose, depth, maps, K, rgb=None):
        inputs.append((last_pose, depth, maps, rgb))
        return cpu_track(last_pose, depth, maps, K, rgb=rgb)

    cpu_trk.track = keep
    cpu.attach_tracker(cpu_trk)

    class Lockstep:
        needs_color = True

        def track(self, last_pose, depth, maps, K, rgb=None):
            poses["card"].append(own_trk.track(last_pose, depth, maps, K, rgb=rgb)[0])
            lp, d, m, c = inputs[-1]
            moved = {k: v.to("cuda") for k, v in m.items() if torch.is_tensor(v)}
            poses["card, CPU maps"].append(same_trk.track(lp, d.to("cuda"), moved, K,
                                                          rgb=c.to("cuda"))[0])
            return cpu.cam_poses[len(poses["card"])], cpu._tracking_quality

    card.attach_tracker(Lockstep())
    n0 = gn_launches()
    for c in cams:
        cpu.process_frame(c.image, c.depth)
        card.process_frame(c.image, c.depth)
    # each Gauss-Newton kernel once a level of each of the card's stage
    # runs, every stage run on each frame by both card trackers
    levels = {type(t).__name__: t.n_levels for t in own_trk.trackers}
    calls = [x[0] for name in ("card", "card, CPU maps") for x in logs[name]]
    if any(calls.count(stage) != 2 * (N - 1) for stage in levels):
        raise RuntimeError(f"reference color tracked: stage runs {calls}")
    gn = check_gn_launches("reference color tracked", n0, gn_launches(),
                           levels["ICPTracker"] * calls.count("ICPTracker"),
                           levels["ColorTracker"] * calls.count("ColorTracker"))
    vox_mm = cfg.pipe.tsdf.voxel_size * 1e3
    res = {"width": W, "height": H, "frames": N, "gn_launches": gn}
    ok = True
    for name in ("card", "card, CPU maps"):
        d_mm, d_deg = [], []
        for k, pose in enumerate(poses[name], 1):
            ref = cpu.cam_poses[k]
            d_mm.append(float(np.linalg.norm(pose[:3, 3] - ref[:3, 3]) * 1e3))
            R = pose[:3, :3].T @ ref[:3, :3]
            d_deg.append(float(np.degrees(np.arccos(np.clip((np.trace(R) - 1) / 2, -1, 1)))))
        lg, ref_lg = logs[name], logs["cpu"]
        labels_equal = [x[:2] for x in lg] == [x[:2] for x in ref_lg]
        iters_equal = {stage: [x[2] for x in lg if x[0] == stage]
                       == [x[2] for x in ref_lg if x[0] == stage]
                       for stage in ("ColorTracker", "ICPTracker")}
        res[name] = {"labels_equal": labels_equal, "iters_equal": iters_equal,
                     "labels": [x[1] for x in lg],
                     "color_iters": [x[2] for x in lg if x[0] == "ColorTracker"],
                     "icp_iters": [x[2] for x in lg if x[0] == "ICPTracker"],
                     "max_pose_diff_mm": max(d_mm), "max_pose_diff_deg": max(d_deg),
                     "pose_diff_mm": d_mm}
        ok &= labels_equal and max(d_mm) < vox_mm and max(d_deg) < 0.1
    res["cpu"] = {"labels": [x[1] for x in logs["cpu"]],
                  "color_iters": [x[2] for x in logs["cpu"] if x[0] == "ColorTracker"],
                  "icp_iters": [x[2] for x in logs["cpu"] if x[0] == "ICPTracker"]}
    ok &= res["card, CPU maps"]["iters_equal"]["ColorTracker"]
    res["tolerance"] = (f"labels of both stages equal on both; on the CPU's maps the colour "
                        f"stage's iterations per level equal; every frame within {vox_mm} mm "
                        "(1 voxel) and 0.1 deg")
    log("[reference color tracked] " + json.dumps(res))
    if not ok:
        raise RuntimeError("the card's composite tracker disagrees with the CPU's")
    return res


def reference_swap() -> dict:
    """tests/test_swapping.py's fixture (a full outward turn, 24 frames at
    128x96, 1024-block pool, check every 2 frames, waters 0.80 / 0.50) on
    the card and on the CPU in lockstep: after every frame equal allocated,
    spill and reload counts; after every check equal block-key and
    store-key sets; at the end, by key, the pool's and the store's state
    words with equal weights, sdf within 1 quantum, colour within 1."""
    from gps_slam_torch.config import Config
    from gps_slam_torch.data import synthetic
    from gps_slam_torch.tsdf.engine import TsdfEngine

    W, H, N = 128, 96, 24
    cams = synthetic.make_cameras(n_frames=N, width=W, height=H, look="out", arc=1.0)
    c0 = cams[0]
    node = {"input_dir": "mem", "image_path": "c", "pose_path": "c", "depth_path": "d",
            "pcd_name": "n", "depth_scale": 6553.5, "scene_scale": 1.0,
            "start_frame": 0, "end_frame": N - 1, "frame_step": 1,
            "intrinsics": [c0.fx, c0.fy, c0.cx, c0.cy], "image_shape": [W, H],
            "downscale_factor": 1, "test_split_interval": -1}
    d = synthetic.default_config_dict("build/smoke_ws", node)
    d["TPU"].update(block_capacity=1024, hash_size=2 ** 15, visible_block_capacity=2 ** 12,
                    alloc_candidate_cap=2 ** 13, enable_swapping=1, swap_check_interval=2,
                    swap_high_water=0.80, swap_low_water=0.50)
    engines = {}
    for dev in ("cuda", "cpu"):
        e = TsdfEngine(Config.from_dict(d), W, H, c0.K, device=dev)
        e.set_gt_poses([c.c2w for c in cams])
        e.turn_off_tracking()
        engines[dev] = e
    card, cpu = engines["cuda"], engines["cpu"]
    count_diffs, set_diffs = [], []
    for i, c in enumerate(cams):
        for e in (card, cpu):
            e.process_frame(c.image, c.depth)
        counts = [(e.vol.n_blocks, e.swap.n_spilled_total, e.swap.n_reloaded_total)
                  for e in (card, cpu)]
        if counts[0] != counts[1]:
            count_diffs.append((i, counts))
        if i % card.swap_check_interval == 0:
            kc, kp = (set(by_key(e.vol)[0].tolist()) for e in (card, cpu))
            if kc != kp or set(card.swap.store) != set(cpu.swap.store):
                set_diffs.append(i)
    res = {"width": W, "height": H, "frames": N,
           "n_spilled_total": card.swap.n_spilled_total,
           "n_reloaded_total": card.swap.n_reloaded_total,
           "frames_counts_differ": count_diffs, "checks_sets_differ": set_diffs,
           "pool": state_diff(by_key(card.vol), by_key(cpu.vol))}
    ks = sorted(card.swap.store)
    if set(ks) == set(cpu.swap.store) and ks:
        def stored(e, f):
            return torch.as_tensor(np.stack([e.swap.store[k][f] for k in ks]).view(np.int32))

        kt = torch.as_tensor(ks, dtype=torch.int64)
        res["store"] = state_diff((kt, stored(card, "state"), stored(card, "color")),
                                  (kt, stored(cpu, "state"), stored(cpu, "color")))
    res["tolerance"] = ("counts equal after every frame, key sets and store keys equal "
                        "after every check; by key weights equal, sdf within 1 quantum, "
                        "colour within 1")
    log("[reference swap] " + json.dumps(res))
    if (count_diffs or set_diffs or not res["pool"]["ok"] or not res.get("store", {}).get("ok")
            or not (res["n_spilled_total"] > 0 and res["n_reloaded_total"] > 0)):
        raise RuntimeError("the card's swap run disagrees with the CPU's")
    return res


def reference_offline(args) -> dict:
    """The offline raw path at 128x96 on the card against the CPU: one
    `raw_forward` and its backward (the classic compositor's) from one pool
    (renders within 1e-5, gradients within 1e-4 of each one's largest
    |value| plus 2e-4 of their own: f32 sums in another order, the
    gathers' gradients summed by atomics on the card); then OFFLINE_REF_ITERS
    raw iterations with densify every 5 (its pause after the opacity reset
    set to 0 here) from one pool, the same camera order (one numpy seed)
    and the same split noise injected: the same alive rows after each
    densify."""
    from gps_slam_torch import convert
    from gps_slam_torch.config import Config
    from gps_slam_torch.data import synthetic
    from gps_slam_torch.gs import densify as dmod
    from gps_slam_torch.gs import losses
    from gps_slam_torch.gs import model as gmodel
    from gps_slam_torch.gs.model import GaussianModel
    from gps_slam_torch.slam.offline import OfflinePipeline

    W, H = 128, 96
    cams = synthetic.make_cameras(n_frames=3, width=W, height=H)
    d = offline_config(cams, "raw", OFFLINE_REF_ITERS)
    d["MODEL"].update(densify_start_iter=3, densify_interval=5,
                      densify_end_iter=OFFLINE_REF_ITERS)
    d["PIPE"]["log_iter"] = 10 ** 6
    cfg = Config.from_dict(d)
    spawn = GaussianModel(cfg, W, H, device="cpu")
    spawn._rng.manual_seed(args.seed)
    fm = cams[0].get_frame_maps(device="cpu")
    mask = torch.zeros((H, W), dtype=torch.bool)
    mask[::3, ::3] = True
    gmodel.add_gaussians(spawn.pool, fm["vertex_map"], fm["color_map"], fm["normal_map"],
                         mask, 1.0, 4096, 0.5, (-1.0, 0.05), spawn.next_rng())
    params = {k: v.numpy() for k, v in spawn.pool.params.items()}
    alive = spawn.pool.alive.numpy()
    cam = cams[0]
    out = {}
    for dev in ("cuda", "cpu"):
        pool = convert.pool_from_numpy(params, alive, dev)
        p = {k: v.clone().requires_grad_(True) for k, v in pool.params.items()}
        probe = torch.zeros((pool.capacity, 2), device=dev, requires_grad=True)
        res = gmodel.raw_forward(p, pool.alive, torch.as_tensor(cam.c2w, device=dev),
                                 cam.K, 0, spawn.statics, means2d_probe=probe)
        losses.compute_loss(res["rgb"], res["depth"], torch.as_tensor(cam.image, device=dev),
                            None, 0.0, 0.0)["total"].backward()
        out[dev] = {"rgb": res["rgb"], "alpha": res["alpha"], "probe": probe.grad,
                    **{k: p[k].grad for k in ("means", "scales", "quats", "features_dc",
                                              "opacities")}}
    errs = {}
    for k, x in out["cuda"].items():
        a, b = x.detach().cpu(), out["cpu"][k].detach()
        scale = float(b.abs().max())
        errs[k] = {"max_abs": float((a - b).abs().max()),
                   "of_largest": float((a - b).abs().max()) / max(scale, 1e-30),
                   "ok": bool(torch.allclose(a, b, rtol=2e-4, atol=1e-4 * scale)
                              if k not in ("rgb", "alpha") else
                              torch.allclose(a, b, rtol=0, atol=1e-5))}

    rng = np.random.default_rng(args.seed)
    noises = [torch.as_tensor(rng.standard_normal(dmod.split_noise_shape(
        cfg.tpu.max_new_gaussians)).astype(np.float32)) for _ in range(OFFLINE_REF_ITERS)]
    step, pause = dmod.densify_step, dmod.PAUSE_REFINE_AFTER_RESET
    alive_after = {}
    for dev in ("cuda", "cpu"):
        model = GaussianModel(cfg, W, H, device=dev)
        model.pool = convert.pool_from_numpy(params, alive, dev)
        rounds = alive_after.setdefault(dev, [])

        def densify(pool, g2, vc, gen, *a, _dev=dev, _rounds=rounds):
            res = step(pool, g2, vc, gen, *a, noise=noises[len(_rounds)].to(_dev))
            _rounds.append(pool.alive.cpu().clone())
            return res

        dmod.densify_step, dmod.PAUSE_REFINE_AFTER_RESET = densify, 0
        try:
            OfflinePipeline(cfg, cfg.workspace_dir).raw_train_cams(model, cams)
        finally:
            dmod.densify_step, dmod.PAUSE_REFINE_AFTER_RESET = step, pause
    same_alive = (len(alive_after["cuda"]) == len(alive_after["cpu"]) > 0
                  and all(torch.equal(a, b) for a, b in zip(alive_after["cuda"],
                                                            alive_after["cpu"])))
    res = {"width": W, "height": H, "gaussians": int(alive.sum()), "errors": errs,
           "iterations": OFFLINE_REF_ITERS, "densify_rounds": len(alive_after["cuda"]),
           "alive_after_each_round": [int(a.sum()) for a in alive_after["cuda"]],
           "alive_after_each_round_cpu": [int(a.sum()) for a in alive_after["cpu"]],
           "same_alive_rows": same_alive,
           "tolerance": "renders within 1e-5; gradients within 1e-4 of the largest "
                        "|gradient| + 2e-4 relative; equal alive rows after each densify"}
    log("[reference offline] " + json.dumps(res))
    if not (all(e["ok"] for e in errs.values()) and same_alive):
        raise RuntimeError("the card's offline raw path disagrees with the CPU's")
    return res


class AllocFrames:
    """Records every volume's allocated count after each of its fusions (a
    wrapper on `integrate.fuse_frame`), so that a block's allocation frame
    can be read off its pool row: rows are handed out in claim order,
    frame by frame."""

    def __init__(self):
        from gps_slam_torch.tsdf import integrate as tint

        self.tint, self.fuse = tint, tint.fuse_frame
        self.marks: dict[int, list] = {}

        def fused(vol, *a, **kw):
            out = self.fuse(vol, *a, **kw)
            self.marks.setdefault(id(vol), []).append(vol.n_blocks)
            return out

        tint.fuse_frame = fused

    def detach(self) -> None:
        self.tint.fuse_frame = self.fuse

    def frames(self, vol) -> torch.Tensor:
        """The frame that allocated each of `vol`'s allocated rows."""
        marks = torch.as_tensor(self.marks[id(vol)])
        return torch.searchsorted(marks, torch.arange(vol.n_blocks), right=True)


def blocks_by_key(vols, alloc: AllocFrames) -> dict:
    """Keys, state, colour and summary words (as int32) and allocation
    frames of the allocated blocks of `vols` on the host, sorted by key."""
    parts = {k: [] for k in ("keys", "state", "color", "summary", "frame")}
    for v in vols:
        n = v.n_blocks
        parts["keys"].append(v.block_coords[:n].cpu())
        parts["state"].append(v.state[:n].cpu())
        parts["color"].append(v.color[:n].cpu())
        parts["summary"].append(v.summary[:n].cpu().view(torch.int32))
        parts["frame"].append(alloc.frames(v))
    out = {k: torch.cat(x) for k, x in parts.items()}
    order = torch.argsort(out["keys"])
    return {k: x[order] for k, x in out.items()}


def sharded_path(args, rec: Recorder, main: dict, main_engine, main_alloc: AllocFrames,
                 cams, main_mesh: dict) -> tuple[dict, tuple, tuple]:
    """The sharded path (phase 13): first the main path's loop with the
    raycasts' caps raised (WIDE_CAP_RUNS), then that loop and frames with
    the block pool split SHARDS ways by key-hash ownership
    (`TPU.space_shards`; per shard a 2^19 hash and 32,768 blocks), 2
    windows x 20 Adam steps.  K1 once per shard and frame, K3 once per
    shard and raycast pose, K5 once per Adam step with an active tile; each
    window's loss falls; eval PSNR above 15 dB and within ROUTE_PSNR_GAP_DB
    of the main path's and of each raised-cap run's (each shard's raycasts
    bin up to the visible capacity and LB per tile of its own blocks, so
    the sharded renders may see blocks that the main path's caps leave
    out; the raised-cap runs show what that is worth).  Then, against the
    main path's volume: every key owned
    by its shard, and by key the same blocks with the same state, colour
    and summary words on >= SHARD_KEY_SHARE of the keys (K1 updates a block
    from the frame alone; a key that a claim round dropped in one table and
    not the other is printed with its allocation frames); the raycast from
    pose 0 within tests/test_parallel.py's gates of a raycast of the main
    path's volume binned with SHARDS x its visible capacity and tile lists
    (the most candidates the shards' merged lists can hold; K3's plain
    version, as the lists are longer than K3 takes); a scene.npz round trip
    into a fresh sharded engine giving the same pose-0 raycast bit for
    bit; and the per-shard mesh's triangles and time.  Returns the path's
    numbers and `k1_row`'s and `k3_row`'s arguments for its last K1 and K3
    calls (K3 held bit for bit)."""
    from gps_slam_torch import kernels
    from gps_slam_torch.config import Config
    import dataclasses

    from gps_slam_torch.tsdf import meshing, raycast_tiles
    from gps_slam_torch.tsdf.engine import TsdfEngine
    from gps_slam_torch.tsdf.integrate import shard_owner

    psnr = {"main path": main["psnr_mean"]}
    for tag, tpu in WIDE_CAP_RUNS:
        r, _, _ = run_path(args, cams, ADAM_STEPS, tag, kernels.INTEGRATE, tpu=tpu)
        psnr[tag] = r["psnr_mean"]
    alloc = AllocFrames()
    try:
        out, engine, _ = run_path(args, cams, ADAM_STEPS, "sharded path", kernels.INTEGRATE,
                                  shards=SHARDS)
    finally:
        alloc.detach()
    last = dict(rec.last)
    tag = f"sharded, {cams[0].width}x{cams[0].height}"
    k1 = (tag, last["integrate_blocks_packed"], out["launches"][kernels.INTEGRATE.name])
    k3 = (tag, last["march"], out["launches"][kernels.RAYCAST.name],
          {"space_shards": SHARDS, "pool_rows": last["march"][0][1].shape[0]}, True)
    res = {"psnr_mean": out["psnr_mean"], "psnr_of": psnr,
           "psnr_gap_db": {k: out["psnr_mean"] - v for k, v in psnr.items()},
           "shard_params": {"hash_size": engine.params.hash_size,
                            "block_capacity": engine.params.block_capacity}}
    owned = all(bool((shard_owner(v.block_coords[:v.n_blocks], SHARDS) == s).all())
                for s, v in enumerate(engine.shards))

    # ---- blocks by key against the main path's volume
    a = blocks_by_key(engine.shards, alloc)
    b = blocks_by_key([main_engine.vol], main_alloc)
    ka, kb = a["keys"].numpy(), b["keys"].numpy()
    common, ia, ib = np.intersect1d(ka, kb, return_indices=True)
    ia, ib = torch.as_tensor(ia), torch.as_tensor(ib)
    same = torch.ones(len(common), dtype=torch.bool)
    for k in ("state", "color", "summary"):
        same &= (a[k][ia] == b[k][ib]).all(1)
    n_equal = int(same.sum())
    sa, sb = set(ka.tolist()), set(kb.tolist())
    differ = ([(int(k), None, int(a["frame"][i])) for i, k in enumerate(ka) if k not in sb]
              + [(int(k), int(b["frame"][i]), None) for i, k in enumerate(kb) if k not in sa]
              + [(int(common[j]), int(b["frame"][ib[j]]), int(a["frame"][ia[j]]))
                 for j in torch.nonzero(~same)[:, 0].tolist()])
    res["keys"] = {"sharded": len(ka), "main": len(kb), "common": len(common),
                   "equal_words": n_equal,
                   "equal_share": n_equal / max(len(ka), len(kb)),
                   "owned_by_their_shard": owned,
                   "differing": len(differ),
                   # (key, allocation frame on the main path, on the sharded one)
                   "differing_first": differ[:20]}

    # ---- the raycast from pose 0 against the main path's volume.  Each
    # shard bins up to the visible capacity of its own surface blocks and
    # keeps up to LB of them per tile, so the merged candidates of a tile
    # are its S x LB nearest blocks at most; the reference bins the main
    # path's volume with S x both, through the march's plain version (S x
    # LB is past K3's 32 slots); the engine's own raycast is printed too
    cam = cams[0]
    d_sh = engine.run_raycast(cam.c2w)
    p = main_engine.params
    wide = dataclasses.replace(main_engine.vol, params=dataclasses.replace(
        p, visible_capacity=SHARDS * p.visible_capacity))
    march = raycast_tiles.march
    raycast_tiles.march = plain_march
    try:
        d1 = raycast_tiles.raycast(wide, cam.c2w, cam.K, cam.width, cam.height,
                                   SHARDS * p.raycast_lb, p.raycast_samples,
                                   max(p.raycast_bisect, 3), 2)
    finally:
        raycast_tiles.march = march
    m_eng = main_engine.run_raycast(cam.c2w)
    capped = m_eng["depth_map"][..., 0].cpu().numpy()
    ds, dm = d_sh["depth_map"][..., 0].cpu().numpy(), d1["depth_map"][..., 0].cpu().numpy()
    both = (ds > 0) & (dm > 0)
    gt = cam.depth[..., 0]
    vox = engine.params.voxel_size
    res["raycast_pose0"] = {
        "surface_blocks": d1["n_visible"], "visible_capacity": p.visible_capacity,
        "lb": p.raycast_lb, "tile_overflow_engine": m_eng["n_tile_overflow"],
        "tile_overflow_sharded": d_sh["n_tile_overflow"],
        "hits_sharded": float(np.mean(ds > 0)), "hits_engine": float(np.mean(capped > 0)),
        "hits_reference": float(np.mean(dm > 0)),
        "hit_mask_differs_from_engine": float(np.mean((ds > 0) != (capped > 0))),
        "hit_mask_differs": float(np.mean((ds > 0) != (dm > 0))),
        "both_hit_within_2_voxels": float(np.mean(np.abs(ds - dm)[both] < 2 * vox)),
        "median_err_voxels": float(np.median(np.abs(ds - gt)[(ds > 0) & (gt > 0)]) / vox),
        "color_diff_mean": float((d_sh["color_map"] - d1["color_map"]).abs()
                                 .cpu().numpy()[both].mean()),
        "tolerance": "tests/test_parallel.py: masks differ < 6%, >= 94% within 2 voxels, "
                     "median error < 1.5 voxels, colour < 0.05"}

    # ---- the eval cameras' raycast colour alone against gt: the main
    # volume (K3, 2 picks per quad), the merged shards (each shard refines
    # its own 2 nearest candidates per quad, so the merge up to SHARDS x 2)
    # and the main volume through K3's plain version with SHARDS x the
    # tile lists and the picks: which of them the sharded PSNR follows
    from gps_slam_torch.eval import metrics as M

    march = raycast_tiles.march
    raycast_tiles.march = plain_march
    try:
        picks = [raycast_tiles.raycast(wide, c.c2w, c.K, c.width, c.height,
                                       SHARDS * p.raycast_lb, p.raycast_samples,
                                       max(p.raycast_bisect, 3), 2 * SHARDS)
                 for c in cams[::6]]
    finally:
        raycast_tiles.march = march
    ev = {"main": [], "sharded": [], f"main, {2 * SHARDS} picks": []}
    for c, mk in zip(cams[::6], picks):
        for k, m in (("main", main_engine.run_raycast(c.c2w)),
                     ("sharded", engine.run_raycast(c.c2w)),
                     (f"main, {2 * SHARDS} picks", mk)):
            ev[k].append((M.psnr(m["color_map"].cpu().numpy(), c.image),
                          float((m["depth_map"][..., 0] > 0).float().mean())))
    res["raycast_eval"] = {k: {"color_psnr_mean": float(np.mean([x[0] for x in v])),
                               "hits_mean": float(np.mean([x[1] for x in v]))}
                           for k, v in ev.items()}

    # ---- scene.npz round trip into a fresh sharded engine
    d = bench_config(len(cams), cam.width, cam.height, cam, ADAM_STEPS)
    d["TPU"]["space_shards"] = SHARDS
    ws = "build/smoke_sharded_scene"
    torch.cuda.synchronize()
    t0 = time.monotonic()
    engine.save_scene(ws)
    t1 = time.monotonic()
    fresh = TsdfEngine(Config.from_dict(d), cam.width, cam.height, cam.K, device="cuda")
    fresh.load_scene(ws)
    torch.cuda.synchronize()
    t2 = time.monotonic()
    m_fresh = fresh.run_raycast(cam.c2w)
    res["roundtrip"] = {"save_ms": (t1 - t0) * 1e3, "load_ms": (t2 - t1) * 1e3,
                        "raycast_bit_equal": all(torch.equal(d_sh[k], m_fresh[k]) for k in (
                            "depth_map", "vertex_map", "color_map", "confidence_map",
                            "normal_map"))}
    del fresh

    # ---- the per-shard mesh, as TsdfEngine.save_mesh meshes it
    t0 = time.monotonic()
    tris = sum(meshing.extract_mesh(v)[0].shape[0] // 3 for v in engine.shards)
    res["mesh"] = {"triangles": tris, "ms": (time.monotonic() - t0) * 1e3,
                   "main_path_triangles": main_mesh["triangles_native"]}
    log("[sharded path check] " + json.dumps(res))
    rc = res["raycast_pose0"]
    for k, gap in res["psnr_gap_db"].items():
        if not abs(gap) <= ROUTE_PSNR_GAP_DB:
            raise RuntimeError(f"sharded path: eval PSNR {out['psnr_mean']} is {gap} dB "
                               f"off the {k}'s {psnr[k]}")
    if not (owned and res["keys"]["equal_share"] >= SHARD_KEY_SHARE):
        raise RuntimeError(f"sharded path: blocks by key differ from the main path's: "
                           f"{res['keys']}")
    if not (rc["hit_mask_differs"] < 0.06 and rc["both_hit_within_2_voxels"] >= 0.94
            and rc["median_err_voxels"] < 1.5 and rc["color_diff_mean"] < 0.05):
        raise RuntimeError(f"sharded path: the pose-0 raycast is off: {rc}")
    if not res["roundtrip"]["raycast_bit_equal"]:
        raise RuntimeError("sharded path: the reloaded scene raycasts otherwise")
    if not tris > 0:
        raise RuntimeError("sharded path: empty mesh")
    out["check"] = res
    return out, k1, k3


def dp_phase(engine, model, cams) -> dict:
    """Camera data parallelism (phase 14) on one card, over the device list
    [cuda:0, cuda:0]: the pipeline's data-parallel eval render of the main
    path's 5 eval cameras (padded to 6, cut back) equals `forward_batch`
    bit for bit; one `dp_train_step` over two replicas of one camera
    equals the single-replica step within 1e-6 (loss and every
    parameter), on copies of the model's parameters.  Then the
    cross-replica mean, over two replicas of two different cameras: the
    averaged gradient equals one replica's gradient of the mean loss over
    both cameras within 1e-6 of each parameter's largest |gradient| (two
    terms summed in another order), the loss the mean of the cameras'
    losses within 1e-6, while one camera's gradient alone is off by more
    than 100x that."""
    from gps_slam_torch import kernels
    from gps_slam_torch.config import Config
    from gps_slam_torch.gs import losses
    from gps_slam_torch.gs.model import ges_forward
    from gps_slam_torch.gs.optim import WindowAdam
    from gps_slam_torch.parallel import mesh as pmesh
    from gps_slam_torch.slam.pipeline import SLAMPipeline

    cam0 = cams[0]
    cfg = Config.from_dict(bench_config(len(cams), cam0.width, cam0.height, cam0, ADAM_STEPS))
    pipe = SLAMPipeline(cfg, engine, cfg.workspace_dir, is_train=False)
    eval_cams = cams[::6]
    poses = np.stack([c.c2w for c in eval_cams]).astype(np.float32)
    rays = engine.run_raycast_batch(poses, K=np.asarray(cam0.K), quality=True)
    batch = {"c2w": torch.as_tensor(poses, device="cuda"),
             "K": torch.as_tensor(np.stack([c.K for c in eval_cams]), device="cuda"),
             "ref_depth": rays["depth_map"][..., 0], "base_color": rays["color_map"],
             "cam_id": torch.full((len(eval_cams),), -1, dtype=torch.int32)}
    ref = model.forward_batch(batch)
    pipe.eval_devices = pmesh.make_mesh(2, ["cuda:0", "cuda:0"])
    torch.cuda.synchronize()
    kernels.reset_counts()
    t0 = time.monotonic()
    dp = pipe._eval_render_batch(model, batch)
    torch.cuda.synchronize()
    render_ms = (time.monotonic() - t0) * 1e3
    render_launches = kernels.counts()
    render_equal = all(torch.equal(dp[k], ref[k]) for k in ("rgb", "alpha", "depth"))

    # one Adam step over 2 replicas of a camera that sees Gaussians
    i = next(j for j in range(len(eval_cams)) if float(ref["alpha"][j].sum()) > 0)
    gt = pipe.frame_cache.get(eval_cams[i])[0]
    params, alive, st = model.eval_slice(cam0.height, cam0.width)
    steps = {}
    kernels.reset_counts()
    for n in (2, 1):
        p = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
        opt = WindowAdam(p, cfg.model, cfg.pipe.max_iterations)
        one = {k: batch[k][i:i + 1] for k in batch}
        one["gt_rgb"] = gt[None]
        rep = {k: v.repeat(n, *([1] * (v.ndim - 1))) for k, v in one.items()}
        loss = pmesh.dp_train_step(pmesh.make_mesh(n, ["cuda:0"] * n), p, alive, opt, rep,
                                   st, cfg.pipe.ssim_weight)
        steps[n] = (float(loss), p)
    step_launches = kernels.counts()
    p_err = max(float((steps[2][1][k] - steps[1][1][k]).abs().max()) for k in params)
    moved = sum(int((steps[1][1][k] != params[k]).sum()) for k in params)

    # the cross-replica mean: 2 replicas of 2 cameras that see Gaussians
    seen = [j for j in range(len(eval_cams)) if float(ref["alpha"][j].sum()) > 0]
    if len(seen) < 2:
        raise RuntimeError(f"dp: {len(seen)} eval cameras see a Gaussian")
    two = seen[:2]
    pair = {k: batch[k][two] for k in batch}
    pair["gt_rgb"] = torch.stack([pipe.frame_cache.get(eval_cams[j])[0] for j in two])
    grads = {}
    kernels.reset_counts()
    for tag, n, b in (("dp", 2, pair), ("single", 1, pair),
                      ("first camera", 1, {k: v[:1] for k, v in pair.items()})):
        p = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
        opt = WindowAdam(p, cfg.model, cfg.pipe.max_iterations)
        loss, g = pmesh.dp_train_step(pmesh.make_mesh(n, ["cuda:0"] * n), p, alive, opt, b,
                                      st, cfg.pipe.ssim_weight, return_grads=True)
        grads[tag] = (float(loss), g)
    mean_launches = kernels.counts()
    with torch.no_grad():
        per_cam = [float(losses.compute_loss(r["rgb"], r["depth"], pair["gt_rgb"][m], None,
                                             cfg.pipe.ssim_weight, 0.0)["total"])
                   for m in range(2) for r in [ges_forward(
                       params, alive, pair["c2w"][m], pair["K"][m], pair["ref_depth"][m],
                       pair["base_color"][m], int(pair["cam_id"][m]), st)]]
    g_dp, g_one = grads["dp"][1], grads["single"][1]
    g_rel = {k: float((g_dp[k] - g).abs().max()) / max(float(g.abs().max()), 1e-30)
             for k, g in g_one.items()}
    g_first = {k: float((grads["first camera"][1][k] - g).abs().max())
               / max(float(g.abs().max()), 1e-30) for k, g in g_one.items()}
    res = {"eval_cameras": len(eval_cams), "devices": ["cuda:0", "cuda:0"],
           "render_bit_equal": render_equal, "render_ms": render_ms,
           "render_launches": render_launches, "step_camera": i,
           "loss_2": steps[2][0], "loss_1": steps[1][0],
           "loss_diff": abs(steps[2][0] - steps[1][0]), "max_param_diff": p_err,
           "params_moved": moved, "step_launches": step_launches,
           "mean_cameras": two, "mean_loss_dp": grads["dp"][0],
           "mean_loss_single": grads["single"][0], "per_camera_loss": per_cam,
           "grad_rel_diff": g_rel, "first_camera_grad_rel_diff": g_first,
           "mean_launches": mean_launches,
           "tolerance": "render bit for bit; step loss and parameters within 1e-6; "
                        "the averaged gradient within 1e-6 of each parameter's "
                        "largest |gradient|, the loss within 1e-6 of the "
                        "per-camera mean"}
    log("[dp] " + json.dumps(res))
    if not render_equal or render_launches[kernels.SPLAT_FWD.name] <= 0:
        raise RuntimeError(f"dp: the data-parallel eval render disagrees: {res}")
    if not (res["loss_diff"] <= 1e-6 and p_err <= 1e-6 and moved > 0
            and step_launches[kernels.SPLAT_BWD.name] == 3):
        raise RuntimeError(f"dp: the 2-replica step disagrees with the single one: {res}")
    if not (all(v <= 1e-6 for v in g_rel.values())
            and max(g_first.values()) > 100 * 1e-6
            and abs(grads["dp"][0] - float(np.mean(per_cam))) <= 1e-6
            and abs(grads["dp"][0] - grads["single"][0]) <= 1e-6
            and mean_launches[kernels.SPLAT_BWD.name] == 5):
        raise RuntimeError(f"dp: the replicas' mean disagrees with the batch's: {res}")
    return res


class _Replay:
    """A socket stand-in that replays a request to `server.read_message`."""

    def __init__(self, data: bytes):
        self.data = data

    def recv(self, n: int) -> bytes:
        out, self.data = self.data[:n], self.data[n:]
        return out


def viewer_phase(engine, model, cams) -> dict:
    """The remote viewer (phase 15): `viewer.server.serve` answers
    VIEWER_REQUESTS on localhost from the main path's engine and model
    (two at 1200x680, one at 800x600 that raycasts and renders at its own
    intrinsics and size); each response's render bytes equal
    `vis.to_u8_rgb` of the model's render over the pipeline's raycast for
    that request, bit for bit; K3 once per request."""
    import socket
    import struct
    import threading

    from gps_slam_torch import kernels
    from gps_slam_torch.config import Config
    from gps_slam_torch.slam.pipeline import SLAMPipeline
    from gps_slam_torch.utils import vis
    from gps_slam_torch.viewer import server

    cam0 = cams[0]
    cfg = Config.from_dict(bench_config(len(cams), cam0.width, cam0.height, cam0, ADAM_STEPS))
    pipe = SLAMPipeline(cfg, engine, cfg.workspace_dir, is_train=False)
    reqs = []
    for (w, h), i in zip(VIEWER_REQUESTS, (0, len(cams) // 2, len(cams) - 1)):
        pose = cams[i].c2w.copy()
        pose[:, 1:3] *= -1      # the SIBR convention the server undoes
        fov_x = 2 * np.arctan(w / (2 * 0.75 * w))
        fov_y = 2 * np.arctan(h / (2 * 0.75 * w))
        msg = json.dumps({"fov_x": fov_x, "fov_y": fov_y, "resolution_x": w,
                          "resolution_y": h, "pose": pose.T.reshape(-1).tolist()}).encode()
        reqs.append((w, h, struct.pack("<i", len(msg)) + msg))
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    kernels.reset_counts()
    t = threading.Thread(target=server.serve, args=(pipe, model, port, cfg.pipe.depth_vis_max),
                         kwargs={"max_requests": len(reqs)}, daemon=True)
    t.start()
    deadline = time.monotonic() + 60
    while True:
        try:
            sock = socket.create_connection(("127.0.0.1", port), timeout=60)
            break
        except ConnectionRefusedError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.05)
    responses, ms = [], []
    with sock:
        f = sock.makefile("rb")
        for w, h, msg in reqs:
            t0 = time.monotonic()
            sock.sendall(msg)
            imgs = []
            for _ in range(4):
                iw, ih = struct.unpack("<II", f.read(8))
                imgs.append((iw, ih, f.read(iw * ih * 3)))
            f.read(48)
            f.read(struct.unpack("<I", f.read(4))[0])
            f.read(64)
            ms.append((time.monotonic() - t0) * 1e3)
            responses.append(imgs)
    t.join(timeout=60)
    launches = kernels.counts()
    equal = []
    for (w, h, msg), imgs in zip(reqs, responses):
        cam = server.read_message(_Replay(msg))
        ray = pipe.run_raycast_by_cam(cam)
        rgb = model.forward(cam.c2w_slam, cam.K, ray["depth_map"][..., 0], ray["color_map"])["rgb"]
        want = vis.to_u8_rgb(np.clip(rgb.cpu().numpy(), 0, 1)).tobytes()
        equal.append(imgs[0][:2] == (w, h) and imgs[0][2] == want)
    res = {"requests": [list(r) for r in VIEWER_REQUESTS], "ms_per_request": ms,
           "render_bytes_equal": equal, "server_finished": not t.is_alive(),
           "launches": launches}
    log("[viewer] " + json.dumps(res))
    if not (all(equal) and res["server_finished"]
            and launches[kernels.RAYCAST.name] == len(reqs)
            and launches[kernels.SPLAT_FWD.name] > 0):
        raise RuntimeError(f"viewer: {res}")
    return res


def lpips_phase(args, engine, model, cams) -> dict:
    """LPIPS(vgg) (phase 16) with seeded `random_weights` (nothing is
    downloaded): the card and the CPU within 1e-5 relative on a 300x170
    crop of eval camera 0's render and ground truth; the card's time per
    1200x680 pair (CUDA events, 5 pairs after one warm-up); `metrics.lpips`
    returns None without a weight file."""
    import os

    from gps_slam_torch.eval import lpips_torch
    from gps_slam_torch.eval import metrics as M

    w = lpips_torch.random_weights(np.random.default_rng(args.seed))
    card, cpu = lpips_torch.LpipsTorch(w, "cuda"), lpips_torch.LpipsTorch(w, "cpu")
    cam = cams[0]
    ray = engine.run_raycast(cam.c2w)
    with torch.no_grad():
        rgb = torch.clamp(model.forward(cam.c2w, cam.K, ray["depth_map"][..., 0],
                                        ray["color_map"])["rgb"], 0, 1).cpu().numpy()
    gt = cam.image.astype(np.float32)
    r0, c0 = (cam.height - LPIPS_CROP[0]) // 2, (cam.width - LPIPS_CROP[1]) // 2
    crop = (slice(r0, r0 + LPIPS_CROP[0]), slice(c0, c0 + LPIPS_CROP[1]))
    v_card, v_cpu = card(rgb[crop], gt[crop]), cpu(rgb[crop], gt[crop])
    a = torch.as_tensor(rgb, device="cuda")[None]
    b = torch.as_tensor(gt, device="cuda")[None]
    with torch.no_grad():
        lpips_torch._forward(card.weights, a, b)
        ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        ev[0].record()
        for _ in range(5):
            lpips_torch._forward(card.weights, a, b)
        ev[1].record()
        torch.cuda.synchronize()
    prev = os.environ.get("LPIPS_WEIGHTS")
    os.environ["LPIPS_WEIGHTS"] = "build/no_lpips_weights.npz"
    try:
        marker = M.lpips(rgb, gt)
    finally:
        if prev is None:
            del os.environ["LPIPS_WEIGHTS"]
        else:
            os.environ["LPIPS_WEIGHTS"] = prev
    res = {"crop": list(LPIPS_CROP), "lpips_card": v_card, "lpips_cpu": v_cpu,
           "rel_err": abs(v_card - v_cpu) / abs(v_cpu),
           "ms_per_pair_1200x680": ev[0].elapsed_time(ev[1]) / 5,
           "without_weights": marker, "tolerance": "card within 1e-5 relative of the CPU"}
    log("[lpips] " + json.dumps(res))
    if not (res["rel_err"] <= 1e-5 and v_cpu > 0 and marker is None):
        raise RuntimeError(f"lpips: {res}")
    return res


def prefetch_phase(cams) -> dict:
    """Frame staging (phase 17): `FramePrefetcher` on the card yields the
    main path's frames in order, each equal to `DeviceFrameCache`'s
    tensors bit for bit."""
    from gps_slam_torch.data.device_cache import DeviceFrameCache
    from gps_slam_torch.data.prefetch import FramePrefetcher

    cache = DeviceFrameCache("cuda")
    seen, equal = [], []
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for cam, depth, rgb in FramePrefetcher(cams, "cuda"):
        r, d = cache.get(cam)
        equal.append(bool(torch.equal(depth, d) and torch.equal(rgb, r)))
        seen.append(cam.id)
    torch.cuda.synchronize()
    res = {"frames": len(seen), "in_order": seen == [c.id for c in cams],
           "bit_equal": all(equal), "ms_total": (time.monotonic() - t0) * 1e3}
    log("[prefetch] " + json.dumps(res))
    if not (res["in_order"] and res["bit_equal"] and len(seen) == len(cams)):
        raise RuntimeError(f"prefetch: {res}")
    return res


def profiled(fn):
    """Run fn under torch.profiler; print device time by kernel and return
    (fn's result, the summed time of the device's own kernel, copy and set
    events in ms).  Only device events are summed: a torch op's attributed
    device time would count its kernels a second time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    dev = lambda e: getattr(e, "self_device_time_total", 0.0)
    ka = [e for e in prof.key_averages() if e.device_type.name == "CUDA" and dev(e) > 0]
    busy_ms = sum(dev(e) for e in ka) / 1e3
    top = sorted(ka, key=dev, reverse=True)[:15]
    log("[profile] " + json.dumps({
        "device_busy_ms": busy_ms,
        "top": [{"name": e.key[:80], "device_ms": dev(e) / 1e3, "calls": e.count}
                for e in top]}))
    return out, busy_ms


def main() -> int:
    ap = argparse.ArgumentParser(description="smoke run of gps_slam_torch on one GPU")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="trace the main path with torch.profiler and print "
                         "device time by kernel (adds host overhead to fps)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    torch.manual_seed(args.seed)
    from gps_slam_torch import kernels

    t0 = time.monotonic()
    kernels.build_all()
    log(f"[build] {len(kernels.ALL)} kernels in {time.monotonic() - t0:.1f} s")
    for k, v in kernels.build_log.items():
        # one entry per distinct line: a source with several instances of a
        # kernel (K5, one per colour count) repeats its lines
        regs = list(dict.fromkeys(ln.strip() for ln in v.splitlines()
                                  if "registers" in ln or "stack frame" in ln or "spill" in ln))
        log(f"[build] {k}: {regs}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    log(smi.stdout.strip())

    rec = Recorder()
    mp, main_engine, main_model, main_cams, main_alloc, main_last = main_path(args, rec)
    main_mesh = mesh_phase(main_engine)
    offline_ges_phase(args, main_engine, main_model, main_cams)
    _, k1_sharded, k3_sharded = sharded_path(args, rec, mp, main_engine, main_alloc,
                                             main_cams, main_mesh)
    dp_phase(main_engine, main_model, main_cams)
    viewer_phase(main_engine, main_model, main_cams)
    lpips_phase(args, main_engine, main_model, main_cams)
    prefetch_phase(main_cams)
    del main_engine, main_model, main_alloc
    mega = megastep_path(args)
    k2, k3_large = large_frame_paths(args, rec)
    tracked_cams = synthetic_cams(N_FRAMES, 1200, 680, look="in", arc=TRACKED_ARC)
    tracked, k3_tracked = tracked_path(args, rec, tracked_cams)
    tracking_fixture_phase()
    _, k3_color, color_calls = color_tracked_path(args, rec, tracked_cams)
    del tracked_cams
    color_tracker_fixture_phase()
    swap_path(args)
    offline_raw_phase(args, main_cams)
    del main_cams
    k1 = [(None, main_last["integrate_blocks_packed"], mp["launches"][kernels.INTEGRATE.name]),
          k1_sharded]
    k3 = [(None, main_last["march"], mp["launches"][kernels.RAYCAST.name]), k3_large,
          *k3_tracked, *k3_color, k3_sharded]
    rows = kernel_phase(main_last, mp["launches"], k1, k2, k3)
    rows += window_step_phase(main_last, mp["launches"], mega)
    rows += [icp_gn_row(*r) for r in tracked.pop("gn_calls")]
    rows += [color_gn_row(*r) for r in color_calls]
    reference_phase()
    reference_chunked()
    reference_tracked()
    reference_color_tracked()
    reference_tracked_megastep()
    reference_swap()
    reference_offline(args)
    print(json.dumps({"kernels": [{k: r[k] for k in (
        "name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
        "plain_ms", "bound_ms", "bound_by", "library_ms")} for r in rows
        if "comparison" not in r]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
