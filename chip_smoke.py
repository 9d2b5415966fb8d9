#!/usr/bin/env python
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--seed 0] [--profile]

Phases (any failure exits non-zero before the final line):
  1. build: compile the CUDA kernels (csrc/*.cu, nvcc sm_90a, in parallel)
     and print the card's name and power limit;
  2. forward-only path: the gt-pose `train` loop with PIPE.local_opt_iters
     = 0 (fusion, window raycasts, spawns, prunes) at 1200x680 for 30
     frames on the synthetic scene, then an eval render; K1, K3 and K4
     must launch, and its eval PSNR is the trained path's lower bound;
  3. main path: the same loop with the Adam window (`local_opt_iters` 20
     per window, as bench.py runs it: bench.py's Replica-equivalent
     config), >= 2 optimization windows, then an eval render; every
     kernel's launch count must rise, K5 once per Adam step, each window's
     loss must fall from its first epoch of cameras to its last, and the
     eval PSNR must clear both the 15 dB floor and the forward-only PSNR;
  4. kernels: each kernel against its plain PyTorch version on the inputs
     of its last main-path call, with CUDA-event timings and the least
     time the card could take for the same work;
  5. reference: fusion + raycast at 128x96 on the card against the plain
     CPU path (the same block set; raycast depths within a voxel).
The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.  Without a CUDA device the
script exits with code 2 and prints no result.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_F32_FLOP_PER_S = 67e12     # f32 outside the tensor cores

N_FRAMES = 30   # >= 2 optimization windows at local_opt_interval 10
ADAM_STEPS = 20  # PIPE.local_opt_iters of bench.py and the release configs
# the JAX package gates its own CPU train run at 15 dB (tests/test_slam.py:86)
PSNR_FLOOR_DB = 15.0


def log(*a):
    print(*a, flush=True)


def sdf_of(words: torch.Tensor) -> torch.Tensor:
    """The signed i16 sdf in the low half of packed state words."""
    return ((words & 0xFFFF) ^ 0x8000) - 0x8000


def live_rows(packed: torch.Tensor, gids: torch.Tensor) -> int:
    """Distinct Gaussian rows of `packed` that the tile lists name (the null
    row N excluded): the rows a splat kernel reads, each counted once."""
    return torch.unique(gids[gids < packed.shape[0] - 1]).numel()


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    tb = n_bytes / H100_BYTES_PER_S * 1e3
    to = n_ops / H100_F32_FLOP_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


_L2_FLUSH = None


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean CUDA-event time of fn over `reps` launches, each after a write
    of 128 MiB that evicts the 50 MB L2: the main path reaches each kernel
    with its pool rows cold."""
    global _L2_FLUSH
    if _L2_FLUSH is None:
        _L2_FLUSH = torch.empty(32 << 20, dtype=torch.float32, device="cuda")
    for _ in range(warmup):
        fn()
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(reps)]
    for a, b in ev:
        _L2_FLUSH.zero_()
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
    """Keeps the arguments of the last call of each kernel wrapper."""

    def __init__(self):
        from gps_slam_torch.gs import rasterize as trz
        from gps_slam_torch.tsdf import integrate as tint
        from gps_slam_torch.tsdf import raycast_tiles as trc

        self.last = {}
        for mod, name in ((tint, "integrate_blocks_packed"), (trc, "march"),
                          (trz, "splat_fwd"), (trz, "splat_bwd")):
            orig = getattr(mod, name)

            def wrap(*args, _orig=orig, _name=name, **kw):
                self.last[_name] = (args, kw)
                return _orig(*args, **kw)

            setattr(mod, name, wrap)


def epoch_means(hist: np.ndarray, n_cams: int) -> tuple[float, float]:
    """Mean loss over the first and over the last full epoch of a window:
    the steps visit the opt set's cameras in shuffled epochs, so only
    whole epochs compare."""
    k = len(hist) // n_cams
    if k < 2:
        raise RuntimeError(f"window of {len(hist)} steps has < 2 epochs of {n_cams}")
    return float(hist[:n_cams].mean()), float(hist[(k - 1) * n_cams:k * n_cams].mean())


def run_path(args, cams, iters: int, tag: str) -> dict:
    """Drive the gt-pose train loop with `iters` Adam steps per window over
    `cams`, then the eval render, with every kernel count set to 0 just
    before and read just after; check the output and return the numbers
    of the `[tag]` line."""
    from gps_slam_torch import kernels
    from gps_slam_torch.config import Config
    from gps_slam_torch.eval import metrics as M
    from gps_slam_torch.gs import model as gmodel
    from gps_slam_torch.gs.model import GaussianModel
    from gps_slam_torch.slam.pipeline import SLAMPipeline
    from gps_slam_torch.tsdf.engine import TsdfEngine

    N, W, H = len(cams), cams[0].width, cams[0].height
    cfg = Config.from_dict(bench_config(N, W, H, cams[0], iters))
    engine = TsdfEngine(cfg, W, H, cams[0].K, device="cuda")
    engine.set_gt_poses([c.c2w for c in cams])
    engine.turn_off_tracking()
    model = GaussianModel(cfg, W, H, device="cuda")
    model._rng.manual_seed(args.seed)
    pipe = SLAMPipeline(cfg, engine, cfg.workspace_dir, is_train=False)
    # (cameras, step losses, steps whose camera has active tiles) per window
    windows = []
    window_optimize = gmodel.window_optimize

    def record_window(pool, batch, idx, *a, **kw):
        pool, aux = window_optimize(pool, batch, idx, *a, **kw)
        windows.append((len(batch["cam_id"]), aux["loss_hist"].cpu().numpy(),
                        sum(1 for m in idx if aux["active_tiles"][m] > 0)))
        return pool, aux

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
    launches = kernels.counts()
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
        "fusion_ms_per_frame": pipe.t_fusion / N,
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
        "eval_views": len(eval_cams), "eval_s": eval_s,
        "n_blocks": engine.vol.n_blocks, "gaussians": model.num_gaussians,
        "psnr_mean": float(np.mean(psnrs)), "psnr_min": float(np.min(psnrs)),
        "max_memory_allocated_mb": torch.cuda.max_memory_allocated() / 2 ** 20,
        "launches": launches,
    }
    if args.profile and iters > 0:
        # share of the train + eval wall time during which the card ran
        # device work (an upper bound where device events overlap)
        out["device_busy_share"] = busy_ms / ((train_s + eval_s) * 1e3)
    log(f"[{tag}] " + json.dumps(out))
    if n_windows < 2 or len(windows) != n_windows:
        raise RuntimeError(f"{tag}: ran {len(windows)} of >= 2 optimization windows")
    expect = [k.name for k in kernels.ALL if iters > 0 or k is not kernels.SPLAT_BWD]
    for name in expect:
        if launches[name] <= 0:
            raise RuntimeError(f"{tag}: kernel {name} was not launched")
    # a step on a camera that sees no Gaussian has no active tile and no
    # splat to differentiate; every other step launches K5 once
    if launches[kernels.SPLAT_BWD.name] != out["adam_steps_with_tiles"]:
        raise RuntimeError(f"{tag}: {launches[kernels.SPLAT_BWD.name]} K5 launches "
                           f"for {out['adam_steps_with_tiles']} Adam steps with "
                           f"active tiles")
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
    return out


def main_path(args) -> dict:
    """The forward-only path (no Adam steps), then the main path with
    ADAM_STEPS per window over the same frames; the main path's eval PSNR
    must be at least the forward-only one's."""
    from gps_slam_torch.data import synthetic

    W, H, N = 1200, 680, N_FRAMES
    t0 = time.monotonic()
    cams = synthetic.make_cameras(n_frames=N, width=W, height=H, arc=0.75)
    log(f"[data] {N} synthetic frames {W}x{H} in {time.monotonic() - t0:.1f} s")
    fwd = run_path(args, cams, 0, "forward-only path")
    out = run_path(args, cams, ADAM_STEPS, "main path")
    if out["adam_steps"] != ADAM_STEPS * out["windows"]:
        raise RuntimeError(f"main path ran {out['adam_steps']} Adam steps")
    if not out["psnr_mean"] >= fwd["psnr_mean"]:
        raise RuntimeError(f"trained eval PSNR {out['psnr_mean']} below the "
                           f"forward-only {fwd['psnr_mean']}")
    out["forward_only_psnr_mean"] = fwd["psnr_mean"]
    return out


def kernel_phase(rec, launches: dict) -> list[dict]:
    from gps_slam_torch.gs import rasterize as trz
    from gps_slam_torch.tsdf import integrate as tint
    from gps_slam_torch.tsdf import raycast_tiles as trc
    from gps_slam_torch.tsdf.volume import BLOCK_VOL

    rows = []

    # ---- K1: integrate, on the last fused frame's inputs
    (a, _) = rec.last["integrate_blocks_packed"]
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
    V, Vv = keys.shape[0], sel.shape[0]
    n_bytes = (depth.numel() * 4 + rgbp.numel() * 4 + V * 8
               + Vv * BLOCK_VOL * 4 * 4 + Vv * 128 * 4)
    n_ops = Vv * BLOCK_VOL * 110
    b, by = bound_ms(n_bytes, n_ops)
    rows.append({"name": "integrate_cuda", "route": "cuda",
                 "source": "gps_slam_torch/csrc/integrate.cu",
                 "replaces": "gps_slam_tpu/tsdf/integrate_pallas.py:239",
                 "launches": launches["integrate_cuda"],
                 "max_abs_err": float(max(sdf_err / 32767.0, col_err / 255.0, sum_err)),
                 "ms": ms, "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
                 "library_ms": None, "ok": ok,
                 "bytes": n_bytes, "ops": n_ops,
                 "shapes": {"V": V, "valid_rows": Vv, "image": list(depth.shape),
                            "pool_rows": state.shape[0]},
                 "tolerance": "whole pools: rows outside the integration set "
                              "unchanged; weights equal, sdf within 1 quantum, "
                              "colour channels within 1, >= 99.9% of the "
                              "integrated rows' state and colour words equal; "
                              "summary within 1e-6",
                 "word_match": word_match, "color_match": col_match})

    # ---- K3: raycast march, on the last raycast's inputs
    (a, kw) = rec.last["march"]
    gids, state, color, summary, bc, cam, tw, s_c, s_r, k_b = a[:10]
    need_color = a[10] if len(a) > 10 else kw.get("need_color", True)
    margs = (gids, state, color, summary, bc, cam, tw, s_c, s_r, k_b, need_color)
    ok_out = trc.march(*margs)
    pl_out = trc.march_plain(*margs)
    torch.cuda.synchronize()
    hk, hp = ok_out[:, 5] > 0, pl_out[:, 5] > 0
    hit_flips = int((hk != hp).sum().item())
    px_err = (ok_out[:, :5] - pl_out[:, :5]).abs().amax(1)[hk & hp]
    max_err = px_err.max().item() if px_err.numel() else 0.0
    ok3 = hit_flips == 0 and max_err < 1e-4
    ms = time_ms(lambda: trc.march(*margs), 20)
    plain_ms = time_ms(lambda: trc.march_plain(*margs), 2, 1)
    T, LB = gids.shape
    valid = gids[gids >= 0]
    n_rows = torch.unique(valid).numel()
    n_slots = valid.numel()
    n_bytes = (gids.numel() * 4 + n_rows * (512 * 4 * 2 + 128 * 4 + 4)
               + ok_out.numel() * 4)
    n_ops = (n_slots * 64 * (20 + s_c * 60)          # quad slab + coarse mip samples
             + T * 256 * k_b * (20 + s_r * 60)       # per-pixel refine
             + T * 256 * 3 * 60)                      # colour read
    b, by = bound_ms(n_bytes, n_ops)
    rows.append({"name": "raycast_cuda", "route": "cuda",
                 "source": "gps_slam_torch/csrc/raycast.cu",
                 "replaces": "gps_slam_tpu/tsdf/raycast_pallas.py:51",
                 "launches": launches["raycast_cuda"], "max_abs_err": max_err,
                 "ms": ms, "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
                 "library_ms": None, "ok": ok3,
                 "bytes": n_bytes, "ops": n_ops,
                 "shapes": {"T": T, "LB": LB, "valid_slots": n_slots,
                            "distinct_blocks": n_rows, "k_blocks": k_b,
                            "s_coarse": s_c, "s_refine": s_r},
                 "tolerance": "hit masks equal; t*, confidence, colour within "
                              "1e-4 wherever both hit",
                 "hit_flips": hit_flips, "hit_ratio": hk.float().mean().item()})

    # ---- K4: splat forward, on the last render's inputs
    (a, _) = rec.last["splat_fwd"]
    packed, gids, px, py, ref, delta, C = a[:7]
    ok_out = trz.splat_fwd(packed, gids, px, py, ref, delta, C)
    pl_out = trz.splat_fwd_plain(packed, gids, px, py, ref, delta, C)
    torch.cuda.synchronize()
    max_err = (ok_out - pl_out).abs().max().item() if ok_out.numel() else 0.0
    rel_ok = bool(torch.allclose(ok_out, pl_out, rtol=1e-5, atol=1e-5))
    ms = time_ms(lambda: trz.splat_fwd(packed, gids, px, py, ref, delta, C), 50)
    plain_ms = time_ms(lambda: trz.splat_fwd_plain(packed, gids, px, py, ref, delta, C), 5, 1)
    A, L = gids.shape
    n_pairs = int((gids < packed.shape[0] - 1).sum().item()) * 256
    n_rows = live_rows(packed, gids)
    n_bytes = (n_rows * packed.shape[1] * 4 + gids.numel() * 4 + 3 * px.numel() * 4
               + ok_out.numel() * 4)
    n_ops = n_pairs * (25 + 2 * (C + 1))
    b, by = bound_ms(n_bytes, n_ops)
    rows.append({"name": "splat_fwd_cuda", "route": "cuda",
                 "source": "gps_slam_torch/csrc/splat_fwd.cu",
                 "replaces": "gps_slam_tpu/gs/splat_pallas.py:83",
                 "launches": launches["splat_fwd_cuda"], "max_abs_err": max_err,
                 "ms": ms, "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
                 "library_ms": None, "ok": rel_ok,
                 "bytes": n_bytes, "ops": n_ops,
                 "shapes": {"A": A, "L": L, "C": C, "gaussians": packed.shape[0] - 1,
                            "live_rows": n_rows, "live_pairs": n_pairs},
                 "tolerance": "rtol 1e-5 / atol 1e-5"})

    # ---- K5: splat backward, on the last Adam step's inputs
    (a, _) = rec.last["splat_bwd"]
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
    n_pairs = int((gids < packed.shape[0] - 1).sum().item()) * 256
    n_rows = live_rows(packed, gids)
    n_bytes = (n_rows * packed.shape[1] * 4 + gids.numel() * 4 + 3 * px.numel() * 4
               + v_out.numel() * 4 + ok_out.numel() * 4)
    # per live pair: the pair terms (as K4), v_w, d_alpha, v_sigma and the
    # 6 + C running sums
    n_ops = n_pairs * (55 + 4 * C)
    b, by = bound_ms(n_bytes, n_ops)
    rows.append({"name": "splat_bwd_cuda", "route": "cuda",
                 "source": "gps_slam_torch/csrc/splat_bwd.cu",
                 "replaces": "gps_slam_tpu/gs/splat_pallas.py:99",
                 "launches": launches["splat_bwd_cuda"], "max_abs_err": max_err,
                 "ms": ms, "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
                 "library_ms": None, "ok": ok5,
                 "bytes": n_bytes, "ops": n_ops,
                 "shapes": {"A": A, "L": L, "C": C, "gaussians": packed.shape[0] - 1,
                            "live_rows": n_rows, "live_pairs": n_pairs},
                 "max_rel_col_err": (col_err / col_max.clamp(min=1e-30)).max().item(),
                 "tolerance": "each column within 1e-4 of its largest |value| "
                              "(pixel sums in another order); the same bits on "
                              "a second launch"})
    for r in rows:
        log("[kernel] " + json.dumps(r))
    bad = [r["name"] for r in rows if not r["ok"]]
    if bad:
        raise RuntimeError(f"kernels disagree with their plain versions: {bad}")
    return rows


def reference_phase() -> dict:
    """Fusion + raycast at a small size on the card against the CPU plain
    path: the same number of blocks and the same block keys (fusion's
    candidate math divides by device tensors on both devices, and the hash
    claim picks each slot's winner explicitly), equal hit masks and depth
    within a voxel on every pixel both hit."""
    from gps_slam_torch.data import synthetic
    from gps_slam_torch.tsdf import integrate as tint
    from gps_slam_torch.tsdf import raycast_tiles as trc
    from gps_slam_torch.tsdf import volume as tvol

    cams = synthetic.make_cameras(n_frames=6, width=128, height=96)
    p = tvol.TsdfParams(voxel_size=0.02, mu=0.08, hash_size=1 << 16,
                        block_capacity=1 << 13, visible_capacity=1 << 12)
    maps = {}
    for dev in ("cuda", "cpu"):
        vol = tvol.create(p, dev)
        for c in cams:
            tint.fuse_frame(vol, torch.as_tensor(c.depth[..., 0], device=dev),
                            torch.as_tensor(c.image, device=dev),
                            torch.as_tensor(c.c2w, device=dev), c.K)
        m = trc.raycast(vol, cams[3].c2w, cams[3].K, 128, 96, 24, 4, 8, 2)
        keys = set(vol.block_coords[:vol.n_blocks].cpu().tolist())
        maps[dev] = (vol.n_blocks, m["depth_map"][..., 0].cpu().numpy(), keys)
    nb_c, d_c, k_c = maps["cuda"]
    nb_p, d_p, k_p = maps["cpu"]
    hit_xor = float(np.mean((d_c > 0) != (d_p > 0)))
    both = (d_c > 0) & (d_p > 0)
    close = float(np.mean(np.abs(d_c - d_p)[both] < p.voxel_size))
    max_diff = float(np.abs(d_c - d_p)[both].max())
    gt = cams[3].depth[..., 0]
    med = float(np.median(np.abs(d_c - gt)[d_c > 0]))
    res = {"n_blocks_cuda": nb_c, "n_blocks_cpu": nb_p,
           "block_keys_only_cuda": len(k_c - k_p), "block_keys_only_cpu": len(k_p - k_c),
           "hit_xor": hit_xor, "depth_within_voxel": close,
           "max_depth_diff": max_diff, "median_depth_err_vs_gt": med}
    log("[reference] " + json.dumps(res))
    if (nb_c != nb_p or k_c != k_p or hit_xor > 0.0 or close < 1.0
            or med > p.voxel_size):
        raise RuntimeError("card run disagrees with the CPU reference")
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
        regs = [ln.strip() for ln in v.splitlines() if "registers" in ln]
        log(f"[build] {k}: {regs}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    log(smi.stdout.strip())

    rec = Recorder()
    mp = main_path(args)
    rows = kernel_phase(rec, mp["launches"])
    reference_phase()
    print(json.dumps({"kernels": [{k: r[k] for k in (
        "name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
        "plain_ms", "bound_ms", "bound_by", "library_ms")} for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
