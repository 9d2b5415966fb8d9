"""Is what the timed path produced right?  The check steps against the
plain references of perfbench/ref/.

The check steps follow the window (or the profiled slice) on the same
program objects, at the sizes the window ran, up to the first step that
runs an optimisation window (one step in a cell without windows).  The
last of them is judged.  Its state before (the volume, the last pose, the
Gaussian pool the window starts from) is the program's own: the fusion
and the windows of thousands of frames cannot be redone in a run, so the
references follow the program from that state for one step and work out
everything the step derives again: the tracked pose (the maps raycast
from the last pose, the ICP pyramid), the candidate blocks and the voxel
updates, a raycast of the volume after the step, the window (its
raycasts, spawn, Adam steps and prune) and the GES render of the pool as
the window left it.  Each number compared has a limit (`LIMITS`); the run
is `correct` where every number is within it.

`control_numbers` puts the reference computed in bfloat16 in the
program's place: the comparison has to fail it.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ref import (fusion as rfusion, icp as ricp, raycast as rraycast, splat as rsplat,
                 window as rwindow)

# name -> limit; a number above its limit fails the run.  PERF.md gives
# the readings each limit was set from.
LIMITS = {
    "track_gap_voxels": 0.1,
    "fusion_sdf_gap_mu": 0.05,
    "fusion_weights_apart": 1e-3,
    "fusion_color_gap": 16.0,
    "raycast_hits_apart": 1e-3,
    "raycast_gap_voxels": 0.003,
    "window_loss_gap": 1e-3,
    "window_change_gap": 3e-3,
    "window_rows_apart": 3e-5,
    "render_weight_gap": 0.05,
    "render_color_gap": 0.05,
}
# the tracking raycast refines this many blocks a ray (the window's: 1)
TRACK_K_BLOCKS = 2
# a row of the program's pool after a window matches the reference's
# within this distance of their means (m)
MATCH_M = 0.01


@dataclass
class Context:
    cfg: object
    cfg_dict: dict
    store: object
    K: np.ndarray
    width: int
    height: int
    tracked: bool
    seed: int


def tsdf_params(d: dict) -> dict:
    t, tpu = d["PIPE"]["TSDF"], d["TPU"]
    return {"voxel_size": float(t["voxel_size"]), "mu": float(t["trunc_dist"]),
            "frustum_min": float(t["viewFrustum_min"]),
            "frustum_max": float(t["viewFrustum_max"]),
            "max_w": int(tpu["max_weight"]), "alloc_steps": int(tpu["alloc_steps"]),
            "alloc_stride": int(tpu["alloc_stride"]),
            "alloc_candidate_cap": int(tpu["alloc_candidate_cap"]),
            "visible_capacity": int(tpu["visible_block_capacity"]),
            "lb": int(tpu["raycast_lb"]), "s_coarse": int(tpu["raycast_samples"]),
            "s_refine": max(int(tpu["raycast_bisect"]), 3)}


def quantile(x: torch.Tensor, q: float) -> float:
    """The q-quantile of x (of a seeded draw of 2^24 where larger)."""
    x = x.reshape(-1).double()
    if x.numel() == 0:
        return 0.0
    if x.numel() > 2 ** 24:
        x = x[torch.randperm(x.numel(), device=x.device)[:2 ** 24]]
    return float(torch.quantile(x, q))


def q999(x: torch.Tensor) -> float:
    return quantile(x, 0.999)


# the readings that the limits were chosen among (control.py prints them)
SPREAD_QS = (0.5, 0.9, 0.99, 0.999, 1.0)


def spread_of(name: str, x: torch.Tensor) -> dict:
    return {f"{name}@{q}": quantile(x, q) for q in SPREAD_QS}


def raycast(vol: dict, pose, ctx: Context, track: bool, dtype=torch.float32) -> dict:
    """The reference's raycast of the check step: the tracking raycast
    (per-pixel ranking, two stages, normals) in a tracked cell, else the
    window raycast."""
    p = tsdf_params(ctx.cfg_dict)
    return rraycast.raycast(vol, pose, ctx.K, ctx.width, ctx.height, p, p["lb"],
                            p["s_coarse"], p["s_refine"], TRACK_K_BLOCKS if track else 1,
                            track=track, dtype=dtype)


def tracked_pose(ctx: Context, snap: dict, dtype) -> np.ndarray:
    """The reference's pose of a tracked check step's frame: the maps
    raycast from the program's last pose over its volume, then the ICP
    pyramid."""
    before, frames = snap["before"], snap["after"]["frames"]
    if len(frames) != 1:
        raise RuntimeError(f"a tracked check step of {len(frames)} frames")
    _, depth = ctx.store.f32(frames[0])
    vol = rfusion.from_words(**before["volume"])
    maps = raycast(vol, before["pose"], ctx, True, dtype)
    pose, _, _, _ = ricp.track(before["pose"], depth, maps["vertex"], maps["normal"],
                               ctx.K, dtype)
    return pose.cpu().numpy()


def products(ctx: Context, snap: dict, poses: list, dtype, pose=None) -> dict:
    """The reference's volume after the check step's frames, fused at
    `poses` from the program's volume before the step, the blocks they
    integrated and (tracked cells) the pose it tracked."""
    p = tsdf_params(ctx.cfg_dict)
    vol = rfusion.from_words(**snap["before"]["volume"])
    touched = []
    for k, pose_k in zip(snap["after"]["frames"], poses):
        rgb, depth = ctx.store.f32(k)
        vol, keys = rfusion.fuse(vol, depth, rgb, pose_k, ctx.K, p, dtype)
        touched.append(keys)
    out = {"volume": vol, "touched": torch.unique(torch.cat(touched))}
    if pose is not None:
        out["pose"] = pose
    return out


def program_products(snap: dict) -> dict:
    after = snap["after"]
    out = {"volume": rfusion.from_words(**after["volume"])}
    if "track_maps" in after:
        out["pose"] = after["poses"][-1]
    if "window" in after:
        out["window"] = after["window"]
    return out


def fusion_numbers(ref: dict, other: dict, touched: torch.Tensor,
                   extra: dict | None = None) -> dict:
    """Over the blocks the reference's step integrated and the voxels in
    them that either side has observed: the 99.9th percentile sdf gap (in
    the band mu; a block one side lacks counts its voxels the reference
    observed at the full 2 mu), the share whose depth weights differ and
    the 99.9th percentile colour gap (0..255)."""
    in_ref = torch.isin(touched, ref["keys"])
    in_oth = torch.isin(touched, other["keys"])
    both = touched[in_ref & in_oth]
    ri = torch.searchsorted(ref["keys"], both)
    oi = torch.searchsorted(other["keys"], both)
    seen = (ref["w"][ri] > 0) | (other["w"][oi] > 0)
    gap = (ref["sdf"][ri] - other["sdf"][oi]).abs()[seen] * (1.0 / rfusion.SDF_SCALE)
    lacking = touched[in_ref & ~in_oth]
    lost = int((ref["w"][torch.searchsorted(ref["keys"], lacking)] > 0).sum())
    gap = torch.cat([gap, gap.new_full((lost,), 2.0)])
    wapart = float((ref["w"][ri] != other["w"][oi])[seen].double().mean()) if bool(
        seen.any()) else 1.0
    cseen = (ref["wc"][ri] > 0) | (other["wc"][oi] > 0)
    cgap = (ref["rgb"][ri] - other["rgb"][oi]).abs().amax(-1)[cseen]
    if extra is not None:
        extra.update(spread_of("sdf_gap_mu", gap), **spread_of("color_gap", cgap),
                     blocks_apart=float((in_ref != in_oth).sum()) / max(touched.numel(), 1))
    return {"fusion_sdf_gap_mu": q999(gap) if gap.numel() else 2.0,
            "fusion_weights_apart": wapart, "fusion_color_gap": q999(cgap)}


def raycast_numbers(ref_vertex: torch.Tensor, other_vertex: torch.Tensor, voxel: float,
                    extra: dict | None = None) -> dict:
    """The share of pixels that one side hits and the other does not, and
    the 99th percentile distance, in voxels, between the hits where both
    hit."""
    hr = ref_vertex.abs().sum(-1) > 0
    ho = other_vertex.abs().sum(-1) > 0
    d = (ref_vertex - other_vertex).norm(dim=-1)[hr & ho] / voxel
    if extra is not None:
        extra.update(spread_of("raycast_gap_voxels", d))
    return {"raycast_hits_apart": float((hr != ho).double().mean()),
            "raycast_gap_voxels": quantile(d, 0.99) if d.numel() else float("inf")}


def align(prog_means: torch.Tensor, ref_means: torch.Tensor, reach: int = 8):
    """For each program row j, the reference row i near j (|i - j| <=
    `reach`, the nearest mean, j itself on a tie) and whether their means
    lie within MATCH_M: the rows a prune decided otherwise shift the
    rows after them."""
    n, m = prog_means.shape[0], ref_means.shape[0]
    j = torch.arange(n, device=prog_means.device)
    best_d = torch.full((n,), float("inf"), device=prog_means.device)
    best_i = j.clamp(max=max(m - 1, 0))
    for s in sorted(range(-reach, reach + 1), key=abs):
        i = j + s
        ok = (i >= 0) & (i < m)
        d = torch.where(ok, (prog_means - ref_means[i.clamp(0, max(m - 1, 0))]).norm(dim=-1),
                        float("inf"))
        better = d < best_d
        best_d, best_i = torch.where(better, d, best_d), torch.where(better, i, best_i)
    return best_i, best_d < MATCH_M


def window_numbers(ref: dict, other_pool: dict, other_losses: list,
                   extra: dict | None = None) -> dict:
    """The window: the median over its steps of the relative gap of a
    step's loss; the rows after the window, on either side, that no row
    of the other side matches, as a share of the reference's; over the
    matched rows that the window did not spawn, the median over the
    attributes of the gap between the norms of the two sides' change
    from the rows as the window found them, against the reference's
    norm of that attribute or of the median attribute, whichever is
    larger.  Attributes whose first gradient in the reference is under a
    thousandth of the median attribute's are left out (they move by
    round-off alone).  Medians,
    since one step's loss or one attribute's change (the quaternions',
    the scales') can swing by itself in sound runs; a skipped step, a
    camera left out or a lower precision moves most of them.  A spawned
    row's orientation and scale turn on the last bits of its normal (a
    normal along -z leaves the rotation's axis to round-off) and of its
    Morton order, so its change is not compared; its place is, through
    the rows apart."""
    lr = torch.tensor(ref["losses"], dtype=torch.float64)
    lo = torch.tensor(other_losses, dtype=torch.float64)
    rel = (lo - lr).abs() / lr.abs().clamp(min=1e-12) if len(lr) == len(lo) else None
    R, S = ref["pool"], ref["start"]
    i, ok = align(other_pool["means"], R["means"])
    m = R["means"].shape[0]
    n = other_pool["means"].shape[0]
    rows_apart = (n + m - 2.0 * float(ok.sum())) / max(m, 1)
    g0 = ref["grad0"]
    g_med = float(np.median(list(g0.values())))
    counted = [k for k in rwindow.ROW_KEYS if g0[k] >= 1e-3 * g_med]

    def gaps(rows):
        norms = {}
        for k in rwindow.ROW_KEYS:
            s_k = S[k][i[rows]].double()
            dp = other_pool[k][rows].double() - s_k
            dr = R[k][i[rows]].double() - s_k
            norms[k] = (float(torch.linalg.vector_norm(dp)),
                        float(torch.linalg.vector_norm(dr)),
                        float(torch.linalg.vector_norm(dp - dr)))
        med = float(np.median([v[1] for v in norms.values()]))
        scale = {k: max(norms[k][1], med, 1e-30) for k in norms}
        return ({k: abs(norms[k][0] - norms[k][1]) / scale[k] for k in counted},
                {k: norms[k][2] / scale[k] for k in norms})

    old_rows = ok & ~ref["new"][i]
    gap, diff = gaps(old_rows)
    if extra is not None:
        gap_all, _ = gaps(ok)
        extra.update({f"window_change_gap.{k}": v for k, v in gap.items()})
        extra.update({f"window_change_gap_with_new.{k}": v for k, v in gap_all.items()})
        extra.update({f"window_diff.{k}": v for k, v in diff.items()})
        extra.update(window_rows=m, window_left_out=[k for k in rwindow.ROW_KEYS
                                                    if k not in counted],
                     window_spawned=ref["spawned"], window_losses=ref["losses"],
                     window_other_losses=list(other_losses))
    if extra is not None and rel is not None:
        extra.update(window_loss_gap_max=float(rel.max()),
                     window_change_gap_worst=max(gap.values()))
    return {"window_loss_gap": float(rel.median()) if rel is not None else float("inf"),
            "window_change_gap": float(np.median(list(gap.values()))),
            "window_rows_apart": rows_apart}


def reference_window(ctx: Context, snap: dict, dtype) -> dict:
    """The reference's window of the check step, from the program's pool
    before it, over the reference's volume after the step's frames (the
    program's own volume: its fusion is judged apart), with the window's
    cameras (the frames' own poses; a tracked cell's, the program's), its
    step order and its spawn priorities."""
    w = snap["window"]
    vol = rfusion.from_words(**snap["after"]["volume"])
    poses = ([c for c in w["poses"].cpu().numpy()] if ctx.tracked
             else [ctx.store.pose(k) for k in w["cam_ids"]])
    gts = [ctx.store.f32(k)[0] for k in w["cam_ids"]]
    return rwindow.window(w["pool"], vol, poses, gts, w["iter_idx"], w["noise"], ctx.K,
                          ctx.width, ctx.height, tsdf_params(ctx.cfg_dict), w["ray"],
                          w["spawn_idx"], ctx.cfg_dict, dtype)


def compare(ctx: Context, snap: dict, ref: dict, other: dict, other_render=None,
            other_vertex=None, dtype_other=None, extra: dict | None = None) -> dict:
    """Every number of the check: `ref` the reference's products, `other`
    the program's (or the control's)."""
    p = tsdf_params(ctx.cfg_dict)
    after = snap["after"]
    out = {}
    if ctx.tracked:
        out["track_gap_voxels"] = float(np.linalg.norm(
            np.asarray(ref["pose"])[:3, 3] - np.asarray(other["pose"])[:3, 3]) / p["voxel_size"])
    out.update(fusion_numbers(ref["volume"], other["volume"], ref["touched"], extra))
    # a raycast of each side's volume from the step's last pose on that side
    pose = other.get("pose", after["raycast"]["pose"])
    maps = raycast(ref["volume"], pose, ctx, ctx.tracked)
    if other_vertex is None:
        other_vertex = raycast(other["volume"], pose, ctx, ctx.tracked, dtype_other)["vertex"]
    out.update(raycast_numbers(maps["vertex"], other_vertex, p["voxel_size"], extra))
    if "window" in snap:
        ow = other["window"]
        out.update(window_numbers(ref["window"], ow["pool"], ow["losses"], extra))
    if "render" in after:
        out.update(render_check(ctx, after["render"]["pool"], after["raycast"]["pose"],
                                after["render"]["depth"], other_render, dtype_other, extra))
    return out


def render_check(ctx: Context, pool: dict, pose, depth, other_render=None, dtype_other=None,
                 extra: dict | None = None) -> dict:
    """The render numbers of `pool` at `pose` over `depth`: the reference's
    render against `other_render` (the program's), or against the
    reference's own in `dtype_other` (the control's)."""
    mcfg, tpu = ctx.cfg_dict["MODEL"], ctx.cfg_dict["TPU"]
    args = (pool, pose, ctx.K, ctx.width, ctx.height, depth, mcfg, tpu)
    ref_r = rsplat.render(*args)
    if other_render is None:
        other_render = rsplat.render(*args, dtype_other)
    return render_numbers(ref_r, other_render, ~rsplat.unsettled(*args), extra)


def render_numbers(ref: dict, other: dict, settled: torch.Tensor,
                   extra: dict | None = None) -> dict:
    """99.9th percentile gaps of the weight sum and of the alpha-weighted
    colour (each channel's), over the pixels whose render turns on no
    rounding of the binning (`settled`)."""
    wgap = (ref["weight"] - other["weight"]).abs()
    cgap = (ref["raw"] - other["raw"]).abs().amax(-1)
    if extra is not None:
        extra.update(spread_of("render_weight_gap", wgap[settled]),
                     **spread_of("render_color_gap", cgap[settled]),
                     **spread_of("render_weight_gap_all", wgap),
                     **spread_of("render_color_gap_all", cgap))
        extra["render_unsettled_share"] = 1.0 - float(settled.double().mean())
        for name, gap in (("render_weight_gap", wgap), ("render_color_gap", cgap)):
            over = gap > LIMITS[name]
            extra[f"{name}_over_limit"] = [int(over[settled].sum()), int(over.sum())]
    return {"render_weight_gap": q999(wgap[settled]),
            "render_color_gap": q999(cgap[settled])}


def program_vertex(snap: dict) -> torch.Tensor:
    after = snap["after"]
    if "track_maps" in after:
        return after["track_maps"]["vertex_map"]
    return after["raycast"]["vertex"]


def program_render(snap: dict) -> dict | None:
    r = snap["after"].get("render")
    return None if r is None else render_of(r["rgb"], r["alpha"])


def render_of(rgb: torch.Tensor, alpha: torch.Tensor) -> dict:
    """The program's eval render as the reference gives it: its colour is
    (raw + base) / (weight + 1), its base black."""
    return {"weight": alpha, "raw": rgb * (alpha[..., None] + 1.0)}


def numbers(ctx: Context, snap: dict, extra: dict | None = None) -> dict:
    """The program's numbers.  A tracked step's pose is judged against the
    reference's; its fusion is judged at the program's pose, so that a
    pose within its limit does not move the voxels' comparison."""
    after = snap["after"]
    if ctx.tracked:
        pose = tracked_pose(ctx, snap, torch.float32)
        ref = products(ctx, snap, after["poses"], torch.float32, pose)
    else:
        ref = products(ctx, snap, [ctx.store.pose(k) for k in after["frames"]], torch.float32)
    if "window" in snap:
        ref["window"] = reference_window(ctx, snap, torch.float32)
    return compare(ctx, snap, ref, program_products(snap), program_render(snap),
                   program_vertex(snap), extra=extra)


def control_numbers(ctx: Context, snap: dict, dtype=torch.bfloat16,
                    extra: dict | None = None) -> dict:
    """The control's numbers: the reference in `dtype` in the program's
    place (its tracked pose, its fusion at that pose, its raycast, window
    and render)."""
    after = snap["after"]
    if ctx.tracked:
        low_pose = tracked_pose(ctx, snap, dtype)
        ref = products(ctx, snap, [low_pose], torch.float32,
                       tracked_pose(ctx, snap, torch.float32))
        low = products(ctx, snap, [low_pose], dtype, low_pose)
    else:
        poses = [ctx.store.pose(k) for k in after["frames"]]
        ref = products(ctx, snap, poses, torch.float32)
        low = products(ctx, snap, poses, dtype)
    if "window" in snap:
        ref["window"] = reference_window(ctx, snap, torch.float32)
        lw = reference_window(ctx, snap, dtype)
        low["window"] = {"pool": lw["pool"], "losses": lw["losses"]}
    return compare(ctx, snap, ref, low, dtype_other=dtype, extra=extra)


def judge(vals: dict) -> list[dict]:
    return [{"name": k, "value": v, "limit": LIMITS[k], "ok": bool(v <= LIMITS[k])}
            for k, v in vals.items()]


def run(ctx: Context, snap: dict, extra: dict | None = None) -> list[dict]:
    torch.manual_seed(ctx.seed % (2 ** 63))
    return judge(numbers(ctx, snap, extra))
