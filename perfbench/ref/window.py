"""Plain optimisation window: the reference the benchmark holds the
program's window megastep to.

Plain PyTorch, no import of the program.  One window of the
configuration (PIPE.local_opt_iters Adam steps every local_opt_interval
frames), from a Gaussian pool of C rows (the window's prefix: live rows
first) and the volume after the window's last frame:

  * raycasts: every camera of the window (the local window and the
    sampled keyframes) is raycast (`ref.raycast`, k_blocks 1, colour);
  * spawn, on the window's last local camera: its render over the pool
    (`ref.splat`, the window's caps: visible min(visible_gaussian_cap,
    C), active tiles max(active_tile_cap, C / 8), fresh lists) with the
    raycast's colour as base, rgb = (raw + base) / (weight + 1); a pixel
    spawns where the raycast hit within the visible depth range, its
    colour error (mean over channels) exceeds color_error_thres and the
    weight is below alpha_vis_max; new_gs_sample_ratio of those pixels
    (the floor), at most TPU.max_new_gaussians, in the order of the
    window's random priorities; each new Gaussian at the hit, its colour
    the frame's, its opacity default_opacities, its scale the root of the
    mean squared distance to its 3 nearest new neighbours among the 64
    either side in Morton order (clamped to the init scale limits), z
    flattened by 10 and turned onto the Sobel normal of the raycast;
    they fill the free rows in order;
  * steps: each camera's lists are binned once, on the pool as spawned,
    with a 2 px margin on every radius and the caps visible
    min(visible_gaussian_cap, C), active tiles min(active_tile_cap, all);
    step k renders camera iter_idx[k] over its lists and takes the mean
    L1 of rgb against the frame over every pixel and channel; Adam per
    attribute (b1 0.9, b2 0.999, eps 1e-8, bias corrections and the
    means' decay lr * gamma^k, gamma = 0.01^(1 / PIPE.max_iterations), in
    float32 as the configuration's optimiser states them), moments fresh;
  * prune and compact: rows whose largest scale is below
    small_scale_thres or above large_scale_thres or whose opacity is
    below low_opac_thres die; the live rows move to the front in order.

`dtype` is the arithmetic of the raycasts and the renders, forward and
backward (float32 as the configuration states; bfloat16 for the
control); the parameters and Adam stay float32.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import raycast as rraycast, splat as rsplat

ROW_KEYS = ("means", "scales", "quats", "features_dc", "features_rest", "opacities")
LRS = {"means": "means_lr", "scales": "scales_lr", "quats": "quats_lr",
       "features_dc": "featuresDc_lr", "features_rest": "featuresRest_lr",
       "opacities": "opacities_lr"}
B1, B2, EPS = 0.9, 0.999, 1e-8
MARGIN_PX = 2.0
KNN_WINDOW = 64


def _spread10(v):
    v = v & 0x3FF
    v = (v | (v << 16)) & 0x30000FF
    v = (v | (v << 8)) & 0x300F00F
    v = (v | (v << 4)) & 0x30C30C3
    return (v | (v << 2)) & 0x9249249


def knn3_mean_sq(pts, valid, window: int = KNN_WINDOW):
    """Mean squared distance to the 3 nearest among the `window` rows
    either side in Morton order (10 bits an axis over the valid rows'
    box; invalid rows last and out of the box)."""
    n = pts.shape[0]
    v = valid[:, None]
    lo = torch.where(v, pts, torch.full_like(pts, float("inf"))).amin(0)
    hi = torch.where(v, pts, torch.full_like(pts, -float("inf"))).amax(0)
    lo = torch.where(torch.isfinite(lo), lo, torch.zeros_like(lo))
    hi = torch.where(torch.isfinite(hi), hi, torch.ones_like(hi))
    q = torch.clamp((pts - lo) / torch.clamp(hi - lo, min=1e-9) * 1023.0, 0.0, 1023.0).long()
    code = _spread10(q[:, 0]) | (_spread10(q[:, 1]) << 1) | (_spread10(q[:, 2]) << 2)
    code = torch.where(valid, code, torch.full_like(code, 0xFFFFFFFF))
    order = torch.argsort(code, stable=True)
    ps = pts[order]
    pad = torch.full((window, 3), float("inf"), dtype=pts.dtype, device=pts.device)
    ext = torch.cat([pad, ps, pad], 0)
    d2 = torch.stack([((ext[window + o: window + o + n] - ps) ** 2).sum(-1)
                      for o in range(-window, window + 1) if o], -1)
    small = torch.topk(d2, 3, dim=-1, largest=False).values
    mean3 = torch.where(torch.isfinite(small), torch.clamp(small, min=0.0),
                        torch.zeros_like(small)).mean(1)
    out = torch.zeros(n, dtype=pts.dtype, device=pts.device)
    out[order] = mean3
    return out


def new_rows(xyz, rgb, nrm, sh_degree: int, opacity: float, min_s: float, max_s: float):
    near = xyz.abs().amax(-1) < 1e5
    s = torch.sqrt(torch.clamp(knn3_mean_sq(xyz, near), min=1e-12))
    s = torch.clamp(s, min_s, max_s) if min_s > 0 else torch.clamp(s, max=max_s)
    scales = torch.stack([s, s, s * 0.1], -1)
    z = torch.zeros_like(nrm)
    z[:, 2] = 1.0
    axis = torch.linalg.cross(z, nrm, dim=-1)
    axis = axis / (torch.linalg.norm(axis, dim=-1, keepdim=True) + 1e-8)
    half = torch.arccos(torch.clamp((z * nrm).sum(-1, keepdim=True), -1.0, 1.0)) * 0.5
    axis = axis / (torch.linalg.norm(axis, dim=-1, keepdim=True) + 1e-8)
    quats = torch.cat([torch.cos(half), axis * torch.sin(half)], -1)
    ident = torch.tensor([1.0, 0.0, 0.0, 0.0], device=xyz.device)
    quats = torch.where((torch.linalg.norm(nrm, dim=-1) > 0.5)[:, None], quats, ident)
    m = xyz.shape[0]
    return {"means": xyz, "scales": torch.log(torch.clamp(scales, min=1e-12)), "quats": quats,
            "features_dc": (rgb - 0.5) / rsplat.SH_C0,
            "features_rest": torch.zeros((m, (sh_degree + 1) ** 2 - 1, 3), device=xyz.device),
            "opacities": torch.full((m, 1), math.log(opacity / (1.0 - opacity)),
                                    device=xyz.device)}


def add_rows(pool: dict, attrs: dict, count) -> int:
    """Row j < count of attrs into the j-th free row, in place; returns
    the rows placed."""
    m = attrs["means"].shape[0]
    free = ~pool["alive"]
    rank = torch.cumsum(free.long(), 0) - 1
    sel = free & (rank < count) & (rank < m)
    src = rank.clamp(0, m - 1)
    for k in ROW_KEYS:
        shape = (-1,) + (1,) * (pool[k].ndim - 1)
        pool[k] = torch.where(sel.view(shape), attrs[k][src], pool[k])
    pool["alive"] = pool["alive"] | sel
    return int(sel.sum())


def schedule(mcfg: dict, max_iterations: int, steps: int) -> np.ndarray:
    """(1 - b1^t, 1 - b2^t, means lr gamma^k) of update k in float32."""
    f32 = np.float32
    g = f32(0.01 ** (1.0 / max(max_iterations, 1)))
    rows = np.empty((steps, 3), np.float32)
    for k in range(steps):
        t = f32(k + 1)
        rows[k] = (f32(1.0) - f32(B1) ** t, f32(1.0) - f32(B2) ** t,
                   f32(mcfg["means_lr"]) * g ** f32(k))
    return rows


def window(pool: dict, vol: dict, poses, gts, iter_idx, noise, K, width: int, height: int,
           p: dict, ray: tuple, spawn_idx: int, cfg: dict, dtype=torch.float32) -> dict:
    """One window.  pool: ROW_KEYS and "alive" over the window's C rows;
    vol: `ref.fusion`'s volume; poses [M] c2w; gts [M] frames' rgb f32
    [H, W, 3]; iter_idx the camera of each step; noise [H * W] the spawn
    priorities; p the TSDF parameters (`check.tsdf_params`); ray (lb,
    coarse samples, refinement samples); cfg the configuration (MODEL,
    TPU, PIPE).  Returns the pool after the window (live rows, in order),
    its rows as spawned in the same order (`start`), which of them the
    window spawned (`new`), each step's loss and each attribute's first
    gradient norm."""
    mcfg, tpu, pipe = cfg["MODEL"], cfg["TPU"], cfg["PIPE"]
    vis = pipe["vis_configs"]
    pool = {k: v.clone() for k, v in pool.items()}
    C = pool["means"].shape[0]
    T = -(-width // rsplat.TILE) * -(-height // rsplat.TILE)
    lb, s_coarse, s_refine = ray
    maps = [rraycast.raycast(vol, c, K, width, height, p, lb, s_coarse, s_refine, 1,
                             need_color=True, dtype=dtype) for c in poses]
    vis_cap = min(int(tpu["gaussian_capacity"]), int(tpu["visible_gaussian_cap"]), C)
    base_caps = {"tile": int(tpu["tile_gaussian_cap"]),
                 "per_gaussian": int(tpu["tiles_per_gaussian_cap"])}
    deg, delta = int(mcfg["sh_degree"]), float(mcfg["delta_depth"])

    # spawn
    s = spawn_idx
    depth, vert, base = maps[s]["depth"], maps[s]["vertex"], maps[s]["color"]
    cp = dict(base_caps, visible=vis_cap,
              active=min(T, max(int(tpu["active_tile_cap"]), C // 8)))
    with torch.no_grad():
        r = rsplat.render(pool, poses[s], K, width, height, depth, mcfg, tpu, dtype, cp)
    rgb = (r["raw"] + base) / (r["weight"][..., None] + 1.0)
    valid = ((depth > float(vis["depth_vis_min"])) & (depth < float(vis["depth_vis_max"]))
             & (vert.abs().sum(-1) > 0))
    mask = (((rgb - gts[s]).abs().mean(-1) > float(pipe["color_error_thres"])) & valid
            & (r["weight"] < float(vis["alpha_vis_max"]))).reshape(-1)
    nrm = rraycast.sobel(vert)
    nrm = torch.where(vert[..., 2:3] <= 0, torch.zeros_like(nrm), nrm).reshape(-1, 3)
    max_new = min(int(tpu["max_new_gaussians"]), mask.numel())
    prio = torch.where(mask, noise, torch.full_like(noise, float("inf")))
    idx = torch.argsort(prio, stable=True)[:max_new]
    n_want = (mask.sum().to(torch.float32) * float(pipe["new_gs_sample_ratio"])).long()
    n_sel = torch.clamp(n_want, max=max_new)
    taken = (torch.arange(max_new, device=idx.device) < n_sel)[:, None]
    xyz = torch.where(taken, vert.reshape(-1, 3)[idx], 1e6)
    before = pool["alive"]
    spawned = add_rows(pool, new_rows(xyz, gts[s].reshape(-1, 3)[idx], nrm[idx], deg,
                            float(mcfg["default_opacities"]), float(mcfg["min_init_scale"]),
                            float(mcfg["max_init_scale"])), n_sel)

    # the Adam steps
    start = {k: pool[k].clone() for k in ROW_KEYS}
    params = {k: pool[k].clone().requires_grad_(True) for k in ROW_KEYS}
    alive = pool["alive"]
    cp = dict(base_caps, visible=vis_cap, active=min(T, int(tpu["active_tile_cap"])))
    lists = []
    with torch.no_grad():
        for c in poses:
            m2d, _, _, radii = rsplat.project(dict(params, alive=alive), c, K, width, height,
                                              int(mcfg["max_gs_radii"]), dtype)
            lists.append(rsplat.bins(m2d, radii, width, height, cp, MARGIN_PX))
    table = schedule(mcfg, int(pipe["max_iterations"]), len(iter_idx))
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    losses, grad0 = [], {}
    for step, m in enumerate(iter_idx):
        pm = dict(params, alive=alive)
        m2d, conic, gdepth, radii = rsplat.project(pm, poses[m], K, width, height,
                                                   int(mcfg["max_gs_radii"]), dtype)
        col = rsplat.colors(pm, poses[m], deg, radii, dtype)
        opac = torch.sigmoid(params["opacities"][:, 0].to(torch.float32)).to(dtype)
        raw, wsum = rsplat.splat(m2d, conic, gdepth, col, opac, *lists[m], maps[m]["depth"],
                                 width, height, delta, dtype)
        out = (raw + maps[m]["color"]) / (wsum[..., None] + 1.0)
        loss = (out - gts[m]).abs().sum() / float(width * height * 3)
        keys = list(params)
        grads = torch.autograd.grad(loss, [params[k] for k in keys], allow_unused=True)
        losses.append(float(loss.detach()))
        bc1, bc2, lr_means = (torch.tensor(float(v), device=loss.device) for v in table[step])
        with torch.no_grad():
            for k, g in zip(keys, grads):
                g = torch.zeros_like(params[k]) if g is None else g.to(torch.float32)
                if step == 0:
                    grad0[k] = float(torch.linalg.vector_norm(g.double()))
                mu[k] = (1.0 - B1) * g + B1 * mu[k]
                nu[k] = (1.0 - B2) * (g * g) + B2 * nu[k]
                upd = (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + EPS)
                lr = lr_means if k == "means" else float(mcfg[LRS[k]])
                params[k].add_(upd * -lr)

    # prune and compact
    with torch.no_grad():
        after = {k: v.detach() for k, v in params.items()}
        big = torch.exp(after["scales"]).amax(-1)
        op = torch.sigmoid(after["opacities"][:, 0])
        rc = pipe["remove_configs"]
        kill = (((big < float(rc["small_scale_thres"])) | (big > float(rc["large_scale_thres"]))
                 | (op < float(rc["low_opac_thres"]))) & alive)
        keep = torch.nonzero(alive & ~kill)[:, 0]
    return {"pool": {k: v[keep] for k, v in after.items()},
            "start": {k: v[keep] for k, v in start.items()},
            "new": (alive & ~before)[keep],
            "losses": losses, "grad0": grad0, "spawned": spawned}
