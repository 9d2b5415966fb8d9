"""Plain point-to-plane ICP: the reference the benchmark holds the
program's tracked poses to.

Plain PyTorch, no import of the program.  The configuration's tracker
(`icp`, levels `rrbb`): a 4-level depth pyramid (each level the mean of
the valid pixels of 2x2 blocks), coarsest first; at each level
Levenberg-Marquardt over a left-multiplied twist, at most
(20, 30, 40, 50) iterations coarsest to finest, the two coarsest solving
the rotation alone.  A pixel's camera point goes to the world at the
estimate, projects into the reference maps' camera (the previous pose),
reads the maps' vertex and normal bilinearly (corners without a value
left out), and counts where it lies within the level's distance of the
vertex; its point-to-plane residual r is weighted by Tukey's biweight
at the level's scale.  An iteration's step solves (H + lambda diag(H) +
0.01 mean(diag(H)) I) delta = -g; a step that raises the mean weighted
residual is undone with ten times the damping, one that lowers it keeps
it with a tenth.  A level stops when the squared step falls to 1e-10.
A track whose inlier share is below 0.08 or whose mean residual is above
5 cm keeps the previous pose.
"""

from __future__ import annotations

import torch

LEVEL_ITERS = (50, 40, 30, 20)            # finest first
SPACE_THRESH = (0.015, 0.03, 0.06, 0.1)   # m, finest first
TUKEY_C = (0.02, 0.03, 0.05, 0.08)        # m, finest first
ROTATION_ONLY_FROM = 2
STEP_EXIT = 1e-10
FAIL_MIN_INLIER = 0.08
FAIL_MAX_RESIDUAL = 0.05


def rigid_inverse(T: torch.Tensor) -> torch.Tensor:
    """[R^T | -R^T t] of a pose [R | t]: a pose is a rigid motion."""
    out = torch.eye(4, dtype=T.dtype, device=T.device)
    out[:3, :3] = T[:3, :3].T
    out[:3, 3] = -(T[:3, :3].T @ T[:3, 3])
    return out


def pyramid(depth: torch.Tensor, n: int = 4) -> list:
    out = [depth]
    for _ in range(n - 1):
        d = out[-1]
        h, w = d.shape[0] // 2, d.shape[1] // 2
        b = d[:2 * h, :2 * w].reshape(h, 2, w, 2)
        c = (b > 0).sum(dim=(1, 3))
        s = torch.where(b > 0, b, 0.0).sum(dim=(1, 3))
        out.append(torch.where(c > 0, s / c.clamp(min=1), 0.0))
    return out


def bilinear(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """([N, 3] values, corner weight sum [N]) at pixel coordinates inside
    the image; corners holding all zeros are left out."""
    H, W = img.shape[:2]
    u0, v0 = torch.floor(u), torch.floor(v)
    fu, fv = u - u0, v - v0
    iu0 = u0.to(torch.int64).clamp(0, W - 1)
    iv0 = v0.to(torch.int64).clamp(0, H - 1)
    iu1, iv1 = (iu0 + 1).clamp(max=W - 1), (iv0 + 1).clamp(max=H - 1)
    flat = img.reshape(-1, 3)
    acc = torch.zeros((u.shape[0], 3), dtype=img.dtype, device=img.device)
    wsum = torch.zeros_like(u)
    for iu, iv, w in ((iu0, iv0, (1 - fu) * (1 - fv)), (iu1, iv0, fu * (1 - fv)),
                      (iu0, iv1, (1 - fu) * fv), (iu1, iv1, fu * fv)):
        c = flat[iv * W + iu]
        ok = (c.abs().sum(-1) > 1e-6).to(img.dtype)
        acc = acc + c * (w * ok)[:, None]
        wsum = wsum + w * ok
    return acc / wsum.clamp(min=1e-6)[:, None], wsum


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    rho, phi = xi[:3], xi[3:]
    theta = phi.norm().clamp(min=1e-12)
    a = phi / theta
    z = torch.zeros((), dtype=xi.dtype, device=xi.device)
    Kx = torch.stack([z, -a[2], a[1], a[2], z, -a[0], -a[1], a[0], z]).view(3, 3)
    I = torch.eye(3, dtype=xi.dtype, device=xi.device)
    s, c = torch.sin(theta), torch.cos(theta)
    if float(theta) < 1e-8:
        R, V = I, I
    else:
        R = I + s * Kx + (1 - c) * (Kx @ Kx)
        V = I + ((1 - c) / theta) * Kx + ((theta - s) / theta) * (Kx @ Kx)
    T = torch.eye(4, dtype=xi.dtype, device=xi.device)
    T[:3, :3], T[:3, 3] = R, V @ rho
    return T


def _sums(T, pts, has, ref_v, ref_n, K0, ref_inv, thresh, tukey, rot_only, dtype):
    pts, T, ref_inv = pts.to(dtype), T.to(dtype), ref_inv.to(dtype)
    pw = pts @ T[:3, :3].T + T[:3, 3]
    pr = pw @ ref_inv[:3, :3].T + ref_inv[:3, 3]
    H, W = ref_v.shape[:2]
    z = pr[:, 2]
    zs = z.clamp(min=1e-6)
    u = K0[0] * pr[:, 0] / zs + K0[2]
    v = K0[1] * pr[:, 1] / zs + K0[3]
    in_img = (z > 0) & (u >= 0) & (u <= W - 1) & (v >= 0) & (v <= H - 1)
    u, v = u.clamp(0, W - 1), v.clamp(0, H - 1)
    vt, wv = bilinear(ref_v.to(dtype), u, v)
    nt, wn = bilinear(ref_n.to(dtype), u, v)
    nlen = nt.norm(dim=-1)
    n = nt / nlen.clamp(min=1e-6)[:, None]
    d = pw - vt
    r = (n * d).sum(-1)
    ok = has & in_img & (wv > 0.5) & (wn > 0.5) & (nlen > 0.3) & ((d * d).sum(-1) < thresh ** 2)
    t = (r / tukey).clamp(-1, 1)
    w = ok.to(dtype) * (1 - t * t) ** 2
    J = torch.cat([n, torch.cross(pw, n, dim=-1)], -1)
    if rot_only:
        J[:, :3] = 0
    Jd, wd, rd = J.double(), w.double(), r.double()
    Hm = (Jd * wd[:, None]).T @ Jd
    g = (Jd * (wd * rd)[:, None]).sum(0)
    return (Hm.float(), g.float(), float((rd.abs() * wd).sum()), float(wd.sum()),
            float(ok.sum()))


def track_level(T0, depth, ref_v, ref_n, K0, cam, n_iters, rot_only, ref_inv, thresh,
                tukey, dtype):
    dev = depth.device
    h, w = depth.shape
    i = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    j = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    pts = torch.stack([((i - cam[2]) / cam[0]).expand(h, w), ((j - cam[3]) / cam[1]).expand(h, w),
                       torch.ones((h, w), device=dev)], -1) * depth[..., None]
    pts, has = pts.reshape(-1, 3), depth.reshape(-1) > 0
    T, T_acc = T0.clone(), T0.clone()
    H_acc = torch.eye(6, device=dev)
    g_acc = torch.zeros(6, device=dev)
    err_acc, lam = float("inf"), 1e-3
    inlier = mean_r = 0.0
    for it in range(n_iters):
        Hm, g, sr, sw, n_ok = _sums(T, pts, has, ref_v, ref_n, K0, ref_inv, thresh, tukey,
                                    rot_only, dtype)
        mean_r = sr / max(sw, 1.0)
        inlier = n_ok / (h * w)
        err = mean_r if n_ok > 50 else float("inf")
        better = it == 0 or err <= err_acc
        if better:
            T_acc, H_acc, g_acc, err_acc = T, Hm, g, err
        lam = min(max(lam * 0.1 if better else lam * 10.0, 1e-6), 1e5)
        dg = torch.diagonal(H_acc)
        A = H_acc + lam * torch.diag(dg) + (1e-2 * (float(dg.sum()) / 6.0 + 1e-6)) * torch.eye(
            6, device=dev)
        try:
            delta = torch.linalg.solve(A.to(torch.float32), -g_acc.to(torch.float32))
        except RuntimeError:
            delta = torch.zeros(6, device=dev)
        if not bool(torch.isfinite(delta).all()) or err_acc == float("inf"):
            delta = torch.zeros(6, device=dev)
        T = se3_exp(delta) @ T_acc
        if float((delta * delta).sum()) <= STEP_EXIT:
            break
    return T_acc, inlier, mean_r


def track(T_prev, depth, ref_v, ref_n, K, dtype=torch.float32) -> tuple:
    """(pose c2w [4, 4], inlier share, mean residual, failed) of a frame's
    depth [H, W] against the maps raycast from T_prev."""
    dev = depth.device
    T0 = torch.as_tensor(T_prev, dtype=torch.float32, device=dev)
    ref_inv = rigid_inverse(T0)
    fx, fy, cx, cy = (float(v) for v in (K[0][0], K[1][1], K[0][2], K[1][2]))
    K0 = (fx, fy, cx, cy)
    pyr = pyramid(depth)
    T = T0
    inl = mr = 0.0
    for lvl in range(len(pyr) - 1, -1, -1):
        s = 2 ** lvl
        cam = (fx / s, fy / s, (cx + 0.5) / s - 0.5, (cy + 0.5) / s - 0.5)
        T, inl, mr = track_level(T, pyr[lvl], ref_v, ref_n, K0, cam, LEVEL_ITERS[lvl],
                                 lvl >= ROTATION_ONLY_FROM, ref_inv, SPACE_THRESH[lvl],
                                 TUKEY_C[lvl], dtype)
    failed = (not bool(torch.isfinite(T).all()) or inl < FAIL_MIN_INLIER
              or mr > FAIL_MAX_RESIDUAL)
    return (T0 if failed else T), inl, mr, failed
