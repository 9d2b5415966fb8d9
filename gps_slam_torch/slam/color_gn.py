"""The Gauss-Newton loop of a colour-tracker pyramid level: the CUDA kernel
`color_gn_cuda` (csrc/color_gn.cu), which runs the level's passes in one
cooperative launch, and its plain PyTorch version, one pass
(`iterate_plain`) run in a loop that reads the loop's test (`run_plain`).

The counterpart of the JAX colour tracker's per-level `lax.while_loop`
(its body `gn_iter` and its test, gps_slam_tpu/slam/tracker.py:322-388),
which XLA compiles into one program; it replaces no `pallas_call`.  One
iteration (a pass) at the level's w2c estimate M, over the N points of the
previous raycast (world points, their model colours, their valid flags):

  * per point: the camera point M p_w, its projection into the level's
    image, the bilinear reads of the image, of its Sobel x and of its
    Sobel y at it (a corner whose three values are all zero left out of
    the weights, as in `icp_gn.bilinear`), the colour residual r [3], the
    inlier test (valid, in the image, the image's corner weights above
    0.5) and the Jacobian J [3, 6] = gx (du/dxi) + gy (dv/dxi) of a
    left-multiplied twist (its rotation columns alone at levels 2-3);
  * 44 sums over the points, in f64 (`N_TERMS`): H_ij (36, each point's
    entry the f64 sum over the 3 channels of f64(Jm_ci) f64(J_cj), Jm = J
    ok rounded to f32), g_i (6, the same with r_c), the inliers' squared
    residual ((r0 r0 + r1 r1) + r2 r2) ok and the inlier count;
  * the colour tracker's Levenberg-Marquardt step on the level's carried
    state (`FIELDS`): accept, or go back to the accepted estimate with 10x
    damping, the new system damped either way (the JAX tracker damps Hm,
    not an accepted system); the damped 6x6 solve by `icp_gn.solve6` (a
    zero pivot or a non-finite solution gives a zero step);
    se3_exp(delta) M_ref; the loop's test `more`.

The plain version writes each f32 expression out term by term in one
fixed order (no matmul, no reduction over a small axis, true divisions by
device tensors), and takes the point sums in the kernel's order
(`icp_gn.cta_sums`, the same grid of CTAs), so that on the card it gives
the kernel's bits.
"""

from __future__ import annotations

import torch

from .. import kernels
from . import icp_gn

N_TERMS = 44      # H (36, row-major), g (6), sum ((r0 r0 + r1 r1) + r2 r2) ok, inliers
# the level's carried state, one f32 buffer that the step updates in place
FIELDS = (("M", (4, 4)), ("M_acc", (4, 4)), ("err_acc", ()), ("lam", ()), ("step", ()),
          ("inlier", ()), ("mean_r", ()))
STATE_SIZE = 37
STEP = 34         # the index of `step` in the state


def partials_buffer(n_pts: int, device) -> torch.Tensor:
    """The kernel's scratch, zeros: two halves of per-CTA sums [N_TERMS,
    n_ctas] f64 (the grid of `icp_gn`; the passes use the halves in turn, a
    launch leaves its last pass's rows in the first), then one slot whose
    bits hold the grid barrier's 64-bit count of arrivals."""
    return torch.zeros(2 * N_TERMS * icp_gn.n_ctas(n_pts) + 1, dtype=torch.float64,
                       device=device)


def load() -> None:
    """Load `color_gn_cuda` onto the current card now (built first if need
    be), which a first launch inside a graph capture would otherwise do,
    and check that the card can launch it cooperatively."""
    icp_gn.grid(kernels.COLOR_GN, icp_gn.MAX_CTAS)


def terms(M, pts_w, col_known, pts_valid, rgb, gx, gy, cam, rotation_only: bool,
          rows: int | None = None) -> torch.Tensor:
    """The per-point terms of the sums at the w2c estimate M: [rows,
    N_TERMS] f64 (see the module's note), rows past the N points (`rows`,
    default N) +0."""
    h, w = rgb.shape[:2]
    fx, fy, cx, cy = cam[0], cam[1], cam[2], cam[3]
    pc = icp_gn._affine(M, *pts_w.unbind(1))
    z = torch.clamp(pc[2], min=1e-6)
    u = fx * pc[0] / z + cx
    v = fy * pc[1] / z + cy
    in_img = (pc[2] > 0) & (u >= 0) & (u <= w - 1) & (v >= 0) & (v <= h - 1)
    us = torch.clamp(u, 0.0, w - 1.0)
    vs = torch.clamp(v, 0.0, h - 1.0)
    c_obs, wz = icp_gn.bilinear(rgb, us, vs)
    gxo = icp_gn.bilinear(gx, us, vs)[0].unbind(1)
    gyo = icp_gn.bilinear(gy, us, vs)[0].unbind(1)
    r = [a - b for a, b in zip(c_obs.unbind(1), col_known.unbind(1))]
    okf = (pts_valid & in_img & (wz > 0.5)).to(torch.float32)
    # projection Jacobians d(u, v) / d p_c, then [d ; p_c x d] for a
    # left-multiplied twist on M
    inv_z = torch.reciprocal(z)
    zero = torch.zeros_like(z)
    du = [fx * inv_z, zero, -fx * pc[0] * inv_z * inv_z]
    dv = [zero, fy * inv_z, -fy * pc[1] * inv_z * inv_z]
    jac = []
    for d in (du, dv):
        j = [*d, pc[1] * d[2] - pc[2] * d[1], pc[2] * d[0] - pc[0] * d[2],
             pc[0] * d[1] - pc[1] * d[0]]
        if rotation_only:
            j[:3] = [c * 0.0 for c in j[:3]]
        jac.append(j)
    ju, jv = jac
    J = torch.stack([torch.stack([gxo[c] * ju[i] + gyo[c] * jv[i] for i in range(6)], 1)
                     for c in range(3)], 1)                        # [N, 3, 6]
    Jm = (J * okf[:, None, None]).double()
    J = J.double()
    r64 = torch.stack(r, 1).double()
    N = J.shape[0]
    out = torch.empty((rows or N, N_TERMS), dtype=torch.float64, device=J.device)
    out[N:].zero_()
    # each entry summed over the channels in their order
    P = Jm[:, :, :, None] * J[:, :, None, :]
    torch.add(P[:, 0] + P[:, 1], P[:, 2], out=out[:N, :36].unflatten(1, (6, 6)))
    Q = Jm * r64[:, :, None]
    torch.add(Q[:, 0] + Q[:, 1], Q[:, 2], out=out[:N, 36:42])
    out[:N, 42].copy_(((r[0] * r[0] + r[1] * r[1]) + r[2] * r[2]) * okf)
    out[:N, 43].copy_(okf)
    return out


def lm_step(state: torch.Tensor, tot: torch.Tensor, n_pts: torch.Tensor,
            first: bool) -> torch.Tensor:
    """The colour tracker's Levenberg-Marquardt accept/reject of one
    iteration on the carried state [STATE_SIZE] and the sums `tot`
    [N_TERMS] (f64, rounded to f32 here): a step that raised the error goes
    back to the accepted estimate with 10x damping, an improving one (or
    the first) is kept with the damping relaxed; either way the system of
    this iteration is damped and solved.  Returns the new state."""
    dev = state.device
    M, M_acc = state[0:16].view(4, 4), state[16:32].view(4, 4)
    err_acc, lam = state[32], state[33]
    Hm, g = tot[:36].float().view(6, 6), tot[36:42].float()
    n_ok = tot[43].float()
    err = torch.where(n_ok > 50, (tot[42] / torch.clamp(tot[43], min=1.0)).float(),
                      float("inf"))
    inlier = n_ok / n_pts
    mean_r = torch.sqrt(torch.clamp(err, min=0.0))
    better = err <= err_acc
    if first:
        better = torch.ones_like(better)
    M_ref = torch.where(better, M, M_acc)
    err_ref = torch.where(better, err, err_acc)
    lam_new = torch.clamp(torch.where(better, lam * 0.1, lam * 10.0), 1e-6, 1e5)
    dg = torch.diagonal(Hm)
    trace = ((((dg[0] + dg[1]) + dg[2]) + dg[3]) + dg[4]) + dg[5]
    mean_diag = trace / torch.full((), 6.0, device=dev) + 1e-9
    eye6 = torch.eye(6, dtype=torch.float32, device=dev)
    A = Hm + (lam_new * torch.diag(dg) + (1e-2 * mean_diag) * eye6)
    delta, nonzero = icp_gn.solve6(A, -g)
    ok = torch.isfinite(delta).all() & torch.isfinite(err_ref) & nonzero
    delta = torch.where(ok, delta, 0.0)
    M_new = icp_gn._compose(icp_gn._se3_exp(delta), M_ref)
    sq = delta * delta
    step = ((((sq[0] + sq[1]) + sq[2]) + sq[3]) + sq[4]) + sq[5]
    return torch.cat([M_new.reshape(-1), M_ref.reshape(-1),
                      torch.stack([err_ref, lam_new, step, inlier, mean_r])])


def iterate_plain(pts_w, col_known, pts_valid, rgb, gx, gy, cam, rotation_only: bool,
                  n_iters: int, step_exit: float, state, n_run, more,
                  first: bool = False) -> None:
    """The plain version of `iterate`, in place."""
    n = pts_w.shape[0]
    M = state[0:16].view(4, 4)
    tot = icp_gn.totals(terms(M, pts_w, col_known, pts_valid, rgb, gx, gy, cam,
                              rotation_only, icp_gn.padded_rows(n)))
    state.copy_(lm_step(state, tot, torch.full((), float(n), device=state.device), first))
    n_run.add_(1)
    torch.logical_and(n_run < n_iters, state[STEP] > step_exit, out=more)


def run_plain(pts_w, col_known, pts_valid, rgb, gx, gy, cam, rotation_only: bool,
              n_iters: int, step_exit: float, state, n_run, more, first: bool = False,
              budget: int = 1) -> None:
    """The plain version of `iterate`: `iterate_plain` pass after pass, the
    first always, then while `more` holds (read on the host), at most
    `budget` passes."""
    for k in range(budget):
        if k and not bool(more):
            break
        iterate_plain(pts_w, col_known, pts_valid, rgb, gx, gy, cam, rotation_only, n_iters,
                      step_exit, state, n_run, more, first=first and k == 0)


def iterate(pts_w, col_known, pts_valid, rgb, gx, gy, cam, rotation_only: bool,
            n_iters: int, step_exit: float, state, n_run, more, partials=None,
            first: bool = False, budget: int = 1) -> None:
    """Gauss-Newton iterations (passes) of the level on its carried `state`
    (f32 [STATE_SIZE], `FIELDS`), in place: the first always, then while
    the loop's test `more` holds, at most `budget` in all; `n_run` (0-d
    int64) and `more` (0-d bool) anew after each.  `pts_w`, `col_known`
    [N, 3] f32, `pts_valid` [N] bool; `rgb`, `gx`, `gy` [h, w, 3] f32;
    `cam` [4] (fx, fy, cx, cy of the level).  `first` marks iteration 0
    (its step is always kept).  `partials` (`partials_buffer`) is the
    kernel's scratch.  CPU tensors take the plain version (`run_plain`);
    CUDA tensors launch `color_gn_cuda` once, reading nothing back, or
    raise."""
    if pts_w.device.type != "cuda":
        run_plain(pts_w, col_known, pts_valid, rgb, gx, gy, cam, rotation_only, n_iters,
                  step_exit, state, n_run, more, first, budget)
        return
    k = kernels.COLOR_GN
    n = pts_w.shape[0]
    h, w = rgb.shape[:2]
    for name, t, dtype, shape in (
            ("pts_w", pts_w, torch.float32, (n, 3)),
            ("col_known", col_known, torch.float32, (n, 3)),
            ("pts_valid", pts_valid, torch.bool, (n,)),
            ("rgb", rgb, torch.float32, (h, w, 3)), ("gx", gx, torch.float32, (h, w, 3)),
            ("gy", gy, torch.float32, (h, w, 3)), ("cam", cam, torch.float32, (4,)),
            ("state", state, torch.float32, (STATE_SIZE,)),
            ("n_run", n_run, torch.int64, ()), ("more", more, torch.bool, ()),
            ("partials", partials, torch.float64, (2 * N_TERMS * icp_gn.n_ctas(n) + 1,))):
        if t is None:
            raise ValueError(f"{k.name}: {name} is missing")
        kernels.check_tensor(k, name, t, dtype, shape)
    if budget < 1:
        raise ValueError(f"{k.name}: budget {budget} < 1")
    ctas = icp_gn.n_ctas(n)
    err = k.fn(pts_w.data_ptr(), col_known.data_ptr(), pts_valid.data_ptr(), rgb.data_ptr(),
               gx.data_ptr(), gy.data_ptr(), cam.data_ptr(), state.data_ptr(),
               n_run.data_ptr(), more.data_ptr(), partials.data_ptr(), n, h, w,
               int(rotation_only), icp_gn.rounds(n), ctas, icp_gn.grid(k, ctas), int(first),
               int(n_iters), float(step_exit), int(budget), kernels.stream_ptr())
    k.launches += 1
    kernels.check(k, err)
