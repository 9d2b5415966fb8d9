"""The Gauss-Newton loop of an ICP pyramid level: the CUDA kernel
`icp_gn_cuda` (csrc/icp_gn.cu), which runs the level's passes in one
cooperative launch, and its plain PyTorch version, one pass
(`iterate_plain`) run in a loop that reads the loop's test (`run_plain`).

The counterpart of the JAX tracker's per-level `lax.while_loop` (its body
`gn_iter` and its test, gps_slam_tpu/slam/tracker.py:150-233), which XLA
compiles into one program; it replaces no `pallas_call`.  One iteration
(a pass) at the level's estimate T:

  * per pixel: the camera point from the level's depth, its world point,
    its projection into the raycast camera, the bilinear vertex and normal
    reads (a corner whose value is all zero left out of the weights), the
    renormalised normal, the point-to-plane residual r, the association
    test, the Tukey weight w and the Jacobian Jt = [n ; p_w x n] (the
    rotation columns alone on the rotation-only levels);
  * 45 sums over the pixels, in f64 of f32 terms (`N_TERMS`): the 36
    entries f64(Jt_i w) f64(Jt_j) of H (not symmetric in their bits: Jt w
    is rounded to f32 first), the 6 f64(Jt_i w) f64(r) of g, sum |r| w,
    sum w and the inlier count;
  * the Levenberg-Marquardt step on the level's carried state (`FIELDS`):
    accept, or roll back to the accepted system with 10x damping; the
    damped 6x6 solve by LU with partial pivoting in f32 (a zero pivot or a
    non-finite solution gives a zero step); se3_exp(delta) T_ref; the
    loop's test `more` (`n_run < n_iters` and the squared step above
    `STEP_EXIT`).

The plain version writes each f32 expression out term by term in one
fixed order (no matmul, no reduction over a small axis, true divisions by
device tensors), and takes the pixel sums in the kernel's order
(`cta_sums`), so that on the card it gives the kernel's bits.  f64 sums of
the f32 terms round to the same f32 in any order but near a rounding
boundary (`tests/test_torch_icp_gn.py` holds the order against the single
sum); the LM accept/reject turns on last bits, so the order is fixed.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels

NT = 256          # threads of a CTA
NW = NT // 32     # warps of a CTA
PIX = 2           # pixels a thread takes a round, added before its warp sums
# the grid at most: 2 CTAs an SM of the H100's 132 at the kernel's <= 128
# registers a thread, one wave (the level kernel's grid barrier needs every
# CTA resident)
MAX_CTAS = 264
N_TERMS = 45      # H (36, row-major), g (6), sum |r| w, sum w, inliers
# the level's carried state, one f32 buffer that the step updates in place
FIELDS = (("T", (4, 4)), ("T_acc", (4, 4)), ("H_acc", (6, 6)), ("g_acc", (6,)),
          ("err_acc", ()), ("lam", ()), ("step", ()), ("inlier", ()), ("mean_r", ()))
STATE_SIZE = 79


def rounds(n_pix: int) -> int:
    """The kernel's rounds: each thread takes PIX pixels a round, so that
    the grid stays within MAX_CTAS CTAs."""
    return max(1, -(-n_pix // (NT * PIX * MAX_CTAS)))


def n_ctas(n_pix: int) -> int:
    """The kernel's grid: the rows of the partial sums."""
    return max(1, -(-n_pix // (NT * PIX * rounds(n_pix))))


def partials_buffer(n_pix: int, device) -> torch.Tensor:
    """The kernel's scratch, zeros: two halves of per-CTA sums [N_TERMS,
    n_ctas] f64 (the passes use them in turn; a launch leaves its last
    pass's rows in the first), then one slot whose bits hold the grid
    barrier's 64-bit count of arrivals (a multiple of n_ctas between
    launches).  Allocated with the level, before its launch."""
    return torch.zeros(2 * N_TERMS * n_ctas(n_pix) + 1, dtype=torch.float64, device=device)


_CAPACITY: dict = {}   # (kernel name, device index) -> CTAs resident at once


def capacity(kernel) -> int:
    """The CTAs the current card holds resident at once for the level
    kernel `kernel` (occupancy x SMs; 0 where it cannot launch a
    cooperative kernel), from its C entry `<entry>_capacity`, queried once
    a card; the query loads the kernel onto the card, which a first
    launch inside a graph capture would otherwise do."""
    key = (kernel.name, torch.cuda.current_device())
    if key not in _CAPACITY:
        n = ctypes.c_int(0)
        kernels.check(kernel, kernel.extra_fn(kernel.entry + "_capacity")(ctypes.byref(n)))
        _CAPACITY[key] = n.value
    return _CAPACITY[key]


def grid(kernel, ctas: int) -> int:
    """The launch's grid for a logical grid of `ctas` CTAs: as many as the
    card holds resident at once, at most `ctas` (each resident CTA takes
    the logical CTAs b, b + grid, ...; the level kernel's grid barrier is
    sound only over resident CTAs, and the cooperative launch is refused
    otherwise).  Raises where the card cannot launch a cooperative
    kernel."""
    held = capacity(kernel)
    if held < 1:
        raise RuntimeError(f"{kernel.name}: this card cannot launch a cooperative kernel")
    return min(ctas, held)


def load() -> None:
    """Load `icp_gn_cuda` onto the current card now (built first if need
    be), which a first launch inside a graph capture would otherwise do,
    and check that the card can launch it cooperatively."""
    grid(kernels.ICP_GN, MAX_CTAS)


def level_points(depth: torch.Tensor, cam: torch.Tensor):
    """A level's camera points [h*w, 3] and their depth mask."""
    dev = depth.device
    h, w = depth.shape
    fx, fy, cx, cy = cam[0], cam[1], cam[2], cam[3]
    i = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    j = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    x = ((i - cx) / fx).expand(h, w)
    y = ((j - cy) / fy).expand(h, w)
    pts_cam = (torch.stack([x, y, torch.ones_like(x)], -1)
               * depth[..., None]).reshape(-1, 3)
    return pts_cam, depth.reshape(-1) > 0


def _affine(M: torch.Tensor, x, y, z) -> list:
    """M[:3, :3] (x, y, z) + M[:3, 3], each row summed term by term:
    ((m0 x + m1 y) + m2 z) + m3."""
    return [((M[i, 0] * x + M[i, 1] * y) + M[i, 2] * z) + M[i, 3] for i in range(3)]


def bilinear(img: torch.Tensor, us: torch.Tensor, vs: torch.Tensor):
    """Bilinear read of [H, W, 3] at float pixel coordinates (us, vs)
    inside the image: ([N, 3], weight sum [N]); a corner whose value is
    all zero (no vertex, no normal) is left out of the weights.  Each
    channel's sum is written out corner by corner (the kernel's order)."""
    H, W = img.shape[:2]
    u0 = torch.floor(us)
    v0 = torch.floor(vs)
    fu = us - u0
    fv = vs - v0
    iu0 = torch.clamp(u0.to(torch.int64), 0, W - 1)
    iv0 = torch.clamp(v0.to(torch.int64), 0, H - 1)
    iu1 = torch.clamp(iu0 + 1, max=W - 1)
    iv1 = torch.clamp(iv0 + 1, max=H - 1)
    flat = img.reshape(-1, 3)
    acc = [torch.zeros_like(us) for _ in range(3)]
    wacc = torch.zeros_like(us)
    for iu, iv, ww in ((iu0, iv0, (1 - fu) * (1 - fv)), (iu1, iv0, fu * (1 - fv)),
                       (iu0, iv1, (1 - fu) * fv), (iu1, iv1, fu * fv)):
        c = flat[iv * W + iu].unbind(1)
        ok = (((c[0].abs() + c[1].abs()) + c[2].abs()) > 1e-6).to(img.dtype)
        acc = [a + (ck * ww) * ok for a, ck in zip(acc, c)]
        wacc = wacc + ww * ok
    den = torch.clamp(wacc, min=1e-6)
    return torch.stack([a / den for a in acc], 1), wacc


def padded_rows(n_pix: int) -> int:
    """The pixels the kernel's grid covers: n_ctas CTAs of NT * PIX *
    rounds (those past n_pix add +0)."""
    return n_ctas(n_pix) * NT * PIX * rounds(n_pix)


def terms(T, pts_cam, has_depth, ref_vertex, ref_normal, cam, ref_pose_inv,
          space_thresh, tukey_c, rotation_only: bool, rows: int | None = None) -> torch.Tensor:
    """The per-pixel terms of the sums at the estimate T: [rows, N_TERMS]
    f64 (see the module's note), rows past the h*w pixels (`rows`,
    default h*w) +0."""
    Hf, Wf = ref_vertex.shape[:2]
    fx0, fy0, cx0, cy0 = cam[4], cam[5], cam[6], cam[7]
    # current points -> world; project into the raycast camera
    pw = _affine(T, *pts_cam.unbind(1))
    pr = _affine(ref_pose_inv, *pw)
    z = pr[2]
    zs = torch.clamp(z, min=1e-6)
    u = fx0 * pr[0] / zs + cx0
    v = fy0 * pr[1] / zs + cy0
    in_img = (z > 0) & (u >= 0) & (u <= Wf - 1) & (v >= 0) & (v <= Hf - 1)
    us = torch.clamp(u, 0.0, Wf - 1.0)
    vs = torch.clamp(v, 0.0, Hf - 1.0)
    vt, wv = bilinear(ref_vertex, us, vs)
    nt, wn = bilinear(ref_normal, us, vs)
    vt, nt = vt.unbind(1), nt.unbind(1)
    nlen = torch.sqrt((nt[0] * nt[0] + nt[1] * nt[1]) + nt[2] * nt[2])
    nl = torch.clamp(nlen, min=1e-6)
    n = [c / nl for c in nt]
    has_ref = (wv > 0.5) & (wn > 0.5) & (nlen > 0.3)
    d = [a - b for a, b in zip(pw, vt)]
    dist2 = (d[0] * d[0] + d[1] * d[1]) + d[2] * d[2]
    r = (n[0] * d[0] + n[1] * d[1]) + n[2] * d[2]
    ok = has_depth & in_img & has_ref & (dist2 < space_thresh * space_thresh)
    # Tukey biweight on the point-to-plane residual
    t = torch.clamp(r / tukey_c, -1.0, 1.0)
    s = 1.0 - t * t
    okf = ok.to(torch.float32)
    wgt = okf * (s * s)
    # d r / d xi = [n ; p_w x n] for a left-multiplied twist on T
    jt = [n[0], n[1], n[2], pw[1] * n[2] - pw[2] * n[1], pw[2] * n[0] - pw[0] * n[2],
          pw[0] * n[1] - pw[1] * n[0]]
    if rotation_only:
        jt[:3] = [c * 0.0 for c in jt[:3]]
    Jt = torch.stack(jt, 1)
    Jw = (Jt * wgt[:, None]).double()
    Jt = Jt.double()
    N = Jt.shape[0]
    out = torch.empty((rows or N, N_TERMS), dtype=torch.float64, device=Jt.device)
    out[N:].zero_()
    torch.mul(Jw[:, :, None], Jt[:, None, :], out=out[:N, :36].unflatten(1, (6, 6)))
    torch.mul(Jw, r.double()[:, None], out=out[:N, 36:42])
    for k, v in ((42, r.abs() * wgt), (43, wgt), (44, okf)):
        out[:N, k].copy_(v)
    return out


def cta_sums(x: torch.Tensor, rounds: int, pix: int = 1) -> torch.Tensor:
    """Column sums of x [M, C] (f64) in the kernel's order: one CTA per
    NT * pix * rounds rows; in round k thread t takes rows (k pix + m) NT
    + t, m < pix, and adds them in m's order; each round's 32 such sums of
    a warp are summed by halving (pairs of lanes 16 apart, then of those
    sums 8 apart, ..., 1), a warp's rounds one after another onto +0, then
    the NW warps' sums by halving.  Rows past M are +0, which changes no
    sum.  Returns the CTAs' sums [ceil(M / (NT pix rounds)), C]."""
    M, C = x.shape
    per = NT * pix * rounds
    n = max(1, -(-M // per))
    if M != n * per:
        x = torch.cat([x, x.new_zeros((n * per - M, C))])
    x = x.view(n, rounds, pix, NW, 32, C)
    y = x[:, :, 0]
    for m in range(1, pix):
        y = y + x[:, :, m]
    for h in (16, 8, 4, 2, 1):
        y = y[:, :, :, :h] + y[:, :, :, h:2 * h]
    acc = y.new_zeros((n, NW, C))
    for k in range(rounds):
        acc = acc + y[:, k, :, 0]
    for h in (NW // 2, NW // 4, NW // 8):
        acc = acc[:, :h] + acc[:, h:2 * h]
    return acc[:, 0]


def cta_rows(x: torch.Tensor) -> torch.Tensor:
    """The kernel's per-CTA sums [n_ctas, C] of the per-pixel terms x
    [N, C] (what it leaves in `partials`, transposed); x may hold the
    grid's +0 rows past the pixels (`padded_rows`): the grid is the
    same."""
    return cta_sums(x, rounds(x.shape[0]), PIX)


def totals(x: torch.Tensor) -> torch.Tensor:
    """The sums [C] of the per-pixel terms x [N, C], as the kernel takes
    them: per CTA, then, in its last CTA, over the CTAs' rows (a row a
    thread a round)."""
    rows = cta_rows(x)
    return cta_sums(rows, -(-rows.shape[0] // NT))[0]


def solve6(A: torch.Tensor, b: torch.Tensor):
    """x with A x = b (6 x 6, f32) by LU with partial pivoting: the pivot
    is the first largest |value| of its column at or below the diagonal
    (NaN counts as largest), the rows below it are eliminated to its
    right, then back substitution subtracts the known unknowns from the
    last one up.  Fixed shapes, no read-back.  Returns (x, no zero
    pivot)."""
    dev = A.device
    idx = torch.arange(6, device=dev)
    nonzero = torch.ones((), dtype=torch.bool, device=dev)
    for k in range(6):
        col = torch.where(idx >= k, A[:, k].abs(), -1.0)
        p = torch.argmax(col)
        perm = torch.where(idx == k, p, torch.where(idx == p, k, idx))
        A, b = A[perm], b[perm]
        nonzero = nonzero & (A[k, k] != 0)
        f = A[:, k] / A[k, k]
        rows = idx > k
        A = torch.where(rows[:, None] & (idx[None, :] > k), A - f[:, None] * A[k][None, :], A)
        b = torch.where(rows, b - f * b[k], b)
    x = torch.zeros_like(b)
    for j in range(5, -1, -1):
        xj = b[j] / A[j, j]
        x = torch.where(idx == j, xj, x)
        b = torch.where(idx < j, b - A[:, j] * xj, b)
    return x, nonzero


def _se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """`utils.se3.se3_exp` of one twist [6] with every sum written out
    term by term: the 4 x 4 transform."""
    dev = xi.device
    rho, phi = xi[:3], xi[3:]
    theta = torch.clamp(torch.sqrt((phi[0] * phi[0] + phi[1] * phi[1]) + phi[2] * phi[2]),
                        min=1e-12)
    a = phi / theta
    zero = torch.zeros_like(theta)
    K = torch.stack([zero, -a[2], a[1], a[2], zero, -a[0], -a[1], a[0], zero]).view(3, 3)
    eye = torch.eye(3, dtype=xi.dtype, device=dev)
    sin_t, cos_t = torch.sin(theta), torch.cos(theta)
    small = theta < 1e-8
    KK = (K[:, 0:1] * K[0:1, :] + K[:, 1:2] * K[1:2, :]) + K[:, 2:3] * K[2:3, :]
    R = torch.where(small, eye, eye + sin_t * K + (1.0 - cos_t) * KK)
    V = torch.where(small, eye,
                    eye + ((1.0 - cos_t) / theta) * K + ((theta - sin_t) / theta) * KK)
    t = (V[:, 0] * rho[0] + V[:, 1] * rho[1]) + V[:, 2] * rho[2]
    bottom = torch.zeros(4, dtype=xi.dtype, device=dev)
    bottom[3:].fill_(1.0)
    return torch.cat([torch.cat([R, t[:, None]], 1), bottom[None]], 0)


def _compose(E: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """E @ T for 4 x 4 matrices, each entry summed term by term."""
    return (((E[:, 0:1] * T[0:1, :] + E[:, 1:2] * T[1:2, :]) + E[:, 2:3] * T[2:3, :])
            + E[:, 3:4] * T[3:4, :])


def lm_step(state: torch.Tensor, tot: torch.Tensor, n_pix: torch.Tensor,
            first: bool) -> torch.Tensor:
    """The Levenberg-Marquardt accept/reject of one iteration on the
    carried state [STATE_SIZE] and the sums `tot` [N_TERMS] (f64, rounded
    to f32 here): a step that raised the error is rolled back and
    re-solved from the accepted system with 10x damping; an improving step
    (or the first) is kept and damping relaxes.  Returns the new state."""
    dev = state.device
    T, T_acc = state[0:16].view(4, 4), state[16:32].view(4, 4)
    H_acc, g_acc = state[32:68].view(6, 6), state[68:74]
    err_acc, lam = state[74], state[75]
    Hm, g = tot[:36].float().view(6, 6), tot[36:42].float()
    n_ok = tot[44].float()
    mean_r = (tot[42] / torch.clamp(tot[43], min=1.0)).float()
    inlier = n_ok / n_pix
    err = torch.where(n_ok > 50, mean_r, float("inf"))
    better = err <= err_acc
    if first:
        better = torch.ones_like(better)
    T_ref = torch.where(better, T, T_acc)
    H_ref = torch.where(better, Hm, H_acc)
    g_ref = torch.where(better, g, g_acc)
    err_ref = torch.where(better, err, err_acc)
    lam_new = torch.clamp(torch.where(better, lam * 0.1, lam * 10.0), 1e-6, 1e5)
    # lambda-scaled diagonal + an absolute floor scaled to the mean
    # diagonal (views of parallel walls make H rank deficient)
    dg = torch.diagonal(H_ref)
    trace = ((((dg[0] + dg[1]) + dg[2]) + dg[3]) + dg[4]) + dg[5]
    mean_diag = trace / torch.full((), 6.0, device=dev) + 1e-6
    eye6 = torch.eye(6, dtype=torch.float32, device=dev)
    A = H_ref + (lam_new * torch.diag(dg) + (1e-2 * mean_diag) * eye6)
    delta, nonzero = solve6(A, -g_ref)
    ok = torch.isfinite(delta).all() & torch.isfinite(err_ref) & nonzero
    delta = torch.where(ok, delta, 0.0)
    T_new = _compose(_se3_exp(delta), T_ref)
    sq = delta * delta
    step = ((((sq[0] + sq[1]) + sq[2]) + sq[3]) + sq[4]) + sq[5]
    return torch.cat([T_new.reshape(-1), T_ref.reshape(-1), H_ref.reshape(-1), g_ref,
                      torch.stack([err_ref, lam_new, step, inlier, mean_r])])


def iterate_plain(depth, ref_vertex, ref_normal, cam, ref_pose_inv, space_thresh,
                  tukey_c, rotation_only: bool, n_iters: int, step_exit: float,
                  state, n_run, more, active=None, first: bool = False) -> None:
    """The plain version of `iterate`, in place."""
    h, w = depth.shape
    pts_cam, has_depth = level_points(depth, cam)
    T = state[0:16].view(4, 4)
    tot = totals(terms(T, pts_cam, has_depth, ref_vertex, ref_normal, cam, ref_pose_inv,
                       space_thresh, tukey_c, rotation_only, padded_rows(h * w)))
    new = lm_step(state, tot, torch.full((), float(h * w), device=depth.device), first)
    if active is None:
        state.copy_(new)
        n_run.add_(1)
    else:
        state.copy_(torch.where(active, new, state))
        n_run.add_(active.to(torch.int64))
    torch.logical_and(n_run < n_iters, state[76] > step_exit, out=more)


def run_plain(depth, ref_vertex, ref_normal, cam, ref_pose_inv, space_thresh, tukey_c,
              rotation_only: bool, n_iters: int, step_exit: float, state, n_run, more,
              first: bool = False, budget: int = 1) -> None:
    """The plain version of `iterate`: `iterate_plain` pass after pass, the
    first always, then while `more` holds (read on the host), at most
    `budget` passes."""
    for k in range(budget):
        if k and not bool(more):
            break
        iterate_plain(depth, ref_vertex, ref_normal, cam, ref_pose_inv, space_thresh,
                      tukey_c, rotation_only, n_iters, step_exit, state, n_run, more,
                      first=first and k == 0)


def iterate(depth, ref_vertex, ref_normal, cam, ref_pose_inv, space_thresh, tukey_c,
            rotation_only: bool, n_iters: int, step_exit: float, state, n_run, more,
            partials=None, first: bool = False, budget: int = 1) -> None:
    """Gauss-Newton iterations (passes) of the level on its carried
    `state` (f32 [STATE_SIZE], `FIELDS`), in place: the first always, then
    while the loop's test `more` holds, at most `budget` in all; `n_run`
    (0-d int64) and `more` (0-d bool) anew after each.  `first` marks
    iteration 0 (its step is always kept).  `partials`
    (`partials_buffer`) is the kernel's scratch.  CPU tensors take the
    plain version (`run_plain`); CUDA tensors launch `icp_gn_cuda` once,
    reading nothing back, or raise."""
    if depth.device.type != "cuda":
        run_plain(depth, ref_vertex, ref_normal, cam, ref_pose_inv, space_thresh, tukey_c,
                  rotation_only, n_iters, step_exit, state, n_run, more, first, budget)
        return
    k = kernels.ICP_GN
    h, w = depth.shape
    Hf, Wf = ref_vertex.shape[:2]
    n_pix = h * w
    for name, t, dtype, shape in (
            ("depth", depth, torch.float32, None),
            ("ref_vertex", ref_vertex, torch.float32, (Hf, Wf, 3)),
            ("ref_normal", ref_normal, torch.float32, (Hf, Wf, 3)),
            ("cam", cam, torch.float32, (8,)), ("ref_pose_inv", ref_pose_inv, torch.float32, (4, 4)),
            ("space_thresh", space_thresh, torch.float32, ()),
            ("tukey_c", tukey_c, torch.float32, ()),
            ("state", state, torch.float32, (STATE_SIZE,)),
            ("n_run", n_run, torch.int64, ()), ("more", more, torch.bool, ()),
            ("partials", partials, torch.float64, (2 * N_TERMS * n_ctas(n_pix) + 1,))):
        if t is None:
            raise ValueError(f"{k.name}: {name} is missing")
        kernels.check_tensor(k, name, t, dtype, shape)
    if budget < 1:
        raise ValueError(f"{k.name}: budget {budget} < 1")
    ctas = n_ctas(n_pix)
    err = k.fn(depth.data_ptr(), ref_vertex.data_ptr(), ref_normal.data_ptr(),
               cam.data_ptr(), ref_pose_inv.data_ptr(), space_thresh.data_ptr(),
               tukey_c.data_ptr(), state.data_ptr(), n_run.data_ptr(), more.data_ptr(),
               partials.data_ptr(), h, w, Hf, Wf, int(rotation_only), rounds(n_pix), ctas,
               grid(k, ctas), int(first), int(n_iters), float(step_exit), int(budget),
               kernels.stream_ptr())
    k.launches += 1
    kernels.check(k, err)
