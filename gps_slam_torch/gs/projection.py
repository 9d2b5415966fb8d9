"""3D Gaussian projection — the port of gps_slam_tpu/gs/projection.py
`project`: world->camera, quat/scale -> covariance, clamped-Jacobian
perspective projection, 0.3-px blur, conic, 3-sigma radius and culling;
and its analytic backward, which the JAX package leaves to `jax.grad`.

Both are written as plain PyTorch on [N] columns, one elementwise op per
expression in one fixed order (no matmul, no reduction over a small
axis), so that the CUDA kernels `project_sh_fwd` and `project_sh_bwd`
(csrc/gauss_step.cu, reached through `gs/model.ProjectSH`), which round
the same expressions in the same order, give their bits on the card.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Projection(NamedTuple):
    radii: torch.Tensor    # int32 [N] screen radius in px; 0 = culled
    means2d: torch.Tensor  # f32 [N, 2]
    depths: torch.Tensor   # f32 [N] camera z
    conics: torch.Tensor   # f32 [N, 3] upper-triangular inverse 2D covariance


class Camera(NamedTuple):
    """The host scalars of a projection: intrinsics and the clamp limits
    of the Jacobian's tx / ty (computed in f64 on the host; the ops and
    the kernels take them as f32)."""

    fx: float
    fy: float
    cx: float
    cy: float
    lim_x_neg: float
    lim_x_pos: float
    lim_y_neg: float
    lim_y_pos: float


def camera(K, width: int, height: int) -> Camera:
    """`Camera` of the [3, 3] intrinsics K (host numbers or a tensor,
    read once on the host) at `width` x `height`."""
    Kl = K.tolist() if torch.is_tensor(K) else K
    fx, fy, cx, cy = (float(Kl[0][0]), float(Kl[1][1]), float(Kl[0][2]),
                      float(Kl[1][2]))
    tan_fovx = 0.5 * width / fx
    tan_fovy = 0.5 * height / fy
    return Camera(fx, fy, cx, cy,
                  lim_x_neg=cx / fx + 0.3 * tan_fovx,
                  lim_x_pos=(width - cx) / fx + 0.3 * tan_fovx,
                  lim_y_neg=cy / fy + 0.3 * tan_fovy,
                  lim_y_pos=(height - cy) / fy + 0.3 * tan_fovy)


def _dot3(a, b):
    return (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2]


def _sum_terms(terms: list):
    """Left-to-right sum of a list of tensors (the kernels' order)."""
    out = terms[0]
    for t in terms[1:]:
        out = out + t
    return out


def _fma(a, b, c):
    """a b + c rounded once to f32, as a fused multiply-add rounds it: the
    product of two f32 is exact in f64 and the f64 sum is rounded to f32
    (twice rounded, which differs from one rounding only on a f64 result
    that lies exactly halfway between two f32, never met in practice).
    f64 inputs stay f64."""
    return (a.double() * b.double() + c.double()).to(torch.promote_types(a.dtype, b.dtype))


def camera_point(means, viewmat) -> list:
    """The camera point R p + t of each row as three [N] columns, summed
    term by term in the order and with the roundings of the CPU's f32
    matmul `means @ R.T` (a multiply-add chain over the columns of p; the
    JAX package's `mm` on the CPU rounds close to it), then + t.  Not a
    matmul: cuBLAS and a CUDA thread round a 3 x 3 product differently;
    written out, the kernels give the same bits on the card."""
    R = [[viewmat[i, k] for k in range(3)] for i in range(3)]
    p = means.unbind(1)
    return [_fma(R[i][2], p[2], _fma(R[i][1], p[1], R[i][0] * p[0])) + viewmat[i, 3]
            for i in range(3)]


def _rotation(quats):
    """(w, x, y, z normalised, 1 / |q|, the rotation's 3 x 3 entries)."""
    w, x, y, z = quats.unbind(1)
    inv = torch.rsqrt((((w * w + x * x) + y * y) + z * z) + 1e-20)
    w, x, y, z = w * inv, x * inv, y * inv, z * inv
    r = [
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ]
    return (w, x, y, z), inv, r


def _forward_terms(means, quats, scales, viewmat, cam: Camera, eps2d: float) -> dict:
    """Every intermediate of the projection that its backward reads, as
    [N] columns (lists of them for the small matrices)."""
    R = [[viewmat[i, k] for k in range(3)] for i in range(3)]
    mc = camera_point(means, viewmat)
    qn, qinv, r = _rotation(quats)
    s = scales.unbind(1)
    m = [[r[i][k] * s[k] for k in range(3)] for i in range(3)]
    # world covariance M M^T (symmetric: the products commute, so each
    # entry below the diagonal equals its mirror bit for bit)
    cw6 = {(i, j): _dot3(m[i], m[j]) for i in range(3) for j in range(i, 3)}
    cw = [[cw6[min(i, j), max(i, j)] for j in range(3)] for i in range(3)]
    a = [[_dot3(R[i], [cw[0][j], cw[1][j], cw[2][j]]) for j in range(3)]
         for i in range(3)]
    c = {(i, j): _dot3(a[i], R[j]) for i in range(3) for j in range(i, 3)}

    x, y, z = mc
    zsafe = torch.where(z.abs() < 1e-8, 1e-8, z)
    rz = 1.0 / zsafe
    rz2 = rz * rz
    ux, uy = x * rz, y * rz
    tx = z * torch.clamp(ux, -cam.lim_x_neg, cam.lim_x_pos)
    ty = z * torch.clamp(uy, -cam.lim_y_neg, cam.lim_y_pos)
    j00 = cam.fx * rz
    j02 = -cam.fx * tx * rz2
    j11 = cam.fy * rz
    j12 = -cam.fy * ty * rz2
    a00 = j00 * j00 * c[0, 0] + 2.0 * j00 * j02 * c[0, 2] + j02 * j02 * c[2, 2]
    a01 = (j00 * j11 * c[0, 1] + j00 * j12 * c[0, 2] + j02 * j11 * c[1, 2]
           + j02 * j12 * c[2, 2])
    a11 = j11 * j11 * c[1, 1] + 2.0 * j11 * j12 * c[1, 2] + j12 * j12 * c[2, 2]
    a00 = a00 + eps2d
    a11 = a11 + eps2d
    det = a00 * a11 - a01 * a01
    det_ok = det > 0
    det_safe = torch.where(det_ok, det, 1.0)
    return dict(R=R, mc=mc, qn=qn, qinv=qinv, r=r, s=s, m=m, c=c, rz=rz, rz2=rz2, ux=ux,
                uy=uy, tx=tx, ty=ty, j00=j00, j02=j02, j11=j11, j12=j12, a00=a00, a01=a01,
                a11=a11, det_ok=det_ok, det_safe=det_safe)


def project_fwd_plain(means, quats, scales, viewmat, K, width: int, height: int,
                      eps2d: float = 0.3, near_plane: float = 0.01,
                      far_plane: float = 1e10, radius_clip: float = 0.0,
                      valid: torch.Tensor | None = None) -> Projection:
    """means [N, 3] world, quats [N, 4], scales [N, 3] linear, viewmat
    [4, 4] world-to-camera, K [3, 3] (or a `Camera`); the camera point
    is `camera_point`'s."""
    cam = K if isinstance(K, Camera) else camera(K, width, height)
    f = _forward_terms(means, quats, scales, viewmat, cam, eps2d)
    a00, a01, a11, det_safe = f["a00"], f["a01"], f["a11"], f["det_safe"]
    conic = torch.stack([a11 / det_safe, -a01 / det_safe, a00 / det_safe], -1)
    b = 0.5 * (a00 + a11)
    v1 = b + torch.sqrt(torch.clamp(b * b - det_safe, min=0.01))
    radius = torch.ceil(3.0 * torch.sqrt(v1))
    x, y, z = f["mc"]
    u = cam.fx * x * f["rz"] + cam.cx
    v = cam.fy * y * f["rz"] + cam.cy
    cull = ((z < near_plane) | (z > far_plane) | ~f["det_ok"]
            | (radius <= radius_clip)
            | (u + radius <= 0) | (u - radius >= width)
            | (v + radius <= 0) | (v - radius >= height))
    if valid is not None:
        cull = cull | ~valid
    radii = torch.where(cull, 0, radius.clamp(-2 ** 30, 2 ** 30).to(torch.int32))
    return Projection(radii=radii.to(torch.int32), means2d=torch.stack([u, v], -1),
                      depths=z, conics=conic)


project = project_fwd_plain


def project_bwd_plain(means, quats, scales, viewmat, K, width: int, height: int,
                      v_means2d, v_conics, v_depths, eps2d: float = 0.3):
    """The analytic backward of `project_fwd_plain`: the cotangents of
    means2d [N, 2], conics [N, 3] and depths [N] (each may be None: zero)
    -> the grads of means [N, 3], quats [N, 4] and the linear scales
    [N, 3].  The radii and the cull carry no gradient, as in autograd:
    a culled row's grad is what its cotangents give.  Where autograd
    passes no gradient, neither does this: through `zsafe` where |z| <
    1e-8, through det where det <= 0 (det_safe is then the constant 1),
    and through the Jacobian's clamped tx / ty where x / z (y / z) lies
    strictly outside the clamp's limits (torch's clamp passes the gradient
    on a tie with a limit, and so does this)."""
    cam = K if isinstance(K, Camera) else camera(K, width, height)
    f = _forward_terms(means, quats, scales, viewmat, cam, eps2d)
    zero = torch.zeros_like(f["rz"])
    gu, gv = v_means2d.unbind(1) if v_means2d is not None else (zero, zero)
    g0, g1, g2 = v_conics.unbind(1) if v_conics is not None else (zero, zero, zero)
    gz = v_depths if v_depths is not None else zero
    R, (x, y, z), c = f["R"], f["mc"], f["c"]
    rz, rz2, tx, ty = f["rz"], f["rz2"], f["tx"], f["ty"]
    j00, j02, j11, j12 = f["j00"], f["j02"], f["j11"], f["j12"]
    a00, a01, a11, D = f["a00"], f["a01"], f["a11"], f["det_safe"]

    # conic = (a11, -a01, a00) / D, D = a00 a11 - a01^2 where det > 0
    c0, c1, c2 = a11 / D, -a01 / D, a00 / D
    v_D = torch.where(f["det_ok"], -((g0 * c0 + g1 * c1) + g2 * c2) / D, 0.0)
    v_a00 = g2 / D + v_D * a11
    v_a11 = g0 / D + v_D * a00
    v_a01 = -g1 / D + v_D * (-2.0 * a01)

    # cov2d = J C J^T -> the camera covariance and the Jacobian
    v_c = {(0, 0): v_a00 * (j00 * j00),
           (0, 1): v_a01 * (j00 * j11),
           (0, 2): v_a00 * (2.0 * j00 * j02) + v_a01 * (j00 * j12),
           (1, 1): v_a11 * (j11 * j11),
           (1, 2): v_a01 * (j02 * j11) + v_a11 * (2.0 * j11 * j12),
           (2, 2): (v_a00 * (j02 * j02) + v_a01 * (j02 * j12)) + v_a11 * (j12 * j12)}
    v_j00 = (v_a00 * (2.0 * j00 * c[0, 0] + 2.0 * j02 * c[0, 2])
             + v_a01 * (j11 * c[0, 1] + j12 * c[0, 2]))
    v_j02 = (v_a00 * (2.0 * j00 * c[0, 2] + 2.0 * j02 * c[2, 2])
             + v_a01 * (j11 * c[1, 2] + j12 * c[2, 2]))
    v_j11 = (v_a11 * (2.0 * j11 * c[1, 1] + 2.0 * j12 * c[1, 2])
             + v_a01 * (j00 * c[0, 1] + j02 * c[1, 2]))
    v_j12 = (v_a11 * (2.0 * j11 * c[1, 2] + 2.0 * j12 * c[2, 2])
             + v_a01 * (j00 * c[0, 2] + j02 * c[2, 2]))

    # J and the projected mean -> rz, rz2, tx, ty, x, y
    v_tx = -cam.fx * rz2 * v_j02
    v_ty = -cam.fy * rz2 * v_j12
    v_rz2 = -cam.fx * tx * v_j02 + -cam.fy * ty * v_j12
    v_rz = ((((cam.fx * v_j00 + cam.fy * v_j11) + cam.fx * x * gu) + cam.fy * y * gv)
            + 2.0 * rz * v_rz2)
    v_x = cam.fx * rz * gu
    v_y = cam.fy * rz * gv
    # tx = z clamp(x / z): the clamp passes its gradient between its limits
    pass_x = (f["ux"] >= -cam.lim_x_neg) & (f["ux"] <= cam.lim_x_pos)
    pass_y = (f["uy"] >= -cam.lim_y_neg) & (f["uy"] <= cam.lim_y_pos)
    v_ux = torch.where(pass_x, z * v_tx, 0.0)
    v_uy = torch.where(pass_y, z * v_ty, 0.0)
    v_x = v_x + v_ux * rz
    v_y = v_y + v_uy * rz
    v_rz = (v_rz + v_ux * x) + v_uy * y
    v_z = ((gz + torch.clamp(f["ux"], -cam.lim_x_neg, cam.lim_x_pos) * v_tx)
           + torch.clamp(f["uy"], -cam.lim_y_neg, cam.lim_y_pos) * v_ty)
    v_z = v_z + torch.where(z.abs() < 1e-8, 0.0, -(rz * rz) * v_rz)
    v_mc = [v_x, v_y, v_z]
    v_means = torch.stack([_dot3([R[0][k], R[1][k], R[2][k]], v_mc) for k in range(3)], 1)

    # C = Rc Cw Rc^T (upper triangle) -> a = Rc Cw -> Cw
    v_a = [[_sum_terms([v_c[i, j] * R[j][k] for j in range(i, 3)]) for k in range(3)]
           for i in range(3)]
    v_cw = [[_dot3([R[0][k], R[1][k], R[2][k]], [v_a[0][j], v_a[1][j], v_a[2][j]])
             for j in range(3)] for k in range(3)]
    # Cw = M M^T -> M: each entry of the symmetric Cw read in both orders
    G = [[v_cw[i][j] + v_cw[j][i] for j in range(3)] for i in range(3)]
    m = f["m"]
    v_m = [[_dot3(G[i], [m[0][k], m[1][k], m[2][k]]) for k in range(3)] for i in range(3)]
    # M = Rq diag(s)
    r, s = f["r"], f["s"]
    v_s = [_dot3([v_m[0][k], v_m[1][k], v_m[2][k]], [r[0][k], r[1][k], r[2][k]])
           for k in range(3)]
    v = [[v_m[i][k] * s[k] for k in range(3)] for i in range(3)]
    w, qx, qy, qz = f["qn"]
    # Rq of the normalised quaternion -> its entries
    v_w = 2.0 * (((((-qz * v[0][1] + qy * v[0][2]) + qz * v[1][0]) - qx * v[1][2])
                  - qy * v[2][0]) + qx * v[2][1])
    v_qx = 2.0 * (((((((qy * v[0][1] + qz * v[0][2]) + qy * v[1][0]) - 2.0 * qx * v[1][1])
                     - w * v[1][2]) + qz * v[2][0]) + w * v[2][1]) - 2.0 * qx * v[2][2])
    v_qy = 2.0 * (((((((-2.0 * qy * v[0][0] + qx * v[0][1]) + w * v[0][2]) + qx * v[1][0])
                     + qz * v[1][2]) - w * v[2][0]) + qz * v[2][1]) - 2.0 * qy * v[2][2])
    v_qz = 2.0 * (((((((-2.0 * qz * v[0][0] - w * v[0][1]) + qx * v[0][2]) + w * v[1][0])
                     - 2.0 * qz * v[1][1]) + qy * v[1][2]) + qx * v[2][0]) + qy * v[2][1])
    # q / |q|: v_q = (v_qn - (v_qn . qn) qn) / |q|
    inv = f["qinv"]
    dot = ((v_w * w + v_qx * qx) + v_qy * qy) + v_qz * qz
    v_quats = torch.stack([(vq - dot * qq) * inv for vq, qq in
                           ((v_w, w), (v_qx, qx), (v_qy, qy), (v_qz, qz))], 1)
    return v_means, v_quats, torch.stack(v_s, 1)

