"""Real spherical-harmonics colour evaluation, degrees 0-4 — the port of
gps_slam_tpu/gs/sh.py — and its analytic backward (`eval_sh_bwd_plain`),
which the JAX package leaves to `jax.grad`.  Both round their
expressions in the order of the CUDA kernels `project_sh_fwd` and
`project_sh_bwd` (csrc/gauss_step.cu)."""

from __future__ import annotations

import torch

C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
      -1.0925484305920792, 0.5462742152960396)
C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
      0.3731763325901154, -0.4570457994644658, 1.445305721320277,
      -0.5900435899266435)
C4 = (2.5033429417967046, -1.7701307697799304, 0.9461746957575601,
      -0.6690465435572892, 0.10578554691520431, -0.6690465435572892,
      0.47308734787878004, -1.7701307697799304, 0.6258357354491761)


def num_sh_bases(degree: int) -> int:
    return (degree + 1) ** 2


def rgb_to_sh(rgb: torch.Tensor) -> torch.Tensor:
    return (rgb - 0.5) / C0


def eval_sh(degree: int, dirs: torch.Tensor, coeffs: torch.Tensor,
            mask: torch.Tensor | None = None,
            active_degree: torch.Tensor | None = None) -> torch.Tensor:
    """dirs [N, 3] (not necessarily normalized), coeffs [N, K, 3] with
    K >= num_sh_bases(degree), optional visibility mask [N] (invisible ->
    zeros).  `active_degree`, an optional int tensor, zeroes the bands
    above it (the offline trainers' SH warm-up ramp) without changing the
    code path; `degree` stays the bound.  Returns colours [N, 3] before
    the +0.5 offset."""
    def band(b, x):
        # (active >= b) * x is 0 or x exactly, as the JAX ramp multiplies
        return x if active_degree is None else (active_degree >= b).to(x.dtype) * x

    # summed term by term, in the order of project_sh_fwd (csrc/gauss_step.cu)
    norm2 = ((dirs[:, 0:1] * dirs[:, 0:1] + dirs[:, 1:2] * dirs[:, 1:2])
             + dirs[:, 2:3] * dirs[:, 2:3])
    d = dirs * torch.rsqrt(norm2 + 1e-20)
    x, y, z = d[..., 0:1], d[..., 1:2], d[..., 2:3]
    res = C0 * coeffs[:, 0]
    if degree >= 1:
        res = res + band(1, C1 * (
            -y * coeffs[:, 1] + z * coeffs[:, 2] - x * coeffs[:, 3]))
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        res = res + band(2, (
            C2[0] * xy * coeffs[:, 4]
            + C2[1] * yz * coeffs[:, 5]
            + C2[2] * (2.0 * zz - xx - yy) * coeffs[:, 6]
            + C2[3] * xz * coeffs[:, 7]
            + C2[4] * (xx - yy) * coeffs[:, 8]
        ))
    if degree >= 3:
        res = res + band(3, (
            C3[0] * y * (3.0 * xx - yy) * coeffs[:, 9]
            + C3[1] * xy * z * coeffs[:, 10]
            + C3[2] * y * (4.0 * zz - xx - yy) * coeffs[:, 11]
            + C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy) * coeffs[:, 12]
            + C3[4] * x * (4.0 * zz - xx - yy) * coeffs[:, 13]
            + C3[5] * z * (xx - yy) * coeffs[:, 14]
            + C3[6] * x * (xx - 3.0 * yy) * coeffs[:, 15]
        ))
    if degree >= 4:
        res = res + band(4, (
            C4[0] * xy * (xx - yy) * coeffs[:, 16]
            + C4[1] * yz * (3.0 * xx - yy) * coeffs[:, 17]
            + C4[2] * xy * (7.0 * zz - 1.0) * coeffs[:, 18]
            + C4[3] * yz * (7.0 * zz - 3.0) * coeffs[:, 19]
            + C4[4] * (zz * (35.0 * zz - 30.0) + 3.0) * coeffs[:, 20]
            + C4[5] * xz * (7.0 * zz - 3.0) * coeffs[:, 21]
            + C4[6] * (xx - yy) * (7.0 * zz - 1.0) * coeffs[:, 22]
            + C4[7] * xz * (xx - 3.0 * yy) * coeffs[:, 23]
            + C4[8] * (xx * (xx - 3.0 * yy) - yy * (3.0 * xx - yy)) * coeffs[:, 24]
        ))
    if mask is not None:
        res = torch.where(mask[:, None], res, 0.0)
    return res


def _basis(degree: int, x, y, z) -> list:
    """The SH basis of the unit direction (x, y, z) ([N] columns), up to
    `degree`: [(band, value, (d/dx, d/dy, d/dz))] in coefficient order;
    a derivative of None is zero, a float a constant (band 0's value
    is C0)."""
    xx, yy, zz = x * x, y * y, z * z
    xy, yz, xz = x * y, y * z, x * z
    out = [(0, None, (None, None, None))]
    if degree >= 1:
        out += [(1, -C1 * y, (None, -C1, None)),
                (1, C1 * z, (None, None, C1)),
                (1, -C1 * x, (-C1, None, None))]
    if degree >= 2:
        c = C2
        out += [(2, c[0] * xy, (c[0] * y, c[0] * x, None)),
                (2, c[1] * yz, (None, c[1] * z, c[1] * y)),
                (2, c[2] * (2.0 * zz - xx - yy),
                 (c[2] * (-2.0 * x), c[2] * (-2.0 * y), c[2] * (4.0 * z))),
                (2, c[3] * xz, (c[3] * z, None, c[3] * x)),
                (2, c[4] * (xx - yy), (c[4] * (2.0 * x), c[4] * (-2.0 * y), None))]
    if degree >= 3:
        c = C3
        out += [(3, c[0] * y * (3.0 * xx - yy),
                 (c[0] * (6.0 * xy), c[0] * (3.0 * xx - 3.0 * yy), None)),
                (3, c[1] * xy * z, (c[1] * yz, c[1] * xz, c[1] * xy)),
                (3, c[2] * y * (4.0 * zz - xx - yy),
                 (c[2] * (-2.0 * xy), c[2] * (4.0 * zz - xx - 3.0 * yy),
                  c[2] * (8.0 * yz))),
                (3, c[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
                 (c[3] * (-6.0 * xz), c[3] * (-6.0 * yz),
                  c[3] * (6.0 * zz - 3.0 * xx - 3.0 * yy))),
                (3, c[4] * x * (4.0 * zz - xx - yy),
                 (c[4] * (4.0 * zz - 3.0 * xx - yy), c[4] * (-2.0 * xy),
                  c[4] * (8.0 * xz))),
                (3, c[5] * z * (xx - yy),
                 (c[5] * (2.0 * xz), c[5] * (-2.0 * yz), c[5] * (xx - yy))),
                (3, c[6] * x * (xx - 3.0 * yy),
                 (c[6] * (3.0 * xx - 3.0 * yy), c[6] * (-6.0 * xy), None))]
    if degree >= 4:
        c = C4
        out += [(4, c[0] * xy * (xx - yy),
                 (c[0] * y * (3.0 * xx - yy), c[0] * x * (xx - 3.0 * yy), None)),
                (4, c[1] * yz * (3.0 * xx - yy),
                 (c[1] * (6.0 * xy) * z, c[1] * z * (3.0 * xx - 3.0 * yy),
                  c[1] * y * (3.0 * xx - yy))),
                (4, c[2] * xy * (7.0 * zz - 1.0),
                 (c[2] * y * (7.0 * zz - 1.0), c[2] * x * (7.0 * zz - 1.0),
                  c[2] * (14.0 * xy) * z)),
                (4, c[3] * yz * (7.0 * zz - 3.0),
                 (None, c[3] * z * (7.0 * zz - 3.0), c[3] * y * (21.0 * zz - 3.0))),
                (4, c[4] * (zz * (35.0 * zz - 30.0) + 3.0),
                 (None, None, c[4] * z * (140.0 * zz - 60.0))),
                (4, c[5] * xz * (7.0 * zz - 3.0),
                 (c[5] * z * (7.0 * zz - 3.0), None, c[5] * x * (21.0 * zz - 3.0))),
                (4, c[6] * (xx - yy) * (7.0 * zz - 1.0),
                 (c[6] * (2.0 * x) * (7.0 * zz - 1.0), c[6] * (-2.0 * y) * (7.0 * zz - 1.0),
                  c[6] * (xx - yy) * (14.0 * z))),
                (4, c[7] * xz * (xx - 3.0 * yy),
                 (c[7] * z * (3.0 * xx - 3.0 * yy), c[7] * (-6.0 * xy) * z,
                  c[7] * x * (xx - 3.0 * yy))),
                (4, c[8] * (xx * (xx - 3.0 * yy) - yy * (3.0 * xx - yy)),
                 (c[8] * (4.0 * x) * (xx - 3.0 * yy), c[8] * (4.0 * y) * (yy - 3.0 * xx),
                  None))]
    return out


def eval_sh_bwd_plain(degree: int, dirs: torch.Tensor, coeffs: torch.Tensor,
                      v_colors: torch.Tensor, mask: torch.Tensor | None = None,
                      active_degree: torch.Tensor | None = None):
    """The analytic backward of clamp(eval_sh(degree, dirs, coeffs, mask,
    active_degree) + 0.5, min=0): the cotangent `v_colors` [N, 3] -> the
    grads of coeffs [N, K, 3] and of dirs [N, 3].  The clamp passes the
    gradient where colour + 0.5 >= 0 (torch's clamp passes a tie), a
    masked row and a band above `active_degree` get none, coefficients
    past num_sh_bases(degree) get zeros, and the direction's grad goes
    back through its normalisation.  Written on [N] columns in the order
    of `project_sh_bwd`."""
    N, K = coeffs.shape[:2]
    res = eval_sh(degree, dirs, coeffs, mask, active_degree)
    g = torch.where(res + 0.5 >= 0.0, v_colors, 0.0)
    if mask is not None:
        g = torch.where(mask[:, None], g, 0.0)
    gc = g.unbind(1)
    dx, dy, dz = dirs.unbind(1)
    inv = torch.rsqrt(((dx * dx + dy * dy) + dz * dz) + 1e-20)
    x, y, z = dx * inv, dy * inv, dz * inv
    v_coeffs = torch.zeros_like(coeffs)
    v_d = [None, None, None]
    band_g = {}
    for k, (band, value, grads) in enumerate(_basis(degree, x, y, z)):
        if band not in band_g:
            # band 0 is never cut (eval_sh adds it unscaled)
            f = (None if active_degree is None or band == 0
                 else (active_degree >= band).to(torch.float32))
            band_g[band] = [gi if f is None else f * gi for gi in gc]
        w = band_g[band]
        if value is None:          # the constant band 0
            for ch in range(3):
                v_coeffs[:, k, ch] = C0 * w[ch]
            continue
        for ch in range(3):
            v_coeffs[:, k, ch] = w[ch] * value
        # the coefficients' row weighted by the cotangent, over the channels
        s = (w[0] * coeffs[:, k, 0] + w[1] * coeffs[:, k, 1]) + w[2] * coeffs[:, k, 2]
        for j, dj in enumerate(grads):
            if dj is not None:
                v_d[j] = s * dj if v_d[j] is None else v_d[j] + s * dj
    v_d = [torch.zeros_like(x) if t is None else t for t in v_d]
    # d = dirs / |dirs|: v_dirs = (v_d - (v_d . d) d) / |dirs|
    dot = (v_d[0] * x + v_d[1] * y) + v_d[2] * z
    v_dirs = torch.stack([(v_d[j] - dot * (x, y, z)[j]) * inv for j in range(3)], 1)
    return v_coeffs, v_dirs
