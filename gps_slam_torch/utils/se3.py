"""SE(3)/quaternion helpers on torch tensors — the port of
gps_slam_tpu/utils/se3.py.

Quaternions use the (w, x, y, z) convention.  All math is f32 and works
on any device; nothing here reads a tensor back to the host.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def pose_inv(c2w: torch.Tensor) -> torch.Tensor:
    """Invert a rigid 4x4 transform analytically.  The translation is
    summed term by term, not by a matmul: CPU and CUDA matmuls round a
    3x3 product differently, and one ulp of translation can move a voxel's
    nearest tap across a pixel edge, so fusion on the card would stop
    matching fusion on the CPU."""
    R = c2w[..., :3, :3]
    t = c2w[..., :3, 3:4]
    Rt = R.transpose(-1, -2)
    t_inv = -(Rt[..., :, 0:1] * t[..., 0:1, :] + Rt[..., :, 1:2] * t[..., 1:2, :]
              + Rt[..., :, 2:3] * t[..., 2:3, :])
    top = torch.cat([Rt, t_inv], dim=-1)
    # filled on the device (`t[i] = 1.0` copies a host scalar, which a
    # CUDA graph cannot capture)
    bottom = c2w.new_zeros(4)
    bottom[3:].fill_(1.0)
    bottom = bottom.expand(*top.shape[:-2], 1, 4)
    return torch.cat([top, bottom], dim=-2)


def quat_to_rotmat(quat: torch.Tensor) -> torch.Tensor:
    """(w,x,y,z) quaternion (not necessarily normalized) -> 3x3 rotation."""
    w, x, y, z = quat[..., 0], quat[..., 1], quat[..., 2], quat[..., 3]
    inv_norm = torch.rsqrt(w * w + x * x + y * y + z * z)
    w, x, y, z = w * inv_norm, x * inv_norm, y * inv_norm, z * inv_norm
    x2, y2, z2 = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([
        1.0 - 2.0 * (y2 + z2), 2.0 * (xy - wz), 2.0 * (xz + wy),
        2.0 * (xy + wz), 1.0 - 2.0 * (x2 + z2), 2.0 * (yz - wx),
        2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (x2 + y2),
    ], dim=-1)
    return m.reshape(*quat.shape[:-1], 3, 3)


def rotmat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """3x3 rotation -> (w,x,y,z) quaternion, branch-free: all four
    candidate component sets are computed and the one keyed to the largest
    diagonal combination is selected."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(v):
        return torch.sqrt(torch.clamp(v, min=1e-12))

    s0 = safe_sqrt(tr + 1.0) * 2.0
    q0 = torch.stack([0.25 * s0, (m21 - m12) / s0, (m02 - m20) / s0, (m10 - m01) / s0], -1)
    s1 = safe_sqrt(1.0 + m00 - m11 - m22) * 2.0
    q1 = torch.stack([(m21 - m12) / s1, 0.25 * s1, (m01 + m10) / s1, (m02 + m20) / s1], -1)
    s2 = safe_sqrt(1.0 + m11 - m00 - m22) * 2.0
    q2 = torch.stack([(m02 - m20) / s2, (m01 + m10) / s2, 0.25 * s2, (m12 + m21) / s2], -1)
    s3 = safe_sqrt(1.0 + m22 - m00 - m11) * 2.0
    q3 = torch.stack([(m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3, 0.25 * s3], -1)

    cond_tr = (tr > 0.0)[..., None]
    cond_0 = ((m00 >= m11) & (m00 >= m22))[..., None]
    cond_1 = (m11 >= m22)[..., None]
    q = torch.where(cond_tr, q0, torch.where(cond_0, q1, torch.where(cond_1, q2, q3)))
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def quat_from_axis_angle(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    naxis = axis / (torch.linalg.norm(axis, dim=-1, keepdim=True) + 1e-8)
    half = angle * 0.5
    return torch.cat([torch.cos(half), naxis * torch.sin(half)], dim=-1)


def quat_between(init_vec: torch.Tensor, target_vec: torch.Tensor) -> torch.Tensor:
    """Quaternion rotating init_vec onto target_vec; both [..., 3]."""
    axis = torch.linalg.cross(init_vec, target_vec, dim=-1)
    axis = axis / (torch.linalg.norm(axis, dim=-1, keepdim=True) + 1e-8)
    cosang = torch.clamp((init_vec * target_vec).sum(-1, keepdim=True), -1.0, 1.0)
    return quat_from_axis_angle(axis, torch.arccos(cosang))


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """SE(3) exponential map: xi = [rho(3), phi(3)] -> 4x4 transform, with
    the identity rotation and left Jacobian below 1e-8 rad.  Builds every
    constant on xi's device (no host-to-device copy), so the tracker's
    Gauss-Newton loop stays free of synchronising calls."""
    rho, phi = xi[..., :3], xi[..., 3:]
    theta = torch.clamp(torch.linalg.norm(phi, dim=-1, keepdim=True), min=1e-12)
    a = phi / theta
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    zeros = torch.zeros_like(ax)
    K = torch.stack([zeros, -az, ay, az, zeros, -ax, -ay, ax, zeros],
                    dim=-1).reshape(*phi.shape[:-1], 3, 3)
    th = theta[..., None]
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    sin_t, cos_t = torch.sin(th), torch.cos(th)
    small = (theta < 1e-8)[..., None]
    KK = K @ K
    R = torch.where(small, eye, eye + sin_t * K + (1.0 - cos_t) * KK)
    V = torch.where(small, eye,
                    eye + ((1.0 - cos_t) / th) * K + ((th - sin_t) / th) * KK)
    t = V @ rho[..., None]
    top = torch.cat([R, t], dim=-1)
    z = torch.zeros((*top.shape[:-2], 1, 3), dtype=xi.dtype, device=xi.device)
    bottom = torch.cat([z, torch.ones_like(z[..., :1])], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def rot_angle_deg(prev_R: torch.Tensor, curr_R: torch.Tensor) -> torch.Tensor:
    """Angle (degrees) between two rotations."""
    diff = prev_R.T @ curr_R
    cos_theta = torch.clamp((torch.trace(diff) - 1.0) * 0.5, -1.0, 1.0)
    return torch.rad2deg(torch.arccos(cos_theta))


def trans_dist(prev_t: torch.Tensor, curr_t: torch.Tensor) -> torch.Tensor:
    """L2 translation distance."""
    return torch.linalg.norm(prev_t - curr_t)


def compute_vertex_map(depth: torch.Tensor, fx, fy, cx, cy) -> torch.Tensor:
    """Back-project a depth map [H, W] or [H, W, 1] to camera-space
    vertices [H, W, 3]."""
    if depth.ndim == 3:
        depth = depth[..., 0]
    H, W = depth.shape
    i = torch.arange(W, dtype=depth.dtype, device=depth.device)[None, :]
    j = torch.arange(H, dtype=depth.dtype, device=depth.device)[:, None]
    x = ((i - cx) / fx).expand(H, W)
    y = ((j - cy) / fy).expand(H, W)
    return torch.stack([x, y, torch.ones_like(x)], dim=-1) * depth[..., None]


def _sobel(img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Replicate-padded Sobel gradients per channel, [H,W,C] -> dx, dy
    (cross-correlation, no normalization)."""
    # [-1, 0, 1] and [1, 2, 1] made on the device (no host-to-device copy)
    d = torch.arange(3, dtype=img.dtype, device=img.device) - 1.0
    s = 2.0 - d.abs()
    wx = s[:, None] * d[None, :]    # [[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]]
    wy = d[:, None] * s[None, :]    # [[-1, -2, -1], [0, 0, 0], [1, 2, 1]]
    x = img.permute(2, 0, 1)[:, None]                       # [C,1,H,W]
    x = F.pad(x, (1, 1, 1, 1), mode="replicate")
    dx = F.conv2d(x, wx[None, None])
    dy = F.conv2d(x, wy[None, None])
    return dx[:, 0].permute(1, 2, 0), dy[:, 0].permute(1, 2, 0)


def sobel_normals(vertex_map: torch.Tensor) -> torch.Tensor:
    """Unit normals of a vertex map [H, W, 3] via Sobel gradients + cross
    product, at every pixel."""
    dx, dy = _sobel(vertex_map)
    normal = torch.linalg.cross(dy, dx, dim=-1)
    mag = torch.linalg.norm(normal, dim=-1, keepdim=True)
    return normal / (mag + 1e-8)


def compute_normal_map(vertex_map: torch.Tensor) -> torch.Tensor:
    """Normals from a vertex map via Sobel gradients + cross product;
    pixels with z <= 0 get zero normals."""
    normal = sobel_normals(vertex_map)
    invalid = vertex_map[..., 2:3] <= 0
    return torch.where(invalid, torch.zeros_like(normal), normal)


def transform_points(points: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """Apply a 4x4 transform to [..., 3] points."""
    return points @ T[:3, :3].T + T[:3, 3]


def bilateral_filter_depth(depth: torch.Tensor) -> torch.Tensor:
    """Edge-preserving 5x5 bilateral depth filter (the reference's
    ViewBuilder filterDepth): spatial kernel exp(-0.5 (|i|+|j|) sigma_L^2)
    and the Kinect noise-model range sigma; the 25 taps are shifted slices
    of a zero-padded plane, and invalid (<= 0) depths pass through as 0."""
    z = depth
    valid = z > 0.0
    SIG_L = 1.2232
    sigma_z = 1.0 / (
        0.0012
        + 0.0019 * (z - 0.4) ** 2
        + 0.0001 / torch.sqrt(torch.clamp(z, min=1e-3)) * 0.25
    )
    H, W = z.shape
    zp = F.pad(z, (2, 2, 2, 2))
    wsum = torch.zeros_like(z)
    acc = torch.zeros_like(z)
    for i in range(-2, 3):
        for j in range(-2, 3):
            nb = zp[2 + i:2 + i + H, 2 + j:2 + j + W]
            ok = nb > 0.0
            dz2 = (nb - z) ** 2
            w = torch.exp(
                -0.5 * ((abs(i) + abs(j)) * SIG_L * SIG_L
                        + dz2 * sigma_z * sigma_z)
            ) * ok.to(z.dtype)
            wsum = wsum + w
            acc = acc + w * nb
    out = acc / torch.clamp(wsum, min=1e-12)
    return torch.where(valid, out, 0.0)
