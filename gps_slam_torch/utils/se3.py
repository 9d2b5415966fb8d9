"""SE(3)/quaternion helpers on torch tensors — the subset of
gps_slam_tpu/utils/se3.py that the gt-pose slice uses.

Quaternions use the (w, x, y, z) convention.  All math is f32 and works
on any device.
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
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=c2w.dtype,
                          device=c2w.device).expand(*top.shape[:-2], 1, 4)
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
    wx = torch.tensor([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], dtype=img.dtype,
                      device=img.device)
    wy = torch.tensor([[-1, -2, -1], [0, 0, 0], [1, 2, 1]], dtype=img.dtype,
                      device=img.device)
    x = img.permute(2, 0, 1)[:, None]                       # [C,1,H,W]
    x = F.pad(x, (1, 1, 1, 1), mode="replicate")
    dx = F.conv2d(x, wx[None, None])
    dy = F.conv2d(x, wy[None, None])
    return dx[:, 0].permute(1, 2, 0), dy[:, 0].permute(1, 2, 0)


def compute_normal_map(vertex_map: torch.Tensor) -> torch.Tensor:
    """Normals from a vertex map via Sobel gradients + cross product;
    pixels with z <= 0 get zero normals."""
    dx, dy = _sobel(vertex_map)
    normal = torch.linalg.cross(dy, dx, dim=-1)
    mag = torch.linalg.norm(normal, dim=-1, keepdim=True)
    normal = normal / (mag + 1e-8)
    invalid = vertex_map[..., 2:3] <= 0
    return torch.where(invalid, torch.zeros_like(normal), normal)


def transform_points(points: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """Apply a 4x4 transform to [..., 3] points."""
    return points @ T[:3, :3].T + T[:3, 3]
