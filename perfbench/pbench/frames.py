"""The benchmark's RGB-D stream, made on the device from the seed.

A torch copy of the synthetic scene of `gps_slam_torch/data/synthetic.py`
(a 4 x 3 x 4 m room with an inner box, closed-form ray casts, a smooth
plus checker texture), frozen here so that the yardstick does not move
with the program.  With all phases 0 it renders what `render_frame`
renders (tests/test_pb_frames.py holds the two together at 160x120).

The seed sets the texture's three colour phases and the orbit's starting
angle; every seed gets the same trajectory shape, the same frame count
and the same sizes.  Frames are kept in the program's wire format (rgb
u8, depth u16 at 0.2 mm: `gps_slam_torch/data/device_cache.py`), 4.1 MB a
1200x680 frame.
"""

from __future__ import annotations

import math

import numpy as np
import torch

ROOM = (4.0, 3.0, 4.0)
BOX_MIN = (1.4, 0.0, 1.6)
BOX_MAX = (2.4, 1.2, 2.6)
DEPTH_SCALE = 5000.0   # the wire format's u16 depth: 0.2 mm steps


def seed_draw(seed: int) -> dict:
    """The seed's texture phases and orbit start (radians)."""
    rng = np.random.default_rng(int(seed) % (2 ** 63))
    ph = rng.uniform(0.0, 2.0 * math.pi, size=4)
    return {"phases": tuple(float(v) for v in ph[:3]), "start": float(ph[3])}


def orbit_poses(n: int, period: int, start: float, look: str = "in",
                radius: float = 0.8) -> np.ndarray:
    """[n, 4, 4] c2w poses of `synthetic.orbit_poses`' trajectory with a
    full turn every `period` frames, from angle `start` (y-down camera:
    x right, y down, z forward)."""
    center = np.asarray(ROOM, np.float32) * 0.5
    out = np.zeros((n, 4, 4), np.float32)
    for k in range(n):
        ang = start + 2.0 * np.pi * k / period
        if look == "in":
            eye = center + np.array([1.6 * np.cos(ang), 0.4 + 0.1 * np.sin(3 * ang),
                                     1.6 * np.sin(ang)], dtype=np.float32)
            target = np.array([2.0, 1.0, 2.1], dtype=np.float32)
        else:
            eye = center + np.array([radius * np.cos(ang), 0.15 * np.sin(3 * ang),
                                     radius * np.sin(ang)], dtype=np.float32)
            target = center + np.array([2.5 * np.cos(ang + 0.35), 0.3 * np.sin(2 * ang),
                                        2.5 * np.sin(ang + 0.35)], dtype=np.float32)
        z = target - eye
        z = z / np.linalg.norm(z)
        up = np.array([0.0, -1.0, 0.0], dtype=np.float32)
        x = np.cross(up, z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        out[k] = np.eye(4, dtype=np.float32)
        out[k, :3, 0], out[k, :3, 1], out[k, :3, 2], out[k, :3, 3] = x, y, z, eye
    return out


def _texture(p: torch.Tensor, wall: torch.Tensor, phases) -> torch.Tensor:
    u = p[..., 0] * 1.7 + p[..., 1] * 0.9
    v = p[..., 2] * 1.3 + p[..., 1] * 0.5
    checker = torch.remainder(torch.floor(u * 2.0) + torch.floor(v * 2.0), 2.0)
    base = torch.stack([
        0.5 + 0.35 * torch.sin(1.9 * u + 0.7 * wall + phases[0]),
        0.5 + 0.35 * torch.sin(2.3 * v + 1.3 * wall + phases[1]),
        0.5 + 0.35 * torch.sin(1.1 * (u + v) + 2.1 * wall + phases[2]),
    ], dim=-1)
    return torch.clamp(base * (0.75 + 0.25 * checker[..., None]), 0.0, 1.0)


def render(c2w: torch.Tensor, width: int, height: int, fx: float, fy: float,
           cx: float, cy: float, phases=(0.0, 0.0, 0.0)):
    """(rgb f32 [B, H, W, 3] in [0, 1], depth f32 [B, H, W] in metres) of
    the poses c2w [B, 4, 4], on their device."""
    dev = c2w.device
    f32 = dict(dtype=torch.float32, device=dev)
    i = torch.arange(width, **f32)[None, :]
    j = torch.arange(height, **f32)[:, None]
    x = ((i - cx) / fx).expand(height, width)
    y = ((j - cy) / fy).expand(height, width)
    dirs_c = torch.stack([x, y, torch.ones_like(x)], dim=-1)          # [H, W, 3]
    R, t = c2w[:, :3, :3], c2w[:, :3, 3]
    dirs = torch.einsum("hwk,bjk->bhwj", dirs_c, R)                    # dirs_c @ R^T
    org = t[:, None, None, :].expand_as(dirs)
    eps = 1e-9
    inv = 1.0 / torch.where(dirs.abs() < eps, torch.full_like(dirs, eps), dirs)
    room = torch.tensor(ROOM, **f32)
    t_all = torch.cat([(0.0 - org) * inv, (room - org) * inv], dim=-1)
    t_all = torch.where(t_all <= 1e-6, torch.full_like(t_all, math.inf), t_all)
    t_room, wall = t_all.min(dim=-1)
    bmin, bmax = torch.tensor(BOX_MIN, **f32), torch.tensor(BOX_MAX, **f32)
    t0, t1 = (bmin - org) * inv, (bmax - org) * inv
    t_near = torch.minimum(t0, t1).amax(dim=-1)
    t_far = torch.maximum(t0, t1).amin(dim=-1)
    hit = (t_near <= t_far) & (t_far > 1e-6) & (t_near > 1e-6)
    t_box = torch.where(hit, t_near, torch.full_like(t_near, math.inf))
    use_box = t_box < t_room
    tt = torch.where(use_box, t_box, t_room)
    surf = torch.where(use_box, torch.full_like(tt, 6.0), wall.to(torch.float32))
    p = org + tt[..., None] * dirs
    return _texture(p, surf, phases), tt


def quantize(rgb: torch.Tensor, depth: torch.Tensor):
    """f32 frames -> the wire format: (rgb u8, depth as int16 holding the
    u16 bits), as `device_cache.quantize` rounds."""
    rgb_u8 = torch.clamp(rgb * 255.0 + 0.5, 0, 255).to(torch.uint8)
    d = torch.clamp(depth * DEPTH_SCALE + 0.5, 0, 65535).to(torch.int32)
    return rgb_u8, d.to(torch.int16)


def wire_depth_i32(depth_i16: torch.Tensor) -> torch.Tensor:
    """The u16 depth of the wire format as int32 (the program's layout)."""
    return depth_i16.to(torch.int32) & 0xFFFF


class FrameStore:
    """One closed orbit of `period` frames in the wire format on `device`,
    and the stream's poses: frame k of the stream is orbit frame k %
    period."""

    def __init__(self, seed: int, period: int, look: str, width: int, height: int,
                 K, device, batch: int = 16):
        d = seed_draw(seed)
        self.period, self.width, self.height = int(period), int(width), int(height)
        self.K = np.asarray(K, np.float32)
        self.poses = orbit_poses(self.period, self.period, d["start"], look)
        fx, fy, cx, cy = (float(v) for v in (self.K[0, 0], self.K[1, 1],
                                             self.K[0, 2], self.K[1, 2]))
        self.rgb = torch.empty((self.period, height, width, 3), dtype=torch.uint8,
                               device=device)
        self.depth = torch.empty((self.period, height, width), dtype=torch.int16,
                                 device=device)
        poses = torch.as_tensor(self.poses, device=device)
        for a in range(0, self.period, batch):
            rgb, depth = render(poses[a:a + batch], width, height, fx, fy, cx, cy,
                                d["phases"])
            self.rgb[a:a + batch], self.depth[a:a + batch] = quantize(rgb, depth)

    def pose(self, k: int) -> np.ndarray:
        return self.poses[k % self.period]

    def wire(self, k: int):
        """(rgb u8 [H, W, 3], depth int32 [H, W] of u16 values) of stream
        frame k."""
        j = k % self.period
        return self.rgb[j], wire_depth_i32(self.depth[j])

    def f32(self, k: int):
        """(rgb f32 [H, W, 3] in [0, 1], depth f32 [H, W] in metres) of
        stream frame k, converted as the program converts the wire."""
        rgb, d = self.wire(k)
        return rgb.to(torch.float32) / 255.0, d.to(torch.float32) / DEPTH_SCALE
