"""Fixed-capacity Gaussian parameter pool — the port of
gps_slam_tpu/gs/params.py.  The JAX `GaussianPool` struct becomes a small
dataclass of tensors; `add`, `remove` and `compact` update it in place.
`add_rows` and `remove_rows` are their fixed-shape forms (the JAX
package's): no host read, the count changed as a device scalar, the host
count `n_alive` left to the caller; `compact` writes the pool's own
storage, so a captured CUDA graph keeps addressing it."""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from .. import resolve_device
from ..utils.se3 import quat_between
from . import knn, sh

PARAM_KEYS = ("means", "scales", "quats", "features_dc", "features_rest",
              "opacities", "exposure")
ROW_KEYS = PARAM_KEYS[:-1]


@dataclass
class GaussianPool:
    capacity: int
    sh_degree: int
    means: torch.Tensor          # [C, 3]
    scales: torch.Tensor         # [C, 3] log
    quats: torch.Tensor          # [C, 4] (w,x,y,z)
    features_dc: torch.Tensor    # [C, 3]
    features_rest: torch.Tensor  # [C, K-1, 3]
    opacities: torch.Tensor      # [C, 1] logit
    exposure: torch.Tensor       # [E, 3, 4]
    alive: torch.Tensor          # [C] bool
    n_alive: int

    @property
    def params(self) -> dict:
        return {k: getattr(self, k) for k in PARAM_KEYS}

    @property
    def device(self) -> torch.device:
        return self.means.device


def create(capacity: int, sh_degree: int, exposure_num: int = 0, *,
           device) -> GaussianPool:
    """An empty pool on `device` (None means the card)."""
    device = resolve_device(device)
    k = sh.num_sh_bases(sh_degree)
    e = max(exposure_num, 1)
    f32 = dict(dtype=torch.float32, device=device)
    quats = torch.zeros((capacity, 4), **f32)
    quats[:, 0] = 1.0
    return GaussianPool(
        capacity=capacity, sh_degree=sh_degree,
        means=torch.zeros((capacity, 3), **f32),
        scales=torch.full((capacity, 3), -10.0, **f32),
        quats=quats,
        features_dc=torch.zeros((capacity, 3), **f32),
        features_rest=torch.zeros((capacity, k - 1, 3), **f32),
        opacities=torch.full((capacity, 1), -10.0, **f32),
        exposure=torch.eye(3, 4, **f32)[None].repeat(e, 1, 1),
        alive=torch.zeros(capacity, dtype=torch.bool, device=device),
        n_alive=0,
    )


def init_attributes(xyz, rgb, normals, sh_degree: int, default_opacity: float,
                    max_init_scale: float, min_init_scale: float) -> dict:
    """New-Gaussian attributes: scale = sqrt(mean 3-NN dist^2) clamped;
    with normals the z axis is flattened x0.1 and aligned to the normal;
    SH dc from rgb; opacity = logit(default)."""
    m = xyz.shape[0]
    near = xyz.abs().amax(-1) < 1e5
    d2 = knn.mean_dist_sq_3nn_morton(xyz, valid=near)
    s = torch.sqrt(torch.clamp(d2, min=1e-12))
    if min_init_scale > 0:
        s = torch.clamp(s, min_init_scale, max_init_scale)
    else:
        s = torch.clamp(s, max=max_init_scale)
    scales = s[:, None].repeat(1, 3)
    # constants filled on the device (`t[i] = 1.0` copies a host scalar,
    # which a CUDA graph cannot capture)
    ident = xyz.new_zeros(4)
    ident[:1].fill_(1.0)
    if normals is not None:
        scales[:, 2] = scales[:, 2] * 0.1
        z_axis = torch.zeros_like(xyz)
        z_axis[:, 2].fill_(1.0)
        quats = quat_between(z_axis, normals)
        ok = torch.linalg.norm(normals, dim=-1) > 0.5
        quats = torch.where(ok[:, None], quats, ident)
    else:
        quats = ident.expand(m, 4).clone()
    k = sh.num_sh_bases(sh_degree)
    logit = math.log(default_opacity / (1.0 - default_opacity))
    return {
        "means": xyz,
        "scales": torch.log(torch.clamp(scales, min=1e-12)),
        "quats": quats,
        "features_dc": sh.rgb_to_sh(rgb),
        "features_rest": torch.zeros((m, k - 1, 3), device=xyz.device),
        "opacities": torch.full((m, 1), logit, device=xyz.device),
    }


def add(pool: GaussianPool, attrs: dict, count: int) -> GaussianPool:
    """Scatter the first `count` rows of `attrs` into free pool slots
    (lowest free indices first); overflow beyond capacity is dropped.
    `add_rows` with the host count."""
    pool.n_alive += int(add_rows(pool, attrs, count))
    return pool


def add_rows(pool: GaussianPool, attrs: dict, count) -> torch.Tensor:
    """Row j < min(count, m) of `attrs` to the j-th free slot, in place,
    in fixed shapes (the JAX package's `add`); `count` is an int or a
    device scalar.  Returns the rows placed as a device scalar;
    `pool.n_alive` is not touched.  Every pool row is rewritten with
    itself or its new value: one pass over the pool, no host read."""
    m = attrs["means"].shape[0]
    if m == 0:
        return torch.zeros((), dtype=torch.int64, device=pool.alive.device)
    free = ~pool.alive
    # rank of each free row among the free rows: row r takes attrs[rank]
    rank = torch.cumsum(free.to(torch.int64), 0) - 1
    sel = free & (rank < count) & (rank < m)
    src = rank.clamp(0, m - 1)
    for k in ROW_KEYS:
        dst = getattr(pool, k)
        new = attrs[k].to(dst.dtype)[src]
        dst.copy_(torch.where(sel.reshape((-1,) + (1,) * (dst.ndim - 1)), new, dst))
    pool.alive |= sel
    return sel.sum()


def remove(pool: GaussianPool, remove_mask: torch.Tensor) -> GaussianPool:
    """`remove_rows` with the host count."""
    pool.n_alive -= int(remove_rows(pool, remove_mask))
    return pool


def remove_rows(pool: GaussianPool, remove_mask: torch.Tensor) -> torch.Tensor:
    """Clear the live rows of `remove_mask` in place and return how many
    there were, as a device scalar; `pool.n_alive` is not touched."""
    kill = remove_mask & pool.alive
    pool.alive &= ~kill
    return kill.sum()


def compact(pool: GaussianPool) -> GaussianPool:
    """Stable-permute live rows to the pool prefix, in the pool's own
    storage."""
    order = torch.argsort((~pool.alive).to(torch.int8), stable=True)
    for k in ROW_KEYS + ("alive",):
        t = getattr(pool, k)
        t.copy_(t[order])
    return pool
