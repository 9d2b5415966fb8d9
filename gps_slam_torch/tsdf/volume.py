"""TSDF volume state — the port of gps_slam_tpu/tsdf/volume.py.

Fixed-capacity pools of 8^3 voxel blocks.  The voxel state is one 32-bit
word per voxel, sdf_i16 | w_depth << 16 | w_color << 24, and colour one
rgb888 word; both are int32 tensors with the JAX package's uint32 bits
(weights stop at max_w = 100, so bit 31 is never set).  The summary row
[B, 128] holds the 2x2x2 sdf mip in lanes 0..63, the min integrated sdf
in lane 64 and the max weight in lane 65.  Voxel linear index inside a
block is x + 8*y + 64*z.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import resolve_device
from . import hash as vhash

BLOCK = 8
BLOCK_VOL = BLOCK ** 3
SDF_SCALE = 32767.0
INV_SDF_SCALE = 1.0 / SDF_SCALE
STATE_INIT = 0x7FFF  # sdf = +1, w_depth = 0, w_color = 0


def state_sdf_i32(state: torch.Tensor) -> torch.Tensor:
    su = state & 0xFFFF
    return torch.where(su >= 32768, su - 65536, su)


def state_sdf_f32(state: torch.Tensor) -> torch.Tensor:
    return state_sdf_i32(state).to(torch.float32) * INV_SDF_SCALE


def state_w_depth(state: torch.Tensor) -> torch.Tensor:
    return (state >> 16) & 0xFF


def state_w_color(state: torch.Tensor) -> torch.Tensor:
    return (state >> 24) & 0xFF


def pack_state(sdf_f32: torch.Tensor, w_depth, w_color) -> torch.Tensor:
    """(f32 sdf in [-1,1], integer-valued weights) -> packed int32 word."""
    q = torch.round(sdf_f32.clamp(-1.0, 1.0) * SDF_SCALE).to(torch.int32)
    return ((q & 0xFFFF) | (w_depth.to(torch.int32) << 16)
            | (w_color.to(torch.int32) << 24))


def unpack_rgb(p: torch.Tensor) -> torch.Tensor:
    """Packed rgb888 -> float [..., 3] in 0..255."""
    return torch.stack([p & 0xFF, (p >> 8) & 0xFF, (p >> 16) & 0xFF],
                       dim=-1).to(torch.float32)


def unpack_color_np(packed) -> np.ndarray:
    """Host rgb888 words (uint32, or int32 with the same bits) -> uint8
    [..., 3]."""
    p = np.asarray(packed).view(np.uint32)
    return np.stack([p & 0xFF, (p >> 8) & 0xFF, (p >> 16) & 0xFF],
                    axis=-1).astype(np.uint8)


@dataclass(frozen=True)
class TsdfParams:
    """Static scene parameters: the fields of the JAX package's TsdfParams
    that the port reads, with the same defaults."""

    voxel_size: float = 0.005
    mu: float = 0.02
    max_w: int = 100
    frustum_min: float = 0.2
    frustum_max: float = 10.0
    hash_size: int = 2 ** 21
    block_capacity: int = 2 ** 18
    max_probes: int = 8
    visible_capacity: int = 2 ** 15
    alloc_steps: int = 4
    alloc_stride: int = 2
    alloc_candidate_cap: int = 2 ** 15
    raycast_lb: int = 24
    raycast_samples: int = 4
    raycast_bisect: int = 6


@dataclass
class TsdfVolume:
    params: TsdfParams
    table_keys: torch.Tensor    # int32 [H/W, W] packed block keys (EMPTY = free)
    table_ptrs: torch.Tensor    # int32 [H/W, W] block-pool index or -1
    block_coords: torch.Tensor  # int32 [B] pool index -> packed key
    state: torch.Tensor         # int32 [B, 512] packed voxel state
    color: torch.Tensor         # int32 [B, 512] packed rgb888
    n_blocks: int               # allocated prefix of the pool
    summary: torch.Tensor       # f32 [B, 128]
    last_seen: torch.Tensor     # int32 [B]
    n_visible: int = 0          # the last fused frame's candidate blocks, before the cap

    @property
    def device(self) -> torch.device:
        return self.state.device


def init_summary(B: int, device=None) -> torch.Tensor:
    row = torch.cat([torch.ones(65), torch.zeros(63)])
    return row.to(device).expand(B, 128).contiguous()


def table_width(params: TsdfParams) -> int:
    return max(params.max_probes, min(128, params.hash_size))


def create(params: TsdfParams, device) -> TsdfVolume:
    """An empty volume on `device` (None means the card)."""
    device = resolve_device(device)
    H, B = params.hash_size, params.block_capacity
    assert H & (H - 1) == 0, "hash_size must be a power of two"
    W = table_width(params)
    i32 = dict(dtype=torch.int32, device=device)
    return TsdfVolume(
        params=params,
        table_keys=torch.full((H // W, W), vhash.EMPTY, **i32),
        table_ptrs=torch.full((H // W, W), -1, **i32),
        block_coords=torch.full((B,), vhash.EMPTY, **i32),
        state=torch.full((B, BLOCK_VOL), STATE_INIT, **i32),
        color=torch.zeros((B, BLOCK_VOL), **i32),
        n_blocks=0,
        summary=init_summary(B, device),
        last_seen=torch.full((B,), -1, **i32),
    )
