"""Spatial sharding of the TSDF block pool — the port of
gps_slam_tpu/parallel/spatial.py (`TPU.space_shards`).

Block ownership by key hash: every shard sees the same per-frame
candidate stream, keeps the keys whose hash lands on it
(`integrate.shard_owner`) and allocates and integrates only those blocks
in its own hash table and pool.  The map is the disjoint union of the
shards, so fusion needs no communication; a raycast runs per shard and
merges by nearest hit (the true first crossing along a ray lives in one
shard), and each shard sizes its table and pool at capacity / S.

The port keeps the shards as a list of S ordinary `TsdfVolume`s: each
shard's pools are its own contiguous tensors, so the integrate kernel
(K1/K2) and the raycast march (K3) launch on them as on a single volume,
once per shard.  Shard s lives on card s when there are at least S cards;
otherwise every shard stays on the engine's device (the stacked
single-device form the JAX engine keeps on fewer devices).
"""

from __future__ import annotations

import torch

from .. import resolve_device
from ..tsdf import integrate, raycast_tiles
from ..tsdf.volume import TsdfParams, TsdfVolume, create


def shard_devices(n_shards: int, device) -> list[torch.device]:
    """Shard s on card s when the engine runs on the card and there are at
    least `n_shards` > 1 cards, else every shard on `device`."""
    device = resolve_device(device)
    if n_shards > 1 and device.type == "cuda" and torch.cuda.device_count() >= n_shards:
        return [torch.device("cuda", s) for s in range(n_shards)]
    return [device] * n_shards


def create_sharded(params: TsdfParams, n_shards: int, device) -> list[TsdfVolume]:
    """S empty volumes with `params` (per-shard capacities: the caller
    divides them by S), placed by `shard_devices`."""
    return [create(params, d) for d in shard_devices(n_shards, device)]


def fuse_frame_sharded(shards: list[TsdfVolume], depth: torch.Tensor,
                       rgb: torch.Tensor, c2w: torch.Tensor, K,
                       frame_idx: int | None = None) -> list[TsdfVolume]:
    """One fused frame across all shards: the candidate stream is computed
    once and each shard fuses the keys it owns (one integrate launch per
    shard), in place; one shard is a plain `fuse_frame`."""
    S = len(shards)
    cand = integrate.frame_candidates(shards[0].params, depth, c2w, K)
    for s, vol in enumerate(shards):
        dev = vol.device
        integrate.fuse_frame(vol, depth.to(dev), rgb.to(dev), c2w.to(dev), K,
                             frame_idx=frame_idx, shard_sid=s, shard_n=S,
                             cand=cand.to(dev))
    return shards


def raycast_sharded(shards: list[TsdfVolume], c2w, K, width: int, height: int,
                    lb: int = 24, s_coarse: int = 4, s_refine: int = 8,
                    k_blocks: int = 2, need_color: bool = True,
                    need_normals: bool = True, track: bool = False) -> dict:
    """Per-shard raycast (one K3 launch each) + nearest-hit merge, on the
    first shard's device.  Returns `raycast_tiles.raycast`'s map dict with
    the counts summed over the shards; the normals are recomputed from the
    merged vertex map (a shard's own normals are wrong along its
    silhouettes), by the single-volume raycast's rule.  One shard is the
    single-volume raycast; `track` runs the march's tracking mode."""
    if len(shards) == 1:
        return raycast_tiles.raycast(shards[0], c2w, K, width, height, lb, s_coarse,
                                     s_refine, k_blocks, need_color=need_color,
                                     need_normals=need_normals, track=track)
    maps = [raycast_tiles.raycast(v, c2w, K, width, height, lb, s_coarse,
                                  s_refine, k_blocks, need_color=need_color,
                                  need_normals=False, track=track) for v in shards]
    dev = shards[0].device

    def stacked(key):
        return torch.stack([m[key].to(dev) for m in maps])    # [S, H, W, C]

    depth_s = stacked("depth_map")[..., 0]
    winner = torch.where(depth_s > 0, depth_s, torch.inf).argmin(0)   # [H, W]
    any_hit = (depth_s > 0).any(0)[..., None]

    def pick(key):
        x = stacked(key)
        idx = winner[None, ..., None].expand(1, *x.shape[1:])
        return torch.where(any_hit, x.gather(0, idx)[0], 0.0).contiguous()

    out = {k: pick(k) for k in ("depth_map", "vertex_map", "color_map",
                                "confidence_map")}
    out["normal_map"] = (
        raycast_tiles.hit_normals(out["vertex_map"], out["depth_map"][..., 0])
        if need_normals else torch.zeros_like(out["vertex_map"]))
    for k in raycast_tiles.COUNTS:
        out[k] = sum(m[k] for m in maps)
    return out


def total_blocks(shards: list[TsdfVolume]) -> int:
    return sum(v.n_blocks for v in shards)
