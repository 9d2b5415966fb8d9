"""Carry state from numpy arrays (the JAX package's pools, or its files)
into the port's tensors.

`pool_from_numpy` takes a `GaussianPool.params` dict plus `alive`;
`lpips_weights_from_numpy` takes LPIPS(vgg) weights in the npz layout of
both packages (`eval/lpips_torch.weight_names`).  `volume_from_numpy`
takes the fields of a `TsdfVolume` either as
scene.npz stores them (flat table, sdf/w_depth/w_color planes, mip and
per-block min sdf / max weight) or as the in-memory packed fields (`state`
[B, 512] and `summary` [B, 128]).  Unsigned 32-bit words become int32
tensors with the same bits.
"""

from __future__ import annotations

import numpy as np
import torch

from . import resolve_device
from .gs.params import GaussianPool, ROW_KEYS
from .tsdf.volume import TsdfParams, TsdfVolume, init_summary, table_width


def _i32(a) -> np.ndarray:
    a = np.ascontiguousarray(a)
    if a.dtype in (np.uint32, np.int32):
        return a.view(np.int32)
    return a.astype(np.int64).astype(np.uint32).view(np.int32)


def pool_from_numpy(params: dict, alive: np.ndarray, device,
                    sh_degree: int | None = None) -> GaussianPool:
    """A GaussianPool holding `params` (the JAX pool's params dict:
    means, scales, quats, features_dc, features_rest, opacities, exposure)
    and the `alive` mask, rows in the same order, on `device` (None means
    the card)."""
    device = resolve_device(device)
    alive = np.asarray(alive, bool)
    t = {k: torch.as_tensor(np.asarray(params[k], np.float32).copy(), device=device)
         for k in ROW_KEYS + ("exposure",)}
    if t["opacities"].ndim == 1:
        t["opacities"] = t["opacities"][:, None]
    k_rest = t["features_rest"].shape[1]
    deg = sh_degree if sh_degree is not None else int(round((k_rest + 1) ** 0.5)) - 1
    return GaussianPool(
        capacity=alive.shape[0], sh_degree=deg, alive=torch.as_tensor(alive.copy(), device=device),
        n_alive=int(alive.sum()), **t)


def volume_from_numpy(arrays: dict, params: TsdfParams, device) -> TsdfVolume:
    """A TsdfVolume from scene.npz-style (or packed in-memory) arrays, on
    `device` (None means the card)."""
    device = resolve_device(device)
    W = table_width(params)
    if "state" in arrays:
        state = _i32(arrays["state"])
    else:
        sdf = np.asarray(arrays["sdf"])
        if sdf.dtype != np.int16:
            sdf = np.round(np.clip(sdf, -1, 1) * 32767.0).astype(np.int16)
        su = sdf.astype(np.int32) & 0xFFFF
        state = (su | (np.asarray(arrays["w_depth"]).astype(np.int32) << 16)
                 | (np.asarray(arrays["w_color"]).astype(np.int32) << 24)).astype(np.int32)
    col = np.asarray(arrays["color"])
    if col.ndim == 3:
        c = col.astype(np.uint32)
        col = c[..., 0] | (c[..., 1] << 8) | (c[..., 2] << 16)
    B = state.shape[0]
    if "summary" in arrays:
        summary = np.asarray(arrays["summary"], np.float32)
    else:
        summary = init_summary(B).numpy().copy()
        if "mip" in arrays:
            summary[:, :64] = arrays["mip"]
        if "block_min_sdf" in arrays:
            summary[:, 64] = arrays["block_min_sdf"]
        if "block_max_w" in arrays:
            summary[:, 65] = np.asarray(arrays["block_max_w"]).astype(np.float32)
    last_seen = (np.asarray(arrays["last_seen"], np.int32) if "last_seen" in arrays
                 else np.full((B,), -1, np.int32))

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a).copy(), device=device)

    return TsdfVolume(
        params=params,
        table_keys=dev(_i32(arrays["table_keys"]).reshape(-1, W)),
        table_ptrs=dev(np.asarray(arrays["table_ptrs"], np.int32).reshape(-1, W)),
        block_coords=dev(_i32(arrays["block_coords"])),
        state=dev(state),
        color=dev(_i32(col)),
        n_blocks=int(np.asarray(arrays["n_blocks"])),
        summary=dev(summary),
        last_seen=dev(last_seen),
    )


def lpips_weights_from_numpy(weights: dict, device) -> dict:
    """LPIPS(vgg) weights in the npz layout (conv weights HWIO, as the JAX
    package's `lax.conv` reads them) -> tensors for `F.conv2d` (OIHW) on
    `device` (None means the card); biases and head weights as they are."""
    device = resolve_device(device)
    return {k: torch.as_tensor(np.ascontiguousarray(
                np.transpose(v, (3, 2, 0, 1)) if k.endswith("_w") and np.ndim(v) == 4
                else v), dtype=torch.float32, device=device)
            for k, v in weights.items()}
