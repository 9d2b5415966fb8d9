"""Classic 3DGS densification on the fixed-capacity pool (clone, split,
prune, opacity reset) for the offline `raw` trainer — the port of
gps_slam_tpu/gs/densify.py.

From the screen-space gradient norms accumulated over visible iterations:
high-gradient small Gaussians are cloned, high-gradient large ones split
into two samples drawn from themselves (scales / 1.6, the original
pruned); low-opacity Gaussians are pruned, and after the first opacity
reset so are those larger than 0.1 x the scene scale.  Clones and split
samples fill free pool rows, lowest first; prunes clear `alive`.  The
caller zeroes the Adam moments of every touched row
(`optim.zero_state_rows`).
"""

from __future__ import annotations

import torch

from ..utils.se3 import quat_to_rotmat
from . import params as pmod
from .params import GaussianPool

PAUSE_REFINE_AFTER_RESET = 100  # iterations without densify after an opacity reset
N_SPLIT_SAMPLES = 2
SPLIT_SIZE_FAC = 1.6


def _first_rows(mask: torch.Tensor, size: int) -> torch.Tensor:
    """The first `size` indices where `mask` holds, padded with len(mask)
    (the JAX package's nonzero(size=, fill_value=C))."""
    C = mask.shape[0]
    idx = torch.nonzero(mask)[:, 0][:size]
    pad = torch.full((size - idx.shape[0],), C, dtype=idx.dtype, device=idx.device)
    return torch.cat([idx, pad])


def split_noise_shape(max_new: int) -> tuple[int, int]:
    """The shape of the split samples' standard normal draw."""
    return (max_new // 2 // N_SPLIT_SAMPLES * N_SPLIT_SAMPLES, 3)


@torch.no_grad()
def densify_step(pool: GaussianPool, grad_2d: torch.Tensor,
                 visible_count: torch.Tensor, generator: torch.Generator | None,
                 scene_scale: torch.Tensor, thresholds: torch.Tensor,
                 max_new: int, allow_scale_prune: bool = False,
                 noise: torch.Tensor | None = None):
    """One densification round, in place.  `thresholds` is the f32 tensor
    [grad_thres, large_thres, (unused), prune_opacity]; `scene_scale` an
    f32 tensor.  The split offsets are R diag(scale) n with n drawn from
    `generator`, or `noise` (shape `split_noise_shape(max_new)`) when
    given.  Returns (pool, touched rows [C] bool, stats of host ints)."""
    grad_thres, large_thres, prune_opac = thresholds[0], thresholds[1], thresholds[3]
    grads = grad_2d / torch.clamp(visible_count, min=1.0)
    is_high = (grads > grad_thres) & pool.alive
    is_large = torch.exp(pool.scales).amax(-1) > large_thres * scene_scale
    is_dupli = is_high & ~is_large
    is_split = is_high & is_large
    C = pool.capacity
    half = max_new // 2

    # clones: straight copies of up to `half` candidates
    dup_idx = _first_rows(is_dupli, half)
    dup_ok = dup_idx < C
    n_dup = int(dup_ok.sum())
    safe_dup = torch.where(dup_ok, dup_idx, 0)
    dup_attrs = {k: getattr(pool, k)[safe_dup] for k in pmod.ROW_KEYS}

    # splits: N_SPLIT_SAMPLES samples around each candidate, scales / 1.6
    n_split_cand = half // N_SPLIT_SAMPLES
    split_idx = _first_rows(is_split, n_split_cand)
    split_ok = split_idx < C
    n_split = int(split_ok.sum())
    safe_split = torch.where(split_ok, split_idx, 0)
    rep = safe_split.repeat(N_SPLIT_SAMPLES)
    rep_ok = split_ok.repeat(N_SPLIT_SAMPLES)
    if noise is None:
        noise = torch.randn(split_noise_shape(max_new), generator=generator,
                            device=pool.device)
    sc = torch.exp(pool.scales[rep])
    R = quat_to_rotmat(pool.quats[rep])
    offs = (R @ (sc * noise)[..., None])[..., 0]
    split_attrs = {k: getattr(pool, k)[rep] for k in pmod.ROW_KEYS}
    split_attrs["means"] = split_attrs["means"] + offs
    split_attrs["scales"] = torch.log(torch.clamp(sc / SPLIT_SIZE_FAC, min=1e-12))

    # clones then splits, valid rows first, so that `add` takes a prefix
    valid_rows = torch.cat([dup_ok, rep_ok])
    order = torch.argsort((~valid_rows).to(torch.int8), stable=True)
    attrs = {k: torch.cat([dup_attrs[k], split_attrs[k]])[order] for k in pmod.ROW_KEYS}
    alive_before = pool.alive.clone()
    pmod.add(pool, attrs, n_dup + n_split * N_SPLIT_SAMPLES)
    new_rows = pool.alive & ~alive_before

    # prune: low opacity, the split originals, (after a reset) huge scales
    opac = torch.sigmoid(pool.opacities[:, 0])
    is_prune = (opac < prune_opac) & pool.alive & ~new_rows
    is_prune = is_prune | (is_split & ~new_rows)
    if allow_scale_prune:
        big = torch.exp(pool.scales).amax(-1) > 0.1 * scene_scale
        is_prune = is_prune | (big & pool.alive & ~new_rows)
    n_pruned = int(is_prune.sum())
    pmod.remove(pool, is_prune)
    touched = new_rows | is_prune
    return pool, touched, {"n_dup": n_dup, "n_split": n_split, "n_pruned": n_pruned}


@torch.no_grad()
def reset_opacities(pool: GaussianPool, target: torch.Tensor) -> GaussianPool:
    """Clamp the opacity logits at logit(target), in place."""
    logit = torch.log(target / (1.0 - target))
    pool.opacities.copy_(torch.minimum(pool.opacities, logit))
    return pool
