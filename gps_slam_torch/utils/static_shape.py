"""Fixed-shape forms of the data-dependent selections of the window
megastep (`slam/megastep.py`): what `jnp.nonzero(..., size=,
fill_value=)` is to the JAX package.  Nothing here reads a tensor back to
the host, so a CUDA graph can capture it."""

from __future__ import annotations

import torch


def nonzero_static(mask: torch.Tensor, size: int, fill: int) -> torch.Tensor:
    """int64 [size]: the indices of the True entries of the 1-D `mask` in
    order, the first `size` of them, then `fill`.  The k-th True entry is
    the first index where the running count of True entries reaches k."""
    csum = torch.cumsum(mask.to(torch.int64), 0)
    want = torch.arange(1, size + 1, dtype=torch.int64, device=mask.device)
    idx = torch.searchsorted(csum, want)
    return torch.where(idx < mask.shape[0], idx, fill)
