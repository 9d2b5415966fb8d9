"""Fixed-shape forms of the data-dependent selections and writes of the
megasteps (`slam/megastep.py`, the fusion and tracked frames of
`tsdf/engine.py`): what `jnp.nonzero(..., size=, fill_value=)` and
`.at[].set(mode="drop")` are to the JAX package.  Nothing here reads a
tensor back to the host, so a CUDA graph can capture it."""

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


def set_rows(pool: torch.Tensor, rows: torch.Tensor, values: torch.Tensor,
             mask: torch.Tensor) -> None:
    """pool[rows[mask]] = values[mask] in place, over every entry: the
    rows where `mask` holds are distinct.  A masked entry writes the row
    and the value of the first live entry instead (with no live entry,
    row 0's own value back into row 0), so every write into a row carries
    the same value and duplicate targets land the same in any order."""
    if mask.numel() == 0:
        return
    live = mask.any()
    src = torch.where(mask, torch.arange(mask.shape[0], device=mask.device),
                      mask.to(torch.int8).argmax())
    tgt = torch.where(live, rows[src].to(torch.int64), 0)
    live_v = live.reshape((1,) * values.dim())
    pool[tgt] = torch.where(live_v, values[src], pool[:1])
