"""Open-addressing voxel-block hash on torch tensors — the port of
gps_slam_tpu/tsdf/hash.py with the same bucket-major table, the same
claim rounds and the same 3-prime xor hash.

torch has no usable uint32, so packed keys live in int32 tensors with the
same bits.  Keys use 30 bits (10 per axis), so every real key is a
non-negative int32 and EMPTY (0xFFFFFFFF) is -1.  Orderings that the JAX
package takes over uint32 (EMPTY sorts last) are reproduced explicitly.
"""

from __future__ import annotations

import torch

COORD_BITS = 10
COORD_OFFSET = 1 << (COORD_BITS - 1)  # 512
COORD_MASK = (1 << COORD_BITS) - 1
EMPTY = -1            # 0xFFFFFFFF as int32
_INT32_MAX = 2 ** 31 - 1

_P1 = 73856093
_P2 = 19349669
_P3 = 83492791


def pack(bx: torch.Tensor, by: torch.Tensor, bz: torch.Tensor) -> torch.Tensor:
    """Pack signed block coords into a 30-bit key (int32)."""
    x = (bx.to(torch.int32) + COORD_OFFSET) & COORD_MASK
    y = (by.to(torch.int32) + COORD_OFFSET) & COORD_MASK
    z = (bz.to(torch.int32) + COORD_OFFSET) & COORD_MASK
    return x | (y << COORD_BITS) | (z << (2 * COORD_BITS))


def unpack(packed: torch.Tensor):
    x = (packed & COORD_MASK) - COORD_OFFSET
    y = ((packed >> COORD_BITS) & COORD_MASK) - COORD_OFFSET
    z = ((packed >> (2 * COORD_BITS)) & COORD_MASK) - COORD_OFFSET
    return x, y, z


def coords_in_range(bx, by, bz) -> torch.Tensor:
    lim = COORD_OFFSET - 1
    return (bx.abs() <= lim) & (by.abs() <= lim) & (bz.abs() <= lim)


def hash_packed(packed: torch.Tensor, table_size: int) -> torch.Tensor:
    """3-prime xor hash masked to the table.  The JAX version multiplies
    int32 coords and relies on the wrap; the low bits of the int64 product
    are the same, so masking the int64 value gives the same index."""
    x, y, z = (c.to(torch.int64) for c in unpack(packed))
    h = (x * _P1) ^ (y * _P2) ^ (z * _P3)
    return (h & (table_size - 1)).to(torch.int32)


def _buckets(packed, R: int, W: int, mp: int):
    bucket = hash_packed(packed, R * W).to(torch.int64) // mp
    gpr = W // mp
    row = bucket // gpr
    lane_g = torch.arange(W, device=packed.device) // mp
    gmask = lane_g[None, :] == (bucket % gpr)[:, None]
    return row, gmask


def lookup(table_keys: torch.Tensor, table_ptrs: torch.Tensor,
           packed: torch.Tensor, max_probes: int) -> torch.Tensor:
    """Block-pool index for each query key, or -1 (any query shape)."""
    R, W = table_keys.shape
    assert W % max_probes == 0, (table_keys.shape, max_probes)
    flat = packed.reshape(-1)
    row, gmask = _buckets(flat, R, W, max_probes)
    match = (table_keys[row] == flat[:, None]) & gmask
    out = torch.where(match, table_ptrs[row], torch.full_like(table_ptrs[row], -1))
    return out.amax(dim=-1).reshape(packed.shape)


def dedup_candidates(packed: torch.Tensor, cap: int) -> torch.Tensor:
    """Unique keys ascending, EMPTY last, cut to `cap` entries."""
    s = torch.sort(torch.where(packed == EMPTY, _INT32_MAX, packed)).values
    first = torch.ones_like(s, dtype=torch.bool)
    first[1:] = s[1:] != s[:-1]
    first &= s != _INT32_MAX
    s2 = torch.sort(torch.where(first, s, _INT32_MAX)).values[:cap]
    return torch.where(s2 == _INT32_MAX, EMPTY, s2)


def insert(table_keys: torch.Tensor, table_ptrs: torch.Tensor, n_blocks: int,
           block_coords: torch.Tensor, packed: torch.Tensor, max_probes: int,
           block_capacity: int, claim_rounds: int | None = None,
           return_ptrs: bool = False):
    """Insert UNIQUE candidate keys (EMPTY = skip) and allocate pool rows
    for the new ones in claim order.  Same rounds and race discipline as
    the JAX `insert`: each round writes unresolved candidates into their
    bucket's first EMPTY slot, the next round's re-read decides the winner
    and losers retry.  Updates the table tensors and `block_coords` in
    place and returns (n_blocks, ptrs or None); `ptrs` is the per-candidate
    pool index (-1 for EMPTY and dropped candidates)."""
    R, W = table_keys.shape
    assert W % max_probes == 0, (table_keys.shape, max_probes)
    mp = max_probes
    valid = packed != EMPTY
    row, gmask = _buckets(packed, R, W, mp)
    resolved = ~valid
    my_col = torch.full_like(packed, W, dtype=torch.int64)
    rounds = min(mp, mp if claim_rounds is None else claim_rounds)
    flat_keys = table_keys.view(-1)
    ptrs_row = None
    for r in range(rounds + 1):
        keys = table_keys[row]                                  # [M, W]
        hitl = (keys == packed[:, None]) & gmask
        hit = (~resolved) & hitl.any(-1)
        my_col = torch.where(hit, hitl.to(torch.int8).argmax(-1), my_col)
        resolved = resolved | hit
        if r == rounds:
            ptrs_row = table_ptrs[row]
            break
        emptyl = (keys == EMPTY) & gmask
        e_col = emptyl.to(torch.int8).argmax(-1)
        want = (~resolved) & emptyl.any(-1)
        idx = row[want] * W + e_col[want]
        # candidates racing for one slot: the last one writes, as a
        # sequential scatter does; on CUDA duplicate-index writes land in
        # no fixed order, so the winners are picked explicitly
        order = torch.argsort(idx, stable=True)
        s = idx[order]
        last = torch.ones_like(s, dtype=torch.bool)
        last[:-1] = s[1:] != s[:-1]
        win = order[last]
        flat_keys[idx[win]] = packed[want][win]

    col_safe = my_col.clamp(max=W - 1)
    my_ptr = ptrs_row.gather(1, col_safe[:, None])[:, 0]
    is_new = resolved & valid & (my_ptr < 0)
    order = torch.cumsum(is_new.to(torch.int64), 0) - 1
    new_ptr = n_blocks + order
    fits = is_new & (new_ptr < block_capacity)
    slot = row * W + col_safe
    table_ptrs.view(-1)[slot[fits]] = new_ptr[fits].to(torch.int32)
    # overflow: un-insert keys that could not get a block this frame
    flat_keys[slot[is_new & ~fits]] = EMPTY
    n_alloc = int(fits.sum())
    block_coords[new_ptr[fits]] = packed[fits]
    ptrs = None
    if return_ptrs:
        p = torch.where(fits, new_ptr, my_ptr.to(torch.int64))
        ptrs = torch.where(resolved & valid & (p >= 0), p, -1).to(torch.int32)
    return n_blocks + n_alloc, ptrs
