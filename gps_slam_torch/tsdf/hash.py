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
           block_capacity: int, claim_rounds: int | None = None):
    """`insert_static` with the allocated count on the host: returns
    (n_blocks, ptrs), reading the new count back once."""
    nb, ptrs = insert_static(
        table_keys, table_ptrs,
        torch.full((), n_blocks, dtype=torch.int64, device=packed.device),
        block_coords, packed, max_probes, block_capacity, claim_rounds)
    return int(nb), ptrs


def insert_static(table_keys: torch.Tensor, table_ptrs: torch.Tensor,
                  n_blocks: torch.Tensor, block_coords: torch.Tensor,
                  packed: torch.Tensor, max_probes: int, block_capacity: int,
                  claim_rounds: int | None = None):
    """Insert UNIQUE candidate keys (EMPTY = skip) and allocate pool rows
    for the new ones in claim order, reading nothing back to the host (a
    CUDA graph can capture it).  Same rounds and race discipline as the JAX
    `insert`: each round writes unresolved candidates into their bucket's
    first EMPTY slot, the next round's re-read decides the winner and
    losers retry.  Updates the table tensors and `block_coords` in place.
    `n_blocks` is a 0-d int64 device count; returns (the new count, the
    per-candidate pool rows: -1 for EMPTY and dropped candidates).

    Every write takes every candidate.  A masked candidate (a loser, one
    with no claim, a key that did not get a row) adds 0 to an element
    instead of writing: the writes are `scatter_add_`s of the difference
    between the new and the present value, which each live target has
    exactly once, so duplicate targets land the same in any order (the
    JAX package's `mode="drop"` writes)."""
    R, W = table_keys.shape
    assert W % max_probes == 0, (table_keys.shape, max_probes)
    mp = max_probes
    valid = packed != EMPTY
    row, gmask = _buckets(packed, R, W, mp)
    resolved = ~valid
    my_col = torch.full_like(packed, W, dtype=torch.int64)
    rounds = min(mp, mp if claim_rounds is None else claim_rounds)
    flat_keys = table_keys.view(-1)
    none = R * W   # the claim target of a candidate that makes no claim
    zero = torch.zeros_like(packed)
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
        idx = torch.where(want, row * W + e_col, none)
        # candidates racing for one slot: the last one writes, as a
        # sequential scatter does (on CUDA duplicate-index writes land in
        # no fixed order); the claims sort first, in candidate order, the
        # non-claims after them
        order = torch.argsort(idx, stable=True)
        s = idx[order]
        last = torch.ones_like(s, dtype=torch.bool)
        last[:-1] = s[1:] != s[:-1]
        win = torch.empty_like(last).scatter_(0, order, last & (s < none))
        # a won slot is EMPTY until this write: it becomes the key
        flat_keys.scatter_add_(0, torch.where(win, idx, 0),
                               torch.where(win, packed - EMPTY, zero))

    col_safe = my_col.clamp(max=W - 1)
    my_ptr = ptrs_row.gather(1, col_safe[:, None])[:, 0]
    is_new = resolved & valid & (my_ptr < 0)
    new_ptr = n_blocks + torch.cumsum(is_new.to(torch.int64), 0) - 1
    fits = is_new & (new_ptr < block_capacity)
    slot = row * W + col_safe
    # a new key's slot holds pointer -1 and the key itself
    table_ptrs.view(-1).scatter_add_(
        0, slot, torch.where(fits, new_ptr.to(torch.int32) + 1, zero))
    # overflow: un-insert keys that could not get a block this frame
    flat_keys.scatter_add_(0, slot, torch.where(is_new & ~fits, EMPTY - packed, zero))
    crow = torch.where(fits, new_ptr, 0)
    block_coords.scatter_add_(
        0, crow, torch.where(fits, packed - block_coords[crow], zero))
    p = torch.where(fits, new_ptr, my_ptr.to(torch.int64))
    ptrs = torch.where(resolved & valid & (p >= 0), p, -1).to(torch.int32)
    return n_blocks + fits.sum(), ptrs
