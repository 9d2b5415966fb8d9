"""Iso-surface extraction with per-vertex colour — the port's own copy of
gps_slam_tpu/tsdf/meshing.py.

Marching tetrahedra ("mt": each cell split into 6 tetrahedra sharing the
main diagonal) or classic marching cubes ("mc", the 256-case table derived
from cube topology at import), with trilinearly interpolated voxel
colours.  Meshing runs on the host at save time, as in the JAX package:
the allocated prefix of the volume is copied off the device once
(`host_volume`), then meshed by the native OpenMP mesher
(`native/mesher.cpp` through `native.py`) or by the numpy route below,
which is its test oracle.  The port keeps packed words in int32 tensors;
the host copy views them as uint32 before any shift.
"""

from __future__ import annotations

import numpy as np

from .hash import COORD_BITS, COORD_MASK, COORD_OFFSET
from .volume import BLOCK, TsdfVolume

# tetrahedron decomposition of the unit cube: corner ids use bit0=x,
# bit1=y, bit2=z; all 6 tets share the 0-7 main diagonal
_TETS = np.array(
    [
        [0, 1, 3, 7],
        [0, 3, 2, 7],
        [0, 2, 6, 7],
        [0, 6, 4, 7],
        [0, 4, 5, 7],
        [0, 5, 1, 7],
    ],
    dtype=np.int32,
)

# tet edges as (corner, corner) pairs: e01,e02,e03,e12,e13,e23
_TET_EDGES = np.array(
    [[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], dtype=np.int32
)

# case table: for each 4-bit "inside" mask (bit i = tet corner i has
# sdf < 0), up to 2 triangles of edge indices; -1 padded.
_CASES = -np.ones((16, 2, 3), dtype=np.int32)


def _set_case(mask, tris):
    for k, t in enumerate(tris):
        _CASES[mask, k] = t


_set_case(0b0001, [[0, 1, 2]])
_set_case(0b0010, [[0, 4, 3]])
_set_case(0b0100, [[1, 3, 5]])
_set_case(0b1000, [[2, 5, 4]])
_set_case(0b0011, [[1, 2, 4], [1, 4, 3]])
_set_case(0b0101, [[0, 2, 5], [0, 5, 3]])
_set_case(0b1001, [[0, 4, 5], [0, 5, 1]])
# complements: same surface, reversed winding
for _m in range(1, 15):
    _comp = 0b1111 ^ _m
    if _CASES[_m, 0, 0] == -1 and _CASES[_comp, 0, 0] != -1:
        for _k in range(2):
            if _CASES[_comp, _k, 0] != -1:
                _CASES[_m, _k] = _CASES[_comp, _k][::-1]

_CUBE_CORNERS = np.array(
    [[(c >> 0) & 1, (c >> 1) & 1, (c >> 2) & 1] for c in range(8)], dtype=np.int32
)

# ---------------------------------------------------------------------------
# Classic marching cubes (reference-topology mode, algo="mc")
#
# The reference meshes with the standard 256-case MC table
# (InfiniTAM/ITMLib/Engines/Meshing/Shared/ITMMeshingEngine_Shared.h:22).
# Rather than transcribing that table, we *derive* it from cube topology at
# import time: for each of the 256 sign configurations the iso-surface
# crosses a known set of cube edges; on every cube face the crossed edges
# pair up into arcs (an ambiguous 4-crossing face is resolved by keeping
# diagonal inside-corners separated — the same convention as the standard
# table); arcs chain into closed polygons which are fan-triangulated and
# oriented so normals point from sdf<0 to sdf>=0.  Vertex placement (linear
# interpolation on cube edges) is identical to the reference's, so
# triangulations match the standard table's up to polygon fan order.

# 12 cube edges, axis-major: x-edges (0,1)(2,3)(4,5)(6,7), then y, then z.
_MC_EDGE_CORNERS = np.array(
    [(c, c | (1 << ax)) for ax in range(3) for c in range(8)
     if not (c >> ax) & 1],
    dtype=np.int32,
)
_MC_MAX_TRIS = 6  # observed max is 4-5 (hexagon fan / 4 isolated corners)


def _gen_mc_table() -> np.ndarray:
    """[256, 3*_MC_MAX_TRIS] int8 edge-index triangle lists, -1 padded."""
    edge_of = {}
    for e, (a, b) in enumerate(_MC_EDGE_CORNERS):
        edge_of[(int(a), int(b))] = e
        edge_of[(int(b), int(a))] = e
    # 6 faces: axis a fixed at side s; 4 corners in cyclic order
    faces = []
    for ax in range(3):
        u, v = [d for d in range(3) if d != ax]
        for s in (0, 1):
            faces.append([
                (s << ax) | (uu << u) | (vv << v)
                for uu, vv in ((0, 0), (1, 0), (1, 1), (0, 1))
            ])
    P = _CUBE_CORNERS.astype(np.float64)
    table = -np.ones((256, 3 * _MC_MAX_TRIS), dtype=np.int8)
    for mask in range(1, 255):
        inside = [(mask >> c) & 1 for c in range(8)]
        nbr: dict[int, list[int]] = {}
        for q in faces:
            f = [inside[c] for c in q]
            if min(f) == max(f):
                continue
            for i in range(4):
                if f[i] and not f[i - 1]:
                    j = i
                    while f[(j + 1) % 4]:
                        j = (j + 1) % 4
                    e1 = edge_of[(q[i - 1], q[i])]
                    e2 = edge_of[(q[j], q[(j + 1) % 4])]
                    nbr.setdefault(e1, []).append(e2)
                    nbr.setdefault(e2, []).append(e1)
        tris: list[tuple[int, int, int]] = []
        visited: set[int] = set()
        for e0 in sorted(nbr):
            if e0 in visited:
                continue
            cyc, prev, cur = [e0], -1, e0
            visited.add(e0)
            while True:
                a, b = nbr[cur]
                nxt = b if a == prev else a
                if nxt == e0:
                    break
                cyc.append(nxt)
                visited.add(nxt)
                prev, cur = cur, nxt
            mid = np.stack([P[_MC_EDGE_CORNERS[e]].mean(0) for e in cyc])
            n = len(cyc)
            newell = np.zeros(3)
            for i in range(n):
                newell += np.cross(mid[i], mid[(i + 1) % n])
            outward = np.zeros(3)
            for e in cyc:
                a, b = _MC_EDGE_CORNERS[e]
                sgn = 1.0 if inside[a] else -1.0
                outward += sgn * (P[b] - P[a])
            if float(newell @ outward) < 0:
                cyc.reverse()
            tris.extend((cyc[0], cyc[i], cyc[i + 1]) for i in range(1, n - 1))
        assert len(tris) <= _MC_MAX_TRIS, (mask, tris)
        flat = [e for t in tris for e in t]
        table[mask, : len(flat)] = flat
    return table


_MC_TRI = _gen_mc_table()


def _mesh_cells_mc(vals: np.ndarray, cols: np.ndarray, cell_base: np.ndarray):
    """Classic marching cubes over active cells — same contract as
    _mesh_cells (marching tetrahedra)."""
    inside = vals < 0                                    # [m, 8]
    mask = np.zeros(vals.shape[0], dtype=np.int32)
    for c in range(8):
        mask |= inside[:, c].astype(np.int32) << c
    corner_pos = cell_base[:, None, :] + _CUBE_CORNERS[None, :, :]
    a, b = _MC_EDGE_CORNERS[:, 0], _MC_EDGE_CORNERS[:, 1]
    sa, sb = vals[:, a], vals[:, b]                      # [m, 12]
    tpar = sa / np.where(np.abs(sa - sb) < 1e-12, 1e-12, sa - sb)
    tpar = np.clip(tpar, 0.0, 1.0)[..., None]
    epos = corner_pos[:, a] * (1 - tpar) + corner_pos[:, b] * tpar
    ecol = cols[:, a] * (1 - tpar) + cols[:, b] * tpar
    tris = _MC_TRI[mask].astype(np.int32)                # [m, 18]
    out_v, out_c = [], []
    for k in range(_MC_MAX_TRIS):
        tk = tris[:, 3 * k : 3 * k + 3]
        sel = np.nonzero(tk[:, 0] >= 0)[0]
        if sel.size == 0:
            continue
        e = tk[sel]
        out_v.append(epos[sel[:, None], e])
        out_c.append(ecol[sel[:, None], e])
    if not out_v:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.float32)
    v = np.concatenate(out_v).reshape(-1, 3).astype(np.float32)
    c = np.concatenate(out_c).reshape(-1, 3).astype(np.float32)
    return v, c


class _HostHash:
    """Numpy mirror of the device hash for neighbor-block lookups."""

    def __init__(self, table_keys: np.ndarray, table_ptrs: np.ndarray, max_probes: int):
        self.keys = table_keys
        self.ptrs = table_ptrs
        self.max_probes = max_probes
        self.size = table_keys.shape[0]

    def lookup_packed(self, packed: np.ndarray) -> np.ndarray:
        x = (packed & COORD_MASK).astype(np.int64) - COORD_OFFSET
        y = ((packed >> COORD_BITS) & COORD_MASK).astype(np.int64) - COORD_OFFSET
        z = ((packed >> (2 * COORD_BITS)) & COORD_MASK).astype(np.int64) - COORD_OFFSET
        h = ((x * 73856093) ^ (y * 19349669) ^ (z * 83492791)).astype(np.int64)
        h = (h & (self.size - 1)).astype(np.int64)
        # aligned-bucket probe (must mirror hash.lookup)
        base = h & ~np.int64(self.max_probes - 1)
        ptr = np.full(packed.shape, -1, dtype=np.int32)
        for r in range(self.max_probes):
            slot = base + r
            match = self.keys[slot] == packed
            ptr = np.where(match, self.ptrs[slot], ptr)
        return ptr

    def lookup(self, bx, by, bz) -> np.ndarray:
        packed = (
            ((bx + COORD_OFFSET).astype(np.uint32) & COORD_MASK)
            | (((by + COORD_OFFSET).astype(np.uint32) & COORD_MASK) << COORD_BITS)
            | (((bz + COORD_OFFSET).astype(np.uint32) & COORD_MASK) << (2 * COORD_BITS))
        )
        return self.lookup_packed(packed)


def _extended_grids(vol_np: dict, block_ids: np.ndarray, hh: _HostHash):
    """[n, 9, 9, 9] sdf/weight and [n, 9, 9, 9, 3] color grids for the given
    blocks, with the +1 border pulled from neighbor blocks (missing
    neighbors: sdf=1, w=0)."""
    n = block_ids.shape[0]
    coords = vol_np["block_coords"][block_ids]
    bx = (coords & COORD_MASK).astype(np.int32) - COORD_OFFSET
    by = ((coords >> COORD_BITS) & COORD_MASK).astype(np.int32) - COORD_OFFSET
    bz = ((coords >> (2 * COORD_BITS)) & COORD_MASK).astype(np.int32) - COORD_OFFSET

    # pool arrays reshaped [B, z, y, x] (lin = x + 8y + 64z) -> [B, x, y, z]
    def as_xyz(a, ch=None):
        shp = (-1, BLOCK, BLOCK, BLOCK) + ((ch,) if ch else ())
        r = a.reshape(shp)
        return np.moveaxis(np.moveaxis(r, 1, 3), 1, 2)  # z,y,x -> x,y,z

    sdf_pool = as_xyz(vol_np["sdf"])
    w_pool = as_xyz(vol_np["w_depth"])
    c_pool = as_xyz(vol_np["color"], 3)

    sdf = np.ones((n, 9, 9, 9), dtype=np.float32)
    w = np.zeros((n, 9, 9, 9), dtype=np.int32)
    col = np.zeros((n, 9, 9, 9, 3), dtype=np.uint8)
    sdf[:, :8, :8, :8] = sdf_pool[block_ids]
    w[:, :8, :8, :8] = w_pool[block_ids]
    col[:, :8, :8, :8] = c_pool[block_ids]

    for ox, oy, oz in [(1, 0, 0), (0, 1, 0), (0, 0, 1), (1, 1, 0), (1, 0, 1), (0, 1, 1), (1, 1, 1)]:
        nb = hh.lookup(bx + ox, by + oy, bz + oz)
        has = nb >= 0
        if not has.any():
            continue
        src = np.where(has, nb, 0)
        # destination region in the 9-grid / source region in the 8-block
        dst = tuple(
            slice(8, 9) if o else slice(0, 8) for o in (ox, oy, oz)
        )
        srcr = tuple(slice(0, 1) if o else slice(0, 8) for o in (ox, oy, oz))
        sdf_n = sdf_pool[src][(slice(None),) + srcr]
        w_n = w_pool[src][(slice(None),) + srcr]
        c_n = c_pool[src][(slice(None),) + srcr]
        mask = has[:, None, None, None]
        region = (slice(None),) + dst
        sdf[region] = np.where(mask, sdf_n, sdf[region])
        w[region] = np.where(mask, w_n, w[region])
        col[region] = np.where(mask[..., None], c_n, col[region])
    base = np.stack([bx, by, bz], -1).astype(np.float32) * BLOCK
    return sdf, w, col, base


def host_volume(vol: TsdfVolume) -> dict:
    """Host numpy copy of what the meshers read, with the JAX package's
    dtypes: the hash table flat [H] (keys uint32, pointers int32) and the
    block keys, state and colour words (uint32) of the allocated blocks
    only; no pointer in the table reaches past them."""
    n = vol.n_blocks
    return {
        "table_keys": vol.table_keys.reshape(-1).cpu().numpy().view(np.uint32),
        "table_ptrs": vol.table_ptrs.reshape(-1).cpu().numpy(),
        "block_coords": vol.block_coords[:n].cpu().numpy().view(np.uint32),
        "state": vol.state[:n].cpu().numpy().view(np.uint32),
        "color": vol.color[:n].cpu().numpy().view(np.uint32),
    }


def _state_sdf(st: np.ndarray) -> np.ndarray:
    """f32 sdf of uint32 state words (low 16 bits, signed)."""
    si = (st & 0xFFFF).astype(np.int32)
    si = np.where(si >= 32768, si - 65536, si)
    return si.astype(np.float32) / 32767.0


def unpack_color_np(packed: np.ndarray) -> np.ndarray:
    """uint32 rgb888 -> u8 [..., 3]."""
    p = np.asarray(packed)
    return np.stack([(p & 0xFF), (p >> 8) & 0xFF, (p >> 16) & 0xFF],
                    axis=-1).astype(np.uint8)


def extract_mesh(vol: TsdfVolume, chunk_blocks: int = 2048,
                 require_weight: bool = True, use_native: bool = True,
                 algo: str = "mt"):
    """Extract the iso-surface as a triangle soup.

    Returns (vertices [3T, 3] metres, colors [3T, 3] in [0,1]).
    `require_weight` skips cells touching never-integrated voxels.  `algo`:
    "mt" (marching tetrahedra) or "mc" (classic marching cubes).  The
    native mesher runs unless `use_native` is False; its build failing
    raises.
    """
    if algo not in ("mt", "mc"):
        raise ValueError(f"unknown mesh algo {algo!r} (want 'mt' or 'mc')")
    host = host_volume(vol)
    p = vol.params
    if use_native:
        from .native import extract_mesh_native

        return extract_mesh_native(host, p.max_probes, p.voxel_size,
                                   require_weight, algo=algo)
    vol_np = {
        "block_coords": host["block_coords"],
        "sdf": _state_sdf(host["state"]),
        "w_depth": ((host["state"] >> 16) & 0xFF).astype(np.int32),
        "color": unpack_color_np(host["color"]),
    }
    hh = _HostHash(host["table_keys"], host["table_ptrs"], p.max_probes)
    n_blocks = host["state"].shape[0]
    all_verts, all_cols = [], []
    cell_off = np.stack(np.meshgrid(np.arange(8), np.arange(8), np.arange(8),
                                    indexing="ij"), -1).reshape(-1, 3)

    for c0 in range(0, n_blocks, chunk_blocks):
        ids = np.arange(c0, min(c0 + chunk_blocks, n_blocks), dtype=np.int64)
        sdf, w, col, base = _extended_grids(vol_np, ids, hh)
        n = ids.shape[0]
        # corner values per cell: [n, 512, 8]
        cidx = cell_off[None, :, None, :] + _CUBE_CORNERS[None, None, :, :]
        cx, cy, cz = cidx[..., 0], cidx[..., 1], cidx[..., 2]
        vals = sdf[np.arange(n)[:, None, None], cx, cy, cz]
        wts = w[np.arange(n)[:, None, None], cx, cy, cz]
        active = (vals.min(-1) < 0) & (vals.max(-1) >= 0)
        if require_weight:
            active &= wts.min(-1) > 0
        bsel, csel = np.nonzero(active)
        if bsel.size == 0:
            continue
        v_act = vals[bsel, csel]                    # [m, 8]
        cell_base = base[bsel] + cell_off[csel]     # [m, 3] voxel units
        cols_act = col[
            bsel[:, None], cx[0, csel], cy[0, csel], cz[0, csel]
        ].astype(np.float32) / 255.0                # [m, 8, 3]

        cells_fn = _mesh_cells if algo == "mt" else _mesh_cells_mc
        verts, vcols = cells_fn(v_act, cols_act, cell_base)
        if verts.size:
            all_verts.append(verts * p.voxel_size)
            all_cols.append(vcols)
    if not all_verts:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.float32)
    return np.concatenate(all_verts), np.concatenate(all_cols)


def _mesh_cells(vals: np.ndarray, cols: np.ndarray, cell_base: np.ndarray):
    """Marching tetrahedra over active cells.
    vals [m, 8] corner sdf; cols [m, 8, 3]; cell_base [m, 3] voxel units.
    Returns packed triangle vertices [3T, 3] (voxel units) + colors."""
    m = vals.shape[0]
    corner_pos = cell_base[:, None, :] + _CUBE_CORNERS[None, :, :]  # [m, 8, 3]
    out_v, out_c = [], []
    for tet in _TETS:
        tv = vals[:, tet]          # [m, 4]
        tp = corner_pos[:, tet]    # [m, 4, 3]
        tc = cols[:, tet]          # [m, 4, 3]
        inside = tv < 0
        mask = (
            inside[:, 0].astype(np.int32)
            | (inside[:, 1] << 1)
            | (inside[:, 2] << 2)
            | (inside[:, 3] << 3)
        )
        # edge intersection points: t = s_a / (s_a - s_b)
        a, b = _TET_EDGES[:, 0], _TET_EDGES[:, 1]
        sa, sb = tv[:, a], tv[:, b]                  # [m, 6]
        tpar = sa / np.where(np.abs(sa - sb) < 1e-12, 1e-12, sa - sb)
        tpar = np.clip(tpar, 0.0, 1.0)[..., None]
        epos = tp[:, a] * (1 - tpar) + tp[:, b] * tpar    # [m, 6, 3]
        ecol = tc[:, a] * (1 - tpar) + tc[:, b] * tpar
        tris = _CASES[mask]                               # [m, 2, 3]
        for k in range(2):
            tk = tris[:, k]                               # [m, 3]
            has = tk[:, 0] >= 0
            if not has.any():
                continue
            sel = np.nonzero(has)[0]
            e = tk[sel]                                   # [q, 3]
            out_v.append(epos[sel[:, None], e])           # [q, 3, 3]
            out_c.append(ecol[sel[:, None], e])
    if not out_v:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.float32)
    v = np.concatenate(out_v).reshape(-1, 3).astype(np.float32)
    c = np.concatenate(out_c).reshape(-1, 3).astype(np.float32)
    return v, c
