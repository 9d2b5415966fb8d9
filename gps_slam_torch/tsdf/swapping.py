"""Host swapping of the TSDF block pool — the port of
gps_slam_tpu/tsdf/swapping.py (`TPU.enable_swapping`, off by default).

The engine swaps in episodes.  Every `swap_check_interval` frames it
merges stored blocks that fusion allocated again back into the pool
(`maybe_reload`) and, past `high_water * block_capacity` allocated blocks,
spills the coldest blocks (smallest `last_seen`, stamped by fusion) to a
host dict and rebuilds the pool from the survivors (`maybe_spill`).
Raycasts bring the stored blocks that project into their view back first
(`reload_visible`).

All of it is host numpy plus the hash's `insert` / `lookup`, as in the JAX
package, so the card and the CPU give the same words.  The store keeps the
JAX layout, {int key: {"state", "color", "summary", "last_seen"}} with
uint32 state and colour words, so a store passes between the packages.
The port's pools are int32 tensors with the uint32 bits: every shift of a
host copy happens on its uint32 view (`st >> 24` on int32 would sign-extend
colour weights of 128 and more).  The volume is updated in place: its
table, pools and `n_blocks` are replaced by new tensors of the same shapes
on its device.
"""

from __future__ import annotations

import numpy as np
import torch

from . import hash as vhash
from .volume import SDF_SCALE, STATE_INIT, TsdfVolume, init_summary, unpack_color_np

_POOL_FIELDS = ("state", "color", "summary", "last_seen")
_WORD_FIELDS = ("state", "color")  # int32 on the device, uint32 in the store


def _np_unpack_state(st):
    """Host state words -> (sdf f32, w f32, wc f32); `st` is uint32, or
    int32 with the same bits."""
    st = np.asarray(st).view(np.uint32)
    si = (st & 0xFFFF).astype(np.int32)
    si = np.where(si >= 32768, si - 65536, si)
    return (si.astype(np.float32) / SDF_SCALE,
            ((st >> 16) & 0xFF).astype(np.float32),
            (st >> 24).astype(np.float32))


def _np_pack_state(f, w, wc):
    """(sdf f32, integer-valued weights) -> uint32 state words."""
    q = np.round(np.clip(f, -1.0, 1.0) * SDF_SCALE).astype(np.int32)
    su = np.where(q < 0, q + 65536, q).astype(np.uint32)
    return su | (w.astype(np.uint32) << 16) | (wc.astype(np.uint32) << 24)


def _host_rows(vol: TsdfVolume, rows: np.ndarray) -> dict:
    """The pool rows `rows` of every field on the host, words as uint32."""
    idx = torch.as_tensor(rows, dtype=torch.int64, device=vol.device)
    out = {f: getattr(vol, f)[idx].cpu().numpy() for f in _POOL_FIELDS}
    for f in _WORD_FIELDS:
        out[f] = out[f].view(np.uint32)
    return out


def _set_rows(vol: TsdfVolume, rows: np.ndarray, fields: dict) -> None:
    """Write host rows (words as uint32) into the pools at `rows`."""
    idx = torch.as_tensor(rows, dtype=torch.int64, device=vol.device)
    for f, x in fields.items():
        x = np.ascontiguousarray(x)
        if f in _WORD_FIELDS:
            x = x.astype(np.uint32, copy=False).view(np.int32)
        pool = getattr(vol, f)
        pool[idx] = torch.from_numpy(x).to(device=vol.device, dtype=pool.dtype)


class HostSwapEngine:
    def __init__(self, high_water: float = 0.85, low_water: float = 0.70):
        self.high_water = high_water
        self.low_water = low_water
        self.store: dict[int, dict[str, np.ndarray]] = {}
        self.n_spilled_total = 0
        self.n_reloaded_total = 0
        self._n_known = 0  # pool cursor after the last spill/reload scan
        # a raycast's swap-in left the pool at or past its high-water mark:
        # the engine spills before it fuses the next frame (see
        # `reload_visible`)
        self.over_high_water = False

    # -- spill ---------------------------------------------------------------

    def maybe_spill(self, vol: TsdfVolume) -> TsdfVolume:
        """Spill the coldest blocks and rebuild the pool from the rest when
        `n_blocks` reaches the high-water mark."""
        p = vol.params
        B = p.block_capacity
        n = vol.n_blocks
        if n < int(self.high_water * B):
            self._n_known = n
            return vol
        self.over_high_water = False
        keep_n = int(self.low_water * B)
        ls = vol.last_seen[:n].cpu().numpy()
        coords = vol.block_coords[:n].cpu().numpy().view(np.uint32)
        order = np.argsort(ls, kind="stable")
        spill_ids = np.sort(order[: n - keep_n])
        keep_ids = np.sort(order[n - keep_n:])

        spilled = _host_rows(vol, spill_ids)
        for k, key in enumerate(coords[spill_ids]):
            self.store[int(key)] = {f: spilled[f][k] for f in _POOL_FIELDS}
        self.n_spilled_total += len(spill_ids)

        # rebuild: a fresh table, the survivors inserted in pool order; all
        # unique and new, so each lands at row 0..keep_n-1 in that order
        dev = vol.device
        keep_keys = torch.as_tensor(coords[keep_ids].view(np.int32), device=dev)
        tk = torch.full_like(vol.table_keys, vhash.EMPTY)
        tp = torch.full_like(vol.table_ptrs, -1)
        bc = torch.full_like(vol.block_coords, vhash.EMPTY)
        nb, ptrs = vhash.insert(tk, tp, 0, bc, keep_keys, p.max_probes, B)
        if nb != keep_n or not torch.equal(
                ptrs, torch.arange(keep_n, dtype=torch.int32, device=dev)):
            raise RuntimeError(
                f"swap rebuild: {nb} of {keep_n} survivors inserted, or not at "
                "their rows (hash probes exhausted)")
        keep = torch.as_tensor(keep_ids, dtype=torch.int64, device=dev)

        def tail_like(x, fill):
            return torch.cat([x[keep], torch.full((B - keep_n, *x.shape[1:]), fill,
                                                  dtype=x.dtype, device=dev)])

        vol.table_keys, vol.table_ptrs, vol.block_coords = tk, tp, bc
        vol.state = tail_like(vol.state, STATE_INIT)
        vol.color = tail_like(vol.color, 0)
        vol.summary = torch.cat([vol.summary[keep], init_summary(B - keep_n, dev)])
        vol.last_seen = tail_like(vol.last_seen, -1)
        vol.n_blocks = nb
        self._n_known = keep_n
        return vol

    # -- per-view swap-in ------------------------------------------------------

    def reload_visible(self, vol: TsdfVolume, c2w, K, width: int,
                       height: int) -> TsdfVolume:
        """Bring the stored blocks that project into the view (c2w, K,
        width x height) back into the pool before a raycast, nearest first
        when the free rows do not hold them all; a frustum cull of the
        store's keys on the host.  The JAX package leaves the pool as full
        as this makes it, so the next fused frame finds no free row and its
        new blocks are dropped; the port marks a pool left at or past the
        high-water mark (`over_high_water`), and the engine spills before
        that frame's fusion."""
        if not self.store:
            return vol
        vol = self.maybe_reload(vol)  # drain pending fusion merges first
        if not self.store:
            return vol
        p = vol.params
        B = p.block_capacity
        keys = np.fromiter(self.store.keys(), np.int64, len(self.store))
        mask, off = vhash.COORD_MASK, vhash.COORD_OFFSET
        bx = (keys & mask) - off
        by = ((keys >> vhash.COORD_BITS) & mask) - off
        bz = ((keys >> (2 * vhash.COORD_BITS)) & mask) - off
        ext = p.voxel_size * 8.0
        centers = (np.stack([bx, by, bz], -1).astype(np.float32) + 0.5) * ext
        w2c = np.linalg.inv(np.asarray(c2w, np.float64)).astype(np.float32)
        pc = centers @ w2c[:3, :3].T + w2c[:3, 3]
        z = pc[:, 2]
        Kn = np.asarray(K, np.float32)
        fx, fy, cx, cy = Kn[0, 0], Kn[1, 1], Kn[0, 2], Kn[1, 2]
        r_blk = ext * 0.87  # block half-diagonal
        zs = np.maximum(z, 1e-6)
        u = fx * pc[:, 0] / zs + cx
        v = fy * pc[:, 1] / zs + cy
        pad_u = fx * r_blk / zs
        pad_v = fy * r_blk / zs
        vis = ((z > -r_blk)
               & (u >= -pad_u) & (u <= width - 1 + pad_u)
               & (v >= -pad_v) & (v <= height - 1 + pad_v))
        if not vis.any():
            return vol
        n = vol.n_blocks
        avail = B - n
        if avail <= 0:
            return vol
        sel = keys[vis]
        if len(sel) > avail:
            sel = sel[np.argsort(zs[vis])][:avail]
        sel_dev = torch.as_tensor(sel.astype(np.uint32).view(np.int32),
                                  device=vol.device)
        vol.n_blocks, _ = vhash.insert(vol.table_keys, vol.table_ptrs, n,
                                       vol.block_coords, sel_dev, p.max_probes, B)
        # a probe-bound insert can drop keys: write only the rows this
        # insert created
        ptrs = vhash.lookup(vol.table_keys, vol.table_ptrs, sel_dev,
                            p.max_probes).cpu().numpy()
        ok = ptrs >= n
        if not ok.any():
            self._n_known = vol.n_blocks
            return vol
        stored = [self.store.pop(int(k)) for k in sel[ok]]
        st = {f: np.stack([s[f] for s in stored]) for f in _POOL_FIELDS}
        # reloaded rows count as freshly seen (no thrash at the next spill)
        st["last_seen"] = np.full(len(stored), max(int(np.max(st["last_seen"])), 0),
                                  np.int32)
        _set_rows(vol, ptrs[ok], st)
        self.n_reloaded_total += len(stored)
        self._n_known = vol.n_blocks
        self.over_high_water = vol.n_blocks >= int(self.high_water * B)
        return vol

    # -- reload ---------------------------------------------------------------

    def maybe_reload(self, vol: TsdfVolume) -> TsdfVolume:
        """Merge stored voxels into the blocks that fusion allocated again
        since the last scan (a running average of both observations) and
        drop them from the store.  Nothing to do while the store is
        empty."""
        if not self.store:
            self._n_known = vol.n_blocks
            return vol
        n = vol.n_blocks
        if n <= self._n_known:
            return vol
        new_ids = np.arange(self._n_known, n)
        new_keys = vol.block_coords[self._n_known:n].cpu().numpy().view(np.uint32)
        hit = [(i, int(k)) for i, k in zip(new_ids, new_keys) if int(k) in self.store]
        self._n_known = n
        if not hit:
            return vol
        rows = np.asarray([i for i, _ in hit])
        stored = [self.store.pop(k) for _, k in hit]
        st = {f: np.stack([s[f] for s in stored]) for f in _POOL_FIELDS}

        max_w = float(vol.params.max_w)
        cur = _host_rows(vol, rows)
        f1, w1, wc1 = _np_unpack_state(cur["state"])
        c1 = unpack_color_np(cur["color"]).astype(np.float32)
        f2, w2, wc2 = _np_unpack_state(st["state"])
        c2 = unpack_color_np(st["color"]).astype(np.float32)
        wsum = w1 + w2
        f = np.where(wsum > 0, (w1 * f1 + w2 * f2) / np.maximum(wsum, 1), 1.0)
        w = np.minimum(wsum, max_w)
        wcsum = wc1 + wc2
        c = np.where(wcsum[..., None] > 0,
                     (wc1[..., None] * c1 + wc2[..., None] * c2)
                     / np.maximum(wcsum[..., None], 1), 0.0)
        wc = np.minimum(wcsum, max_w)
        cq = np.clip(c + 0.5, 0, 255).astype(np.uint32)
        c_packed = cq[..., 0] | (cq[..., 1] << 8) | (cq[..., 2] << 16)

        mip = f.reshape(-1, 4, 2, 4, 2, 4, 2).mean(axis=(2, 4, 6)).reshape(-1, 64)
        min_sdf = np.min(np.where(w > 0, f, 1.0), axis=1)
        maxw_blk = np.max(w, axis=1).astype(np.float32)
        summary = np.concatenate(
            [mip, min_sdf[:, None], maxw_blk[:, None],
             np.zeros((len(mip), 62), np.float32)], axis=1).astype(np.float32)
        _set_rows(vol, rows, {"state": _np_pack_state(f, w, wc), "color": c_packed,
                              "summary": summary})
        self.n_reloaded_total += len(hit)
        return vol
