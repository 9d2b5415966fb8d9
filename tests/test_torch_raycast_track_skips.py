"""The work that raycast_cuda's tracking mode skips, held on the CPU to
the plain version it must give bit for bit (`march_plain` with
raycast_tiles.TRACK).

The kernel computes only what its picks can read.  This file writes its
steps out per pixel in torch, out of the plain version's own ops, with
the work each step leaves out:

- step 1: no slab test where `slab_misses` rules the pair out (products
  with the direction's reciprocals in place of the slab test's
  quotients, with a margin of 4e-6 of their sizes): each such pair must
  be a miss of the slab test;
- step 2: no mip samples where the slab test misses; none after a pair's
  first negative sample;
- step 3: the sorted insert in slot order, by (key, slot): a new pair
  never displaces an equal key (its slot comes first), a pair pushed down
  by an insert displaces an equal key of a later slot, so the picks are
  the plain version's smallest keys, the first slot on a tie.  The kernel
  leaves one rule out: a pair whose t0 - 1e4 is at or above the pixel's
  kb-th key, that key with a negative sample, cannot enter (every key with
  a negative sample lies below every other finite key); the walk counts
  such pairs and checks that none enters;
- step 5: each bracket stage stops at its first crossing; stage 2 after
  a crossing starts from stage 1's sample at its near side; with no
  negative sample and no crossing in stage 1 (which took stage 2's
  samples) only the virtual entry's pair is tested; a pick whose slab
  entry t0s is at or beyond the pixel's t* is skipped once a pick has hit
  (every refined t lies at or beyond its pick's t0s in f32).

The walk must give the plain version's picks (slot and info) and output.
Inputs: tests/test_tracking.py's fixture (160x120, 2 cm voxels, its
config's 32-slot tile lists) after a few gt-pose fusions, the same volume
with its mips made non-negative (no pixel then has a negative sample),
the same with its non-negative mip values set to 0 (every pair without a
negative sample keys 0: ties, and pairs with one come after them in
slot order), and a small synthetic room at 64x48."""

import pytest
import torch

from gps_slam_torch.data import synthetic
from gps_slam_torch.tsdf import integrate as tint
from gps_slam_torch.tsdf import raycast_tiles as trc
from gps_slam_torch.tsdf import volume as tvol
from gps_slam_torch.utils.se3 import pose_inv


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Many small torch ops; one thread per test worker keeps them from
    handing work between threads (results do not depend on the count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


KB = trc.TRACK_K_BLOCKS
S_COARSE, S_REFINE = 4, 6   # raycast_samples; max(raycast_bisect, 3)


def _fused(width, height, n_fused, look, arc, lb):
    """The port's gt-pose fusion of `n_fused` frames of a synthetic orbit
    (tests/test_tracking.py's TSDF settings) and the tracking-prepare
    march's arguments at the last fused pose."""
    cams = synthetic.make_cameras(n_frames=n_fused, width=width, height=height,
                                  look=look, arc=arc)
    p = tvol.TsdfParams(voxel_size=0.02, mu=0.08, frustum_min=0.2, frustum_max=10.0,
                        hash_size=1 << 16, block_capacity=1 << 13,
                        visible_capacity=1 << 12)
    vol = tvol.create(p, "cpu")
    for c in cams:
        tint.fuse_frame(vol, torch.as_tensor(c.depth[..., 0]), torch.as_tensor(c.image),
                        torch.as_tensor(c.c2w), c.K)
    cam = cams[-1]
    c2w = torch.as_tensor(cam.c2w)
    tw = -(-width // trc.TILE)
    gids = trc._tile_bins(vol, pose_inv(c2w), cam.fx, cam.fy, cam.cx, cam.cy, width,
                          height, p.visible_capacity, lb, 6)[0]
    camd = {"fx": cam.fx, "fy": cam.fy, "cx": cam.cx, "cy": cam.cy, "R": c2w[:3, :3],
            "t": c2w[:3, 3], "inv_vox": 1.0 / p.voxel_size, "ext": p.voxel_size * 8,
            "fmin": p.frustum_min, "fmax": p.frustum_max}
    return [gids, vol.state, vol.color, vol.summary, vol.block_coords, camd, tw,
            S_COARSE, S_REFINE, KB, False]


def _cases():
    fixture = _fused(160, 120, 4, "in", 0.025, 32)
    no_neg = list(fixture)
    summary = no_neg[3].clone()
    summary[:, :64] = summary[:, :64].abs()
    no_neg[3] = summary
    tied = list(fixture)
    summary = tied[3].clone()
    summary[:, :64] = torch.clamp(summary[:, :64], max=0.0)
    tied[3] = summary
    room = _fused(64, 48, 6, "out", 0.75, 16)
    return {"tracking fixture": fixture, "no negative sample": no_neg,
            "tied keys": tied, "room 64x48": room}


@pytest.fixture(scope="module")
def cases():
    return _cases()


def _sample(cube, dirs, bsel, t, inv_vox):
    """The trilinear sdf of the picked rows `cube` at t along the rays."""
    ls = [torch.clamp((d * t - b) * inv_vox, 0.0, 7.0) for d, b in zip(dirs, bsel)]
    return trc._trilinear(cube, *(x[..., None] for x in ls), 8)[..., 0]


def _walk(gids, state, color, summary, bc, cam, tw, s_coarse, s_refine, kb,
          need_color):
    """The kernel's tracking mode written out per pixel with the work it
    skips: (slots [T, P, kb] (LB: none), infos (first negative sample << 2
    | has one << 1), output [T, 6, P] without colour, counts of the work
    done and of the work the plain version does)."""
    T, LB = gids.shape
    tiles = torch.arange(T)
    ext, inv_vox = cam["ext"], cam["inv_vox"]
    fmin, fmax = cam["fmin"], cam["fmax"]
    dirs = trc._pixel_dirs(tiles, tw, cam)                           # [T, P]
    valid = gids >= 0
    gsafe = gids.clamp(min=0).to(torch.int64)
    bxi, byi, bzi = trc.vhash.unpack(bc[gsafe])
    borg = [torch.where(valid, c.to(torch.float32) * ext - cam["t"][a], 1e9)
            for a, c in enumerate((bxi, byi, bzi))]                 # [T, LB]
    mip = summary[gsafe, :64]                                       # [T, LB, 64]
    half = inv_vox * 0.5
    shape = dirs[0].shape
    # the approximate slab test's reciprocals (`slab_rcp`)
    rcp = [1.0 / torch.where(d.abs() < 1e-9, 1e-9, d) for d in dirs]
    pk = torch.full((*shape, kb), torch.inf)
    ps = torch.full((*shape, kb), LB, dtype=torch.int64)
    pi = torch.zeros((*shape, kb), dtype=torch.int64)
    n = {"listed": 0, "culled": 0, "hit": 0, "coarse_samples": 0, "prunable": 0,
         "after_picks": 0, "tie_displaced": 0}
    for l in range(LB):
        live = valid[:, l][:, None].expand(shape)
        bo = [b[:, l][:, None] for b in borg]
        # step 1: the pairs that `slab_misses` rules out take nothing more
        t0a = torch.full(shape, fmin)
        t1a = torch.full(shape, fmax)
        for b, r in zip(bo, rcp):
            ta, tb = b * r, (b + ext) * r
            t0a = torch.maximum(t0a, torch.minimum(ta, tb))
            t1a = torch.minimum(t1a, torch.maximum(ta, tb))
        culled = live & (t0a >= t1a + 4e-6 * (t0a.abs() + t1a.abs()))
        # step 2: the rest take the slab test, and its hits their samples
        t0, t1 = trc._slab(bo, dirs, ext, fmin, fmax)
        hit = live & (t1 > t0)
        assert not (culled & hit).any()              # `slab_misses` is sure
        n["listed"] += int(live.sum())
        n["culled"] += int(culled.sum())
        n["hit"] += int(hit.sum())
        active = hit.clone()
        neg = torch.zeros_like(hit)
        sf = torch.zeros(shape, dtype=torch.int64)
        minval = torch.full(shape, torch.inf)
        for s in range(s_coarse):
            n["coarse_samples"] += int(active.sum())
            ts = t0 + (t1 - t0) * ((s + 0.5) / s_coarse)
            lq = [torch.clamp((d * ts - b) * half - 0.5, 0.0, 3.0) for d, b in zip(dirs, bo)]
            m = mip[:, l][:, None, :].expand(*shape, 64)
            v = trc._trilinear(m, *(x[..., None] for x in lq), 4)[..., 0]
            first = active & (v < 0.0)
            sf = torch.where(first, s, sf)
            neg = neg | first
            minval = torch.where(active & ~first, torch.minimum(minval, v), minval)
            active = active & ~first                 # stop at the first negative
        key = torch.where(neg, t0 - 1e4, torch.where(minval < trc.NEAR, minval, torch.inf))
        key = torch.where(hit, key, torch.inf)
        # a rule the kernel leaves out: a pair whose t0 - 1e4 is at or above
        # the pixel's kb-th key, that key with a negative sample, cannot enter
        held = hit & ((pi[..., kb - 1] & 2) > 0)
        prunable = held & (t0 - 1e4 >= pk[..., kb - 1])
        assert not (prunable & (key < pk[..., kb - 1])).any()
        n["after_picks"] += int(held.sum())
        n["prunable"] += int(prunable.sum())
        # step 3: the sorted insert, slot by slot, by (key, slot)
        slot = torch.full(shape, l, dtype=torch.int64)
        info = (sf << 2) | (neg.to(torch.int64) << 1)
        for k in range(kb):
            tie = (key == pk[..., k]) & (slot < ps[..., k]) & torch.isfinite(key)
            n["tie_displaced"] += int(tie.sum())
            ins = (key < pk[..., k]) | tie
            for arr, new in ((pk, key), (ps, slot), (pi, info)):
                old = arr[..., k].clone()
                arr[..., k] = torch.where(ins, new, old)
                new.copy_(torch.where(ins, old, new))

    # step 5: two bracket stages per pick, each to its first crossing
    fr = [q / (s_refine - 1) for q in range(s_refine)]
    found = torch.zeros(shape, dtype=torch.bool)
    t_star = torch.zeros(shape)
    win = torch.full(shape, -1, dtype=torch.int64)
    n.update(picks=0, skipped_picks=0, refine_samples=0, refine_samples_plain=0)
    rows = tiles[:, None]
    zero = torch.zeros(shape)

    def stage(cube, bsel, lo, hi, q0, t_prev, v_prev, todo):
        """Samples q0.. of [lo, hi] after (t_prev, v_prev), to the first
        crossing (`bracket` with kStop); counts the samples taken."""
        fk = torch.zeros(shape, dtype=torch.bool)
        tlo = thi = vlo = vhi = zero
        for q in range(q0, len(fr)):
            n["refine_samples"] += int((todo & ~fk).sum())
            tq = lo + (hi - lo) * fr[q]
            v = _sample(cube, dirs, bsel, tq, inv_vox)
            cr = ~fk & (v_prev >= 0) & (v_prev < 1e9) & (v < 0)
            tlo, thi = torch.where(cr, t_prev, tlo), torch.where(cr, tq, thi)
            vlo, vhi = torch.where(cr, v_prev, vlo), torch.where(cr, v, vhi)
            fk = fk | cr
            t_prev, v_prev = tq, v
        return fk, tlo, thi, vlo, vhi

    for k in range(kb):
        slot = ps[..., k]
        has = slot < LB
        sl = slot.clamp(max=LB - 1)
        bsel = [torch.gather(b, 1, sl) for b in borg]
        t0s, t1s = trc._slab(bsel, dirs, ext, fmin, fmax)
        t1s = torch.maximum(t1s, t0s)
        skip = has & found & (t0s >= t_star)
        todo = has & ~skip
        n["picks"] += int(has.sum())
        n["skipped_picks"] += int(skip.sum())
        n["refine_samples_plain"] += int(todo.sum()) * 2 * len(fr)
        an = (pi[..., k] & 2) > 0
        dt = (t1s - t0s) / s_coarse
        ts_neg = t0s + ((pi[..., k] >> 2).to(torch.float32) + 0.5) * dt
        su = state[gsafe[rows, sl]] & 0xFFFF
        cube = torch.where(su >= 32768, su - 65536, su).to(torch.float32) * (1.0 / 32767.0)
        lo = torch.where(an, torch.maximum(ts_neg - 1.25 * dt, t0s), t0s)
        hi = torch.where(an, ts_neg + 0.25 * dt, t1s)
        tq0 = lo + (hi - lo) * fr[0]
        v0 = _sample(cube, dirs, bsel, tq0, inv_vox)
        n["refine_samples"] += int(todo.sum())
        f1, tlo1, thi1, vlo1, _ = stage(cube, bsel, lo, hi, 1, tq0, v0, todo)
        # stage 2: after a crossing, from stage 1's sample at its near side;
        # with no negative sample and none found, only the entry's pair;
        # else the whole segment after the virtual entry
        fa = stage(cube, bsel, tlo1, thi1, 1, tlo1, vlo1, todo & f1)
        cross = v0 < 0.0
        fb = (cross, torch.where(cross, t0s, zero), torch.where(cross, tq0, zero),
              torch.where(cross, 1e-3, zero), torch.where(cross, v0, zero))
        fc = stage(cube, bsel, t0s, t1s, 0, t0s, torch.full(shape, 1e-3), todo & ~f1 & an)
        fk, tlo, thi, vlo, vhi = (torch.where(f1, a, torch.where(an, c, b_))
                                  for a, b_, c in zip(fa, fb, fc))
        denom = vlo - vhi
        alpha = torch.clamp(vlo / torch.where(denom.abs() < 1e-9, 1e-9, denom), 0.0, 1.0)
        tk = tlo + alpha * (thi - tlo)
        # the pick skip's premise: a refined t never lies before t0s
        assert bool((tk >= t0s)[fk & has].all())
        fk = fk & todo
        better = fk & (~found | (tk < t_star))
        t_star = torch.where(better, tk, t_star)
        win = torch.where(better, sl, win)
        found = found | fk
    fm = found.to(torch.float32)
    maxw = torch.where(valid, summary[gsafe, 65], 0.0)
    conf = torch.where(win >= 0, torch.gather(maxw, 1, win.clamp(min=0)), 0.0)
    out = torch.zeros((T, trc.N_OUT, trc.P))
    out[:, 0] = t_star * fm
    out[:, 1] = (conf + 1.0) * fm
    out[:, 5] = fm
    return ps, pi, out, n


def _plain_picks(margs):
    """The plain version's per-pixel keys and picks (`_coarse` with
    per_pixel, then the smallest key k times, the first slot on a tie)."""
    gids, _, _, summary, bc, cam, tw, s_coarse, _, kb = margs[:10]
    T, LB = gids.shape
    _, _, _, _, key, s_first, has_neg, _ = trc._coarse(
        torch.arange(T), gids, summary, bc, cam, tw, s_coarse, per_pixel=True)
    keys = key.clone()
    slots, infos = [], []
    for _ in range(kb):
        kmin = key.amin(1)
        slot = torch.where(torch.isfinite(kmin), key.argmin(1), LB)     # [T, P]
        key = torch.where(torch.arange(LB)[None, :, None] == slot[:, None, :],
                          torch.inf, key)
        sr = slot.clamp(max=LB - 1)[:, None, :]
        sf = torch.gather(s_first, 1, sr)[:, 0].to(torch.int64)
        an = torch.gather(has_neg, 1, sr)[:, 0] & (slot < LB)
        slots.append(slot)
        infos.append(torch.where(slot < LB, (sf << 2) | (an.to(torch.int64) << 1), 0))
    return torch.stack(slots, -1), torch.stack(infos, -1), keys, has_neg


@pytest.mark.parametrize("name", ["tracking fixture", "no negative sample", "tied keys",
                                  "room 64x48"])
def test_walk_with_skips_gives_the_plain_picks_and_output(cases, name):
    """The per-pixel walk with the work the kernel skips gives the plain
    version's picks (slot and info, pixel by pixel) and its output bit for
    bit, and every key with a negative sample lies below every other
    finite key.  Each case also shows the skips at work: most listed pairs
    miss, and `slab_misses` rules out all but a few of them; the refine
    takes fewer samples than the plain version; with tied keys a pair
    pushed down by an insert displaces an equal key of a later slot (the
    rule a pick without it got wrong on 1 pixel in ~800,000 of some
    1200x680 prepare raycasts); with negative samples
    some pairs stop early, and on the fixture's 32-slot lists nearly every
    hit pair met after a pixel holds its picks could not enter, though
    they are few; without negative samples none stops early."""
    margs = cases[name]
    ps, pi, out, n = _walk(*margs)
    slots, infos, keys, has_neg = _plain_picks(margs)
    assert torch.equal(ps, slots)
    assert torch.equal(pi, infos)
    plain = trc.march_plain(*margs, xla=trc.TRACK)
    assert torch.equal(out, plain)
    neg_keys = keys[has_neg & torch.isfinite(keys)]
    other = keys[~has_neg & torch.isfinite(keys)]
    if neg_keys.numel() and other.numel():
        assert neg_keys.max() < other.min()
    assert n["hit"] < 0.5 * n["listed"]
    assert n["culled"] > 0.99 * (n["listed"] - n["hit"])
    assert n["refine_samples"] < 0.8 * n["refine_samples_plain"]
    if name == "no negative sample":
        assert not has_neg.any() and n["prunable"] == 0
        assert n["coarse_samples"] == n["hit"] * S_COARSE
        assert (plain[:, 5] > 0).any()
    else:
        assert has_neg.any() and (plain[:, 5] > 0).float().mean() > 0.3
        assert n["coarse_samples"] < n["hit"] * S_COARSE
    if name == "tracking fixture":
        assert 0.9 * n["after_picks"] < n["prunable"] < 0.05 * n["hit"]
    if name == "tied keys":
        # pushed-down pairs displaced equal keys of later slots
        assert n["tie_displaced"] > 0


if __name__ == "__main__":
    # the work counts of each case:
    #   PYTHONPATH=. python tests/test_torch_raycast_track_skips.py
    torch.set_num_threads(1)
    for name, margs in _cases().items():
        print(name, _walk(*margs)[3])
