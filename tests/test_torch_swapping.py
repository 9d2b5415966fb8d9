"""Host swapping of the TSDF pool in the port against the JAX package: the
host word helpers, the fixture of tests/test_swapping.py run by both
engines (spill and reload counts, the stores' key sets, `last_seen` by
block key, and that file's three gates on the port's run), and each swap
operation on one volume carried from the JAX engine to the port through
scene.npz with one store: `maybe_spill`, `maybe_reload` and
`reload_visible` give the same words bit for bit.

Allocation, the integration set and so the `last_seen` stamps do not
depend on how a package integrates, so both engines spill the same keys at
the same frames; the integrated words differ (the JAX CPU fusion anchors
its windows otherwise, see tests/test_torch_tsdf.py), which is why the
operations are compared on one carried volume."""

import copy
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gps_slam_tpu.config import Config as JConfig
from gps_slam_tpu.data import synthetic
from gps_slam_tpu.tsdf import swapping as jswap
from gps_slam_tpu.tsdf.engine import TsdfEngine as JEngine
from gps_slam_torch.config import Config as TConfig
from gps_slam_torch.tsdf import swapping as tswap
from gps_slam_torch.tsdf.engine import TsdfEngine as TEngine

W, H, N = 128, 96, 24
SMALL = {"block_capacity": 1024, "hash_size": 2 ** 15,
         "visible_block_capacity": 2 ** 12, "alloc_candidate_cap": 2 ** 13,
         "enable_swapping": 1, "swap_check_interval": 2,
         "swap_high_water": 0.80, "swap_low_water": 0.50}
BIG = {"block_capacity": 2 ** 14, "hash_size": 2 ** 17,
       "visible_block_capacity": 2 ** 12, "alloc_candidate_cap": 2 ** 13}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Swapping and fusion at 128x96 are many small torch ops; one thread
    per test worker keeps them from handing work between threads.  Module
    scope sets it before the module's other fixtures run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config_dict(tmp, cams, tpu):
    c = cams[0]
    node = {"input_dir": "mem", "image_path": "c", "pose_path": "c", "depth_path": "d",
            "pcd_name": "n", "depth_scale": 6553.5, "scene_scale": 1.0,
            "start_frame": 0, "end_frame": len(cams) - 1, "frame_step": 1,
            "intrinsics": [c.fx, c.fy, c.cx, c.cy], "image_shape": [W, H],
            "downscale_factor": 1, "test_split_interval": -1}
    d = synthetic.default_config_dict(str(tmp / "ws"), node)
    d.setdefault("TPU", {}).update(tpu)
    return d


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint32)


def _run_port(d, cams):
    eng = TEngine(TConfig.from_dict(d), W, H, cams[0].K, device="cpu")
    eng.set_gt_poses([c.c2w for c in cams])
    eng.turn_off_tracking()
    counts = []
    for c in cams:
        eng.process_frame(c.image, c.depth)
        if eng.swap is not None:
            counts.append((eng.vol.n_blocks, eng.swap.n_spilled_total,
                           eng.swap.n_reloaded_total))
    return eng, counts


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The tests/test_swapping.py fixture (a full outward turn, 24 frames
    at 128x96, 1024-block pool, check every 2 frames, waters 0.80 / 0.50)
    through the JAX engine and the port's, and the port's run on the big
    pool.  The JAX swap engine's inputs are kept: the volume (immutable)
    and a copy of the store and cursor before its first spill and before
    its first merge that finds stored keys, and after the last frame."""
    tmp = tmp_path_factory.mktemp("swap")
    cams = synthetic.make_cameras(n_frames=N, width=W, height=H, look="out", arc=1.0)
    d_small = _config_dict(tmp, cams, SMALL)
    je = JEngine(JConfig.from_dict(d_small), W, H, cams[0].K)
    je.set_gt_poses([c.c2w for c in cams])
    je.turn_off_tracking()
    seen = {}
    spill, reload = je.swap.maybe_spill, je.swap.maybe_reload

    def snap(swap, vol):
        return vol, copy.deepcopy(swap.store), swap._n_known

    def rec_spill(vol):
        if "spill" not in seen and int(vol.n_blocks) >= int(je.swap.high_water * 1024):
            seen["spill"] = snap(je.swap, vol)
        return spill(vol)

    def rec_reload(vol):
        if "reload" not in seen and je.swap.store:
            n0, n = je.swap._n_known, int(vol.n_blocks)
            keys = np.asarray(vol.block_coords)[n0:n]
            if any(int(k) in je.swap.store for k in keys):
                seen["reload"] = snap(je.swap, vol)
        return reload(vol)

    je.swap.maybe_spill, je.swap.maybe_reload = rec_spill, rec_reload
    jcounts = []
    for c in cams:
        je.process_frame(jnp.asarray(c.image), jnp.asarray(c.depth))
        jcounts.append((int(je.vol.n_blocks), je.swap.n_spilled_total,
                        je.swap.n_reloaded_total))
    je.swap.maybe_spill, je.swap.maybe_reload = spill, reload
    seen["end"] = snap(je.swap, je.vol)
    te, tcounts = _run_port(d_small, cams)
    te_big, _ = _run_port(_config_dict(tmp, cams, BIG), cams)
    # the port's end state, before a test's raycast swaps blocks back in
    n = te.vol.n_blocks
    t_end = {"store": {k: dict(e) for k, e in te.swap.store.items()},
             "keys": _u32(te.vol.block_coords[:n]).copy(),
             "last_seen": te.vol.last_seen[:n].numpy().copy()}
    return {"cams": cams, "tmp": tmp, "d": d_small, "je": je, "jcounts": jcounts,
            "te": te, "tcounts": tcounts, "te_big": te_big, "seen": seen,
            "t_end": t_end}


def test_host_word_helpers_match_jax():
    """`_np_unpack_state` / `_np_pack_state` on words with negative sdf and
    colour weights of 128 and more (bit 31 set: a negative int32), given
    as the port's int32 and the JAX package's uint32: equal outputs."""
    rng = np.random.default_rng(3)
    sdf = rng.integers(-32767, 32768, 4096)
    w = rng.integers(0, 256, 4096)
    wc = rng.integers(120, 256, 4096)
    words = ((sdf & 0xFFFF) | (w << 16) | (wc << 24)).astype(np.uint32)
    assert (words.view(np.int32) < 0).mean() > 0.5 and (sdf < 0).any()
    jf, jw, jwc = jswap._np_unpack_state(words)
    tf, tw, twc = tswap._np_unpack_state(words.view(np.int32))
    for a, b in ((jf, tf), (jw, tw), (jwc, twc)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(twc, wc.astype(np.float32))
    np.testing.assert_array_equal(tswap._np_pack_state(tf, tw, twc),
                                  jswap._np_pack_state(jf, jw, jwc))
    np.testing.assert_array_equal(tswap._np_pack_state(tf, tw, twc), words)


def test_port_swapping_actually_spills(runs):
    """tests/test_swapping.py's first gate on the port's run."""
    te, te_big = runs["te"], runs["te_big"]
    assert te.swap is not None and te.swap.n_spilled_total > 0
    assert te_big.vol.n_blocks > 1024
    assert te.vol.n_blocks <= 1024


def test_port_swapping_reloads_and_merges(runs):
    """tests/test_swapping.py's second gate on the port's run."""
    assert runs["te"].swap.n_reloaded_total > 0


def test_port_raycast_correct_after_swap_roundtrip(runs):
    """tests/test_swapping.py's third gate on the port's run: the raycast
    from the first pose after the turn (its blocks spilled and reloaded)
    against the big pool's: mean depth error below max(3x, 1 cm), coverage
    above 0.8x."""
    cam = runs["cams"][0]

    def err(engine):
        d = engine.run_raycast(cam.c2w, cam.K, cam.width, cam.height)["depth_map"]
        d = d[..., 0].numpy()
        gt = np.asarray(cam.depth).reshape(d.shape)
        both = (d > 0) & (gt > 0)
        assert both.mean() > 0.5, "raycast lost most of the view"
        return float(np.abs(d - gt)[both].mean()), float(both.mean())

    e_small, cov_small = err(runs["te"])
    e_big, cov_big = err(runs["te_big"])
    assert e_small < max(3.0 * e_big, 0.01), (e_small, e_big)
    assert cov_small > 0.8 * cov_big, (cov_small, cov_big)


def test_swap_counts_and_stores_match_jax(runs):
    """Both engines run the fixture: after every frame the same allocated
    count, spill count and reload count; at the end the same store keys
    and the same block keys row for row."""
    assert runs["tcounts"] == runs["jcounts"]
    jvol, jstore, _ = runs["seen"]["end"]
    t_end = runs["t_end"]
    assert list(t_end["store"]) == list(jstore)
    np.testing.assert_array_equal(t_end["keys"],
                                  np.asarray(jvol.block_coords)[:int(jvol.n_blocks)])


def test_last_seen_matches_jax_by_key(runs):
    """The LRU stamps after the run, by block key, and those the stores
    hold: equal in both packages.  (Rows also agree; the stores keep the
    stamps of spilled blocks.)"""
    jvol, jstore, _ = runs["seen"]["end"]
    t_end = runs["t_end"]
    n = int(jvol.n_blocks)
    jmap = dict(zip(np.asarray(jvol.block_coords)[:n].tolist(),
                    np.asarray(jvol.last_seen)[:n].tolist()))
    tmap = dict(zip(t_end["keys"].tolist(), t_end["last_seen"].tolist()))
    assert jmap == tmap
    assert min(tmap.values()) >= 0
    for k, e in jstore.items():
        assert int(t_end["store"][k]["last_seen"]) == int(e["last_seen"])


def _carry(runs, name, sub):
    """The JAX swap engine's recorded input `name` carried to the port: the
    volume through scene.npz, the store and cursor copied.  Returns (JAX
    volume, JAX swap engine, port engine, port swap engine)."""
    vol, store, n_known = runs["seen"][name]
    d, cams = runs["d"], runs["cams"]
    je = JEngine(JConfig.from_dict(d), W, H, cams[0].K)
    je.vol = vol
    je.save_scene(str(runs["tmp"] / sub))
    te = TEngine(TConfig.from_dict(d), W, H, cams[0].K, device="cpu")
    te.load_scene(str(runs["tmp"] / sub))
    js, ts = (jswap.HostSwapEngine(0.80, 0.50), tswap.HostSwapEngine(0.80, 0.50))
    for s in (js, ts):
        s.store, s._n_known = copy.deepcopy(store), n_known
    return vol, js, te, ts


def _assert_same(jvol, js, tvol, ts):
    """Equal pools, table and cursor bit for bit, equal stores."""
    assert tvol.n_blocks == int(jvol.n_blocks)
    for f in ("table_keys", "block_coords", "state", "color"):
        np.testing.assert_array_equal(_u32(getattr(tvol, f)), np.asarray(getattr(jvol, f)))
    for f in ("table_ptrs", "last_seen", "summary"):
        np.testing.assert_array_equal(getattr(tvol, f).numpy(), np.asarray(getattr(jvol, f)))
    assert list(ts.store) == list(js.store)
    for k, e in js.store.items():
        for f, x in e.items():
            assert ts.store[k][f].dtype == x.dtype
            np.testing.assert_array_equal(ts.store[k][f], x)
    assert (ts.n_spilled_total, ts.n_reloaded_total, ts._n_known) == \
        (js.n_spilled_total, js.n_reloaded_total, js._n_known)


def test_maybe_spill_matches_jax(runs):
    """The JAX engine's volume at its first spill, carried across: both
    spills keep the same keys at the same rows (the rebuilt table bit for
    bit), the same words, summaries and stamps, and store the same
    entries in the same order."""
    jvol, js, te, ts = _carry(runs, "spill", "spill")
    n0 = te.vol.n_blocks
    jvol = js.maybe_spill(jvol)
    ts.maybe_spill(te.vol)
    assert ts.n_spilled_total == n0 - int(0.50 * 1024) > 0
    _assert_same(jvol, js, te.vol, ts)


def test_maybe_reload_matches_jax(runs):
    """The JAX engine's volume at its first merge that finds stored keys,
    carried across with its store: the merged state words, colours and
    summaries bit for bit, and the same store left."""
    jvol, js, te, ts = _carry(runs, "reload", "reload")
    jvol = js.maybe_reload(jvol)
    ts.maybe_reload(te.vol)
    assert ts.n_reloaded_total > 0
    _assert_same(jvol, js, te.vol, ts)


def test_reload_visible_matches_jax(runs, tmp_path):
    """The JAX engine's volume and store after the last frame, carried
    across: swapping in the first pose's view brings back the same blocks
    at the same rows with the same words; the port's scene.npz then holds
    the new pool."""
    cam = runs["cams"][0]
    jvol, js, te, ts = _carry(runs, "end", "end")
    jvol = js.reload_visible(jvol, cam.c2w, cam.K, W, H)
    ts.reload_visible(te.vol, cam.c2w, cam.K, W, H)
    assert ts.n_reloaded_total > 0
    _assert_same(jvol, js, te.vol, ts)
    te.save_scene(str(tmp_path))
    z = np.load(os.path.join(tmp_path, "scene.npz"))
    assert int(z["n_blocks"]) == te.vol.n_blocks
    np.testing.assert_array_equal(z["block_coords"], np.asarray(jvol.block_coords))


def test_no_stamp_without_swapping(runs):
    """With swapping off fusion leaves `last_seen` alone (the big pool's
    run) and the engine has no swap engine."""
    te_big = runs["te_big"]
    assert te_big.swap is None
    assert bool((te_big.vol.last_seen == -1).all())


def test_fusion_after_a_filling_swap_in_spills_first(runs):
    """A deviation from the JAX package, stated: a raycast's swap-in fills
    the free rows with stored blocks, and the JAX engine then fuses the
    next frame into the full pool, dropping the frame's new blocks; the
    port's engine spills first.  From the JAX engine's state after the
    run, carried to both engines: raycasts from the first poses fill
    both pools to capacity with the same words, then a frame from the
    middle of the turn (its blocks spilled) is fused at an odd frame
    index (no check after it).  The JAX pool keeps the same 1024 keys; the
    port's pool is below capacity and holds the frame's new blocks."""
    cams = runs["cams"]
    vol, store, n_known = runs["seen"]["end"]
    d = runs["d"]
    je = JEngine(JConfig.from_dict(d), W, H, cams[0].K)
    je.vol = vol
    je.save_scene(str(runs["tmp"] / "fill"))
    te = TEngine(TConfig.from_dict(d), W, H, cams[0].K, device="cpu")
    te.load_scene(str(runs["tmp"] / "fill"))
    mid = cams[12]
    for e in (je, te):
        e.swap.store, e.swap._n_known = copy.deepcopy(store), n_known
        e.set_gt_poses([c.c2w for c in cams] + [mid.c2w] * 2)
        e.turn_off_tracking()
        e.current_frame = N + 1
    for cam in cams[:9:2]:
        je.run_raycast(cam.c2w, cam.K, W, H)
        te.run_raycast(cam.c2w, cam.K, W, H)
    assert te.vol.n_blocks == int(je.vol.n_blocks) == 1024
    np.testing.assert_array_equal(_u32(te.vol.state), np.asarray(je.vol.state))
    assert te.swap.over_high_water
    jkeys = set(np.asarray(je.vol.block_coords).tolist())
    je.process_frame(jnp.asarray(mid.image), jnp.asarray(mid.depth))
    te.process_frame(mid.image, mid.depth)
    assert int(je.vol.n_blocks) == 1024
    assert set(np.asarray(je.vol.block_coords).tolist()) == jkeys
    keep_n = int(0.50 * 1024)
    assert keep_n < te.vol.n_blocks < 1024 and not te.swap.over_high_water
    new = set(_u32(te.vol.block_coords[keep_n:te.vol.n_blocks]).tolist())
    assert len(new - jkeys) > 50
