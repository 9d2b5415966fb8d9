"""Chunked gt fusion of the port (`TsdfEngine.process_frames_gt` over the
fixed-shape frame body `integrate.fuse_frame_static`) on the CPU.

(a) The fixed-shape hash insert against the JAX `insert`, bit for bit.  (b) The
fixed-shape frame body against `fuse_frame`, bit for bit, on the packed
route, the f32 route (the JAX budget lowered, as
tests/test_torch_integrate_f32.py lowers it) and a frame below 64 px; and
the body under the guard that fails on every host read.  (c)
`_fusion_groups` against the JAX package's.  (d) The pipeline with
TPU.fuse_chunk 8 against 1: volumes and poses bit for bit.  (e) The
port's chunk against the JAX `fuse_frames_scan` on its kernel branch
(Pallas in interpret mode), by block key."""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gps_slam_tpu.data import synthetic
from gps_slam_tpu.slam.pipeline import SLAMPipeline as JPipeline
from gps_slam_tpu.tsdf import hash as jhash
from gps_slam_tpu.tsdf import integrate as jint
from gps_slam_tpu.tsdf import integrate_pallas as ipk
from gps_slam_tpu.tsdf import volume as jvol
from gps_slam_torch.slam.pipeline import SLAMPipeline as TPipeline
from gps_slam_torch.tsdf import hash as thash
from gps_slam_torch.tsdf import integrate as tint
from gps_slam_torch.tsdf import volume as tvol
from test_torch_megastep import NoHostReads, _pipeline

VOLUME_FIELDS = ("table_keys", "table_ptrs", "block_coords", "state", "color",
                 "summary", "last_seen")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Many small torch ops per frame: one thread per test worker keeps
    them from handing work between threads.  Module scope sets it before
    the module's other fixtures run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ (a) insert

def _insert_case(case):
    """(table shape, capacity, key batches): `racing` hashes 600 keys into
    a 256-slot table (8-lane buckets overfull, claims racing for slots),
    `overflow` runs the pool out of rows in the second batch, `all_empty`
    inserts nothing."""
    rng = np.random.default_rng(3)
    coords = np.unique(rng.integers(-60, 60, size=(900, 3)), axis=0)[:600]
    keys = thash.pack(*(torch.as_tensor(coords[:, i]) for i in range(3)))
    if case == "all_empty":
        return (2, 128), 1024, [torch.full((300,), thash.EMPTY, dtype=torch.int32)]
    batches = [keys[:250], torch.cat([keys[200:450], torch.full((40,), thash.EMPTY,
                                                                dtype=torch.int32)]),
               keys[400:]]
    batches = [thash.dedup_candidates(b, 512) for b in batches]
    if case == "racing":
        return (2, 128), 4096, batches
    return (64, 128), 300, batches


@pytest.mark.parametrize("case", ["racing", "overflow", "all_empty"])
def test_insert_static_matches_insert(case):
    """`insert_static` against the JAX `insert`: the same table keys and
    pointers, block coordinates, per-candidate pool rows and allocated
    count after each batch (claim_rounds 2, as fusion inserts).  The
    port's `insert` is `insert_static` with a host count."""
    (R, W), B, batches = _insert_case(case)
    sta = [torch.full((R, W), thash.EMPTY, dtype=torch.int32),
           torch.full((R, W), -1, dtype=torch.int32),
           torch.full((B,), thash.EMPTY, dtype=torch.int32)]
    ref = [jnp.full((R, W), jhash.EMPTY, dtype=jnp.uint32),
           jnp.full((R, W), -1, dtype=jnp.int32), jnp.zeros((), jnp.int32),
           jnp.full((B,), jhash.EMPTY, dtype=jnp.uint32)]
    n_sta = torch.zeros((), dtype=torch.int64)
    for b in batches:
        *ref, j_ptrs = jhash.insert(*ref, jnp.asarray(b.numpy().view(np.uint32)), 8, B,
                                    claim_rounds=2, return_ptrs=True)
        n_sta, p_sta = thash.insert_static(*sta[:2], n_sta, sta[2], b, 8, B,
                                           claim_rounds=2)
        n_ref = int(ref[2])
        assert int(n_sta) == n_ref
        np.testing.assert_array_equal(p_sta.numpy(), np.asarray(j_ptrs))
        for t, j in zip(sta, (ref[0], ref[1], ref[3])):
            np.testing.assert_array_equal(t.numpy().view(np.asarray(j).dtype),
                                          np.asarray(j))
    if case == "racing":
        assert 0 < n_ref < 600 and int((p_sta < 0).sum()) > 0   # dropped claims
    elif case == "overflow":
        assert n_ref == B
    else:
        assert n_ref == 0


# ------------------------------------------------------- (b) frame body

ROUTES = {"packed": (96, 72), "f32": (96, 72), "narrow": (48, 40)}


def _frames(width, height, n=4):
    return synthetic.make_cameras(n_frames=n, width=width, height=height)


def _params():
    return tvol.TsdfParams(voxel_size=0.02, mu=0.08, hash_size=1 << 14,
                           block_capacity=1 << 12, visible_capacity=1 << 11)


def _route(monkeypatch, route):
    if route == "f32":
        monkeypatch.setattr(tint, "_RESIDENT_BYTES", 0)
        assert tint.integrate_route(96, 72) == "pregather"


def _tensors(cam):
    return (torch.as_tensor(cam.depth[..., 0]), torch.as_tensor(cam.image),
            torch.as_tensor(cam.c2w))


@pytest.mark.parametrize("route", list(ROUTES))
def test_static_frame_body_matches_fuse_frame(route, monkeypatch):
    """Four frames through `fuse_frame` and through `fuse_frame_static`
    (whose integration set is padded to `static_rows` with EMPTY rows):
    every volume tensor, the allocated count and each frame's candidate
    count bit for bit."""
    _route(monkeypatch, route)
    cams = _frames(*ROUTES[route])
    p = _params()
    a, b = tvol.create(p, "cpu"), tvol.create(p, "cpu")
    nb = torch.zeros((), dtype=torch.int64)
    for cam in cams:
        tint.fuse_frame(a, *_tensors(cam), cam.K)
        n_vis = tint.fuse_frame_static(b, *_tensors(cam), cam.K, nb)
        assert int(nb) == a.n_blocks and int(n_vis) == a.n_visible
    assert tint.static_rows(p, cams[0].height, cams[0].width) > a.n_visible
    for k in VOLUME_FIELDS:
        assert torch.equal(getattr(a, k), getattr(b, k)), k


@pytest.mark.parametrize("route", list(ROUTES))
def test_static_frame_body_reads_nothing_back(route, monkeypatch):
    """The frame body (with the bilateral filter) under a guard that fails
    on every read of a tensor's values on the host, every shape made from
    data and every number assigned by index: what a CUDA graph cannot
    capture."""
    _route(monkeypatch, route)
    cams = _frames(*ROUTES[route], n=2)
    vol = tvol.create(_params(), "cpu")
    nb = torch.zeros((), dtype=torch.int64)
    tint.fuse_frame_static(vol, *_tensors(cams[0]), cams[0].K, nb)
    with NoHostReads():
        n_vis = tint.fuse_frame_static(vol, *_tensors(cams[1]), cams[1].K, nb,
                                       bilateral=True)
    assert int(n_vis) > 0 and int(nb) > 0


# ---------------------------------------------------- (c) fusion groups

@pytest.mark.parametrize("mode", ["train", "recon"])
@pytest.mark.parametrize("interval", [3, 10])
@pytest.mark.parametrize("chunk", [1, 3, 8])
def test_fusion_groups_match_jax(mode, interval, chunk):
    """The groups of `_fusion_groups` over several totals, with and without
    chunking, are the JAX package's."""
    me = types.SimpleNamespace(cfg=types.SimpleNamespace(work_mode=mode))
    p = types.SimpleNamespace(local_opt_interval=interval)
    for total in (1, 2, 7, 10, 11, 25, 31):
        for can in (True, False):
            got = list(TPipeline._fusion_groups(me, total, p, can, chunk))
            assert got == list(JPipeline._fusion_groups(me, total, p, can, chunk))
            assert sum(got, []) == list(range(total))


# ------------------------------------------------------ (d) the pipeline

@pytest.fixture(scope="module")
def chunked_and_per_frame(tmp_path_factory):
    """tests/test_slam.py's dataset (13 frames at 160x120, windows at
    frames 4, 8 and 12, 2 Adam steps each) through the port's pipeline
    with TPU.fuse_chunk 8 and 1; the group sizes that each run took."""
    cams = synthetic.make_cameras(n_frames=13, width=160, height=120)
    runs = {}
    for chunk in (8, 1):
        cfg, eng, model, pipe = _pipeline(tmp_path_factory.mktemp(f"c{chunk}"), cams,
                                          tpu={"fuse_chunk": chunk}, local_opt_iters=2)
        sizes = []
        gt = eng.process_frames_gt
        eng.process_frames_gt = lambda frames, _gt=gt: (sizes.append(len(frames)),
                                                        _gt(frames))[1]
        pipe.slam_train_cams(model, cams)
        runs[chunk] = (eng, model, sizes)
    return runs


def test_pipeline_chunked_matches_per_frame(chunked_and_per_frame):
    """Groups of 5, 4 and 4 frames (the window frames 4, 8 and 12 end
    them) with fuse_chunk 8, one frame at a time with 1; the volumes, the
    recorded poses, the counts and the Gaussian pools bit for bit."""
    ec, mc, sc = chunked_and_per_frame[8]
    ep, mp_, sp = chunked_and_per_frame[1]
    assert sc == [5, 4, 4] and sp == []
    for k in VOLUME_FIELDS:
        assert torch.equal(getattr(ec.vol, k), getattr(ep.vol, k)), k
    assert (ec.vol.n_blocks, ec.vol.n_visible) == (ep.vol.n_blocks, ep.vol.n_visible)
    assert ec.peak_visible == ep.peak_visible
    np.testing.assert_array_equal(np.stack(ec.cam_poses), np.stack(ep.cam_poses))
    assert mc.num_gaussians == mp_.num_gaussians > 0
    assert torch.equal(mc.pool.alive, mp_.pool.alive)


# ------------------------------------------------------------ (e) JAX

def test_chunk_matches_jax_fuse_frames_scan(monkeypatch):
    """Four frames at 128x96 as one chunk: the JAX `fuse_frames_scan` on its
    kernel branch (the packed integrate kernel in interpret mode) and the
    port's `process_frames_gt`.  By block key, with
    test_fusion_matches_jax_by_block_key's tolerances: the same keys,
    weights equal on >= 99.5% of the voxels, sdf within 2e-3 on >= 99% of
    the voxels both integrated."""
    from gps_slam_torch.config import Config as TConfig
    from gps_slam_torch.tsdf.engine import TsdfEngine

    monkeypatch.setattr(ipk, "integrate_blocks_packed",
                        functools.partial(ipk.integrate_blocks_packed, interpret=True))
    cams = synthetic.make_cameras(n_frames=4, width=128, height=96)
    kw = dict(voxel_size=0.02, mu=0.08, hash_size=1 << 16, block_capacity=1 << 13,
              visible_capacity=1 << 11)
    jv = jvol.create(jvol.TsdfParams(raycast_steps=64, **kw))
    scan = jax.jit(jint.fuse_frames_scan.__wrapped__, static_argnums=(5, 6, 7, 8))
    jv = scan(jv, jnp.asarray(np.stack([c.depth[..., 0] for c in cams])),
              jnp.asarray(np.stack([c.image for c in cams])),
              jnp.asarray(np.stack([c.c2w for c in cams])), jnp.asarray(cams[0].K),
              False, True, None, None)

    d = synthetic.default_config_dict("unused", {
        "input_dir": "m", "image_path": "c", "pose_path": "c", "depth_path": "d",
        "pcd_name": "n", "depth_scale": 6553.5, "scene_scale": 1.0, "start_frame": 0,
        "end_frame": 3, "frame_step": 1, "intrinsics": [cams[0].fx, cams[0].fy,
                                                        cams[0].cx, cams[0].cy],
        "image_shape": [128, 96], "downscale_factor": 1, "test_split_interval": -1})
    d["PIPE"]["TSDF"].update(voxel_size=kw["voxel_size"], trunc_dist=kw["mu"])
    d["TPU"].update(hash_size=kw["hash_size"], block_capacity=kw["block_capacity"],
                    visible_block_capacity=kw["visible_capacity"])
    eng = TsdfEngine(TConfig.from_dict(d), 128, 96, cams[0].K, device="cpu")
    eng.set_gt_poses([c.c2w for c in cams])
    eng.turn_off_tracking()
    assert eng.can_chunk_fusion()
    eng.process_frames_gt([(torch.as_tensor(c.image), torch.as_tensor(c.depth))
                           for c in cams])
    tv = eng.vol
    n = int(jv.n_blocks)
    assert tv.n_blocks == n > 100
    jk = np.asarray(jv.block_coords)[:n]
    tk = tv.block_coords[:n].numpy().view(np.uint32)
    assert set(jk.tolist()) == set(tk.tolist())
    js = np.asarray(jv.state)[:n][np.argsort(jk)]
    ts = tv.state[:n].numpy().view(np.uint32)[np.argsort(tk)]
    jw, tw = (js >> 16) & 0xFF, (ts >> 16) & 0xFF
    assert np.mean(jw == tw) >= 0.995
    both = (jw > 0) & (tw > 0)
    fj = np.asarray(jvol.state_sdf_f32(jnp.asarray(js)))
    ft = np.asarray(jvol.state_sdf_f32(jnp.asarray(ts)))
    assert np.mean(np.abs(fj - ft)[both] < 2e-3) >= 0.99
