"""The port's multi-device modules held against the JAX package: spatial
sharding of the TSDF pool (`parallel/spatial.py`: the ownership bits,
sharded fusion and the nearest-hit raycast merge, the engine's
`TPU.space_shards` switch, mesh export and the sharded scene.npz) and
camera data parallelism (`parallel/mesh.py`: the data-parallel Adam step
and eval render, the pipeline's padded data-parallel eval batch).

The JAX side runs on its 8 virtual CPU devices (tests/conftest.py); the
port takes a list of devices, here the CPU repeated, and its kernels'
plain versions."""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gps_slam_tpu.data import synthetic
from gps_slam_tpu.parallel import spatial as jsp
from gps_slam_tpu.tsdf import hash as jhash
from gps_slam_tpu.tsdf import volume as jvol
from gps_slam_torch import convert
from gps_slam_torch.parallel import mesh as tmesh
from gps_slam_torch.parallel import spatial as tsp
from gps_slam_torch.tsdf import hash as thash
from gps_slam_torch.tsdf import integrate as tint
from gps_slam_torch.tsdf import raycast_tiles as trc
from gps_slam_torch.tsdf import volume as tvol

VOX = 0.02
TX_CFG = (0.00016, 1.6e-6, 0.005, 0.001, 0.0025, 0.0005, 0.05, 0.003, False)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Fusion and raycasts at 96x72 are many small torch ops; one thread per
    test worker keeps them from handing work between threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint32)


def _by_key(block_coords, n, *planes) -> dict:
    keys = np.asarray(block_coords)[:n]
    return {int(k): tuple(np.asarray(p)[i] for p in planes) for i, k in enumerate(keys)}


# ---------------------------------------------------------------- ownership

def test_shard_owner_matches_jax():
    """The shard that owns a key: the JAX package multiplies int32 coords
    and relies on the wrap, the port masks an int64 product; the bits are
    equal, exactly, for random keys over the whole coordinate range."""
    rng = np.random.default_rng(5)
    xyz = rng.integers(-511, 512, size=(20000, 3)).astype(np.int32)
    jk = jhash.pack(*[jnp.asarray(xyz[:, k]) for k in range(3)])
    tk = thash.pack(*[torch.as_tensor(xyz[:, k]) for k in range(3)])
    for S in (2, 3, 4, 8):
        j = np.asarray((jhash.hash_packed(jk, 1 << 30) >> 21) % S)
        t = tint.shard_owner(tk, S).numpy()
        np.testing.assert_array_equal(j, t)
        assert len(np.unique(t)) == S


# ---------------------------------------------------------------- sharded fusion

@pytest.fixture(scope="module", params=[2, 4])
def fused_shards(request):
    """4 synthetic frames at 96x72 fused S ways by both packages (the JAX
    sharded fusion is its XLA branch) and by the port into one volume of S
    times the per-shard capacities."""
    S = request.param
    cams = synthetic.make_cameras(n_frames=4, width=96, height=72)
    d = dict(voxel_size=VOX, mu=0.08, hash_size=1 << 14, block_capacity=1 << 11,
             visible_capacity=1 << 11, frustum_min=0.2, frustum_max=10.0)
    js = jsp.create_sharded(jvol.TsdfParams(raycast_steps=64, **d), S)
    ts = tsp.create_sharded(tvol.TsdfParams(**d), S, "cpu")
    single = tvol.create(tvol.TsdfParams(**dict(
        d, hash_size=d["hash_size"] * S, block_capacity=d["block_capacity"] * S)), "cpu")
    for cam in cams:
        depth, rgb, c2w = cam.depth[..., 0], cam.image, cam.c2w
        js = jsp.fuse_frame_sharded(js, jnp.asarray(depth), jnp.asarray(rgb),
                                    jnp.asarray(c2w), jnp.asarray(cam.K), S)
        args = (torch.as_tensor(depth), torch.as_tensor(rgb), torch.as_tensor(c2w), cam.K)
        tsp.fuse_frame_sharded(ts, *args)
        tint.fuse_frame(single, *args)
    return S, js, ts, single, cams


def test_sharded_fusion_matches_jax(fused_shards):
    """Per shard: the same allocated count and key set as the JAX sharded
    fusion, exactly (allocation is integer work), and weights equal by key
    on >= 99.5% of voxels (the JAX CPU fusion anchors each block's window
    otherwise: test_fusion_matches_jax_by_block_key's tolerance).  Against
    the port's single volume: every key both hold has the same state,
    colour and summary words, bit for bit (the update reads only the
    frame), and the key sets differ by at most 0.5% of the keys: with two
    claim rounds `hash.insert` drops a candidate that loses two races for
    a free slot of its probe group, and the shard tables are masked and
    filled otherwise than the single table (measured: 4 of 1258 keys at
    S = 2, 3 of 1258 at S = 4)."""
    S, js, ts, single, _ = fused_shards
    assert tsp.total_blocks(ts) == int(jsp.total_blocks(js))
    union = {}
    for s in range(S):
        n = int(js.n_blocks[s])
        assert ts[s].n_blocks == n > 0
        jmap = _by_key(js.block_coords[s], n, js.state[s])
        tmap = _by_key(_u32(ts[s].block_coords), n, _u32(ts[s].state),
                       _u32(ts[s].color), ts[s].summary.numpy())
        assert set(jmap) == set(tmap)
        owner = tint.shard_owner(torch.as_tensor(np.array(list(tmap), np.int64)), S)
        assert (owner == s).all()
        ks = sorted(jmap)
        jw = (np.stack([jmap[k][0] for k in ks]) >> 16) & 0xFF
        tw = (np.stack([tmap[k][0] for k in ks]) >> 16) & 0xFF
        assert np.mean(jw == tw) >= 0.995
        union.update(tmap)
    smap = _by_key(_u32(single.block_coords), single.n_blocks, _u32(single.state),
                   _u32(single.color), single.summary.numpy())
    common = set(union) & set(smap)
    assert len(set(union) ^ set(smap)) <= 0.005 * len(smap)
    for k in common:
        for a, b in zip(union[k], smap[k]):
            assert np.array_equal(a.view(np.uint32), b.view(np.uint32)), k


def test_sharded_raycast_matches_jax(fused_shards):
    """The merged raycast from frame 2 against the JAX `raycast_sharded`
    (its XLA march) with the gates of tests/test_parallel.py: hit masks
    differ on < 6% of pixels, >= 94% of the both-hit depths within 2
    voxels, median error against the analytic depth < 1.5 voxels, mean
    colour difference < 0.05; the counts are the shards' sums."""
    S, js, ts, _, cams = fused_shards
    cam = cams[2]
    mj = jsp.raycast_sharded(js, jnp.asarray(cam.c2w), jnp.asarray(cam.K),
                             cam.width, cam.height, 24, 4, 8, 32)
    mt = tsp.raycast_sharded(ts, cam.c2w, cam.K, cam.width, cam.height, 24, 4, 8, 2)
    dj = np.asarray(mj["depth_map"])[..., 0]
    dt = mt["depth_map"][..., 0].numpy()
    assert np.mean((dj > 0) != (dt > 0)) < 0.06
    both = (dj > 0) & (dt > 0)
    assert both.mean() > 0.5
    assert np.mean(np.abs(dj - dt)[both] < 2 * VOX) > 0.94
    gt = cam.depth[..., 0]
    assert np.median(np.abs(dt - gt)[(dt > 0) & (gt > 0)]) < 1.5 * VOX
    cj = np.asarray(mj["color_map"])[both]
    assert np.abs(cj - mt["color_map"].numpy()[both]).mean() < 0.05
    per = [trc.raycast(v, cam.c2w, cam.K, cam.width, cam.height, 24, 4, 8, 2,
                       need_normals=False) for v in ts]
    assert mt["n_visible"] == sum(m["n_visible"] for m in per)
    # the nearest shard's hit wins each pixel
    dmin = np.min([np.where(m["depth_map"][..., 0].numpy() > 0,
                            m["depth_map"][..., 0].numpy(), np.inf) for m in per], 0)
    np.testing.assert_array_equal(np.where(np.isfinite(dmin), dmin, 0), dt)


# ---------------------------------------------------------------- engine

def _engine_config(tmp, cams, tpu: dict):
    from gps_slam_torch.config import Config
    from gps_slam_torch.data import synthetic as tsyn

    c = cams[0]
    node = {"input_dir": "mem", "image_path": "c", "pose_path": "c", "depth_path": "d",
            "pcd_name": "n", "depth_scale": 6553.5, "scene_scale": 1.0,
            "start_frame": 0, "end_frame": len(cams) - 1, "frame_step": 1,
            "intrinsics": [c.fx, c.fy, c.cx, c.cy], "image_shape": [c.width, c.height],
            "downscale_factor": 1, "test_split_interval": -1}
    d = tsyn.default_config_dict(str(tmp), node)
    d.setdefault("TPU", {}).update(tpu)
    return Config.from_dict(d)


def _engine(tmp, cams, shards: int, fuse: bool = True, **tpu):
    from gps_slam_torch.tsdf.engine import TsdfEngine

    cfg = _engine_config(tmp, cams, {"space_shards": shards, "hash_size": 2 ** 16,
                                     "block_capacity": 2 ** 13,
                                     "visible_block_capacity": 2 ** 12, **tpu})
    eng = TsdfEngine(cfg, cams[0].width, cams[0].height, cams[0].K, device="cpu")
    eng.set_gt_poses([c.c2w for c in cams])
    eng.turn_off_tracking()
    for c in cams if fuse else []:
        eng.process_frame(c.image, c.depth)
    return eng


def test_engine_space_shards_config_switch(tmp_path):
    """tests/test_parallel.py's config switch on the port: `TPU.space_shards`
    2 routes the engine through the sharded fusion and raycast, each shard
    at half the capacities; the raycast from frame 0 agrees with the single
    volume's (both-hit > 50% of pixels, >= 90% of them within 2 voxels), and
    the sharded volume exports a mesh.  As in the JAX package, each shard
    is meshed alone and the triangles concatenated, so a cell whose corners
    reach into a block of the other shard is skipped: the mesh keeps
    between half and all of the single volume's triangles (measured 76.5%)."""
    from gps_slam_torch.utils import io as uio

    W, H, N = 128, 96, 5
    cams = synthetic.make_cameras(n_frames=N, width=W, height=H)
    eng2 = _engine(tmp_path / "s2", cams, 2)
    eng1 = _engine(tmp_path / "s1", cams, 1)
    assert eng2.space_shards == 2 and len(eng2.shards) == 2
    assert eng1.shards == [eng1.vol]
    with pytest.raises(RuntimeError, match="space shards"):
        eng2.vol
    assert all(v.params.hash_size == 2 ** 15 and v.params.block_capacity == 2 ** 12
               for v in eng2.shards)
    assert tsp.total_blocks(eng2.shards) == pytest.approx(eng1.vol.n_blocks, rel=0.005)
    cam0 = cams[0]
    d2 = eng2.run_raycast(cam0.c2w, cam0.K, W, H)["depth_map"][..., 0].numpy()
    d1 = eng1.run_raycast(cam0.c2w, cam0.K, W, H)["depth_map"][..., 0].numpy()
    both = (d1 > 0) & (d2 > 0)
    assert both.mean() > 0.5
    assert np.mean(np.abs(d1 - d2)[both] < 2 * eng1.params.voxel_size) > 0.9
    batch = eng2.run_raycast_batch(np.stack([c.c2w for c in cams[:2]]))
    np.testing.assert_array_equal(batch["depth_map"][0].numpy(),
                                  eng2.run_raycast(cam0.c2w, quality=False)["depth_map"].numpy())
    eng2.save_mesh(str(tmp_path / "mesh2.ply"))
    eng1.save_mesh(str(tmp_path / "mesh1.ply"))
    v2 = uio.read_mesh_ply(str(tmp_path / "mesh2.ply"))[0]
    v1 = uio.read_mesh_ply(str(tmp_path / "mesh1.ply"))[0]
    assert 0.5 * len(v1) < len(v2) < len(v1)
    with pytest.raises(ValueError, match="mutually exclusive"):
        _engine(tmp_path / "sw", cams[:1], 2, enable_swapping=1)


def test_sharded_scene_roundtrip(tmp_path):
    """A sharded scene.npz loads back into a fresh sharded engine: every
    volume tensor equal and the raycast from frame 0 equal bit for bit.  The
    port writes each volume field with a leading [S] axis and records
    `space_shards`.  This is a stated deviation from the JAX package, whose
    sharded `save_scene` slices the stacked summary on the block axis
    (its `mip` comes out [S, 64, 128]) and flattens the table across the
    shards, which its `load_scene` then reshapes without the shard axis: a
    sharded JAX `train` run writes a scene that `eval` mode cannot load
    (shown below on a 2-shard JAX engine).  A file of the other shard count
    is refused."""
    from gps_slam_tpu.config import Config as JConfig
    from gps_slam_tpu.tsdf.engine import TsdfEngine as JEngine

    cams = synthetic.make_cameras(n_frames=3, width=64, height=48)
    eng = _engine(tmp_path / "a", cams, 2)
    eng.save_scene(str(tmp_path / "scene"))
    z = np.load(str(tmp_path / "scene" / "scene.npz"))
    B, Hs = eng.params.block_capacity, eng.params.hash_size
    assert int(z["space_shards"]) == 2
    assert z["mip"].shape == (2, B, 64) and z["table_keys"].shape == (2, Hs)
    assert z["n_blocks"].tolist() == [v.n_blocks for v in eng.shards]

    fresh = _engine(tmp_path / "b", cams, 2, fuse=False)
    fresh.load_scene(str(tmp_path / "scene"))
    for a, b in zip(eng.shards, fresh.shards):
        assert a.n_blocks == b.n_blocks
        for k in ("table_keys", "table_ptrs", "block_coords", "state", "color",
                  "summary", "last_seen"):
            assert torch.equal(getattr(a, k), getattr(b, k)), k
    m0 = eng.run_raycast(cams[0].c2w)
    m1 = fresh.run_raycast(cams[0].c2w)
    for k in ("depth_map", "vertex_map", "color_map", "confidence_map", "normal_map"):
        assert torch.equal(m0[k], m1[k]), k
    with pytest.raises(ValueError, match="space shards"):
        _engine(tmp_path / "c", cams, 1, fuse=False).load_scene(str(tmp_path / "scene"))

    d = _engine_config(tmp_path / "j", cams, {}).raw
    d["TPU"].update(space_shards=2, hash_size=2 ** 16, block_capacity=2 ** 13,
                    visible_block_capacity=2 ** 12)
    jeng = JEngine(JConfig.from_dict(d), 64, 48, cams[0].K)
    jeng.set_gt_poses([c.c2w for c in cams])
    jeng.turn_off_tracking()
    for c in cams:
        jeng.process_frame(jnp.asarray(c.image), jnp.asarray(c.depth))
    jeng.save_scene(str(tmp_path / "jscene"))
    zj = np.load(str(tmp_path / "jscene" / "scene.npz"))
    assert zj["mip"].shape == (2, 64, 128)
    assert zj["table_keys"].shape == (2 * Hs,)


# ---------------------------------------------------------------- data parallelism

def _tiny():
    """__graft_entry__._tiny_setup's pool and camera, carried to the port."""
    import __graft_entry__ as g
    from gps_slam_torch.gs.model import RenderStatics

    pool, st, c2w, K, ref_depth, base_color = g._tiny_setup()
    tpool = convert.pool_from_numpy({k: np.asarray(v) for k, v in pool.params.items()},
                                    np.asarray(pool.alive), "cpu")
    tst = RenderStatics(**{f: getattr(st, f) for f in RenderStatics._fields})
    return pool, st, tpool, tst, np.asarray(c2w), np.asarray(K)


def _batch(c2w, K, gt, n, lib):
    H, W = gt.shape[:2]
    if lib == "jax":
        tile = lambda a: jnp.tile(jnp.asarray(a)[None], (n,) + (1,) * a.ndim)  # noqa: E731
        ids = jnp.zeros((n,), jnp.int32)
    else:
        tile = lambda a: torch.as_tensor(np.array(a))[None].repeat(n, *([1] * a.ndim))  # noqa: E731
        ids = torch.zeros((n,), dtype=torch.int32)
    return {"c2w": tile(c2w), "K": tile(K), "gt_rgb": tile(gt),
            "ref_depth": tile(np.zeros((H, W), np.float32)),
            "base_color": tile(np.zeros((H, W, 3), np.float32)), "cam_id": ids}


def test_dp_train_step_matches_jax_and_single():
    """One data-parallel Adam step over 8 replicas, each with its own
    camera (perturbed pose, its own gt image): the port (8 CPU entries in
    its device list) against the JAX `dp_train_step_fn` on its 8 virtual
    devices (its splat in interpret mode), and against one replica that
    takes the mean loss over all 8 cameras.  The replicas' averaged
    gradient equals that single gradient within 1e-6 of each parameter's
    largest |gradient| (8 per-camera terms summed in another order;
    measured <= 1.2e-7), while camera 0's gradient alone, or the replicas'
    sum, is off by far more; the loss equals the per-camera mean within
    1e-6; every parameter within 1e-6 of the single step's.  Against the
    JAX step: the loss within 1e-6, >= 99% of each parameter's elements
    within 1e-6 and all within tests/test_parallel.py's 5e-4: Adam's first
    step is lr * g / (|g| + 1e-8), so an element whose gradient is near
    1e-8 moves by a share of lr that the gradient's last bits decide, and
    the JAX K5 sums its pixels through moments (ROADMAP section 3;
    measured: 2 of 512 opacities off by 5.3e-6, every other element within
    1e-6)."""
    from gps_slam_tpu.gs import optim as joptim
    from gps_slam_tpu.parallel import mesh as jmesh
    from gps_slam_torch.gs import losses
    from gps_slam_torch.gs.model import ges_forward
    from gps_slam_torch.gs.optim import WindowAdam

    pool, st, tpool, tst, c2w, K = _tiny()
    n = 8
    rng = np.random.default_rng(3)
    gts = rng.uniform(0, 1, (n, st.height, st.width, 3)).astype(np.float32)
    poses = np.repeat(c2w[None], n, 0).astype(np.float32)
    poses[:, :3, 3] += rng.normal(0, 0.05, (n, 3)).astype(np.float32)
    jb = _batch(c2w, K, gts[0], n, "jax")
    jb.update(c2w=jnp.asarray(poses), gt_rgb=jnp.asarray(gts))
    tb = _batch(c2w, K, gts[0], n, "torch")
    tb.update(c2w=torch.as_tensor(poses), gt_rgb=torch.as_tensor(gts))
    tx = joptim.make_optimizer(jmesh.optim_cfg(TX_CFG), 100)
    m8 = jmesh.make_mesh(8)
    # the JAX side on its kernels' semantics (interpret mode): its CPU
    # splat contracts in bf16, the port follows the kernels
    step8 = jmesh.dp_train_step_fn(m8, st._replace(splat_impl="pallas_interpret"),
                                   TX_CFG, 100, 0.0)
    jp, _, jl = step8(jmesh.replicate(m8, pool.params), jmesh.replicate(m8, pool.alive),
                      jmesh.replicate(m8, tx.init(pool.params)), jmesh.shard_batch(m8, jb))
    names = ("means_lr", "means_lr_final", "scales_lr", "quats_lr", "featuresDc_lr",
             "featuresRest_lr", "opacities_lr", "exposure_lr", "use_exposure")
    mcfg = SimpleNamespace(**dict(zip(names, TX_CFG)))
    out = {}
    for tag, devs, batch in (("dp", 8, tb), ("single", 1, tb),
                             ("cam0", 1, {k: v[:1] for k, v in tb.items()})):
        params = {k: v.detach().clone().requires_grad_(True) for k, v in tpool.params.items()}
        opt = WindowAdam(params, mcfg, 100)
        loss, grads = tmesh.dp_train_step(tmesh.make_mesh(devs, ["cpu"] * devs), params,
                                          tpool.alive, opt, batch, tst, 0.0,
                                          return_grads=True)
        out[tag] = (float(loss), grads, {k: v.detach().numpy() for k, v in params.items()})
    with torch.no_grad():
        per_cam = [float(losses.compute_loss(
            r["rgb"], r["depth"], tb["gt_rgb"][i], None, 0.0, 0.0)["total"])
            for i in range(n) for r in [ges_forward(tpool.params, tpool.alive, tb["c2w"][i],
                                                    tb["K"][i], tb["ref_depth"][i],
                                                    tb["base_color"][i], 0, tst)]]
    loss_dp, g_dp, p_dp = out["dp"]
    assert abs(loss_dp - float(jl)) < 1e-6 and abs(loss_dp - out["single"][0]) < 1e-6
    assert abs(loss_dp - np.mean(per_cam)) < 1e-6 and np.ptp(per_cam) > 1e-3
    differs = 0
    for k, g in out["single"][1].items():
        tol = 1e-6 * float(g.abs().max())
        assert float((g_dp[k] - g).abs().max()) <= tol, k
        if tol > 0:
            assert float((8 * g_dp[k] - g).abs().max()) > 100 * tol, k
            differs += float((out["cam0"][1][k] - g).abs().max()) > 100 * tol
    assert differs >= 4
    moved = 0
    for k, v in p_dp.items():
        np.testing.assert_allclose(v, out["single"][2][k], rtol=0, atol=1e-6, err_msg=k)
        err = np.abs(v - np.asarray(jp[k]))
        assert np.mean(err <= 1e-6) >= 0.99 and err.max() < 5e-4, (k, err.max())
        moved += int((v != tpool.params[k].numpy()).sum())
    assert moved > 0


def test_dp_render_and_padded_eval_batch_match_forward_batch(tmp_path):
    """`dp_render` over 4 CPU entries equals `render_eval_batch` on 8
    perturbed cameras bit for bit (each camera renders alone either way),
    and the pipeline's `_eval_render_batch` over 3 devices pads 8 cameras
    to 9 and cuts back to `forward_batch`'s images, bit for bit."""
    from gps_slam_torch.config import Config
    from gps_slam_torch.gs.model import GaussianModel, render_eval_batch
    from gps_slam_torch.slam.pipeline import SLAMPipeline
    from gps_slam_torch.tsdf.engine import TsdfEngine

    _, st, tpool, tst, c2w, K = _tiny()
    n = 8
    rng = np.random.default_rng(1)
    poses = np.repeat(c2w[None], n, 0).astype(np.float32)
    poses[:, :3, 3] += rng.normal(0, 0.05, (n, 3)).astype(np.float32)
    batch = _batch(c2w, K, np.zeros((st.height, st.width, 3), np.float32), n, "torch")
    batch["c2w"] = torch.as_tensor(poses)
    batch["cam_id"] = torch.full((n,), -1, dtype=torch.int32)
    del batch["gt_rgb"]
    ref = render_eval_batch(tpool.params, tpool.alive, batch, tst)
    dp = tmesh.dp_render(tmesh.make_mesh(4, ["cpu"] * 4), tpool.params, tpool.alive,
                         batch, tst)
    for k in ("rgb", "alpha", "depth"):
        assert torch.equal(dp[k], ref[k]), k
    assert float(ref["alpha"].sum()) > 0

    cams = synthetic.make_cameras(n_frames=1, width=st.width, height=st.height)
    d = _engine_config(tmp_path, cams, {"gaussian_capacity": tpool.capacity}).raw
    d["MODEL"]["sh_degree"] = tpool.sh_degree
    cfg = Config.from_dict(d)
    model = GaussianModel(cfg, st.width, st.height, device="cpu")
    model.pool = tpool
    pipe = SLAMPipeline(cfg, TsdfEngine(cfg, st.width, st.height, K, device="cpu"),
                        str(tmp_path), is_train=False)
    assert pipe.eval_devices is None
    single = pipe._eval_render_batch(model, batch)
    pipe.eval_devices = tmesh.make_mesh(3, ["cpu"] * 3)
    padded = pipe._eval_render_batch(model, batch)
    for k in ("rgb", "alpha", "depth"):
        assert padded[k].shape[0] == n and torch.equal(padded[k], single[k]), k


def test_cli_sharded_tracked_train_then_eval(tmp_path):
    """slam_trainer_torch.main with `TPU.space_shards: 2` on an on-disk
    synthetic dataset on the CPU: tracked `train` (ICP against the merged
    raycasts, Adam windows at frames 4 and 8) writes a 2-shard scene.npz,
    the mesh and the model; `eval` mode then loads that scene into a
    sharded engine and renders the validation views."""
    import os

    import yaml

    import slam_trainer_torch
    from gps_slam_torch.data import synthetic as tsyn

    node = tsyn.write_dataset(str(tmp_path / "scene"), n_frames=9, width=96, height=72)
    node["test_split_interval"] = 3
    d = tsyn.default_config_dict(str(tmp_path / "scene"), node)
    d["PIPE"]["TSDF"]["use_gt_pose"] = False
    d["TPU"]["space_shards"] = 2
    d["workspace_dir"] = str(tmp_path / "ws")
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(yaml.safe_dump(d))
    slam_trainer_torch.main(str(cfg), device="cpu")
    ws = d["workspace_dir"]
    z = np.load(os.path.join(ws, d["PIPE"]["TSDF"]["saved_engine"], "scene.npz"))
    assert int(z["space_shards"]) == 2 and (z["n_blocks"] > 0).all()
    assert os.path.getsize(os.path.join(ws, d["PIPE"]["TSDF"]["saved_mesh"])) > 1000
    d["work_mode"] = "eval"
    cfg.write_text(yaml.safe_dump(d))
    slam_trainer_torch.main(str(cfg), device="cpu")
    renders = os.listdir(os.path.join(ws + d["PIPE"]["eval_path"], "render"))
    assert len(renders) > 0
