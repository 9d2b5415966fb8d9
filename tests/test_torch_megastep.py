"""The window megastep (`gps_slam_torch/slam/megastep.py`) on the CPU.

(a) Each fixed-shape helper against the dynamic form that the eager
window keeps, on seeded numpy inputs: equal on the live rows, bit for
bit.  (b) The port's `window_megastep` against the JAX package's, one
window from the same volume, pool, poses, camera sequence and spawn
pixels; the JAX side on its kernel branch with its Pallas kernels in
interpret mode.  (c) The port's pipeline with and without the megastep on
tests/test_slam.py's megastep fixture.  (d) `_can_megastep`, gate by
gate.  (e) PIPE.log_pipeline_time keeps every window on the per-phase
path.  Plus the megastep under a guard that fails on every call that
would read a device tensor back to the host on the card."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from gps_slam_torch import convert
from gps_slam_torch.config import Config as TConfig
from gps_slam_torch.data import synthetic as tsyn
from gps_slam_torch.gs import model as tmodel
from gps_slam_torch.gs import optim as toptim
from gps_slam_torch.gs import params as tparams
from gps_slam_torch.gs import rasterize as trast
from gps_slam_torch.slam import megastep as tms
from gps_slam_torch.slam.pipeline import SLAMPipeline
from gps_slam_torch.tsdf import raycast_tiles as trc
from gps_slam_torch.tsdf.engine import TsdfEngine
from gps_slam_torch.utils.se3 import pose_inv

ROW_KEYS = tparams.ROW_KEYS


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The windows at 64x48 and 96x64 are many small torch ops; one thread
    per test worker keeps them from handing work between threads (and from
    taking the cores of the other workers).  Module scope sets it before
    the module's other fixtures run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _node(cam, n_frames):
    return {"input_dir": "m", "image_path": "c", "pose_path": "c", "depth_path": "d",
            "pcd_name": "n", "depth_scale": 6553.5, "scene_scale": 1.0,
            "start_frame": 0, "end_frame": n_frames - 1, "frame_step": 1,
            "intrinsics": [cam.fx, cam.fy, cam.cx, cam.cy],
            "image_shape": [cam.width, cam.height], "downscale_factor": 1,
            "test_split_interval": -1}


def _config(tmp, cams, tpu=None, **pipe):
    d = tsyn.default_config_dict(str(tmp), _node(cams[0], len(cams)))
    d["PIPE"].update(pipe)
    d["TPU"].update(tpu or {})
    return d



def _pipeline(tmp, cams, disable_megastep=False, tpu=None, **pipe):
    """A CPU engine, model and pipeline on `cams` (gt poses)."""
    cfg = TConfig.from_dict(_config(tmp, cams, tpu, **pipe))
    W, H = cams[0].width, cams[0].height
    eng = TsdfEngine(cfg, W, H, cams[0].K, device="cpu")
    eng.set_gt_poses([c.c2w for c in cams])
    eng.turn_off_tracking()
    model = tmodel.GaussianModel(cfg, W, H, device="cpu")
    pipe_ = SLAMPipeline(cfg, eng, cfg.workspace_dir, is_train=False)
    pipe_.disable_megastep = disable_megastep
    return cfg, eng, model, pipe_


class NoHostReads(TorchFunctionMode):
    """Fails every call that reads a tensor's values on the host (on the
    card: a device-to-host copy and a synchronisation, which a CUDA graph
    cannot capture) or makes a shape from its values, and the item
    assignment of a host number (`t[i] = 1.0`, a host-to-device copy on
    the card, which a graph cannot capture either)."""

    READS = {"item", "tolist", "__bool__", "__int__", "__float__", "__index__",
             "cpu", "numpy", "nonzero", "argwhere", "bincount", "unique",
             "unique_consecutive", "masked_select", "repeat_interleave"}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", "")
        if name in self.READS:
            raise AssertionError(f"host read: {name}")
        if name == "where" and len(args) + len(kwargs) == 1:
            raise AssertionError("host read: one-argument torch.where")
        if name == "__setitem__" and isinstance(args[2], (bool, int, float)):
            raise AssertionError("host-to-device copy: a number assigned by index")
        if name in ("__getitem__", "__setitem__"):
            idx = args[1] if isinstance(args[1], tuple) else (args[1],)
            for i in idx:
                if torch.is_tensor(i) and i.dtype == torch.bool:
                    raise AssertionError("host read: boolean mask index")
                if isinstance(i, slice) and any(
                        torch.is_tensor(b) for b in (i.start, i.stop, i.step)):
                    raise AssertionError("host read: slice bound from a tensor")
        return func(*args, **kwargs)


def test_no_host_reads_guard_trips():
    """The guard catches what it is there to catch."""
    x = torch.arange(5)
    def assign():
        x[1] = 3

    for bad in (lambda: int(x.sum()), lambda: x[x > 2], lambda: torch.nonzero(x),
                lambda: bool(x.any()), lambda: x[:x[1]], assign):
        with pytest.raises(AssertionError, match="host"), NoHostReads():
            bad()


# ------------------------------------------------------ (a) static helpers

def _splat_inputs(seed, n=400, W=96, H=64):
    rng = np.random.default_rng(seed)
    m2d = np.stack([rng.uniform(-20, W + 20, n), rng.uniform(-20, H + 20, n)], -1)
    radii = np.where(rng.random(n) < 0.8, rng.integers(1, 40, n), 0)
    return torch.as_tensor(m2d.astype(np.float32)), torch.as_tensor(radii.astype(np.int32))


@pytest.mark.parametrize("caps", [(400, 24, 64), (150, 24, 64), (400, 4, 8)],
                         ids=["loose", "visible_cap", "tile_and_active_cap"])
def test_bin_gaussians_active_static_equals_dynamic(caps):
    """The fixed-shape binning gives the dynamic lists on its first A
    rows, then padding rows naming tile T and only the null row N; the
    overflow counts and the backward's segments are equal."""
    vis_cap, tile_cap, act_cap = caps
    m2d, radii = _splat_inputs(1)
    N, tw, th = m2d.shape[0], 6, 4
    args = (m2d, radii, 16, tw, th, vis_cap, 9, tile_cap, act_cap)
    dyn = trast.bin_gaussians_active(*args, margin_px=2.0, segments=True)
    sta = trast.bin_gaussians_active(*args, margin_px=2.0, segments=True, static=True)
    A = dyn.tiles.shape[0]
    assert sta.tiles.shape == (act_cap,) and sta.gids.shape == (act_cap, tile_cap)
    assert torch.equal(sta.tiles[:A], dyn.tiles) and (sta.tiles[A:] == tw * th).all()
    assert torch.equal(sta.gids[:A], dyn.gids) and (sta.gids[A:] == N).all()
    assert torch.equal(sta.valid[:A], dyn.valid) and not sta.valid[A:].any()
    for k in ("n_pairs", "n_tile_overflow", "n_span_overflow", "n_active_overflow"):
        assert int(getattr(sta, k)) == getattr(dyn, k), k
    assert torch.equal(sta.seg_lo, dyn.seg_lo) and torch.equal(sta.seg_hi, dyn.seg_hi)
    n_live = int((dyn.gids < N).sum())
    assert torch.equal(sta.pair_order[:n_live], dyn.pair_order[:n_live])
    if caps[0] < N:
        assert dyn.n_pairs < int(trast.bin_gaussians_active(
            m2d, radii, 16, tw, th, N, 9, tile_cap, act_cap).n_pairs)
    if caps[2] == 8:
        assert dyn.n_active_overflow > 0 and dyn.n_tile_overflow > 0


@functools.lru_cache(maxsize=None)
def _fused(tmp):
    """A CPU volume of 4 fused synthetic 64 x 48 frames and its cameras."""
    cams = tsyn.make_cameras(n_frames=4, width=64, height=48)
    cfg = TConfig.from_dict(_config(tmp, cams))
    eng = TsdfEngine(cfg, 64, 48, cams[0].K, device="cpu")
    eng.set_gt_poses([c.c2w for c in cams])
    eng.turn_off_tracking()
    for c in cams:
        eng.process_frame(c.image, c.depth)
    return eng, cams


@pytest.mark.parametrize("vis_cap,lb", [(4096, 32), (300, 2)], ids=["loose", "capped"])
def test_tile_bins_prefix_equals_dynamic(tmp_path_factory, vis_cap, lb):
    """`_tile_bins` over a static pool prefix above n_blocks gives the
    dynamic lists and counts, also where the visible cap and the list
    length bite; the raycast maps of both forms are equal."""
    eng, cams = _fused(str(tmp_path_factory.getbasetemp() / "fused"))
    vol = eng.vol
    prefix = trc.pool_prefix(vol.n_blocks, vol.params.block_capacity)
    assert vol.n_blocks < prefix == vol.params.block_capacity
    K = cams[0].K
    for cam in cams[::3]:
        c2w = torch.as_tensor(cam.c2w, dtype=torch.float32)
        w2c = pose_inv(c2w)
        args = (vol, w2c, K[0, 0], K[1, 1], K[0, 2], K[1, 2], 64, 48, vis_cap, lb, 6)
        g0, o0, v0 = trc._tile_bins(*args)
        g1, o1, v1 = trc._tile_bins(*args, prefix=prefix)
        assert torch.equal(g0, g1)
        assert (int(o1), int(v1)) == (o0, v0) and v0 > 0
        if vis_cap < v0:
            assert o0 > 0
    m0 = trc.raycast_batch(vol, [c.c2w for c in cams[:2]], K, 64, 48, 16, 4, 6, 1)
    m1 = trc.raycast_batch(vol, torch.as_tensor(np.stack([c.c2w for c in cams[:2]])),
                           K, 64, 48, 16, 4, 6, 1, prefix=prefix)
    for k, v in m0.items():
        assert torch.equal(torch.as_tensor(v), m1[k]), k


def _pool(seed, C=64, n_alive=20, sh_degree=1):
    rng = np.random.default_rng(seed)
    pool = tparams.create(C, sh_degree, device="cpu")
    attrs = {k: torch.as_tensor(rng.normal(size=(C, *v.shape[1:])).astype(np.float32))
             for k, v in pool.params.items() if k in ROW_KEYS}
    tparams.add(pool, attrs, n_alive)
    tparams.remove(pool, torch.as_tensor(rng.random(C) < 0.3))
    return pool, rng


def _clone_pool(pool):
    return dataclasses.replace(pool, **{k: getattr(pool, k).clone()
                                        for k in (*tparams.PARAM_KEYS, "alive")})


def _add_scatter(pool, attrs, count):
    """The pool's add as an index scatter: the first min(count, m) rows of
    `attrs` into the lowest free slots."""
    free = torch.nonzero(~pool.alive)[:, 0][:min(attrs["means"].shape[0], count)]
    n = free.shape[0]
    for k in ROW_KEYS:
        getattr(pool, k)[free] = attrs[k][:n]
    pool.alive[free] = True
    return n


@pytest.mark.parametrize("m,count", [(16, 10), (60, 60), (16, 0), (0, 5)],
                         ids=["some", "past_capacity", "none", "no_rows"])
def test_params_add_rows_equals_add(m, count):
    """`add_rows` places the rows an index scatter into the lowest free
    slots places and returns their count, which `add` adds to n_alive;
    `remove_rows` clears and counts the live rows of the mask, which
    `remove` takes from n_alive; `compact` permutes in place."""
    pool, rng = _pool(2)
    attrs = {k: torch.as_tensor(rng.normal(size=(m, *v.shape[1:])).astype(np.float32))
             for k, v in pool.params.items() if k in ROW_KEYS}
    ref, host = _clone_pool(pool), _clone_pool(pool)
    n0 = host.n_alive
    placed_ref = _add_scatter(ref, attrs, count)
    placed = tparams.add_rows(pool, attrs, torch.tensor(count))
    tparams.add(host, attrs, count)
    assert int(placed) == placed_ref == host.n_alive - n0
    for k in (*ROW_KEYS, "alive"):
        assert torch.equal(getattr(pool, k), getattr(ref, k)), k
        assert torch.equal(getattr(host, k), getattr(ref, k)), k
    kill = torch.as_tensor(rng.random(pool.capacity) < 0.4)
    n_live = int((ref.alive & kill).sum())
    ref.alive &= ~kill
    n_host = host.n_alive
    tparams.remove(host, kill)
    assert int(tparams.remove_rows(pool, kill)) == n_live == n_host - host.n_alive
    assert torch.equal(pool.alive, ref.alive) and torch.equal(host.alive, ref.alive)
    ptrs = [getattr(pool, k).data_ptr() for k in (*ROW_KEYS, "alive")]
    order = torch.argsort((~ref.alive).to(torch.int8), stable=True)
    tparams.compact(pool)
    assert [getattr(pool, k).data_ptr() for k in (*ROW_KEYS, "alive")] == ptrs
    n = int(pool.alive.sum())
    assert pool.alive[:n].all() and not pool.alive[n:].any()
    for k in (*ROW_KEYS, "alive"):
        assert torch.equal(getattr(pool, k), getattr(ref, k)[order]), k


def _add_gaussians_dynamic(pool, vertex, color, normal, mask, ratio, max_new, opac,
                           limits, prio):
    """The eager spawn as it stood before its fixed-shape form: host
    counts and `params.add`."""
    flat = mask.reshape(-1)
    max_new = min(max_new, flat.shape[0])
    n_valid = int(flat.sum())
    idx = torch.argsort(torch.where(flat, prio, torch.inf), stable=True)[:max_new]
    n_want = int(np.float32(n_valid) * np.float32(ratio))
    n_select = min(n_want, max_new)
    xyz = vertex.reshape(-1, 3)[idx]
    taken = (torch.arange(max_new) < n_select)[:, None]
    xyz = torch.where(taken, xyz, 1e6)
    attrs = tparams.init_attributes(xyz, color.reshape(-1, 3)[idx],
                                    normal.reshape(-1, 3)[idx], pool.sh_degree,
                                    opac, limits[1], limits[0])
    n0 = pool.n_alive
    tparams.add(pool, attrs, n_select)
    return pool.n_alive - n0, n_want - n_select


@pytest.mark.parametrize("max_new", [200, 40], ids=["room", "overflow"])
def test_add_gaussians_and_remove_redundant_static(max_new):
    """The spawn with device counts (no host count) against the dynamic
    spawn on the same priorities, then the prune: equal pools and counts."""
    rng = np.random.default_rng(3)
    H, W = 24, 32
    vertex = torch.as_tensor(rng.uniform(-1, 1, (H, W, 3)).astype(np.float32))
    color = torch.as_tensor(rng.uniform(size=(H, W, 3)).astype(np.float32))
    normal = torch.as_tensor(rng.normal(size=(H, W, 3)).astype(np.float32))
    mask = torch.as_tensor(rng.random((H, W)) > 0.5)
    prio = torch.as_tensor(rng.random(H * W).astype(np.float32))
    pool, _ = _pool(4, C=256, n_alive=30)
    ref = _clone_pool(pool)
    n_ref, o_ref = _add_gaussians_dynamic(ref, vertex, color, normal, mask, 0.5, max_new,
                                          0.5, (0.001, 0.05), prio)
    _, n_add, n_ofl = tmodel.add_gaussians(pool, vertex, color, normal, mask, 0.5,
                                           max_new, 0.5, (0.001, 0.05), prio,
                                           host_count=False)
    assert (int(n_add), int(n_ofl)) == (n_ref, o_ref) and n_ref > 0
    assert (o_ref > 0) == (max_new == 40)
    for k in (*ROW_KEYS, "alive"):
        assert torch.equal(getattr(pool, k), getattr(ref, k)), k
    thr = (0.003, 0.04, 0.3)
    max_scale = torch.exp(ref.scales).amax(-1)
    kill = ((max_scale < thr[0]) | (max_scale > thr[1])
            | (torch.sigmoid(ref.opacities[:, 0]) < thr[2])) & ref.alive
    n_before = ref.n_alive
    tparams.remove(ref, kill)
    _, n = tmodel.remove_redundant(pool, *thr, host_count=False)
    assert int(n) == n_before - ref.n_alive > 0
    assert torch.equal(pool.alive, ref.alive)


def test_window_adam_table_equals_per_step_rows():
    """The window's schedule table holds, row for row, the f32 values of
    optax's schedule computed in 0-d torch tensors; Adam with a window's
    12-row table moves the parameters as Adam with the default table of
    max_iterations rows (the offline trainer's), bit for bit, and an
    update past its table raises."""
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)  # noqa: E731
    means_lr, max_it = 1.6e-4, 30
    gamma = 0.01 ** (1.0 / max_it)
    table = toptim.window_schedule(means_lr, gamma, 12, torch.device("cpu"))
    for k in range(12):
        t = f32(k + 1)
        row = torch.stack([1.0 - f32(toptim.B1) ** t, 1.0 - f32(toptim.B2) ** t,
                           f32(means_lr) * f32(gamma) ** f32(k)])
        assert torch.equal(table[k], row), k
    cfg = tsyn.default_config_dict("x", _node(tsyn.make_cameras(1, 16, 16)[0], 1))
    mcfg = TConfig.from_dict(cfg).model
    rng = np.random.default_rng(5)
    p0 = {k: rng.normal(size=(10, 3)).astype(np.float32) for k in ROW_KEYS}
    runs = []
    for steps in (None, 12):
        p = {k: torch.tensor(v, requires_grad=True) for k, v in p0.items()}
        opt = toptim.WindowAdam(p, mcfg, max_it, steps=steps)
        assert opt.table.shape == (max_it if steps is None else steps, 3)
        g = np.random.default_rng(6)
        for _ in range(12):
            for v in p.values():
                v.grad = torch.as_tensor(g.normal(size=(10, 3)).astype(np.float32))
            opt.step()
        runs.append(p)
    with pytest.raises(IndexError, match="past the 12 steps"):
        opt.step()
    for k in ROW_KEYS:
        assert torch.equal(runs[0][k], runs[1][k]), k


# ------------------------------------------------- the megastep on the CPU

def _megastep_inputs(tmp_factory, n_gauss_stride=4):
    """One window's state and inputs at 64 x 48: the fused volume, a pool
    spawned from two frames' maps, 3 cameras padded to M = 4, the camera
    sequence of tests/test_torch_train.py's window and spawn priorities
    from numpy."""
    eng, cams = _fused(str(tmp_factory.getbasetemp() / "fused"))
    cfg = TConfig.from_dict(_config(str(tmp_factory.getbasetemp()), cams))
    model = tmodel.GaussianModel(cfg, 64, 48, device="cpu")
    mask = torch.zeros((48, 64), dtype=torch.bool)
    mask[::n_gauss_stride, ::n_gauss_stride] = True
    for i, c in enumerate(cams[:2]):
        fm = c.get_frame_maps("cpu")
        tmodel.add_gaussians(model.pool, fm["vertex_map"], fm["color_map"],
                             fm["normal_map"], mask, 0.7, 512, 0.5, (0.001, 0.05),
                             torch.Generator().manual_seed(i))
    rng = np.random.default_rng(7)
    sel = [0, 1, 3, 3]
    return {"eng": eng, "cams": cams, "cfg": cfg, "model": model,
            "poses": np.stack([cams[i].c2w for i in sel]).astype(np.float32),
            "gt": np.stack([cams[i].image for i in sel]).astype(np.float32),
            "idx": np.asarray([0, 2, 1, 1, 0, 2, 2, 0, 1, 0]),
            "prio": rng.random(64 * 48).astype(np.float32), "spawn_idx": 1}


def _port_statics(d, opt_cap):
    cfg, eng, model = d["cfg"], d["eng"], d["model"]
    p, m, tpu = cfg.pipe, cfg.model, cfg.tpu
    sc = tms.WindowScalars(
        p.depth_vis_min, p.depth_vis_max, p.color_error_thres, p.alpha_vis_max,
        p.new_gs_sample_ratio, tpu.max_new_gaussians, m.default_opacities,
        m.min_init_scale, m.max_init_scale, p.remove_small_scale_thres,
        p.remove_large_scale_thres, p.remove_low_opac_thres, p.ssim_weight,
        p.depth_weight, p.max_iterations)
    vp = eng.vol.params
    rk = tms.RayKnobs(64, 48, vp.raycast_lb, vp.raycast_samples, max(vp.raycast_bisect, 3))
    st = model.statics
    n_tiles = -(-st.width // st.tile_size) * -(-st.height // st.tile_size)
    st_spawn = st._replace(visible_cap=min(st.visible_cap, opt_cap),
                           active_tile_cap=min(n_tiles, max(st.active_tile_cap, opt_cap // 8)))
    return dict(st=st, st_spawn=st_spawn, sc=sc, rk=rk, mcfg=m,
                spawn_idx=d["spawn_idx"], opt_cap=opt_cap,
                pool_prefix=trc.pool_prefix(eng.vol.n_blocks, vp.block_capacity))


def _run_port(d, pool, opt_cap, guard=False):
    args = (d["eng"].vol, pool, torch.as_tensor(d["poses"]), d["cams"][0].K,
            torch.as_tensor(d["gt"]), torch.as_tensor(d["idx"], dtype=torch.int64),
            torch.as_tensor(d["prio"]))
    if guard:
        with NoHostReads():
            return tms.window_megastep(*args, **_port_statics(d, opt_cap))
    return tms.window_megastep(*args, **_port_statics(d, opt_cap))


def test_window_megastep_reads_nothing_back(tmp_path_factory):
    """The whole window, raycast to compaction, runs under `NoHostReads`
    and its counts are the pool's."""
    d = _megastep_inputs(tmp_path_factory)
    pool = _clone_pool(d["model"].pool)
    n0 = int(pool.alive.sum())
    out = _run_port(d, pool, d["model"].opt_cap(extra=512), guard=True)
    assert out["loss_hist"].shape == (len(d["idx"]),)
    assert torch.isfinite(out["loss_hist"]).all()
    n = int(out["n_alive"])
    assert n == int(pool.alive.sum()) and n != n0 > 0
    assert pool.alive[:n].all() and not pool.alive[n:].any()


def test_window_optimize_static_ssim_equals_dynamic(tmp_path_factory):
    """The image-space loss of a window with PIPE.ssim_weight > 0, which
    `_can_megastep` lets into the megastep (as in the JAX package): the
    static window (stacked SSIM moments, the gathered `ges_forward` over
    padded tile lists, `compute_loss`) under `NoHostReads`, against the
    dynamic window on the same pool, cameras and steps.  Its parameters
    and counts are the dynamic ones bit for bit and its loss history
    within 1e-6 relative (the padded tiles' zero rows are cut before the
    image is assembled, but the reductions of the loss run over stacked
    rows)."""
    d = _megastep_inputs(tmp_path_factory)
    model, cams, sel = d["model"], d["cams"], [0, 1, 3, 3]
    st, mcfg, max_it = model.statics, d["cfg"].model, d["cfg"].pipe.max_iterations
    opt_cap = model.opt_cap()
    batch = {"c2w": torch.as_tensor(d["poses"]), "gt_rgb": torch.as_tensor(d["gt"]),
             "ref_depth": torch.stack([torch.as_tensor(cams[i].depth[..., 0]) for i in sel]),
             "base_color": torch.as_tensor(0.5 * d["gt"]), "cam_id": [-1] * 4}
    K = np.asarray(cams[0].K, np.float32)
    idx = torch.as_tensor(d["idx"], dtype=torch.int64)
    pool_s, pool_d = _clone_pool(model.pool), _clone_pool(model.pool)
    with NoHostReads():
        _, aux_s = tmodel.window_optimize(pool_s, {**batch, "K": K}, idx, st, mcfg,
                                          max_it, 0.2, 0.0, opt_cap, static=True)
    _, aux_d = tmodel.window_optimize(pool_d, {**batch, "K": np.stack([K] * 4)},
                                      d["idx"].tolist(), st, mcfg, max_it, 0.2, 0.0,
                                      opt_cap)
    for k in (*ROW_KEYS, "alive"):
        assert torch.equal(getattr(pool_s, k), getattr(pool_d, k)), k
    assert not torch.equal(pool_s.means, model.pool.means)
    np.testing.assert_allclose(aux_s["loss_hist"].numpy(),
                               torch.stack(list(aux_d["loss_hist"])).numpy(), rtol=1e-6)
    for k in ("n_tile_overflow", "n_span_overflow", "n_active_overflow"):
        assert int(aux_s[k]) == int(aux_d[k]), k


def test_window_megastep_matches_jax(tmp_path_factory, monkeypatch):
    """(b) One window of both packages' window_megastep from the same
    state: the port's volume carried to the JAX engine through scene.npz,
    the pool through numpy, the same padded poses, camera sequence and
    spawn priorities (jax.random.uniform returns the numpy draw).  The
    JAX window is handed the port's raycast maps (K3 and the Pallas
    raycast differ in their last bits: bf16 reads, held to each other in
    test_torch_tsdf.py), and both spawn masks are replaced by the port's
    own, so that both spawn the same pixels into the same rows; the JAX
    mask agrees with it on >= 99% of pixels (the rendered alpha gate moves
    a few).  Then, as tests/test_torch_train.py holds window_optimize: the
    first step's loss within 1e-5 relative, every step within 5e-3 and at
    least 7 of the 10 within 1e-4, equal overflow and live counts, the
    final parameters row by row in units of each learning rate."""
    import gps_slam_tpu.gs.model as jmodel
    import gps_slam_tpu.slam.megastep as jms
    import gps_slam_tpu.tsdf.raycast_pallas as rcp
    from gps_slam_tpu.config import Config as JConfig
    from gps_slam_tpu.tsdf.engine import TsdfEngine as JEngine

    d = _megastep_inputs(tmp_path_factory)
    eng, model, cfg = d["eng"], d["model"], d["cfg"]
    opt_cap = model.opt_cap(extra=cfg.tpu.max_new_gaussians)
    pool_np = {k: v.numpy().copy() for k, v in model.pool.params.items()}
    alive = model.pool.alive.numpy().copy()

    # the port's raycast maps and natural spawn mask, then both packages
    # spawn from that mask
    seen = {}
    orig_t, orig_rc = tms.spawn_mask, trc.raycast_batch

    def record_t(*a):
        mask, normal = orig_t(*a)
        seen["torch"] = mask.numpy().copy()
        return mask, normal

    def record_rc(*a, **k):
        seen["maps"] = orig_rc(*a, **k)
        return seen["maps"]

    monkeypatch.setattr(tms, "spawn_mask", record_t)
    monkeypatch.setattr(trc, "raycast_batch", record_rc)
    pool_t = convert.pool_from_numpy(pool_np, alive, "cpu")
    out_t = _run_port(d, pool_t, opt_cap)
    assert pool_t.n_alive == int(alive.sum())  # the host count is left alone

    orig_j = jms._spawn_mask

    def fixed_j(*a):
        mask, normal = orig_j(*a)
        jax.debug.callback(lambda m: seen.__setitem__("jax", np.asarray(m)), mask)
        return jnp.asarray(seen["torch"]), normal

    monkeypatch.setattr(jms, "_spawn_mask", fixed_j)
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape, *a, **k: jnp.asarray(d["prio"]).reshape(shape))
    monkeypatch.setattr(rcp, "raycast_batch", lambda *a, **k: {
        n: jnp.asarray(seen["maps"][n].numpy())
        for n in ("depth_map", "vertex_map", "color_map")})
    tmp = tmp_path_factory.mktemp("jax_scene")
    eng.save_scene(str(tmp))
    jcfg = JConfig.from_dict(_config(str(tmp_path_factory.getbasetemp()), d["cams"]))
    jeng = JEngine(jcfg, 64, 48, d["cams"][0].K)
    jeng.load_scene(str(tmp))
    jm = jmodel.GaussianModel(jcfg, 64, 48)
    jm.pool = jm.pool.with_params({k: jnp.asarray(v) for k, v in pool_np.items()}).replace(
        alive=jnp.asarray(alive), n_alive=jnp.asarray(alive.sum(), jnp.int32))
    st_j = jm.statics._replace(splat_impl="pallas_interpret")
    st_t = model.statics
    assert tuple(st_t) == tuple(st_j[:-1])
    ps = _port_statics(d, opt_cap)
    vp = eng.vol.params
    rk_j = jms.RayKnobs(64, 48, vp.raycast_lb, vp.raycast_samples,
                        max(vp.raycast_bisect, 3), jeng.vol.params.raycast_tiles_per_step,
                        jeng.vol.params.raycast_chunk, True)
    sc_j = jms.WindowScalars(*ps["sc"])
    jax.clear_caches()
    try:
        pool_j, aux_j = jms.window_megastep(
            jeng.vol, jm.pool, jnp.asarray(d["poses"]), jnp.asarray(d["cams"][0].K),
            tuple(jnp.asarray(g) for g in d["gt"]), jnp.asarray(d["idx"], jnp.int32),
            jax.random.PRNGKey(0),
            st=st_j, st_spawn=st_j._replace(visible_cap=ps["st_spawn"].visible_cap,
                                            active_tile_cap=ps["st_spawn"].active_tile_cap),
            tx_cfg=jmodel.tx_cfg_tuple(jcfg.model), sc=sc_j, rk=rk_j,
            spawn_idx=d["spawn_idx"], pool_prefix=ps["pool_prefix"], opt_cap=opt_cap)
        jax.block_until_ready(pool_j.n_alive)
    finally:
        jax.clear_caches()
    assert np.mean(seen["jax"] == seen["torch"]) >= 0.99 and seen["torch"].sum() > 20

    hj, ht = np.asarray(aux_j["loss_hist"]), out_t["loss_hist"].numpy()
    rel = np.abs(ht - hj) / np.abs(hj)
    assert rel[0] <= 1e-5 and rel.max() <= 5e-3 and (rel <= 1e-4).sum() >= 7, rel
    for k in ("n_tile_overflow", "n_span_overflow", "n_active_overflow",
              "n_spawn_overflow"):
        assert int(out_t[k]) == int(aux_j[k]), k
    n = int(pool_j.n_alive)
    assert int(out_t["n_alive"]) == n == int(np.asarray(pool_j.alive).sum())
    assert np.array_equal(pool_t.alive.numpy(), np.asarray(pool_j.alive))
    m = cfg.model
    lrs = {"means": m.means_lr, "scales": m.scales_lr, "quats": m.quats_lr,
           "features_dc": m.featuresDc_lr, "features_rest": m.featuresRest_lr,
           "opacities": m.opacities_lr}
    iters = len(d["idx"])
    for k, lr in lrs.items():
        t = getattr(pool_t, k).numpy()[:n].reshape(n, -1)
        j = np.asarray(getattr(pool_j, k))[:n].reshape(n, -1)
        dd = np.abs(t - j).max(1) / lr
        stats = (k, dd.max(), (dd > 1).mean(), (dd < 1e-3).mean())
        assert dd.max() <= 2 * iters and (dd > 1).mean() < 0.1, stats
        assert (dd < 1e-3).mean() > 0.6, stats


# ------------------------------------------- (c)-(e) the pipeline's routes

N_FRAMES_C, W_C, H_C = 25, 96, 64


@pytest.fixture(scope="module")
def eager_and_megastep(tmp_path_factory):
    """tests/test_slam.py's megastep fixture (25 frames at 96 x 64, six
    windows) through the port's pipeline with and without
    `disable_megastep`, with 64-slot tile lists: the synthetic config's
    256 only lengthen the splat kernels' plain loops on the CPU (both runs
    bin alike either way)."""
    cams = tsyn.make_cameras(n_frames=N_FRAMES_C, width=W_C, height=H_C)
    runs = {}
    for name, dis in (("eager", True), ("megastep", False)):
        cfg, eng, model, pipe = _pipeline(tmp_path_factory.mktemp(name), cams, dis,
                                          tpu={"tile_gaussian_cap": 64})
        routes = []
        for fn in ("_run_window_megastep", "local_optimize"):
            orig = getattr(pipe, fn)
            setattr(pipe, fn, functools.partial(
                lambda o, f, *a: (routes.append(f), o(*a))[1], orig, fn))
        pipe.slam_train_cams(model, cams)
        cam = cams[12]
        ray = eng.run_raycast(cam.c2w, cam.K, cam.width, cam.height)
        res = model.forward(cam.c2w, cam.K, ray["depth_map"][..., 0], ray["color_map"])
        runs[name] = (pipe, model, torch.clamp(res["rgb"], 0, 1).numpy(), routes)
    return runs


def test_pipeline_megastep_matches_eager(eager_and_megastep):
    """(c) As tests/test_slam.py holds the JAX megastep: equal Gaussian
    counts and renders of frame 12 more than 45 dB apart.  The port's
    static forms keep the eager order, so here the pools are equal bit
    for bit and so are the overflow counts."""
    pe, me, ie, re_ = eager_and_megastep["eager"]
    pm, mm, im, rm = eager_and_megastep["megastep"]
    assert pm._megastep_ran and not pe._megastep_ran
    assert re_ == ["local_optimize"] * 6
    assert rm == ["local_optimize"] + ["_run_window_megastep"] * 5
    assert mm.num_gaussians == me.num_gaussians > 100
    mse = float(((im - ie) ** 2).mean())
    assert -10 * np.log10(max(mse, 1e-12)) > 45.0
    for k in (*ROW_KEYS, "alive"):
        assert torch.equal(getattr(mm.pool, k), getattr(me.pool, k)), k
    assert (pm._spawn_overflow, pm._bin_overflow) == (pe._spawn_overflow, pe._bin_overflow)
    assert pm.curr_iter == pe.curr_iter


def test_pipeline_megastep_loss_history(eager_and_megastep):
    """The last window's loss history: equal to the eager one within 1e-6
    relative (the static loss sums its padded tiles' zeros too, in
    another order); its parameters are the eager ones bit for bit."""
    he = eager_and_megastep["eager"][0]._last_loss_hist.numpy()
    hm = eager_and_megastep["megastep"][0]._last_loss_hist.numpy()
    assert hm.shape == he.shape == (10,)
    np.testing.assert_allclose(hm, he, rtol=1e-6)


GATES = ("disable_megastep", "exposure", "depth_weight", "debug_artifacts", "swap",
         "space_shards", "empty_model", "not_last_slot", "intrinsics", "image_size")


@pytest.mark.parametrize("gate", ("none",) + GATES)
def test_can_megastep_gates(tmp_path, gate):
    """(d) `_can_megastep`, gate by gate, on a pipeline holding a model
    with Gaussians and a window whose last slot is the current frame."""
    cams = tsyn.make_cameras(n_frames=3, width=32, height=24)
    cfg, eng, model, pipe = _pipeline(tmp_path, cams)
    model.pool.n_alive = 5
    pipe.localframe_cam_window = cams[1:]
    pipe.keyframe_cam_list = cams[:2]
    pipe.curr_cam = cams[2]
    if gate == "disable_megastep":
        pipe.disable_megastep = True
    elif gate == "exposure":
        model.statics = model.statics._replace(use_exposure=True)
    elif gate == "depth_weight":
        pipe.pipe = dataclasses.replace(pipe.pipe, depth_weight=0.1)
    elif gate == "debug_artifacts":
        pipe.pipe = dataclasses.replace(pipe.pipe, log_slam_state=True)
    elif gate == "swap":
        eng.swap = object()
    elif gate == "space_shards":
        eng.space_shards = 2
    elif gate == "empty_model":
        model.pool.n_alive = 0
    elif gate == "not_last_slot":
        pipe.curr_cam = cams[1]
    elif gate == "intrinsics":
        cams[0].fx *= 1.01
    elif gate == "image_size":
        cams[1].width = 48
    assert pipe._can_megastep(model) == (gate == "none")
    if gate == "debug_artifacts":   # debug images are off while profiling
        pipe.log_pipeline_time = True
        assert pipe._can_megastep(model)


@pytest.mark.parametrize("log_time", [True, False], ids=["log_pipeline_time", "default"])
def test_log_pipeline_time_keeps_the_per_phase_path(tmp_path, log_time):
    """(e) With PIPE.log_pipeline_time every window takes the per-phase
    path (its raycast column fills); without it every window past the
    bootstrap one takes the megastep."""
    cams = tsyn.make_cameras(n_frames=9, width=48, height=32)
    d = _config(tmp_path, cams, local_opt_interval=4, local_opt_iters=3)
    if log_time:
        d["PIPE"]["log_pipeline_time"] = True
    cfg = TConfig.from_dict(d)
    eng = TsdfEngine(cfg, 48, 32, cams[0].K, device="cpu")
    eng.set_gt_poses([c.c2w for c in cams])
    eng.turn_off_tracking()
    model = tmodel.GaussianModel(cfg, 48, 32, device="cpu")
    pipe = SLAMPipeline(cfg, eng, cfg.workspace_dir, is_train=False)
    assert pipe.log_pipeline_time == log_time
    calls = []
    orig = pipe._run_window_megastep
    pipe._run_window_megastep = lambda m: (calls.append(1), orig(m))[1]
    pipe.slam_train_cams(model, cams)
    assert len(calls) == (0 if log_time else 1) and pipe._megastep_ran != log_time
    assert pipe.curr_iter == 6 and model.num_gaussians > 0
