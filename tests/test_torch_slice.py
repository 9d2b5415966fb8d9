"""The slice as a whole: JAX `slam_trainer.main` against the port's
`slam_trainer_torch.main` on the same on-disk synthetic dataset (gt-pose
`train` mode, two windows of PIPE.local_opt_iters = 10 Adam steps, eval
after train).

On the CPU the JAX engine normally takes its XLA branches (per-voxel
confidence, k_blocks=2 for every raycast, bf16 splat contraction), while
the port reproduces the TPU kernels.  So the JAX run here is switched onto
its kernel branch, with its four Pallas kernels (integrate, raycast march,
splat forward and backward) in interpret mode, as the JAX package's own
kernel tests run them on the CPU, and onto its eager per-phase window
(no one-dispatch megastep), which is the path the port follows.  The
spawn's random pixel choice differs (jax.random vs torch.Generator);
everything else is deterministic."""

import copy
import functools
import os

import numpy as np
import pytest
import yaml

from gps_slam_tpu.data import synthetic

# windows at frames 3 and 6; 7 frames keep the file near 100 s alone on
# one CPU worker, almost all of it the JAX side's interpret-mode kernels
N_FRAMES, W, H = 7, 96, 72
# two full epochs of the larger window's cameras (local window 2 +
# keyframes 3): the opt sets hold 4 and 5 cameras
ITERS = 10


def _jax_on_kernel_branch(mp):
    import gps_slam_tpu.gs.model as jmodel
    import gps_slam_tpu.tsdf.integrate_pallas as ipk
    import gps_slam_tpu.tsdf.raycast_pallas as rcp
    from gps_slam_tpu.slam.pipeline import SLAMPipeline
    from gps_slam_tpu.tsdf.engine import TsdfEngine

    mp.setattr(ipk, "integrate_blocks_packed",
               functools.partial(ipk.integrate_blocks_packed, interpret=True))
    ray, ray_batch = rcp.raycast, rcp.raycast_batch
    # positional `interpret` is argument 10 of raycast (raycast_batch
    # passes it through positionally)
    mp.setattr(rcp, "raycast", lambda *a, **k: ray(*a, **k) if len(a) > 10
               else ray(*a, **{**k, "interpret": True}))
    mp.setattr(rcp, "raycast_batch", lambda *a, **k: ray_batch(*a, **{**k, "interpret": True}))
    mp.setattr(TsdfEngine, "_use_pallas_raycast", lambda self: True)
    init = jmodel.GaussianModel.__init__

    def model_init(self, *a, **k):
        init(self, *a, **k)
        self.statics = self.statics._replace(splat_impl="pallas_interpret")

    mp.setattr(jmodel.GaussianModel, "__init__", model_init)
    mp.setattr(SLAMPipeline, "disable_megastep", True, raising=False)


def _record_windows(mp, model_mod, windows):
    """Record each window_optimize call: the camera id of every Adam step,
    the step losses and the epoch length (each epoch is a permutation of
    the opt set's indices)."""
    orig = model_mod.window_optimize

    def rec(pool, batch, idx, *a, **k):
        pool, aux = orig(pool, batch, idx, *a, **k)
        ids = [int(v) for v in np.asarray(batch["cam_id"])]
        idx = [int(i) for i in np.asarray(idx)]
        windows.append(([ids[i] for i in idx],
                        np.asarray(aux["loss_hist"], np.float64), max(idx) + 1))
        return pool, aux

    mp.setattr(model_mod, "window_optimize", rec)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("slice")
    node = synthetic.write_dataset(str(tmp / "scene"), n_frames=N_FRAMES, width=W, height=H)
    base = synthetic.default_config_dict(str(tmp / "scene"), node)
    base["PIPE"]["local_opt_iters"] = ITERS
    base["PIPE"]["local_opt_interval"] = 3
    base["PIPE"]["eval_after_train"] = True
    paths = {}
    for name in ("jax", "torch"):
        d = copy.deepcopy(base)
        d["workspace_dir"] = str(tmp / f"ws_{name}")
        paths[name] = (str(tmp / f"cfg_{name}.yaml"), d["workspace_dir"], d)
        with open(paths[name][0], "w") as f:
            yaml.safe_dump(d, f)
    import gps_slam_tpu.gs.model as jmodel
    import gps_slam_torch.gs.model as tmodel

    windows = {"jax": [], "torch": []}
    with pytest.MonkeyPatch.context() as mp:
        _jax_on_kernel_branch(mp)
        _record_windows(mp, jmodel, windows["jax"])
        import slam_trainer

        slam_trainer.main(paths["jax"][0])
    with pytest.MonkeyPatch.context() as mp:
        _record_windows(mp, tmodel, windows["torch"])
        import slam_trainer_torch

        slam_trainer_torch.main(paths["torch"][0], device="cpu")
    paths["windows"] = windows
    return paths


def _run_port_mode(runs, tmp_path, mode, copy_workspace):
    """Run slam_trainer_torch.main in `mode` on the slice's dataset, in a
    workspace of its own (a copy of the train workspace for eval)."""
    import shutil

    import slam_trainer_torch

    d = copy.deepcopy(runs["torch"][2])
    d["work_mode"] = mode
    d["workspace_dir"] = str(tmp_path / f"ws_{mode}")
    if copy_workspace:
        shutil.copytree(runs["torch"][1], d["workspace_dir"])
    cfg = str(tmp_path / f"cfg_{mode}.yaml")
    with open(cfg, "w") as f:
        yaml.safe_dump(d, f)
    slam_trainer_torch.main(cfg, device="cpu")
    return d["workspace_dir"], d


def _scene(ws, cfg):
    return np.load(os.path.join(ws, cfg["PIPE"]["TSDF"]["saved_engine"], "scene.npz"))


def _psnr_dir(ws):
    import cv2

    rdir, gdir = os.path.join(ws, "val", "render"), os.path.join(ws, "val", "gt")
    names = sorted(n for n in os.listdir(rdir) if n.endswith(".color.jpg"))
    out = []
    for n in names:
        r = cv2.imread(os.path.join(rdir, n)).astype(np.float32) / 255
        g = cv2.imread(os.path.join(gdir, n)).astype(np.float32) / 255
        out.append(-10 * np.log10(max(float(((r - g) ** 2).mean()), 1e-12)))
    return names, np.asarray(out)


def _gs_count(ws):
    return np.load(os.path.join(ws, "gs_model", "model.npz"))["means"].shape[0]


def test_slice_artifacts(runs):
    """The port writes the JAX CLI's artifacts in the same formats."""
    _, ws, cfg = runs["torch"]
    log = open(os.path.join(ws, "time_log.txt")).read()
    assert "[PIPELINE AVG TIME]" in log and "FPS:" in log
    for rel in ("gs_model/model.npz", "gs_model/model.pt", "gs_model/point_cloud.ply",
                "gs_model/cameras.json", "gs_model/cfg_args", "config.yaml"):
        assert os.path.exists(os.path.join(ws, rel)), rel
    assert len(os.listdir(os.path.join(ws, "pose"))) == N_FRAMES
    assert sorted(os.listdir(os.path.join(ws, "val", "render"))) == \
        sorted(os.listdir(os.path.join(runs["jax"][1], "val", "render")))


def test_slice_time_log_counts_bin_overflow(runs):
    """time_log.txt carries the window binning's real overflow count, a
    number, where the forward-only slice wrote a constant 0."""
    import re

    log = open(os.path.join(runs["torch"][1], "time_log.txt")).read()
    m = re.search(r"^Bin overflow: (\d+)$", log, re.M)
    assert m is not None, log
    assert int(m.group(1)) >= 0


def test_slice_adam_windows_visit_the_same_cameras(runs):
    """Both packages run two windows of ITERS steps, drawing the keyframe
    sample and the shuffled camera epochs from the same numpy stream, so
    every step optimizes the same camera in both."""
    wj, wt = runs["windows"]["jax"], runs["windows"]["torch"]
    assert len(wj) == len(wt) == 2
    for (cj, _, nj), (ct, _, nt) in zip(wj, wt):
        assert len(ct) == ITERS and ct == cj and nt == nj


def test_slice_adam_windows_reduce_the_loss(runs):
    """In every window of both runs the loss history is finite and the
    mean loss over the last full epoch of the window's cameras is below
    the mean over the first (consecutive steps see different cameras, so
    only whole epochs compare)."""
    for name in ("jax", "torch"):
        for _, hist, n in runs["windows"][name]:
            k = len(hist) // n
            assert k >= 2 and np.isfinite(hist).all(), (name, n)
            assert hist[(k - 1) * n:k * n].mean() < hist[:n].mean(), (name, hist)


def test_slice_block_count_equal(runs):
    """Both packages allocate exactly the same voxel blocks."""
    sj, st = _scene(runs["jax"][1], runs["jax"][2]), _scene(runs["torch"][1], runs["torch"][2])
    n = int(sj["n_blocks"])
    assert int(st["n_blocks"]) == n > 100
    assert set(sj["block_coords"][:n].tolist()) == set(st["block_coords"][:n].tolist())


def test_slice_voxels_match_by_key(runs):
    """Voxels compared by block key (pool rows follow claim order):
    weights equal on >= 99.9% of voxels (an eta on the -mu boundary can
    flip with the TPU kernel's bf16 hi+lo depth), sdf within 20 i16 quanta
    (see test_torch_tsdf's integrate test) on >= 99.9% of voxels, colour
    channels within 1 on >= 99.9%."""
    sj, st = _scene(runs["jax"][1], runs["jax"][2]), _scene(runs["torch"][1], runs["torch"][2])
    n = int(sj["n_blocks"])
    oj = np.argsort(sj["block_coords"][:n])
    ot = np.argsort(st["block_coords"][:n])
    np.testing.assert_array_equal(sj["block_coords"][:n][oj], st["block_coords"][:n][ot])
    wj, wt = sj["w_depth"][:n][oj], st["w_depth"][:n][ot]
    assert np.mean(wj == wt) >= 0.999
    assert (wt > 0).mean() > 0.1
    dsdf = np.abs(sj["sdf"][:n][oj].astype(int) - st["sdf"][:n][ot].astype(int))
    assert np.mean(dsdf <= 20) >= 0.999
    cj, ct = sj["color"][:n][oj], st["color"][:n][ot]
    for ch in range(3):
        d = np.abs(((cj >> (8 * ch)) & 0xFF).astype(int) - ((ct >> (8 * ch)) & 0xFF).astype(int))
        assert np.mean(d <= 1) >= 0.999


def test_slice_gaussian_count_close(runs):
    """The spawn takes floor(ratio x masked pixels) in both packages; the
    masks agree up to the few pixels the rendered alpha gate and the
    random pixel choice move, and the prune acts on kNN scales of
    different samples: counts within 5%."""
    gj, gt = _gs_count(runs["jax"][1]), _gs_count(runs["torch"][1])
    assert gj > 100
    assert abs(gt - gj) <= 0.05 * gj, (gj, gt)


def test_slice_eval_psnr_close(runs):
    """Eval PSNR (JPEG renders vs gt, as test_slam reads them) within
    1.5 dB of the JAX run's mean; the difference is the spawn's random
    pixel choice."""
    nj, pj = _psnr_dir(runs["jax"][1])
    nt, pt = _psnr_dir(runs["torch"][1])
    assert nj == nt and len(nj) == N_FRAMES
    assert np.isfinite(pt).all() and pt.mean() > 10.0
    assert abs(pt.mean() - pj.mean()) <= 1.5, (pj.mean(), pt.mean())


def test_port_recon_mode_fuses_the_same_scene(runs, tmp_path):
    """work_mode recon fuses the same frames without Gaussians: the same
    voxel state, block for block, as the train run, and no model."""
    ws, cfg = _run_port_mode(runs, tmp_path, "recon", copy_workspace=False)
    sr, st = _scene(ws, cfg), _scene(runs["torch"][1], runs["torch"][2])
    n = int(st["n_blocks"])
    assert int(sr["n_blocks"]) == n
    for k in ("block_coords", "sdf", "w_depth", "w_color", "color"):
        np.testing.assert_array_equal(sr[k][:n], st[k][:n], err_msg=k)
    assert not os.path.exists(os.path.join(ws, "gs_model", "model.npz"))


def test_port_eval_mode_rerenders_the_saved_workspace(runs, tmp_path):
    """work_mode eval loads the saved model.npz and scene.npz and renders
    the same eval images the train run rendered (JPEG pixels within 2 of
    255: the same deterministic render, encoded twice).  Renders are named
    by the Adam steps run so far: 0 in eval mode, 2 x ITERS after
    training."""
    import cv2

    ws, _ = _run_port_mode(runs, tmp_path, "eval", copy_workspace=True)
    rdir = os.path.join(ws, "val", "render")
    names = sorted(n for n in os.listdir(rdir) if n.endswith("_iter0.color.jpg"))
    assert len(names) == N_FRAMES
    for n in names:
        a = cv2.imread(os.path.join(rdir, n)).astype(int)
        b = cv2.imread(os.path.join(runs["torch"][1], "val", "render", n.replace(
            "_iter0.", f"_iter{2 * ITERS}."))).astype(int)
        assert np.abs(a - b).max() <= 2, n
