"""The TSDF mesh export of the port against the JAX package: meshing
(numpy and native routes, marching tetrahedra and marching cubes), the
mesh PLY writer and reader, and the geometry and trajectory metrics.

One scene is fused by the JAX engine and handed to both packages through
scene.npz, so both mesh the same voxels."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gps_slam_tpu.config import Config as JConfig
from gps_slam_tpu.data import synthetic
from gps_slam_tpu.eval import metrics as jmetrics
from gps_slam_tpu.tsdf import meshing as jmesh
from gps_slam_tpu.tsdf.engine import TsdfEngine as JEngine
from gps_slam_tpu.utils import io as jio
from gps_slam_torch.config import Config as TConfig
from gps_slam_torch.eval import metrics as tmetrics
from gps_slam_torch.tsdf import meshing as tmesh
from gps_slam_torch.tsdf import native as tnative
from gps_slam_torch.tsdf.engine import TsdfEngine as TEngine
from gps_slam_torch.utils import io as tio

W, H, N = 96, 72, 4
# the comparison of tests/test_native.py: sorted triangles within 1e-5 m,
# sorted colours within 2e-2
TRI_ATOL, COL_ATOL = 1e-5, 2e-2


def _config(tmp, mesh_algo="mt"):
    cams = synthetic.make_cameras(n_frames=N, width=W, height=H)
    node = {"input_dir": "mem", "image_path": "c", "pose_path": "c", "depth_path": "d",
            "pcd_name": "n", "depth_scale": 6553.5, "scene_scale": 1.0,
            "start_frame": 0, "end_frame": N - 1, "frame_step": 1,
            "intrinsics": [cams[0].fx, cams[0].fy, cams[0].cx, cams[0].cy],
            "image_shape": [W, H], "downscale_factor": 1, "test_split_interval": -1}
    d = synthetic.default_config_dict(str(tmp), node)
    d["TPU"]["mesh_algo"] = mesh_algo
    return cams, d


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """(JAX engine, port engine) holding one scene, fused by the JAX engine
    and loaded into the port from its scene.npz."""
    tmp = tmp_path_factory.mktemp("mesh")
    cams, d = _config(tmp)
    je = JEngine(JConfig.from_dict(d), W, H, cams[0].K)
    je.set_gt_poses([c.c2w for c in cams])
    je.turn_off_tracking()
    for c in cams:
        je.process_frame(jnp.asarray(c.image), jnp.asarray(c.depth))
    je.save_scene(str(tmp / "scene"))
    te = TEngine(TConfig.from_dict(d), W, H, cams[0].K, device="cpu")
    te.load_scene(str(tmp / "scene"))
    return je, te, d, tmp


def _same_triangles(va, ca, vb, cb):
    assert va.shape == vb.shape and va.shape[0] > 0, (va.shape, vb.shape)
    np.testing.assert_allclose(np.sort(va.reshape(-1, 9), axis=0),
                               np.sort(vb.reshape(-1, 9), axis=0), atol=TRI_ATOL)
    np.testing.assert_allclose(np.sort(ca.reshape(-1, 9), axis=0),
                               np.sort(cb.reshape(-1, 9), axis=0), atol=COL_ATOL)


@pytest.mark.parametrize("algo", ["mt", "mc"])
def test_numpy_mesh_matches_jax(scene, algo):
    """The port's numpy route gives the JAX package's numpy triangle set."""
    je, te, _, _ = scene
    vj, cj = jmesh.extract_mesh(je.vol, use_native=False, algo=algo)
    vt, ct = tmesh.extract_mesh(te.vol, use_native=False, algo=algo)
    _same_triangles(vt, ct, vj, cj)


@pytest.mark.parametrize("algo", ["mt", "mc"])
def test_native_mesh_matches_numpy(scene, algo):
    """The port's native mesher (built from native/mesher.cpp) equals its
    numpy route."""
    _, te, _, _ = scene
    vn, cn = tmesh.extract_mesh(te.vol, use_native=True, algo=algo)
    vp, cp = tmesh.extract_mesh(te.vol, use_native=False, algo=algo)
    _same_triangles(vn, cn, vp, cp)


def test_native_builds_under_build_not_in_place(scene):
    """The port builds the mesher into build/ (named by the source and flag
    hash) and leaves the tracked native/libmesher.so as it was."""
    _, te, _, _ = scene
    so = tnative.ROOT / "native" / "libmesher.so"
    before = (so.read_bytes(), os.stat(so).st_mtime_ns)
    tmesh.extract_mesh(te.vol, use_native=True)
    lib = tnative.loaded_path()
    assert lib in [tnative.lib_path(f) for f in tnative.VARIANTS]
    assert lib.exists() and lib.parent == tnative.ROOT / "build"
    assert lib.name.startswith("libmesher_") and lib.suffix == ".so"
    assert (so.read_bytes(), os.stat(so).st_mtime_ns) == before


def test_mesher_builds_serially_without_openmp(scene, tmp_path, monkeypatch):
    """A compiler that cannot build the OpenMP variant (here: a flag it
    refuses in its place) gets the serial build, which meshes as the numpy
    route does; a compiler that builds neither variant raises with its
    output."""
    _, te, _, _ = scene
    monkeypatch.setattr(tnative, "BUILD", tmp_path)
    monkeypatch.setattr(tnative, "_LIB", None)
    monkeypatch.setattr(tnative, "_LIB_PATH", None)
    bad = tnative.GXX_FLAGS + ("-fno-such-option",)
    monkeypatch.setattr(tnative, "VARIANTS", (bad, tnative.GXX_FLAGS))
    vn, cn = tmesh.extract_mesh(te.vol, use_native=True)
    assert tnative.loaded_path() == tnative.lib_path(tnative.GXX_FLAGS)
    vp, cp = tmesh.extract_mesh(te.vol, use_native=False)
    _same_triangles(vn, cn, vp, cp)
    monkeypatch.setattr(tnative, "_LIB", None)
    monkeypatch.setattr(tnative, "VARIANTS", (bad,))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed to build mesher.cpp"):
        tnative.load()


def test_engine_save_mesh_matches_jax(scene):
    """TsdfEngine.save_mesh of both packages (native route, TPU.mesh_algo
    "mt") writes the same triangle set."""
    je, te, _, tmp = scene
    je.save_mesh(str(tmp / "j.ply"))
    te.save_mesh(str(tmp / "t.ply"))
    vj, cj, fj = jio.read_mesh_ply(str(tmp / "j.ply"))
    vt, ct, ft = tio.read_mesh_ply(str(tmp / "t.ply"))
    _same_triangles(vt, ct, vj, cj)
    np.testing.assert_array_equal(ft, fj)


@pytest.mark.parametrize("with_color,with_faces", [(True, False), (False, False), (True, True)])
def test_mesh_ply_bytes_match_jax(tmp_path, with_color, with_faces):
    """save_mesh_ply writes the JAX writer's bytes; read_mesh_ply reads
    them back (colours to 1/255)."""
    rng = np.random.default_rng(0)
    v = rng.normal(size=(30, 3)).astype(np.float32)
    c = rng.uniform(size=(30, 3)).astype(np.float32) if with_color else None
    f = rng.integers(0, 30, (7, 3)).astype(np.int32) if with_faces else None
    jio.save_mesh_ply(str(tmp_path / "j.ply"), v, c, f)
    tio.save_mesh_ply(str(tmp_path / "t.ply"), v, c, f)
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    vr, cr, fr = tio.read_mesh_ply(str(tmp_path / "t.ply"))
    np.testing.assert_array_equal(vr, v)
    np.testing.assert_array_equal(fr, f if with_faces else np.arange(30).reshape(-1, 3))
    if with_color:
        np.testing.assert_allclose(cr, np.clip(c * 255.0, 0, 255).astype(np.uint8) / 255.0,
                                   atol=1e-7)
    else:
        assert cr is None


def test_geometry_metrics_match_jax(scene):
    """sample_mesh_surface (same seed) and geometry_metrics equal the JAX
    functions within 1e-6, on the scene's mesh against a jittered copy."""
    _, te, _, _ = scene
    v, _ = tmesh.extract_mesh(te.vol, use_native=False)
    faces = np.arange(v.shape[0]).reshape(-1, 3)
    pj = jmetrics.sample_mesh_surface(v, faces, 4000, np.random.default_rng(5))
    pt = tmetrics.sample_mesh_surface(v, faces, 4000, np.random.default_rng(5))
    np.testing.assert_allclose(pt, pj, atol=1e-6)
    gt = pj + np.random.default_rng(6).normal(0, 0.01, pj.shape)
    mj = jmetrics.geometry_metrics(pj, gt, (0.01, 0.02))
    mt = tmetrics.geometry_metrics(pt, gt, (0.01, 0.02))
    assert mt.keys() == mj.keys()
    for k in mj:
        assert abs(mt[k] - mj[k]) <= 1e-6, (k, mt[k], mj[k])


def test_trajectory_metrics_match_jax():
    """horn_align and ate_rmse_cm equal the JAX functions within 1e-6."""
    rng = np.random.default_rng(3)
    cams = synthetic.make_cameras(n_frames=12, width=32, height=24, look="in", arc=0.1)
    gt = [c.c2w for c in cams]
    est = []
    for p in gt:
        q = p.copy()
        q[:3, 3] += rng.normal(0, 0.01, 3).astype(np.float32)
        est.append(q)
    m = np.stack([p[:3, 3] for p in gt]).T
    d = np.stack([p[:3, 3] for p in est]).T
    for a, b in zip(tmetrics.horn_align(m, d), jmetrics.horn_align(m, d)):
        np.testing.assert_allclose(a, b, atol=1e-6)
    assert abs(tmetrics.ate_rmse_cm(est, gt) - jmetrics.ate_rmse_cm(est, gt)) <= 1e-6


def test_mesh_of_a_port_fused_volume(tmp_path):
    """A volume fused by the port itself (int32 words on the device side)
    meshes the same by both routes, and the host copy holds only the
    allocated blocks."""
    cams, d = _config(tmp_path, "mc")
    te = TEngine(TConfig.from_dict(d), W, H, cams[0].K, device="cpu")
    te.set_gt_poses([c.c2w for c in cams])
    te.turn_off_tracking()
    for c in cams:
        te.process_frame(torch.as_tensor(c.image), torch.as_tensor(c.depth))
    host = tmesh.host_volume(te.vol)
    assert host["state"].shape == (te.vol.n_blocks, 512)
    assert host["state"].dtype == np.uint32 and host["table_keys"].dtype == np.uint32
    vn, cn = tmesh.extract_mesh(te.vol, algo="mc")
    vp, cp = tmesh.extract_mesh(te.vol, use_native=False, algo="mc")
    _same_triangles(vn, cn, vp, cp)
    te.save_mesh(str(tmp_path / "m.ply"))
    v, c, f = tio.read_mesh_ply(str(tmp_path / "m.ply"))
    assert v.shape == vn.shape and f.shape == (vn.shape[0] // 3, 3)
