"""The port's remote viewer (`viewer/server.py`) held against the JAX
package's: the jet table against OpenCV's, the response bytes of both
servers for the same fake pipeline and model outputs, and a real port
model and TSDF engine served at 64x48 on the CPU, including a request of
another size.  Each server binds a port the OS reports free (never
tests/test_aux.py's 16699: the test files run in parallel)."""

import json
import socket
import struct
import threading
import time

import numpy as np
import pytest
import torch

from gps_slam_tpu.data import synthetic
from gps_slam_tpu.utils import vis as jvis
from gps_slam_tpu.viewer import server as jserver
from gps_slam_torch.utils import vis as tvis
from gps_slam_torch.viewer import server as tserver


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _request(w: int, h: int, pose: np.ndarray) -> bytes:
    msg = json.dumps({"fov_x": 1.0, "fov_y": 0.8, "resolution_x": w,
                      "resolution_y": h,
                      "pose": pose.T.reshape(-1).tolist()}).encode()
    return struct.pack("<i", len(msg)) + msg


def _serve_and_query(serve, pipe, model, requests) -> list[bytes]:
    """Run `serve` on a free port in a thread, send each (w, h, pose)
    request and return each response's raw bytes."""
    port = _free_port()
    t = threading.Thread(target=serve, args=(pipe, model, port),
                         kwargs={"max_requests": len(requests)}, daemon=True)
    t.start()
    deadline = time.monotonic() + 30
    while True:
        try:
            sock = socket.create_connection(("127.0.0.1", port), timeout=30)
            break
        except ConnectionRefusedError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.05)
    out = []
    with sock:
        buf = sock.makefile("rb")
        for w, h, pose in requests:
            sock.sendall(_request(w, h, pose))
            resp = b""
            for _ in range(4):
                head = buf.read(8)
                iw, ih = struct.unpack("<II", head)
                assert (iw, ih) == (w, h)
                resp += head + buf.read(iw * ih * 3)
            resp += buf.read(48)
            slen = buf.read(4)
            resp += slen + buf.read(struct.unpack("<I", slen)[0]) + buf.read(64)
            out.append(resp)
    t.join(timeout=30)
    assert not t.is_alive()
    return out


def test_jet_table_matches_opencv():
    """The port's jet colormap needs no OpenCV: its table equals
    cv2.applyColorMap(COLORMAP_JET)'s entry for entry, and `vis.jet` equals
    the JAX package's (which calls OpenCV) on random depths, exactly."""
    import cv2

    i = np.arange(256, dtype=np.uint8)[None]
    ref = cv2.cvtColor(cv2.applyColorMap(i, cv2.COLORMAP_JET), cv2.COLOR_BGR2RGB)[0]
    np.testing.assert_array_equal(tvis._JET, ref)
    d = np.random.default_rng(0).uniform(-0.5, 6.0, (48, 64, 1)).astype(np.float32)
    for zero_black in (False, True):
        np.testing.assert_array_equal(tvis.jet(d, 0, 5.0, zero_black),
                                      jvis.jet(d, 0, 5.0, zero_black))


class _FakePipe:
    """Seeded raycast maps for a request's size (numpy, read by both)."""

    def run_raycast_by_cam(self, cam, *_):
        rng = np.random.default_rng(cam.width * 1000 + cam.height)
        return {"color_map": rng.uniform(-0.1, 1.1, (cam.height, cam.width, 3)).astype(np.float32),
                "depth_map": rng.uniform(-0.5, 6.0, (cam.height, cam.width, 1)).astype(np.float32)}


class _FakeModel:
    def forward(self, c2w, K, ref_depth, base_color):
        H, W = np.asarray(ref_depth).shape
        rgb = np.random.default_rng(W + H).uniform(-0.1, 1.1, (H, W, 3)).astype(np.float32)
        return {"rgb": rgb}


def test_protocol_bytes_match_jax():
    """Two requests (64x48 and 40x30, arbitrary poses) answered by the JAX
    server and by the port's from the same fake raycast and render: the
    response bytes are equal, exactly; the first decodes as
    tests/test_aux.py expects (SIBR y/z columns negated, the info
    string)."""
    pose = np.eye(4, dtype=np.float32)
    rng = np.random.default_rng(2)
    pose2 = np.eye(4, dtype=np.float32)
    pose2[:3, 3] = rng.normal(0, 1, 3)
    reqs = [(64, 48, pose), (40, 30, pose2)]
    jb = _serve_and_query(jserver.serve, _FakePipe(), _FakeModel(), reqs)
    tb = _serve_and_query(tserver.serve, _FakePipe(), _FakeModel(), reqs)
    assert jb == tb
    off = 4 * (8 + 64 * 48 * 3)
    rot = np.frombuffer(tb[0][off:off + 36], "<f4").reshape(3, 3)
    np.testing.assert_allclose(rot, np.diag([1, -1, -1]), atol=1e-6)
    (slen,) = struct.unpack("<I", tb[0][off + 48:off + 52])
    assert tb[0][off + 52:off + 52 + slen].decode() == tserver.INFO


def test_port_model_served(tmp_path):
    """A real port pipeline at 64x48 on the CPU (3 fused frames, Gaussians
    spawned from frame 0's raycast) through `serve`: each response's render
    bytes equal `vis.to_u8_rgb` of the model's own render over the
    pipeline's raycast for that request, bit for bit, for a request at the
    engine's size and one at 48x40 (raycast and render at the request's
    own intrinsics and size)."""
    from gps_slam_torch.config import Config
    from gps_slam_torch.data import synthetic as tsyn
    from gps_slam_torch.gs import model as gmodel
    from gps_slam_torch.gs.model import GaussianModel
    from gps_slam_torch.slam.pipeline import SLAMPipeline
    from gps_slam_torch.tsdf.engine import TsdfEngine

    W, H = 64, 48
    cams = synthetic.make_cameras(n_frames=3, width=W, height=H)
    c = cams[0]
    node = {"input_dir": "mem", "image_path": "c", "pose_path": "c", "depth_path": "d",
            "pcd_name": "n", "depth_scale": 6553.5, "scene_scale": 1.0,
            "start_frame": 0, "end_frame": 2, "frame_step": 1,
            "intrinsics": [c.fx, c.fy, c.cx, c.cy], "image_shape": [W, H],
            "downscale_factor": 1, "test_split_interval": -1}
    cfg = Config.from_dict(tsyn.default_config_dict(str(tmp_path), node))
    engine = TsdfEngine(cfg, W, H, c.K, device="cpu")
    engine.set_gt_poses([x.c2w for x in cams])
    engine.turn_off_tracking()
    for x in cams:
        engine.process_frame(x.image, x.depth)
    model = GaussianModel(cfg, W, H, device="cpu")
    ray = engine.run_raycast(c.c2w)
    gmodel.add_gaussians(model.pool, ray["vertex_map"], ray["color_map"],
                         ray["normal_map"], ray["depth_map"][..., 0] > 0, 0.2, 512,
                         0.5, (0.0005, 0.05), torch.Generator().manual_seed(0))
    assert model.num_gaussians > 0
    pipe = SLAMPipeline(cfg, engine, str(tmp_path), is_train=False)
    reqs = [(W, H, c.c2w), (48, 40, cams[2].c2w)]
    resp = _serve_and_query(tserver.serve, pipe, model, reqs)
    for (w, h, pose), r in zip(reqs, resp):
        cam = tserver.read_message(_Replay(_request(w, h, pose)))
        ray = pipe.run_raycast_by_cam(cam)
        rgb = model.forward(cam.c2w_slam, cam.K, ray["depth_map"][..., 0],
                            ray["color_map"])["rgb"]
        want = tvis.to_u8_rgb(np.clip(rgb.numpy(), 0, 1)).tobytes()
        assert r[8:8 + w * h * 3] == want
        assert len(set(want)) > 8  # not a blank render


class _Replay:
    """A socket stand-in that replays fixed bytes to `read_message`."""

    def __init__(self, data: bytes):
        self.data = data

    def recv(self, n: int) -> bytes:
        out, self.data = self.data[:n], self.data[n:]
        return out
