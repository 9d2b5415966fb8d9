"""Remote viewer server — the port of gps_slam_tpu/viewer/server.py: the
SIBR/3DGS remote-viewer TCP protocol (reference remote_viewer.cpp:12-156),
byte for byte.

Wire format (little-endian):
  request:  4-byte length + JSON {fov_x, fov_y, resolution_x,
            resolution_y, pose: 16 floats column-major}; the pose's y/z
            columns are negated (SIBR convention, :32-38).
  response: 4 images (each: u32 width, u32 height, raw RGB24) —
            render, input, raycast color, raycast depth-jet — then the
            3x3 rotation + 3x1 translation as raw f32, a length-prefixed
            info string, and the 4x4 MVP as raw f32.

A request raycasts the TSDF with its own intrinsics and size and renders
the Gaussians over that raycast.

    python -m gps_slam_torch.viewer.server cfg.yaml [--device cpu]

serves the model and scene that an earlier run saved in the config's
workspace, on the config's `port` (default 6688).
"""

from __future__ import annotations

import json
import socket
import struct

import numpy as np
import torch

from ..utils import vis
from ..utils.camera import Camera

INFO = "gps-slam-tpu viewer"  # the info string of the wire format


def read_message(conn: socket.socket) -> Camera:
    raw_len = _read_exact(conn, 4)
    (msg_len,) = struct.unpack("<i", raw_len)
    msg = json.loads(_read_exact(conn, msg_len).decode())
    fov_x, fov_y = float(msg["fov_x"]), float(msg["fov_y"])
    rx, ry = float(msg["resolution_x"]), float(msg["resolution_y"])
    fx = rx / (2.0 * np.tan(fov_x / 2.0))
    fy = ry / (2.0 * np.tan(fov_y / 2.0))
    pose = np.asarray(msg["pose"], np.float32).reshape(4, 4).T  # column-major
    pose[:, 1] *= -1
    pose[:, 2] *= -1
    return Camera(int(rx), int(ry), fx, fy, rx / 2, ry / 2, False, pose)


def _read_exact(conn: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = conn.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("client closed")
        buf += chunk
    return buf


def send_image(conn: socket.socket, rgb_u8: np.ndarray) -> None:
    h, w = rgb_u8.shape[:2]
    conn.sendall(struct.pack("<II", w, h))
    conn.sendall(np.ascontiguousarray(rgb_u8).tobytes())


def send_tensor(conn: socket.socket, arr: np.ndarray) -> None:
    conn.sendall(np.ascontiguousarray(arr, dtype="<f4").tobytes())


def send_string(conn: socket.socket, s: str) -> None:
    conn.sendall(struct.pack("<I", len(s)))
    conn.sendall(s.encode())


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def serve(pipe, model, port: int, depth_vis_max: float = 5.0,
          max_requests: int | None = None) -> None:
    """Serve render requests (reference main loop :104-150) to one client,
    until it disconnects or after `max_requests`.  `pipe` provides
    run_raycast_by_cam(cam); `model` provides forward(c2w, K, ref_depth,
    base_color)."""
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    try:
        srv.bind(("0.0.0.0", port))
        srv.listen(1)
        print(f"viewer server listening on :{port}", flush=True)
        conn, addr = srv.accept()
    except BaseException:
        srv.close()
        raise
    print("client connected!", addr, flush=True)
    served = 0
    try:
        while max_requests is None or served < max_requests:
            cam = read_message(conn)
            ray = pipe.run_raycast_by_cam(cam)
            res = model.forward(cam.c2w_slam, cam.K, ray["depth_map"][..., 0],
                                ray["color_map"])
            rendered_u8 = vis.to_u8_rgb(np.clip(_host(res["rgb"]), 0, 1))
            send_image(conn, rendered_u8)
            send_image(conn, rendered_u8)  # "input" slot (reference clones)
            send_image(conn, vis.to_u8_rgb(np.clip(_host(ray["color_map"]), 0, 1)))
            send_image(conn, vis.jet(_host(ray["depth_map"]), 0, depth_vis_max, True))
            pose = np.asarray(cam.c2w_slam, np.float32)
            send_tensor(conn, pose[:3, :3])
            send_tensor(conn, pose[:3, 3:4])
            send_string(conn, INFO)
            send_tensor(conn, pose)
            served += 1
    except (ConnectionError, BrokenPipeError):
        print("client disconnected", flush=True)
    finally:
        conn.close()
        srv.close()


def main(config_path: str, max_requests: int | None = None, device=None) -> None:
    """Viewer entry (reference remote_viewer.cpp:68-103): eval-mode setup
    (the saved model and scene of the config's workspace) + serve loop, on
    the card unless `device` says otherwise."""
    from ..config import Config
    from ..data.reader import DatasetReader
    from ..gs.model import GaussianModel
    from ..slam.pipeline import SLAMPipeline
    from ..tsdf.engine import TsdfEngine

    cfg = Config.from_yaml(config_path)
    port = int(cfg.raw.get("port", 6688))
    reader = DatasetReader(cfg.reader)
    reader.read()
    reader.update_scene_geo()
    cam0 = reader.train_vec[0]
    engine = TsdfEngine(cfg, cam0.width, cam0.height, cam0.K, device=device)
    model = GaussianModel(cfg, cam0.width, cam0.height, device=engine.device)
    pipe = SLAMPipeline(cfg, engine, cfg.workspace_dir, is_train=False)
    model.load(pipe.model_path)
    pipe.load_engine()
    serve(pipe, model, port, cfg.pipe.depth_vis_max, max_requests)


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description="gps_slam_torch remote viewer server")
    ap.add_argument("config")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain path)")
    a = ap.parse_args()
    main(a.config, device=a.device)
