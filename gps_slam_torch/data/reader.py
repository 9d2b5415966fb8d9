"""Dataset reader for the reference's custom on-disk format.

Format (reference src/dataset_reader.cpp:269-370 DatasetReader::read):
  <input_dir>/<image_path>/frameNNNNNN.jpg   — RGB
  <input_dir>/<pose_path>/poseNNNNNN.txt     — 4x4 c2w pose
  <input_dir>/<depth_path>/depthNNNNNN.png   — uint16 depth / depth_scale
  <input_dir>/<pcd_name>                     — optional init point-cloud PLY

Behaviors mirrored:
  * all poses rebased to frame 0 (c2w := inv(c2w_0) @ c2w,
    dataset_reader.cpp:331-338);
  * train/val split by test_split_interval (every k-th frame is val;
    interval < 0 -> train == val == all frames, :346-361);
  * scene center/scale estimated from the camera orbit
    (updateSceneGeo, :371-403);
  * downscale_factor rescales images + intrinsics (:92-104);
  * pose export for the ATE script (savePose, :405-418).
"""

from __future__ import annotations

import os

import numpy as np

from ..config import ReaderConfig
from ..utils import io as uio
from ..utils.camera import Camera


def _imread_rgb(path: str) -> np.ndarray:
    import cv2

    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(path)
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB).astype(np.float32) / 255.0


def disparity_to_depth(raw: np.ndarray, c1: float, c2: float,
                       fx: float) -> np.ndarray:
    """Kinect-style disparity -> metric depth:
    depth = 8 * c2 * fx / (c1 - raw), non-positive denominators invalid.

    Capability parity with InfiniTAM's ITMViewBuilder ConvertDisparityToDepth
    (Engines/ViewBuilding/Shared/ITMViewBuilder_Shared.h, calib params
    (c1, c2) from ITMDisparityCalib); the affine short->metric path
    (1/depth_scale) stays the default like the reference's
    AFFINE calibration type."""
    den = c1 - raw.astype(np.float32)
    d = np.where(den > 1e-6, (8.0 * c2 * fx) / np.maximum(den, 1e-6), 0.0)
    return np.where(d > 0, d, 0.0).astype(np.float32)


def _imread_depth(path: str, depth_scale: float, depth_mode: str = "affine",
                  disparity_calib=(0.0, 0.0), fx: float = 1.0) -> np.ndarray:
    import cv2

    d = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if d is None:
        raise FileNotFoundError(path)
    if depth_mode == "kinect_disparity":
        c1, c2 = disparity_calib
        return disparity_to_depth(d, c1, c2, fx)[..., None]
    return (d.astype(np.float32) / depth_scale)[..., None]


class RandomSelector:
    """Shuffled draws without replacement: walk a permutation of the items
    drawn from `rng` (a numpy Generator), draw a new one when it is used
    up.  The same generator state gives the JAX package's sequence."""

    def __init__(self, items, rng: np.random.Generator | None = None):
        self.items = list(items)
        self.rng = rng or np.random.default_rng(0)
        self._order: list[int] = []

    def get_next(self):
        """(item, its index)."""
        if not self._order:
            self._order = list(self.rng.permutation(len(self.items)))
        idx = int(self._order.pop(0))
        return self.items[idx], idx


class DatasetReader:
    def __init__(self, cfg: ReaderConfig):
        self.cfg = cfg
        fx, fy, cx, cy = cfg.intrinsics
        self.fx, self.fy, self.cx, self.cy = fx, fy, cx, cy
        self.width, self.height = cfg.image_shape
        self.downscale_factor = cfg.downscale_factor
        self.scene_scale = 1.1 * cfg.scene_scale
        self.scene_center = np.zeros(3, dtype=np.float32)
        self.train_vec: list[Camera] = []
        self.val_vec: list[Camera] = []
        self.scene_points: tuple[np.ndarray, np.ndarray] | None = None
        self.has_depth = os.path.isdir(os.path.join(cfg.input_dir, cfg.depth_path))
        pcd_path = os.path.join(cfg.input_dir, cfg.pcd_name)
        if os.path.exists(pcd_path):
            self.scene_points = uio.read_ply_points(pcd_path)

    # -- loading ------------------------------------------------------------

    def read(self) -> None:
        cfg = self.cfg
        image_dir = os.path.join(cfg.input_dir, cfg.image_path)
        pose_dir = os.path.join(cfg.input_dir, cfg.pose_path)
        depth_dir = os.path.join(cfg.input_dir, cfg.depth_path)

        end_frame = cfg.end_frame
        if end_frame <= 0:
            end_frame = sum(1 for p in os.listdir(image_dir) if p.endswith(".jpg"))

        read_count = 0
        init_c2w_inv = None
        for frame_id in range(cfg.start_frame, end_frame + 1, cfg.frame_step):
            fid = uio.id_to_filename(frame_id)
            pose_file = os.path.join(pose_dir, f"pose{fid}.txt")
            img_file = os.path.join(image_dir, f"frame{fid}.jpg")
            depth_file = os.path.join(depth_dir, f"depth{fid}.png")
            for p, needed in ((pose_file, True), (img_file, True), (depth_file, self.has_depth)):
                if needed and not os.path.exists(p):
                    raise FileNotFoundError(p)

            c2w = uio.read_pose_txt(pose_file)
            if read_count == 0:
                R, t = c2w[:3, :3], c2w[:3, 3]
                inv = np.eye(4, dtype=np.float32)
                inv[:3, :3] = R.T
                inv[:3, 3] = -R.T @ t
                init_c2w_inv = inv
            ref_c2w = (init_c2w_inv @ c2w).astype(np.float32)

            cam = Camera(
                self.width, self.height, self.fx, self.fy, self.cx, self.cy,
                self.has_depth, ref_c2w, img_file, depth_file, cam_id=read_count,
            )
            cam.image = _imread_rgb(img_file)
            if self.downscale_factor > 1.0:
                import cv2

                s = 1.0 / self.downscale_factor
                cam.image = cv2.resize(cam.image, None, fx=s, fy=s, interpolation=cv2.INTER_AREA)
                cam = self._rescale_cam(cam)
            if self.has_depth:
                cam.depth = _imread_depth(
                    depth_file, cfg.depth_scale, cfg.depth_mode,
                    cfg.disparity_calib, self.fx,
                )
                if self.downscale_factor > 1.0:
                    import cv2

                    s = 1.0 / self.downscale_factor
                    cam.depth = cv2.resize(
                        cam.depth[..., 0], None, fx=s, fy=s, interpolation=cv2.INTER_AREA
                    )[..., None]

            if cfg.test_split_interval < 0:
                self.train_vec.append(cam)
                self.val_vec.append(cam)
            elif read_count % cfg.test_split_interval == 0:
                self.val_vec.append(cam)
            else:
                self.train_vec.append(cam)
            read_count += 1

    def _rescale_cam(self, cam: Camera) -> Camera:
        s = 1.0 / self.downscale_factor
        new = cam.scaled(self.downscale_factor)
        new.image = cam.image
        new.depth = cam.depth
        new.height = cam.image.shape[0]
        new.width = cam.image.shape[1]
        return new

    def get_all_cams(self) -> list[Camera]:
        all_cams = list(self.train_vec)
        if self.cfg.test_split_interval > 0:
            all_cams.extend(self.val_vec)
        return all_cams

    # -- scene geometry -----------------------------------------------------

    def update_scene_geo(self) -> None:
        """Scene center = mean camera location; scale = 1.1 x max distance
        from it (reference src/dataset_reader.cpp:371-403)."""
        if len(self.train_vec) == 1:
            self.scene_scale = 1.0
            self.scene_center = np.zeros(3, dtype=np.float32)
            return
        all_cams = self.get_all_cams()
        locs = np.stack([c.c2w[:3, 3] for c in all_cams])
        # NOTE: the reference divides the *sum over all cams* by
        # len(train_vec) (dataset_reader.cpp:389); with the default
        # test_split_interval=-1 the two sets coincide, so use the plain mean.
        self.scene_center = locs.mean(axis=0)
        self.scene_scale = 1.1 * float(
            np.linalg.norm(locs - self.scene_center, axis=1).max()
        )

    # -- export -------------------------------------------------------------

    def save_pose(self, save_dir: str) -> None:
        os.makedirs(save_dir, exist_ok=True)
        for cam in self.train_vec:
            uio.save_pose_txt(
                cam.c2w_slam, os.path.join(save_dir, f"frame{cam.get_frame_id()}.txt")
            )
