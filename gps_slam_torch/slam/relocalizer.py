"""Fern-based appearance relocaliser and the tracking-failure policy — the
port of gps_slam_tpu/slam/relocalizer.py.

Each fern is a handful of random (pixel, threshold) comparisons on a
downsampled depth image; a frame's binary code concatenates all ferns;
keyframes are harvested when their code is far enough from every stored
one, and relocalisation returns the stored pose whose code is nearest in
Hamming distance.  The JAX package downsamples with OpenCV's
nearest-neighbour resize; here the same source pixels are picked by index
arithmetic (`nearest_source`), so no OpenCV is needed, and only the fern
pixels are read off the device.
"""

from __future__ import annotations

import numpy as np
import torch


class FailurePolicy:
    """behaviourOnFailure: default IGNORE."""

    IGNORE = "ignore"
    STOP_INTEGRATION = "stop_integration"
    RELOCALISE = "relocalise"


def nearest_source(n_src: int, n_dst: int) -> np.ndarray:
    """Source index of each of `n_dst` samples of an axis of `n_src`
    pixels, as OpenCV's INTER_NEAREST resize picks it: floor(x / scale)
    with scale = n_dst / n_src in double precision (its reciprocal taken
    as a separate step), clipped to the last pixel."""
    ifx = 1.0 / (n_dst / n_src)
    return np.minimum(np.floor(np.arange(n_dst) * ifx).astype(np.int64), n_src - 1)


class FernRelocalizer:
    def __init__(self, width: int = 40, height: int = 30, n_ferns: int = 500,
                 n_decisions: int = 4, harvest_threshold: float = 0.2,
                 depth_range: tuple = (0.3, 4.0), seed: int = 0):
        rng = np.random.default_rng(seed)
        self.w, self.h = width, height
        self.n_ferns, self.n_dec = n_ferns, n_decisions
        self.harvest_threshold = harvest_threshold
        n = n_ferns * n_decisions
        self.px = rng.integers(0, width, n)
        self.py = rng.integers(0, height, n)
        self.thresh = rng.uniform(depth_range[0], depth_range[1], n).astype(np.float32)
        self.codes: list[np.ndarray] = []
        self.poses: list[np.ndarray] = []

    def compute_code(self, depth) -> np.ndarray:
        """Nearest-neighbour downsample + binary comparisons -> bool code
        [n_ferns * n_dec].  `depth` [H, W] (or [H, W, 1]): numpy or a
        tensor on any device."""
        d = torch.as_tensor(depth, dtype=torch.float32)
        if d.ndim == 3:
            d = d[..., 0]
        H, W = d.shape
        ys = nearest_source(H, self.h)[self.py]
        xs = nearest_source(W, self.w)[self.px]
        vals = d[torch.as_tensor(ys, device=d.device), torch.as_tensor(xs, device=d.device)]
        return vals.cpu().numpy() > self.thresh

    def dissimilarity(self, code: np.ndarray) -> float:
        """Min normalised Hamming distance to the database (1.0 = empty)."""
        if not self.codes:
            return 1.0
        db = np.stack(self.codes)
        return float((db != code[None]).mean(axis=1).min())

    def process_frame(self, depth, pose: np.ndarray, tracking_good: bool) -> None:
        """Harvest a keyframe when the view is novel enough and tracking is
        trusted."""
        if not tracking_good:
            return
        code = self.compute_code(depth)
        if self.dissimilarity(code) > self.harvest_threshold:
            self.codes.append(code)
            self.poses.append(np.asarray(pose, np.float32).copy())

    def relocalize(self, depth) -> np.ndarray | None:
        """Best-matching stored pose, or None when the database is empty."""
        if not self.codes:
            return None
        code = self.compute_code(depth)
        db = np.stack(self.codes)
        idx = int((db != code[None]).mean(axis=1).argmin())
        return self.poses[idx]

    @property
    def num_keyframes(self) -> int:
        return len(self.codes)
