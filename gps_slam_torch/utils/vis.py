"""Visualization helpers — jet colormaps and side-by-side comparison images
(reference src/cv_utils.cpp: tensorToImage/tensorToDepth/tensorToJetMat,
colorCompImg :164-186, depthCompImg :188-207)."""

from __future__ import annotations

import numpy as np


def to_u8_rgb(img: np.ndarray) -> np.ndarray:
    """float [H,W,3] in [0,1] -> uint8."""
    return np.clip(np.asarray(img) * 255.0 + 0.5, 0, 255).astype(np.uint8)


def _jet_lut() -> np.ndarray:
    """OpenCV's COLORMAP_JET table as RGB [256, 3] uint8, written as its
    linear pieces so that no OpenCV is needed (the card machine has none);
    equal to cv2.applyColorMap's table entry for entry
    (tests/test_torch_viewer.py).  OpenCV's rounding puts blue at 1, not
    2, in entry 159."""
    i = np.arange(256)
    r = np.minimum(4 * i - 382, 4 * (287 - i))
    g = np.minimum(4 * i - 128, 4 * (223 - i))
    b = np.minimum(4 * i + 128, 4 * (160 - i) - 2)
    b[159] = 1
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


_JET = _jet_lut()


def jet(values: np.ndarray, vmin: float, vmax: float,
        zero_black: bool = False) -> np.ndarray:
    """Jet colormap -> uint8 RGB (tensorToJetMat)."""
    v = np.asarray(values, dtype=np.float32)
    if v.ndim == 3:
        v = v[..., 0]
    norm = np.clip((v - vmin) / max(vmax - vmin, 1e-9), 0.0, 1.0)
    rgb = _JET[(norm * 255).astype(np.uint8)]
    if zero_black:
        rgb[v <= 0] = 0
    return rgb


def color_comp_img(rendered: np.ndarray, gt: np.ndarray,
                   err_min: float = 0.0, err_max: float = 0.1) -> np.ndarray:
    """[render | gt | jet(|err|)] side-by-side, uint8 RGB (colorCompImg)."""
    r8, g8 = to_u8_rgb(rendered), to_u8_rgb(gt)
    err = np.abs(np.asarray(rendered) - np.asarray(gt)).mean(-1)
    e8 = jet(err, err_min, err_max)
    return np.concatenate([r8, g8, e8], axis=1)


def depth_comp_img(rendered: np.ndarray, gt: np.ndarray, vis_min: float,
                   vis_max: float, err_min: float, err_max: float) -> np.ndarray:
    """[jet(render) | jet(gt) | jet(|err|)] (depthCompImg)."""
    r = np.asarray(rendered)
    g = np.asarray(gt)
    if r.ndim == 3:
        r = r[..., 0]
    if g.ndim == 3:
        g = g[..., 0]
    err = np.abs(r - g)
    return np.concatenate(
        [jet(r, vis_min, vis_max, True), jet(g, vis_min, vis_max, True),
         jet(err, err_min, err_max)], axis=1
    )


def imwrite_rgb(path: str, rgb_u8: np.ndarray) -> None:
    import os

    import cv2

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    cv2.imwrite(path, cv2.cvtColor(rgb_u8, cv2.COLOR_RGB2BGR))


def depth_to_png16(depth: np.ndarray, scale: float = 5000.0) -> np.ndarray:
    d = np.asarray(depth)
    if d.ndim == 3:
        d = d[..., 0]
    return np.clip(d * scale, 0, 65535).astype(np.uint16)
