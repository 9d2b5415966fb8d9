"""Eval metrics — the port's own copy of gps_slam_tpu/eval/metrics.py:
PSNR/SSIM of the eval render (SSIM = 11x11 Gaussian
window, same constants as the reference's utils/image_utils + fused SSIM),
LPIPS(vgg) from a local weight file (`eval/lpips_torch.py`), an unweighted
VGG feature distance under its own name,
the trajectory error of tracked runs (Horn alignment, ATE) and the
geometry metrics of an exported mesh (surface sampling, accuracy,
completion, F1).
"""

from __future__ import annotations

import numpy as np


# ----------------------------------------------------------------- image

def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return -10.0 * np.log10(max(mse, 1e-12))


def _gauss_win(size=11, sigma=1.5):
    x = np.arange(size) - (size - 1) / 2
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    return g / g.sum()


def ssim(a: np.ndarray, b: np.ndarray, c1=0.01 ** 2, c2=0.03 ** 2) -> float:
    """Mean SSIM over an 11x11 Gaussian window, channels averaged."""
    from scipy.ndimage import convolve1d

    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.ndim == 2:
        a, b = a[..., None], b[..., None]
    w = _gauss_win()

    def blur(x):
        y = convolve1d(x, w, axis=0, mode="reflect")
        return convolve1d(y, w, axis=1, mode="reflect")

    mu1, mu2 = blur(a), blur(b)
    s1 = blur(a * a) - mu1 ** 2
    s2 = blur(b * b) - mu2 ** 2
    s12 = blur(a * b) - mu1 * mu2
    m = ((2 * mu1 * mu2 + c1) * (2 * s12 + c2)) / (
        (mu1 ** 2 + mu2 ** 2 + c1) * (s1 + s2 + c2)
    )
    return float(m.mean())


def lpips(a, b, device=None):
    """TRUE LPIPS(vgg) — learned linear weights over VGG features, the
    exact metric the reference vendors (scripts/lpipsPyTorch/modules/
    lpips.py) — of two [H, W, 3] images in [0, 1], on the card unless
    `device` says otherwise.  The weights come from a local file
    ($LPIPS_WEIGHTS / ~/.cache/gps_slam_tpu/lpips_vgg.npz, see
    eval/lpips_torch.py); without one this returns None after one warning,
    and callers serialize that as JSON null: no stand-in metric is reported
    under the LPIPS name.  (The JAX package first tries the `lpips`
    package, which fetches its weights; the port never does.)"""
    from . import lpips_torch

    net = lpips_torch.get(device=device)
    return None if net is None else float(net(a, b))


_VGG: dict = {}  # (weight file, device) -> VGG16 feature stack, or None


def _vgg16_features(device):
    """torchvision's VGG16 feature stack with its ImageNet weights from the
    local torch hub cache, on `device`, loaded once per file and device;
    None without torchvision or the cached file (nothing is downloaded)."""
    import os

    import torch

    path = os.path.join(torch.hub.get_dir(), "checkpoints", "vgg16-397923af.pth")
    key = (path, str(device))
    if key not in _VGG:
        try:
            import torchvision
        except ImportError:
            torchvision = None
        net = None
        if torchvision is not None and os.path.exists(path):
            sd = torch.load(path, map_location="cpu", weights_only=True)
            net = torchvision.models.vgg16().features.eval()
            net.load_state_dict({k[len("features."):]: v for k, v in sd.items()
                                 if k.startswith("features.")})
            net = net.to(device)
        _VGG[key] = net
    return _VGG[key]


def vgg_perceptual(a, b, device=None):
    """Unweighted normalized-VGG-feature distance (LPIPS architecture
    minus the learned linear layer) of two [H, W, 3] images in [0, 1], on
    the card unless `device` says otherwise, reported under its own name,
    never as LPIPS.  Needs torchvision and its ImageNet VGG16 weights
    already in the local torch hub cache (nothing is downloaded); returns
    None without them."""
    import torch

    from .. import resolve_device

    dev = resolve_device(device)
    net = _vgg16_features(dev)
    if net is None:
        return None
    ta, tb = (torch.as_tensor(np.asarray(x, np.float32), device=dev).permute(2, 0, 1)[None]
              for x in (a, b))
    with torch.no_grad():
        mean = torch.tensor([0.485, 0.456, 0.406], device=dev).view(1, 3, 1, 1)
        std = torch.tensor([0.229, 0.224, 0.225], device=dev).view(1, 3, 1, 1)
        xa, xb = (ta - mean) / std, (tb - mean) / std
        dist = 0.0
        layers = {3, 8, 15, 22, 29}
        for i, layer in enumerate(net):
            xa, xb = layer(xa), layer(xb)
            if i in layers:
                na = xa / (xa.norm(dim=1, keepdim=True) + 1e-10)
                nb = xb / (xb.norm(dim=1, keepdim=True) + 1e-10)
                dist = dist + ((na - nb) ** 2).sum(1).mean()
        return float(dist / len(layers))


# ------------------------------------------------------------ trajectory

def horn_align(model: np.ndarray, data: np.ndarray):
    """Closed-form similarity-free rigid alignment (ate_general.py:29-53).
    model/data: [3, N].  Returns (rot, trans, per-pose translation error)."""
    mc = model - model.mean(1, keepdims=True)
    dc = data - data.mean(1, keepdims=True)
    W = mc @ dc.T
    U, _, Vh = np.linalg.svd(W.T)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vh) < 0:
        S[2, 2] = -1
    rot = U @ S @ Vh
    trans = data.mean(1, keepdims=True) - rot @ model.mean(1, keepdims=True)
    aligned = rot @ model + trans
    err = np.sqrt(((aligned - data) ** 2).sum(0))
    return rot, trans, err


def ate_rmse_cm(est_poses: list[np.ndarray], gt_poses: list[np.ndarray]) -> float:
    """Mean translation error after alignment, in cm (the reference labels
    this 'ATE RMSE', ate_general.py:60-64 — we keep its exact definition)."""
    est = np.stack([p[:3, 3] for p in est_poses]).T
    gt = np.stack([p[:3, 3] for p in gt_poses]).T
    _, _, err = horn_align(gt, est)
    return float(err.mean() * 100.0)


# -------------------------------------------------------------- geometry

def sample_mesh_surface(vertices: np.ndarray, faces: np.ndarray, n: int,
                        rng=None) -> np.ndarray:
    """Uniform area-weighted surface sampling (trimesh.sample equivalent)."""
    rng = rng or np.random.default_rng(0)
    v0, v1, v2 = (vertices[faces[:, k]] for k in range(3))
    areas = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=1)
    total = areas.sum()
    if total <= 0:
        return vertices[rng.integers(0, len(vertices), n)]
    probs = areas / total
    tri = rng.choice(len(faces), size=n, p=probs)
    r1 = np.sqrt(rng.uniform(size=(n, 1)))
    r2 = rng.uniform(size=(n, 1))
    return (1 - r1) * v0[tri] + r1 * (1 - r2) * v1[tri] + r1 * r2 * v2[tri]


def geometry_metrics(rec_points: np.ndarray, gt_points: np.ndarray,
                     dist_thres=(0.03,)) -> dict:
    """accuracy/completion (cm) + ratio/F1 at thresholds
    (geo_general.py:20-91)."""
    from scipy.spatial import cKDTree

    rec_tree = cKDTree(rec_points)
    gt_tree = cKDTree(gt_points)
    d_rec_to_gt, _ = gt_tree.query(rec_points)   # accuracy direction
    d_gt_to_rec, _ = rec_tree.query(gt_points)   # completion direction
    results = {
        "accuracy": float(d_rec_to_gt.mean() * 100.0),
        "completion": float(d_gt_to_rec.mean() * 100.0),
    }
    for t in dist_thres:
        P = float((d_rec_to_gt < t).mean() * 100.0)
        R = float((d_gt_to_rec < t).mean() * 100.0)
        F1 = 2 * P * R / max(P + R, 1e-9)
        results[f"accuracy ratio (< {t})"] = P
        results[f"completion ratio (< {t})"] = R
        results[f"F1 (< {t})"] = F1
    return results
