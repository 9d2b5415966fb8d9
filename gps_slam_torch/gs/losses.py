"""Training losses — the port of gps_slam_tpu/gs/losses.py: L1, the SSIM
map with an 11x11 separable Gaussian window (valid padding), PSNR and
`compute_loss` (L1 + SSIM + masked depth L1).  Plain tensor ops: the JAX
package computes them outside Pallas too."""

from __future__ import annotations

import numpy as np
import torch


def l1(a: torch.Tensor, b: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
    d = (a - b).abs()
    if mask is None:
        return d.mean()
    m = torch.broadcast_to(mask, d.shape).to(d.dtype)
    return (d * m).sum() / torch.clamp(m.sum(), min=1.0)


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> list[float]:
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    return [float(v) for v in g / g.sum()]


def _blur_valid(x: torch.Tensor) -> torch.Tensor:
    """Separable 11x11 Gaussian blur, valid padding, over the trailing two
    axes of [..., H, W]: 11 shifted-slice multiply-adds per direction, in
    the JAX package's order."""
    w = _gaussian_window()

    def conv1d(v, dim):
        n = v.shape[dim] - 10
        out = w[0] * v.narrow(dim, 0, n)
        for k in range(1, 11):
            out = out + w[k] * v.narrow(dim, k, n)
        return out

    return conv1d(conv1d(x, x.ndim - 1), x.ndim - 2)


def ssim_gt_moments(img2: torch.Tensor):
    """Blur moments (mu2, s2) of a fixed comparison image [H, W, C], for
    the window loop to compute once per camera."""
    b = img2.permute(2, 0, 1)
    C = b.shape[0]
    bl = _blur_valid(torch.cat([b, b * b], 0))
    mu2 = bl[:C]
    return mu2, bl[C:] - mu2 * mu2


def ssim_map(img1: torch.Tensor, img2: torch.Tensor, c1: float = 0.01 ** 2,
             c2: float = 0.03 ** 2, gt_moments=None) -> torch.Tensor:
    """SSIM map with valid padding of [H, W, C] inputs -> [H-10, W-10, C]."""
    a = img1.permute(2, 0, 1)
    b = img2.permute(2, 0, 1)
    C = a.shape[0]
    if gt_moments is None:
        bl = _blur_valid(torch.cat([a, a * a, a * b, b, b * b], 0))
        mu2 = bl[3 * C:4 * C]
        s2 = bl[4 * C:5 * C] - mu2 * mu2
    else:
        bl = _blur_valid(torch.cat([a, a * a, a * b], 0))
        mu2, s2 = gt_moments
    mu1 = bl[:C]
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = bl[C:2 * C] - mu1_sq
    s12 = bl[2 * C:3 * C] - mu12
    out = ((2 * mu12 + c1) * (2 * s12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (s1 + s2 + c2))
    return out.permute(1, 2, 0)


def psnr(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    mse = ((a - b) ** 2).mean()
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-12))


def compute_loss(rendered_rgb, rendered_depth, gt_rgb, gt_depth,
                 ssim_weight: float, depth_weight: float, mask=None,
                 gt_ssim_moments=None) -> dict:
    """The reference's computeLoss: (1 - w_ssim) L1 + w_ssim (1 - SSIM),
    plus w_depth x the L1 of depth where both depths are positive."""
    l1_loss = l1(gt_rgb, rendered_rgb, mask)
    if ssim_weight > 0:
        ssim_loss = 1.0 - ssim_map(rendered_rgb, gt_rgb,
                                   gt_moments=gt_ssim_moments).mean()
        rgb_loss = (1.0 - ssim_weight) * l1_loss + ssim_weight * ssim_loss
    else:
        rgb_loss = l1_loss
    loss = {"total": rgb_loss, "rgb": rgb_loss, "l1": l1_loss}
    if depth_weight > 0 and gt_depth is not None:
        valid = (gt_depth > 0) & (rendered_depth > 0)
        depth_loss = l1(gt_depth, rendered_depth, valid)
        loss["depth"] = depth_loss
        loss["total"] = loss["total"] + depth_weight * depth_loss
    return loss
