"""Per-attribute Adam with the reference's learning-rate schedule — the
port of gps_slam_tpu/gs/optim.py `make_optimizer` (`WindowAdam`).

One Adam per attribute (b1 0.9, b2 0.999, eps 1e-8); only the means
decay, lr_k = means_lr * gamma**k with gamma = 0.01**(1 / max_iterations),
k counted from 0 at a window's first update.  Exposure learns only with
`use_exposure`.  The window loop makes a fresh optimizer every window, as
the reference re-initialises its Adam state.

Written out rather than torch.optim.Adam because the bias corrections
1 - b**t are ill-conditioned in f32 (1 - 0.999 rounds to 1.3e-5 off):
computed in f32 like optax, the update is the JAX package's to the last
bits instead of ~1e-5 of a step away.
"""

from __future__ import annotations

import torch

B1, B2, EPS = 0.9, 0.999, 1e-8


class WindowAdam:
    """Adam over a dict of leaf tensors keyed like the pool's params."""

    def __init__(self, params: dict, cfg, max_iterations: int):
        """cfg: a ModelConfig (or anything with its learning rates and
        `use_exposure`)."""
        self.params = params
        self.lrs = {
            "means": cfg.means_lr, "scales": cfg.scales_lr, "quats": cfg.quats_lr,
            "features_dc": cfg.featuresDc_lr, "features_rest": cfg.featuresRest_lr,
            "opacities": cfg.opacities_lr,
            "exposure": cfg.exposure_lr if cfg.use_exposure else 0.0,
        }
        self.gamma = 0.01 ** (1.0 / max(max_iterations, 1))
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self) -> None:
        """One update from each param's .grad (a missing grad is zero)."""
        f32 = lambda x: torch.tensor(x, dtype=torch.float32)  # noqa: E731
        t = f32(self.count + 1)
        # device tensors, not host scalars: torch on CUDA divides by a host
        # scalar as a multiplication by its reciprocal
        dev = next(iter(self.params.values())).device
        bc1, bc2, means_lr = torch.stack([
            1.0 - f32(B1) ** t, 1.0 - f32(B2) ** t,
            f32(self.lrs["means"]) * f32(self.gamma) ** f32(self.count)]).to(dev)
        for k, p in self.params.items():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            self.mu[k] = (1.0 - B1) * g + B1 * self.mu[k]
            self.nu[k] = (1.0 - B2) * (g * g) + B2 * self.nu[k]
            upd = (self.mu[k] / bc1) / (torch.sqrt(self.nu[k] / bc2) + EPS)
            p.add_(upd * (-means_lr if k == "means" else -self.lrs[k]))
        self.count += 1

    def zero_grad(self) -> None:
        for p in self.params.values():
            p.grad = None
