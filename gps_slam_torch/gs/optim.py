"""Per-attribute Adam with the reference's learning-rate schedule — the
port of gps_slam_tpu/gs/optim.py `make_optimizer` (`WindowAdam`).

One Adam per attribute (b1 0.9, b2 0.999, eps 1e-8); only the means
decay, lr_k = means_lr * gamma**k with gamma = 0.01**(1 / max_iterations),
k counted from 0 at a window's first update.  Exposure learns only with
`use_exposure`.  The window loop makes a fresh optimizer every window, as
the reference re-initialises its Adam state; the offline trainers keep one
across PIPE.max_iterations (`GaussianModel.init_optimizers`), where
`zero_state_rows` clears the moments of the pool rows densify touched.

On the card one step is one launch of `window_adam_cuda`
(csrc/window_adam.cu) over every attribute, bit for bit with the plain
version `WindowAdam._step_plain`.

Written out rather than torch.optim.Adam because the bias corrections
1 - b**t are ill-conditioned in f32 (1 - 0.999 rounds to 1.3e-5 off):
computed in f32 like optax, the update is the JAX package's to the last
bits instead of ~1e-5 of a step away.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import kernels

B1, B2, EPS = 0.9, 0.999, 1e-8


@functools.lru_cache(maxsize=32)
def window_schedule(means_lr: float, gamma: float, steps: int,
                    device: torch.device) -> torch.Tensor:
    """f32 [steps, 3]: (1 - b1^t, 1 - b2^t, means_lr gamma^k) of update k,
    t = k + 1, computed on the host in f32 as optax does (scalar by
    scalar: a vectorised pow rounds some rows another way), copied to
    `device` once and kept: the steps index it and copy nothing from the
    host (which a CUDA graph could not capture).  Never written."""
    f32 = np.float32
    b1, b2, lr, g = f32(B1), f32(B2), f32(means_lr), f32(gamma)
    rows = np.empty((steps, 3), np.float32)
    for k in range(steps):
        t = f32(k + 1)
        rows[k] = (f32(1.0) - b1 ** t, f32(1.0) - b2 ** t, lr * g ** f32(k))
    return torch.from_numpy(rows).to(device)


class WindowAdam:
    """Adam over a dict of leaf tensors keyed like the pool's params."""

    def __init__(self, params: dict, cfg, max_iterations: int,
                 steps: int | None = None):
        """cfg: a ModelConfig (or anything with its learning rates and
        `use_exposure`).  `steps`: the number of updates (a window's;
        `max_iterations` by default, the offline trainer's), whose
        schedule rows come from `window_schedule`."""
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
        dev = next(iter(params.values())).device
        self.table = window_schedule(float(self.lrs["means"]), self.gamma,
                                     max_iterations if steps is None else steps, dev)

    @torch.no_grad()
    def step(self) -> None:
        """One update from each param's .grad (a missing grad is zero).
        CPU tensors take `_step_plain`; CUDA tensors one launch of
        `window_adam_cuda` over every attribute, which updates the moments
        and the params in place, or raise."""
        if self.count >= self.table.shape[0]:
            raise IndexError(f"WindowAdam: update {self.count + 1} past the "
                             f"{self.table.shape[0]} steps it was made for")
        if self.table.device.type == "cuda":
            window_adam(self)
        else:
            self._step_plain()
        self.count += 1

    def _step_plain(self) -> None:
        """The plain version of `window_adam_cuda`: update `count`'s."""
        # device tensors, not host scalars: torch on CUDA divides by a host
        # scalar as a multiplication by its reciprocal
        bc1, bc2, means_lr = self.table[self.count]
        for k, p in self.params.items():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            self.mu[k] = (1.0 - B1) * g + B1 * self.mu[k]
            self.nu[k] = (1.0 - B2) * (g * g) + B2 * self.nu[k]
            upd = (self.mu[k] / bc1) / (torch.sqrt(self.nu[k] / bc2) + EPS)
            p.add_(upd * (-means_lr if k == "means" else -self.lrs[k]))

    def zero_grad(self) -> None:
        for p in self.params.values():
            p.grad = None


class _Group(ctypes.Structure):
    """csrc/window_adam.cu's `Group`: one attribute's update."""

    _fields_ = [("p", ctypes.c_void_p), ("g", ctypes.c_void_p), ("mu", ctypes.c_void_p),
                ("nu", ctypes.c_void_p), ("n", ctypes.c_longlong), ("neg_lr", ctypes.c_float),
                ("table_lr", ctypes.c_int)]


MAX_GROUPS = 8


class _Args(ctypes.Structure):
    """csrc/window_adam.cu's `Args`, passed to the kernel by value."""

    _fields_ = [("g", _Group * MAX_GROUPS), ("offset", ctypes.c_longlong * (MAX_GROUPS + 1))]


def window_adam(opt: WindowAdam) -> None:
    """Update `opt.count` of every attribute of `opt` in one launch of
    `window_adam_cuda` (see `WindowAdam.step`); raises on anything the
    kernel does not take."""
    k = kernels.WINDOW_ADAM
    if len(opt.params) > MAX_GROUPS:
        raise ValueError(f"{k.name}: {len(opt.params)} attributes, at most {MAX_GROUPS}")
    kernels.check_tensor(k, "table", opt.table, torch.float32, (opt.table.shape[0], 3))
    args = _Args()
    total = 0
    for i, (name, p) in enumerate(opt.params.items()):
        for what, t in (("param", p), ("grad", p.grad), ("mu", opt.mu[name]),
                        ("nu", opt.nu[name])):
            if t is not None:
                kernels.check_tensor(k, f"{name} {what}", t, torch.float32, p.shape)
        table_lr = name == "means"
        args.g[i] = _Group(p.data_ptr(), None if p.grad is None else p.grad.data_ptr(),
                           opt.mu[name].data_ptr(), opt.nu[name].data_ptr(), p.numel(),
                           0.0 if table_lr else -opt.lrs[name], int(table_lr))
        args.offset[i] = total
        total += p.numel()
    for i in range(len(opt.params), MAX_GROUPS + 1):
        args.offset[i] = total
    err = k.fn(ctypes.byref(args), opt.table.data_ptr(), opt.count, kernels.stream_ptr())
    if total > 0:
        k.launches += 1
    kernels.check(k, err)


@torch.no_grad()
def zero_state_rows(opt: WindowAdam, row_mask: torch.Tensor) -> WindowAdam:
    """Zero both moments of the pool rows in `row_mask` [C] for every
    attribute with one row per pool slot (exposure keeps its state); the
    step count stays.  The fixed-pool form of the reference's optimizer
    surgery when densify adds and removes Gaussians."""
    for state in (opt.mu, opt.nu):
        for k, m in state.items():
            if m.ndim >= 1 and m.shape[0] == row_mask.shape[0]:
                shape = (-1,) + (1,) * (m.ndim - 1)
                state[k] = torch.where(row_mask.reshape(shape), 0.0, m)
    return opt
