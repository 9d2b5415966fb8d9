"""LPIPS(vgg) in PyTorch — the port of gps_slam_tpu/eval/lpips_jax.py: the
learned perceptual metric the reference vendors (reference
scripts/lpipsPyTorch/modules/lpips.py, networks.py: VGG16 backbone,
unit-normalized activations at the five relu taps, learned per-channel
linear heads, spatial average, layer sum).

Weights come from a LOCAL file only, never a download: a converted
``.npz`` in the JAX package's key layout (conv weights HWIO) or a torch
checkpoint ``{"vgg": torchvision vgg16 state dict, "lin": lpips state
dict}``, found as `path`, ``$LPIPS_WEIGHTS`` or
``~/.cache/gps_slam_tpu/lpips_vgg.npz`` — the JAX package's default, so
one converted file serves both.  Without one, `get()` returns None after
one warning, and callers report the metric as unavailable.

  x -> (x*2-1 - shift) / scale          # the ScalingLayer constants
  5 VGG16 stages (3x3 convs, padding 1, + relu, 2x2 max pool between)
  taps after relu1_2, relu2_2, relu3_3, relu4_3, relu5_3
  f_hat = f / sqrt(sum_c f^2 + 1e-10)   # unit-normalize over channels
  d_l   = mean_hw( sum_c  w_lc * (fa_hat - fb_hat)^2 )
  LPIPS = sum_l d_l

The convolutions are `F.conv2d` (cuDNN on the card, TF32 off): the JAX
package computes them with `lax.conv` outside any Pallas kernel.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device

# VGG16 `features` conv plan per stage: (out_channels per conv)
_STAGES = ((64, 64), (128, 128), (256, 256, 256), (512, 512, 512),
           (512, 512, 512))
# channels at the five taps (after the last relu of each stage)
TAP_CHANNELS = (64, 128, 256, 512, 512)

# lpipsPyTorch's ScalingLayer constants (modules/networks.py)
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)

_DEFAULT_PATH = os.path.join(
    os.path.expanduser("~"), ".cache", "gps_slam_tpu", "lpips_vgg.npz")


def weight_names() -> list[str]:
    """Flat npz key list: conv{i}_w [kh,kw,cin,cout], conv{i}_b [cout]
    (i in VGG order), lin{l}_w [c_l] (per-channel head weights)."""
    names = []
    n = 0
    for stage in _STAGES:
        for _ in stage:
            names += [f"conv{n}_w", f"conv{n}_b"]
            n += 1
    names += [f"lin{l}_w" for l in range(5)]
    return names


def random_weights(rng: np.random.Generator) -> dict:
    """Structurally correct random weights in the npz layout, drawn as the
    JAX package draws them — for tests only (the metric values are
    meaningless; the math and shapes are what is tested)."""
    w = {}
    n = 0
    cin = 3
    for stage in _STAGES:
        for cout in stage:
            w[f"conv{n}_w"] = rng.normal(0, 0.1, (3, 3, cin, cout)).astype(np.float32)
            w[f"conv{n}_b"] = rng.normal(0, 0.01, (cout,)).astype(np.float32)
            cin = cout
            n += 1
    for l, c in enumerate(TAP_CHANNELS):
        w[f"lin{l}_w"] = np.abs(rng.normal(0, 0.1, (c,))).astype(np.float32)
    return w


def _from_torch_state(vgg_sd: dict, lin_sd: dict) -> dict:
    """Torch state dicts (torchvision vgg16 `features.*` + lpips
    `lin{l}.model.1.weight`) -> the flat npz layout.  Torch conv weights
    are [cout, cin, kh, kw] -> HWIO."""
    out = {}
    conv_keys = sorted(
        (k for k in vgg_sd if k.endswith(".weight") and vgg_sd[k].ndim == 4),
        key=lambda k: int(k.split(".")[-2]))
    for n, k in enumerate(conv_keys):
        wt = np.asarray(vgg_sd[k], np.float32)
        out[f"conv{n}_w"] = np.transpose(wt, (2, 3, 1, 0))
        out[f"conv{n}_b"] = np.asarray(vgg_sd[k.replace(".weight", ".bias")], np.float32)
    for l in range(5):
        for cand in (f"lin{l}.model.1.weight", f"lin.{l}.model.1.weight"):
            if cand in lin_sd:
                out[f"lin{l}_w"] = np.asarray(lin_sd[cand], np.float32).reshape(-1)
                break
        else:
            raise KeyError(f"no linear-head weight for tap {l}")
    return out


def weights_path(path: str | None = None) -> str:
    return path or os.environ.get("LPIPS_WEIGHTS") or _DEFAULT_PATH


def load_weights(path: str | None = None) -> dict | None:
    """LPIPS(vgg) weights in the npz layout from `path`, $LPIPS_WEIGHTS or
    the default cache file; None when the file is absent."""
    path = weights_path(path)
    if not os.path.exists(path):
        return None
    if path.endswith(".npz"):
        z = np.load(path)
        return {k: z[k] for k in weight_names()}
    # a torch checkpoint written by the user's own conversion; weights_only
    # keeps its unpickling to tensors and containers
    blob = torch.load(path, map_location="cpu", weights_only=True)
    to_np = lambda sd: {k: v.detach().cpu().numpy() for k, v in sd.items()}  # noqa: E731
    return _from_torch_state(to_np(blob["vgg"]), to_np(blob["lin"]))


def _forward(w: dict, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """LPIPS of image batches [N, H, W, 3] in [0, 1] -> [N]; `w` from
    `convert.lpips_weights_from_numpy`."""
    dev = a.device
    shift = torch.as_tensor(_SHIFT, device=dev).view(1, 3, 1, 1)
    scale = torch.as_tensor(_SCALE, device=dev).view(1, 3, 1, 1)

    def taps(x):
        x = (x.permute(0, 3, 1, 2) * 2.0 - 1.0 - shift) / scale
        out = []
        n = 0
        for si, stage in enumerate(_STAGES):
            for _ in stage:
                x = F.relu(F.conv2d(x, w[f"conv{n}_w"], w[f"conv{n}_b"], padding=1))
                n += 1
            out.append(x)
            if si < len(_STAGES) - 1:
                x = F.max_pool2d(x, 2, 2)
        return out

    total = 0.0
    for l, (fa, fb) in enumerate(zip(taps(a), taps(b))):
        na = fa * torch.rsqrt((fa * fa).sum(1, keepdim=True) + 1e-10)
        nb = fb * torch.rsqrt((fb * fb).sum(1, keepdim=True) + 1e-10)
        d = (((na - nb) ** 2) * w[f"lin{l}_w"].view(1, -1, 1, 1)).sum(1)   # [N, H, W]
        total = total + d.mean(dim=(1, 2))
    return total


class LpipsTorch:
    """Callable LPIPS(vgg) on `device` (None means the card)."""

    def __init__(self, weights: dict, device=None):
        from ..convert import lpips_weights_from_numpy

        self.device = resolve_device(device)
        self.weights = lpips_weights_from_numpy(weights, self.device)

    @torch.no_grad()
    def __call__(self, a, b):
        """a, b: [H, W, 3] float in [0, 1] (or [N, H, W, 3]); a float, or a
        numpy [N] for batches."""
        a, b = (torch.as_tensor(x, dtype=torch.float32, device=self.device)
                for x in (a, b))
        batched = a.ndim == 4
        if not batched:
            a, b = a[None], b[None]
        out = _forward(self.weights, a, b).cpu().numpy()
        return out if batched else float(out[0])


_NETS: dict = {}  # (weight file, device) -> LpipsTorch, or None without the file


def get(path: str | None = None, device=None) -> LpipsTorch | None:
    """The LPIPS(vgg) network of the weight file on `device`, loaded once;
    None when no weights exist, with one warning per missing file."""
    path = weights_path(path)
    key = (path, str(resolve_device(device)))
    if key not in _NETS:
        w = load_weights(path)
        if w is None and not any(k[0] == path for k in _NETS):
            print(f"[lpips_torch] WARNING: no LPIPS(vgg) weights at {path} (set "
                  f"LPIPS_WEIGHTS or place {_DEFAULT_PATH}); LPIPS is reported "
                  "as unavailable.", file=sys.stderr)
        _NETS[key] = LpipsTorch(w, device) if w is not None else None
    return _NETS[key]


def available(path: str | None = None, device=None) -> bool:
    return get(path, device) is not None
