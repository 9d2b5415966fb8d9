"""The port's LPIPS(vgg) (`eval/lpips_torch.py`, `metrics.lpips`) held
against the JAX package's `lpips_jax`: the forward on seeded random
weights, the npz and torch-checkpoint loaders (one file serves both
packages), and the None marker when there is no weight file.  Nothing is
downloaded: the weights are `random_weights`."""

import numpy as np
import pytest
import torch

from gps_slam_tpu.eval import lpips_jax
from gps_slam_torch.eval import lpips_torch, metrics


@pytest.fixture(scope="module")
def weights():
    return lpips_torch.random_weights(np.random.default_rng(0))


def test_random_weights_and_names_match_jax(weights):
    """The same key layout, shapes and draws as the JAX package's."""
    jw = lpips_jax.random_weights(np.random.default_rng(0))
    assert lpips_torch.weight_names() == lpips_jax.weight_names() == list(weights)
    for k in jw:
        np.testing.assert_array_equal(jw[k], weights[k])


def test_lpips_matches_jax(weights):
    """A batch of 2 image pairs at 64x48, and one unbatched pair: the port
    on the CPU against `LpipsJax` within 1e-5 relative (f32 convolutions
    summed in another order)."""
    rng = np.random.default_rng(1)
    a = rng.uniform(0, 1, (2, 48, 64, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    t = lpips_torch.LpipsTorch(weights, "cpu")
    j = lpips_jax.LpipsJax(weights)
    got, want = t(a, b), j(a, b)
    assert got.shape == (2,) and (got > 0).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    assert t(a[0], b[0]) == pytest.approx(float(want[0]), rel=1e-5)
    assert t(a[0], a[0]) == 0.0


def test_weight_files_load_in_both_packages(weights, tmp_path):
    """A converted npz and a torch checkpoint {"vgg", "lin"} (OIHW convs
    under `features.N`, heads under `lin{l}.model.1.weight`) load to the
    same npz-layout arrays in the port and in the JAX package, exactly."""
    npz = tmp_path / "lpips_vgg.npz"
    np.savez(npz, **weights)
    vgg, n, idx = {}, 0, 0
    for stage in lpips_torch._STAGES:
        for _ in stage:
            vgg[f"features.{idx}.weight"] = torch.as_tensor(
                np.transpose(weights[f"conv{n}_w"], (3, 2, 0, 1)).copy())
            vgg[f"features.{idx}.bias"] = torch.as_tensor(weights[f"conv{n}_b"])
            idx += 2
            n += 1
        idx += 1  # the stage's max pool
    lin = {f"lin{l}.model.1.weight": torch.as_tensor(weights[f"lin{l}_w"]).view(1, -1, 1, 1)
           for l in range(5)}
    ckpt = tmp_path / "lpips_vgg.pt"
    torch.save({"vgg": vgg, "lin": lin}, ckpt)
    for path in (npz, ckpt):
        tw = lpips_torch.load_weights(str(path))
        jw = lpips_jax.load_weights(str(path))
        assert list(tw) == list(weights)
        for k in weights:
            np.testing.assert_array_equal(tw[k], weights[k])
            np.testing.assert_array_equal(jw[k], weights[k])


def test_lpips_marker_without_weights(weights, tmp_path, monkeypatch, capsys):
    """Without a weight file `metrics.lpips` returns None and warns once;
    with $LPIPS_WEIGHTS naming a file it returns that network's value.
    `vgg_perceptual` returns None without torchvision or its cached VGG16
    weights (the torch hub directory pointed at an empty one)."""
    a = np.random.default_rng(2).uniform(0, 1, (32, 32, 3)).astype(np.float32)
    b = a[::-1].copy()
    monkeypatch.setenv("LPIPS_WEIGHTS", str(tmp_path / "absent.npz"))
    assert metrics.lpips(a, b, device="cpu") is None
    assert metrics.lpips(a, b, device="cpu") is None
    assert not lpips_torch.available(device="cpu")
    assert capsys.readouterr().err.count("WARNING") == 1
    npz = tmp_path / "w.npz"
    np.savez(npz, **weights)
    monkeypatch.setenv("LPIPS_WEIGHTS", str(npz))
    assert metrics.lpips(a, b, device="cpu") == lpips_torch.LpipsTorch(weights, "cpu")(a, b)
    monkeypatch.setenv("TORCH_HOME", str(tmp_path / "hub"))
    assert metrics.vgg_perceptual(a, b, device="cpu") is None


def _vgg16_stack() -> torch.nn.Sequential:
    """torchvision's `vgg16().features` layer for layer (13 convolutions,
    ReLU after each, a max pool after each stage)."""
    layers, c = [], 3
    for v in (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
              512, 512, 512, "M"):
        if v == "M":
            layers.append(torch.nn.MaxPool2d(2, 2))
        else:
            layers += [torch.nn.Conv2d(c, v, 3, padding=1), torch.nn.ReLU(inplace=True)]
            c = v
    return torch.nn.Sequential(*layers)


def test_vgg_perceptual_matches_jax(tmp_path, monkeypatch):
    """`vgg_perceptual` with VGG16 weights in the torch hub cache: neither
    machine has torchvision, so a stand-in module builds torchvision's
    layer stack and the cached file holds seeded random weights.  The port
    on the CPU equals the JAX package's `vgg_perceptual` (which runs the
    same torch network) within 1e-6 relative; the network is built once
    for repeated calls; an image against itself is 0; without `device` it
    asks for the card, and raises where there is none."""
    import sys
    import types

    from gps_slam_tpu.eval import metrics as jmetrics

    hub = tmp_path / "torch"
    (hub / "hub" / "checkpoints").mkdir(parents=True)
    path = hub / "hub" / "checkpoints" / "vgg16-397923af.pth"
    torch.manual_seed(0)
    torch.save({f"features.{k}": v for k, v in _vgg16_stack().state_dict().items()}, path)
    built = []

    def vgg16(weights=None):
        net = types.SimpleNamespace(features=_vgg16_stack())
        if weights is not None:   # the JAX package names the ImageNet weights
            sd = torch.load(path, weights_only=True)
            net.features.load_state_dict({k[len("features."):]: v for k, v in sd.items()})
        built.append(weights)
        return net

    fake = types.ModuleType("torchvision")
    fake.models = types.SimpleNamespace(vgg16=vgg16)
    monkeypatch.setitem(sys.modules, "torchvision", fake)
    monkeypatch.setenv("TORCH_HOME", str(hub))
    monkeypatch.setattr(metrics, "_VGG", {})
    monkeypatch.setattr(jmetrics, "_VGG", None)
    monkeypatch.setattr(jmetrics, "_VGG_TRIED", False)
    rng = np.random.default_rng(4)
    a = rng.uniform(0, 1, (48, 64, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    got = metrics.vgg_perceptual(a, b, device="cpu")
    want = jmetrics.vgg_perceptual(a, b)
    assert got > 0 and got == pytest.approx(want, rel=1e-6)
    assert metrics.vgg_perceptual(a, a, device="cpu") == 0.0
    assert built == [None, "IMAGENET1K_V1"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            metrics.vgg_perceptual(a, b)
