"""The port's frame staging (`data/device_cache.py`, `data/prefetch.py`)
held against the JAX package: the cache's quantized values against the
JAX `DeviceFrameCache`'s, its LRU eviction, and the prefetcher's order,
its values (the cache's, bit for bit) and its error path, on the CPU."""

import numpy as np
import pytest
import torch

from gps_slam_tpu.data import synthetic
from gps_slam_tpu.data.device_cache import DeviceFrameCache as JCache
from gps_slam_torch.data.device_cache import DeviceFrameCache, quantize
from gps_slam_torch.data.prefetch import FramePrefetcher


@pytest.fixture(scope="module")
def cams():
    cs = synthetic.make_cameras(6, 64, 48)
    cs[5].depth = None  # a frame without depth: zeros, as in the JAX cache
    return cs


def test_device_frame_cache_matches_jax(cams):
    """rgb888 and u16 depth at 0.2 mm, converted on the device: the same
    quantized words as the JAX cache, converted within one f32 ulp of its
    values (the port divides by 255 and 5000, exactly on the CPU, while
    XLA's CPU compiler multiplies by the reciprocals: both are checked
    bit for bit); a frame without depth gives zeros, and the least
    recently used entry is evicted first."""
    jc, tc = JCache(), DeviceFrameCache("cpu")
    for cam in cams:
        (jr, jd), (tr, td) = jc.get(cam), tc.get(cam)
        u8, d = quantize(cam)
        np.testing.assert_array_equal(tr.numpy(), u8.astype(np.float32) / np.float32(255))
        np.testing.assert_array_equal(td.numpy(), d.astype(np.float32) / np.float32(5000))
        np.testing.assert_array_equal(np.asarray(jr),
                                      u8.astype(np.float32) * np.float32(1 / 255))
        np.testing.assert_array_equal(np.asarray(jd),
                                      d.astype(np.float32) * np.float32(1 / 5000))
        np.testing.assert_array_max_ulp(np.asarray(jr), tr.numpy(), maxulp=1)
        np.testing.assert_array_max_ulp(np.asarray(jd), td.numpy(), maxulp=1)
        assert tr.shape == (48, 64, 3) and td.shape == (48, 64)
    assert not tc.get(cams[5])[1].any()
    assert np.abs(tc.get(cams[0])[1].numpy() - cams[0].depth[..., 0]).max() <= 1e-4
    small = DeviceFrameCache("cpu", capacity=2)
    first = small.get(cams[0])
    small.get(cams[1])
    assert small.get(cams[0]) is first       # hit: cams[0] becomes most recent
    small.get(cams[2])                       # evicts cams[1]
    assert list(small._cache) == [cams[0].id, cams[2].id]


def test_prefetcher_order_and_values(cams):
    """The frames come in camera order as (cam, depth, rgb), each equal to
    the cache's tensors bit for bit (the same wire format and conversion),
    with a lookahead of 1 and of 3."""
    cache = DeviceFrameCache("cpu")
    for lookahead in (1, 3):
        seen = []
        for cam, depth, rgb in FramePrefetcher(cams, "cpu", lookahead=lookahead):
            r, d = cache.get(cam)
            assert torch.equal(depth, d) and torch.equal(rgb, r)
            seen.append(cam.id)
        assert seen == [c.id for c in cams]


def test_prefetcher_raises_the_workers_error(cams):
    """A frame the worker cannot stage raises in the consumer, after the
    frames before it."""
    broken = synthetic.make_cameras(3, 32, 24)
    broken[1].image = None
    seen = []
    with pytest.raises(TypeError):
        for cam, _, _ in FramePrefetcher(broken, "cpu"):
            seen.append(cam.id)
    assert seen == [broken[0].id]
