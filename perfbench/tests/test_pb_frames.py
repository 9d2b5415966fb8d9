"""The benchmark's torch frame generator against the scene it copies."""

import numpy as np
import torch

from pbench import frames


def test_torch_frames_match_the_synthetic_scene():
    from gps_slam_torch.data import synthetic

    W, H = 160, 120
    fx = fy = 0.75 * W
    cx, cy = (W - 1) / 2.0, (H - 1) / 2.0
    for look in ("in", "out"):
        poses = frames.orbit_poses(6, 24, 0.0, look)
        ref = synthetic.orbit_poses(24, look=look, arc=1.0)[:6]
        np.testing.assert_allclose(poses, np.stack(ref), atol=1e-6)
        rgb, depth = frames.render(torch.as_tensor(poses), W, H, fx, fy, cx, cy)
        for k in range(6):
            r_rgb, r_depth = synthetic.render_frame(poses[k], W, H, fx, fy, cx, cy)
            np.testing.assert_allclose(depth[k].numpy(), r_depth[..., 0], rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(rgb[k].numpy(), r_rgb, atol=1e-4)
            q_rgb, q_d = frames.quantize(rgb[k], depth[k])
            # the wire format, rounded as the program's device cache rounds
            want_rgb = np.clip(r_rgb * 255.0 + 0.5, 0, 255).astype(np.uint8)
            want_d = np.clip(r_depth[..., 0] * 5000.0 + 0.5, 0, 65535).astype(np.uint16)
            assert (q_rgb.numpy().astype(int) - want_rgb).__abs__().max() <= 1
            assert (frames.wire_depth_i32(q_d).numpy() - want_d.astype(int)).__abs__().max() <= 1


def test_a_seed_sets_phases_and_start_not_sizes():
    a, b = frames.seed_draw(1), frames.seed_draw(2 ** 31 + 7)
    assert a != b and frames.seed_draw(1) == a
    K = np.array([[40.0, 0, 31.5], [0, 40.0, 23.5], [0, 0, 1]], np.float32)
    s1 = frames.FrameStore(1, 12, "in", 64, 48, K, "cpu")
    s2 = frames.FrameStore(2 ** 31 + 7, 12, "in", 64, 48, K, "cpu")
    assert s1.rgb.shape == s2.rgb.shape and s1.depth.dtype == torch.int16
    # the same trajectory shape: every seed's poses keep the orbit's radius
    for s in (s1, s2):
        c = s.poses[:, :3, 3] - np.array([2.0, 1.5, 2.0])
        np.testing.assert_allclose(np.hypot(c[:, 0], c[:, 2]), 1.6, atol=1e-5)
    assert not torch.equal(s1.rgb, s2.rgb)
