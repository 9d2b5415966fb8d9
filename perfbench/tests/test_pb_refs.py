"""The plain references on their own: a fused frame raycast back to its
depth, the ICP recovering a known motion, the render's caps, and each in
bfloat16 (the control) ending and reading worse."""

import numpy as np
import pytest
import torch

from pbench import frames
from ref import fusion as rfusion, icp as ricp, raycast as rraycast

W, H = 160, 120
K = np.array([[120.0, 0, 79.5], [0, 120.0, 59.5], [0, 0, 1]], np.float32)
P = {"voxel_size": 0.01, "mu": 0.04, "frustum_min": 0.2, "frustum_max": 10.0, "max_w": 100,
     "alloc_steps": 4, "alloc_stride": 2, "alloc_candidate_cap": 2 ** 15,
     "visible_capacity": 2 ** 15}


def fused(n=3, dtype=torch.float32):
    poses = frames.orbit_poses(n, 600, 0.3, "in")
    rgb, depth = frames.render(torch.as_tensor(poses), W, H, 120.0, 120.0, 79.5, 59.5)
    vol = rfusion.empty("cpu")
    for k in range(n):
        vol, _ = rfusion.fuse(vol, depth[k], rgb[k], poses[k], K, P, dtype)
    return vol, poses, depth


def test_a_fused_frame_raycasts_back_to_its_depth():
    """Within two and a half voxels at the 90th percentile (rays leave the
    pixel centres, half a pixel from the frame's samples), and the more blocks a
    tile keeps, the more pixels hit (16 a tile see little of a 160x120
    view at 1 cm voxels)."""
    vol, poses, depth = fused()
    hits = []
    for lb in (16, 64, 512):
        m = rraycast.raycast(vol, poses[-1], K, W, H, P, lb=lb, k_blocks=2)
        hit = m["depth"] > 0
        hits.append(float(hit.double().mean()))
    gap = (m["depth"] - depth[-1]).abs()[hit]
    assert hits[0] < hits[1] < hits[2] and hits[2] > 0.9
    assert float(torch.quantile(gap, 0.9)) < 2.5 * P["voxel_size"]


@pytest.mark.parametrize("mu", [0.02, 0.04])
def test_the_bf16_raycast_ends_and_reads_otherwise(mu):
    p = dict(P, mu=mu, voxel_size=mu / 4)
    vol, poses, depth = fused(2)
    vol = rfusion.empty("cpu")
    for k in range(2):
        rgb, d = frames.render(torch.as_tensor(poses[k:k + 1]), W, H, 120.0, 120.0, 79.5, 59.5)
        vol, _ = rfusion.fuse(vol, d[0], rgb[0], poses[k], K, p)
    a = rraycast.raycast(vol, poses[-1], K, W, H, p, lb=512)
    b = rraycast.raycast(vol, poses[-1], K, W, H, p, lb=512, dtype=torch.bfloat16)
    both = (a["depth"] > 0) & (b["depth"] > 0)
    assert float(both.double().mean()) > 0.4
    assert bool((a["vertex"] != b["vertex"]).any())


def test_icp_recovers_a_frame_step_and_bf16_does_worse():
    vol, poses, depth = fused(2)
    m = rraycast.raycast(vol, poses[0], K, W, H, P, lb=512, k_blocks=2, track=True)
    T, inl, mr, failed = ricp.track(poses[0], depth[1], m["vertex"], m["normal"], K)
    assert not failed and inl > 0.2
    err = np.linalg.norm(T.numpy()[:3, 3] - poses[1][:3, 3])
    step = np.linalg.norm(poses[1][:3, 3] - poses[0][:3, 3])
    assert step > 0.01 and err < 0.25 * step
    Tb, _, _, _ = ricp.track(poses[0], depth[1], m["vertex"], m["normal"], K, torch.bfloat16)
    assert np.linalg.norm(Tb.numpy()[:3, 3] - poses[1][:3, 3]) > 3 * err


def test_fusion_in_bf16_moves_the_sdf():
    a, _, _ = fused(2)
    b, _, _ = fused(2, torch.bfloat16)
    both = torch.isin(a["keys"], b["keys"])
    rows_b = torch.searchsorted(b["keys"], a["keys"][both])
    seen = a["w"][both] > 0
    gap = (a["sdf"][both] - b["sdf"][rows_b]).abs()[seen].double() * 0.04 / 32767
    assert float(torch.quantile(gap, 0.99)) > 2e-3


def big_gaussian_pool(u_px: float, n_small: int = 200):
    """A pool seen from the identity pose of a 160x120 view at fx 120: one
    Gaussian wider than six tiles, its centre at u_px, v 60, and small ones
    around it."""
    from ref import splat as rsplat

    g = torch.Generator().manual_seed(5)
    z = 2.0
    means = torch.cat([torch.tensor([[0.0, 0.0, z]]),
                       torch.rand((n_small, 3), generator=g) * torch.tensor([2.0, 1.5, 1.0])
                       - torch.tensor([1.0, 0.75, -1.5])])
    n = means.shape[0]
    pool = {"means": means, "quats": torch.tensor([[1.0, 0, 0, 0]]).repeat(n, 1),
            "scales": torch.full((n, 3), -4.0), "features_dc": torch.rand((n, 3), generator=g),
            "features_rest": torch.zeros((n, 15, 3)), "opacities": torch.full((n, 1), 2.0),
            "alive": torch.ones(n, dtype=torch.bool)}
    pool["scales"][0] = -1.2
    # place the big one's centre at u_px as the reference projects it
    for _ in range(3):
        m2d, _, _, _ = rsplat.project(pool, np.eye(4), K, W, H, 100, torch.float32)
        pool["means"][0, 0] += (u_px - float(m2d[0, 0])) * z / 120.0
    return pool


def render_args():
    mcfg = {"max_gs_radii": 100, "sh_degree": 3, "delta_depth": 0.1}
    tpu = {"gaussian_capacity": 2 ** 12, "visible_gaussian_cap": 2 ** 12,
           "active_tile_cap": 2048, "tile_gaussian_cap": 64, "tiles_per_gaussian_cap": 36}
    return np.eye(4), K, W, H, torch.full((H, W), 3.0), mcfg, tpu


def test_a_centre_at_a_tile_edge_moves_a_column_of_the_render_and_is_unsettled():
    """A Gaussian wider than six tiles keeps the window of six centred on
    its centre's tile: a centre some float32 steps on the other side of a
    tile's edge, as another sound projection may put it, moves a column of
    tiles by more than the check's limit.  Those pixels are unsettled; the
    rest of the render does not move, and a pool with no centre near an
    edge has no unsettled pixel."""
    from ref import splat as rsplat

    args = render_args()
    gap = rsplat.SETTLE_PX / 2
    pool = big_gaussian_pool(64.0 - gap / 2)
    m2d, _, _, radii = rsplat.project(pool, np.eye(4), K, W, H, 100, torch.float32)
    assert float(m2d[0, 0]) < 64.0 < float(m2d[0, 0]) + gap and int(radii[0]) > 3 * 16
    a = rsplat.render(pool, *args)
    other = dict(pool, means=pool["means"].clone())
    other["means"][0, 0] += gap * 2.0 / 120.0
    b = rsplat.render(other, *args)
    moved = (a["weight"] - b["weight"]).abs()
    unsettled = rsplat.unsettled(pool, *args)
    assert float(torch.quantile(moved, 0.999)) > 0.05
    assert float(moved[~unsettled].max()) <= rsplat.SETTLE_TOL
    assert 0 < float(unsettled.double().mean()) < 0.2
    assert not bool(rsplat.unsettled(big_gaussian_pool(70.3), *args).any())


def test_a_depth_at_the_depth_cut_is_unsettled():
    """Over a flat depth a Gaussian that lies delta_depth behind it, to
    within rounding, is cut at every pixel or at none: a depth a few
    float32 steps away flips the whole of it.  Those pixels are unsettled,
    and a Gaussian well inside the cut leaves none."""
    from ref import splat as rsplat

    pool = big_gaussian_pool(70.3, n_small=0)
    cam, k, w, h, _, mcfg, tpu = render_args()
    m2d, _, depth, _ = rsplat.project(pool, cam, k, w, h, 100, torch.float32)
    flat = torch.full((h, w), float(depth[0]) - mcfg["delta_depth"])
    a = rsplat.render(pool, cam, k, w, h, flat, mcfg, tpu)
    other = dict(pool, means=pool["means"] * (1.0 + 4e-7))
    b = rsplat.render(other, cam, k, w, h, flat, mcfg, tpu)
    moved = (a["weight"] - b["weight"]).abs()
    unsettled = rsplat.unsettled(pool, cam, k, w, h, flat, mcfg, tpu)
    assert float(torch.quantile(moved, 0.999)) > 0.05
    assert float(moved[~unsettled].max()) <= rsplat.SETTLE_TOL
    inside = torch.full((h, w), float(depth[0]))
    assert not bool(rsplat.unsettled(pool, cam, k, w, h, inside, mcfg, tpu).any())
