"""Faults planted under the timed path, for the tests of the check and
the readings of control.py: each breaks the program as a faulty change
would, and the check has to come out not correct.

  * "stale_step": the check step returns its state unchanged (nothing
    fused; a tracked frame keeps the last pose);
  * "half_batch": half of the check step's work is left out (every
    second frame of a fusion group; half the rows of a tracked frame's
    depth);
  * "altered_answer": an answer altered where it is produced (the sign of
    the sdf of every voxel the check step fused; a tracked pose moved by
    four voxels);
  * "adam_skipped": every window's Adam steps leave the pool unchanged;
  * "camera_dropped": every window's steps that draw its first camera
    take its second in its place.

The first three patch the module functions that the eager route (the
CPU's) calls in the check step; a graph captured in set-up holds the
unpatched work, so they act on CPU runs only.  The window's two act from
the start of the run, so the card's window graphs capture them too.
`plant` patches with the `setattr` it is given (pytest's monkeypatch, or
control.py's, which undoes it).
"""

from __future__ import annotations

import torch

from pbench.stream import Phases

FAULTS = ("stale_step", "half_batch", "altered_answer", "adam_skipped", "camera_dropped")


def plant(run, faults, setattr) -> None:
    from gps_slam_torch.gs import optim
    from gps_slam_torch.slam import megastep, tracker as trk
    from gps_slam_torch.tsdf import integrate

    faults = set(faults)
    unknown = faults - set(FAULTS)
    if unknown:
        raise ValueError(f"unknown faults {sorted(unknown)}")
    fuse0, track0 = integrate.fuse_frame_static, trk.track_pyramid_static
    count = [0]

    def in_check():
        return run.source is not None and run.source.phase == Phases.CHECK

    def fuse(vol, depth, rgb, c2w, K, n_blocks, bilateral=False):
        if not in_check():
            return fuse0(vol, depth, rgb, c2w, K, n_blocks, bilateral)
        count[0] += 1
        if "stale_step" in faults:
            return torch.zeros((), dtype=torch.int64, device=depth.device)
        if "half_batch" in faults:
            if run.tracked:
                depth = depth.clone()
                depth[depth.shape[0] // 2:] = 0.0
            elif count[0] % 2 == 0:
                return torch.zeros((), dtype=torch.int64, device=depth.device)
        before = vol.state.clone()
        out = fuse0(vol, depth, rgb, c2w, K, n_blocks, bilateral)
        if "altered_answer" in faults and not run.tracked:
            changed = vol.state != before
            low = vol.state & 0xFFFF
            sdf = torch.where(low >= 32768, low - 65536, low)
            flipped = (-sdf) & 0xFFFF
            vol.state.copy_(torch.where(changed, (vol.state & ~0xFFFF) | flipped, vol.state))
        return out

    def track(T0, *a, **kw):
        T, inl, mr, iters = track0(T0, *a, **kw)
        if in_check():
            if "stale_step" in faults:
                T = T0.clone()
            if "altered_answer" in faults:
                T = T.clone()
                T[0, 3] += 4 * run.cfg.pipe.tsdf.voxel_size
        return T, inl, mr, iters

    if faults & {"stale_step", "half_batch", "altered_answer"}:
        setattr(integrate, "fuse_frame_static", fuse)
        setattr(trk, "track_pyramid_static", track)
    if "adam_skipped" in faults:
        def step(self):
            self.count += 1

        setattr(optim.WindowAdam, "step", step)
    if "camera_dropped" in faults:
        window0 = megastep.window_megastep

        def window(vol, pool, poses, K, gt_rgb, iter_cam_idx, spawn_noise, **kw):
            idx = torch.where(iter_cam_idx == 0, torch.ones_like(iter_cam_idx), iter_cam_idx)
            return window0(vol, pool, poses, K, gt_rgb, idx, spawn_noise, **kw)

        setattr(megastep, "window_megastep", window)
