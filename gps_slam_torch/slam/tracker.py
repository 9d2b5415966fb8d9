"""Camera trackers — the port of gps_slam_tpu/slam/tracker.py.

Point-to-plane ICP against the previous frame's raycast maps over a
coarse-to-fine depth pyramid (`levels=rrbb`: the two coarsest levels solve
rotation only), Gauss-Newton with Levenberg-Marquardt accept/reject,
Tukey-weighted residuals, bilinear association into the reference maps;
a photometric tracker (`ColorTracker`), and the file, force-fail and
composite trackers of the reference's tracker factory.

Each level's loop runs on the tensors' device.  The JAX package runs it as
one `lax.while_loop` whose exit test (`it < n_iters and step > 1e-10`)
stays on the device.  A Gauss-Newton iteration (the JAX loop body: the
per-pixel system, its f64 sums and the Levenberg-Marquardt step) is a pass
of `icp_gn.iterate` on the level's state (`_StaticLevel`) in place; on the
card one launch of the kernel `icp_gn_cuda` runs the level's whole loop,
its passes and its exit test (`more`) on the device, as the JAX loop does.
The eager route (`_track_level`, `ICPTracker.track`) launches it once a
level and reads the iterations run back once (8 bytes, the only
synchronising call of a level).  The tracked megastep's route
(`_track_level_static`, `track_pyramid_static`) reads nothing: captured
into a CUDA graph, each level is one kernel node.  On the CPU the plain
version runs pass after pass; its eager loop reads the test back after
each pass, and the static level, which must read nothing, is unrolled to
the level's budget with every update after the exit masked by the device
flag (the masked passes change nothing).  The colour tracker's level
(`_track_level_color`) runs only eagerly, as the JAX package's engine runs
it: one `color_gn.iterate` (one launch of `color_gn_cuda` on the card) and
one read of the iterations run.

The sums over pixels (the 6x6 system, the gradient, the robust error) are
accumulated in f64 and rounded to f32, in one fixed order on both devices
(`icp_gn.cta_sums`): the LM accept/reject compares errors that differ in
their last bits, so sums taken in another order could flip it and send
the trajectory elsewhere.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..config import Config
from ..utils.se3 import pose_inv
from . import color_gn, icp_gn
from .icp_gn import bilinear as _bilinear

# per-level Gauss-Newton budgets: numiterC (coarsest) to numiterF (finest),
# interpolated as the reference's SetupLevels does
NUMITER_C, NUMITER_F = 20, 50


def level_iters(numiter_c: int = NUMITER_C, numiter_f: int = NUMITER_F,
                n_levels: int = 4) -> tuple:
    """Coarsest = numiterC, finest = numiterF.  Returns finest-first."""
    step = (numiter_c - numiter_f) / max(n_levels - 1, 1)
    return tuple(
        int(round(numiter_c - step * (n_levels - 1 - lvl)))
        for lvl in range(n_levels)
    )


LEVEL_ITERS = level_iters()               # (50, 40, 30, 20) finest-first
SPACE_THRESH = (0.015, 0.03, 0.06, 0.1)   # hard outlier distance per level
TUKEY_C = (0.02, 0.03, 0.05, 0.08)        # robust scale per level (m)
# 'rrbb' finest-first: levels 0, 1 solve the full twist, 2, 3 rotation only
ROTATION_ONLY_FROM_LEVEL = 2
CONVERGED_STEP = 1e-5
# the loop continues while the squared step exceeds this f32 value (the
# JAX loop compares in f32)
_STEP_EXIT = float(np.float32(CONVERGED_STEP ** 2))


def _scalar(v, device) -> torch.Tensor:
    """A 0-d f32 tensor made on `device` by a fill: no host-to-device copy,
    and a division by it stays a true division on the card (a host float
    divisor becomes a multiply by its reciprocal there)."""
    return torch.full((), float(v), dtype=torch.float32, device=device)


def _subsample_depth(depth: torch.Tensor) -> torch.Tensor:
    """Stride-2 subsample keeping holes: the mean of each 2x2 block's
    valid pixels.  The block's sum is written out, (x00 + x01) + (x10 +
    x11), the order of the CPU's sum over the two axes, so that the card
    computes the CPU's bits whatever order its own reduction takes."""
    H, W = depth.shape
    H2, W2 = H // 2, W // 2
    d = depth[: H2 * 2, : W2 * 2].reshape(H2, 2, W2, 2)
    valid = d > 0
    z = torch.where(valid, d, 0.0)
    s = (z[:, 0, :, 0] + z[:, 0, :, 1]) + (z[:, 1, :, 0] + z[:, 1, :, 1])
    c = valid.sum(dim=(1, 3))
    return torch.where(c > 0, s / torch.clamp(c, min=1), 0.0)


def _vector(vals, device) -> torch.Tensor:
    """A 1-d f32 tensor of host values made on `device` by fills."""
    return torch.stack([_scalar(v, device) for v in vals])


def _track_level(
    T0: torch.Tensor,          # [4,4] current c2w estimate
    depth: torch.Tensor,       # [h, w] this level's depth
    ref_vertex: torch.Tensor,  # [H, W, 3] world vertices from the previous raycast
    ref_normal: torch.Tensor,  # [H, W, 3] world normals
    cam: torch.Tensor,         # [8]: fx, fy, cx, cy (level), fx0, fy0, cx0, cy0 (full)
    n_iters: int,
    rotation_only: bool,
    ref_pose_inv: torch.Tensor,  # [4,4] w2c of the raycast camera
    space_thresh: torch.Tensor,  # 0-d
    tukey_c: torch.Tensor,       # 0-d
):
    """Gauss-Newton iterations at one pyramid level.  Returns (T,
    inlier_frac, mean_residual, n_iters_run): T is the last accepted
    estimate (the trailing trial step is never evaluated), the inlier share
    and residual those of the last iteration, all on the device; the
    iterations run read back once (the level's one synchronising call)."""
    lv = _StaticLevel(T0, depth, ref_vertex, ref_normal, cam, n_iters, rotation_only,
                      ref_pose_inv, space_thresh, tukey_c, budget=n_iters)
    T, inlier, mean_r, n_run = lv.result()
    return T, inlier, mean_r, int(n_run)


class _StaticLevel:
    """One Gauss-Newton level: its inputs and the state its loop carries,
    allocated before the loop and updated in place by `iterate`
    (`icp_gn.iterate`: `icp_gn_cuda` on the card, its plain version on the
    CPU): T, T_acc, H_acc, g_acc, err_acc, lam, step, inlier and mean_r in
    one f32 buffer (`icp_gn.FIELDS`), the iterations run `n_run` (0-d
    int64) and the loop's test `more` (0-d bool: `n_run < n_iters` and the
    last step above the exit, the JAX `cond`).  When the level is made it
    runs iteration 0 and, while `more` holds, up to `budget` passes in all
    (one launch on the card; `budget` n_iters runs the whole level)."""

    def __init__(self, T0, depth, ref_vertex, ref_normal, cam, n_iters: int,
                 rotation_only: bool, ref_pose_inv, space_thresh, tukey_c, budget: int = 1):
        dev = depth.device
        h, w = depth.shape
        self.inputs = (depth.contiguous(), ref_vertex.contiguous(), ref_normal.contiguous(),
                       cam, ref_pose_inv, space_thresh, tukey_c, rotation_only, n_iters,
                       _STEP_EXIT)
        self.state = torch.cat([
            T0.reshape(-1), T0.reshape(-1),
            torch.eye(6, dtype=torch.float32, device=dev).reshape(-1),
            torch.zeros(6, dtype=torch.float32, device=dev),
            _vector((float("inf"), 1e-3, 0.0, 0.0, 0.0), dev)])
        at = 0
        for name, shape in icp_gn.FIELDS:
            n = int(np.prod(shape))
            setattr(self, name, self.state[at:at + n].view(shape))
            at += n
        self.n_run = torch.zeros((), dtype=torch.int64, device=dev)
        self.more = torch.zeros((), dtype=torch.bool, device=dev)
        self.partials = icp_gn.partials_buffer(h * w, dev) if dev.type == "cuda" else None
        self.iterate(budget, first=True)

    def iterate(self, budget: int = 1, first: bool = False) -> None:
        """Gauss-Newton passes on the carried state, in place: one, then
        more while `more` holds, at most `budget` (one launch on the card);
        `more` anew after each."""
        icp_gn.iterate(*self.inputs, self.state, self.n_run, self.more, self.partials,
                       first, budget)

    def iterate_masked(self) -> None:
        """One pass of the plain version with every update masked by
        `more` (the CPU's static level, which reads nothing back: a pass
        after the exit changes nothing)."""
        icp_gn.iterate_plain(*self.inputs, self.state, self.n_run, self.more,
                             active=self.more)

    def result(self) -> tuple:
        """(T, inlier, mean_r, n_run) as `_track_level` returns them."""
        return self.T_acc, self.inlier, self.mean_r, self.n_run


def _track_level_static(T0, depth, ref_vertex, ref_normal, cam, n_iters: int,
                        rotation_only: bool, ref_pose_inv, space_thresh, tukey_c):
    """`_track_level` with no read-back: the same values bit for bit, the
    iteration count a 0-d int64 device tensor.  On the card the level is
    one launch of `icp_gn_cuda` at budget n_iters (one kernel node when a
    CUDA graph is captured), whose loop exits on the device; on the CPU the
    loop is unrolled to `n_iters` and an iteration updates the state only
    while `more` (every step so far above the exit) holds."""
    if depth.device.type == "cuda":
        lv = _StaticLevel(T0, depth, ref_vertex, ref_normal, cam, n_iters, rotation_only,
                          ref_pose_inv, space_thresh, tukey_c, budget=n_iters)
    else:
        lv = _StaticLevel(T0, depth, ref_vertex, ref_normal, cam, n_iters, rotation_only,
                          ref_pose_inv, space_thresh, tukey_c)
        for _ in range(1, n_iters):
            # the pass reads the flag before it rewrites it
            lv.iterate_masked()
    return lv.result()


class TrackerQuality:
    GOOD, POOR, FAILED = 2, 1, 0


# thresholds of the ICP quality policy (ICPTracker.track)
FAIL_MIN_INLIER = 0.08
FAIL_MAX_RESIDUAL = 0.05
GOOD_MIN_INLIER = 0.2
GOOD_MAX_RESIDUAL = 0.015


def _level_cam(K: np.ndarray, lvl: int, full: bool) -> np.ndarray:
    """f32 intrinsics of pyramid level `lvl` (then the full-resolution
    ones when `full`), computed as the JAX package computes them."""
    fx0, fy0, cx0, cy0 = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    s = 2 ** lvl
    vals = [fx0 / s, fy0 / s, (cx0 + 0.5) / s - 0.5, (cy0 + 0.5) / s - 0.5]
    if full:
        vals += [fx0, fy0, cx0, cy0]
    return np.asarray(vals, np.float32)


def track_pyramid(T0: torch.Tensor, depth: torch.Tensor, ref_vertex, ref_normal,
                  K: np.ndarray, ref_pose_inv: torch.Tensor, level_iters: tuple,
                  space_thresh: tuple = SPACE_THRESH, tukey_c: tuple = TUKEY_C,
                  n_levels: int = 4):
    """The rrbb ICP pyramid, coarsest level first.  Returns (T, inlier,
    mean_r) of the finest level on the device, and the iterations run per
    level (finest-first)."""
    dev = depth.device
    pyramid = [depth]
    for _ in range(n_levels - 1):
        pyramid.append(_subsample_depth(pyramid[-1]))
    T = T0
    inl = mr = None
    iters = [0] * n_levels
    for lvl in range(n_levels - 1, -1, -1):
        cam = torch.as_tensor(_level_cam(K, lvl, True), device=dev)
        li = min(lvl, len(level_iters) - 1)
        T, inl, mr, iters[lvl] = _track_level(
            T, pyramid[lvl], ref_vertex, ref_normal, cam, level_iters[li],
            lvl >= ROTATION_ONLY_FROM_LEVEL, ref_pose_inv,
            _scalar(space_thresh[li], dev), _scalar(tukey_c[li], dev))
    return T, inl, mr, iters


def track_pyramid_static(T0: torch.Tensor, depth: torch.Tensor, ref_vertex,
                         ref_normal, K: np.ndarray, level_iters: tuple,
                         space_thresh: tuple = SPACE_THRESH,
                         tukey_c: tuple = TUKEY_C, n_levels: int = 4):
    """The rrbb pyramid of the tracked megastep, reading nothing back to
    the host (the JAX `track_pyramid`): each level is
    `_track_level_static`, the raycast camera's w2c is `pose_inv(T0)` on
    the device (the eager `ICPTracker.track` inverts it on the host) and
    the level constants are made by fills.  Returns (T, inlier, mean_r,
    iterations run per level finest-first [n_levels] int64), all on the
    device."""
    dev = depth.device
    pyramid = [depth]
    for _ in range(n_levels - 1):
        pyramid.append(_subsample_depth(pyramid[-1]))
    ref_pose_inv = pose_inv(T0)
    T = T0
    inl = mr = None
    iters = [None] * n_levels
    for lvl in range(n_levels - 1, -1, -1):
        li = min(lvl, len(level_iters) - 1)
        T, inl, mr, iters[lvl] = _track_level_static(
            T, pyramid[lvl], ref_vertex, ref_normal,
            _vector(_level_cam(K, lvl, True), dev), level_iters[li],
            lvl >= ROTATION_ONLY_FROM_LEVEL, ref_pose_inv,
            _scalar(space_thresh[li], dev), _scalar(tukey_c[li], dev))
    return T, inl, mr, torch.stack(iters)


def _tracker_node(cfg: Config) -> dict:
    return (cfg.raw.get("PIPE", {}).get("TSDF", {}) or {}).get("tracker", {}) or {}


# --------------------------------------------------------------- color

def _track_level_color(M0, pts_w, col_known, pts_valid, rgb, gx, gy,
                       n_iters: int, rotation_only: bool, cam: torch.Tensor):
    """One pyramid level of photometric Levenberg-Marquardt: minimises
    |bilinear(rgb, proj(M p_w)) - col_known|^2 over a left-multiplied twist
    on the w2c matrix M.  The level's loop is one `color_gn.iterate` at
    budget n_iters (one launch of `color_gn_cuda` on the card, its plain
    version pass after pass on the CPU) on the level's state
    (`color_gn.FIELDS`) in place, which exits after the JAX `cond`'s
    iteration; then one read of the iterations run.  Returns (M, inlier,
    residual, n_iters_run): M the last accepted estimate, the inlier share
    and residual those of the last iteration, on the device."""
    dev = rgb.device
    state = torch.cat([M0.reshape(-1), M0.reshape(-1),
                       _vector((float("inf"), 1e-3, 0.0, 0.0, 0.0), dev)])
    n_run = torch.zeros((), dtype=torch.int64, device=dev)
    more = torch.zeros((), dtype=torch.bool, device=dev)
    partials = (color_gn.partials_buffer(pts_w.shape[0], dev) if dev.type == "cuda"
                else None)
    inputs = (pts_w.contiguous(), col_known.contiguous(), pts_valid.contiguous(),
              rgb.contiguous(), gx.contiguous(), gy.contiguous(), cam, rotation_only,
              n_iters, _STEP_EXIT)
    color_gn.iterate(*inputs, state, n_run, more, partials, first=True, budget=n_iters)
    # the one read-back of a level
    return state[16:32].view(4, 4), state[35], state[36], int(n_run)


# The colour tracker's pyramid and image gradients are elementwise torch
# ops in one written order, so that the card and the CPU compute the same
# bits (a mean over two axes or a convolution sums in an order of the
# device's choosing, and an accept/reject of the loop turns on last bits).

def _downsample_rgb(img: torch.Tensor) -> torch.Tensor:
    """The mean of each 2x2 block, ((x00 + x01) + (x10 + x11)) / 4 (the
    CPU's order, as in `_subsample_depth`)."""
    H, W, C = img.shape
    x = img[: H // 2 * 2, : W // 2 * 2].reshape(H // 2, 2, W // 2, 2, C)
    return ((x[:, 0, :, 0] + x[:, 0, :, 1]) + (x[:, 1, :, 0] + x[:, 1, :, 1])) * 0.25


def _gradients(img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """`utils.se3._sobel` of [H, W, C] (replicate-padded Sobel x and y,
    cross-correlation, no normalisation), each sum of its six taps written
    out: dx = ((a02 - a00) + 2 (a12 - a10)) + (a22 - a20) over the 3x3
    neighbourhood a, dy likewise down the columns."""
    H, W = img.shape[:2]
    p = F.pad(img.permute(2, 0, 1)[None], (1, 1, 1, 1), mode="replicate")[0].permute(1, 2, 0)
    a = [[p[r:r + H, c:c + W] for c in range(3)] for r in range(3)]
    dx = ((a[0][2] - a[0][0]) + (a[1][2] - a[1][0]) * 2.0) + (a[2][2] - a[2][0])
    dy = ((a[2][0] - a[0][0]) + (a[2][1] - a[0][1]) * 2.0) + (a[2][2] - a[0][2])
    return dx, dy


class ColorTracker:
    """Photometric pose tracker against the model's raycast colours: the
    previous raycast's world points and rendered colours are projected
    into the new rgb frame and the photometric error is minimised by LM
    over SE(3), rotation-only at the two coarsest pyramid levels."""

    needs_color = True   # the tracking-prepare raycast must carry rgb

    def __init__(self, cfg: Config, width: int, height: int,
                 n_levels: int = 4, stride: int = 4):
        self.cfg = cfg
        self.width, self.height = width, height
        self.n_levels = n_levels
        self.stride = stride
        tnode = _tracker_node(cfg)
        self.level_iters = level_iters(
            int(tnode.get("numiterC", NUMITER_C)),
            int(tnode.get("numiterF", NUMITER_F)), n_levels)
        self.min_inlier = float(tnode.get("color_min_inlier", 0.15))
        self.max_residual = float(tnode.get("color_max_residual", 0.10))
        self.last_iters: list[int] = []

    def track(self, last_pose: np.ndarray, depth, raycast_maps: dict | None,
              K: np.ndarray, rgb=None):
        if raycast_maps is None or rgb is None:
            return last_pose, TrackerQuality.POOR
        s = self.stride
        vtx = raycast_maps["vertex_map"][::s, ::s].reshape(-1, 3)
        dev = vtx.device
        col = raycast_maps["color_map"][::s, ::s].reshape(-1, 3)
        valid = vtx.abs().sum(-1) > 0
        img0 = torch.as_tensor(rgb, dtype=torch.float32, device=dev).reshape(
            self.height, self.width, 3)
        levels = [img0]
        for _ in range(self.n_levels - 1):
            levels.append(_downsample_rgb(levels[-1]))
        M = torch.as_tensor(np.linalg.inv(last_pose), device=dev)
        inl = mr = None
        self.last_iters = [0] * self.n_levels
        for lvl in range(self.n_levels - 1, -1, -1):
            cam = torch.as_tensor(_level_cam(K, lvl, False), device=dev)
            gx, gy = _gradients(levels[lvl])
            li = min(lvl, len(self.level_iters) - 1)
            M, inl, mr, self.last_iters[lvl] = _track_level_color(
                M, vtx, col, valid, levels[lvl], gx, gy,
                self.level_iters[li], lvl >= ROTATION_ONLY_FROM_LEVEL, cam)
        # one fetch after the level chain; the 4x4 inverse on the host
        M_h = M.cpu().numpy()
        inlier, mean_r = float(inl), float(mr)
        self.last_inlier, self.last_residual = inlier, mean_r
        try:
            T = np.linalg.inv(M_h)
        except np.linalg.LinAlgError:
            return last_pose, TrackerQuality.FAILED
        if not np.all(np.isfinite(T)):
            return last_pose, TrackerQuality.FAILED
        if inlier < self.min_inlier or mean_r > self.max_residual:
            return last_pose, TrackerQuality.FAILED
        quality = (TrackerQuality.GOOD
                   if (inlier > 0.3 and mean_r < 0.06)
                   else TrackerQuality.POOR)
        return T, quality


class CompositeTracker:
    """Run trackers in sequence, each refining the previous estimate; the
    reported quality is the last tracker's."""

    def __init__(self, trackers: list):
        self.trackers = list(trackers)

    @property
    def needs_color(self) -> bool:
        return any(getattr(t, "needs_color", False) for t in self.trackers)

    def track(self, last_pose, depth, raycast_maps, K, rgb=None):
        pose, quality = last_pose, TrackerQuality.POOR
        for t in self.trackers:
            pose, quality = t.track(pose, depth, raycast_maps, K, rgb=rgb)
        return pose, quality


class FileBasedTracker:
    """Poses from per-frame files: `pose_mask % frame` holds the
    column-major 4x4 inverse pose (w2c); a missing or unreadable file is a
    tracking failure and the counter still advances."""

    def __init__(self, pose_mask: str, initial_frame: int = 0):
        self.pose_mask = pose_mask
        self.frame = initial_frame

    def track(self, last_pose, depth, raycast_maps, K, rgb=None):
        path = self.pose_mask % self.frame
        self.frame += 1
        try:
            vals = np.loadtxt(path, dtype=np.float32)
        except (OSError, ValueError):
            return last_pose, TrackerQuality.FAILED
        if vals.size != 16:
            return last_pose, TrackerQuality.FAILED
        inv_pose = vals.reshape(4, 4, order="F")  # column-major stream
        try:
            return (np.linalg.inv(inv_pose).astype(np.float32),
                    TrackerQuality.GOOD)
        except np.linalg.LinAlgError:
            return last_pose, TrackerQuality.FAILED


class ForceFailTracker:
    """Always fails: exercises the failure policies end to end."""

    def track(self, last_pose, depth, raycast_maps, K, rgb=None):
        return last_pose, TrackerQuality.FAILED


def make_tracker(cfg: Config, width: int, height: int):
    """Tracker factory over the optional PIPE.TSDF.tracker.type key: icp
    (default), rgb/color, composite (colour refine then icp), file
    (pose_mask), force_fail."""
    tnode = _tracker_node(cfg)
    ttype = str(tnode.get("type", "icp")).lower()
    if ttype in ("icp", "extended"):
        return ICPTracker(cfg, width, height)
    if ttype in ("rgb", "color"):
        return ColorTracker(cfg, width, height)
    if ttype == "composite":
        return CompositeTracker(
            [ColorTracker(cfg, width, height),
             ICPTracker(cfg, width, height)])
    if ttype == "file":
        return FileBasedTracker(str(tnode.get("pose_mask", "pose%06d.txt")),
                                int(tnode.get("initial_frame", 0)))
    if ttype == "force_fail":
        return ForceFailTracker()
    raise ValueError(f"unknown tracker type: {ttype}")


class ICPTracker:
    """Depth-only rrbb ICP against the previous tracking-prepare raycast."""

    needs_color = False  # vertex and normal maps suffice
    # the pyramid has a form that reads nothing back (`track_pyramid_static`):
    # the engine's tracked megastep may run it
    device_pure = True

    def __init__(self, cfg: Config, width: int, height: int, n_levels: int = 4):
        self.cfg = cfg
        self.width, self.height = width, height
        self.n_levels = n_levels
        tnode = _tracker_node(cfg)
        self.level_iters = level_iters(
            int(tnode.get("numiterC", NUMITER_C)),
            int(tnode.get("numiterF", NUMITER_F)),
            n_levels,
        )
        self.space_thresh = tuple(tnode.get("space_thresh", SPACE_THRESH))
        self.tukey_c = tuple(tnode.get("tukey_c", TUKEY_C))
        self.last_iters: list[int] = []

    def track(self, last_pose: np.ndarray, depth, raycast_maps: dict | None,
              K: np.ndarray, rgb=None):
        """Track the new depth frame against the previous raycast.  Returns
        (c2w pose [4,4] numpy, quality); `rgb` is ignored.  The iterations
        run per level (finest first) are kept in `last_iters`."""
        if raycast_maps is None:
            return last_pose, TrackerQuality.POOR
        ref_v = raycast_maps["vertex_map"]
        dev = ref_v.device
        d0 = torch.as_tensor(depth, dtype=torch.float32, device=dev).reshape(
            self.height, self.width)
        # the raycast camera's w2c inverted on the host in f32, as the JAX
        # package does, so both start from the same bits
        ref_pose_inv = torch.as_tensor(np.linalg.inv(last_pose), device=dev)
        T0 = torch.as_tensor(np.asarray(last_pose), device=dev)
        T, inl, mr, self.last_iters = track_pyramid(
            T0, d0, ref_v, raycast_maps["normal_map"], K, ref_pose_inv,
            self.level_iters, self.space_thresh, self.tukey_c, self.n_levels)
        # one fetch of (pose, inlier, residual) after the level chain
        vals = torch.cat([T.reshape(-1), inl.reshape(1), mr.reshape(1)]).cpu().numpy()
        T = vals[:16].reshape(4, 4)
        inlier, mean_r = float(vals[16]), float(vals[17])
        self.last_inlier, self.last_residual = inlier, mean_r
        # quality policy in place of the reference's SVM gate
        if not np.all(np.isfinite(T)):
            return last_pose, TrackerQuality.FAILED
        if inlier < FAIL_MIN_INLIER or mean_r > FAIL_MAX_RESIDUAL:
            return last_pose, TrackerQuality.FAILED
        quality = (TrackerQuality.GOOD
                   if (inlier > GOOD_MIN_INLIER and mean_r < GOOD_MAX_RESIDUAL)
                   else TrackerQuality.POOR)
        return T, quality
