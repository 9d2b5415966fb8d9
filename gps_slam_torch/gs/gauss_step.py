"""The per-Gaussian head of a render and of an Adam step: projection and
SH colour (`project_sh_fwd`) and their analytic backward
(`project_sh_bwd`), the CUDA kernels of csrc/gauss_step.cu and their plain
PyTorch versions.

The counterpart of the XLA fusions that the JAX package makes of
`_project_and_colors` (gps_slam_tpu/gs/model.py:58-79) and of its
`jax.grad` inside the window scan; it replaces no `pallas_call`.  The
forward returns what `_project_and_colors` returns: means2d [N, 2],
conics [N, 3], depths [N], radii [N] (int32, at most `max_gs_radii` when
that is > 0) and colours [N, 3] (SH + 0.5, clamped at 0, zero where the
radius is 0).  The backward maps the cotangents of means2d, conics,
depths and colours (None: zero) to the grads of the means, quats,
log-scales, features_dc and features_rest.

The camera is a device view matrix [4, 4] and c2w [4, 4] (its centre is
the SH view origin) plus the host `projection.Camera`; the SH ramp's
active degree is an optional int tensor on the device.  Nothing is read
back to the host, so a CUDA graph captures both kernels.  CPU tensors
take the plain versions; CUDA tensors launch the kernels or raise.
"""

from __future__ import annotations

import torch

from .. import kernels
from . import projection, sh


def _coeffs(features_dc, features_rest):
    return torch.cat([features_dc[:, None, :], features_rest], 1)


def project_sh_fwd_plain(means, quats, log_scales, features_dc, features_rest, alive,
                         viewmat, c2w, active_degree, cam: projection.Camera, st):
    """The plain version of `project_sh_fwd_cuda` (`st`: the render's
    statics, a `model.RenderStatics`)."""
    proj = projection.project_fwd_plain(
        means, quats, torch.exp(log_scales), viewmat, cam, st.width, st.height,
        eps2d=st.eps2d, near_plane=st.near_plane, far_plane=st.far_plane,
        radius_clip=st.radius_clip, valid=alive)
    radii = proj.radii
    if st.max_gs_radii > 0:
        radii = torch.clamp(radii, max=st.max_gs_radii)
    colors = sh.eval_sh(st.sh_degree, means - c2w[:3, 3], _coeffs(features_dc, features_rest),
                        mask=radii > 0, active_degree=active_degree)
    return proj.means2d, proj.conics, proj.depths, radii, torch.clamp(colors + 0.5, min=0.0)


def project_sh_bwd_plain(means, quats, log_scales, features_dc, features_rest, radii,
                         viewmat, c2w, active_degree, cam: projection.Camera, st,
                         v_means2d, v_conics, v_depths, v_colors):
    """The plain version of `project_sh_bwd_cuda`: (grad means, quats,
    log_scales, features_dc, features_rest).  The means' grad is the
    projection's plus the view direction's, in that order."""
    scales = torch.exp(log_scales)
    v_means, v_quats, v_scales = projection.project_bwd_plain(
        means, quats, scales, viewmat, cam, st.width, st.height, v_means2d, v_conics,
        v_depths, eps2d=st.eps2d)
    if v_colors is None:
        v_colors = torch.zeros_like(means)
    v_coeffs, v_dirs = sh.eval_sh_bwd_plain(
        st.sh_degree, means - c2w[:3, 3], _coeffs(features_dc, features_rest), v_colors,
        mask=radii > 0, active_degree=active_degree)
    return (v_means + v_dirs, v_quats, v_scales * scales, v_coeffs[:, 0].contiguous(),
            v_coeffs[:, 1:].contiguous())


def _check_inputs(k, means, quats, log_scales, features_dc, features_rest, viewmat, c2w,
                  active_degree, st):
    N = means.shape[0]
    nc = features_rest.shape[1] + 1
    if not 0 <= st.sh_degree <= 4 or nc < (st.sh_degree + 1) ** 2:
        raise ValueError(f"{k.name}: SH degree {st.sh_degree} with {nc} coefficients")
    for name, t, shape in (("means", means, (N, 3)), ("quats", quats, (N, 4)),
                           ("log_scales", log_scales, (N, 3)),
                           ("features_dc", features_dc, (N, 3)),
                           ("features_rest", features_rest, (N, nc - 1, 3)),
                           ("viewmat", viewmat, (4, 4)), ("c2w", c2w, (4, 4))):
        kernels.check_tensor(k, name, t, torch.float32, shape)
    if active_degree is not None:
        kernels.check_tensor(k, "active_degree", active_degree, torch.int32, ())
    return N, nc


def _cam_args(cam: projection.Camera) -> tuple:
    return (cam.fx, cam.fy, cam.cx, cam.cy, cam.lim_x_neg, cam.lim_x_pos, cam.lim_y_neg,
            cam.lim_y_pos)


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def project_sh_fwd(means, quats, log_scales, features_dc, features_rest, alive, viewmat,
                   c2w, active_degree, cam: projection.Camera, st):
    """(means2d, conics, depths, radii, colors) of every row (see the
    module's note).  CPU tensors take the plain version; CUDA tensors
    launch `project_sh_fwd_cuda` or raise."""
    if means.device.type != "cuda":
        return project_sh_fwd_plain(means, quats, log_scales, features_dc, features_rest,
                                    alive, viewmat, c2w, active_degree, cam, st)
    k = kernels.PROJECT_SH_FWD
    N, nc = _check_inputs(k, means, quats, log_scales, features_dc, features_rest, viewmat,
                          c2w, active_degree, st)
    kernels.check_tensor(k, "alive", alive, torch.bool, (N,))
    dev = means.device
    means2d = torch.empty((N, 2), dtype=torch.float32, device=dev)
    conics = torch.empty((N, 3), dtype=torch.float32, device=dev)
    depths = torch.empty((N,), dtype=torch.float32, device=dev)
    radii = torch.empty((N,), dtype=torch.int32, device=dev)
    colors = torch.empty((N, 3), dtype=torch.float32, device=dev)
    if N == 0:
        return means2d, conics, depths, radii, colors
    err = k.fn(means.data_ptr(), quats.data_ptr(), log_scales.data_ptr(),
               features_dc.data_ptr(), features_rest.data_ptr(), alive.data_ptr(),
               viewmat.data_ptr(), c2w.data_ptr(), _ptr(active_degree), means2d.data_ptr(),
               conics.data_ptr(), depths.data_ptr(), radii.data_ptr(), colors.data_ptr(),
               N, nc, st.sh_degree, st.width, st.height, st.max_gs_radii, *_cam_args(cam),
               st.eps2d, st.near_plane, st.far_plane, st.radius_clip, kernels.stream_ptr())
    k.launches += 1
    kernels.check(k, err)
    return means2d, conics, depths, radii, colors


def project_sh_bwd(means, quats, log_scales, features_dc, features_rest, radii, viewmat,
                   c2w, active_degree, cam: projection.Camera, st, v_means2d, v_conics,
                   v_depths, v_colors):
    """(grad means, quats, log_scales, features_dc, features_rest) for
    the cotangents (None: zero) of `project_sh_fwd`'s outputs, its radii
    given.  CPU tensors take the plain version; CUDA tensors launch
    `project_sh_bwd_cuda` or raise."""
    if means.device.type != "cuda":
        return project_sh_bwd_plain(means, quats, log_scales, features_dc, features_rest,
                                    radii, viewmat, c2w, active_degree, cam, st, v_means2d,
                                    v_conics, v_depths, v_colors)
    k = kernels.PROJECT_SH_BWD
    N, nc = _check_inputs(k, means, quats, log_scales, features_dc, features_rest, viewmat,
                          c2w, active_degree, st)
    kernels.check_tensor(k, "radii", radii, torch.int32, (N,))
    for name, t, shape in (("v_means2d", v_means2d, (N, 2)), ("v_conics", v_conics, (N, 3)),
                           ("v_depths", v_depths, (N,)), ("v_colors", v_colors, (N, 3))):
        if t is not None:
            kernels.check_tensor(k, name, t, torch.float32, shape)
    outs = [torch.empty_like(t) for t in (means, quats, log_scales, features_dc,
                                          features_rest)]
    if N == 0:
        return tuple(outs)
    err = k.fn(means.data_ptr(), quats.data_ptr(), log_scales.data_ptr(),
               features_dc.data_ptr(), features_rest.data_ptr(), radii.data_ptr(),
               viewmat.data_ptr(), c2w.data_ptr(), _ptr(active_degree), _ptr(v_means2d),
               _ptr(v_conics), _ptr(v_depths), _ptr(v_colors), *(o.data_ptr() for o in outs),
               N, nc, st.sh_degree, *_cam_args(cam), st.eps2d, kernels.stream_ptr())
    k.launches += 1
    kernels.check(k, err)
    return tuple(outs)
