"""The per-Gaussian work of an Adam step in the port, on the CPU: the
projection and SH forward (`gauss_step.project_sh_fwd_plain`, the plain
version of `project_sh_fwd_cuda`) against the JAX `_project_and_colors`;
its analytic backward (`projection.project_bwd_plain` +
`sh.eval_sh_bwd_plain`, through `model.ProjectSH`) against torch autograd
through the forward and against `jax.grad` of the JAX
`_project_and_colors`, over SH degrees 0-4 and every active degree, on
rows that are culled, dead, behind the near plane, off to the side (the
Jacobian's tx / ty clamped) or with det <= 0; and `WindowAdam.step` bit
for bit with the step it replaced.

Inputs are made with numpy from a seed.  The kernels themselves run only
on the card (tests/test_torch_cuda.py)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gps_slam_tpu.gs import model as jmodel
from gps_slam_torch.gs import gauss_step, model as tmodel, optim as toptim
from gps_slam_torch.gs import projection as tproj
from gps_slam_torch.utils.se3 import pose_inv

W, H = 96, 72
N = 2048
K = np.array([[60.0, 0, 47.5], [0, 60.0, 35.5], [0, 0, 1]], np.float32)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """A step's plain version is a few hundred small torch ops on [N]
    columns; one thread per test worker keeps them from handing work
    between threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _statics(degree: int, eps2d: float = 0.3):
    return tmodel.RenderStatics(width=W, height=H, sh_degree=degree, tile_size=16,
                                max_gs_radii=12, delta_depth=0.1, use_exposure=False,
                                visible_cap=N, tiles_per_gaussian_cap=9, tile_cap=64,
                                eps2d=eps2d)


def _jstatics(st):
    return jmodel.RenderStatics(**st._asdict())


@functools.lru_cache(maxsize=None)
def _inputs(degree: int):
    """A c2w looking down +z from (0.2, -0.1, -0.4), turned a little, and
    N Gaussians in front of it and around it: some behind the near plane
    or the camera, some far to the side (their Jacobian clamped), some
    dead; anisotropic scales from tiny to large; random SH of `degree`
    and random cotangents of every output."""
    rng = np.random.default_rng(17 + degree)
    a = 0.2
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
    c2w[:3, 3] = [0.2, -0.1, -0.4]
    z = rng.uniform(-0.5, 5.0, N)
    lat = rng.uniform(-1.0, 1.0, (N, 2)) * np.maximum(z, 0.2)[:, None]
    lat[: N // 8] *= 4.0                              # off to the side: clamped
    cam_pts = np.concatenate([lat, z[:, None]], 1)
    means = cam_pts @ c2w[:3, :3].T + c2w[:3, 3]
    nb = (degree + 1) ** 2
    p = {
        "means": means.astype(np.float32),
        "quats": rng.normal(size=(N, 4)).astype(np.float32),
        "scales": rng.uniform(-6.0, -0.5, (N, 3)).astype(np.float32),
        "features_dc": rng.normal(0, 0.5, (N, 3)).astype(np.float32),
        "features_rest": rng.normal(0, 0.3, (N, nb - 1, 3)).astype(np.float32),
        "opacities": rng.normal(size=(N, 1)).astype(np.float32),
    }
    alive = rng.random(N) > 0.1
    cot = {"means2d": rng.normal(size=(N, 2)), "conics": rng.normal(size=(N, 3)),
           "depths": rng.normal(size=N), "colors": rng.normal(size=(N, 3))}
    return p, alive, c2w, {k: v.astype(np.float32) for k, v in cot.items()}


def _port(p, alive, c2w, st, active, grads: bool, reference: bool = False):
    """(the leaf params, the outputs) of the port's `_project_and_colors`
    (`ProjectSH`) or, with `reference`, of its plain forward, which torch
    autograd then differentiates."""
    tp = {k: torch.tensor(v, requires_grad=grads) for k, v in p.items()}
    c2w_t = torch.as_tensor(c2w)
    al = torch.as_tensor(alive)
    act = None if active is None else torch.tensor(active, dtype=torch.int32)
    if reference:
        cam = tproj.camera(K, W, H)
        out = gauss_step.project_sh_fwd_plain(
            tp["means"], tp["quats"], tp["scales"], tp["features_dc"], tp["features_rest"],
            al, pose_inv(c2w_t), c2w_t, act, cam, st)
        m2, con, dep, radii, col = out
    else:
        proj, radii, col = tmodel._project_and_colors(tp, al, c2w_t, K, st, act)
        m2, con, dep = proj.means2d, proj.conics, proj.depths
    return tp, (m2, con, dep, radii, col)


def _port_grads(p, alive, c2w, cot, st, active, reference=False):
    tp, (m2, con, dep, _, col) = _port(p, alive, c2w, st, active, True, reference)
    loss = ((m2 * torch.as_tensor(cot["means2d"])).sum()
            + (con * torch.as_tensor(cot["conics"])).sum()
            + (dep * torch.as_tensor(cot["depths"])).sum()
            + (col * torch.as_tensor(cot["colors"])).sum())
    loss.backward()
    return {k: v.grad.numpy() for k, v in tp.items() if k != "opacities"}


@functools.lru_cache(maxsize=None)
def _jax_grad_fn(st, with_active: bool):
    def loss(params, alive, c2w, cot, active):
        proj, _, col = jmodel._project_and_colors(
            params, alive, c2w, jnp.asarray(K), st, active if with_active else None)
        return ((proj.means2d * cot["means2d"]).sum() + (proj.conics * cot["conics"]).sum()
                + (proj.depths * cot["depths"]).sum() + (col * cot["colors"]).sum())

    return jax.jit(jax.grad(loss))


def _jax_grads(p, alive, c2w, cot, st, active):
    fn = _jax_grad_fn(_jstatics(st), active is not None)
    g = fn({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(alive), jnp.asarray(c2w),
           {k: jnp.asarray(v) for k, v in cot.items()},
           jnp.asarray(0 if active is None else active, jnp.int32))
    return {k: np.asarray(v) for k, v in g.items() if k != "opacities"}


def _row_err(got, want):
    """Per attribute, the largest error of a row relative to the row's
    largest |value| in `want` (a row's entries share its scale: a row near
    the camera plane has grads 1e8 times those of its neighbours), floored
    at 1e-6 of the attribute's median row scale; and the error of the
    whole attribute relative to its norm."""
    out = {}
    for k in want:
        if want[k].size == 0:
            continue
        g = got[k].reshape(N, -1).astype(np.float64)
        w = want[k].reshape(N, -1).astype(np.float64)
        scale = np.abs(w).max(1)
        floor = 1e-6 * np.median(scale[scale > 0]) if (scale > 0).any() else 1e-30
        row = float((np.abs(g - w).max(1) / np.maximum(scale, floor)).max())
        whole = float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))
        out[k] = (row, whole)
    return out


def _check(errs: dict, row: float, whole, what: str):
    for k, (r, w) in errs.items():
        lim = whole[k] if isinstance(whole, dict) else whole
        assert r <= row and w <= lim, (what, k, r, w, lim)


def test_project_sh_fwd_matches_jax():
    """The port's forward (`project_sh_fwd_plain` through `ProjectSH`)
    against the JAX `_project_and_colors` at SH degree 3: radii equal,
    means2d, depths and colours within 1e-5 relative, the conics of
    visible rows within 1e-3 relative (1e-6 of their largest absolute)."""
    p, alive, c2w, _ = _inputs(3)
    st = _statics(3)
    _, (m2, con, dep, radii, col) = _port(p, alive, c2w, st, None, False)
    proj, jr, jc = jmodel._project_and_colors(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(alive), jnp.asarray(c2w),
        jnp.asarray(K), _jstatics(st))
    vis = np.asarray(jr) > 0
    assert 200 < vis.sum() < N - 200
    np.testing.assert_array_equal(radii.numpy(), np.asarray(jr))
    np.testing.assert_allclose(m2.numpy(), np.asarray(proj.means2d), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(dep.numpy(), np.asarray(proj.depths), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(col.numpy(), np.asarray(jc), rtol=1e-5, atol=1e-6)
    # the inverse of a 2D covariance near the blur's floor loses digits to
    # the det's cancellation: 2e-4 relative on these rows (the same
    # before the port's camera point was written out)
    jcon = np.asarray(proj.conics)[vis]
    np.testing.assert_allclose(con.numpy()[vis], jcon, rtol=1e-3,
                               atol=1e-6 * np.abs(jcon).max())


def test_rows_of_every_kind_are_present():
    """The inputs hold each kind of row the backward must treat as
    autograd does: dead, behind the near plane, beside the camera (tx or
    ty clamped), and with det <= 0 under a negative blur."""
    p, alive, c2w, _ = _inputs(3)
    viewmat = pose_inv(torch.as_tensor(c2w))
    means = torch.as_tensor(p["means"])
    x, y, z = tproj.camera_point(means, viewmat)
    cam = tproj.camera(K, W, H)
    assert (~alive).sum() > 50 and (z < 0.01).sum() > 50
    ux, uy = x / z, y / z
    front = z > 0.01
    clamped = (((ux < -cam.lim_x_neg) | (ux > cam.lim_x_pos)
                | (uy < -cam.lim_y_neg) | (uy > cam.lim_y_pos)) & front)
    assert clamped.sum() > 50
    for eps2d, want in ((0.3, 0), (-0.3, 50)):
        f = tproj._forward_terms(means, torch.as_tensor(p["quats"]),
                                 torch.exp(torch.as_tensor(p["scales"])), viewmat, cam, eps2d)
        assert int((~f["det_ok"]).sum()) >= want


CASES = [(d, a, 0.3) for d in range(5) for a in [None, *range(d + 1)]] + [(3, None, -0.3)]


@pytest.mark.parametrize("degree,active,eps2d", CASES,
                         ids=[f"deg{d}-active{a}-eps{e}" for d, a, e in CASES])
def test_backward_matches_autograd_and_jax(degree, active, eps2d):
    """The analytic backward (ProjectSH on the CPU) against the grads of
    the same forward in f64 under torch autograd (the truth), against
    torch autograd in f32 and against jax.grad of the JAX
    `_project_and_colors`.  f32 loses up to ~5e-3 of a row's scale on
    rows whose grads cancel (needle-like Gaussians turned about their long
    axis, rows at the near plane), in autograd as in the written-out
    chain, so the bounds are: against the truth, each attribute's error
    within 1.5x autograd's f32 error (+1e-7 of its norm) and every row
    within 1e-2 of its scale; against autograd in f32 and against JAX
    (whose camera point and chain round otherwise), each attribute within
    2e-3 of its norm and every row within 2e-2.  The SH coefficients of
    bands above `active`, and of culled rows, get exact zeros."""
    p, alive, c2w, cot = _inputs(degree)
    st = _statics(degree, eps2d)
    got = _port_grads(p, alive, c2w, cot, st, active)
    auto = _port_grads(p, alive, c2w, cot, st, active, reference=True)
    default = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        truth = _port_grads({k: v.astype(np.float64) for k, v in p.items()}, alive,
                            c2w.astype(np.float64),
                            {k: v.astype(np.float64) for k, v in cot.items()}, st, active,
                            reference=True)
    finally:
        torch.set_default_dtype(default)
    auto_err = _row_err(auto, truth)
    _check(_row_err(got, truth), 1e-2,
           {k: 1.5 * w + 1e-7 for k, (_, w) in auto_err.items()}, "truth")
    _check(_row_err(got, auto), 2e-2, 2e-3, "autograd")
    _check(_row_err(got, _jax_grads(p, alive, c2w, cot, st, active)), 2e-2, 2e-3, "jax")
    if active is not None and active < degree:
        assert not got["features_rest"][:, (active + 1) ** 2 - 1:].any()
    # culled rows (radius 0) take no colour gradient: their SH grads are zero
    _, (_, _, _, radii, _) = _port(p, alive, c2w, st, active, False)
    culled = radii.numpy() == 0
    assert culled.sum() > 100
    assert not got["features_dc"][culled].any() and not got["features_rest"][culled].any()


def test_backward_with_missing_cotangents():
    """Outputs that the loss does not reach (None cotangents) count as
    zeros: a loss of the colours alone gives the grads of autograd."""
    p, alive, c2w, cot = _inputs(2)
    st = _statics(2)
    out = {}
    for reference in (False, True):
        tp, (_, _, _, _, col) = _port(p, alive, c2w, st, None, True, reference)
        (col * torch.as_tensor(cot["colors"])).sum().backward()
        out[reference] = {k: v.grad.numpy() for k, v in tp.items() if v.grad is not None}
    assert set(out[False]) == set(out[True])
    _check(_row_err(out[False], out[True]), 2e-2, 2e-3, "autograd")


def _old_step(opt):
    """`WindowAdam.step` as it was before `window_adam_cuda`: the witness."""
    bc1, bc2, means_lr = opt.table[opt.count]
    for k, p in opt.params.items():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        opt.mu[k] = (1.0 - toptim.B1) * g + toptim.B1 * opt.mu[k]
        opt.nu[k] = (1.0 - toptim.B2) * (g * g) + toptim.B2 * opt.nu[k]
        upd = (opt.mu[k] / bc1) / (torch.sqrt(opt.nu[k] / bc2) + toptim.EPS)
        p.add_(upd * (-means_lr if k == "means" else -opt.lrs[k]))
    opt.count += 1


def test_window_adam_step_bit_for_bit_with_the_old_step():
    """20 updates of a 7-attribute pool (exposure learning) through
    `WindowAdam.step` and through the old step, from the same params and
    the same grads, some attributes' grads missing at some steps: params
    and both moments bit for bit after every step."""
    from types import SimpleNamespace

    rng = np.random.default_rng(3)
    shapes = {"means": (300, 3), "scales": (300, 3), "quats": (300, 4),
              "features_dc": (300, 3), "features_rest": (300, 15, 3),
              "opacities": (300, 1), "exposure": (2, 3, 4)}
    base = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    mcfg = SimpleNamespace(means_lr=1.6e-4, scales_lr=5e-3, quats_lr=1e-3,
                           featuresDc_lr=2.5e-3, featuresRest_lr=1.25e-4,
                           opacities_lr=5e-2, exposure_lr=1e-3, use_exposure=True)
    opts = []
    for _ in range(2):
        params = {k: torch.tensor(v) for k, v in base.items()}
        opts.append(toptim.WindowAdam(params, mcfg, 100, steps=20))
    for step in range(20):
        for k, s in shapes.items():
            g = (None if (step + len(k)) % 5 == 0
                 else torch.tensor(rng.normal(size=s).astype(np.float32)))
            for o in opts:
                o.params[k].grad = None if g is None else g.clone()
        opts[0].step()
        _old_step(opts[1])
        for k in shapes:
            for a, b in ((opts[0].params[k], opts[1].params[k]),
                         (opts[0].mu[k], opts[1].mu[k]), (opts[0].nu[k], opts[1].nu[k])):
                assert torch.equal(a, b), (step, k)
    assert opts[0].count == 20
    with pytest.raises(IndexError):
        opts[0].step()
