"""The plain version of `icp_gn_cuda` (gps_slam_torch/slam/icp_gn.py), one
Gauss-Newton iteration of an ICP level, on the CPU: against the JAX
`_track_level` at one and two iterations on each pyramid level of
tests/test_torch_tracking.py's `ref_maps` fixture; its f64 sums in the
kernel's order (`cta_sums`) against that order written thread by thread,
and rounding to the same f32 values as the single sum; its 6x6 solve
against numpy, and a singular system giving a zero step; the plain level
loop (`run_plain`, which the CPU routes take) against the per-pass loop
with a host read of the step after each pass.

The kernel itself runs only on the card (tests/test_torch_cuda.py)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gps_slam_tpu.slam import tracker as jtrk
from gps_slam_torch.slam import icp_gn
from gps_slam_torch.slam import tracker as ttrk
from test_torch_tracking import ref_maps  # noqa: F401  (the fixture)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """A level's iteration is dozens of small torch ops; one thread per
    test worker keeps them from handing work between threads (the sums
    are f64 in a fixed order: the results do not depend on the thread
    count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _level_args(ref_maps, lvl):
    """The port's `_track_level` arguments at pyramid level `lvl` (its
    budget left out) and the JAX ones."""
    cams, vw, nw, depth, T0 = ref_maps
    dj, dt = jnp.asarray(depth), _t(depth)
    for _ in range(lvl):
        dj, dt = jtrk._subsample_depth(dj), ttrk._subsample_depth(dt)
    cam = ttrk._level_cam(cams[0].K, lvl, True)
    rpi = np.linalg.inv(cams[0].c2w.astype(np.float32))
    li = min(lvl, 3)
    rot = lvl >= ttrk.ROTATION_ONLY_FROM_LEVEL
    port = (_t(T0), dt, _t(vw), _t(nw), _t(cam), rot, _t(rpi),
            ttrk._scalar(ttrk.SPACE_THRESH[li], "cpu"), ttrk._scalar(ttrk.TUKEY_C[li], "cpu"))
    jax = dict(T0=jnp.asarray(T0), depth=dj, ref_vertex=jnp.asarray(vw),
               ref_normal=jnp.asarray(nw), cam=jnp.asarray(cam), rotation_only=rot,
               ref_pose_inv=jnp.asarray(rpi), space_thresh=jnp.asarray(jtrk.SPACE_THRESH[li]),
               tukey_c=jnp.asarray(jtrk.TUKEY_C[li]))
    return port, jax


def _level(port, n_iters):
    T0, d, vw, nw, cam, rot, rpi, st, tc = port
    return ttrk._StaticLevel(T0, d, vw, nw, cam, n_iters, rot, rpi, st, tc)


@pytest.mark.parametrize("lvl", [3, 2, 1, 0])
def test_plain_iteration_matches_jax(ref_maps, lvl):
    """One and two iterations of the plain version (term-by-term points,
    cross product and sums, the LU solve, se3_exp) against the JAX
    `_track_level` with budgets 1 and 2, on the rotation-only levels 3, 2
    and the full-twist levels 1, 0: the accepted pose within 1e-5, the
    inlier share within 1e-6, the mean residual within 1e-7 m (the
    tolerances of test_track_level_matches_jax: the JAX products and sums
    round in another order).  After one iteration the accepted pose is
    the start, bit for bit; the trial pose of that iteration (not
    returned by the JAX loop) is the accepted one after two (the second
    iteration lowers the error on every level of this fixture)."""
    port, jax = _level_args(ref_maps, lvl)
    lv = _level(port, 2)
    trial = lv.T.clone()
    assert not torch.equal(trial, port[0])
    for n in (1, 2):
        Tj, ij, mj, nj = jtrk._track_level(
            jax["T0"], jax["depth"], jax["ref_vertex"], jax["ref_normal"], jax["cam"], n,
            jax["rotation_only"], ref_pose_inv=jax["ref_pose_inv"],
            space_thresh=jax["space_thresh"], tukey_c=jax["tukey_c"])
        if n == 2:
            lv.iterate()
        Tt, it_, mt, nt = lv.result()
        assert int(nt) == int(nj) == n
        np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), atol=1e-5)
        assert abs(float(it_) - float(ij)) <= 1e-6
        assert abs(float(mt) - float(mj)) <= 1e-7
        assert torch.equal(Tt, port[0] if n == 1 else trial)


def _fresh_state(T0):
    """A level's state at its start (`_StaticLevel`'s)."""
    return torch.cat([T0.reshape(-1), T0.reshape(-1), torch.eye(6).reshape(-1), torch.zeros(6),
                      torch.tensor([float("inf"), 1e-3, 0.0, 0.0, 0.0])])


@pytest.mark.parametrize("lvl", [0, 1, 2, 3])
def test_plain_level_loop_matches_the_per_pass_loop(ref_maps, lvl):
    """The plain level loop that the CPU routes take (`icp_gn.iterate` at
    budget n_iters: `run_plain`, `iterate_plain` pass after pass while the
    device flag `more` holds) against the per-pass loop of the eager route
    before the level kernel (`iterate_plain` once a pass, the host reading
    `step` after each and going on while `it < n_iters` and `step` is
    above the exit), from the level's start at its budget, at every level
    of the 160x120 fixture: the state, the iterations run and the loop's
    test bit for bit, and `_track_level` returns that state's estimate,
    inlier share, residual and count."""
    port, _ = _level_args(ref_maps, lvl)
    T0, d, vw, nw, cam, rot, rpi, st, tc = port
    n_iters = ttrk.LEVEL_ITERS[lvl]
    inputs = (d, vw, nw, cam, rpi, st, tc, rot, n_iters, ttrk._STEP_EXIT)
    s, n, m = _fresh_state(T0), torch.zeros((), dtype=torch.int64), torch.zeros((), dtype=bool)
    icp_gn.iterate_plain(*inputs, s, n, m, first=True)
    it, step = 1, float(s[76])
    while it < n_iters and step > ttrk._STEP_EXIT:
        icp_gn.iterate_plain(*inputs, s, n, m)
        it += 1
        step = float(s[76])
    s2, n2 = _fresh_state(T0), torch.zeros((), dtype=torch.int64)
    m2 = torch.zeros((), dtype=torch.bool)
    icp_gn.iterate(*inputs, s2, n2, m2, None, first=True, budget=n_iters)
    assert torch.equal(s2, s) and int(n2) == int(n) == it and torch.equal(m2, m)
    assert it > 1 and not bool(m2)
    T, inl, mr, n3 = ttrk._track_level(T0, d, vw, nw, cam, n_iters, rot, rpi, st, tc)
    assert n3 == it and torch.equal(T, s[16:32].view(4, 4))
    assert torch.equal(inl, s[77]) and torch.equal(mr, s[78])


def _kernel_order(x: np.ndarray, rounds: int, pix: int) -> np.ndarray:
    """The kernel's reduction written thread by thread: CTA b takes rows
    [b per, (b + 1) per), per = NT pix rounds; in round k thread
    t = 32 w + l adds rows b per + (k pix + m) NT + t, m < pix, in m's
    order (+0 past the end); `__shfl_xor_sync` transposes (a lane keeps
    half of its values by its lane bit, from bit 4 down, and adds its
    partner's), lane l ends with term l's warp sum, which it adds to its
    running sum (from +0); then the warps' sums by halving."""
    M, C = x.shape
    nt, nw = icp_gn.NT, icp_gn.NW
    per = nt * pix * rounds
    out = np.zeros((max(1, -(-M // per)), C))
    for b in range(out.shape[0]):
        acc = [[0.0] * C for _ in range(nw)]
        for k in range(rounds):
            for w in range(nw):
                vals = []
                for lane in range(32):
                    s = None
                    for m in range(pix):
                        row = b * per + (k * pix + m) * nt + 32 * w + lane
                        v = x[row] if row < M else np.zeros(C)
                        s = v if s is None else s + v
                    vals.append(s)
                for c in range(C):
                    # lane l holds a value of term c: at lane bit B it adds
                    # its partner's, as the transposes do
                    lanes = [vals[l][c] for l in range(32)]
                    for bit in (16, 8, 4, 2, 1):
                        lanes = [lanes[l] + lanes[l ^ bit] for l in range(32)]
                    acc[w][c] = acc[w][c] + lanes[0]
        acc = [np.array(a) for a in acc]
        for h in (nw // 2, nw // 4, nw // 8):
            acc = [acc[i] + acc[i + h] for i in range(h)]
        out[b] = acc[0]
    return out


@pytest.mark.parametrize("M,rounds,pix", [(1, 1, 1), (3000, 1, 1), (3000, 2, 1), (5000, 2, 2),
                                          (1800, 1, 2)])
def test_cta_sums_follow_the_kernels_order(M, rounds, pix):
    """`cta_sums` bit for bit with the kernel's reduction written thread
    by thread, on values spread over 16 decades (where the order of an f64
    sum shows in its bits)."""
    rng = np.random.default_rng(M + rounds + pix)
    x = rng.normal(size=(M, 3)) * 10.0 ** rng.uniform(-8, 8, (M, 3))
    got = icp_gn.cta_sums(torch.as_tensor(x), rounds, pix).numpy()
    assert np.array_equal(got, _kernel_order(x, rounds, pix))


@pytest.mark.parametrize("lvl", [3, 2, 1, 0])
def test_cta_sums_round_like_the_single_sum(ref_maps, lvl):
    """The 45 sums of a level's terms (at the start pose and after one
    iteration), taken in the kernel's CTA blocks of NT x 1 to 16 rows (1,
    2 or 4 rows a thread a round; then the blocks' rows in one CTA), round
    to the same f32 values as the exact sum (math.fsum) and as torch's
    single f64 sum."""
    port, _ = _level_args(ref_maps, lvl)
    T0, d, vw, nw, cam, rot, rpi, st, tc = port
    lv = _level(port, 2)
    pts, has_depth = icp_gn.level_points(d, cam)
    for T in (T0, lv.T):
        x = icp_gn.terms(T, pts, has_depth, vw, nw, cam, rpi, st, tc, rot)
        exact = torch.tensor([math.fsum(c) for c in x.T.tolist()]).float()
        assert torch.equal(x.sum(0).float(), exact)
        assert float(exact[44]) > 50   # an iteration with inliers
        for rounds, pix in ((1, 1), (2, 1), (1, 2), (5, 2), (4, 4), (16, 1)):
            rows = icp_gn.cta_sums(x, rounds, pix)
            tot = icp_gn.cta_sums(rows, -(-rows.shape[0] // icp_gn.NT))[0]
            assert torch.equal(tot.float(), exact), (rounds, pix)
        assert torch.equal(icp_gn.totals(x).float(), exact)


def test_solve6_matches_numpy():
    """The LU solve on well-conditioned systems, one of them with a zero
    leading entry (the first pivot is a row swap): within 1e-5 of
    numpy's f64 solve, relative to the solution's largest |value|, and a
    non-zero-pivot flag."""
    rng = np.random.default_rng(5)
    for case in range(6):
        A = rng.normal(size=(6, 6)).astype(np.float32) + 4 * np.eye(6, dtype=np.float32)
        if case == 0:
            A[0, 0] = 0.0
        b = rng.normal(size=6).astype(np.float32)
        x, nonzero = icp_gn.solve6(_t(A), _t(b))
        ref = np.linalg.solve(A.astype(np.float64), b.astype(np.float64))
        assert bool(nonzero)
        assert np.abs(x.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()


def _state(T):
    return torch.cat([T.reshape(-1), T.reshape(-1), torch.eye(6).reshape(-1), torch.zeros(6),
                      torch.tensor([float("inf"), 1e-3, 0.0, 0.0, 0.0])])


def test_singular_system_gives_a_zero_step():
    """A damped system with two equal rows (a zero pivot) and one with a
    NaN: the solve flags the first, and the step keeps the pose (T
    bit for bit, step 0), as `solve_ex` with `ok_solve` did.  A regular
    system moves it."""
    T = torch.tensor([[1.0, 0.0, 0.0, 0.5], [0.0, 0.0, -1.0, 0.2], [0.0, 1.0, 0.0, 1.5],
                      [0.0, 0.0, 0.0, 1.0]])
    n_pix = torch.tensor(100.0)

    def tot(H, g):
        return torch.cat([H.double().reshape(-1), g.double(),
                          torch.tensor([5.0, 400.0, 90.0], dtype=torch.float64)])

    H = torch.zeros(6, 6)
    # zero diagonal: the damped diagonal is the 1e-8 floor, and rows 0, 1
    # of the damped system are equal
    H[0, 1] = H[1, 0] = 1e-8
    g = torch.arange(1.0, 7.0)
    A = H + 1e-8 * torch.eye(6)
    assert not bool(icp_gn.solve6(A, -g)[1])
    H_nan = torch.eye(6)
    H_nan[2, 4] = float("nan")
    for Hs in (H, H_nan):
        new = icp_gn.lm_step(_state(T), tot(Hs, g), n_pix, first=True)
        assert torch.equal(new[:16].view(4, 4), T)
        assert float(new[76]) == 0.0
    moved = icp_gn.lm_step(_state(T), tot(torch.eye(6), g * 1e-3), n_pix, first=True)
    assert float(moved[76]) > 0 and not torch.equal(moved[:16].view(4, 4), T)


def test_grid_covers_the_levels():
    """The kernel's grid at the pyramid levels of 1200x680 and 160x120:
    within MAX_CTAS CTAs, every pixel in it, no CTA empty; its scratch
    holds two halves of a row per CTA (the passes use them in turn) and
    the zeroed words of the grid barrier."""
    for w, h in ((1200, 680), (160, 120)):
        for lvl in range(4):
            n = (w >> lvl) * (h >> lvl)
            per = icp_gn.NT * icp_gn.PIX * icp_gn.rounds(n)
            c = icp_gn.n_ctas(n)
            assert c <= icp_gn.MAX_CTAS and c * per >= n > (c - 1) * per
            buf = icp_gn.partials_buffer(n, "cpu")
            assert buf.shape == (2 * icp_gn.N_TERMS * c + 1,) and not buf.any()
