#!/usr/bin/env python
"""Where the time of the Gauss-Newton level kernels goes, on the card:
`icp_gn_cuda` and `color_gn_cuda`, each a pyramid level's loop in one
cooperative launch, against the per-pass kernels they replaced.

Makes one tracking step at 1200x680 (tests/test_torch_cuda.py's
`icp_levels` and `color_levels`: frame 0's world vertices, normals,
points and colours, frame 1's depth and rgb pyramids, frame 1's pose or
frame 0's w2c perturbed by a small twist) and, at each pyramid level,
from the level's start (iteration 0, `first`) at its budget:

  * this tree's level launch: the state, count and test bit for bit with
    the plain level loop (`run_plain`),
    `passes`, and by CUDA events (each launch after an L2 flush and a
    spin of the card, the state restored outside the events, as
    chip_smoke.py's [kernel] rows) `ms_level`, `ms_pass` = ms_level /
    passes, and `ms_one_pass` (a launch at budget 1);
  * with `--parent DIR`, the per-pass kernel of the tree at DIR
    (gps_slam_torch/csrc/icp_gn.cu, color_gn.cu: one launch a pass, its
    last CTA takes the step after a ticket), called through its own C
    entry: `parent_ms_level` (its `passes` launches back to back in the
    events), `parent_ms_pass`, and its final state bit for bit with this
    tree's;
  * the eager route's level on the host clock (synchronised before and
    after): this tree's one launch and one read of the count
    (`eager_ms`), the parent's launch and 4-byte read of the step a pass
    (`parent_eager_ms`);
  * the cut builds of this tree's source (copies with phases taken out by
    pattern, `variant`): the pass cut after the pixels and the CTA's sums,
    after its row is written, after the grid barrier, after the rows are
    summed, after the step's solve; and the whole source: each launched
    at budget 1 and at budget `--cut-passes` with the step exit at -1
    (every pass runs): `cut_ms_one`, `cut_ms_pass` = (ms at B - ms at 1) /
    (B - 1), the cost of one more pass.

The measurements run in turns (every variant at a level, then the next
level, `--reps` rounds), so that a slow round touches them all alike.
Usage, on a machine with the card and nvcc:

    python tools/icp_gn_split.py [--parent DIR] [--kernel icp --kernel color]
                                 [--reps N] [--cut-passes B] [--out FILE]

Prints one JSON line per kernel and level and the card's name and power
limit, and writes them all to --out (default build/icp_gn_split.json).
Card only: exits 2 without CUDA; exits 1 if a check is not bit for bit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from gps_slam_torch import kernels  # noqa: E402
from gps_slam_torch.data import synthetic  # noqa: E402
from gps_slam_torch.slam import color_gn, icp_gn  # noqa: E402
from gps_slam_torch.slam import tracker as ttrk  # noqa: E402
from gps_slam_torch.utils import se3 as tse3  # noqa: E402

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the C entries of the per-pass kernels (one launch a pass, a ticket slot
# after the rows): icp_gn(depth, refv, refn, cam, rpi, st, tc, state,
# n_run, more, active, partials, h, w, Hf, Wf, rot, rounds, n_ctas, first,
# n_iters, step_exit, stream) and color_gn(pts, col, valid, rgb, gx, gy,
# cam, state, n_run, more, partials, n, h, w, rot, rounds, n_ctas, first,
# n_iters, step_exit, stream)
PER_PASS_ARGTYPES = {"icp": [P] * 12 + [I] * 9 + [F, P], "color": [P] * 11 + [I] * 8 + [F, P]}
CUTS = (1, 2, 3, 4, 5)
# the edits of a cut build, (pattern, replacement) on the level kernel's
# source: every pass runs to the budget (the cuts change no state), and the
# phases past the cut go; what a cut keeps stays live through a test that
# never holds
RUN_BUDGET = (r"if \(!\(s_more && k < budget\)\) break;", "if (k >= budget) break;")
NO_ROW = (r"if \(t < NTERMS\) rows\[\(size_t\)t \* n_ctas \+ lb\] = row;",
          "if (row == -1.25e300) rows[t] = row;")
NO_BARRIER = (r"grid_sync\(bar, [^;]*\);", "")
NO_STEP = (r"take_step\(rows, [^;]*\);", "")
KEEP_SUMS = (r"(sum_rows<NTERMS>\(rows, n_ctas, acc, tot\);)",
             r"\1\n  if (t == 0 && tot[0] == -1.25e300) ss[0] = 0.0f;\n  return;")
KEEP_SOLVE = (r"(const bool nonzero = lu6_lanes\(sA, sb, dl, lane\);)",
              r"\1\n  if (lane == 0 && nonzero && dl[0] == -1.25e30f) ss[0] = 0.0f;\n  return;")
CUT_EDITS = {1: (RUN_BUDGET, NO_ROW, NO_BARRIER, NO_STEP),
             2: (RUN_BUDGET, NO_BARRIER, NO_STEP),
             3: (RUN_BUDGET, NO_STEP),
             4: (RUN_BUDGET, KEEP_SUMS),
             5: (RUN_BUDGET, KEEP_SOLVE)}


def variant(src: str, cut: int) -> str:
    """The level kernel's source with the phases past `cut` taken out."""
    for pattern, text in CUT_EDITS[cut]:
        found = list(re.finditer(pattern, src))
        if len(found) != 1:
            raise RuntimeError(f"cut {cut}: {pattern!r} matches {len(found)} times")
        src = src[:found[0].start()] + found[0].expand(text) + src[found[0].end():]
    return src


def icp_levels(dev) -> list:
    """The 4 levels' `_track_level` arguments of a 1200x680 tracking step."""
    a, b = synthetic.make_cameras(n_frames=2, width=1200, height=680, look="in",
                                  arc=0.025 / 8)
    vm = tse3.compute_vertex_map(torch.as_tensor(a.depth[..., 0], device=dev),
                                 a.fx, a.fy, a.cx, a.cy)
    nm = tse3.compute_normal_map(vm)
    ok = vm[..., 2:3] > 0
    c2w = torch.as_tensor(a.c2w, device=dev)
    vw = torch.where(ok, vm @ c2w[:3, :3].T + c2w[:3, 3], 0.0).contiguous()
    nw = torch.where(ok, nm @ c2w[:3, :3].T, 0.0).contiguous()
    twist = torch.tensor([0.004, -0.003, 0.006, 0.004, -0.006, 0.003], device=dev)
    T0 = (tse3.se3_exp(twist) @ torch.as_tensor(b.c2w, device=dev)).contiguous()
    rpi = tse3.pose_inv(c2w)
    d = torch.as_tensor(b.depth[..., 0], device=dev)
    out = []
    for lvl in range(4):
        cam = torch.as_tensor(ttrk._level_cam(a.K, lvl, True), device=dev)
        out.append((T0, d, vw, nw, cam, ttrk.LEVEL_ITERS[lvl],
                    lvl >= ttrk.ROTATION_ONLY_FROM_LEVEL, rpi,
                    ttrk._scalar(ttrk.SPACE_THRESH[lvl], dev),
                    ttrk._scalar(ttrk.TUKEY_C[lvl], dev)))
        d = ttrk._subsample_depth(d)
    return out


def color_levels(dev) -> list:
    """The 4 levels' (M0, pts, col, valid, rgb, gx, gy, cam) of a 1200x680
    colour-tracking step (51,000 points)."""
    a, b = synthetic.make_cameras(n_frames=2, width=1200, height=680, look="in",
                                  arc=0.025 / 8)
    vm = tse3.compute_vertex_map(torch.as_tensor(a.depth[..., 0], device=dev),
                                 a.fx, a.fy, a.cx, a.cy)
    c2w = torch.as_tensor(a.c2w, device=dev)
    vw = torch.where(vm[..., 2:3] > 0, vm @ c2w[:3, :3].T + c2w[:3, 3], 0.0)
    pts = vw[::4, ::4].reshape(-1, 3).contiguous()
    col = torch.as_tensor(a.image, device=dev)[::4, ::4].reshape(-1, 3).contiguous()
    valid = pts.abs().sum(-1) > 0
    twist = torch.tensor([0.004, -0.003, 0.006, 0.004, -0.006, 0.003], device=dev)
    M0 = (tse3.se3_exp(twist) @ tse3.pose_inv(c2w)).contiguous()
    img = torch.as_tensor(b.image, device=dev)
    out = []
    for lvl in range(4):
        gx, gy = ttrk._gradients(img)
        cam = torch.as_tensor(ttrk._level_cam(a.K, lvl, False), device=dev)
        out.append((M0, pts, col, valid, img.contiguous(), gx.contiguous(), gy.contiguous(),
                    cam))
        img = ttrk._downsample_rgb(img)
    return out


def build(jobs: list) -> list:
    """nvcc each (source, its text or None for the file's own) at once into
    build/icp_gn_split/; per job (the library, its ptxas lines)."""
    out_dir = ROOT / "build" / "icp_gn_split"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for i, (src, text) in enumerate(jobs):
        lib = out_dir / f"job{i}.so"
        if text is not None:
            cu = out_dir / f"job{i}.cu"
            cu.write_text(text)
            src = cu
        cmd = [kernels._nvcc(), *kernels.ICP_GN.nvcc_flags(), "-I", str(Path(jobs[i][0]).parent),
               "-o", str(lib), str(src)]
        procs.append((lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True)))
    res = []
    for lib, p in procs:
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{log}")
        res.append((ctypes.CDLL(str(lib)),
                    [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]))
    return res


class Level:
    """One level of one kernel: its inputs, its start state and the calls
    that run it on this tree's kernel, a cut build, the parent's per-pass
    kernel or the plain loop."""

    def __init__(self, kind: str, lvl: int, largs: tuple):
        self.kind, self.lvl = kind, lvl
        if kind == "icp":
            T0, d, vw, nw, cam, budget, rot, rpi, st, tc = largs
            d = d.contiguous()
            self.inputs = (d, vw, nw, cam, rpi, st, tc, rot, budget, ttrk._STEP_EXIT)
            self.mod, self.k, self.n = icp_gn, kernels.ICP_GN, d.numel()
            self.s0 = torch.cat([T0.reshape(-1), T0.reshape(-1),
                                 torch.eye(6, device=d.device).reshape(-1),
                                 torch.zeros(6, device=d.device),
                                 torch.tensor([float("inf"), 1e-3, 0.0, 0.0, 0.0],
                                              device=d.device)])
            self.shape = {"h": d.shape[0], "w": d.shape[1]}
            self.step_at = 76
        else:
            M0, pts, col, valid, rgb, gx, gy, cam = largs
            budget = ttrk.LEVEL_ITERS[lvl]
            rot = lvl >= ttrk.ROTATION_ONLY_FROM_LEVEL
            self.inputs = (pts, col, valid, rgb, gx, gy, cam, rot, budget, ttrk._STEP_EXIT)
            self.mod, self.k, self.n = color_gn, kernels.COLOR_GN, pts.shape[0]
            self.s0 = torch.cat([M0.reshape(-1), M0.reshape(-1),
                                 torch.tensor([float("inf"), 1e-3, 0.0, 0.0, 0.0],
                                              device=M0.device)])
            self.shape = {"points": pts.shape[0], "image": list(rgb.shape[:2])}
            self.step_at = color_gn.STEP
        self.budget = budget
        dev = self.s0.device
        self.r0 = torch.zeros((), dtype=torch.int64, device=dev)
        self.m0 = torch.zeros((), dtype=torch.bool, device=dev)
        self.s, self.r, self.m = self.s0.clone(), self.r0.clone(), self.m0.clone()
        self.p = self.mod.partials_buffer(self.n, dev)
        self.ctas = icp_gn.n_ctas(self.n)
        self.pp = torch.zeros(self.mod.N_TERMS * self.ctas + 1, dtype=torch.float64, device=dev)

    def restore(self) -> None:
        self.s.copy_(self.s0)
        self.r.copy_(self.r0)
        self.m.copy_(self.m0)

    def launch(self, budget: int, step_exit: float | None = None) -> None:
        inputs = self.inputs if step_exit is None else (*self.inputs[:-1], step_exit)
        self.mod.iterate(*inputs, self.s, self.r, self.m, self.p, first=True, budget=budget)

    def plain(self) -> tuple:
        s, r, m = self.s0.clone(), self.r0.clone(), self.m0.clone()
        self.mod.run_plain(*self.inputs, s, r, m, first=True, budget=self.budget)
        return s, r, m

    def per_pass(self, fn, first: bool) -> None:
        """One launch of the parent's per-pass kernel on (s, r, m)."""
        a = self.inputs
        n_iters, step_exit, rot = a[8], a[9], a[7]
        if self.kind == "icp":
            d, vw = a[0], a[1]
            err = fn(*(t.data_ptr() for t in a[:7]), self.s.data_ptr(), self.r.data_ptr(),
                     self.m.data_ptr(), None, self.pp.data_ptr(), d.shape[0], d.shape[1],
                     vw.shape[0], vw.shape[1], int(rot), icp_gn.rounds(self.n), self.ctas,
                     int(first), int(n_iters), float(step_exit), kernels.stream_ptr())
        else:
            rgb = a[3]
            err = fn(*(t.data_ptr() for t in a[:7]), self.s.data_ptr(), self.r.data_ptr(),
                     self.m.data_ptr(), self.pp.data_ptr(), self.n, rgb.shape[0], rgb.shape[1],
                     int(rot), icp_gn.rounds(self.n), self.ctas, int(first), int(n_iters),
                     float(step_exit), kernels.stream_ptr())
        kernels.check(self.k, err)

    def parent_eager(self, fn) -> int:
        """The parent's eager level: a launch and a read of the step a pass."""
        self.per_pass(fn, True)
        it, step = 1, float(self.s[self.step_at])
        while it < self.budget and step > ttrk._STEP_EXIT:
            self.per_pass(fn, False)
            it += 1
            step = float(self.s[self.step_at])
        return it


def host_ms(fn, before, reps: int) -> float:
    """Median host-clock ms of fn, synchronised before and after."""
    out = []
    for _ in range(reps):
        before()
        torch.cuda.synchronize()
        t = time.monotonic()
        fn()
        torch.cuda.synchronize()
        out.append((time.monotonic() - t) * 1e3)
    return float(np.median(out))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="a tree whose gps_slam_torch/csrc holds the per-pass kernels")
    ap.add_argument("--kernel", action="append", choices=("icp", "color"))
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--cut-passes", type=int, default=8)
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "icp_gn_split.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("icp_gn_split: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    kinds = args.kernel or ["icp", "color"]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    cs.log(smi)
    kernels.build_all()
    ks = {"icp": kernels.ICP_GN, "color": kernels.COLOR_GN}
    jobs, index = [], {}
    for kind in kinds:
        for cut in CUTS:
            index[(kind, cut)] = len(jobs)
            jobs.append((ks[kind].path, variant(Path(ks[kind].path).read_text(), cut)))
        if args.parent is not None:
            index[(kind, "parent")] = len(jobs)
            jobs.append((args.parent.resolve() / "gps_slam_torch" / "csrc" / ks[kind].source,
                         None))
    libs = build(jobs)
    rows, ok = {}, True
    levels = {"icp": icp_levels(dev) if "icp" in kinds else [],
              "color": color_levels(dev) if "color" in kinds else []}
    for rep in range(args.reps):
        for kind in kinds:
            k = ks[kind]
            own = k._fn
            for lvl, largs in enumerate(levels[kind]):
                L = Level(kind, lvl, largs)
                ps, pr, pm = L.plain()
                r = rows.setdefault((kind, lvl), {
                    "kernel": k.name, "level": lvl, **L.shape, "ctas": L.ctas,
                    "rounds": icp_gn.rounds(L.n), "budget": L.budget,
                    "build": [ln for ln in kernels.build_log.get(k.name, "").splitlines()
                              if "registers" in ln], "bit_for_bit": True})
                L.restore()
                L.launch(L.budget)
                torch.cuda.synchronize()
                passes = int(L.r)
                exact = torch.equal(L.s, ps) and torch.equal(L.r, pr) and torch.equal(L.m, pm)
                ms = cs.time_ms(lambda: L.launch(L.budget), 20, before=L.restore)
                one = cs.time_ms(lambda: L.launch(1), 20, before=L.restore)
                eager = host_ms(lambda: (L.launch(L.budget), int(L.r)), L.restore, 10)
                r["passes"] = passes
                r["bit_for_bit"] = r["bit_for_bit"] and exact
                for key, v in (("ms_level", ms), ("ms_one_pass", one), ("eager_ms", eager),
                               ("ms_pass", ms / passes)):
                    r.setdefault(key, []).append(v)
                if (kind, "parent") in index:
                    lib = libs[index[(kind, "parent")]][0]
                    fn = getattr(lib, k.entry)
                    fn.argtypes, fn.restype = PER_PASS_ARGTYPES[kind], ctypes.c_int
                    passes = r["passes"]

                    def parent_level():
                        for i in range(passes):
                            L.per_pass(fn, i == 0)

                    L.restore()
                    parent_level()
                    torch.cuda.synchronize()
                    same = (torch.equal(L.s, ps) and torch.equal(L.r, pr)
                            and torch.equal(L.m, pm))
                    r["parent_bit_for_bit"] = r.get("parent_bit_for_bit", True) and same
                    pms = cs.time_ms(parent_level, 20, before=L.restore)
                    r.setdefault("parent_ms_level", []).append(pms)
                    r.setdefault("parent_ms_pass", []).append(pms / passes)
                    r.setdefault("parent_eager_ms", []).append(
                        host_ms(lambda: L.parent_eager(fn), L.restore, 10))
                    r["parent_build"] = libs[index[(kind, "parent")]][1]
                # the cut builds and the whole source, every pass run
                B = args.cut_passes
                variants = [(c, libs[index[(kind, c)]][0]) for c in CUTS] + [(6, None)]
                for cut, lib in variants:
                    if lib is not None:
                        fn = getattr(lib, k.entry)
                        fn.argtypes, fn.restype = k.argtypes, ctypes.c_int
                        k._fn = fn
                    try:
                        one = cs.time_ms(lambda: L.launch(1, -1.0), 20, before=L.restore)
                        many = cs.time_ms(lambda: L.launch(B, -1.0), 20, before=L.restore)
                    finally:
                        k._fn = own
                    name = {1: "pixels", 2: "rows", 3: "barrier", 4: "row_sums", 5: "solve",
                            6: "whole"}[cut]
                    r.setdefault(f"cut_ms_one_{name}", []).append(one)
                    r.setdefault(f"cut_ms_pass_{name}", []).append((many - one) / (B - 1))
                    if lib is not None:
                        r[f"cut_build_{name}"] = libs[index[(kind, cut)]][1]
    out = []
    for r in rows.values():
        for key in [x for x in r if isinstance(r[x], list) and r[x]
                    and isinstance(r[x][0], float)]:
            r[key + "_mean"] = float(np.mean(r[key]))
        ok = ok and r["bit_for_bit"] and r.get("parent_bit_for_bit", True)
        cs.log("[gn split] " + json.dumps(r))
        out.append(r)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"card": smi, "cut_passes": args.cut_passes, "rows": out}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
