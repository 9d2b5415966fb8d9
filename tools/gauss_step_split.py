#!/usr/bin/env python
"""Time project_sh_fwd_cuda and project_sh_bwd_cuda (csrc/gauss_step.cu) on
the card, for each given source, and split the tiled design's time.

Drives chip_smoke.py's main path (30 frames of the outward arc at
1200x680, bench_config, 20 Adam steps a window) to get the inputs of its
last Adam step's forward and backward, the inputs of chip_smoke.py's
`[window step]` rows, and draws a second set: 131,072 random rows of SH
degree 3 around a 1200x680 camera, the `131072-3` case of
tests/test_torch_cuda.py::test_project_sh_kernels_match_plain.  Then it
builds each given source into build/gauss_split/ and times both kernels
of each build on both sets, as chip_smoke.time_ms times a [kernel] row
(CUDA events, each launch after an L2 flush and a spin of the card).  A
source with the tiled design (its phases marked "// ---- 2." and so on)
is also built cut down:

  staging     the tiles' loads and stores only (no projection, no SH);
  projection  the loads, the projection and the stores (no SH);
  whole       the source as it is, its outputs compared with the plain
              versions' (`bit_for_bit`).

Each build is also timed warm (`warm_ms`: the same launches without the
L2 flush, the spin kept), which says how much of a cold launch is the
first reads of its data and code from device memory.

The cut builds are copies of the source with phases taken out; the
port's source carries no switch for them.  The builds run in turns
(every source and cut, `--reps` rounds), so that a slow round touches them
all alike.  Usage, on a machine with the card and nvcc:

    python tools/gauss_step_split.py [--source PATH ...] [--reps N] [--out FILE]

Each `--source` is a gauss_step.cu (default: this tree's); give the
parent's and this tree's as parent, this, this, parent to compare them in
one call.  Prints one JSON line (the card's name and power limit, each
build's ms on both sets and its registers from `-Xptxas -v`) and writes
it to build/gauss_step_split.json (and `--out`).  Card only: exits 2
without CUDA.
"""

from __future__ import annotations

import argparse
import ctypes
import gc
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from gps_slam_torch import kernels  # noqa: E402

# the phases each cut takes out: (pattern, replacement), each pattern
# matching the source once
CUTS = {
    "staging": [
        (r"  // ---- 2\. the projection, a lane a row\n.*?"
         r"(?=  // ---- 4\. store the tile's outputs\n)", ""),
        (r"  // ---- 2\. the projection's chain \(warp 0\) beside the SH's \(warp 1\)\n.*?"
         r"(?=  // ---- 3\. store the tile's grads)", ""),
    ],
    "projection": [
        (r"  // ---- 3\. the visible rows' SH, a lane a \(row, channel\).*?"
         r"(?=  // ---- 4\. store the tile's outputs\n)", ""),
        (r"  \} else \{\n    // ---- `sh\.eval_sh_bwd_plain`.*?\n  \}\n(?=  __syncthreads\(\);\n\n"
         r"  // ---- 3\. store the tile's grads)", "  }\n"),
    ],
}
CUT_ORDER = ("staging", "projection", "whole")


def variant(src: str, cut: str) -> str | None:
    """The source with the cut's phases taken out (None: the source has
    not the tiled design's phases)."""
    if cut == "whole":
        return src
    for pattern, text in CUTS[cut]:
        found = list(re.finditer(pattern, src, re.S))
        if len(found) != 1:
            return None
        src = src[:found[0].start()] + text + src[found[0].end():]
    return src


def build(sources: list[Path]) -> dict:
    """nvcc every (source, cut) build at once; (i, cut) -> (fwd, bwd, regs)."""
    out_dir = ROOT / "build" / "gauss_split"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, s in enumerate(sources):
        text = s.read_text()
        for k, cut in enumerate(CUT_ORDER):
            v = variant(text, cut)
            if v is None:
                continue
            cu = out_dir / f"src{i}_cut{k}.cu"
            cu.write_text(v)
            lib = cu.with_suffix(".so")
            cmd = [kernels._nvcc(), *kernels.PROJECT_SH_FWD.nvcc_flags(), "-I", str(s.parent),
                   "-o", str(lib), str(cu)]
            procs[(i, cut)] = (lib, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    res = {}
    for key, (lib, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"gauss step split: nvcc failed on {key}:\n{log}")
        so = ctypes.CDLL(str(lib))
        fns = []
        for k in (kernels.PROJECT_SH_FWD, kernels.PROJECT_SH_BWD):
            fn = getattr(so, k.entry)
            fn.argtypes = k.argtypes
            fn.restype = ctypes.c_int
            fns.append(fn)
        regs = list(dict.fromkeys(ln.strip() for ln in log.splitlines()
                                  if "registers" in ln or "spill" in ln))
        res[key] = (*fns, regs)
    return res


def main_path_inputs(seed: int) -> dict:
    """The wrappers' arguments at the main path's last Adam step."""
    rec = cs.Recorder()
    cams = cs.synthetic_cams(cs.N_FRAMES, 1200, 680)
    args = argparse.Namespace(seed=seed, profile=False)
    cs.run_path(args, cams, cs.ADAM_STEPS, "gauss step split: main path", kernels.INTEGRATE)
    return {"fwd": rec.last["project_sh_fwd"][0], "bwd": rec.last["project_sh_bwd"][0]}


def random_inputs(n: int, seed: int) -> dict:
    """n random rows of SH degree 3 around a 1200x680 camera (some behind
    it, some far to the side, 10% dead) and random cotangents: the draws of
    tests/test_torch_cuda.py's `_gauss_inputs(n, 3, ..., seed)`."""
    from gps_slam_torch.gs import gauss_step as gs
    from gps_slam_torch.gs import model as tmodel
    from gps_slam_torch.gs import projection as tproj
    from gps_slam_torch.utils.se3 import pose_inv

    rng = np.random.default_rng(seed)
    a = 0.2
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
    c2w[:3, 3] = [0.2, -0.1, -0.4]
    z = rng.uniform(-0.5, 5.0, n)
    lat = rng.uniform(-1.0, 1.0, (n, 2)) * np.maximum(z, 0.2)[:, None]
    lat[: n // 8] *= 4.0
    means = np.concatenate([lat, z[:, None]], 1) @ c2w[:3, :3].T + c2w[:3, 3]

    def f(x):
        return torch.as_tensor(np.ascontiguousarray(x, np.float32), device="cuda")

    p = [f(means), f(rng.normal(size=(n, 4))), f(rng.uniform(-6.0, -0.5, (n, 3))),
         f(rng.normal(0, 0.5, (n, 3))), f(rng.normal(0, 0.3, (n, 15, 3)))]
    alive = torch.as_tensor(rng.random(n) > 0.1, device="cuda")
    cot = [f(rng.normal(size=s)) for s in ((n, 2), (n, 3), (n,), (n, 3))]
    K = np.array([[600.0, 0, 599.5], [0, 600.0, 339.5], [0, 0, 1]], np.float32)
    st = tmodel.RenderStatics(width=1200, height=680, sh_degree=3, tile_size=16,
                              max_gs_radii=64, delta_depth=0.1, use_exposure=False,
                              visible_cap=n, tiles_per_gaussian_cap=9, tile_cap=64)
    cam = tproj.camera(K, st.width, st.height)
    c2w_t = f(c2w)
    viewmat = pose_inv(c2w_t)
    fwd = (*p, alive, viewmat, c2w_t, None, cam, st)
    radii = gs.project_sh_fwd_plain(*fwd)[3]
    return {"fwd": fwd, "bwd": (*p, radii, viewmat, c2w_t, None, cam, st, *cot)}


def warm_ms(fn, reps: int) -> float:
    """chip_smoke.time_ms without the L2 flush: mean CUDA-event time of fn
    over `reps` launches, each after a spin of the card (the garbage
    collector off meanwhile, as there)."""
    gc_was = gc.isenabled()
    gc.disable()
    try:
        return _warm_ms(fn, reps)
    finally:
        if gc_was:
            gc.enable()


def _warm_ms(fn, reps: int) -> float:
    fn()
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(reps)]
    for a, b in ev:
        torch.cuda._sleep(cs._HOST_LEAD_CYCLES)
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in ev) / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", action="append", type=Path,
                    help="gauss_step.cu to time (repeatable; default: this tree's)")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path, default=None, help="also write the JSON line here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("gauss_step_split: no CUDA device", file=sys.stderr)
        return 2
    from gps_slam_torch.gs import gauss_step as gs

    sources = [s.resolve() for s in (args.source or [kernels.PROJECT_SH_FWD.path])]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    cs.log(smi)
    kernels.build_all()
    builds = build(sources)
    sets = {"main path, last Adam step": main_path_inputs(args.seed),
            "131072 random rows": random_inputs(131072, 43)}
    shapes = {}
    for name, s in sets.items():
        a = s["fwd"]
        shapes[name] = {"rows": a[0].shape[0], "sh_coeffs": a[4].shape[1] + 1,
                        "sh_degree": a[-1].sh_degree,
                        "visible": int((s["bwd"][5] > 0).sum().item()),
                        "cotangents": sum(v is not None for v in s["bwd"][11:])}
    cs.log("[gauss step split inputs] " + json.dumps(shapes))
    plain = {name: (gs.project_sh_fwd_plain(*s["fwd"]), gs.project_sh_bwd_plain(*s["bwd"]))
             for name, s in sets.items()}
    orig = (kernels.PROJECT_SH_FWD._fn, kernels.PROJECT_SH_BWD._fn)
    ms = {(key, name, k): [] for key in builds for name in sets
          for k in ("fwd", "bwd", "fwd_warm", "bwd_warm")}
    exact = {}
    try:
        for key, (fwd, bwd, _) in builds.items():
            if key[1] != "whole":
                continue
            kernels.PROJECT_SH_FWD._fn, kernels.PROJECT_SH_BWD._fn = fwd, bwd
            for name, s in sets.items():
                outs = (gs.project_sh_fwd(*s["fwd"]), gs.project_sh_bwd(*s["bwd"]))
                torch.cuda.synchronize()
                exact[(key, name)] = all(
                    cs._bits_equal(x, y) for o, p in zip(outs, plain[name]) for x, y in zip(o, p))
        for _ in range(args.reps):
            for key, (fwd, bwd, _) in builds.items():
                kernels.PROJECT_SH_FWD._fn, kernels.PROJECT_SH_BWD._fn = fwd, bwd
                for name, s in sets.items():
                    ms[(key, name, "fwd")].append(
                        cs.time_ms(lambda: gs.project_sh_fwd(*s["fwd"]), 50))
                    ms[(key, name, "bwd")].append(
                        cs.time_ms(lambda: gs.project_sh_bwd(*s["bwd"]), 50))
                    ms[(key, name, "fwd_warm")].append(
                        warm_ms(lambda: gs.project_sh_fwd(*s["fwd"]), 50))
                    ms[(key, name, "bwd_warm")].append(
                        warm_ms(lambda: gs.project_sh_bwd(*s["bwd"]), 50))
    finally:
        kernels.PROJECT_SH_FWD._fn, kernels.PROJECT_SH_BWD._fn = orig
    rows = []
    for (i, cut), (_, _, regs) in builds.items():
        row = {"source": str(sources[i]), "index": i, "cut": cut, "build": regs, "ms": {}}
        for name in sets:
            row["ms"][name] = {k: {"ms": ms[((i, cut), name, k)],
                                   "ms_mean": float(np.mean(ms[((i, cut), name, k)]))}
                               for k in ("fwd", "bwd", "fwd_warm", "bwd_warm")}
            if ((i, cut), name) in exact:
                row["ms"][name]["bit_for_bit"] = exact[((i, cut), name)]
        rows.append(row)
    res = {"device": smi, "inputs": shapes, "reps": args.reps, "rows": rows}
    line = json.dumps(res)
    print(line, flush=True)
    for out in (ROOT / "build" / "gauss_step_split.json", args.out):
        if out is not None:
            out.parent.mkdir(parents=True, exist_ok=True)
            out.write_text(line + "\n")
    bad = [k for k, v in exact.items() if not v]
    if bad:
        print(f"gauss_step_split: not bit for bit with the plain versions: {bad}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
