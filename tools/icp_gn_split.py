#!/usr/bin/env python
"""Where the time of icp_gn_cuda goes, kernel by kernel, on the card.

Makes one tracking step at 1200x680 (tests/test_torch_cuda.py's
`icp_levels`: frame 0's world vertices and normals, frame 1's depth
pyramid, frame 1's pose perturbed by a small twist), runs iteration 0 of
each pyramid level with this tree's kernel, then builds each given
icp_gn.cu into build/icp_gn_split/ and, from the state iteration 0 left
at each level:

  * holds the new state, iteration count and loop test, and the per-CTA
    rows, bit for bit against the plain version (`bit_for_bit`);
  * times the launch with CUDA events as chip_smoke.py's [kernel] rows do
    (each launch after an L2 flush and a spin of the card, the state
    restored before it, outside the events): `ms`;
  * and by torch.profiler's device time of each of its kernels (named
    gn_*) over the same launches, without the flush: `<kernel>_ms`.

A source must take the wrapper's arguments and scratch
(`icp_gn.rounds`, `n_ctas`, `partials_buffer`) as this tree's does.

The builds run in turns (every source at a level, then the next level,
`--reps` rounds), so that a slow round touches them all alike.  Usage, on
a machine with the card and nvcc:

    python tools/icp_gn_split.py [--source PATH ...] [--reps N] [--max-ctas N]

Prints one JSON line per source and level and the card's name and power
limit, and writes them all to build/icp_gn_split.json.
"""

from __future__ import annotations

import argparse
import ctypes
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
from gps_slam_torch.data import synthetic  # noqa: E402
from gps_slam_torch.slam import icp_gn  # noqa: E402
from gps_slam_torch.slam import tracker as ttrk  # noqa: E402
from gps_slam_torch.utils import se3 as tse3  # noqa: E402


def levels(dev) -> list:
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


def build(sources: list[Path]) -> list:
    """nvcc every source at once; per source (the C entry, ptxas lines)."""
    out_dir = ROOT / "build" / "icp_gn_split"
    out_dir.mkdir(parents=True, exist_ok=True)
    k = kernels.ICP_GN
    procs = []
    for i, s in enumerate(sources):
        lib = out_dir / f"src{i}.so"
        cmd = [kernels._nvcc(), *k.nvcc_flags(), "-o", str(lib), str(s)]
        procs.append((lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True)))
    res = []
    for lib, p in procs:
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{log}")
        fn = getattr(ctypes.CDLL(str(lib)), k.entry)
        fn.argtypes = k.argtypes
        fn.restype = ctypes.c_int
        res.append((fn, [ln.strip() for ln in log.splitlines()
                         if "registers" in ln or "spill" in ln]))
    return res


def profiled_split(run, before, reps: int) -> dict:
    """Device ms per launch of each of the source's kernels (named gn_*)
    over `reps` launches."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            before()
            run()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        name = re.search(r"\b(gn_\w+)", e.key)
        if name:
            out[name.group(1) + "_ms"] = (getattr(e, "self_device_time_total", 0.0)
                                          / 1e3 / reps)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", action="append", type=Path,
                    help="icp_gn.cu to time (repeatable; default: this tree's)")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--max-ctas", type=int, default=icp_gn.MAX_CTAS,
                    help="the grid's cap (icp_gn.MAX_CTAS), for every source")
    args = ap.parse_args()
    icp_gn.MAX_CTAS = args.max_ctas
    if not torch.cuda.is_available():
        print("icp_gn_split: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    sources = [s.resolve() for s in (args.source or [kernels.ICP_GN.path])]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    cs.log(smi)
    kernels.build_all()
    builds = build(sources)
    own = kernels.ICP_GN._fn
    rows = {}
    for lvl, largs in enumerate(levels(dev)):
        T0, d, vw, nw, cam, budget, rot, rpi, st, tc = largs
        lv = ttrk._StaticLevel(*largs)   # iteration 0, this tree's kernel
        inputs = (d, vw, nw, cam, rpi, st, tc, rot, budget, ttrk._STEP_EXIT)
        s0, r0, m0 = lv.state.clone(), lv.n_run.clone(), lv.more.clone()
        ps, pr, pm = s0.clone(), r0.clone(), m0.clone()
        icp_gn.iterate_plain(*inputs, ps, pr, pm)
        pts, has_depth = icp_gn.level_points(d, cam)
        x = icp_gn.terms(s0[:16].view(4, 4), pts, has_depth, vw, nw, cam, rpi, st, tc, rot)
        cta_rows = icp_gn.cta_rows(x)
        s, n, m, p = s0.clone(), r0.clone(), m0.clone(), lv.partials.clone()

        def restore():
            s.copy_(s0)
            n.copy_(r0)
            m.copy_(m0)

        for rep in range(args.reps):
            for i, (fn, regs) in enumerate(builds):
                kernels.ICP_GN._fn = fn
                try:
                    run = lambda: icp_gn.iterate(*inputs, s, n, m, p)
                    restore()
                    run()
                    torch.cuda.synchronize()
                    exact = (torch.equal(s, ps) and torch.equal(n, pr) and torch.equal(m, pm)
                             and torch.equal(p[:-1].view(icp_gn.N_TERMS, -1).T, cta_rows))
                    ms = cs.time_ms(run, 50, before=restore)
                    split = profiled_split(run, restore, 50)
                finally:
                    kernels.ICP_GN._fn = own
                r = rows.setdefault((i, lvl), {
                    "source": str(sources[i].relative_to(ROOT) if sources[i].is_relative_to(ROOT)
                                  else sources[i]),
                    "level": lvl, "h": d.shape[0], "w": d.shape[1], "max_ctas": icp_gn.MAX_CTAS,
                    "ctas": icp_gn.n_ctas(d.numel()),
                    "pixels_per_thread": icp_gn.PIX * icp_gn.rounds(d.numel()),
                    "build": regs, "bit_for_bit": True, "ms": []})
                r["bit_for_bit"] = r["bit_for_bit"] and exact
                r["ms"].append(ms)
                for k, v in split.items():
                    r.setdefault(k, []).append(v)
    out = []
    for r in rows.values():
        r["ms_mean"] = float(np.mean(r["ms"]))
        cs.log("[icp_gn split] " + json.dumps(r))
        out.append(r)
    (ROOT / "build").mkdir(exist_ok=True)
    (ROOT / "build" / "icp_gn_split.json").write_text(json.dumps({"card": smi, "rows": out}))
    return 0 if all(r["bit_for_bit"] for r in out) else 1


if __name__ == "__main__":
    sys.exit(main())
