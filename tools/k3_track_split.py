#!/usr/bin/env python
"""Where the time of K3's tracking mode goes, step by step, on the card.

Drives chip_smoke.py's tracked path (1200x680, 30 frames of its inward
orbit, ICP, the tracked megastep) to get the inputs of its last
tracking-prepare `march` call, the inputs of chip_smoke.py's
"tracking prepare, 1200x680" [kernel] row.  Then it builds each given
raycast source once per step into build/k3_split/ and times each build on
those inputs, as chip_smoke.time_ms times a [kernel] row (CUDA events, each
launch after an L2 flush and a spin of the card):

  step 0   the launch and step 0 alone (the tile's candidates and mip rows
           to shared memory), then one word out per thread;
  coarse   step 0 and the coarse pass (each pixel's slab tests, mip
           samples and picks), then one word out per thread;
  full     the source as it is (the row copies and the refine too), its
           output compared with the plain version's (`bit_for_bit`);
  full, every live row staged at step 0
           where the source has a tracking kernel of its own, the same
           with every live slot's state row copied at step 0 instead of
           the picked ones after the picks (compared the same way).

The step builds are copies of the source with an exit written in after a
step; the port's source carries no switch for them.  The builds run in
turns (every source and step, `--reps` rounds), so that a slow round
touches them all alike.  Usage, on a machine with the card and nvcc:

    python tools/k3_track_split.py [--source PATH ...] [--reps N]

Each `--source` is a raycast.cu (default: this tree's); headers it
includes are taken from its own directory.  Prints one JSON line per
build and step and the card's name and power limit, and writes them all to
build/k3_track_split.json.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from gps_slam_torch import kernels  # noqa: E402

OUT_WORD = "out[(size_t)tile * 6 * NPIX + p]"
# the exit written in after step 0: every thread writes a word that reads
# what step 0 left in shared memory (so that no load of it is dead code)
STEP0 = (OUT_WORD + " = s_mip[p % (LB * 64)] + s_borg[0][p % LB] + s_maxw[p % LB]"
         " + (float)s_nlive + s_cs[0] + s_fr[0];\n  return;\n")
# the exit written in after the coarse pass and the picks: every thread
# writes a word that reads all of its picks
COARSE = ("{\n  float acc = 0.0f;\n  for (int k = 0; k < MAX_TRACK_K; ++k)\n"
          "    acc += pk[k] + (float)ps[k] + (float)pi[k];\n  " + OUT_WORD
          + " = acc;\n  return;\n}\n")
# where each exit goes: after the line that the first of these patterns
# matches once (the tracking kernel of its own, then the one kernel with
# a `track` argument that came before it), and what the exit is
ANCHORS = {
    "step 0": [
        (r"^  const int kb = k_blocks < LB \? k_blocks : LB;  // a pixel's picks\n", STEP0),
        (r"^  const int kb = k_blocks < LB \? k_blocks : LB;  // later picks find none\n",
         "if (track) {\n" + STEP0 + "}\n"),
    ],
    "coarse": [
        (r"^\s*if \(\(p & 31\) == 0 && picked\) atomicOr\(&s_mask, picked\);\n", COARSE),
    ],
}
# the other way to stage the rows: every live row copied at step 0, so
# that the copies overlap steps 1-3 (their own LB x 2 KiB of shared
# memory; the pairs move past the pair list); written into a tracking
# kernel of its own as (pattern, replacement) pairs, each matching once
EARLY_ROWS = "full, every live row staged at step 0"
EARLY = [
    (r"^  float2\* s_pair = reinterpret_cast<float2\*>\(s_dyn\);.*\n", ""),
    (r"^  float\* s_cs = reinterpret_cast<float\*>\(s_list \+ LB \* NPIX\);.*\n",
     "  float2* s_pair = reinterpret_cast<float2*>(s_list + LB * NPIX);\n"
     "  float* s_cs = reinterpret_cast<float*>(s_pair + LB * NPIX);\n"),
    (r"^  const int nlive = s_nlive;\n",
     "  const int nlive = s_nlive;\n"
     "  if (p == 0) {\n"
     "    tma::mbar_expect_tx(bar, nlive * ROW * 4);\n"
     "    for (int j = 0; j < nlive; ++j) {\n"
     "      const int l = s_live[j];\n"
     "      s_row[l] = l;\n"
     "      tma::bulk_copy(s_rows + l * ROW, state + (size_t)s_gid[l] * ROW, ROW * 4, bar);\n"
     "    }\n  }\n"),
    (r"^  // ---- 4\. stage the picked blocks' state rows \(TMA bulk copies\) ----\n"
     r"  stage_rows\(state, p, s_mask, bar, s_gid, s_row, s_rows\);\n",
     "  tma::mbar_wait(bar, 0);\n"
     "  for (unsigned m = s_mask; m; m &= m - 1) {\n"
     "    int* r = s_rows + (__ffs(m) - 1) * ROW;\n"
     "    for (int i = p; i < ROW; i += NPIX) r[i] = __float_as_int(sdf_of(r[i]));\n"
     "  }\n  __syncthreads();\n"),
    (r"^  const int smem = LB \* SLOT_BYTES \+ \(s_coarse \+ s_refine\) \* 4;\n",
     "  const int smem = LB * SLOT_BYTES + (s_coarse + s_refine) * 4 + (track ? LB * ROW * 4 : 0);\n"),
]
STEPS = ("step 0", "coarse", "full", EARLY_ROWS)


def patched(src: str, patches: list) -> str | None:
    """`src` with each (pattern, replacement) applied, or None unless each
    pattern matches exactly once."""
    for pattern, text in patches:
        found = list(re.finditer(pattern, src, re.M))
        if len(found) != 1:
            return None
        src = src[:found[0].start()] + text + src[found[0].end():]
    return src


def variant(src: str, step: str) -> str | None:
    """The source with its exit after `step` written in (None: the step
    does not apply to this source)."""
    if step == "full":
        return src
    if step == EARLY_ROWS:
        return patched(src, EARLY)
    for pattern, text in ANCHORS[step]:
        found = list(re.finditer(pattern, src, re.M))
        if len(found) == 1:
            return src[:found[0].end()] + text + src[found[0].end():]
    raise RuntimeError(f"{step}: no pattern matches the source once")


def build(sources: list[Path]) -> dict:
    """nvcc every (source, step) build at once; (source, step) -> (path, log)."""
    out_dir = ROOT / "build" / "k3_split"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, s in enumerate(sources):
        text = s.read_text()
        for k, step in enumerate(STEPS):
            v = variant(text, step)
            if v is None:
                cs.log(f"[k3 split] {s}: {step} does not apply")
                continue
            cu = out_dir / f"src{i}_step{k}.cu"
            cu.write_text(v)
            lib = cu.with_suffix(".so")
            cmd = [kernels._nvcc(), *kernels.RAYCAST.nvcc_flags(), "-I", str(s.parent),
                   "-o", str(lib), str(cu)]
            procs[(i, step)] = (lib, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    res = {}
    for key, (lib, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            cs.log(f"[k3 split] nvcc failed on {key}:\n{log}")
            continue
        fn = getattr(ctypes.CDLL(str(lib)), kernels.RAYCAST.entry)
        fn.argtypes = kernels.RAYCAST.argtypes
        fn.restype = ctypes.c_int
        regs = [ln.strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln]
        res[key] = (fn, regs)
    return res


def prepare_inputs(seed: int) -> tuple:
    """`march`'s arguments of the tracked path's last tracking-prepare call."""
    rec = cs.Recorder()
    cams = cs.synthetic_cams(cs.N_FRAMES, 1200, 680, look="in", arc=cs.TRACKED_ARC)
    args = argparse.Namespace(seed=seed, profile=False)
    cs.run_path(args, cams, cs.ADAM_STEPS, "tracked path", kernels.INTEGRATE, tracked=rec)
    a, kw = rec.last["tracking prepare"]
    need_color = a[10] if len(a) > 10 else kw.get("need_color", True)
    return (*a[:10], need_color)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", action="append", type=Path,
                    help="raycast.cu to split (repeatable; default: this tree's)")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k3_track_split: no CUDA device", file=sys.stderr)
        return 2
    from gps_slam_torch.tsdf import raycast_tiles as trc

    sources = [s.resolve() for s in (args.source or [kernels.RAYCAST.path])]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    cs.log(smi)
    kernels.build_all()
    builds = build(sources)
    margs = prepare_inputs(args.seed)
    plain = cs.plain_march(*margs, track=True)
    gids = margs[0]
    work = cs.march_work(margs, True)
    shapes = {"T": gids.shape[0], "LB": gids.shape[1],
              "valid_slots": int((gids >= 0).sum().item()),
              "hit_pairs": work["hit_pairs"], "picks": work["picks"],
              "picked_rows": work["picked_rows"],
              "hit_pixels": int((plain[:, 5] > 0).sum().item())}
    cs.log("[k3 split inputs] " + json.dumps(shapes))
    orig = kernels.RAYCAST._fn
    ms = {key: [] for key in builds}
    try:
        exact = {}
        for (i, step), (fn, _) in builds.items():
            if step in ("full", EARLY_ROWS):
                kernels.RAYCAST._fn = fn
                exact[(i, step)] = bool(torch.equal(trc.march(*margs, track=True), plain))
        for _ in range(args.reps):
            for key in builds:
                kernels.RAYCAST._fn = builds[key][0]
                ms[key].append(cs.time_ms(lambda: trc.march(*margs, track=True), 20))
    finally:
        kernels.RAYCAST._fn = orig
    rows = []
    for (i, step), t in ms.items():
        row = {"source": str(sources[i]), "step": step, "ms": t,
               "ms_mean": sum(t) / len(t), "build": builds[(i, step)][1]}
        if (i, step) in exact:
            row["bit_for_bit"] = exact[(i, step)]
        rows.append(row)
        cs.log("[k3 split] " + json.dumps(row))
    res = {"device": smi, "shapes": shapes, "rows": rows}
    out = ROOT / "build" / "k3_track_split.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
