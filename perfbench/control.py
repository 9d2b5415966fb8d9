#!/usr/bin/env python3
"""The readings that the check's limits are set from, on the card.

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 [--seconds 2] [--control]
        [--fault <name>] [--render-poses N]

For each seed, in one process: a run of the cell with a short window at
the cell's own sizes, its check step, the numbers the check compares for
the program and, with --control, for the control (the reference computed
in bfloat16 put in the program's place), each with the quantiles they
were chosen among; with --fault, with that fault planted (faults.py);
with --render-poses, the render numbers of the pool the check step's
window left at N more poses of the orbit, as many more readings of the
render's comparison a seed.
One JSON line per seed, side and pose on standard output.
The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
for p in (str(ROOT), str(HERE)):
    if p not in sys.path:
        sys.path.insert(0, p)


# the frames between two of --render-poses's poses (a tenth of an orbit)
POSE_STRIDE = 60


def sweep_renders(run, n: int) -> list[dict]:
    """The program's eval render of its pool after the check step at the
    poses of the n frames POSE_STRIDE, 2 POSE_STRIDE, ... before the step's
    last, over those frames' depths and a black base layer."""
    import torch

    last = run.snap["after"]["frames"][-1]
    out = []
    base = torch.zeros((run.H, run.W, 3), device=run.device)
    for j in range(1, n + 1):
        k = last - j * POSE_STRIDE
        _, depth = run.store.f32(k)
        pose = run.store.pose(k)
        with torch.no_grad():
            res = run.model.forward(pose, run.K, depth, base)
        out.append({"frame": k, "pose": pose, "depth": depth, "rgb": res["rgb"].clone(),
                    "alpha": res["alpha"].clone()})
    return out


def readings(cell, seed: int, seconds: float, control: bool, device="cuda",
             faults=(), render_poses: int = 0) -> list[dict]:
    """The check's numbers of one run of `cell` (a short window), for the
    program and, with `control`, for the control; `faults` planted under
    the timed path (faults.py), undone before it returns; with
    `render_poses`, the render numbers at that many more poses."""
    import torch

    import faults as pbfaults
    from pbench import check as pbcheck, result

    undo = []

    def patch(obj, name, value):
        undo.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    drive_run = result.Run

    class ReadRun(drive_run):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            if faults:
                pbfaults.plant(self, faults, patch)

        def _on_done(self):
            super()._on_done()
            if render_poses and "render" in self.snap["after"]:
                self.snap["sweep"] = sweep_renders(self, render_poses)

    result.Run = ReadRun
    try:
        _, _, ctx, snap = result.drive(cell, seed, seconds, False, device,
                                       time.perf_counter())
    finally:
        result.Run = drive_run
        for obj, name, value in reversed(undo):
            setattr(obj, name, value)
    torch.manual_seed(seed)
    out = []
    for side in (("program", "control") if control else ("program",)):
        extra = {}
        t = time.perf_counter()
        vals = (pbcheck.numbers(ctx, snap, extra) if side == "program"
                else pbcheck.control_numbers(ctx, snap, extra=extra))
        out.append({"workload": cell.name, "seed": seed, "side": side,
                    "faults": sorted(faults), "numbers": vals,
                    "fails": [c["name"] for c in pbcheck.judge(vals) if not c["ok"]],
                    "quantiles": extra, "check_s": time.perf_counter() - t})
    pool = snap["after"]["render"]["pool"] if "sweep" in snap else None
    for r in snap.get("sweep", ()):
        for side in (("program", "control") if control else ("program",)):
            extra = {}
            other = pbcheck.render_of(r["rgb"], r["alpha"]) if side == "program" else None
            vals = pbcheck.render_check(ctx, pool, r["pose"], r["depth"], other,
                                        torch.bfloat16, extra)
            out.append({"workload": cell.name, "seed": seed, "side": side,
                        "frame": r["frame"], "numbers": vals,
                        "fails": [c["name"] for c in pbcheck.judge(vals) if not c["ok"]],
                        "quantiles": {k: v for k, v in extra.items()
                                      if "@" not in k or k.endswith("@0.999")}})
    del snap, ctx
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", action="append", default=[],
                    help="a fault of faults.py to plant (repeatable)")
    ap.add_argument("--render-poses", type=int, default=0,
                    help="render numbers at this many more poses of the orbit")
    args = ap.parse_args(argv)
    import torch

    import run  # the benchmark's environment: its caches, its threads
    from pbench.cell import Cell

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    cell = Cell(args.workload, ROOT)
    for s in args.seeds.split(","):
        for line in readings(cell, int(s), args.seconds, args.control, faults=args.fault,
                             render_poses=args.render_poses):
            print(json.dumps(line), flush=True)
    found = run.forbidden_modules()
    if found:
        print(f"control: the runs loaded {found}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
