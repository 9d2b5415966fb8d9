"""A run of a cell from start to result: drive the program, read the
metrics by name, check the check step against the references, and
assemble the result line."""

from __future__ import annotations

import json
import os
import tempfile
import time

from . import check as pbcheck
from .cell import Cell, load_metric
from .runner import Run


def read_metrics(cell: Cell, rec: dict, trace: bool) -> dict:
    """Each metric of the cell for this kind of run, read by
    perfbench/metrics/<name>.py; a reader that finds nothing to read
    returns None and the metric is left out."""
    out = {}
    for m in cell.metrics(trace):
        v = load_metric(m["name"], cell.root / "perfbench")(rec)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def drive(cell: Cell, seed: int, seconds: float, trace: bool, device,
          t_process: float) -> tuple:
    """Drive one run of `cell` to its end: (record, memory peak, the
    check's context, the check's snapshots), the program's objects
    released."""
    workspace = os.path.join(tempfile.gettempdir(), "perfbench_ws")
    run = Run(cell, seed, seconds, trace, device, workspace, t_process)
    run.drive()
    rec = run.record()
    ctx = pbcheck.Context(cfg=run.cfg, cfg_dict=run.cfg_dict, store=run.store,
                          K=run.K, width=run.W, height=run.H, tracked=run.tracked,
                          seed=seed)
    mem = run.memory_peak
    return rec, mem, ctx, run.release()


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_process: float) -> tuple[dict, list[str]]:
    """(result dict, the check's lines)."""
    rec, mem, ctx, snap = drive(cell, seed, seconds, trace, device, t_process)
    t_check = time.perf_counter()
    extra = {}
    checks = pbcheck.run(ctx, snap, extra)
    rec["diag"]["check_s"] = time.perf_counter() - t_check
    # what a window's numbers were taken over: each step's loss on both
    # sides, each attribute's gap
    rec["diag"]["check_window"] = {k: v for k, v in extra.items()
                                   if k.startswith("window_") and "@" not in k}
    # the render's gaps over every pixel, and the share of pixels left out
    rec["diag"]["check_render"] = {k: v for k, v in extra.items()
                                   if k.startswith("render_")
                                   and ("@" not in k or k.endswith("_all@0.999"))}
    out = {"correct": all(c["ok"] for c in checks),
           "attempted": rec["window"]["frames"], "failed": 0,
           "metrics": read_metrics(cell, rec, trace),
           "device": {"memory_peak_bytes": mem}}
    if trace and "trace" in rec:
        t = rec["trace"]
        out["device"].update(busy_s=t["busy_s"], window_s=t["window_s"])
        out["breakdown"] = {"device_ops": t["device_ops"], "idle_gaps": t["idle_gaps"]}
    out["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    lines = [f"check {c['name']}: {c['value']!r} (limit {c['limit']!r}) "
             f"{'ok' if c['ok'] else 'FAIL'}" for c in checks]
    lines.insert(0, "diag " + json.dumps(rec["diag"]))
    lines.append(f"correct: {out['correct']}")
    return out, lines
