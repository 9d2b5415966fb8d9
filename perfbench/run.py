#!/usr/bin/env python3
"""The benchmark of gps_slam_torch: one cell of BENCHMARK.json, one run.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Streams the cell's RGB-D frames (made on the card from --seed) through
`SLAMPipeline.slam_train_cams` in a closed loop: set-up runs the first
frames of the stream (the kernels' build, the graphs' captures, the
first windows), the timed window continues the same stream for --seconds
and ends at the first step boundary after them.  With --trace 1 a
profiled slice of steps follows the window.  Then one more step of the
stream is checked against the plain references in perfbench/ref/, and
the last line of standard output is the result as JSON.  Needs an NVIDIA
card: without one it exits 2 and prints no result.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# the kernel caches stay inside the checkout, at fixed paths
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
os.environ["USE_FLAX"] = "0"
# one process with few threads: the loop's host work is one Python thread,
# and idle pool threads only add jitter
os.environ["OMP_NUM_THREADS"] = "2"
for p in (str(ROOT), str(HERE)):
    if p not in sys.path:
        sys.path.insert(0, p)

FORBIDDEN = ("jax", "jaxlib", "flax", "gps_slam_tpu")


def forbidden_modules(names=None) -> list[str]:
    """Loaded modules (or `names`) whose top-level name, the part before
    the first dot, is JAX's or the JAX package's, compared whole."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    torch.set_num_threads(int(os.environ["OMP_NUM_THREADS"]))
    from pbench import result
    from pbench.cell import Cell

    if not torch.cuda.is_available():
        print("perfbench: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    cell = Cell(args.workload, ROOT)
    chips = int(cell.workload["chips"])
    if torch.cuda.device_count() < chips:
        print(f"perfbench: {args.workload} needs {chips} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    out, check_lines = result.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                                       "cuda", T_PROCESS)
    found = forbidden_modules()
    if found:
        print(f"perfbench: the run loaded {found}", file=sys.stderr)
        return 3
    out["device"].update(platform="gpu", kind=torch.cuda.get_device_name(0), count=chips)
    for line in check_lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
