"""Build, load and count the hand-written CUDA kernels.

Each kernel lives in one `csrc/*.cu` file with a plain C entry point (two
kernels may share a file, each with its own entry).  The
first call that needs a kernel compiles every source with `nvcc` for
sm_90a into `build/` at the repository root (one `nvcc` process per
source, all started together) and loads the shared libraries with
`ctypes`.  Libraries are named by a hash of their source, of the `csrc/`
headers it includes and of their nvcc flags, so an edited source, header
or flag is rebuilt and a stale library is never loaded.

Every C entry returns `cudaGetLastError()` after its launch; `check`
raises when it is not 0.  Each kernel carries a launch counter that its
wrapper bumps by one per launch.  A source may export C entries besides
its launch (`Kernel.extra`, loaded into `Kernel.extra_fns`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent.parent / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# no multiply-add contraction, so a kernel rounds exactly like its plain
# PyTorch version (which runs one op per elementwise pass): every kernel
# but K5, which sums its pixels in another order than its plain version
# and is held to a tolerance, not to its bits
EXACT = ("-fmad=false",)
_LOCAL_INCLUDE = re.compile(r'^\s*#include\s+"([^"]+)"', re.M)


class Kernel:
    """One CUDA source, its C entry point and its launch count."""

    def __init__(self, name: str, source: str, entry: str, argtypes: list,
                 design: str, flags: tuple = EXACT, extra: dict | None = None):
        self.name = name
        self.source = source
        self.entry = entry
        self.argtypes = argtypes
        self.design = design  # one line, printed beside each measurement
        self.flags = tuple(flags)  # nvcc flags of this kernel alone
        self.launches = 0
        self._fn = None
        # the source's other C entries: name -> (argtypes, restype)
        self.extra = dict(extra or {})
        self.extra_fns: dict = {}

    @property
    def path(self) -> Path:
        return CSRC / self.source

    def nvcc_flags(self) -> list[str]:
        return [*NVCC_FLAGS, *self.flags]

    def lib_path(self) -> Path:
        src = self.path.read_bytes()
        h = hashlib.sha1(src)
        # the local headers the source includes (`#include "x.cuh"`, found
        # beside it in csrc/) take part in the name, one level deep, and
        # so do the flags it is built with
        for name in _LOCAL_INCLUDE.findall(src.decode()):
            h.update((CSRC / name).read_bytes())
        h.update("\0".join(self.nvcc_flags()).encode())
        return BUILD / f"lib{self.path.stem}_{h.hexdigest()[:12]}.so"

    @property
    def fn(self):
        if self._fn is None:
            build_all()
        return self._fn

    def extra_fn(self, name: str):
        """The source's C entry `name` of `extra`, built and loaded."""
        self.fn
        return self.extra_fns[name]


P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float

INTEGRATE = Kernel(
    "integrate_cuda", "integrate.cu", "integrate_packed",
    [P] * 8 + [I, I, I] + [F] * 6 + [I, P],
    "128 threads per block, 4 x-voxels each as 16-byte words loaded first; "
    "anchor and mip by shuffles, one barrier")
INTEGRATE_F32 = Kernel(
    "integrate_f32_cuda", "integrate_f32.cu", "integrate_f32",
    [P] * 13 + [I, I, I] + [F] * 6 + [I, P],
    "256 threads per row, 2 x-voxels each; valid first, old planes as "
    "8-byte words loaded next; anchor by shuffles, no barrier; streaming stores")
RAYCAST = Kernel(
    "raycast_cuda", "raycast.cu", "raycast_march",
    [P] * 7 + [I] * 8 + [F] * 8 + [P],
    "coarse once per (quad, block) pair; picked rows staged by TMA, "
    "sdf decoded once")
# the design of raycast_cuda's tracking mode (`track`, a kernel of its own
# in the same source), printed beside its measurements
RAYCAST_TRACK_DESIGN = ("tracking mode: a division-free slab bound per (pixel, "
                        "block) pair, then the pairs that may hit spread over "
                        "the CTA (exact slab test, mip samples to the first "
                        "negative); k picks a pixel in registers; picked rows "
                        "staged by TMA; two bracket stages, each to its first "
                        "crossing, reusing stage 1's samples")
SPLAT_FWD = Kernel(
    "splat_fwd_cuda", "splat_fwd.cu", "splat_fwd",
    [P, P, P, P, P, P, I, I, I, I, F, P],
    "live rows staged by TMA; 4 pixels per thread; a tile with no live slot "
    "writes zeros and exits")
SPLAT_BWD = Kernel(
    "splat_bwd_cuda", "splat_bwd.cu", "splat_bwd",
    [P, P, P, P, P, P, P, I, I, I, I, F, P],
    "live slots compacted, planes and live rows staged by TMA; (slot, pixel "
    "chunk) items balanced over 128 threads, chunk sums in fixed order; "
    "contraction on; a tile with no live slot writes zeros and exits",
    flags=("-fmad=true",))

ICP_GN = Kernel(
    "icp_gn_cuda", "icp_gn.cu", "icp_gn", [P] * 11 + [I] * 10 + [F, I, P],
    "a pyramid level's Gauss-Newton loop in one cooperative launch: 2 pixels a "
    "thread a round, a warp's 45 sums by an xor transpose, per-CTA f64 rows, a grid "
    "barrier (one atomic a CTA); every CTA sums the rows in the same order and one "
    "warp takes the LM step (LU a row a lane), pass after pass",
    extra={"icp_gn_capacity": ([P], ctypes.c_int)})

COLOR_GN = Kernel(
    "color_gn_cuda", "color_gn.cu", "color_gn", [P] * 11 + [I] * 9 + [F, I, P],
    "a colour pyramid level's Gauss-Newton loop in one cooperative launch, "
    "icp_gn_cuda's design: 2 points a thread a round, a warp's 44 sums by an xor "
    "transpose, per-CTA f64 rows, a grid barrier; every CTA sums the rows in the "
    "same order and one warp takes the colour LM step, pass after pass",
    extra={"color_gn_capacity": ([P], ctypes.c_int)})

# kernels A and B of an Adam step share one source (one library, two
# entries, two counters)
PROJECT_SH_FWD = Kernel(
    "project_sh_fwd_cuda", "gauss_step.cu", "project_sh_fwd",
    [P] * 14 + [I] * 6 + [F] * 12 + [P],
    "64 rows a CTA of 64 threads, staged through shared memory by coalesced "
    "16-byte loads and stores; a lane a row: camera point, covariance, clamped "
    "Jacobian, conic, radius and cull; then a lane a visible (row, channel): its "
    "SH read at once (a culled row's not read); instanced per SH degree")
PROJECT_SH_BWD = Kernel(
    "project_sh_bwd_cuda", "gauss_step.cu", "project_sh_bwd",
    [P] * 18 + [I] * 3 + [F] * 9 + [P],
    "32 rows a CTA of 2 warps, staged through shared memory by coalesced 16-byte "
    "loads and stores; warp 0 a lane a row: the projection recomputed and its "
    "chain back; beside it warp 1 a lane a row: the SH grads of its three "
    "channels and the view term; every row's SH read; instanced per SH degree")
WINDOW_ADAM = Kernel(
    "window_adam_cuda", "window_adam.cu", "window_adam", [P, P, I, P],
    "one thread an element over the attributes laid end to end; pointers, "
    "sizes and learning rates by value in the launch's arguments")

ALL = (INTEGRATE, INTEGRATE_F32, RAYCAST, SPLAT_FWD, SPLAT_BWD, ICP_GN, COLOR_GN,
       PROJECT_SH_FWD, PROJECT_SH_BWD, WINDOW_ADAM)
_lock = threading.Lock()
build_log: dict[str, str] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), "/usr/local/cuda/bin/nvcc", "nvcc"):
        if cand and (os.path.sep not in cand or os.path.exists(cand)):
            return cand
    raise RuntimeError("nvcc not found")


def build_all() -> None:
    """Compile (in parallel) and load every kernel that is not loaded yet."""
    with _lock:
        todo = [k for k in ALL if k._fn is None]
        if not todo:
            return
        BUILD.mkdir(parents=True, exist_ok=True)
        procs = []
        building = set()   # a source of several kernels is built once
        for k in todo:
            out = k.lib_path()
            if out.exists() or out in building:
                continue
            building.add(out)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *k.nvcc_flags(), "-o", str(tmp), str(k.path)]
            procs.append((k, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        errors = []
        for k, out, tmp, proc in procs:
            log, _ = proc.communicate()
            build_log[k.name] = log
            if proc.returncode != 0:
                errors.append(f"{k.source}:\n{log}")
            else:
                os.replace(tmp, out)
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        for k in todo:
            lib = ctypes.CDLL(str(k.lib_path()))
            fn = getattr(lib, k.entry)
            fn.argtypes = k.argtypes
            fn.restype = ctypes.c_int
            for name, (argtypes, restype) in k.extra.items():
                extra = getattr(lib, name)
                extra.argtypes, extra.restype = argtypes, restype
                k.extra_fns[name] = extra
            k._fn = fn


def check(kernel: Kernel, err: int) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{kernel.name}: CUDA launch failed with error {err}")


def check_tensor(kernel: Kernel, name: str, t, dtype, shape=None) -> None:
    """Raise ValueError unless `t` is what the C entry points take: a
    contiguous CUDA tensor of `dtype` (and of `shape`, when given)."""
    if t.device.type != "cuda":
        raise ValueError(f"{kernel.name}: {name} must be a CUDA tensor")
    if t.dtype != dtype:
        raise ValueError(f"{kernel.name}: {name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{kernel.name}: {name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{kernel.name}: {name} shape {tuple(t.shape)} != {tuple(shape)}")


def pose_rows(m):
    """The rows [R | t] of a 4 x 4 (or 3 x 4) pose as the contiguous f32
    3 x 4 that the integrate and raycast kernels read from the device.
    Built on the pose's own device: a wrapper never reads a pose back to
    the host."""
    import torch

    return m[:3].to(torch.float32).contiguous()


def reset_counts() -> None:
    for k in ALL:
        k.launches = 0


def counts() -> dict[str, int]:
    return {k.name: k.launches for k in ALL}


def stream_ptr() -> int:
    import torch

    return torch.cuda.current_stream().cuda_stream
