"""Build, load and count the hand-written CUDA kernels.

Each kernel lives in one `csrc/*.cu` file with a plain C entry point.  The
first call that needs a kernel compiles every source with `nvcc` for
sm_90a into `build/` at the repository root (one `nvcc` process per
source, all started together) and loads the shared libraries with
`ctypes`.  Libraries are named by a hash of their source, so an edited
source is rebuilt and a stale library is never loaded.

Every C entry returns `cudaGetLastError()` after its launch; `check`
raises when it is not 0.  Each kernel carries a launch counter that its
wrapper bumps by one per launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent.parent / "build"
# -fmad=false: no multiply-add contraction, so each kernel rounds exactly
# like its plain PyTorch version (which runs one op per elementwise pass)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]


class Kernel:
    """One CUDA source, its C entry point and its launch count."""

    def __init__(self, name: str, source: str, entry: str, argtypes: list):
        self.name = name
        self.source = source
        self.entry = entry
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None

    @property
    def path(self) -> Path:
        return CSRC / self.source

    def lib_path(self) -> Path:
        digest = hashlib.sha1(self.path.read_bytes()).hexdigest()[:12]
        return BUILD / f"lib{self.path.stem}_{digest}.so"

    @property
    def fn(self):
        if self._fn is None:
            build_all()
        return self._fn


P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float

INTEGRATE = Kernel(
    "integrate_cuda", "integrate.cu", "integrate_packed",
    [P, P, P, P, P, P, P, I, I, I, I, F, F, F, F, F, F, I,
     F, F, F, F, F, F, F, F, F, F, F, F, P])
RAYCAST = Kernel(
    "raycast_cuda", "raycast.cu", "raycast_march",
    [P, P, P, P, P, P, I, I, I, I, I, I, I, I] + [F] * 20 + [P])
SPLAT_FWD = Kernel(
    "splat_fwd_cuda", "splat_fwd.cu", "splat_fwd",
    [P, P, P, P, P, P, I, I, I, I, F, P])
SPLAT_BWD = Kernel(
    "splat_bwd_cuda", "splat_bwd.cu", "splat_bwd",
    [P, P, P, P, P, P, P, I, I, I, I, F, P])

ALL = (INTEGRATE, RAYCAST, SPLAT_FWD, SPLAT_BWD)
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
        for k in todo:
            out = k.lib_path()
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(k.path)]
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


def reset_counts() -> None:
    for k in ALL:
        k.launches = 0


def counts() -> dict[str, int]:
    return {k.name: k.launches for k in ALL}


def stream_ptr() -> int:
    import torch

    return torch.cuda.current_stream().cuda_stream
