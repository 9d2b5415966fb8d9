"""ctypes binding of the native marching-tetrahedra mesher — the port's own
copy of gps_slam_tpu/tsdf/native.py.

`native/mesher.cpp` (OpenMP C++, plain C ABI) is built with g++ at first
use into `build/` at the repository root, never in place: the library is
named by a hash of the source, of the g++ flags and of the host's name, so
an edited source or flag is rebuilt, a stale library is never loaded, and
a `-march=native` build is never loaded on another machine than the one
that compiled it.  It is built with
OpenMP where the compiler has OpenMP's support files, else without it
(its pragmas then compile to a serial loop over the blocks).  Each
process builds into a temporary file of its own and moves it into place,
so concurrent builds do not collide.  A failed build raises with g++'s
output; the numpy route of `meshing.extract_mesh(use_native=False)` is
the explicit way to mesh without a compiler.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent.parent
SOURCE = ROOT / "native" / "mesher.cpp"
BUILD = ROOT / "build"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")
# the builds tried in order: with OpenMP, then serial
VARIANTS = (GXX_FLAGS + ("-fopenmp",), GXX_FLAGS)

_lock = threading.Lock()
_LIB = None
_LIB_PATH = None


def lib_path(flags: tuple = VARIANTS[0]) -> Path:
    h = hashlib.sha1(SOURCE.read_bytes())
    h.update("\0".join((*flags, platform.node())).encode())
    return BUILD / f"libmesher_{h.hexdigest()[:12]}.so"


def loaded_path() -> Path | None:
    """The library `load` opened (None before the first load)."""
    return _LIB_PATH


def _build(flags: tuple) -> str | None:
    """Build the variant of `flags`; None on success, else g++'s output."""
    out = lib_path(flags)
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [os.environ.get("CXX", "g++"), *flags, str(SOURCE), "-o", str(tmp)],
        capture_output=True, text=True, timeout=180)
    if proc.returncode != 0:
        return f"{' '.join(flags)}:\n{proc.stderr}"
    os.replace(tmp, out)
    return None


def load():
    """Load the mesher, building it first when no variant is built; raises
    with g++'s output if no variant builds."""
    global _LIB, _LIB_PATH
    with _lock:
        if _LIB is not None:
            return _LIB
        built = [f for f in VARIANTS if lib_path(f).exists()]
        if not built:
            errors = []
            for flags in VARIANTS:
                err = _build(flags)
                if err is None:
                    built = [flags]
                    break
                errors.append(err)
            else:
                raise RuntimeError(f"g++ failed to build {SOURCE.name}:\n" + "\n".join(errors))
        path = lib_path(built[0])
        lib = ctypes.CDLL(str(path))
        lib.extract_mesh.restype = ctypes.c_int64
        lib.extract_mesh.argtypes = [
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int16), ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64, ctypes.c_float, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_int8),
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64,
        ]
        _LIB, _LIB_PATH = lib, path
        return lib


def extract_mesh_native(host: dict, max_probes: int, voxel_size: float,
                        require_weight: bool = True, algo: str = "mt",
                        max_verts: int = 20_000_000):
    """Native mesh extraction of a host copy of the volume (`host`: the
    uint32 `table_keys` [H], int32 `table_ptrs` [H], uint32
    `block_coords`, `state` and `color` of the allocated blocks, see
    `meshing.host_volume`).  Returns (verts [V, 3], colors [V, 3]); a mesh
    of more than `max_verts` vertices is meshed again into a larger buffer
    (the JAX package's binding keeps the first `max_verts`)."""
    from .meshing import _MC_TRI, _state_sdf, unpack_color_np

    lib = load()
    if algo == "mc":
        mc_tri = np.ascontiguousarray(_MC_TRI, np.int8)
    else:
        mc_tri = np.zeros(1, np.int8)
    tk = np.ascontiguousarray(host["table_keys"], np.uint32)
    tp = np.ascontiguousarray(host["table_ptrs"], np.int32)
    bc = np.ascontiguousarray(host["block_coords"], np.uint32)
    st = host["state"]
    sdf = np.ascontiguousarray(_state_sdf(st), np.float32)
    w = np.ascontiguousarray(((st >> 16) & 0xFF).astype(np.int16), np.int16)
    col = np.ascontiguousarray(unpack_color_np(host["color"]), np.uint8)
    n_blocks = st.shape[0]

    def ptr(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    # the C side stops writing at max_verts and returns at most that count;
    # a full buffer may have been cut short, so mesh again into one twice
    # the size until the mesh fits
    while True:
        out_v = np.empty((max_verts, 3), np.float32)
        out_c = np.empty((max_verts, 3), np.float32)
        n = int(lib.extract_mesh(
            ptr(tk, ctypes.c_uint32), ptr(tp, ctypes.c_int32),
            ctypes.c_int64(tk.shape[0]), ctypes.c_int(max_probes),
            ptr(bc, ctypes.c_uint32), ptr(sdf, ctypes.c_float),
            ptr(w, ctypes.c_int16), ptr(col, ctypes.c_uint8),
            ctypes.c_int64(n_blocks), ctypes.c_float(voxel_size),
            ctypes.c_int(1 if require_weight else 0),
            ctypes.c_int(1 if algo == "mc" else 0), ptr(mc_tri, ctypes.c_int8),
            ptr(out_v, ctypes.c_float), ptr(out_c, ctypes.c_float),
            ctypes.c_int64(max_verts),
        ))
        if n < max_verts:
            return out_v[:n].copy(), out_c[:n].copy()
        max_verts *= 2
