"""Capturing the port's CUDA graphs, and counting what a capture holds.

`capture(graph)` opens `torch.cuda.graph(graph)` with the garbage
collector run first and held off, and `node_counts` counts a captured
graph's nodes, its conditional ones apart (chip_smoke.py reports those:
none, since each tracker level's Gauss-Newton loop is one cooperative
launch of a hand-written kernel whose exit test stays on the device,
`slam/icp_gn.py` and `slam/color_gn.py`, and a captured level is one
kernel node).
"""

from __future__ import annotations

import contextlib
import ctypes
import gc

import torch

# cuda.h's CU_GRAPH_NODE_TYPE_CONDITIONAL
_NODE_CONDITIONAL = 13


def versions() -> str:
    """The CUDA driver's version and torch's CUDA build."""
    drv = ctypes.c_int(0)
    ctypes.CDLL("libcuda.so.1").cuDriverGetVersion(ctypes.byref(drv))
    return f"CUDA driver {drv.value}, torch {torch.__version__} built for CUDA {torch.version.cuda}"


@contextlib.contextmanager
def capture(graph: torch.cuda.CUDAGraph):
    """`torch.cuda.graph(graph)`.  The garbage collector runs before the
    capture and is off during it: a collection inside the capture that
    frees another graph (one held by a dead reference cycle) destroys it
    there, which the runtime forbids while a stream captures, and the
    capture is lost."""
    gc.collect()
    gc_was = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph):
            yield
    finally:
        if gc_was:
            gc.enable()


def node_counts(graph: torch.cuda.CUDAGraph) -> dict:
    """The nodes of a graph captured with `keep_graph=True`, before it is
    instantiated: all of them and the conditional ones.  Read through the
    CUDA driver API (libcuda), which counts a graph holding any node
    type."""
    cu = ctypes.CDLL("libcuda.so.1")
    g, n = ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.c_size_t(0)
    err = cu.cuGraphGetNodes(g, None, ctypes.byref(n))
    nodes = (ctypes.c_void_p * n.value)()
    if err == 0:
        err = cu.cuGraphGetNodes(g, nodes, ctypes.byref(n))
    types = []
    for node in nodes if err == 0 else ():
        t = ctypes.c_int(-1)
        err = err or cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(t))
        types.append(t.value)
    if err != 0:
        raise RuntimeError(f"counting a graph's nodes failed with CUresult {err}; "
                           f"{versions()}")
    return {"nodes": n.value, "conditional": types.count(_NODE_CONDITIONAL)}
