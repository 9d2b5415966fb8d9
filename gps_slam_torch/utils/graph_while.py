"""The JAX `lax.while_loop` in a CUDA graph: a conditional WHILE node.

A captured graph replays a fixed list of launches; a loop whose exit the
device decides (the tracker's Gauss-Newton levels) needs a conditional
node, whose body graph runs again while a handle set on the device is
non-zero.  `capture(graph)` opens `torch.cuda.graph(graph)` so that
`while_loop(flag, body)` may add such nodes to it: the node runs `body()`
while the 0-d bool `flag` holds, read on the device before the first pass
and after each one (the body rewrites it).  The node, its handle and the
kernel that sets the handle come from `csrc/graph_while.cu` (kernel
`graph_while_cuda`): the PyTorch builds the port runs on have no helper
for conditional nodes.

The body is captured once, on a stream of its own (`body_stream`), into
the node's body graph.  The allocator's filter of the graph's own pool
admits only the capturing stream, so the body's temporaries come from a
memory pool of their own (`body_pool`), made once per device and kept
for the process (a pool freed while a capture is underway aborts the
allocator): nothing but a WHILE body allocates from it.  The bodies of
all graphs share it, which is safe because a body's temporaries are dead
once its pass ends and the graphs replay one at a time on one stream; so
the body must write what outlives a pass into tensors allocated before
the loop.  A body launches hand-written kernels only (the tracker's
`icp_gn_cuda`, loaded before the capture by
`tsdf/engine._before_tracked_capture`): no library handle is made inside
it.
"""

from __future__ import annotations

import contextlib
import ctypes
import gc
import threading
from dataclasses import dataclass, field

import torch

from .. import kernels

# cuda.h's CU_GRAPH_NODE_TYPE_CONDITIONAL
_NODE_CONDITIONAL = 13
_local = threading.local()
_streams: dict = {}
_pools: dict = {}


@dataclass
class Capture:
    """The WHILE nodes a capture added, and each body's node count."""

    while_nodes: int = 0
    body_nodes: list = field(default_factory=list)


def versions() -> str:
    """The CUDA runtime and CUDA driver versions, and torch's CUDA build."""
    rt, drv = ctypes.c_int(0), ctypes.c_int(0)
    kernels.GRAPH_WHILE.extra_fn("graph_while_versions")(ctypes.byref(rt), ctypes.byref(drv))
    return (f"CUDA runtime {rt.value}, CUDA driver {drv.value}, torch {torch.__version__} "
            f"built for CUDA {torch.version.cuda}")


def _check(err: int, what: str) -> None:
    if err != 0:
        k = kernels.GRAPH_WHILE
        name = k.extra_fn("graph_while_error")(err) or b"?"
        call = k.extra_fn("graph_while_failed_call")() or b"?"
        raise RuntimeError(f"graph_while_cuda: {what} failed with CUDA error {err} "
                           f"({name.decode()}) in {call.decode()}; {versions()}")


def _cuda(device) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    return dev if dev.index is not None else torch.device("cuda", torch.cuda.current_device())


def body_stream(device=None) -> torch.cuda.ExternalStream:
    """The stream on which WHILE bodies are captured on `device`: made by
    the C entry and kept for the process (a stream of torch's pool may be
    the capturing stream itself)."""
    dev = _cuda(device)
    if dev not in _streams:
        ptr = ctypes.c_void_p(0)
        with torch.cuda.device(dev):
            _check(kernels.GRAPH_WHILE.extra_fn("graph_while_stream")(ctypes.byref(ptr)),
                   "making the body stream")
        _streams[dev] = torch.cuda.ExternalStream(ptr.value, device=dev)
    return _streams[dev]


def body_pool(device=None) -> torch.cuda.MemPool:
    """The memory pool of the WHILE bodies' temporaries on `device`."""
    dev = _cuda(device)
    if dev not in _pools:
        with torch.cuda.device(dev):
            _pools[dev] = torch.cuda.MemPool()
    return _pools[dev]


@contextlib.contextmanager
def capture(graph: torch.cuda.CUDAGraph):
    """`torch.cuda.graph(graph)` in which `while_loop` may add WHILE
    nodes; yields the `Capture`.  The garbage collector runs before the
    capture and is off during it: a collection inside the capture that
    frees another graph (one held by a dead reference cycle) destroys it
    there, which the runtime forbids while a stream captures, and the
    capture is lost."""
    body_stream()
    body_pool()
    cap = Capture()
    _local.capture = cap
    gc.collect()
    gc_was = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph):
            yield cap
    finally:
        _local.capture = None
        if gc_was:
            gc.enable()


def capturing(device: torch.device) -> bool:
    """Whether work on `device` is being captured into a CUDA graph."""
    return device.type == "cuda" and torch.cuda.is_current_stream_capturing()


def while_loop(flag: torch.Tensor, body) -> None:
    """Add to the graph being captured a WHILE node that runs `body()`
    while `flag` (a 0-d bool on the card, rewritten by the body) holds.
    Raises when the node cannot be built: outside `capture`, or where the
    runtime refuses it."""
    cap = getattr(_local, "capture", None)
    if cap is None or not capturing(flag.device):
        raise RuntimeError("graph_while_cuda: a WHILE node needs a graph captured "
                           "through graph_while.capture")
    k = kernels.GRAPH_WHILE
    kernels.check_tensor(k, "flag", flag, torch.bool, ())
    bs = body_stream(flag.device)
    handle = ctypes.c_ulonglong(0)
    _check(k.fn(torch.cuda.current_stream().cuda_stream, bs.cuda_stream, flag.data_ptr(),
                ctypes.byref(handle)), "adding a WHILE node")
    k.launches += 1
    n = ctypes.c_size_t(0)
    try:
        with torch.cuda.stream(bs), torch.cuda.use_mem_pool(body_pool(flag.device)):
            body()
    finally:
        err = k.extra_fn("graph_while_end")(bs.cuda_stream, handle.value, flag.data_ptr(),
                                            ctypes.byref(n))
    _check(err, "ending a WHILE body")
    k.launches += 1
    cap.while_nodes += 1
    cap.body_nodes.append(n.value)


def node_counts(graph: torch.cuda.CUDAGraph) -> dict:
    """The nodes of a graph captured with `keep_graph=True`, before it is
    instantiated: all of them and the conditional ones (a body's nodes
    are not the graph's).  Read through the CUDA driver API (libcuda): on
    the card's machine the runtime's node queries returned
    cudaErrorUnknown for a graph holding a conditional node."""
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
        raise RuntimeError(f"graph_while_cuda: counting a graph's nodes failed with "
                           f"CUresult {err}; {versions()}")
    return {"nodes": n.value, "conditional": types.count(_NODE_CONDITIONAL)}
