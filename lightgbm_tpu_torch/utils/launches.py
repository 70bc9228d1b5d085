"""The device work one call enqueues, counted exactly: the call is
captured into a CUDA graph, whose kernel and memset nodes
`cuGraphGetNodes` and `cuGraphNodeGetType` count. A profiler window of a
few launches can lose records; a graph holds every operation the call
put on its stream.

Nothing here runs at import time; `graph_launches` needs a GPU.
"""
from __future__ import annotations

import ctypes
from typing import Callable, Dict

import torch

# CUgraphNodeType (cuda.h)
_KERNEL, _MEMSET = 0, 2


def graph_launches(fn: Callable[[], object]) -> Dict[str, int]:
    """{"kernels", "memsets", "other"}: the nodes of one call of ``fn``.
    ``fn`` runs once on a side stream (so that what it caches per stream
    exists), then is captured from that stream into a CUDA graph, whose
    nodes ``cuGraphGetNodes`` and ``cuGraphNodeGetType`` count. ``fn``
    must not synchronise or read the device from the host."""
    cu = ctypes.CDLL("libcuda.so.1")
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    stream.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, stream=stream,
                          capture_error_mode="relaxed"):
        fn()
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(raw, None, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * max(n.value, 1))()
    if cu.cuGraphGetNodes(raw, nodes, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    kinds: Dict[int, int] = {}
    for i in range(n.value):
        t = ctypes.c_int(-1)
        if cu.cuGraphNodeGetType(ctypes.c_void_p(nodes[i]),
                                 ctypes.byref(t)) != 0:
            raise RuntimeError("cuGraphNodeGetType failed")
        kinds[t.value] = kinds.get(t.value, 0) + 1
    del graph
    torch.cuda.synchronize()
    return {"kernels": kinds.pop(_KERNEL, 0),
            "memsets": kinds.pop(_MEMSET, 0),
            "other": sum(kinds.values())}
