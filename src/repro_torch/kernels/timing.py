"""CUDA-event timers shared by ``chip_smoke.py`` and the kernels' A/B
tools (``kernels/*/ab.py``).  Nothing here touches a GPU at import time.

``eager_ms`` times calls as a caller issues them, one after another;
``graph_ms`` times ``n`` calls captured in a CUDA graph, which leaves out
the host's issue time; ``rotating`` makes one call that runs the next of
several each time, so a captured graph rotates over input sets as eager
calls do.
"""

from __future__ import annotations

import itertools

import torch

_GRAPH_SIDE = []


def eager_ms(fns, iters):
    """Device time per call over ``iters`` calls, rotating over ``fns``
    (separate input or weight sets, together larger than the 50 MB L2, so
    each call streams its operands from HBM)."""
    for f in fns:
        f()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fns[i % len(fns)]()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, n=20, reps=5):
    """Device time per call of ``fn``: ``n`` calls captured in a CUDA graph
    and replayed ``reps`` times.  A kernel shorter than its wrapper's host
    time would otherwise time the host's enqueue, not the device.  ``fn``
    runs under the capture, so a launch it makes must bind the current
    stream when it is called.  The warm-up runs on one side stream for
    every call: each stream that runs a cuBLAS call keeps a cuBLAS
    workspace for the rest of the process, which a peak-memory reading
    would count."""
    fn()
    if not _GRAPH_SIDE:
        _GRAPH_SIDE.append(torch.cuda.Stream())
    side = _GRAPH_SIDE[0]
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):       # warm the allocator off the graph
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (n * reps)


def rotating(fns):
    """A call that runs the next of ``fns`` each time (captured into a CUDA
    graph, the calls rotate over the input sets as eager calls do)."""
    it = itertools.cycle(fns)
    return lambda: next(it)()
