"""CUDA events around every `torch.cuda.CUDAGraph.replay`: a frozen
copy of `chip_smoke.py`'s `replay_spans`, so that later edits there do
not move the yardstick.  The
profiler misses kernels that run inside CUDA-graph conditional nodes, so
no graph's device time comes from it: a replay's device time is the span
between two CUDA events recorded around it on the replaying stream."""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def replay_spans():
    """Every CUDAGraph.replay within, bracketed by CUDA events: yields the
    list of (start, end) event pairs."""
    import torch
    spans, orig = [], torch.cuda.CUDAGraph.replay

    def replay(graph):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        orig(graph)
        b.record()
        spans.append((a, b))

    torch.cuda.CUDAGraph.replay = replay
    try:
        yield spans
    finally:
        torch.cuda.CUDAGraph.replay = orig
