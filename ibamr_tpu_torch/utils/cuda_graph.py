"""CUDA-graph replay of a pure function of CUDA tensors (port-only).

The 2D solves issue thousands of tiny kernels per call (a multigrid
preconditioner ~4,000, a walled INS step ~650), and launching them one by
one from Python costs ~10 µs each while each runs ~1-2 µs on the card.
:class:`Graphed` captures such a function once, after one warm-up call on
a side stream, and replays it: the same kernels on the same data, so the
result is bitwise the eager one. The function must be free of host reads
and of data-dependent control flow, and its inputs keep their shapes.
"""

from __future__ import annotations

import torch

from ibamr_tpu_torch.utils.tree import leaves, tree_map


class Graphed:
    """``fn(x)`` for a pytree ``x`` of CUDA tensors shaped like
    ``example``, captured as a CUDA graph. A call copies ``x`` into the
    graph's input buffers, replays the graph and returns its output
    buffers, which the next call overwrites (copy what must outlive it)."""

    def __init__(self, fn, example):
        self.static_in = tree_map(torch.clone, example)
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            fn(self.static_in)
        torch.cuda.current_stream().wait_stream(stream)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.static_out = fn(self.static_in)

    def __call__(self, x):
        for dst, src in zip(leaves(self.static_in), leaves(x)):
            dst.copy_(src)
        self.graph.replay()
        return self.static_out
