"""Lifetimes of what a captured CUDA graph reads.

A stream session on the card captures its block step once in a
``torch.cuda.CUDAGraph`` and replays it every block
(runtime/block_graph.py).  The graph reads device memory by address: the
constants the step takes from a cache (Toeplitz tiles, packed sections,
0-d divisors), and the pinned host buffers its kernels' packed programs
are copied from.  Each must outlive the graph, and none may go back to an
allocator that would hand its memory to someone else.  A cache that
evicts, or a pinned block freed when its wrapper returns, would break
that.

So every such object passes through :func:`hold` where it is made or
looked up, and :func:`holding` collects what was held while a capture is
underway; the session keeps the list beside the graph and drops both
together.  Outside a capture :func:`hold` does nothing.
"""

from __future__ import annotations

import contextlib
import functools
import gc

# one list per capture underway (captures do not nest in practice; the
# innermost collects)
_HOLDERS: list[list] = []


def hold(obj):
    """``obj``, kept alive by the capture underway (if any)."""
    if _HOLDERS:
        _HOLDERS[-1].append(obj)
    return obj


@contextlib.contextmanager
def holding():
    """Collect everything :func:`hold` sees inside the block: yields the
    list, which the caller keeps as long as what it captured."""
    held: list = []
    _HOLDERS.append(held)
    try:
        yield held
    finally:
        del _HOLDERS[next(i for i, h in enumerate(_HOLDERS) if h is held)]


@contextlib.contextmanager
def no_collection():
    """Python's cyclic garbage collector off inside the block, for a
    capture: a collection inside it could finalize an unreachable CUDA
    graph (a dropped CompiledGraph's loops sit in reference cycles), and
    a graph's reset is an operation that invalidates the capture
    underway.  What became garbage is collected after the block."""
    was = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was:
            gc.enable()


def device_cache(maxsize: int | None):
    """``functools.lru_cache`` for a function that returns device tensors:
    every result, a hit or a miss, is held by the capture underway, so an
    eviction cannot free what a captured graph reads."""
    def wrap(fn):
        cached = functools.lru_cache(maxsize=maxsize)(fn)

        @functools.wraps(fn)
        def call(*args, **kwargs):
            return hold(cached(*args, **kwargs))
        call.cache_clear = cached.cache_clear
        call.cache_info = cached.cache_info
        return call
    return wrap
