"""The per-node feedback-cycle scan as a loop over static buffers: on the
card, its blocks captured in CUDA graphs and replayed over the render.

The JAX package runs the per-node scan of a feedback SCC as one
``lax.scan`` over the blocks (dsp_stuff_tpu/compiler/compile.py:1386, the
scan at :1569, unrolled ``cycle_unroll = 8``).  The port's Python loop
(``CompiledGraph._eval_cycle``) launches every op of every member from the
host at every block: 3,750 blocks at 10 s.  :class:`CycleLoops` is the
counterpart of the compiled scan:

* fixed buffers on the graph's device: each signal the SCC reads from
  outside, at full length [..., T] (the feeds); the members' states, each
  Python int of them (a reverb's ``pos``, a chorus's ``t0``) a lockstep
  counter, a 0-d int64 tensor (ops/lockstep.py); the carried blocks; each
  emitted port's sequence [..., T]; and the block counter, a 0-d int64
  tensor;
* a body: ``_CycleScan.body`` at the counter (each feed's block gathered
  at ``counter * block + arange(block)``), its emitted blocks written at
  the same columns (``index_copy_``), the new states and blocks copied
  into their buffers, the counter advanced on the device;
* on the card, :data:`CHUNK` (K, 1) bodies captured in one
  ``torch.cuda.CUDAGraph`` (and, where K > 1, one body in another, for
  the blocks K does not divide), replayed over the loop; on the CPU the
  same buffers and bodies, run eagerly.

The loop opens with the Python loop's first blocks, until the shapes of
the states and carried blocks stop moving (a state that enters a render
unbatched takes the streams' shape at its first block); the buffers take
those shapes.  The sliders a render overrides are bound as a stream step
binds them (utils/buffers.Binding: a float a root of
utils/sliders, a tensor a device buffer), so another value is a copy into
the buffers, not a capture.  The graphs are cached by :meth:`CycleLoops.key`:
the SCC, T, K, the shapes of everything the loop holds, the overrides'
structure, the policy and the members' sliders in the graph.

A replayed loop runs the kernels of the Python loop on the same shapes in
the same order, so it is bitwise that loop.  A capture or a replay that
fails raises; nothing runs the loop eagerly on the card instead.
"""

from __future__ import annotations

import collections
import contextlib
import time

import numpy as np
import torch

from dsp_stuff_tpu_torch.ops import lockstep
from dsp_stuff_tpu_torch.registry import ParamSpec
from dsp_stuff_tpu_torch.utils import precision
from dsp_stuff_tpu_torch.utils.buffers import (Binding, buffer_pairs,
                                              capture_key, copy_into,
                                              freeze_params, state_buffer)
from dsp_stuff_tpu_torch.utils.capture import holding
from dsp_stuff_tpu_torch.utils.sliders import Data

#: bodies a captured graph holds.  The JAX package unrolls its scan 8
#: times (``cycle_unroll``); on the card a graph of one body, replayed a
#: block, runs a 10 s render within 2% of a graph of 8 or 32 and captures
#: in a tenth of their time (PERF.md), so one body it is
CHUNK = 1

#: loops a CompiledGraph keeps (the oldest goes first)
MAX_LOOPS = 4

#: the fewest blocks the route "auto" replays: a graph compiled for one
#: render pays its capture, 10-20 ms, which the Python loop's 0.5-1.4 ms a
#: block repays between 16 and 64 blocks (config5 on an H100, PERF.md)
MIN_BLOCKS = 32


def _shapes(tree):
    """The structure of a tree of states and blocks: each tensor's shape,
    dtype and device, each integer as such (a counter's value is data)."""
    if isinstance(tree, dict):
        return tuple((k, _shapes(v)) for k, v in tree.items())
    if isinstance(tree, (tuple, list)):
        return tuple(_shapes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tuple(tree.shape), str(tree.dtype), str(tree.device)
    if isinstance(tree, (int, np.integer)) and not isinstance(tree, bool):
        return "int"
    return type(tree).__name__


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _tensors(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def _is_int(v) -> bool:
    return isinstance(v, (int, np.integer)) and not isinstance(v, bool)


class CycleLoops:
    """The per-node cycle scans of one CompiledGraph as loops over static
    buffers, cached by key.

    ``route`` picks the loop: "auto" (the rule of :meth:`takes`),
    "buffers" (the same rule on any device and at any length past one
    block: on the CPU the buffers run eagerly, which is how the tests
    drive them) or "eager" (the Python loop always; :meth:`eager` pins it
    for a block of code).  ``captures`` and ``replays`` count the CUDA
    graphs (0 on the CPU), ``capture_s`` is the wall time of the
    captures, their warm-ups included, ``last`` the loop that ran last
    and ``plan`` its (head blocks, K-body chunks, single-body chunks)."""

    def __init__(self, cg):
        self.cg = cg
        self.route = "auto"
        self.captures = 0
        self.replays = 0
        self.capture_s = 0.0
        self.plan = None
        self._loops: collections.OrderedDict = collections.OrderedDict()
        self.last = None
        self._specs = {str(nid): node.spec for nid, node in cg._nodes.items()}

    @contextlib.contextmanager
    def eager(self):
        """Every scan inside the block takes the Python loop.  The entry
        point for a caller that captures the graph's step whole, its
        cycles' blocks inside it (runtime/block_graph.BlockStep): its
        warm-up then runs what its capture runs."""
        was, self.route = self.route, "eager"
        try:
            yield
        finally:
            self.route = was

    def takes(self, scan, values: dict, pdict, st: dict, prev: dict,
              nb: int) -> bool:
        """Whether the scan runs as the loop over buffers: more than one
        block; on the card and at least :data:`MIN_BLOCKS` blocks (route
        "auto"); no capture underway (a stream step captures its cycles'
        blocks inside its own graph); no override that is a
        stream step's slider (``sliders.Data``: the step binds its own);
        and nothing for autograd to record (no feed, state, carried block
        or override that requires grad while grad mode is on: the Python
        loop stays the route of a gradient)."""
        if self.route == "eager" or nb < 2:
            return False
        dev = self.cg.device
        if self.route == "auto" and (dev.type != "cuda"
                                     or nb < MIN_BLOCKS):
            return False
        if dev.type == "cuda" and torch.cuda.is_current_stream_capturing():
            return False
        over = self._overrides(scan, pdict)
        if any(isinstance(v, Data) for entry in (over or {}).values()
               if isinstance(entry, dict) for v in entry.values()):
            return False
        if torch.is_grad_enabled():
            feeds = [values[k] for k in scan.feeds]
            if any(t.requires_grad for t in _tensors((feeds, st, prev, over))):
                return False
        return True

    def data(self, nid, name) -> bool:
        """Whether ``params[nid][name]`` is data of a captured loop: a
        non-static slider its node reads on the device."""
        spec = self._specs.get(str(nid))
        p = None if spec is None else next(
            (p for p in spec.params if p.name == name), None)
        return (isinstance(p, ParamSpec) and not p.static
                and name not in getattr(spec.impl, "host_sliders", ()))

    def key(self, scan, T: int, feeds: dict, over, st: dict, prev: dict,
            outs) -> tuple:
        """What a loop's buffers and graphs depend on: the SCC, T, K, the
        shapes of the feeds, states, carried and emitted blocks, the
        overrides' structure with the policy (utils/buffers.capture_key),
        and the members' sliders as the graph holds them (the body bakes
        what it reads from the graph)."""
        nodes = self.cg._nodes
        return (tuple(scan.order), T, CHUNK, _shapes(feeds),
                _shapes((st, prev)), tuple(outs),
                capture_key(over, self.data),
                freeze_params({str(n): nodes[n].params for n in scan.order}))

    @staticmethod
    def _overrides(scan, pdict):
        """The render's overrides of the SCC's members, or None."""
        over = {k: v for k, v in (pdict or {}).items()
                if k in {str(n) for n in scan.order}}
        return over or None

    def run(self, scan, values: dict, pdict, st: dict, prev: dict, nb: int):
        """The scan over ``nb`` blocks: the Python loop's first blocks,
        until the shapes hold, then the loop over buffers.  Returns the
        members' states, the carried blocks and the emitted sequences, as
        the Python loop does."""
        B = self.cg.block_size
        head: list = [[] for _ in scan.emit]
        b, shapes = 0, _shapes((st, prev))
        while b < nb:
            st, prev, emitted = scan.body(values, pdict, st, prev, b)
            for seq, blk in zip(head, emitted):
                seq.append(blk)
            b += 1
            was, shapes = shapes, _shapes((st, prev))
            if was == shapes:
                break
        if b == nb:
            return st, prev, [torch.cat(torch.broadcast_tensors(*seq), dim=-1)
                              for seq in head]
        feeds = {k: values[k] for k in scan.feeds}
        over = self._overrides(scan, pdict)
        outs = [(torch.broadcast_shapes(*(blk.shape[:-1] for blk in seq)),
                 seq[-1].dtype) for seq in head]
        key = self.key(scan, nb * B, feeds, over, st, prev, outs)
        loop = self._loops.pop(key, None)
        if loop is not None and not loop.binding.move(over):
            loop = None                  # a form moved: bind and capture anew
        if loop is None:
            loop = _Loop(self, scan, key, feeds, over, st, prev, outs,
                         nb * B)
        self._loops[key] = loop
        while len(self._loops) > MAX_LOOPS:
            self._loops.popitem(last=False)
        self.last = loop
        loop.load(scan, feeds, st, prev, head, b)
        full, rest = divmod(nb - b, CHUNK)
        self.plan = (b, full, rest)
        for _ in range(full):
            loop.chunk(CHUNK)
        for _ in range(rest):
            loop.chunk(1)
        return loop.result()

    def dump_graph(self, path: str, bodies: int | None = None) -> None:
        """Write the last loop's graph of ``bodies`` bodies (K by default)
        to ``path`` as Graphviz DOT with every node's parameters
        (``cudaGraphDebugDotPrint``, verbose)."""
        got = None if self.last is None else self.last.graphs.get(
            CHUNK if bodies is None else bodies)
        if got is None:
            raise RuntimeError("dump_graph: no such graph captured")
        got[0].debug_dump(path)


class _Loop:
    """One scan's buffers, its binding of the overrides and, on the card,
    its graphs by bodies (each with what it holds, utils/capture)."""

    def __init__(self, loops: CycleLoops, scan, key, feeds: dict, over,
                 st: dict, prev: dict, outs, T: int):
        dev = loops.cg.device
        self.loops, self.scan, self.block = loops, scan, loops.cg.block_size
        self.feeds = {k: torch.empty(v.shape, dtype=v.dtype, device=dev)
                      for k, v in feeds.items()}
        self.st = {k: ({kk: state_buffer(v, dev) for kk, v in s.items()}
                       if isinstance(s, dict) else state_buffer(s, dev))
                   for k, s in st.items()}
        # the counters the Python loop holds as ints, given back as ints
        self.ints = {(k, kk) for k, s in st.items() if isinstance(s, dict)
                     for kk, v in s.items() if _is_int(v)}
        self.prev = {kp: torch.empty(v.shape, dtype=v.dtype, device=dev)
                     for kp, v in prev.items()}
        self.outs = [torch.empty((*shape, T), dtype=dtype, device=dev)
                     for shape, dtype in outs]
        self.counter = lockstep.on_device(0, dev)
        self.binding = Binding(over, loops.data, dev, key)
        self.graphs: dict = {}
        self.warm = False

    def _pairs(self, st: dict, prev: dict):
        return (buffer_pairs(self.st, st, "the cycle's state")
                + buffer_pairs(self.prev, prev, "the cycle's carried blocks"))

    def load(self, scan, feeds: dict, st: dict, prev: dict, head,
             b: int) -> None:
        """Copy a render's feeds, the states and carried blocks after the
        head's ``b`` blocks, and the head's emitted blocks into the
        buffers; point the counter at block ``b``."""
        self.scan = scan
        for k, buf in self.feeds.items():
            buf.copy_(feeds[k])
        copy_into(self._pairs(st, prev))
        B = self.block
        for out, seq in zip(self.outs, head):
            for j, blk in enumerate(seq):
                out[..., j * B:(j + 1) * B].copy_(blk)
        self.counter.fill_(b)

    def _body(self) -> None:
        """One block over the buffers."""
        B = self.block
        st, cur, emitted = self.scan.body(self.feeds, self.binding.params,
                                          self.st, self.prev, self.counter)
        idx = self.counter * B + torch.arange(B, device=self.counter.device)
        for out, blk in zip(self.outs, emitted):
            out.index_copy_(-1, idx, blk.expand(*out.shape[:-1], B))
        copy_into(self._pairs(st, cur))
        self.counter.add_(1)

    def chunk(self, bodies: int) -> None:
        """``bodies`` blocks: on the card one replay of the graph of that
        many bodies (captured first when there is none), on the CPU the
        bodies themselves."""
        if self.counter.device.type != "cuda":
            for _ in range(bodies):
                self._body()
            return
        got = self.graphs.get(bodies)
        graph = got[0] if got is not None else self._capture(bodies)
        try:
            graph.replay()
        except RuntimeError as e:
            raise RuntimeError(f"render: replaying the feedback cycle "
                               f"{self.scan.order}'s captured block loop "
                               f"failed: {e}") from e
        self.loops.replays += 1

    def _saved(self):
        return ({k: ({kk: None if b is None else b.clone()
                      for kk, b in s.items()} if isinstance(s, dict)
                     else None if s is None else s.clone())
                 for k, s in self.st.items()},
                {kp: b.clone() for kp, b in self.prev.items()},
                self.counter.clone())

    def _capture(self, bodies: int):
        """Warm the body up on the capture's stream (the first capture
        only: the kernels build and load, the constant caches and the
        sliders' buffers fill), put the buffers back, and capture
        ``bodies`` bodies in one graph."""
        dev = self.counter.device
        t0 = time.perf_counter()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        try:
            if not self.warm:
                st, prev, counter = self._saved()
                with torch.cuda.stream(side):
                    self._body()
                torch.cuda.current_stream(dev).wait_stream(side)
                copy_into(self._pairs(st, prev))
                self.counter.copy_(counter)
                self.warm = True
            torch.cuda.synchronize(dev)
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            with holding() as held:
                with torch.cuda.graph(graph, stream=side):
                    for _ in range(bodies):
                        self._body()
            graph.instantiate()
        except (RuntimeError, ValueError, TypeError) as e:
            shapes = [tuple(o.shape) for o in self.outs]
            raise RuntimeError(
                f"render: capturing {bodies} block(s) of the feedback cycle "
                f"{self.scan.order}'s per-node scan (emitting {shapes}, "
                f"policy {precision.get_policy().name!r}) in a CUDA graph "
                f"failed: {e}") from e
        self.graphs[bodies] = (graph, held)
        self.loops.captures += 1
        self.loops.capture_s += time.perf_counter() - t0
        return graph

    def result(self):
        """(states, carried blocks, emitted sequences) read out of the
        buffers: tensors cloned (the next render writes the buffers), the
        Python loop's int counters as ints."""
        def leaf(path, b):
            if b is None:
                return None
            return int(b) if path in self.ints else b.clone()
        st = {k: ({kk: leaf((k, kk), b) for kk, b in s.items()}
                  if isinstance(s, dict) else leaf((k,), s))
              for k, s in self.st.items()}
        prev = {kp: b.clone() for kp, b in self.prev.items()}
        return st, prev, [o.clone() for o in self.outs]
