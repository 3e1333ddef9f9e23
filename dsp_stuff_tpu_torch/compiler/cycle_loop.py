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
the SCC, T, K, its pointwise groups and the fan-ins they write, the
shapes of everything the loop holds, the overrides' structure, the policy and the members' sliders in
the graph.

A replayed loop runs the kernels of the Python loop on the same shapes in
the same order, so it is bitwise that loop.  A capture or a replay that
fails raises; nothing runs the loop eagerly on the card instead.

Under autograd (a feed, state, carried block or override that requires
grad) the loop runs inside :class:`_ScanGrad`, the counterpart of
``jax.grad`` through the JAX package's ``lax.scan`` (its fit step,
dsp_stuff_tpu/train/fit.py:94): the forward is the same replayed loop,
plus a checkpoint of the states and carried blocks every
:data:`SEGMENT` (S) blocks (a captured copy into slot ``slot``, a device
counter); the backward walks the segments from the last: a captured
restore of the segment's checkpoint, S replays of a *record* body (the
forward body after a copy of its input state into ``record[counter -
seg]``) and S replays of a *reverse* body, the counter going down, which
runs ``_CycleScan.step`` under ``torch.enable_grad()`` on the recorded
state, the feeds' blocks and the overrides as leaves and
``torch.autograd.grad`` with the static cotangent buffers as
``grad_outputs``: d(state) and d(carried) go back into those buffers,
d(feed block) into a full-length ``dfeeds`` buffer at the block's
columns, d(override) is added into a float64 buffer a slider.  Every
buffer a gradient binds lives with the loop (utils/buffers.GradBuffers),
so the next step of a fit, whose override values move as data,
captures nothing.
"""

from __future__ import annotations

import collections
import contextlib
import time
import weakref

import numpy as np
import torch

from dsp_stuff_tpu_torch.ops import lockstep
from dsp_stuff_tpu_torch.registry import ParamSpec
from dsp_stuff_tpu_torch.utils import precision
from dsp_stuff_tpu_torch.utils.buffers import (Binding, GradBuffers,
                                              buffer_pairs, capture_key,
                                              copy_into, freeze_params,
                                              state_buffer)
from dsp_stuff_tpu_torch.utils.capture import holding, no_collection
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
#: block repays between 16 and 64 blocks (config5 on an H100, PERF.md); a
#: gradient's five captures break even near 16 blocks too
MIN_BLOCKS = 32

#: blocks between two checkpoints of a differentiated loop (S): the
#: backward keeps ceil(blocks / S) checkpoints and S records of the
#: states and carried blocks, near sqrt(3,748) at 128 x 10 s, where
#: config5's reverb ring is 3.7 MB a block (PERF.md)
SEGMENT = 64


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
    graphs (0 on the CPU), ``captured`` the captures by kind ("forward",
    "save", "restore", "record", "reverse"), ``capture_s`` is the wall
    time of the captures, their warm-ups included, ``last`` the loop that
    ran last and ``plan`` its (head blocks, K-body chunks, single-body
    chunks)."""

    def __init__(self, cg):
        self.cg = cg
        self.route = "auto"
        self.replays = 0
        self.captured: collections.Counter = collections.Counter()
        self.capture_s = 0.0
        self.plan = None
        self._loops: collections.OrderedDict = collections.OrderedDict()
        self.last = None
        self._specs = {str(nid): node.spec for nid, node in cg._nodes.items()}

    @property
    def captures(self) -> int:
        return sum(self.captured.values())

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
        blocks inside its own graph); and no override that is a stream
        step's slider (``sliders.Data``: the step binds its own).  Under
        autograd the same rule holds: :meth:`run` then differentiates the
        loop (:class:`_ScanGrad`)."""
        if self.route == "eager" or nb < 2:
            return False
        dev = self.cg.device
        if self.route == "auto" and (dev.type != "cuda"
                                     or nb < MIN_BLOCKS):
            return False
        if dev.type == "cuda" and torch.cuda.is_current_stream_capturing():
            return False
        over = self._overrides(scan, pdict)
        return not any(isinstance(v, Data) for entry in (over or {}).values()
                       if isinstance(entry, dict) for v in entry.values())

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
        """What a loop's buffers and graphs depend on: the SCC, T, K, its
        pointwise groups (none with ``POINTWISE_FUSION`` off) and the
        fan-ins they write (``_CycleScan.fanins``), the shapes
        of the feeds, states, carried and emitted blocks, the overrides'
        structure with the policy (utils/buffers.capture_key), and the
        members' sliders as the graph holds them (the body bakes what it
        reads from the graph)."""
        nodes = self.cg._nodes
        return (tuple(scan.order), T, CHUNK, scan.groups,
                tuple(sorted(scan.fanins.items())), _shapes(feeds),
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
        until the shapes hold, then the loop over buffers, differentiated
        by :class:`_ScanGrad` when autograd must see it.  Returns the
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
        # a loop whose backward is still to run keeps its buffers; a form
        # that moved binds and captures anew
        if loop is not None and (loop.pending()
                                 or not loop.binding.move(over)):
            loop = None
        if loop is None:
            loop = _Loop(self, scan, key, feeds, over, st, prev, outs,
                         nb * B)
        self._loops[key] = loop
        while len(self._loops) > MAX_LOOPS:
            self._loops.popitem(last=False)
        self.last = loop
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in _tensors((feeds, st, prev, over))):
            return loop.differentiated(scan, feeds, over, st, prev, head, b,
                                       nb)
        loop.load(scan, feeds, st, prev, head, b)
        self.plan = (b, *loop.advance(nb - b))
        return loop.result()

    def dump_graph(self, path: str, bodies=None) -> None:
        """Write one of the last loop's graphs to ``path`` as Graphviz DOT
        with every node's parameters (``cudaGraphDebugDotPrint``,
        verbose): the forward graph of ``bodies`` bodies (K by default),
        or the backward's "save", "restore", "record" or "reverse"."""
        graphs = {} if self.last is None else self.last.graphs
        if bodies is None:
            bodies = CHUNK
        got = graphs.get(bodies)
        if got is None and isinstance(bodies, str):
            got = next((g for k, g in graphs.items()
                        if isinstance(k, tuple) and k[0] == bodies), None)
        if got is None:
            raise RuntimeError("dump_graph: no such graph captured")
        got[0].debug_dump(path)


def _kind(key) -> str:
    """A graph's kind by its key in ``_Loop.graphs``."""
    if isinstance(key, int):
        return "forward"
    return key[0] if isinstance(key, tuple) else key


class _Loop:
    """One scan's buffers, its binding of the overrides and, on the card,
    its graphs by key (each with what it holds, utils/capture): the
    forward's by bodies, the backward's by kind ("save", "restore",
    "record"; ``("reverse", feeds that need a gradient)``)."""

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
        # every buffer of the state and carried blocks by path ("st", k),
        # ("st", k, kk) or ("prev", kp); the floating ones carry gradients
        self.paths = [(("st", k, kk), b) for k, s in self.st.items()
                      if isinstance(s, dict) for kk, b in s.items()
                      if b is not None]
        self.paths += [(("st", k), s) for k, s in self.st.items()
                       if isinstance(s, torch.Tensor)]
        self.paths += [(("prev", kp), b) for kp, b in self.prev.items()]
        self.carries = [(p, b) for p, b in self.paths
                        if b.is_floating_point()]
        self.grad = None               # the backward's (GradBuffers)
        self._pending = None           # the forward whose backward is due
        self.generation = 0            # renders loaded, for the backward

    def _pairs(self, st: dict, prev: dict):
        return (buffer_pairs(self.st, st, "the cycle's state")
                + buffer_pairs(self.prev, prev, "the cycle's carried blocks"))

    def load(self, scan, feeds: dict, st: dict, prev: dict, head,
             b: int) -> None:
        """Copy a render's feeds, the states and carried blocks after the
        head's ``b`` blocks, and the head's emitted blocks into the
        buffers; point the counter at block ``b``."""
        self.scan = scan
        self.generation += 1
        for k, buf in self.feeds.items():
            buf.copy_(feeds[k])
        copy_into(self._pairs(st, prev))
        B = self.block
        for out, seq in zip(self.outs, head):
            for j, blk in enumerate(seq):
                out[..., j * B:(j + 1) * B].copy_(blk)
        self.counter.fill_(b)

    def advance(self, n: int) -> tuple[int, int]:
        """The next ``n`` blocks: K-body chunks, then single bodies.
        Returns their counts."""
        full, rest = divmod(n, CHUNK)
        for _ in range(full):
            self.run(CHUNK)
        for _ in range(rest):
            self.run(1)
        return full, rest

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

    def _fn(self, key):
        """What the graph of ``key`` runs."""
        if isinstance(key, int):
            return lambda: [self._body() for _ in range(key)]
        if isinstance(key, tuple):
            return lambda: self._reverse(key[1])
        return {"save": self._save, "restore": self._restore,
                "record": self._record}[key]

    def run(self, key) -> None:
        """The graph of ``key`` once: on the card one replay (captured
        first when there is none), on the CPU its bodies themselves."""
        if self.counter.device.type != "cuda":
            self._fn(key)()
            return
        got = self.graphs.get(key)
        graph = got[0] if got is not None else self._capture(key)
        try:
            graph.replay()
        except RuntimeError as e:
            raise RuntimeError(f"render: replaying the feedback cycle "
                               f"{self.scan.order}'s captured "
                               f"{_kind(key)} graph failed: {e}") from e
        self.loops.replays += 1

    def _warm_up(self, key, side) -> None:
        """Run ``key``'s bodies once on ``side`` and put back the buffers
        they move: the forward's before its first capture (the kernels
        build and load, the constant caches and the sliders' buffers
        fill), the reverse's before each of its captures (autograd's
        device thread starts, the reverse kernels build).  The save,
        restore and record graphs run only ops the forward's warm-up
        ran.  What the bodies write beside those buffers (an emitted or
        a feed's gradient block) their replay writes again."""
        if isinstance(key, int) and not self.warm:
            bufs = [b for _, b in self.paths] + [self.counter]
        elif isinstance(key, tuple):
            bufs = [self.counter, *self.grad.dcarry, *self.grad.dover]
        else:
            return
        kept = [b.clone() for b in bufs]
        cur = torch.cuda.current_stream(side.device)
        side.wait_stream(cur)            # after the copies that keep them
        with torch.cuda.stream(side):
            self._fn(1 if isinstance(key, int) else key)()
        cur.wait_stream(side)
        for b, v in zip(bufs, kept):
            b.copy_(v)
        self.warm = self.warm or isinstance(key, int)

    def _capture(self, key):
        """Warm ``key``'s bodies up on the capture's stream where they
        need it (:meth:`_warm_up`) and capture them in one graph."""
        dev = self.counter.device
        t0 = time.perf_counter()
        side = torch.cuda.Stream(dev)
        try:
            self._warm_up(key, side)
            side.wait_stream(torch.cuda.current_stream(dev))
            torch.cuda.synchronize(dev)
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            with holding() as held, no_collection():
                with torch.cuda.graph(graph, stream=side):
                    self._fn(key)()
            graph.instantiate()
        except (RuntimeError, ValueError, TypeError) as e:
            shapes = [tuple(o.shape) for o in self.outs]
            raise RuntimeError(
                f"render: capturing the {_kind(key)} graph "
                f"({key if isinstance(key, int) else 1} block(s)) of the "
                f"feedback cycle {self.scan.order}'s per-node scan "
                f"(emitting {shapes}, policy "
                f"{precision.get_policy().name!r}) in a CUDA graph "
                f"failed: {e}") from e
        self.graphs[key] = (graph, held)
        self.loops.captured[_kind(key)] += 1
        self.loops.capture_s += time.perf_counter() - t0
        return graph

    def result(self, carried: dict | None = None):
        """(states, carried blocks, emitted sequences) read out of the
        buffers: tensors cloned (the next render writes the buffers), the
        Python loop's int counters as ints; ``carried`` gives the tensors
        of some paths instead (the differentiated loop's outputs)."""
        carried = carried or {}

        def leaf(path, b):
            if b is None:
                return None
            if path in carried:
                return carried[path]
            return int(b) if path[1:] in self.ints else b.clone()
        st = {k: ({kk: leaf(("st", k, kk), b) for kk, b in s.items()}
                  if isinstance(s, dict) else leaf(("st", k), s))
              for k, s in self.st.items()}
        prev = {kp: leaf(("prev", kp), b) for kp, b in self.prev.items()}
        return st, prev, [o.clone() for o in self.outs]

    # -- the backward ------------------------------------------------------

    def pending(self) -> bool:
        """Whether a differentiated forward's backward is still due: its
        checkpoints, feeds and binding must stay as they are."""
        return self._pending is not None and self._pending() is not None

    def differentiated(self, scan, feeds: dict, over, st: dict, prev: dict,
                       head, b: int, nb: int):
        """The loop from block ``b`` under :class:`_ScanGrad`: the states,
        carried blocks and emitted sequences as :meth:`result` gives them,
        the floating ones differentiable with respect to the feeds, the
        states and carried blocks after the head and the overrides."""
        B = self.block
        if self.grad is None:
            self.grad = GradBuffers(
                self.paths, self.carries, self.outs, self.feeds,
                [v for _, v in self.binding.tensors], self.counter,
                slots=-(-(nb - 1) // SEGMENT), records=SEGMENT)
        values = [_at(path, st, prev) for path, _ in self.carries]
        outs = _ScanGrad.apply(self, (scan, feeds, st, prev, head, b, nb),
                               *(feeds[k] for k in scan.feeds), *values,
                               *(over[nid][name] for (nid, name), _
                                 in self.binding.tensors))
        n = len(self.carries)
        st, prev, _ = self.result(dict(zip((p for p, _ in self.carries),
                                           outs[:n])))
        seqs = [torch.cat([blk.expand(*out.shape[:-1], B) for blk in seq]
                          + [tail], dim=-1)
                for seq, tail, out in zip(head, outs[n:], self.outs)]
        return st, prev, seqs

    def segments(self, b: int, nb: int) -> list:
        """(first block, blocks) of each checkpointed segment of the loop
        from block ``b``: SEGMENT blocks each, the last ragged."""
        return [(s, min(SEGMENT, nb - s)) for s in range(b, nb, SEGMENT)]

    def checkpointed(self, b: int, nb: int) -> tuple[int, int]:
        """The forward from block ``b``: a checkpoint ("save") before each
        segment, then its blocks.  Returns the chunks' counts."""
        self.grad.slot.zero_()
        full = rest = 0
        for _, n in self.segments(b, nb):
            self.run("save")
            f, r = self.advance(n)
            full, rest = full + f, rest + r
        return full, rest

    def _save(self) -> None:
        """The states, carried blocks and counter into checkpoint
        ``slot``; the slot moves on."""
        g = self.grad
        i = g.slot.view(1)
        for path, buf in self.paths:
            g.ck[path].index_copy_(0, i, buf.unsqueeze(0))
        g.ck_counter.index_copy_(0, i, self.counter.view(1))
        g.slot.add_(1)

    def _restore(self) -> None:
        """The slot moves back; its checkpoint into the buffers, the
        counter and ``seg`` (the segment's first block)."""
        g = self.grad
        g.slot.sub_(1)
        i = g.slot.view(1)
        for path, buf in self.paths:
            buf.copy_(g.ck[path].index_select(0, i)[0])
        self.counter.copy_(g.ck_counter.index_select(0, i)[0])
        g.seg.copy_(self.counter)

    def _record(self) -> None:
        """The block's input state into ``record[counter - seg]``, then the
        forward body."""
        g = self.grad
        j = (self.counter - g.seg).view(1)
        for path, buf in self.paths:
            g.record[path].index_copy_(0, j, buf.unsqueeze(0))
        self._body()

    def _reverse(self, needs: tuple) -> None:
        """One block backwards: the counter moves back to it, the block's
        recorded state, its feeds' blocks (those of ``needs``) and the
        overrides become leaves, ``_CycleScan.step`` runs on them under
        autograd, and ``torch.autograd.grad`` takes the cotangents of its
        new states and outputs (the block's own outputs: what the next
        block read as ``prev``) from the buffers: d(state, carried) back
        into them, d(feed block) into ``dfeeds`` at the block's columns,
        d(override) added into ``dover``."""
        g, B = self.grad, self.block
        self.counter.sub_(1)
        j = (self.counter - g.seg).view(1)
        idx = self.counter * B + torch.arange(B, device=self.counter.device)
        rec = {path: g.record[path].index_select(0, j)[0]
               for path, _ in self.paths}
        st = {k: ({kk: None if b is None else rec[("st", k, kk)]
                   for kk, b in s.items()} if isinstance(s, dict)
                  else None if s is None else rec[("st", k)])
              for k, s in self.st.items()}
        prev = {kp: rec[("prev", kp)] for kp in self.prev}
        blocks = self.scan.feed_blocks(self.feeds, self.counter)
        fed = [k for k, need in zip(self.scan.feeds, needs) if need]
        params = self.binding.params
        if params is not None:
            params = {n: dict(e) if isinstance(e, dict) else e
                      for n, e in params.items()}
        with torch.enable_grad():
            carried = [rec[path].requires_grad_() for path, _ in self.carries]
            for k in fed:
                blocks[k] = blocks[k].requires_grad_()
            over = []
            for (nid, name), buf in self.binding.tensors:
                params[nid][name] = buf.detach().requires_grad_()
                over.append(params[nid][name])
            st, cur, emitted = self.scan.step(blocks, params, st, prev)
            outs, cots = [], []
            for (path, _), d in zip(self.carries, g.dcarry):
                v = _at(path, st, cur)
                if v.requires_grad:
                    outs.append(v)
                    cots.append(d)
            for blk, out, d in zip(emitted, self.outs, g.demit):
                if blk.requires_grad:
                    outs.append(blk.expand(*out.shape[:-1], B))
                    cots.append(d.index_select(-1, idx))
            inputs = carried + [blocks[k] for k in fed] + over
            grads = (torch.autograd.grad(outs, inputs, cots, allow_unused=True)
                     if outs else (None,) * len(inputs))
        n = len(carried)
        copy_into([(d, 0.0 if v is None else v, f"d{path}")
                   for ((path, _), d), v in zip(zip(self.carries, g.dcarry),
                                                grads[:n])])
        for k, v in zip(fed, grads[n:n + len(fed)]):
            if v is not None:
                g.dfeeds[k].index_copy_(-1, idx, v)
        for i, v in enumerate(grads[n + len(fed):]):
            if v is not None:
                g.dover[i].add_(v)
                g.used[i] = True

    def backward(self, b: int, nb: int, dcarry, demit, needs: tuple):
        """The gradients of the loop from block ``b`` given the cotangents
        of its outputs (None: zero): d(feeds) for those of ``needs``,
        d(states and carried blocks after the head), d(overrides) in
        their leaves' dtypes (None for an override no block reads)."""
        g, B = self.grad, self.block
        copy_into([(buf, 0.0 if d is None else d, "a cotangent")
                   for buf, d in zip(g.dcarry, dcarry)])
        for buf, d in zip(g.demit, demit):
            if d is None:
                buf.zero_()
            else:
                buf[..., b * B:].copy_(d)
        for k, need in zip(self.scan.feeds, needs):
            if need:
                g.feed_buffer(k).zero_()
        for buf in g.dover:
            buf.zero_()
        for _, n in reversed(self.segments(b, nb)):
            self.run("restore")
            for _ in range(n):
                self.run("record")
            for _ in range(n):
                self.run(("reverse", needs))
        dfeeds = [g.dfeeds[k] if need else None
                  for k, need in zip(self.scan.feeds, needs)]
        dover = [d.to(v.dtype) if used else None
                 for d, used, (_, v) in zip(g.dover, g.used,
                                            self.binding.tensors)]
        return dfeeds, [d.clone() for d in g.dcarry], dover


def _at(path, st: dict, prev: dict):
    """The value at ``path`` ("st", k[, kk]) or ("prev", kp) of (st, prev)."""
    if path[0] == "prev":
        return prev[path[1]]
    v = st[path[1]]
    return v[path[2]] if len(path) == 3 else v


class _ScanGrad(torch.autograd.Function):
    """The differentiated loop over buffers (:meth:`_Loop.differentiated`).

    ``apply(loop, (scan, feeds, st, prev, head, b, nb), *feeds, *carries,
    *overrides)``: the forward loads the buffers and runs the loop from
    block ``b`` with its checkpoints (:meth:`_Loop.checkpointed`); it
    returns the floating states and carried blocks (``loop.carries``'
    order) and each emitted sequence's blocks from ``b`` on.  The
    backward runs :meth:`_Loop.backward`.  It is differentiable once: a
    second-order gradient raises."""

    @staticmethod
    def forward(ctx, loop, args, *tensors):
        scan, feeds, st, prev, head, b, nb = args
        loop.load(scan, feeds, st, prev, head, b)
        loop.loops.plan = (b, *loop.checkpointed(b, nb))
        token = ctx.token = _Token()
        loop._pending = weakref.ref(token)
        ctx.loop, ctx.b, ctx.nb = loop, b, nb
        ctx.generation = loop.generation
        B = loop.block
        return tuple([buf.clone() for _, buf in loop.carries]
                     + [out[..., b * B:].clone() for out in loop.outs])

    @staticmethod
    def backward(ctx, *grads):
        loop = ctx.loop
        order = loop.scan.order
        if torch.is_grad_enabled():
            raise RuntimeError(
                f"the feedback cycle {order}'s replayed per-node scan is "
                f"differentiable once: a second-order gradient through it "
                f"(create_graph=True) is not supported")
        if loop.generation != ctx.generation:
            raise RuntimeError(
                f"the feedback cycle {order}'s replayed per-node scan ran "
                f"again since this forward; its checkpoints are gone")
        loop._pending = None
        nf, n = len(loop.scan.feeds), len(loop.carries)
        needs = tuple(ctx.needs_input_grad[2:2 + nf])
        with torch.no_grad():
            dfeeds, dcarry, dover = loop.backward(ctx.b, ctx.nb, grads[:n],
                                                  grads[n:], needs)
        wants = ctx.needs_input_grad[2 + nf:2 + nf + n]
        dcarry = [d if w else None for d, w in zip(dcarry, wants)]
        return (None, None, *dfeeds, *dcarry, *dover)


class _Token:
    """A differentiated forward's mark: alive while its backward is due."""
