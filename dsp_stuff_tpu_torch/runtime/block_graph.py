"""One stream block of a compiled graph over static buffers: on the card,
one captured CUDA graph replayed a block.

The JAX package runs a stream block as one compiled program
(``jax.jit(cg.fn)``, dsp_stuff_tpu/runtime/stream.py:124) and
``process_many`` as a jitted ``lax.scan`` of it, cached on a snapshot of
the params (``_chunk_fn``, :223-247).  Eager PyTorch launches every op of
the step from the host, 67-293 launches a block.  :class:`BlockStep` is
the counterpart of the compiled program:

* fixed buffers on the graph's device: the input blocks ``inputs``
  [n_in, block], the state (the tree of ``cg.init_state()``, each Python
  int of it a 0-d int64 counter) and the outputs ``outputs``
  [n_out, block];
* a step: ``cg.fn(state, {key: inputs[i]}, params)``, then ``copy_`` of
  the outputs and of the new state into their buffers;
* the params as the step reads them (a *binding*): each non-static
  slider a float overrides is a root of utils/sliders (the nodes derive
  what their float path derives from it on the host, and read it from
  device buffers), each one a tensor overrides a device buffer of the
  tensor's shape and dtype (the nodes' tensor path);
* on the CPU the step runs as plain calls; on the card it is captured
  once in a ``torch.cuda.CUDAGraph`` and replayed (:meth:`run`).  A
  capture is keyed on the params' STRUCTURE (:func:`capture_key`: which
  sliders are overridden, each a float or a tensor of which shape and
  dtype; the content of a static slider) and on the precision policy, as
  ``jax.jit`` keys its program on the params' tree and avals.  Another
  key binds the params anew and captures again before the next replay.

The lockstep counters (a reverb's write position, a chorus's clock, a
FIR's sample count) live on the device so that no host value changes
from one replay to the next: the ops take them as 0-d tensors through
ops/lockstep.py, with the values the Python ints give.

The params' values are data.  When the params' cheap stamp
(``params_stamp``: values, tensors by identity and version counter)
moves, the step works the key out again and, the structure unchanged,
*moves* its binding: the host derives the floats' constants again and
copies what changed into the buffers (from pinned staging on the card),
and copies each tensor into its buffer on the device; the captured graph
replays on the new values, bitwise the eager step that takes them as
Python floats.  Where a node's float path branches on a value
(``sliders.form``: a biquad's degenerate forms), a move across the
branch binds anew and captures again, as does a value whose derived
shape moves.  A steady stream (the stamp unmoved) makes no copy and no
host read a block.  The JAX package's ``process_many`` bakes the params
into its scanned program and traces it again on a change
(``_chunk_fn``, dsp_stuff_tpu/runtime/stream.py:223-247); the port's k
replays take the values as data: the same values, no capture.

Before a capture the step runs once on the capture's stream (the kernels
build and load, the constant caches fill, ``cudaFuncSetAttribute`` is
called), and the state buffers are then put back, so the warm-up does not
advance the stream.  What the graph reads beside its own pool (cached
constants, the pinned copies of the packed programs) is held with it
(utils/capture).  A capture or replay that fails raises, naming the step;
nothing runs the step eagerly on the card instead.
"""

from __future__ import annotations

import time

import torch

from dsp_stuff_tpu_torch.compiler import compile as _compile
from dsp_stuff_tpu_torch.ops import lockstep
from dsp_stuff_tpu_torch.registry import ParamSpec
from dsp_stuff_tpu_torch.utils import precision
from dsp_stuff_tpu_torch.utils.buffers import (Binding, buffer_pairs,
                                              capture_key, copy_into,
                                              freeze_params, state_buffer)
from dsp_stuff_tpu_torch.utils.capture import holding, no_collection

_F32 = torch.float32


class _Same:
    """A tensor in a stamp: equal only to the same tensor object (held, so
    its address is not reused while the stamp lives)."""
    __slots__ = ("t",)

    def __init__(self, t):
        self.t = t

    def __eq__(self, other):
        return isinstance(other, _Same) and other.t is self.t

    def __hash__(self):
        return id(self.t)


def params_stamp(p):
    """What ``freeze_params`` would read, cheaply: scalars by value, arrays
    by content, each tensor by identity, data pointer and version counter
    (an in-place edit bumps it; nothing is read from the device), a CPU
    tensor by content.  Equal stamps mean equal content; a stamp that
    moved makes the step work its key out again and copy the values in.
    An edit through a device tensor's ``.data`` bumps no version and is
    not seen: edit the tensor itself, or give the session a new params
    object."""
    if isinstance(p, dict):
        return tuple(sorted((str(k), params_stamp(v)) for k, v in p.items()))
    if isinstance(p, (list, tuple)):
        return tuple(params_stamp(v) for v in p)
    if isinstance(p, torch.Tensor) and p.device.type != "cpu":
        return _Same(p), p.data_ptr(), p._version
    return freeze_params(p)


def refuse_node_hook() -> None:
    """Raise while ``compile.NODE_HOOK`` is set: a per-node host callback
    cannot fire inside a replayed graph, so a session on the card refuses
    it (before any CUDA call, and at every block)."""
    if _compile.NODE_HOOK is not None:
        raise RuntimeError(
            "StreamSession on the card: compile.NODE_HOOK is set, and a "
            "per-node host callback cannot fire inside a replayed CUDA "
            "graph; use utils/obs.debug_render, or device=\"cpu\"")


class BlockStep:
    """The block step of ``cg`` over fixed buffers on ``cg.device``, a
    block of ``block`` samples (a multiple of the graph's 128).

    ``inputs`` rows follow ``keys`` (the Input node ids, or the silent
    length carrier ``"__len__"`` of a graph without inputs); ``outputs``
    rows follow ``cg.output_ids``.  ``captures`` and ``replays`` count the
    CUDA graphs captured and replayed (both stay 0 on the CPU);
    ``bindings`` counts the params' bindings (one a params structure, on
    either device);
    ``capture_s`` is the wall time of the last capture, its warm-up
    included.  The captured graph is kept beside its instance, so that
    it can be written out (:meth:`dump_graph`)."""

    def __init__(self, cg, block: int):
        dev = cg.device
        self.cg = cg
        self.block = int(block)
        self.keys = [str(i) for i in cg.input_ids] or ["__len__"]
        self.inputs = torch.zeros((len(self.keys), self.block), dtype=_F32,
                                  device=dev)
        self.outputs = torch.zeros((len(cg.output_ids), self.block),
                                   dtype=_F32, device=dev)
        self._state = {k: ({kk: state_buffer(v, dev) for kk, v in st.items()}
                           if isinstance(st, dict) else state_buffer(st, dev))
                       for k, st in cg.init_state().items()}
        self.on_card = dev.type == "cuda"
        self.captures = 0
        self.replays = 0
        self.capture_s = 0.0
        self._graph = None          # (CUDAGraph, key, what it reads)
        self._stamp = self._binding = None
        self.bindings = 0
        self._specs = {str(nid): node.spec for nid, node in cg._nodes.items()}

    # -- state ---------------------------------------------------------------

    def read_state(self) -> dict:
        """A copy of the state: tensors cloned, counters as Python ints."""
        def leaf(b):
            if lockstep.is_counter(b):
                return int(b)
            return None if b is None else b.clone()
        return {k: ({kk: leaf(b) for kk, b in st.items()}
                    if isinstance(st, dict) else leaf(st))
                for k, st in self._state.items()}

    def write_state(self, state: dict) -> None:
        """Copy ``state`` (the tree of ``cg.init_state()``) into the
        buffers; the buffers themselves stay, so a captured graph goes on
        reading them."""
        pairs = buffer_pairs(self._state, state, "state")
        for _, v, what in pairs:
            if isinstance(v, torch.Tensor) and v.device != self.cg.device:
                raise ValueError(f"{what} is on {v.device}; the session is "
                                 f"on {self.cg.device}")
        copy_into(pairs)

    # -- the step ------------------------------------------------------------

    def _body(self, params) -> None:
        ext = {k: self.inputs[i] for i, k in enumerate(self.keys)}
        # the step is captured whole, its cycles' blocks inside it: the
        # warm-up runs their Python loop, as the capture does
        with self.cg.cycle_loops.eager():
            new, outs, _aux = self.cg.fn(self._state, ext, params)
        for i, nid in enumerate(self.cg.output_ids):
            self.outputs[i].copy_(outs[nid])
        copy_into(buffer_pairs(self._state, new, "the step's new state"))

    def run(self, params, n: int = 1, before=None, after=None) -> None:
        """``n`` steps under ``params``: on the card, replays of the graph
        captured under ``self.key(params)`` (captured first when there is
        none), the values copied in first when they moved; on the CPU,
        plain calls over the same binding.  ``before(j)`` and ``after(j)``
        run around step j (the stream's copies in and out)."""
        if self.on_card:
            refuse_node_hook()
        key = self.key(params)
        params = self._binding.params
        if self.on_card and (self._graph is None or self._graph[1] != key):
            self._capture(params, key)
        for j in range(n):
            if before is not None:
                before(j)
            if self.on_card:
                try:
                    self._graph[0].replay()
                except RuntimeError as e:
                    raise RuntimeError(f"StreamSession: replaying the "
                                       f"captured block step failed: {e}"
                                       ) from e
                self.replays += 1
            else:
                self._body(params)
            if after is not None:
                after(j)

    def data(self, nid, name) -> bool:
        """Whether ``params[nid][name]`` is data of the step: a non-static
        slider of a node of the graph.  An override of a slider its node
        reads on the host (``host_sliders``: pitch's thresholds) raises,
        as the JAX package's ``process()`` does."""
        spec = self._specs.get(str(nid))
        p = None if spec is None else next(
            (p for p in spec.params if p.name == name), None)
        if not isinstance(p, ParamSpec) or p.static:
            return False
        if name in getattr(spec.impl, "host_sliders", ()):
            raise ValueError(
                f"params[{str(nid)!r}][{name!r}]: the {spec.cfg_name} node "
                f"reads this slider on the host, so a stream step cannot "
                f"take it as data (the JAX package's process() raises on "
                f"it too); set it in the graph")
        return True

    def key(self, params):
        """The key of the capture that runs ``params``: the structure's
        (``capture_key``) and the binding's count.  Worked out again only
        when the stamp of the params or the policy moved since the last
        call; then, with the structure unchanged, the values are copied
        into the binding's buffers and the key stays, unless a form moved
        (utils/sliders), which binds anew."""
        stamp = params_stamp(params), precision.get_policy().name
        if self._stamp is None or self._stamp != stamp:
            skey = capture_key(params, self.data)
            b = self._binding
            if b is None or b.key[0] != skey or not b.move(params):
                self.bindings += 1
                self._binding = Binding(params, self.data, self.cg.device,
                                         (skey, self.bindings))
            self._stamp = stamp
        return self._binding.key

    def dump_graph(self, path: str) -> None:
        """Write the captured graph to ``path`` as Graphviz DOT with every
        node's parameters (``cudaGraphDebugDotPrint``, verbose)."""
        if self._graph is None:
            raise RuntimeError("dump_graph: no graph captured")
        self._graph[0].debug_dump(path)

    def _capture(self, params, key) -> None:
        """Warm the step up on the capture's stream from a copy of the
        state, put the state back, and capture one step."""
        dev = self.cg.device
        t0 = time.perf_counter()
        self._graph = None                   # frees the old graph's pool
        saved = self.read_state()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        try:
            with torch.cuda.stream(side):
                self._body(params)
            torch.cuda.current_stream(dev).wait_stream(side)
            self.write_state(saved)
            torch.cuda.synchronize(dev)
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            with holding() as held, no_collection():
                with torch.cuda.graph(graph, stream=side):
                    self._body(params)
            graph.instantiate()
        except (RuntimeError, ValueError) as e:
            raise RuntimeError(
                f"StreamSession: capturing the block step ({len(self.keys)} "
                f"input rows x {self.block} samples, policy "
                f"{precision.get_policy().name!r}) in a CUDA graph failed: "
                f"{e}") from e
        self._graph = (graph, key, (held, self._binding))
        self.captures += 1
        self.capture_s = time.perf_counter() - t0
