"""Streaming block session: the live-rack operating mode.

The reference processes audio as an endless stream of 128-sample blocks
pulled through per-node tasks (node.rs:267-352).  The session keeps ONE
compiled graph on its device and carries the state across calls:

    sess = StreamSession(graph)            # the card by default
    out = sess.process(in_block)           # [block] in -> [n_out, block] out

The block step runs over fixed buffers on the session's device: the
input blocks, the state and the outputs (runtime/block_graph.BlockStep).
On the card it is captured once in a CUDA graph and replayed for every
block, the counterpart of the JAX package's ``jax.jit`` of the step: a
``process()`` block is a copy in, one graph launch, a copy out and one
wait, and ``process_many(k)`` is k replays with one copy of the outputs
to the host at the end, bitwise k ``process()`` calls (the same kernels
in the same order).  ``params`` are data, as they are arguments of the
JAX package's jitted step: a moved slider (a new dict of the same
structure, or a value edited in place) is a copy into the device buffers
the captured graph reads before the next block, bitwise the eager step
that takes the values as Python floats.  What the capture is keyed on is
the params' structure (which sliders are overridden, each a float or a
tensor of which shape and dtype; a static slider's value) and the
precision policy: a change of either captures again, as does a move
across a branch a node's float path takes on a value (a biquad's
degenerate forms, runtime/block_graph.py).  The JAX package's
``process_many`` traces its scan again when the params change; the
port's replays take the new values with no capture (the same values).
On the CPU the same step runs as plain calls over the same buffers.
Setting ``state`` copies into the buffers.

Device I/O (the cpal analog) is modeled by host-side ring buffers (the
host library's SPSC ring when built, ``_PyRing`` otherwise) with the
reference's failure semantics:
write overrun drops the excess (devices.rs:239-241), read underrun
zero-fills (devices.rs:436-440), and ``resync()`` drains every ring
(runtime.rs:524-526, 587-594).

``block_size`` may be any multiple of 128; semantics that depend on the
128 frame (Fuzz block-max, signal_gen phase wrap) are evaluated on the 128
grid inside the step regardless.
"""

from __future__ import annotations

import numpy as np
import torch

from dsp_stuff_tpu_torch.compiler.compile import compile_graph
from dsp_stuff_tpu_torch.graph import Graph
from dsp_stuff_tpu_torch.io import native
from dsp_stuff_tpu_torch.io.playback import StreamingSinc16, dup_to_stereo
from dsp_stuff_tpu_torch.runtime.block_graph import (BlockStep,
                                                    refuse_node_hook)


class _PyRing:
    """NumPy stand-in for native.Ring with the same semantics: an ndarray
    circular buffer (slice copies, no per-sample Python)."""

    def __init__(self, capacity: int = 8192):
        self._cap = capacity
        self._buf = np.zeros(capacity, np.float32)
        self._head = 0          # read position
        self._size = 0

    def write(self, x) -> int:
        x = np.asarray(x, np.float32).ravel()
        k = min(x.size, self._cap - self._size)
        if k:
            start = (self._head + self._size) % self._cap
            end = start + k
            if end <= self._cap:
                self._buf[start:end] = x[:k]
            else:
                split = self._cap - start
                self._buf[start:] = x[:split]
                self._buf[:end - self._cap] = x[split:k]
            self._size += k
        return k

    def read(self, n: int) -> np.ndarray:
        k = min(n, self._size)
        out = np.empty(k, np.float32)
        end = self._head + k
        if end <= self._cap:
            out[:] = self._buf[self._head:end]
        else:
            split = self._cap - self._head
            out[:split] = self._buf[self._head:]
            out[split:] = self._buf[:end - self._cap]
        self._head = end % self._cap
        self._size -= k
        return out

    @property
    def readable(self) -> int:
        return self._size

    @property
    def writable(self) -> int:
        return self._cap - self._size

    def drain(self) -> None:
        self._head = 0
        self._size = 0


def make_ring(capacity: int = 8192):
    """The host library's SPSC ring when built, ``_PyRing`` otherwise.
    8192 is the reference's per-link capacity (runtime.rs:568)."""
    if native.available():
        return native.Ring(capacity)
    return _PyRing(capacity)


class StreamSession:
    """A compiled graph and its state on ``device``; processes fixed-size
    blocks.  ``device`` is the card by default ("cpu" for the CPU); without
    a CUDA device the default raises RuntimeError, as does a session on
    the card while ``compile.NODE_HOOK`` is set (a host callback cannot
    fire inside a replayed graph).

    ``step`` is the block step over its buffers (``step.captures`` and
    ``step.replays`` count the CUDA graphs captured and replayed).
    ``params`` ({node id: {slider: value}}) may be replaced or edited
    between calls; its values are copied in before the next block, and
    only a change of its structure captures again.  An override of a
    slider a node reads on the host (pitch's thresholds) raises, as in
    the JAX package."""

    def __init__(self, graph: Graph, block_size: int = 128,
                 ring_capacity: int = 8192, params=None, device="cuda"):
        if block_size % 128:
            raise ValueError("block_size must be a multiple of 128 "
                             "(the reference frame, node.rs:257)")
        if torch.device(device).type == "cuda":
            refuse_node_hook()
        self.block_size = block_size
        self.cg = compile_graph(graph, block_size=128, device=device)
        self.device = self.cg.device
        self.step = BlockStep(self.cg, block_size)
        self.params = params
        # fixed host copies of one block in and out (pinned on the card,
        # so the copies neither wait for nor are waited on by the host)
        pin = self.device.type == "cuda"
        self._in_host = torch.zeros(self.step.inputs.shape,
                                    dtype=torch.float32, pin_memory=pin)
        self._out_host = torch.zeros(self.step.outputs.shape,
                                     dtype=torch.float32, pin_memory=pin)
        # host-side device rings: one per Input node (capture) and one per
        # Output node (playback)
        self.in_rings = {nid: make_ring(ring_capacity)
                         for nid in self.cg.input_ids}
        self.out_rings = {nid: make_ring(ring_capacity)
                          for nid in self.cg.output_ids}
        # per-output catch-up counter (the reference's per-device AtomicU8
        # resync counter, devices.rs:33,150-156)
        self._catchup = {nid: 0 for nid in self.cg.output_ids}
        # per-(output, device_rate) streaming resampler (the reference's
        # persistent Converter<CountingSignal, Sinc>, devices.rs:550-556)
        self._resamplers = {}

    @property
    def state(self) -> dict:
        """A copy of the DSP state (tensors cloned, lockstep counters as
        Python ints), as ``cg.init_state()`` lays it out."""
        return self.step.read_state()

    @state.setter
    def state(self, state: dict) -> None:
        """Copies ``state`` into the step's buffers (a checkpoint restore,
        ``reset()``); the buffers a captured graph reads stay."""
        self.step.write_state(state)

    # -- direct block API --------------------------------------------------

    def _host_blocks(self, inputs, k: int) -> np.ndarray:
        """[k, rows, block] float32 in the step's input rows; inputs absent
        from a dict (and the length carrier of a graph without inputs) are
        silence.  A dict key that names no Input node, or an array with
        fewer rows than the graph has inputs, raises."""
        B = self.block_size
        keys = self.step.keys
        arr = np.zeros((k, len(keys), B), np.float32)
        if isinstance(inputs, dict):
            for key, v in inputs.items():
                if str(key) not in keys:
                    raise ValueError(f"input {key!r} names no Input node of "
                                     f"the graph (its inputs: {keys})")
                a = np.asarray(v, np.float32)
                if a.shape[-1] != k * B:
                    raise ValueError(f"input {key!r}: {a.shape[-1]} samples, "
                                     f"expected {k} x {B}")
                arr[:, keys.index(str(key))] = a.reshape(k, B)
        elif inputs is not None:
            a = np.atleast_2d(np.asarray(inputs, np.float32))
            if a.shape[-1] != k * B:
                raise ValueError(f"inputs carry {a.shape[-1]} samples, "
                                 f"expected {k} x {B}")
            n = len(self.cg.input_ids)
            if a.shape[0] < n:
                raise ValueError(f"inputs carry {a.shape[0]} rows; the graph "
                                 f"has {n} inputs")
            arr[:, :n] = a[:n].reshape(n, k, B).transpose(1, 0, 2)
        return arr

    def process(self, inputs=None) -> np.ndarray:
        """Process one block under ``self.params`` (moved values copied in
        first).  inputs: {input_node_id: [block]} or [n_inputs, block] or
        None (silence).  Returns [n_out, block]."""
        self._in_host.numpy()[:] = self._host_blocks(inputs, 1)[0]
        step = self.step
        step.run(self.params,
                 before=lambda j: step.inputs.copy_(self._in_host,
                                                    non_blocking=True),
                 after=lambda j: self._out_host.copy_(step.outputs,
                                                      non_blocking=True))
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return self._out_host.numpy().copy()

    def process_many(self, inputs=None, n_blocks: int | None = None):
        """Process k consecutive blocks in one call: the step of
        ``process`` k times on the device (k replays of its graph on the
        card), the inputs copied in once and the outputs copied to the
        host once, all k under ``self.params`` (copied in once when they
        moved).  Bitwise equal to k ``process()`` calls.

        inputs: {input_node_id: [k*block]} / [n_inputs, k*block] / None or
        {} (then ``n_blocks`` is required).  Returns [n_out, k*block].
        """
        B = self.block_size
        if inputs is None or (isinstance(inputs, dict) and not inputs):
            if not n_blocks:
                raise ValueError("process_many() needs inputs or n_blocks: "
                                 "silence carries no block count")
            k = int(n_blocks)
        else:
            first = (next(iter(inputs.values())) if isinstance(inputs, dict)
                     else inputs)
            T = np.shape(first)[-1]
            if T % B:
                raise ValueError(f"input length {T} is not a multiple of "
                                 f"block_size {B}")
            k = T // B
            if n_blocks is not None and int(n_blocks) != k:
                raise ValueError(f"n_blocks={n_blocks} but inputs carry "
                                 f"{k} blocks")
        step = self.step
        ins = torch.from_numpy(self._host_blocks(inputs, k)).to(self.device)
        outs = torch.empty((k, *step.outputs.shape), dtype=torch.float32,
                           device=self.device)
        step.run(self.params, k,
                 before=lambda j: step.inputs.copy_(ins[j]),
                 after=lambda j: outs[j].copy_(step.outputs))
        return outs.permute(1, 0, 2).reshape(len(self.cg.output_ids),
                                             k * B).cpu().numpy()

    # -- ring-buffered device-style API -------------------------------------

    def feed(self, node_id: int, samples) -> int:
        """Capture-side write (overrun drops, devices.rs:239-241)."""
        return self.in_rings[node_id].write(samples)

    def pump(self) -> bool:
        """Run one block if every input ring has a block buffered.
        Output blocks land in the output rings.  Returns True if a block
        was processed."""
        B = self.block_size
        if any(r.readable < B for r in self.in_rings.values()):
            return False
        out = self.process({str(nid): r.read(B)
                            for nid, r in self.in_rings.items()})
        for i, nid in enumerate(self.cg.output_ids):
            self.out_rings[nid].write(out[i])
        return True

    def drain_output(self, node_id: int, n: int,
                     device_rate: int | None = None,
                     stereo: bool = False) -> np.ndarray:
        """Playback-side read with the reference's callback semantics
        (devices.rs:400-500):

        * underrun (fewer source samples buffered than the read needs) ->
          a full block of silence, the ring untouched (try_grant fails,
          devices.rs:436-440,495-499);
        * otherwise the catch-up counter saturating-decrements once per
          read, and if its PREVIOUS value was > 0 while the backlog is
          >= 2 blocks' worth of input, the backlog is skipped: the newest
          samples play and everything older is dropped
          (devices.rs:408-427,459-483).

        ``device_rate`` (the composed output path, devices.rs:516-556):
        ``n`` counts DEVICE-rate samples; the read pulls the exact number
        of 48 kHz source samples the persistent sinc-16 resampler consumes
        (devices.rs:434) and emits n resampled samples, chained reads
        bit-identical to a one-shot ``resample_sinc16`` of the
        8-sample-delayed source stream (io/playback.StreamingSinc16).
        ``stereo`` duplicates the mono result into interleaved stereo [2n]
        (devices.rs:476-480).
        """
        out = self._drain_mono(node_id, n, device_rate)
        return dup_to_stereo(out) if stereo else out

    def _drain_mono(self, node_id: int, n: int,
                    device_rate: int | None) -> np.ndarray:
        ring = self.out_rings[node_id]
        if device_rate is None or device_rate == 48_000:
            if ring.readable < n:
                return np.zeros(n, np.float32)
            c = self._catchup[node_id]
            self._catchup[node_id] = c - 1 if c > 0 else 0  # saturating_sub
            backlog = ring.readable - n
            if c > 0 and backlog >= 2 * n:
                ring.read(backlog)      # skip ahead; ring drains fully
            return ring.read(n)

        key = (node_id, int(device_rate))
        rs = self._resamplers.get(key)
        if rs is None:
            rs = self._resamplers[key] = StreamingSinc16(int(device_rate))
        input_len = rs.input_needed(n)
        if ring.readable < input_len:
            return np.zeros(n, np.float32)      # underrun, nothing advances
        c = self._catchup[node_id]
        self._catchup[node_id] = c - 1 if c > 0 else 0
        backlog = ring.readable - input_len
        if c > 0 and backlog >= 2 * input_len:
            rs.skip(ring.read(backlog))         # drop oldest, keep history
        return rs.produce(ring.read(input_len), n)

    def resync(self) -> None:
        """The Sync-output action (runtime.rs:513-529): inter-node pipes
        drain (the input rings; the compiled graph holds no buffered
        audio) and every output's catch-up counter gains 5
        (TriggerResync, devices.rs:150-156; an AtomicU8, so the add wraps
        at 256).  Output rings are NOT drained: the playback reader skips
        their backlog gradually (drain_output).  DSP state is kept, as in
        the reference."""
        for r in self.in_rings.values():
            r.drain()
        for nid in self._catchup:
            self._catchup[nid] = (self._catchup[nid] + 5) & 0xFF

    def reset(self) -> None:
        """Fresh DSP state (the restart_node analog, runtime.rs:153)."""
        self.state = self.cg.init_state()
