"""Streaming block session: the live-rack operating mode.

The reference processes audio as an endless stream of 128-sample blocks
pulled through per-node tasks (node.rs:267-352).  The session keeps ONE
compiled graph on its device and carries the state across calls:

    sess = StreamSession(graph)            # the card by default
    out = sess.process(in_block)           # [block] in -> [n_out, block] out

The compiled graph and its state stay on the session's device between
calls; blocks come in and go out as NumPy arrays (one host-to-device copy
per input and one device-to-host copy per call).  Device I/O (the cpal
analog) is modeled by host-side ring buffers (the host library's SPSC ring
when built, ``_PyRing`` otherwise) with the reference's failure semantics:
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
    a CUDA device the default raises RuntimeError."""

    def __init__(self, graph: Graph, block_size: int = 128,
                 ring_capacity: int = 8192, params=None, device="cuda"):
        if block_size % 128:
            raise ValueError("block_size must be a multiple of 128 "
                             "(the reference frame, node.rs:257)")
        self.block_size = block_size
        self.cg = compile_graph(graph, block_size=128, device=device)
        self.device = self.cg.device
        self.state = self.cg.init_state()
        self.params = params
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
        self._silence = {}      # zero blocks on the device, by block count

    # -- direct block API --------------------------------------------------

    def _zeros(self, k: int) -> torch.Tensor:
        """[k, block] zeros on the device, made once per k."""
        z = self._silence.get(k)
        if z is None:
            z = self._silence[k] = torch.zeros(
                (k, self.block_size), dtype=torch.float32, device=self.device)
        return z

    def _ext_blocks(self, inputs, k: int) -> dict:
        """{input key: [k, block] tensor on the device}; absent inputs are
        silence, and a graph without inputs gets a silent length carrier."""
        B = self.block_size
        ext = {}
        if isinstance(inputs, dict):
            for key, v in inputs.items():
                a = np.asarray(v, np.float32)
                if a.shape[-1] != k * B:
                    raise ValueError(f"input {key!r}: {a.shape[-1]} samples, "
                                     f"expected {k} x {B}")
                ext[str(key)] = torch.from_numpy(
                    np.ascontiguousarray(a.reshape(k, B))).to(self.device)
        elif inputs is not None:
            arr = np.atleast_2d(np.asarray(inputs, np.float32))
            if arr.shape[-1] != k * B:
                raise ValueError(f"inputs carry {arr.shape[-1]} samples, "
                                 f"expected {k} x {B}")
            dev = torch.from_numpy(np.ascontiguousarray(
                arr.reshape(arr.shape[0], k, B))).to(self.device)
            ext = {str(nid): dev[i] for i, nid in enumerate(self.cg.input_ids)}
        for i in self.cg.input_ids:
            ext.setdefault(str(i), self._zeros(k))
        if not ext:
            ext["__len__"] = self._zeros(k)
        return ext

    def _run(self, ext: dict, k: int) -> np.ndarray:
        """k blocks of ``ext`` through the one-block step, the outputs kept
        on the device until one copy to the host: [n_out, k*block]."""
        B = self.block_size
        outs = []
        for j in range(k):
            self.state, o, _aux = self.cg.fn(
                self.state, {key: v[j] for key, v in ext.items()},
                self.params)
            outs.append([o[i].expand(B) for i in self.cg.output_ids])
        if not self.cg.output_ids:
            return np.zeros((0, k * B), np.float32)
        y = torch.stack([torch.cat(ch) for ch in zip(*outs)])
        return y.cpu().numpy()

    def process(self, inputs=None) -> np.ndarray:
        """Process one block.  inputs: {input_node_id: [block]} or
        [n_inputs, block] or None (silence).  Returns [n_out, block]."""
        return self._run(self._ext_blocks(inputs, 1), 1)

    def process_many(self, inputs=None, n_blocks: int | None = None):
        """Process k consecutive blocks in one call: the same one-block
        step as ``process`` run k times on the device, the outputs copied
        to the host once.  Bitwise equal to k ``process()`` calls.

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
        return self._run(self._ext_blocks(inputs, k), k)

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
