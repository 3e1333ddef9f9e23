"""The composed device-rate output path (the devices.rs playback analog).

The reference's output callback chain is: rivulet source -> persistent
sinc-16 resampler 48 kHz -> device rate (devices.rs:550-556) -> mono
duplicated to both stereo slots (devices.rs:476-480), with underrun
silence and the graduated catch-up protocol.  This module supplies the
pieces the session layer composes, on the host:

* ``host_resample(x, ratio)`` -- one-shot whole-signal resample for file
  export (the host library when built, NumPy otherwise; the same bits);
* ``dup_to_stereo(x)`` -- mono -> interleaved stereo (the host library
  when built);
* ``StreamingSinc16`` -- callback-by-callback resampler with persistent
  tap history and fractional phase, so chained device-rate reads from
  ``StreamSession.drain_output`` reproduce the one-shot resample exactly.

Streaming semantics: output sample k is the 16-tap windowed-sinc
interpolation at input position t = k/ratio, evaluated with an 8-sample
input lookbehind window (indices floor(t)-15 .. floor(t)), a fixed
8-input-sample latency (the Converter's 16-frame ring interpolates between
slots 7 and 8, devices.rs:550).  Chained produce() calls are bit-identical
to ``resample_sinc16(concat(zeros(8), x), ratio)`` on the whole stream.
"""

from __future__ import annotations

import numpy as np

from dsp_stuff_tpu_torch.io import native
from dsp_stuff_tpu_torch.io.resample import HALF, resample_sinc16, sinc16_taps

SAMPLE_RATE = 48_000


def host_resample(x, ratio: float) -> np.ndarray:
    """One-shot sinc-16 resample of a 1-D f32 signal by out/in ``ratio``
    on the host: the host library when built, NumPy otherwise (the two
    give the same bits)."""
    if native.available():
        return native.resample_sinc16(x, ratio)
    return resample_sinc16(x, ratio)


def dup_to_stereo(x) -> np.ndarray:
    """Mono [n] -> interleaved stereo [2n] (devices.rs:476-480)."""
    x = np.ascontiguousarray(np.asarray(x, np.float32))
    if native.available():
        return native.dup_to_stereo(x)
    out = np.empty(2 * x.size, np.float32)
    out[0::2] = x
    out[1::2] = x
    return out


class StreamingSinc16:
    """Persistent-state sinc-16 resampler for the playback callback path.

    State: the last 16 consumed input samples (the tap lookbehind), the
    count of consumed input, and the next output index.  The caller
    (StreamSession.drain_output) asks ``input_needed(n)``, pulls exactly
    that many samples from the ring, and calls ``produce``.
    """

    def __init__(self, device_rate: int, source_rate: int = SAMPLE_RATE):
        self.ratio = float(device_rate) / float(source_rate)
        if self.ratio <= 0:
            raise ValueError(f"bad device rate {device_rate}")
        self.k = 0              # next output sample index
        # the VIRTUAL input count: samples consumed by produce().  A
        # catch-up skip drops samples without advancing it, so the output
        # timeline continues onto the post-skip input (the reference preps
        # its converter with view[offs..] and the fractional phase carries
        # over, devices.rs:421-425)
        self.consumed = 0
        self.hist = np.zeros(2 * HALF, np.float32)   # last 16 seen inputs

    def input_needed(self, n: int) -> int:
        """Input samples required beyond ``consumed`` to emit n outputs:
        the count the reference's Converter consumes
        (release(source().index), devices.rs:434)."""
        if n <= 0:
            return 0
        i0_max = int(np.floor((self.k + n - 1) / self.ratio))
        return max(0, i0_max + 1 - self.consumed)

    def skip(self, samples) -> None:
        """Catch-up: drop a backlog, keeping the tap history continuous
        with the end of the skipped region; the virtual clock does not
        advance."""
        samples = np.asarray(samples, np.float32).ravel()
        self.hist = np.concatenate([self.hist, samples])[-2 * HALF:]

    def produce(self, new_input, n: int) -> np.ndarray:
        """Consume ``input_needed(n)`` fresh samples, emit n output
        samples at the device rate."""
        new_input = np.asarray(new_input, np.float32).ravel()
        need = self.input_needed(n)
        if new_input.size != need:
            raise ValueError(f"expected {need} input samples, "
                             f"got {new_input.size}")
        if n <= 0:
            return np.zeros(0, np.float32)
        ext = np.concatenate([self.hist, new_input]).astype(np.float64)
        base = self.consumed - 2 * HALF       # index of ext[0]
        t = (self.k + np.arange(n, dtype=np.float64)) / self.ratio
        i0 = np.floor(t).astype(np.int64)
        taps = sinc16_taps(t - i0, self.ratio)                # [n, 16]
        m = np.arange(-HALF + 1, HALF + 1, dtype=np.int64)
        # the 8-sample-latency window: x[i0 + m - HALF]; indices before the
        # stream read the zero-initialized history
        idx = i0[:, None] + m[None, :] - HALF - base
        out = (ext[idx] * taps).sum(axis=1).astype(np.float32)
        self.k += n
        self.consumed += new_input.size
        self.hist = np.concatenate([self.hist, new_input])[-2 * HALF:]
        return out
