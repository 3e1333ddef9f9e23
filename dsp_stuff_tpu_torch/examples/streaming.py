"""Streaming block processing with ring-buffer device I/O (the port of
examples/streaming.py).

The live-rack operating mode: feed capture samples in, pump compiled
blocks, drain playback samples out, with the reference's overrun and
underrun semantics (runtime/stream.py).  On the card every block is one
replay of the session's captured CUDA graph.

    python -m dsp_stuff_tpu_torch.examples.streaming [--device cpu]
        [--seconds 1.0]
"""

from __future__ import annotations

import argparse

import numpy as np

import dsp_stuff_tpu_torch as dst
from dsp_stuff_tpu_torch.ids import IdSpace

SR = 48_000


def rack() -> tuple:
    """input -> overdrive -> reverb -> output, and the input and output
    node ids."""
    g = dst.Graph(IdSpace())
    inp = g.add("input")
    od = g.add("overdrive", boost=6.0, drive=0.7, level=0.9)
    rv = g.add("reverb", seconds=0.05, decay=0.4)
    out = g.add("output")
    g.chain(inp, od, rv, out)
    return g, inp.id, out.id


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="the card (default) or cpu")
    ap.add_argument("--seconds", type=float, default=1.0,
                    help="length of the 220 Hz test tone")
    args = ap.parse_args(argv)
    g, inp, out = rack()
    total = int(args.seconds * SR)
    sig = (np.sin(2 * np.pi * 220.0 * np.arange(total) / SR) * 0.5
           ).astype(np.float32)

    # a capture callback delivering irregular chunk sizes
    sess = dst.StreamSession(g, block_size=128, device=args.device)
    rng = np.random.default_rng(0)
    pos, played = 0, []
    while pos < total:
        n = int(rng.integers(64, 400))
        sess.feed(inp, sig[pos:pos + n])
        pos += n
        while sess.pump():
            pass
        played.append(sess.drain_output(out, 128))
    y = np.concatenate(played)
    print(f"streamed {pos} samples in, {y.size} out, peak "
          f"{np.abs(y).max():.3f}, rms {np.sqrt((y ** 2).mean()):.3f} "
          f"({sess.step.replays} replays of {sess.step.captures} captured "
          f"graph(s) on {sess.device})")

    # device-rate playback: drain a session at 44.1 kHz interleaved
    # stereo, like the reference's output callback (sinc-16 and
    # dup-to-stereo, devices.rs:476-556)
    sess2 = dst.StreamSession(g, device=args.device)
    sess2.feed(inp, sig[:8192])
    while sess2.pump():
        pass
    dev = np.concatenate([sess2.drain_output(out, 441, device_rate=44_100,
                                             stereo=True)
                          for _ in range(10)])
    print(f"device-rate drain: {dev.size // 2} stereo frames @ 44.1 kHz, "
          f"peak {np.abs(dev).max():.3f}")

    # k blocks a call: the outputs come back to the host once
    sess3 = dst.StreamSession(g, device=args.device)
    k = total // 128
    y3 = sess3.process_many({str(inp): sig[:128 * k]})
    print(f"process_many: {y3.shape[-1]} samples ({k} blocks) in one call")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
