"""Batched, sharded rendering: stereo streams through the 16-node
feedback graph (the port of examples/render_batch.py).

The stream axis is split over a mesh of devices (parallel/mesh.py): every
card by default, or ``--shards`` copies of ``--device``; streams are
independent, so the shards need no exchange.

    python -m dsp_stuff_tpu_torch.examples.render_batch [--device cpu]
        [--streams 64] [--seconds 1.0] [--shards 1]
"""

from __future__ import annotations

import argparse

import numpy as np

import dsp_stuff_tpu_torch as dst
from dsp_stuff_tpu_torch.models import presets
from dsp_stuff_tpu_torch.parallel import mesh as pmesh

SR = 48_000


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="the card (default) or cpu")
    ap.add_argument("--streams", type=int, default=64)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--shards", type=int, default=0,
                    help="shards of --device (default: every card, or one "
                         "shard of the CPU)")
    args = ap.parse_args(argv)
    g, meta = presets.config5_feedback_16node()
    cg = dst.compile_graph(g, device=args.device)
    T = int(args.seconds * SR) // 128 * 128
    x = (np.random.default_rng(0).standard_normal((args.streams, 1, T))
         * 0.2).astype(np.float32)
    if args.shards:
        m = pmesh.make_mesh([args.device] * args.shards)
    elif cg.device.type == "cuda":
        m = pmesh.make_mesh()
    else:
        m = pmesh.make_mesh([cg.device])
    with dst.policy("fast"):
        outs, aux, state = pmesh.render_sharded(cg, x, m)
    cols = aux[f"spectrogram:{meta['spectrogram']}"]["columns"]
    print(f"rendered {tuple(outs.shape)} on {m.size} shard(s) "
          f"({', '.join(str(d) for d in m.devices)}); peak "
          f"{float(outs.abs().max()):.3f}, spectrogram "
          f"{tuple(cols.shape)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
