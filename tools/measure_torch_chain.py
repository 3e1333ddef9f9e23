#!/usr/bin/env python3
"""Where the chain kernel's time goes, on one NVIDIA GPU.

    python3 tools/measure_torch_chain.py

Times dsp_stuff_tpu_torch's chain kernel (csrc/chain_kernel.cu) with CUDA
events (median of 5 after a warm-up) at T = 10 s of 48 kHz audio:

* the bench chain's stage list at B = 128, 256, 512 and 1024 rows: a time
  that stays flat as B grows means the kernel is bound by each row's
  sequential latency, one that doubles means by the SMs' throughput;
* at B = 512, each stage kind of the bench chain alone (one cascade, one
  shaper, the comb) and a lone scale stage, which is the block loop and
  the signal I/O with no work.

Prints one line per measurement with the card's name and power limit.
Needs a CUDA device; imports nothing of JAX.
"""

import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 48_000
T = 10 * SR


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("measure_torch_chain: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from chip_smoke import bench_stages, cuda_ms, seeded_states
    from dsp_stuff_tpu_torch.ops import chain_kernel
    from dsp_stuff_tpu_torch.utils import precision

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    precision.set_policy("fast")
    rng = np.random.default_rng(0)
    dev = torch.device("cuda", 0)
    bench = bench_stages()
    h = bench[1]
    cases = [(f"bench, B={b}", bench, b) for b in (128, 256, 512, 1024)]
    cases += [("scale only, B=512", (h,), 512),
              ("cascade gain+biquad (N=2), B=512", (bench[0],), 512),
              ("cascade lp+hp (N=2), B=512", (bench[3],), 512),
              ("ew overdrive, B=512", (bench[2],), 512),
              ("ew distort:Tanh, B=512", (bench[5],), 512),
              ("ew chebyshev, B=512", (bench[7],), 512),
              ("comb D=2400, B=512", (bench[9],), 512)]
    x_all = torch.as_tensor(
        rng.standard_normal((1024, T), dtype=np.float32) * np.float32(0.25),
        device=dev)
    for name, stages, b in cases:
        x = x_all[:b]
        st = seeded_states(stages, b, rng, dev)
        ms = cuda_ms(lambda: chain_kernel.chain_kernel_call(x, stages, st))
        print(f"{name:36s} {ms:9.3f} ms  {b * T / SR / (ms / 1e3):>12,.0f} "
              f"audio-s/s  [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
