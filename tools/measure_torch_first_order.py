#!/usr/bin/env python3
"""Check and time the first-order recurrence kernel on one NVIDIA GPU.

    python3 tools/measure_torch_first_order.py

Builds dsp_stuff_tpu_torch's csrc/first_order_kernel.cu (printing what
ptxas reports), then:

* holds the kernel and its plain f32 version against the float64 solve at
  edge shapes (T = 1, one tile, one tile plus one sample, R = 1) and at
  the fitting path's shape [128, 480000], for a in {0, 0.2, 0.6, 0.9,
  0.99, 1}, forward, reverse and per-sample, with chip_smoke.py's bounds
  (at the slider ends a = 0 and 1 only the float64 one: at a = 1, a
  running sum, the plain blocked solve rounds less than a sequential
  one);
* times the kernel against its plain version with CUDA events (median of
  5 after a warm-up): scalar forward at B = 1, 128 and 512 x 10 s, and the
  per-sample reverse solve (the envelope backward's) at B = 128 x 10 s.

Prints one line per measurement with the card's name and power limit.
Needs a CUDA device; imports nothing of JAX.
"""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 48_000
T = 10 * SR


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("measure_torch_first_order: needs a CUDA device",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from chip_smoke import cuda_ms, fo_check, fo_inputs, fo_plain
    from dsp_stuff_tpu_torch.ops import cuda_build, first_order_kernel

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(card)
    _, log = cuda_build.build("first_order_kernel")["first_order_kernel"]
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print("  ptxas:", line.strip())
    dev = torch.device("cuda", 0)
    forms = ("forward", "reverse", "per-sample forward", "per-sample reverse")
    print("kernel vs plain f32 vs float64:")
    seed = 0
    failed = []
    for B, TT in ((3, 1), (2, 4096), (2, 4097), (1, 100_000), (128, T)):
        print(f" [{B}, {TT}]")
        for a in (0.0, 0.2, 0.6, 0.9, 0.99, 1.0):
            for form in forms:
                seed += 1
                if a in (0.0, 1.0) and TT == T:
                    continue
                if a == 1.0 and TT > 4097:
                    continue        # a sum of 1e5 terms: f32 is not the point
                try:
                    fo_check(a, form, B, TT, seed, dev,
                             vs_plain=a not in (0.0, 1.0))
                except AssertionError as e:
                    print("  FAILED:", e)
                    failed.append(str(e))
    for B, per_sample, reverse in ((1, False, False), (128, False, False),
                                   (512, False, False), (128, True, True)):
        a, b, y0 = fo_inputs(0.6, B, T, 7, dev, per_sample)
        tk = cuda_ms(lambda: first_order_kernel.first_order_cuda(
            a, b, y0, reverse))
        tp = cuda_ms(lambda: fo_plain(a, b, y0, reverse, torch.float32))
        what = "per-sample reverse" if per_sample else "scalar forward"
        gbs = (3 if not per_sample else 5) * 4 * B * T / (tk * 1e-3) / 1e9
        print(f"{what}, B={B} x 10 s: kernel {tk:.3f} ms "
              f"({gbs:.0f} GB/s of its 2 reads + 1 write), plain {tp:.3f} ms "
              f"[{card}]")
        del a, b, y0
    print(f"{len(failed)} checks failed")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
