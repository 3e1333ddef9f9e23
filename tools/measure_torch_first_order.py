#!/usr/bin/env python3
"""Check and time the first-order recurrence kernel on one NVIDIA GPU.

    python3 tools/measure_torch_first_order.py [--check] [--variants DEFS ...]

Builds dsp_stuff_tpu_torch's csrc/first_order_kernel.cu (printing what
ptxas reports), then:

* ``--check``: holds the kernel and its plain f32 version against the
  float64 solve at chip_smoke.py's edge shapes (T = 1, a tile and one
  sample either side, T = 100,003 with unaligned rows, R = 1 x 480,000,
  R = 1,024 x 4,097, R = 70,000 x 64) and at the fitting path's shape
  [128, 480000], for a in {0, 0.2, 0.6, 0.9, 0.99, 1}, forward, reverse
  and per-sample, with chip_smoke.py's bounds (at a = 0 and 1 only the
  float64 one); b starting off a 16-byte boundary; the kernel bitwise
  against the CPU model of its schedule
  (tests/test_torch_first_order_schedule.py) at small shapes; and ten
  launches at [128, 480000] bitwise equal;
* ``--variants``: builds the kernel with each set of comma-separated
  defines (FO_THREADS=256,FO_SPAN=32; FO_NSTAGE=3; FO_NO_WAIT, the probe
  that skips the carry waits) and times them in turns with the default
  build, every form below;
* always: times the kernel against its plain version with CUDA events
  (median of 5 after a warm-up, each over 20 calls back to back, and one
  call alone, which adds the wrapper's host time) and its device time a
  solve from ``torch.profiler`` (its kernel and memset): scalar
  forward at R = 1, 128 and 512 x 10 s, every form at 128 x 10 s (the
  per-sample reverse solve is the envelope backward's), each with its
  bound (8 bytes a sample, 12 per-sample), and ``y.copy_(b)`` at [128,
  480000], the ceiling of one read and one write as a yardstick.

Prints one line per measurement with the card's name and power limit.
Needs a CUDA device; imports nothing of JAX.
"""

import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
SR = 48_000
T = 10 * SR


def bitwise_vs_model(dev) -> list:
    """The kernel against the test-local model of its schedule, bit for
    bit, at small shapes (every form, ragged and unaligned rows)."""
    import torch
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import test_torch_first_order_schedule as model
    from dsp_stuff_tpu_torch.ops import first_order_kernel
    failed = []
    tile = model.TILE
    for R, TT in ((1, 1), (3, tile - 1), (3, tile + 1), (5, 3 * tile + 5),
                  (2, 12_345), (4, 2 * tile)):
        for form in model.FORMS:
            per_sample, reverse = "per-sample" in form, "reverse" in form
            a, b, y0 = model._inputs(0.99, R, TT, R * TT, per_sample)
            want = model.chained_solve(a, b, y0, reverse)
            got = first_order_kernel.first_order_cuda(
                a.to(dev), b.to(dev), y0.to(dev), reverse).cpu()
            same = torch.equal(got.view(torch.int32), want.view(torch.int32))
            print(f"  kernel vs schedule model [{R}, {TT}] {form:19s}: "
                  f"{'bitwise equal' if same else 'DIFFER'} (max abs "
                  f"{float((got - want).abs().max()):.2e})")
            if not same:
                failed.append(f"model [{R}, {TT}] {form}")
    return failed


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("measure_torch_first_order: needs a CUDA device",
              file=sys.stderr)
        return 1
    sys.path[:0] = [ROOT, HERE]
    from chip_smoke import (FO_FORMS, bound, cuda_ms, fo_check,
                            fo_determinism, fo_edge_shapes, fo_inputs,
                            fo_plain)
    from time_torch_paths import back_to_back_ms, profiled_ms
    from dsp_stuff_tpu_torch.ops import cuda_build, first_order_kernel

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(card)
    variants = [()]
    if "--variants" in sys.argv:
        variants += [tuple(v.split(",")) for v in
                     sys.argv[sys.argv.index("--variants") + 1:]]
    built = cuda_build.build_jobs([("first_order_kernel", v, "")
                                   for v in variants])
    for v, (_, log) in zip(variants, built):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {' '.join(v) or 'default'}:", line.strip())
    dev = torch.device("cuda", 0)
    failed = []
    if "--check" in sys.argv:
        print("kernel vs plain f32 vs float64:")
        seed = 0
        for B, TT in fo_edge_shapes() + ((128, T),):
            print(f" [{B}, {TT}]")
            for a in (0.0, 0.2, 0.6, 0.9, 0.99, 1.0):
                for form in FO_FORMS:
                    seed += 1
                    if a in (0.0, 1.0) and TT == T and B > 1:
                        continue
                    try:
                        fo_check(a, form, B, TT, seed, dev,
                                 vs_plain=a not in (0.0, 1.0))
                    except AssertionError as e:
                        print("  FAILED:", e)
                        failed.append(str(e))
        # b starting 4 bytes past a 16-byte boundary (the wrapper copies it)
        a, b, y0 = fo_inputs(0.9, 3, 5000, 1, dev, True)
        flat = torch.empty(3 * 5000 + 1, device=dev)
        flat[1:] = b.reshape(-1)
        bu = flat[1:].view(3, 5000)
        k = first_order_kernel.first_order_cuda(a, bu, y0, True)
        same = torch.equal(k, first_order_kernel.first_order_cuda(a, b, y0,
                                                                  True))
        print(f"  unaligned b: {'bitwise equal' if same else 'DIFFER'} to "
              f"the aligned solve")
        if not same:
            failed.append("unaligned b")
        failed += bitwise_vs_model(dev)
        try:
            fo_determinism(dev, 10)
        except AssertionError as e:
            print("  FAILED:", e)
            failed.append(str(e))
    cases = ((1, False, False), (128, False, False), (512, False, False),
             (128, True, True), (128, False, True), (128, True, False))
    for B, per_sample, reverse in cases:
        a, b, y0 = fo_inputs(0.6, B, T, 7, dev, per_sample)
        what = (f"{'per-sample' if per_sample else 'scalar'} "
                f"{'reverse' if reverse else 'forward'}")
        n_bytes = (12.0 if per_sample else 8.0) * B * T
        bms, bby = bound(n_bytes, 2.0 * B * T)
        if len(variants) > 1:
            for v in variants * 2:
                def build_solve():
                    return first_order_kernel.first_order_cuda(
                        a, b, y0, reverse, defines=v)
                tk = back_to_back_ms(build_solve)
                td = profiled_ms(build_solve)
                print(f"{what}, B={B} x 10 s, build "
                      f"{' '.join(v) or 'default'}: {tk:.3f} ms "
                      f"({bms / tk:.1%} of its {bms:.3f} ms bound), device "
                      f"{td:.4f} ms a solve [{card}]")

        def solve():
            return first_order_kernel.first_order_cuda(a, b, y0, reverse)
        tk = back_to_back_ms(solve)
        t1 = cuda_ms(solve)
        td = profiled_ms(solve)
        tp = back_to_back_ms(
            lambda: fo_plain(a, b, y0, reverse, torch.float32), inner=5)
        print(f"{what}, B={B} x 10 s: kernel {tk:.3f} ms "
              f"({n_bytes / (tk * 1e-3) / 1e9:.0f} GB/s of its one read and "
              f"one write; {bms / tk:.1%} of its {bms:.3f} ms bound by "
              f"{bby}); one call alone {t1:.3f} ms; device {td:.4f} ms a "
              f"solve (profiler); plain {tp:.3f} ms [{card}]")
        del a, b, y0
    b = torch.randn((128, T), device=dev)
    y = torch.empty_like(b)
    tc = back_to_back_ms(lambda: y.copy_(b))
    gbs = 8.0 * 128 * T / (tc * 1e-3) / 1e9
    print(f"y.copy_(b) at [128, {T}]: {tc:.3f} ms ({gbs:.0f} GB/s) [{card}]")
    print(f"{len(failed)} checks failed")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
