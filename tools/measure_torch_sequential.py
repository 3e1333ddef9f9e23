#!/usr/bin/env python3
"""Check and time the sequential recurrence kernel on one NVIDIA GPU.

    python3 tools/measure_torch_sequential.py [--check]

Builds dsp_stuff_tpu_torch's csrc/sequential_kernel.cu (the exact policy's
per-sample first order and biquad), also as the SQ_CHAIN_ONLY probe (the
chain alone on values made in registers: no copies, no stores), printing
what ptxas reports, then:

* ``--check``: the kernel bitwise against its plain version
  (ops/scan._first_order_sequential, _biquad_sequential) in every mode at
  [512, 4096], T = 1 (2 for the biquad), a run and one sample either
  side, rows not 16-byte aligned;
* always: times (CUDA events, median of 5 after a warm-up) the kernel
  and the probe in every mode at R = 1, 128, 512 and 1024 x 480,000, in
  turns, each beside the chain floor (4 cycles a dependent operation at
  1.98 GHz), the bytes bound and the cycles a sample; and ``y.copy_(x)``
  at [512, 480,000], one read and one write, as a yardstick.

Prints one line per measurement with the card's name and power limit.
Needs a CUDA device; imports nothing of JAX.
"""

import argparse
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
T = 480_000
CLOCK_HZ = 1.98e9


def call(mode, ins, lib=None):
    """(y, final state) of the kernel on ``ins`` (chip_smoke.seq_inputs):
    the wrapper's build, or the build ``lib`` (the SQ_CHAIN_ONLY probe,
    launched here through the same C entry point)."""
    import torch
    from dsp_stuff_tpu_torch.ops import sequential_kernel as sk
    if lib is None:
        if mode == "biquad":
            return sk.biquad_sequential_cuda(*ins)
        return sk.first_order_sequential_cuda(*ins)
    if mode == "biquad":
        x, coef, s_in = ins
        a, kind, s_shape = None, sk._BIQUAD, (x.shape[0], 4)
    else:
        a, x, s_in = ins
        coef, s_shape = None, (x.shape[0],)
        kind = sk._FIRST_ORDER_PS if a.dim() else sk._FIRST_ORDER
    y = torch.empty_like(x)
    s_out = torch.empty(s_shape, dtype=torch.float32, device=x.device)
    rc = lib.sequential_kernel_launch(
        kind, x.data_ptr(), a.data_ptr() if a is not None else None,
        coef.data_ptr() if coef is not None else None, s_in.data_ptr(),
        y.data_ptr(), s_out.data_ptr(), x.shape[0], x.shape[1],
        x.device.index, torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"sequential kernel probe: CUDA error {rc}")
    return y, s_out


def main() -> int:
    import numpy as np
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--check", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("measure_torch_sequential: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import chip_smoke as cs
    from dsp_stuff_tpu_torch.ops import cuda_build
    from dsp_stuff_tpu_torch.ops import sequential_kernel as sk
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(card)
    probe = ("SQ_CHAIN_ONLY",)
    builds = {"default": (), "chain only": probe}
    for (name, d), (lib, log) in zip(builds.items(), cuda_build.build_jobs(
            [("sequential_kernel", d, "") for d in builds.values()])):
        regs = [ln.split(":", 1)[1].strip() for ln in log.splitlines()
                if "registers" in ln]
        print(f"  {name}: {os.path.relpath(lib, ROOT)} {regs}")
    libs = {"default": None,
            "chain only": sk.bind(cuda_build.load("sequential_kernel", probe))}

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(3)
    if args.check:
        for mode in cs.SEQ_MODES:
            for r, t, off in ((512, 4096, 0), (8, 1, 0), (8, 2, 0),
                              (8, 31, 0), (8, 32, 0), (8, 33, 0),
                              (37, 1001, 1), (1, 4097, 1)):
                if mode == "biquad" and t < 2:
                    continue
                ins = cs.seq_inputs(mode, r, t, rng, dev, off)
                k, p = call(mode, ins), cs.seq_plain(mode, ins)
                torch.cuda.synchronize()
                cs.check(all(torch.equal(a, b) for a, b in zip(k, p)),
                         f"{mode} [{r}, {t}] offset {off}: not bitwise the "
                         f"plain version")
        print("  the kernel is bitwise its plain version in every mode")

    for mode in cs.SEQ_MODES:
        floor = cs.seq_floor_ms(mode, T)
        for r in (1, 128, 512, 1024):
            ins = cs.seq_inputs(mode, r, T, rng, dev)
            got = {}
            for name in ("default", "chain only", "chain only", "default"):
                got.setdefault(name, []).append(cs.cuda_ms(
                    lambda: call(mode, ins, libs[name])))
            bms, bby = cs.seq_bound(mode, r, T)
            print(f"{mode}, [{r}, {T}]: " + ", ".join(
                f"{k} {min(v):.3f} ms ({min(v) * 1e-3 * CLOCK_HZ / T:.1f} "
                f"cycles a sample)" for k, v in got.items())
                + f"; chain floor {floor:.3f} ms, bound {bms:.3f} ms by "
                f"{bby} [{card}]")
            del ins
        torch.cuda.empty_cache()
    x = torch.randn((512, T), device=dev)
    y = torch.empty_like(x)
    print(f"y.copy_(x) at [512, {T}]: "
          f"{cs.cuda_ms(lambda: y.copy_(x)):.3f} ms [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
