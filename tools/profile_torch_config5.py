#!/usr/bin/env python3
"""Where config5's render time goes in dsp_stuff_tpu_torch, on one NVIDIA GPU.

    python3 tools/profile_torch_config5.py

config5 is the 16-node feedback graph of models/presets.py, rendered under
the fast policy through ``compile_graph(..., device="cuda")`` and
``render`` at 10 s of 48 kHz audio per stream.  Two measurements:

* for B = 128 and 512 streams: the wall time of one render (CUDA events,
  median of 5 after a warm-up) and, from ``torch.profiler`` over one more
  render, the device time of each of the port's three kernels, of all
  other device work (the plain PyTorch ops, copies and fills) and the
  largest plain ops by self device time; the idle share is
  1 - device time / wall time;
* the chain kernel on config5's planned stage list ([high_pass cascade,
  scale, mtap]) at B = 128: the whole list, each stage alone, and
  segment_fallback (the plain version) of each, so each stage's share of
  the kernel shows; and the whole list at B = 512, to tell a row's
  sequential latency from the SMs' throughput.

Prints one line per figure with the card's name and power limit.  Needs a
CUDA device; imports nothing of JAX.
"""

import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 48_000
T = 10 * SR
KERNELS = ("cycle_kernel", "chain_kernel", "envelope_kernel")


def profile_render(cg, x, B, card):
    import torch
    from torch.profiler import ProfilerActivity, profile
    from chip_smoke import cuda_ms
    from torch.autograd import DeviceType
    wall = cuda_ms(lambda: cg.render(x, batch_shape=(B,)))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        cg.render(x, batch_shape=(B,))
        torch.cuda.synchronize()
    avgs = prof.key_averages()
    # device-side entries (kernels, copies, fills) each hold their own time;
    # host-side aten ops hold the device time of the kernels they launched
    dev_ms = {e.key: e.self_device_time_total / 1e3 for e in avgs
              if e.device_type == DeviceType.CUDA}
    total = sum(dev_ms.values())
    # a kernel's name, as "void chain_kernel<2>(...)" for a template
    ours = {k: sum(v for key, v in dev_ms.items()
                   if key.split("(")[0].split("<")[0].split()[-1] == k)
            for k in KERNELS}
    print(f"config5, B={B} x 10 s, fast policy [{card}]")
    print(f"  wall time of the render   {wall:9.3f} ms (median of 5)")
    print(f"  device time, all work     {total:9.3f} ms")
    for k, v in ours.items():
        print(f"  {k:25s} {v:9.3f} ms  {v / total:6.1%} of device time")
    rest = total - sum(ours.values())
    print(f"  {'all other device work':25s} {rest:9.3f} ms  "
          f"{rest / total:6.1%} of device time")
    print(f"  device idle share         {1 - total / wall:9.1%}")
    ops = sorted((e for e in avgs if e.device_type == DeviceType.CPU
                  and e.key.startswith("aten::")
                  and e.self_device_time_total > 0),
                 key=lambda e: -e.self_device_time_total)
    for e in ops[:8]:
        print(f"    {e.key:23s} {e.self_device_time_total / 1e3:9.3f} ms "
              f"in {e.count} calls")


def chain_attribution(x_all, card):
    import dsp_stuff_tpu_torch as dst
    from chip_smoke import cuda_ms, planned_stages, seeded_states
    from dsp_stuff_tpu_torch.models import presets
    from dsp_stuff_tpu_torch.ops import chain_kernel, chain_segment
    stages, lfos = planned_stages(presets.config5_feedback_16node()[0])
    rng = np.random.default_rng(1)
    cases = [("whole list", stages, lfos)]
    for st in stages:
        cases.append((f"{st[0]} alone", (st,),
                      lfos if st[0] == "mtap" else ()))
    print(f"chain kernel on config5's list {[s[0] for s in stages]}, "
          f"10 s [{card}]")
    whole = None
    with dst.policy("fast"):
        for name, sts, lf in cases:
            for B in ((128, 512) if name == "whole list" else (128,)):
                x = x_all[:B]
                state = seeded_states(sts, B, rng, x.device, T=T, lfos=lf)
                ms = cuda_ms(lambda: chain_kernel.chain_kernel_call(
                    x, sts, state))
                plain = cuda_ms(lambda: chain_segment.segment_fallback(
                    x, sts, state))
                if whole is None:
                    whole = ms
                share = f"{ms / whole:6.1%} of the whole list at B=128" \
                    if B == 128 else ""
                print(f"  {name:14s} B={B:4d}: kernel {ms:8.3f} ms, plain "
                      f"{plain:8.3f} ms  {share}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("profile_torch_config5: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import dsp_stuff_tpu_torch as dst
    from dsp_stuff_tpu_torch.models import presets
    from dsp_stuff_tpu_torch.ops import cuda_build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    cuda_build.build()
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    x_all = torch.as_tensor(
        rng.standard_normal((512, 1, T), dtype=np.float32) * np.float32(0.3),
        device=dev)
    with dst.policy("fast"):
        cg = dst.compile_graph(presets.config5_feedback_16node()[0],
                               device="cuda")
        for B in (128, 512):
            profile_render(cg, x_all[:B], B, card)
    chain_attribution(x_all.reshape(512, T), card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
