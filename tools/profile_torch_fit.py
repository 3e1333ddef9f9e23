#!/usr/bin/env python3
"""Where a training step's time goes in dsp_stuff_tpu_torch, on one NVIDIA GPU.

    python3 tools/profile_torch_fit.py

One step of train/fit.py's ``make_train_step`` (loss, backward, Adam,
clamp) fitting the bench chain's 16 sliders under the fast policy, over
B = 64 and 128 streams of 10 s at 48 kHz, as chip_smoke.py drives it: the
wall time of a step (host clock around the step and a synchronize, median
of 5 after a warm-up), its peak device memory, and from ``torch.profiler``
over one more step the device time of the first-order kernel's grid
function (``fo_chained``), of the memsets (the first-order kernel's
scratch among them), of all other device work, and the largest plain ops
by self device time; the idle share is 1 - device time / wall time.

Prints one line per figure with the card's name and power limit.  Needs a
CUDA device; imports nothing of JAX.
"""

import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 48_000
T = 10 * SR
KERNEL_NAMES = ("fo_chained",)


def profile_step(B, card):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    import dsp_stuff_tpu_torch as dst
    from chip_smoke import bench_graph, hidden_params, render_target
    from dsp_stuff_tpu_torch.train import fit
    cg = dst.compile_graph(bench_graph(), device="cuda")
    inp = str(cg.input_ids[0])
    gen = torch.Generator(device="cuda").manual_seed(13)
    ext = {inp: torch.randn((B, T), generator=gen, device="cuda") * 0.25}
    target = render_target(cg, ext, hidden_params(
        cg, gain=("level", 2.0), low_pass=("ratio", 0.7)))
    params = cg.init_params(requires_grad=True)
    step, init_opt = fit.make_train_step(cg, fit.adam(0.03))
    opt = init_opt(params)
    state = cg.init_state()

    def run():
        step(params, opt, state, ext, target)
        torch.cuda.synchronize()

    run()
    torch.cuda.reset_peak_memory_stats()
    secs = []
    for _ in range(5):
        t0 = time.time()
        run()
        secs.append(time.time() - t0)
    wall = float(np.median(secs)) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**30
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    avgs = prof.key_averages()
    dev_ms = {e.key: e.self_device_time_total / 1e3 for e in avgs
              if e.device_type == DeviceType.CUDA}
    total = sum(dev_ms.values())
    fo = sum(v for k, v in dev_ms.items()
             if any(n in k for n in KERNEL_NAMES))
    memset = sum(v for k, v in dev_ms.items() if "memset" in k.lower())
    print(f"bench chain training step, B={B} x 10 s, fast policy [{card}]")
    print(f"  wall time of a step       {wall:9.3f} ms (median of 5)")
    print(f"  peak device memory        {peak:9.3f} GiB")
    print(f"  device time, all work     {total:9.3f} ms")
    print(f"  first-order kernel        {fo:9.3f} ms  {fo / total:6.1%} of "
          f"device time")
    print(f"  memsets                   {memset:9.3f} ms")
    print(f"  all other device work     {total - fo:9.3f} ms")
    print(f"  device idle share         {1 - total / wall:9.1%}")
    ops = sorted((e for e in avgs if e.device_type == DeviceType.CPU
                  and e.key.startswith("aten::")
                  and e.self_device_time_total > 0),
                 key=lambda e: -e.self_device_time_total)
    for e in ops[:10]:
        print(f"    {e.key:27s} {e.self_device_time_total / 1e3:9.3f} ms "
              f"in {e.count} calls")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("profile_torch_fit: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import dsp_stuff_tpu_torch as dst
    from dsp_stuff_tpu_torch.ops import cuda_build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    cuda_build.build("first_order_kernel")
    with dst.policy("fast"):
        for B in (64, 128):
            profile_step(B, card)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
