#!/usr/bin/env python3
"""Time the port's kernel entry points and main paths of one checkout.

    python3 tools/time_torch_paths.py [--root DIR] [--renders | --grads]

Imports dsp_stuff_tpu_torch and chip_smoke from DIR (default: this
checkout), so that two commits can be compared in one call on one card:
unpack the other commit into a git-ignored directory (git archive) and run
this script against each in turns (A, B, B, A).  It uses only entry points
both sides share (chain_kernel.chain_kernel_call, cycle_kernel.
cycle_kernel_call, envelope_kernel.peak_envelope_cuda,
first_order_kernel.first_order_cuda, compile_graph(..., device="cuda")
.render, train.fit.make_train_step; the envelope kernel's gains are two
host floats in an older root, one [2] device tensor since they became
device data) and times with CUDA events, median of 5 after a warm-up, at
10 s of 48 kHz audio, inputs from fixed seeds:

* the chain kernel on the bench list at B = 128 and 512;
* the chain kernel on config5's [hp, mtap] list at B = 128;
* the cycle kernel on config5's program at B = 128 and 512;
* the envelope kernel chunked (chunk 32768) at B = 128 and 512, and
  sequential at B = 4 x 48,000 (config5's parity path);
* the first-order kernel scalar forward at R = 1 and 128 and per-sample
  reverse at R = 128 (chip_smoke.fo_inputs, a = 0.6), each timing over 20
  solves back to back, and its device time a solve from torch.profiler
  (every kernel and memset of the call, over 10 calls; at R = 1 the
  back-to-back time is the host's time a call);
* the bench chain's render at B = 512, config5's at B = 128 and 512,
  config3's (4x-oversampled overdrive and distortion) at B = 512 and
  config4's (two 48,000-tap FIRs, the 1 s stereo IR) at B = 256; a root
  whose port cannot build or render a preset prints why instead;
* a training step of the bench chain's 16 sliders at B = 128 (the host
  clock around the step and a synchronize, median of 5 after a warm-up).

``--renders`` times the renders alone.  ``--grads`` times, alone, the bench
chain's and config5's input gradients at B = 128 (the root's
chip_smoke.grad_split: the forward and the backward on the host's clock,
medians of 3 after a first call, and one forward + backward's device time
by torch.profiler, split by op group, with the port's kernels' device
times; the peak device memory of one forward + backward; and the device
time under each backward node, the largest eight, by this checkout's
``backward_by_node``), and, where
the root's chain kernel has a record build, that build beside the plain
one on the bench list at B = 128 (CUDA events, in turns: plain, record,
record, plain).  Prints one line per measurement
with the root and the card's name and power limit.  Needs a CUDA device;
imports nothing of JAX.
"""

import inspect
import os
import subprocess
import sys
import time

import numpy as np

SR = 48_000
T = 10 * SR


def profiled_ms(fn, n=10):
    """Device ms a call of fn (every kernel and memset) from torch.profiler
    over n calls after a warm-up."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3 / n


def backward_by_node(run, top=8):
    """{autograd node: device ms} of one call of run() (a forward and a
    backward) from torch.profiler: the device time under each backward
    node's ``autograd::engine::evaluate_function`` range (the kernels it
    launched), the ``top`` largest, after a warm-up call."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    pre = "autograd::engine::evaluate_function: "
    got = {e.key[len(pre):]: e.device_time_total / 1e3
           for e in prof.key_averages() if e.key.startswith(pre)}
    return dict(sorted(got.items(), key=lambda kv: -kv[1])[:top])


def back_to_back_ms(fn, inner=20, n=5):
    """Median of n CUDA-event timings of ``inner`` calls of fn() back to
    back, a call, after a warm-up (this checkout's timer, so that both
    roots are timed alike)."""
    import torch
    fn()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return float(np.median(times))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("time_torch_paths: needs a CUDA device", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    root = os.path.abspath(sys.argv[sys.argv.index("--root") + 1]
                           if "--root" in sys.argv else here)
    renders_only = "--renders" in sys.argv
    grads_only = "--grads" in sys.argv
    sys.path[:0] = [root, os.path.join(root, "tests")]
    import chip_smoke as cs
    import dsp_stuff_tpu_torch as dst
    from dsp_stuff_tpu_torch.models import presets
    from dsp_stuff_tpu_torch.ops import (chain_kernel, cycle_kernel,
                                         envelope, envelope_kernel,
                                         first_order_kernel)
    from dsp_stuff_tpu_torch.train import fit

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    tag = f"[{os.path.relpath(root, here)}] [{card}]"
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(3)
    x_all = torch.as_tensor(
        rng.standard_normal((512, T), dtype=np.float32) * np.float32(0.25),
        device=dev)
    g5 = presets.config5_feedback_16node()[0]
    if grads_only:
        del x_all
        with dst.policy("fast"):
            for name, graph in (("bench chain", cs.bench_graph()),
                                ("config5", g5)):
                cg = dst.compile_graph(graph, device="cuda")
                rg = np.random.default_rng(120)
                x = torch.as_tensor(rg.standard_normal(
                    (128, T), dtype=np.float32) * np.float32(0.25),
                    device=dev)
                tgt = torch.as_tensor(rg.standard_normal(
                    (128, 1, T), dtype=np.float32) * np.float32(0.1),
                    device=dev)
                cs.grad_split(f"{name} input gradient, [128, {T}] "
                              f"[{os.path.relpath(root, here)}]", cg, x, tgt,
                              card)
                xt = x.clone().requires_grad_(True)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats(dev)
                loss = fit.make_loss_fn(cg)({}, cg.init_state(),
                                            {str(cg.input_ids[0]): xt}, tgt)
                loss.backward()
                torch.cuda.synchronize()
                print(f"{name} input gradient, [128, {T}]: peak device memory "
                      f"{torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB "
                      f"{tag}")

                def step():
                    xg = x.clone().requires_grad_(True)
                    fit.make_loss_fn(cg)({}, cg.init_state(),
                                         {str(cg.input_ids[0]): xg},
                                         tgt).backward()
                nodes = backward_by_node(step)
                print(f"{name} input gradient, [128, {T}]: device ms under "
                      f"each backward node: " + ", ".join(
                          f"{k} {v:.3f}" for k, v in nodes.items())
                      + f" {tag}")
                del cg, x, tgt, xt, loss
                torch.cuda.empty_cache()
            if "record" in inspect.signature(
                    chain_kernel.chain_kernel_call).parameters:
                bench = cs.bench_stages()
                st = cs.seeded_states(bench, 128, rng, dev)
                x = torch.as_tensor(rng.standard_normal(
                    (128, T), dtype=np.float32) * np.float32(0.25),
                    device=dev)
                plain = [cs.cuda_ms(lambda: chain_kernel.chain_kernel_call(
                    x, bench, st))]
                rec = [cs.cuda_ms(lambda: chain_kernel.chain_kernel_call(
                    x, bench, st, record=True)) for _ in range(2)]
                plain.append(cs.cuda_ms(lambda: chain_kernel.chain_kernel_call(
                    x, bench, st)))
                print(f"chain kernel, bench list, B=128: plain build "
                      f"{np.median(plain):.3f} ms, record build "
                      f"{np.median(rec):.3f} ms (in turns) {tag}")
        return 0
    with dst.policy("fast"):
        if not renders_only:
            bench = cs.bench_stages()
            for b in (128, 512):
                st = cs.seeded_states(bench, b, rng, dev)
                x = x_all[:b]
                ms = cs.cuda_ms(lambda: chain_kernel.chain_kernel_call(
                    x, bench, st))
                print(f"chain kernel, bench list, B={b}: {ms:.3f} ms {tag}")
            stages5, lfos5 = cs.planned_stages(g5)
            st5 = cs.seeded_states(stages5, 128, rng, dev, T=T, lfos=lfos5)
            x = x_all[:128]
            ms = cs.cuda_ms(lambda: chain_kernel.chain_kernel_call(
                x, stages5, st5))
            print(f"chain kernel, config5 list, B=128: {ms:.3f} ms {tag}")
            program, n_taps = cs.cycle_program(g5)
            for b in (128, 512):
                ins = cs.cycle_inputs(program, b, T, rng, dev)
                ms = cs.cuda_ms(lambda: cycle_kernel.cycle_kernel_call(
                    *ins, program, n_taps))
                print(f"cycle kernel, config5 program, B={b}: {ms:.3f} ms "
                      f"{tag}")
                del ins
            atk = envelope.gain_from_frames(50.0)
            rel = envelope.gain_from_frames(400.0)
            # the kernel's gains: one [2] device tensor since the gains
            # became device data, two host floats before
            gains = ((cs.env_gains(atk, rel, dev),) if "gains" in
                     inspect.signature(envelope_kernel.peak_envelope_cuda)
                     .parameters else (atk, rel))
            for b, t, chunk, what in ((128, T, envelope._CHUNK, "chunked"),
                                      (512, T, envelope._CHUNK, "chunked"),
                                      (4, SR, SR, "sequential")):
                x = x_all[:b, :t].contiguous()
                e0 = torch.as_tensor(rng.random(b).astype(np.float32),
                                     device=dev)
                ms = cs.cuda_ms(lambda: envelope_kernel.peak_envelope_cuda(
                    x, *gains, e0, chunk=chunk))
                print(f"envelope kernel, {what}, B={b} x {t}: {ms:.3f} ms "
                      f"{tag}")
            for b, per_sample, reverse, what in (
                    (1, False, False, "scalar forward"),
                    (128, False, False, "scalar forward"),
                    (128, True, True, "per-sample reverse")):
                a, y, y0 = cs.fo_inputs(0.6, b, T, 7, dev, per_sample)
                def solve():
                    return first_order_kernel.first_order_cuda(a, y, y0,
                                                               reverse)
                ms = back_to_back_ms(solve)
                dev_ms = profiled_ms(solve)
                print(f"first-order kernel, {what}, R={b} x {T}: {ms:.3f} ms; "
                      f"device {dev_ms:.4f} ms a solve {tag}")
                del a, y, y0
        for name, graph, b in (("bench chain", cs.bench_graph(), 512),
                               ("config5", g5, 128), ("config5", g5, 512)):
            cg = dst.compile_graph(graph, device="cuda")
            xr = x_all[:b].reshape(b, 1, T)
            ms = cs.cuda_ms(lambda: cg.render(xr, batch_shape=(b,)))
            print(f"{name} render, B={b}: {ms:.3f} ms {tag}")
        for name, b in (("config3", 512), ("config4", 256)):
            try:
                cg = dst.compile_graph(presets.PRESETS[name]()[0],
                                       device="cuda")
                xr = x_all[:b].reshape(b, 1, T)
                ms = cs.cuda_ms(lambda: cg.render(xr, batch_shape=(b,)))
            except (KeyError, NotImplementedError) as e:
                # an older root that has not ported the preset's nodes
                print(f"{name} render, B={b}: not rendered ({e}) {tag}")
                continue
            print(f"{name} render, B={b}: {ms:.3f} ms {tag}")
            del cg
            torch.cuda.empty_cache()
        del x_all
        torch.cuda.empty_cache()
        if not renders_only:
            cg = dst.compile_graph(cs.bench_graph(), device="cuda")
            inp = str(cg.input_ids[0])
            gen = torch.Generator(device=dev).manual_seed(13)
            ext = {inp: torch.randn((128, T), generator=gen, device=dev)
                   * 0.25}
            target = cs.render_target(cg, ext, cs.hidden_params(
                cg, gain=("level", 2.0), low_pass=("ratio", 0.7)))
            params = cg.init_params(requires_grad=True)
            step, init_opt = fit.make_train_step(cg, fit.adam(0.03))
            opt = init_opt(params)
            state = cg.init_state()
            secs = []
            for _ in range(6):
                t0 = time.time()
                step(params, opt, state, ext, target)
                torch.cuda.synchronize()
                secs.append(time.time() - t0)
            print(f"training step (bench chain, 16 sliders), B=128: "
                  f"{np.median(secs[1:]) * 1e3:.3f} ms {tag}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
