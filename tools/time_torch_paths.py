#!/usr/bin/env python3
"""Time the port's kernel entry points and main paths of one checkout.

    python3 tools/time_torch_paths.py [--root DIR] [--renders | --grads |
                                       --parity | --fit]
    python3 tools/time_torch_paths.py --sass FILE ...

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

``--renders`` times the renders alone.  ``--parity`` times, alone,
config5's render at B = 128 x 10 s under the parity policy (the host
clock around the render and a synchronize, median of 3 after a warm-up:
its per-node cycle loop and its host work, such as an eager oscillator's
scalar launches, in one figure).  ``--grads`` times, alone, the bench
chain's and config5's input gradients at B = 128 (the root's
chip_smoke.grad_split: the forward and the backward on the host's clock,
medians of 3 after a first call, and one forward + backward's device time
by torch.profiler, split by op group, with the port's kernels' device
times; the peak device memory of one forward + backward; and the device
time under each backward node, the largest eight, by this checkout's
``backward_by_node``), the reverse pointwise kernel on config5's groups
at B = 128 and config3's at B = 32 (its shapers' passes at R = 4; the
root's chip_smoke.groups_of_render, both of its
reverse_needs: CUDA events over 10 calls back to back, median of 5, and
each pass's device time by torch.profiler; for the first group the
registers of each pass and, of pass 1's float4 build, the SASS
instructions and MUFU instructions in its row loop a sample, from
``cuobjdump`` of the root's built library), and, where
the root's chain kernel has a record build, that build beside the plain
one on the bench list at B = 128 (CUDA events, in turns: plain, record,
record, plain), and the bench chain's training step (its reverse
pointwise kernel's device time a step beside it).  Prints one line per
measurement
with the root and the card's name and power limit.  ``--fit`` times,
alone, a make_train_step step of config5 through its feedback cycle with
every slider a leaf (the LFO's amplitude and frequency among them) at
B = 128 x 10 s under fast and under parity: CUDA events around the step
(loss, backward, Adam, clamp) and a synchronize, the median of 3 steps
after one that captures the per-node loop; the group programs and
adjoint programs the step builds are built first, one nvcc each, all
started together (the root's chip_smoke collects them on the CPU port).
Needs a CUDA device;
imports nothing of JAX.  ``--sass`` reads pass-1 SASS dumps that
``--grads`` wrote (build/sass/) and prints their
loop_stats, on any machine.
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


def sass_loop_stats(lib: str, dump: str = "") -> dict:
    """Of the reverse pointwise kernel's library ``lib``: each kernel's
    registers (``cuobjdump -res-usage``) and pass 1's loop_stats (its
    float4 build's SASS, written to ``dump`` where given).  Empty where
    cuobjdump is missing."""
    import re
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return {}
    res = subprocess.run([tool, "-res-usage", lib], capture_output=True,
                         text=True, timeout=120).stdout
    regs, fn = {}, None
    for line in res.splitlines():
        m = re.search(r"Function (\S+):", line)
        if m:
            fn = m.group(1)
        m = re.search(r"REG:(\d+)", line)
        if m and fn:
            regs[fn] = int(m.group(1))
    sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, timeout=120).stdout
    out = {"registers": regs}
    for block in sass.split("Function : ")[1:]:
        if "pointwise_reverse_kernelILb1E" not in block.split()[0]:
            continue
        if dump:
            os.makedirs(os.path.dirname(dump), exist_ok=True)
            with open(dump, "w") as f:
                f.write(block)
        out.update(loop_stats(block))
    return out


def loop_stats(sass: str) -> dict:
    """Of one kernel's SASS (``cuobjdump -sass``): its instructions and
    MUFU instructions in all, and in its row loop a sample: the loop is
    the longest span from a backward branch's target to the branch, less
    the spans of the loops inside it (a row's tail, where the build has
    one), over the 4 samples of a float4 unit; ``loop_*`` count all of
    it, ``hot_*`` what is off a divide's slow path (hot_path)."""
    import re
    ins = [(int(m.group(1), 16), m.group(2).strip()) for m in re.finditer(
        r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", sass)]
    loops = []
    for a, op in ins:
        m = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)", op)
        if m and int(m.group(1), 16) < a:
            loops.append((int(m.group(1), 16), a))
    out = {"sass_total": len(ins),
           "mufu_total": sum("MUFU" in op for _, op in ins)}
    if loops:
        lo, hi = max(loops, key=lambda s: s[1] - s[0])
        inner = [(b, e) for b, e in loops if lo < b and e < hi]
        body = {a for a, _ in ins if lo <= a <= hi
                and not any(b <= a <= e for b, e in inner)}
        out["loop_sass_a_sample"] = len(body) / 4
        out["loop_mufu_a_sample"] = sum("MUFU" in op for a, op in ins
                                        if a in body) / 4
        hot = hot_path(ins, body)
        out["hot_sass_a_sample"] = len(hot) / 4
        out["hot_mufu_a_sample"] = sum("MUFU" in op for op in hot) / 4
    return out


def hot_path(ins, body_at) -> list:
    """Of the loop body (``body_at``: the addresses), the instructions off
    a divide's slow path: a conditional forward branch over fewer than 64
    instructions holding a CALL (div.rn's slow-path call, or pw_div's
    fallback to __fdiv_rn) marks those as cold."""
    import re
    cold = set()
    for i, (a, op) in enumerate(ins):
        m = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)", op)
        if a not in body_at or not op.startswith("@") or not m:
            continue
        skipped = [(b, o) for b, o in ins[i + 1:]
                   if b < int(m.group(1), 16)]
        if len(skipped) < 64 and any("CALL" in o for _, o in skipped):
            cold.update(b for b, _ in skipped)
    return [op for a, op in ins if a in body_at and a not in cold]


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


def pointwise_reverse_times(cs, name, graph, B, dev, here, root,
                            tag) -> None:
    """The reverse pointwise kernel on a graph's groups at B x 10 s,
    through the root's chip_smoke and wrapper (see the module's doc; the
    SASS of config5's first group)."""
    import torch
    import dsp_stuff_tpu_torch as dst
    from dsp_stuff_tpu_torch.ops import pointwise_kernel as pk
    from dsp_stuff_tpu_torch.ops import pointwise_reverse_kernel as prk
    if not hasattr(cs, "reverse_needs"):
        return
    x = torch.as_tensor(np.random.default_rng(142).standard_normal(
        (B, 1, T), dtype=np.float32) * np.float32(0.3), device=dev)
    with dst.policy("fast"):
        cg = dst.compile_graph(graph, device="cuda")
        groups = cs.groups_of_render(cg, x, (B,))
    del x
    for gi, (prog, sigs, scals, Tn) in enumerate(groups):
        cts = cs.reverse_cotangents(prog, sigs, scals, Tn, dev, 3000 + gi)
        for need in cs.reverse_needs(prog):
            need = list(need)

            def fk():
                return prk.reverse_group(prog, sigs, scals, cts, need, Tn,
                                         dev)
            ms = cs.cuda_ms(fk, inner=10)
            prk.SUM_LAUNCHES = 0
            fk()
            passes = [cs.kernel_device_ms(fk, "pointwise_reverse_kernel<")[0]]
            if prk.SUM_LAUNCHES:
                passes.append(cs.kernel_device_ms(
                    fk, "pointwise_reverse_kernel_sums")[0])
            # the bytes bound: each operand read once, each gradient
            # written once (the same in every root's layout)
            pl = pk.plan_adjoint(prog, sigs, scals, cts, need, Tn)
            ln = prk.plan_reverse(pl, dev)
            bnd = 4.0 * (sum(t.numel() for t in ln.ins)
                         + sum(t.numel() for t in ln.outs)) / 3.35e9
            print(f"{name} group {gi} reverse, need {sum(need)}, [{B}, {T}]: "
                  f"{ms:.3f} ms, device by pass "
                  f"{[None if p is None else round(p, 4) for p in passes]}, "
                  f"bytes bound {bnd:.4f} ms, rch {ln.rch}, grid {ln.grid}, "
                  f"pass 2 {ln.pass2} {tag}")
            del ln
            if gi == 0 and name == "config5":
                lib = prk._lib(prk.reverse_source(pl.adj),
                               prk._counts(prk.worlds(pl.adj)))._name
                dump = os.path.join(here, "build", "sass",
                                    f"{os.path.basename(root)}_need"
                                    f"{sum(need)}.sass")
                print(f"config5 group 0 reverse, need {sum(need)}: "
                      f"{sass_loop_stats(lib, dump)} {tag}")
    torch.cuda.empty_cache()


def main() -> int:
    if "--sass" in sys.argv:
        for path in sys.argv[sys.argv.index("--sass") + 1:]:
            with open(path) as f:
                print(f"{path}: {loop_stats(f.read())}")
        return 0
    import torch
    if not torch.cuda.is_available():
        print("time_torch_paths: needs a CUDA device", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    root = os.path.abspath(sys.argv[sys.argv.index("--root") + 1]
                           if "--root" in sys.argv else here)
    renders_only = "--renders" in sys.argv
    grads_only = "--grads" in sys.argv
    parity_only = "--parity" in sys.argv
    fit_only = "--fit" in sys.argv
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
    if fit_only:
        del x_all
        fit_step_times(cs, g5, dev, tag)
        return 0
    if parity_only:
        cg = dst.compile_graph(g5, device="cuda")
        xr = x_all[:128].reshape(128, 1, T)
        walls = []
        with dst.policy("parity"):
            for _ in range(4):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                cg.render(xr, batch_shape=(128,))
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
        print(f"config5 render, B=128, parity: wall {np.median(walls[1:]):.3f}"
              f" ms (median of 3 after a warm-up; {[round(w, 3) for w in walls]}"
              f") {tag}")
        return 0
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
            for name, graph, b in (
                    ("config5", g5, 128),
                    ("config3", presets.config3_oversampled_distortion()[0],
                     32)):
                pointwise_reverse_times(cs, name, graph, b, dev, here, root,
                                        tag)
            train_step_times(cs, dev, tag)
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
            train_step_times(cs, dev, tag)
    return 0


def fit_step_times(cs, g5, dev, tag) -> None:
    """config5's make_train_step step, every slider a leaf, B = 128 x 10 s,
    fast and parity (``--fit``): its group and adjoint programs built
    first, all together, then one step (the loop's captures) and three
    timed, CUDA events around each and a synchronize."""
    import torch
    import dsp_stuff_tpu_torch as dst
    from dsp_stuff_tpu_torch.compiler import compile as comp
    from dsp_stuff_tpu_torch.ops import cuda_build
    from dsp_stuff_tpu_torch.ops import pointwise_kernel as pk
    from dsp_stuff_tpu_torch.train import fit

    def every(cg):
        return cg.init_params(requires_grad=True)
    progs, srcs = set(), set()
    real = pk.group_call

    def spy(prog, *args):
        progs.add(prog)
        return real(prog, *args)
    for pol in ("fast", "parity"):
        cpu = dst.compile_graph(g5, device="cpu")
        with dst.policy(pol), cs.swapped_attr(comp, "group_call", spy), \
                cs.swapped_attr(pk, "group_call", spy):
            cpu.render(torch.zeros(2, 1, 21 * 128), T=21 * 128,
                       batch_shape=(2,), params=every(cpu))
        for T_, route in ((256, "auto"), (21 * 128, "buffers")):
            srcs.update(cs.cpu_group_backwards(g5, pol, every, False, T=T_,
                                               route=route))
    jobs = [(n, (), "") for n in cuda_build.STATIC_KERNELS]
    jobs.append(("chain_kernel", ("CK_RECORD",), ""))
    jobs += [("pointwise_kernel", (), pk.source(p)) for p in progs]
    jobs += [("pointwise_reverse_kernel", (), h) for h in sorted(srcs)]
    t0 = time.time()
    cuda_build.build_jobs(jobs)
    print(f"  {len(jobs)} builds in {time.time() - t0:.1f} s {tag}")
    inp = str(min(cpu.input_ids))
    rg = np.random.default_rng(170)
    x = torch.as_tensor(rg.standard_normal((128, T), dtype=np.float32)
                        * np.float32(0.3), device=dev)
    tgt = torch.as_tensor(rg.standard_normal((128, 1, T), dtype=np.float32)
                          * np.float32(0.1), device=dev)
    for pol in ("fast", "parity"):
        with dst.policy(pol):
            cg = dst.compile_graph(g5, device="cuda")
            step, init = fit.make_train_step(cg, fit.adam(1e-2))
            params = every(cg)
            opt = init(params)
            ms = []
            for _ in range(4):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                _, opt, loss = step(params, opt, cg.init_state(), {inp: x},
                                    tgt)
                e1.record()
                torch.cuda.synchronize()
                ms.append(e0.elapsed_time(e1))
        print(f"config5 fit step, every slider a leaf, B=128 x 10 s, {pol}: "
              f"{np.median(ms[1:]):.1f} ms (median of 3 after a first "
              f"{ms[0]:.1f}; {[round(m, 1) for m in ms[1:]]}), loss "
              f"{float(loss):.6e} {tag}")
        del cg, step, params, opt
        torch.cuda.empty_cache()


def train_step_times(cs, dev, tag) -> None:
    """A training step of the bench chain's 16 sliders at B = 128: the
    host clock around the step and a synchronize (median of 5 after a
    warm-up), and the device time a step of the reverse pointwise
    kernel's launches (both passes, torch.profiler over 5 steps)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    import dsp_stuff_tpu_torch as dst
    from dsp_stuff_tpu_torch.train import fit
    with dst.policy("fast"):
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
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                step(params, opt, state, ext, target)
            torch.cuda.synchronize()
    evs = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA
           and "pointwise_reverse_kernel" in e.key]
    rev = sum(e.self_device_time_total for e in evs) / 5 / 1e3
    print(f"training step (bench chain, 16 sliders), B=128: "
          f"{np.median(secs[1:]) * 1e3:.3f} ms; reverse pointwise kernel "
          f"device {rev:.4f} ms a step in {sum(e.count for e in evs) / 5:g} "
          f"launches {tag}")


if __name__ == "__main__":
    sys.exit(main())
