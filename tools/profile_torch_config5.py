#!/usr/bin/env python3
"""Where the render time goes in dsp_stuff_tpu_torch, on one NVIDIA GPU.

    python3 tools/profile_torch_config5.py [--root DIR] [--renders]

Imports dsp_stuff_tpu_torch and chip_smoke from DIR (default: this
checkout), so that two commits can be compared in one call on one card:
unpack the other commit into a git-ignored directory (git archive) and run
this script against each in turns (A, B, B, A).

Renders under the fast policy through ``compile_graph(...,
device="cuda")`` and ``render`` at 10 s of 48 kHz audio per stream, inputs
from fixed seeds: config5 (the 16-node feedback graph of models/presets.py)
at B = 128 and 512, the bench chain (bench.py's 10-node chain) at B = 512
and config3 (4x-oversampled overdrive and distortion) at B = 512.  For each:

* the wall time of one render (CUDA events, median of 5 after a warm-up);
* from ``torch.profiler`` over one more render: the device time of all
  work, of the port's kernels (each by name) and of everything else (the
  plain PyTorch ops, copies and fills), and the idle share, 1 - device
  time / wall time;
* the device time attributed to what the evaluator ran, each scope a
  ``torch.profiler.record_function`` range this script opens around the
  compiler's own functions: each node's evaluation (``_call``, by node
  type), each pointwise group (``_group_eval``, by its members' types,
  where the checkout has groups, then "avg" or "mod" for each fan-in it
  writes for a reader outside it: "group mix+avg"; a one-form group is
  "group avg" or "group mod"), each chain segment, linear run and
  feedback cycle, each fan-in average and modulation map that stays
  eager (``_avg``, ``_map_mod``: a run head's, a node's, an analysis
  sink's, the knob writeback's one sample); what runs outside every
  scope (Outputs, analysis sinks, knobs) is "outside the scopes"; and
  the largest plain ops by device time.

Without ``--renders`` it also times the chain kernel on config5's planned
stage list ([high_pass cascade, scale, mtap]) at B = 128: the whole list,
each stage alone, and segment_fallback (the plain version) of each, and
the whole list at B = 512.

Prints one line per figure with the root and the card's name and power
limit.  Needs a CUDA device; imports nothing of JAX.
"""

import contextlib
import functools
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 48_000
T = 10 * SR
#: the port's kernels, by the name their launches carry
KERNELS = ("chain_kernel", "cycle_kernel", "envelope_kernel",
           "first_order_kernel", "fo_chained", "oscillator_clock_kernel",
           "oscillator_wave_kernel", "pointwise_kernel", "sequential_kernel")
#: the kernels launched through ctypes (no host op carries their device
#: time), each to the scope open at its launch, by the name they carry
CTYPES_KERNELS = ("pointwise_kernel", "oscillator_")


@contextlib.contextmanager
def scopes():
    """Each evaluator function of the compiler wrapped in a
    record_function range named for what it evaluates.  Yields {kernel
    name: list} whose list gets, at each launch of that kernel through
    ctypes (CTYPES_KERNELS: the pointwise kernel, the oscillator kernel's
    passes; no host op carries their device time), the innermost scope
    open then."""
    import torch
    from dsp_stuff_tpu_torch.compiler import compile as comp
    from dsp_stuff_tpu_torch.ops import pointwise_kernel as pk
    try:
        from dsp_stuff_tpu_torch.ops import oscillator_kernel as ok
    except ImportError:                     # a root before the kernel
        ok = None
    open_scopes: list = []
    launched: dict = {k: [] for k in CTYPES_KERNELS}

    def wrap(fn, label):
        @functools.wraps(fn)
        def run(*a, **k):
            name = label(*a, **k)
            open_scopes.append(name)
            try:
                with torch.profiler.record_function(name):
                    return fn(*a, **k)
            finally:
                open_scopes.pop()
        return run

    def here():
        return open_scopes[-1] if open_scopes else "outside the scopes"

    def launch(*a, **k):
        launched["pointwise_kernel"].append(here())
        return kernel_group(*a, **k)

    def osc_launch(ln, passes, *a, **k):
        launched["oscillator_"].extend([here()] * len(passes))
        return osc_inner(ln, passes, *a, **k)

    def members(self, ms, values=None, outs=None, pdict=None, T=None,
                fanins=(), *a, **k):
        kinds = [self._nodes[n].cfg_name for n in ms]
        kinds += [key[0] for key, _ in fanins or ()]
        return f"group {'+'.join(kinds)}"

    cg = comp.CompiledGraph
    saved = [(comp, "_call", lambda impl, *a, **k:
              f"node {impl.__name__}"),
             (comp, "_avg", lambda *a, **k: "fan-in average"),
             (comp, "_map_mod", lambda *a, **k: "modulation map"),
             (cg, "_group_eval", members),
             (cg, "_mega_run_eval", lambda *a, **k: "chain segment"),
             (cg, "_fused_run_eval", lambda *a, **k: "linear run"),
             (cg, "_eval_cycle", lambda *a, **k: "feedback cycle")]
    saved = [(m, n, getattr(m, n), lab) for m, n, lab in saved
             if hasattr(m, n)]
    for m, n, fn, lab in saved:
        setattr(m, n, wrap(fn, lab))
    kernel_group = getattr(pk, "_kernel_group", None)
    if kernel_group is not None:
        pk._kernel_group = launch
    osc_inner = getattr(ok, "_launch", None)
    if osc_inner is not None:
        ok._launch = osc_launch
    try:
        yield launched
    finally:
        for m, n, fn, _ in saved:
            setattr(m, n, fn)
        if kernel_group is not None:
            pk._kernel_group = kernel_group
        if osc_inner is not None:
            ok._launch = osc_inner


LABELS = ("node ", "group ", "fan-in average", "modulation map",
          "chain segment", "linear run", "feedback cycle")


def profile_render(name, cg, x, B, tag):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from chip_smoke import cuda_ms
    wall = cuda_ms(lambda: cg.render(x, batch_shape=(B,)))
    with scopes() as launched:
        cg.render(x, batch_shape=(B,))          # the scopes' first call
        torch.cuda.synchronize()
        for v in launched.values():
            v.clear()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(64):                 # the trace's lead-in
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            with torch.profiler.record_function("render"):
                cg.render(x, batch_shape=(B,))
            torch.cuda.synchronize()
    evs = [e for e in prof.events() if e.name != "render"
           and not e.name.startswith(LABELS)]
    # device-side events (kernels, copies, fills) each hold their own time;
    # the record_function ranges' device-side spans are left out
    dev = [e for e in evs if e.device_type == DeviceType.CUDA
           and "spin" not in e.name.lower()
           and "sleep" not in e.name.lower()]
    total = sum(e.self_device_time_total for e in dev) / 1e3
    ours = {k: sum(e.self_device_time_total for e in dev if k in e.name)
            / 1e3 for k in KERNELS}
    ours = {k: v for k, v in ours.items() if v}
    print(f"{name}, B={B} x 10 s, fast policy {tag}")
    print(f"  wall time of the render   {wall:9.3f} ms (median of 5)")
    print(f"  device time, all work     {total:9.3f} ms")
    for k, v in ours.items():
        print(f"  {k:25s} {v:9.3f} ms  {v / total:6.1%} of device time")
    rest = total - sum(ours.values())
    print(f"  {'plain ops, copies, fills':25s} {rest:9.3f} ms  "
          f"{rest / total:6.1%} of device time")
    print(f"  device idle share         {1 - total / wall:9.1%}")
    # each host-side event's own device time (an op's kernels, a runtime
    # call's launch) to the innermost scope whose host span holds its start
    spans = sorted(((e.time_range.start, e.time_range.end, e.name)
                    for e in prof.events() if e.device_type == DeviceType.CPU
                    and e.name.startswith(LABELS)),
                   key=lambda t: t[1] - t[0])
    by_scope: dict = {}
    for e in evs:
        ms = e.self_device_time_total / 1e3
        if e.device_type != DeviceType.CPU or ms <= 0:
            continue
        at = e.time_range.start
        scope = next((n for a, b, n in spans if a <= at < b),
                     "outside the scopes")
        by_scope[scope] = by_scope.get(scope, 0.0) + ms
    # each pointwise kernel and oscillator pass (in stream order, the
    # launch order) to the scope that launched it: a group's fan-in
    # outputs are its own
    for kname, scopes_at in launched.items():
        runs = sorted((e for e in dev if kname in e.name),
                      key=lambda e: e.time_range.start)
        if len(runs) == len(scopes_at):
            for scope, e in zip(scopes_at, runs):
                by_scope[scope] = (by_scope.get(scope, 0.0)
                                   + e.self_device_time_total / 1e3)
        else:
            print(f"  (the {len(runs)} {kname} kernels in the trace are "
                  f"not the {len(scopes_at)} launched: left out of the "
                  f"scopes)")
    print(f"  by scope (their sum {sum(by_scope.values()):.3f} ms of the "
          f"{total:.3f}):")
    for scope, ms in sorted(by_scope.items(), key=lambda t: -t[1]):
        n = sum(1 for *_, nm in spans if nm == scope)
        print(f"    {scope:38s} {ms:9.3f} ms" + (f" in {n} call(s)" if n
                                                  else ""))
    ops: dict = {}
    for e in evs:
        if e.device_type == DeviceType.CPU and e.name.startswith("aten::"):
            ops[e.name] = ops.get(e.name, 0.0) + e.self_device_time_total
    for k, v in sorted(ops.items(), key=lambda t: -t[1])[:6]:
        if v > 0:
            print(f"    {k:38s} {v / 1e3:9.3f} ms")


def chain_attribution(x_all, tag):
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
          f"10 s {tag}")
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
    root = os.path.abspath(sys.argv[sys.argv.index("--root") + 1]
                           if "--root" in sys.argv else HERE)
    sys.path[:0] = [root, os.path.join(root, "tests")]
    import dsp_stuff_tpu_torch as dst
    from chip_smoke import bench_graph
    from dsp_stuff_tpu_torch.models import presets
    from dsp_stuff_tpu_torch.ops import cuda_build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    tag = f"[{os.path.relpath(root, HERE)}] [{card}]"
    cuda_build.build()
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    x_all = torch.as_tensor(
        rng.standard_normal((512, 1, T), dtype=np.float32) * np.float32(0.3),
        device=dev)
    with dst.policy("fast"):
        for name, g, widths in (
                ("config5", presets.config5_feedback_16node()[0], (128, 512)),
                ("bench chain", bench_graph(), (512,)),
                ("config3", presets.config3_oversampled_distortion()[0],
                 (512,))):
            cg = dst.compile_graph(g, device="cuda")
            for B in widths:
                profile_render(name, cg, x_all[:B], B, tag)
            del cg
            torch.cuda.empty_cache()
    if "--renders" not in sys.argv:
        chain_attribution(x_all.reshape(512, T), tag)
    return 0


if __name__ == "__main__":
    sys.exit(main())
