#!/usr/bin/env python3
"""Smoke run of the PyTorch port (dsp_stuff_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernel from csrc/ with nvcc, holds it against its
plain PyTorch version on the card, drives the port's main path (the
10-node bench chain over 512 streams x 10 s at 48 kHz through
``compile_graph(..., device="cuda")`` and ``render``), checks the output
against the repo's NumPy oracle, checks the state handoff and the parity
policy, and times the kernel against the plain version.  Every phase
raises on failure.  Needs a CUDA device; imports nothing of JAX.

Output: progress lines, then one JSON line with the per-kernel record,
then the card's identity as the last line.  Error figures are in dBFS:
20 log10(max |got - want| / max |want|).
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SR = 48_000
B_MAIN = 512
T_MAIN = 10 * SR
B_CHECK, T_CHECK = 64, 4096
Y_BOUND_DB = -100.0       # kernel vs plain, y and taps
STATE_ATOL = 1e-4         # kernel vs plain, rebuilt states
ORACLE_FAST_DB = -80.0    # main path (fast) vs the oracle
HANDOFF_DB = -100.0       # two chained renders vs one
PARITY_DB = -90.0         # parity policy vs the oracle (README bound)
N_TIMED = 5


def dbfs(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    return 20.0 * np.log10(max(err, 1e-30) / max(np.abs(want).max(), 1e-30))


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def host(t):
    return t.detach().float().cpu().numpy()


def bench_stages():
    """The stage list the planner builds for bench.py's chain."""
    h = float(np.float32(np.float32(1.0) / np.float32(1.0001)))
    return (
        ("cascade", (("gain", h), ("gain", 1.2), ("gain", h),
                     ("bq", (-0.24, 0.0, 0.758, 0.0, 0.0)))),
        ("scale", h), ("ew", "overdrive", (4.0, 0.6, 0.9)),
        ("cascade", (("gain", h), ("lp", 0.6), ("gain", h), ("hp", 0.2))),
        ("scale", h), ("ew", "distort:Tanh", (3.0,)),
        ("scale", h), ("ew", "chebyshev", (2.0, 4.0)),
        ("scale", h), ("comb", 0.4, 2400), ("scale", h))


def check_lists():
    from dsp_stuff_tpu_torch.ops import shaping
    lists = {"bench": bench_stages()}
    for mode in shaping.DISTORT_MODES:
        lists[f"distort:{mode}"] = (
            ("cascade", (("gain", 0.9), ("lp", 0.5))),
            ("ew", f"distort:{mode}", (2.5,)),
            ("cascade", (("hp", 0.2),)), ("comb", 0.4, 300))
    lists["comb D=100"] = (
        ("cascade", (("bq", (-0.3, 0.05, 0.8, 0.1, 0.0)),)),
        ("comb", 0.5, 100))
    lists["mid-chain tap"] = (
        ("cascade", (("lp", 0.3),)), ("tap", 0),
        ("ew", "overdrive", (2.0, 0.5, 0.8)), ("tap", 1),
        ("comb", 0.3, 200))
    return lists


def seeded_states(stages, B, rng, device):
    import torch
    from dsp_stuff_tpu_torch.ops.cascade import _embed_dim, composite_dim
    out = []
    for st in stages:
        if st[0] == "cascade":
            n = _embed_dim(composite_dim(st[1]))
        elif st[0] == "comb":
            n = st[2]
        else:
            continue
        out.append(torch.as_tensor(
            (rng.standard_normal((B, n)) * 0.1).astype(np.float32),
            device=device))
    return tuple(out)


def kernel_segment(x, stages, state_in):
    from dsp_stuff_tpu_torch.ops import chain_kernel, chain_segment
    y, casc_raw, ring_raw, taps = chain_kernel.chain_kernel_call(
        x, stages, state_in)
    cinfos, hists = chain_segment.rebuild_states(stages, x.shape[-1],
                                                 casc_raw, ring_raw)
    return y, cinfos, hists, taps


def compare(name, k, p):
    """Kernel outputs ``k`` against the plain version's ``p``; returns the
    y error in dBFS and the largest absolute y error."""
    y_db = dbfs(host(k[0]), host(p[0]))
    tap_db = max([dbfs(host(a), host(b)) for a, b in zip(k[3], p[3])],
                 default=float("-inf"))
    st_err = 0.0
    for ik, ip in zip(k[1], p[1]):
        for a, b in zip(ik, ip):
            st_err = max(st_err, float(np.abs(host(a) - host(b)).max()))
    for a, b in zip(k[2], p[2]):
        st_err = max(st_err, float(np.abs(host(a) - host(b)).max()))
    abs_err = float(np.abs(host(k[0]) - host(p[0])).max())
    print(f"  {name:22s} y {y_db:8.1f} dBFS  taps {tap_db:8.1f} dBFS  "
          f"states max abs {st_err:.2e}")
    check(len(k[1]) == len(p[1]) and len(k[2]) == len(p[2])
          and len(k[3]) == len(p[3]), f"{name}: output structure differs")
    check(y_db <= Y_BOUND_DB, f"{name}: y {y_db:.1f} dBFS > {Y_BOUND_DB}")
    check(tap_db <= Y_BOUND_DB, f"{name}: taps {tap_db:.1f} dBFS")
    check(st_err <= STATE_ATOL, f"{name}: states {st_err:.2e} > {STATE_ATOL}")
    return y_db, abs_err


def bench_graph():
    import dsp_stuff_tpu_torch as dst
    from dsp_stuff_tpu_torch.ids import IdSpace
    g = dst.Graph(IdSpace())
    inp = g.add("input")
    gn = g.add("gain", level=1.2)
    bq = g.add("biquad", a0=1.0, a1=-0.24, a2=0.0, b0=0.758, b1=0.0, b2=0.0)
    od = g.add("overdrive", boost=4.0, drive=0.6, level=0.9)
    lp = g.add("low_pass", ratio=0.6)
    hp = g.add("high_pass", ratio=0.2)
    dt = g.add("distort", mode="Tanh", level=3.0)
    ch = g.add("chebyshev", level_pos=2.0, level_neg=4.0)
    rv = g.add("reverb", seconds=0.05, decay=0.4)
    out = g.add("output")
    g.chain(inp, gn, bq, od, lp, hp, dt, ch, rv, out)
    return dst.loads_graph(dst.dumps_graph(g), ids=IdSpace())


def cuda_ms(fn, n=N_TIMED):
    """Median of n CUDA-event timings of fn(), after one warm-up call."""
    import torch
    fn()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import dsp_stuff_tpu_torch as dst
    from dsp_stuff_tpu_torch.ops import chain_kernel, chain_segment
    from bench import oracle_chain

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    card = f"{smi}"
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")

    # -- 2. build --------------------------------------------------------
    t0 = time.time()
    lib, log = chain_kernel.build()
    print(f"nvcc build: {time.time() - t0:.1f} s -> {os.path.relpath(lib, ROOT)}")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    rng = np.random.default_rng(0)
    with dst.policy("fast"):
        # -- 3. kernel against plain on the card -------------------------
        print(f"kernel vs segment_fallback, B={B_CHECK}, T={T_CHECK}:")
        for name, stages in check_lists().items():
            x = torch.as_tensor((rng.standard_normal((B_CHECK, T_CHECK))
                                 * 0.3).astype(np.float32), device=dev)
            st = seeded_states(stages, B_CHECK, rng, dev)
            k = kernel_segment(x, stages, st)
            p = chain_segment.segment_fallback(x, stages, st)
            torch.cuda.synchronize()
            compare(name, k, p)

        # -- 4. the main path --------------------------------------------
        g = bench_graph()
        cg = dst.compile_graph(g, device="cuda")
        x_np = (rng.standard_normal((B_MAIN, 1, T_MAIN), dtype=np.float32)
                * np.float32(0.25))
        x = torch.as_tensor(x_np, device=dev)
        torch.cuda.synchronize()
        chain_kernel.LAUNCHES = 0
        t0 = time.time()
        outs, _aux, _state = cg.render(x, batch_shape=(B_MAIN,))
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = chain_kernel.LAUNCHES
        print(f"main path: render [{B_MAIN}, 1, {T_MAIN}] in {wall:.3f} s "
              f"(first call), chain kernel launches {launches}")
        check(launches == 1, f"main path launched the kernel {launches} "
                             f"times, expected 1")
        check(tuple(outs.shape) == (B_MAIN, 1, T_MAIN),
              f"output shape {tuple(outs.shape)}")
        check(bool(torch.isfinite(outs).all()), "main path output not finite")
        ref = oracle_chain(x_np[0, 0, :SR])
        d = dbfs(host(outs[0, 0, :SR]), ref)
        print(f"  stream 0, first second vs bench.oracle_chain: {d:.1f} dBFS")
        check(d <= ORACLE_FAST_DB, f"main path vs oracle {d:.1f} dBFS")
        del outs, _state

        # -- 5. state handoff ---------------------------------------------
        xh = x[:B_CHECK]
        full, _, _ = cg.render(xh, batch_shape=(B_CHECK,))
        half = T_MAIN // 2
        a, _, st = cg.render(xh[..., :half].contiguous(),
                             batch_shape=(B_CHECK,))
        b, _, _ = cg.render(xh[..., half:].contiguous(), state=st,
                            batch_shape=(B_CHECK,))
        d = dbfs(host(torch.cat([a, b], dim=-1)), host(full))
        print(f"state handoff, B={B_CHECK}: 2 x 5 s vs 10 s: {d:.1f} dBFS")
        check(d <= HANDOFF_DB, f"state handoff {d:.1f} dBFS")
        del full, a, b, st

    # -- 6. parity on the card ----------------------------------------------
    with dst.policy("parity"):
        cgp = dst.compile_graph(g, device="cuda")
        xp = x_np[:4, :, :SR]
        yp, _, _ = cgp.render(xp, batch_shape=(4,))
        worst = max(dbfs(host(yp[i, 0]), oracle_chain(xp[i, 0]))
                    for i in range(4))
        print(f"parity, B=4 x 1 s vs bench.oracle_chain: {worst:.1f} dBFS")
        check(worst <= PARITY_DB, f"parity {worst:.1f} dBFS > {PARITY_DB}")

    # -- 7. times -------------------------------------------------------------
    with dst.policy("fast"):
        stages = bench_stages()
        xs = x.reshape(B_MAIN, T_MAIN)
        st = seeded_states(stages, B_MAIN, rng, dev)
        k = kernel_segment(xs, stages, st)
        p = chain_segment.segment_fallback(xs, stages, st)
        torch.cuda.synchronize()
        print(f"kernel vs segment_fallback, B={B_MAIN}, T={T_MAIN}:")
        _, abs_err = compare("bench (main-path shape)", k, p)
        del k, p
        ms = cuda_ms(lambda: kernel_segment(xs, stages, st))
        plain_ms = cuda_ms(lambda: chain_segment.segment_fallback(
            xs, stages, st))
        render_ms = cuda_ms(lambda: cg.render(x, batch_shape=(B_MAIN,)))
    audio_s = B_MAIN * T_MAIN / SR
    for what, t in (("chain segment, kernel", ms),
                    ("chain segment, segment_fallback", plain_ms),
                    ("whole render (kernel path)", render_ms)):
        print(f"{what}: {t:.3f} ms median of {N_TIMED} = "
              f"{audio_s / (t / 1e3):,.0f} audio-s/s at B={B_MAIN} x 10 s "
              f"[{card}]")

    print(json.dumps({"kernels": [{
        "name": "chain_kernel", "route": "cuda",
        "source": "dsp_stuff_tpu_torch/csrc/chain_kernel.cu",
        "replaces": "dsp_stuff_tpu/ops/pallas_chain.py:459",
        "launches": launches, "max_abs_err": abs_err,
        "ms": ms, "plain_ms": plain_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
