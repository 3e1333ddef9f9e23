#!/usr/bin/env python3
"""Check and time the sequential recurrence kernel on one NVIDIA GPU.

    python3 tools/measure_torch_sequential.py [--check] [--root DIR]
                                             [--probes] [--quick]
                                             [--variants DEFS ...]
                                             [--phases]

Builds dsp_stuff_tpu_torch's csrc/sequential_kernel.cu (the exact policy's
per-sample first order and biquad, forward and reverse mode), printing
what ptxas reports for every instance (registers, spills), also as the
measuring builds (``--probes``):

* ``SQ_CHAIN_ONLY``: the chain alone (y, lam or g) on values made in
  registers: no copies, no stores, none of the chain's consumers;
* ``SQ_NO_F64``: the reverse mode without its float64 row sums;
* ``SQ_NO_LOADS``, ``SQ_NO_STORES``: no copies into shared memory, no
  stores of the results (the two together: "no copies");

then, all launched through the C entry points of each build:

* ``--check``: every build that computes (this checkout's, and DIR's)
  bitwise against the plain versions (ops/scan._first_order_sequential,
  _biquad_sequential, _first_order_adjoint_sequential,
  _biquad_adjoint_sequential) in all six modes at [512, 4096], T = 1 (2
  for the biquad), a tile and one sample either side, 2 tiles + 1,
  R = 33, rows not 16-byte aligned;
* always: the six modes timed (CUDA events, median of 5 after a
  warm-up; in turns, the better of each build's two medians) at R = 1,
  4, 128 and 512 x 480,000 and at [4, 48,000], each beside the chain
  floor (4 cycles a dependent operation at 1.98 GHz), in cycles a
  sample; and at [1, 128] and [4, 128] as 20 launches captured in one
  CUDA graph, a launch's share of a replay (the stream's shapes: a
  replayed exact block, config5's per-node block scan); ``--probes``
  adds the measuring builds at [512, 480,000];
* ``--root DIR``: DIR's csrc/sequential_kernel.cu (unpack the parent
  commit there with ``git archive``) built with this checkout's flags and
  timed in turns with this checkout's (parent, change, change, parent).

``--variants SQ_NST=4 SQ_RUN=32,SQ_NST=8`` builds the kernel with other
preprocessor definitions (comma-separated, one build each), checks them
with ``--check`` and times them beside the rest at [512, 480,000].
``--phases`` builds ``SQ_PHASES`` and prints, for each mode at [512,
480,000], each warp's clock cycles a tile by phase (waiting on a
barrier, its work, the memory warp's copies into the ring, the rest).
``--quick`` times [512, 480,000] and the small shapes only.  Prints one
line per measurement with the card's name and power limit.  Needs a
CUDA device; imports nothing of JAX.
"""

import argparse
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
T = 480_000
CLOCK_HZ = 1.98e9
FWD = ("first_order", "first_order:per-sample", "biquad")
REV = ("first_order_reverse", "first_order_reverse_per_sample",
       "biquad_reverse")
PROBES = {"chain only": ("SQ_CHAIN_ONLY",), "no f64": ("SQ_NO_F64",),
          "no loads": ("SQ_NO_LOADS",), "no stores": ("SQ_NO_STORES",),
          "no copies": ("SQ_NO_LOADS", "SQ_NO_STORES")}
GRAPH_LAUNCHES = 20
HANG_S = 30


def build_other(src: str):
    """(library, nvcc's output) of another checkout's sequential kernel
    source, built with this checkout's flags into build/torch_kernels/."""
    import hashlib
    from dsp_stuff_tpu_torch.ops import cuda_build
    text = open(src, "rb").read()
    lib = (cuda_build.BUILD_DIR
           / f"sequential_kernel_other_{hashlib.sha256(text).hexdigest()[:16]}"
             f".so")
    log = ""
    if not lib.exists():
        cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        proc = subprocess.run(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-I",
             os.path.dirname(src), "-o", str(lib), src],
            capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {src}:\n{log}")
    import ctypes
    from dsp_stuff_tpu_torch.ops import sequential_kernel as sk
    return sk.bind(ctypes.CDLL(str(lib))), log


def launch(lib, mode, ins, y=None, ybar=None):
    """One solve of ``mode`` on ``ins`` (chip_smoke.seq_inputs, or
    seq_rev_inputs' with y and ybar for a reverse mode) through ``lib``'s
    C entry point; returns the outputs as the wrappers do."""
    import torch
    from dsp_stuff_tpu_torch.ops import sequential_kernel as sk
    if mode in FWD:
        if mode == "biquad":
            x, coef, s_in = ins
            a, kind, s_shape = None, sk._BIQUAD, (x.shape[0], 4)
        else:
            a, x, s_in = ins
            coef, s_shape = None, (x.shape[0],)
            kind = sk._FIRST_ORDER_PS if a.dim() else sk._FIRST_ORDER
        out = torch.empty_like(x)
        s_out = torch.empty(s_shape, dtype=torch.float32, device=x.device)
        rc = lib.sequential_kernel_launch(
            kind, x.data_ptr(), sk._ptr(a), sk._ptr(coef), s_in.data_ptr(),
            out.data_ptr(), s_out.data_ptr(), x.shape[0], x.shape[1],
            x.device.index, torch.cuda.current_stream(x.device).cuda_stream)
        if rc:
            raise RuntimeError(f"sequential kernel {mode}: CUDA error {rc}")
        return out, s_out
    R, n = ybar.shape
    dev = ybar.device
    f32 = dict(dtype=torch.float32, device=dev)
    gx, ga, acc = torch.empty_like(ybar), None, None
    if mode == "biquad_reverse":
        x, coef, s_in = ins
        a, kind = None, sk._BIQUAD
        s_out = torch.empty((R, 4), **f32)
        acc = torch.empty((R, 5), dtype=torch.float64, device=dev)
    else:
        a, _, s_in = ins
        x = coef = None
        s_out = torch.empty((R,), **f32)
        if a.dim():
            kind, ga = sk._FIRST_ORDER_PS, torch.empty_like(ybar)
        else:
            kind = sk._FIRST_ORDER
            acc = torch.empty((R,), dtype=torch.float64, device=dev)
    rc = lib.sequential_reverse_launch(
        kind, ybar.data_ptr(), sk._ptr(a), y.data_ptr(), sk._ptr(x),
        sk._ptr(coef), s_in.data_ptr(), gx.data_ptr(), sk._ptr(ga),
        s_out.data_ptr(), sk._ptr(acc), R, n, dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc:
        raise RuntimeError(f"sequential kernel {mode}: CUDA error {rc}")
    if mode == "biquad_reverse":
        return gx, s_out, acc
    return gx, (ga if a.dim() else acc), s_out


def inputs(cs, mode, R, n, rng, dev, offset=0):
    """(ins, y, ybar) of ``mode`` at [R, n]; y and ybar None forward."""
    if mode in FWD:
        return cs.seq_inputs(mode, R, n, rng, dev, offset), None, None
    return cs.seq_rev_inputs(mode, R, n, rng, dev, offset)


def same(cs, mode, got, ins, y, ybar) -> bool:
    import torch
    if mode in FWD:
        want = cs.seq_plain(mode, ins)
        return all(torch.equal(a, b) for a, b in zip(got, want))
    want = cs.seq_rev_plain(mode, ins, y, ybar)
    return all(torch.equal(a, b) for a, b in zip(got, want))


def finish_or_exit(what: str) -> None:
    """Wait for the card's work so far, at most HANG_S seconds; a kernel
    that has not finished by then ends the process (exit 3), and with it
    its CUDA context."""
    import time
    import torch
    ev = torch.cuda.Event()
    ev.record()
    t0 = time.time()
    while not ev.query():
        if time.time() - t0 > HANG_S:
            print(f"{what}: not finished after {HANG_S} s", flush=True)
            os._exit(3)
        time.sleep(0.01)


def graph_ms(fn, n=5):
    """A launch's share (ms) of one replay of GRAPH_LAUNCHES calls of fn
    captured in a CUDA graph: median of n replays after a warm-up."""
    import numpy as np
    import torch
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        fn()
    torch.cuda.current_stream().wait_stream(s)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(GRAPH_LAUNCHES):
            fn()
    g.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / GRAPH_LAUNCHES)
    return float(np.median(times))


def main() -> int:
    import numpy as np
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--probes", action="store_true")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--root", default=None)
    ap.add_argument("--variants", nargs="*", default=[])
    ap.add_argument("--phases", action="store_true")
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
    builds = {"change": ()}
    if args.probes:
        builds.update(PROBES)
    variants = {v: tuple(v.split(",")) for v in args.variants}
    builds.update(variants)
    if args.phases:
        builds["phases"] = ("SQ_PHASES",)
    libs = {}
    for (name, d), (lib, log) in zip(builds.items(), cuda_build.build_jobs(
            [("sequential_kernel", d, "") for d in builds.values()])):
        libs[name] = sk.bind(cuda_build.load("sequential_kernel", d))
        print(f"  {name}: {os.path.relpath(lib, ROOT)}")
        for ln in log.splitlines():
            if "Compiling entry" in ln or "registers" in ln or "spill" in ln:
                print(f"    {ln.strip()}")
    if args.root:
        src = os.path.join(os.path.abspath(args.root), "dsp_stuff_tpu_torch",
                           "csrc", "sequential_kernel.cu")
        libs["parent"], log = build_other(src)
        print(f"  parent: {src}")
        for ln in log.splitlines():
            if "registers" in ln or "spill" in ln:
                print(f"    {ln.strip()}")

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(3)
    if args.check:
        # one launch a mode and build first, each given HANG_S to finish
        for name in libs:
            for mode in FWD + REV:
                ins, y, ybar = inputs(cs, mode, 33, 200, rng, dev)
                launch(libs[name], mode, ins, y, ybar)
                finish_or_exit(f"{name} {mode} [33, 200]")
        print("  every build and mode ran to its end")
        shapes = ((512, 4096, 0), (8, 1, 0), (8, 2, 0), (8, 63, 0),
                  (8, 64, 0), (8, 65, 0), (8, 129, 0), (33, 200, 0),
                  (37, 1001, 1), (1, 4097, 1), (33, 129, 1))
        for name in [n for n in ("change", "parent", *variants)
                     if n in libs]:
            for mode in FWD + REV:
                for r, t, off in shapes:
                    if mode.startswith("biquad") and t < 2:
                        continue
                    ins, y, ybar = inputs(cs, mode, r, t, rng, dev, off)
                    got = launch(libs[name], mode, ins, y, ybar)
                    torch.cuda.synchronize()
                    cs.check(same(cs, mode, got, ins, y, ybar),
                             f"{name} {mode} [{r}, {t}] offset {off}: not "
                             f"bitwise the plain version")
            print(f"  {name}: bitwise its plain versions in all six modes")

    if args.phases:
        import ctypes
        lib = libs["phases"]
        lib.sequential_phases.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.sequential_phases.restype = ctypes.c_int
        got = np.zeros((5, 4), np.uint64)
        for mode in FWD + REV:
            ins, y, ybar = inputs(cs, mode, 512, T, rng, dev)
            launch(lib, mode, ins, y, ybar)
            torch.cuda.synchronize()
            lib.sequential_phases(got.ctypes.data, 1)
            launch(lib, mode, ins, y, ybar)
            torch.cuda.synchronize()
            lib.sequential_phases(got.ctypes.data, 1)
            per = got.astype(np.float64) / (512 // 32 * -(-T // cs.SEQ_RUN))
            names = ["memory", "chain"] + (
                ["prep"] if mode == "biquad" else
                ["a1, a2 sums, xbar", "b0, b1 sums", "b2 sum"]
                if mode == "biquad_reverse" else [] if mode in FWD
                else ["epilogue"])
            print(f"{mode}, [512, {T}], cycles a tile (64 samples) by warp: "
                  + "; ".join(f"{w} wait {per[k, 0]:.0f}, work "
                              f"{per[k, 1]:.0f}, copies {per[k, 2]:.0f}, "
                              f"rest {per[k, 3]:.0f}"
                              for k, w in enumerate(names))
                  + f" [{card}]")
            del ins, y, ybar
        libs.pop("phases")

    order = (["parent", "change", "change", "parent"] if "parent" in libs
             else ["change"])
    big = ((512, T),) if args.quick else ((1, T), (4, T), (128, T), (512, T),
                                          (4, 48_000))
    for mode in FWD + REV:
        fwd = mode if mode in FWD else cs.SEQ_REV[mode]
        for r, n in big:
            ins, y, ybar = inputs(cs, mode, r, n, rng, dev)
            names = order + ((list(PROBES) if args.probes else [])
                             + list(variants) if r == 512 and n == T else [])
            got = {}
            for name in names:
                got.setdefault(name, []).append(cs.cuda_ms(
                    lambda: launch(libs[name], mode, ins, y, ybar)))
            floor = cs.seq_floor_ms(fwd, n)
            print(f"{mode}, [{r}, {n}]: " + ", ".join(
                f"{k} {min(v):.3f} ms ({min(v) * 1e-3 * CLOCK_HZ / n:.1f} "
                f"cycles a sample)" for k, v in got.items())
                + f"; chain floor {floor:.3f} ms [{card}]")
            del ins, y, ybar
            torch.cuda.empty_cache()
        for r, n in ((1, 128), (4, 128)):
            ins, y, ybar = inputs(cs, mode, r, n, rng, dev)
            got = {}
            for name in order:
                got.setdefault(name, []).append(graph_ms(
                    lambda: launch(libs[name], mode, ins, y, ybar)))
            print(f"{mode}, [{r}, {n}], a launch in a CUDA graph of "
                  f"{GRAPH_LAUNCHES}: " + ", ".join(
                      f"{k} {min(v) * 1e3:.2f} us" for k, v in got.items())
                  + f" [{card}]")
    x = torch.randn((512, T), device=dev)
    y = torch.empty_like(x)
    print(f"y.copy_(x) at [512, {T}]: "
          f"{cs.cuda_ms(lambda: y.copy_(x)):.3f} ms [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
