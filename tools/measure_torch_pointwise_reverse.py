#!/usr/bin/env python3
"""Time the reverse pointwise kernel's launch layouts on one NVIDIA GPU.

    python3 tools/measure_torch_pointwise_reverse.py [--tail] [--hoist]
                                                      [--bounds] [--divide]

On config5's first group (pre -> overdrive -> distort) under fast, its
operands from a render at [128, 1, 480,000] (chip_smoke.groups_of_render;
cut to their first T samples for a shorter T) and
N(0, 1) cotangents, through ops/pointwise_reverse_kernel.reverse_group
with the layout's constants set for the run (no flag: every part):

* ``--tail``: every operand needing a gradient (its [T] LFO's gradient
  summed over the rows) at T = 480,000 down to 128, both layouts: every
  row in one chunk with the per-sample tail in pass 1 (TAIL_MIN_GX 0)
  against ROW_CHUNK rows a chunk with the tail in pass 2 (TAIL_MIN_GX
  beyond the grid): where the first starts to win, TAIL_MIN_GX's choice;
* ``--hoist``: the input's program at each [rows, T] of HOIST_SHAPES
  (its rows cut to the first ones too), each of HOIST_LIST rows a
  thread (HOIST_ROWS, HOIST_MIN_CTAS 0): the per-sample values computed
  once for that many rows against the grid's CTAs, HOIST_MIN_CTAS's
  choice;
* ``--bounds``: each of config5's three groups, both needs, at T =
  480,000, built with each of 4, 5, 6 and 7 CTAs an SM as pass 1's launch
  bound (min_ctas set for the run), ptxas' registers and spills of each
  build: the choice min_ctas makes by the accumulators' registers;
* ``--divide``: each of config5's three groups, the input's program, at
  T = 480,000, its generated text as built (a divide by a uniform value
  through ``pw_div``) against the same text with each ``pw_div`` an IEEE
  divide (``__fdiv_rn`` by ``pw_fresh`` of the divisor, as before the
  reciprocal), in turns (as built, IEEE, IEEE, as built).

Each: CUDA events over 10 calls back to back (median of 5 after a
warm-up), each pass's device time by torch.profiler (chip_smoke.
kernel_device_ms), pass 1's grid.  Prints ptxas' register and spill lines
of the builds, one line per measurement with the card's name and power
limit.  Needs a CUDA device; imports nothing of JAX.
"""

import os
import re
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 48_000
T_LIST = (480_000, 240_000, 144_000, 120_000, 96_000, 48_000, 12_000,
          4_096, 128)
HOIST_LIST = (1, 2, 4, 8, 16)
HOIST_SHAPES = ((128, 480_000), (128, 48_000), (32, 48_000), (8, 48_000),
                (128, 4_096), (8, 4_096), (128, 128))
BOUNDS = (4, 5, 6, 7)


def config5_groups(dev):
    """(program, signals, scalars, T) of each of config5's groups at [128,
    1, 480,000] under fast."""
    import torch
    import chip_smoke as cs
    import dsp_stuff_tpu_torch as dst
    from dsp_stuff_tpu_torch.models import presets
    x = torch.as_tensor(np.random.default_rng(142).standard_normal(
        (128, 1, T_LIST[0]), dtype=np.float32) * np.float32(0.3),
        device=dev)
    with dst.policy("fast"):
        cg = dst.compile_graph(presets.config5_feedback_16node()[0],
                               device="cuda")
        return cs.groups_of_render(cg, x, (128,))


def cut(group, T: int, rows: int = 0):
    """``group`` with its signals cut to their first T samples (and, given
    ``rows``, a batched one to its first rows)."""
    prog, sigs, scals, _ = group
    return prog, [(s[:rows] if rows and s.dim() > 1 and s.shape[0] > 1
                   else s)[..., :T].contiguous() for s in sigs], scals, T


def ieee_divides(src: str) -> str:
    """The generated text ``src`` with each divide through a reciprocal
    (pw_div(a, U.rN)) an IEEE divide by the divisor (__fdiv_rn(a,
    pw_fresh(U.vN))); f32 divides only (fast's programs)."""
    if "PwRecip64" in src:
        raise ValueError("a float64 divide through a reciprocal")
    return re.sub(r"pw_div\(([\w.]+), U\.r(\d+)\)",
                  r"__fdiv_rn(\1, pw_fresh(U.v\2))", src)


def timed(group, need, dev, card, what, **consts) -> None:
    """One layout of ``group``'s reverse call: ms, device by pass, grid."""
    import chip_smoke as cs
    from dsp_stuff_tpu_torch.ops import pointwise_kernel as pk
    from dsp_stuff_tpu_torch.ops import pointwise_reverse_kernel as prk
    prog, sigs, scals, T = group
    cts = cs.reverse_cotangents(prog, sigs, scals, T, dev, 3000)
    old = {k: getattr(prk, k) for k in consts}
    for k, v in consts.items():
        setattr(prk, k, v)
    try:
        def fk():
            return prk.reverse_group(prog, sigs, scals, cts, need, T, dev)
        ms = cs.cuda_ms(fk, inner=10)
        prk.SUM_LAUNCHES = 0
        fk()
        passes = [cs.kernel_device_ms(fk, "pointwise_reverse_kernel<")[0]]
        if prk.SUM_LAUNCHES:
            passes.append(cs.kernel_device_ms(
                fk, "pointwise_reverse_kernel_sums")[0])
        ln = prk.plan_reverse(pk.plan_adjoint(prog, sigs, scals, cts, need,
                                              T), dev)
    finally:
        for k, v in old.items():
            setattr(prk, k, v)
    dm = None if None in passes else sum(passes)
    print(f"{what}: {ms:.4f} ms, device {dm if dm is None else round(dm, 4)}"
          f" (by pass {[p if p is None else round(p, 4) for p in passes]}), "
          f"rch {ln.rch}, grid {ln.grid} [{card}]", flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("measure_torch_pointwise_reverse: needs a CUDA device",
              file=sys.stderr)
        return 1
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
    import chip_smoke as cs
    from dsp_stuff_tpu_torch.ops import cuda_build
    from dsp_stuff_tpu_torch.ops import pointwise_kernel as pk
    from dsp_stuff_tpu_torch.ops import pointwise_reverse_kernel as prk
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    every_part = ["--tail", "--hoist", "--bounds", "--divide"]
    parts = [a for a in every_part if a in sys.argv] or every_part
    groups = config5_groups(dev)
    g = groups[0]
    n = g[0].n_sig + g[0].n_scal
    needs = {"every": [True] * n, "input": [True] + [False] * (n - 1)}
    # build both programs first (one nvcc each, together)
    srcs = []
    for need in needs.values():
        cts = cs.reverse_cotangents(*g, dev, 0)
        pl = pk.plan_adjoint(g[0], g[1], g[2], cts, need, g[3])
        srcs.append(prk.reverse_source(pl.adj))
    for (lib, log), what in zip(cuda_build.build_jobs(
            [("pointwise_reverse_kernel", (), s) for s in srcs]), needs):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas ({what}'s program): {line.strip()}")
    if "--tail" in parts:
        for T in T_LIST:
            gt = cut(g, T)
            for name, gx in (("tail in pass 1 (gy = 1)", 0),
                             ("tail in pass 2 (chunked)", 2**40)):
                timed(gt, needs["every"], dev, card,
                      f"every gradient, [128, {T}], {name}", TAIL_MIN_GX=gx)
            del gt
            torch.cuda.empty_cache()
    if "--hoist" in parts:
        for rows, T in HOIST_SHAPES:
            gt = cut(g, T, rows)
            cts = cs.reverse_cotangents(*gt, dev, 0)
            adj = pk.plan_adjoint(gt[0], gt[1], gt[2], cts, needs["input"],
                                  T).adj
            vec = T % pk.V == 0
            chosen = prk.launch_shape(adj, rows, T, vec)[0]
            for r in HOIST_LIST:
                timed(gt, needs["input"], dev, card,
                      f"the input's program, [{rows}, {T}], {r} rows a "
                      f"thread (launch_shape: {chosen})", HOIST_ROWS=r,
                      HOIST_MIN_CTAS=0)
            del gt, cts
            torch.cuda.empty_cache()
    if "--bounds" in parts:
        launch_bounds(groups, dev, card)
    if "--divide" in parts:
        ieee_against_pw_div(groups, dev, card)
    return 0


def ieee_against_pw_div(groups, dev, card) -> None:
    """--divide: each group's input program as built against its text
    with IEEE divides, in turns (both built first, together)."""
    import chip_smoke as cs
    from dsp_stuff_tpu_torch.ops import cuda_build
    from dsp_stuff_tpu_torch.ops import pointwise_kernel as pk
    from dsp_stuff_tpu_torch.ops import pointwise_reverse_kernel as prk
    real = prk.reverse_source

    def ieee(adj):
        return ieee_divides(real(adj))
    cases = []
    for gi, group in enumerate(groups):
        prog, sigs, scals, T = group
        need = list(cs.reverse_needs(prog)[-1])
        cts = cs.reverse_cotangents(prog, sigs, scals, T, dev, 3000 + gi)
        adj = pk.plan_adjoint(prog, sigs, scals, cts, need, T).adj
        n_div = real(adj).count("pw_div(")
        cases.append((gi, group, need, n_div))
        cuda_build.build_jobs([("pointwise_reverse_kernel", (), real(adj)),
                               ("pointwise_reverse_kernel", (), ieee(adj))])
    for gi, group, need, n_div in cases:
        for name, fn in (("pw_div", real), ("IEEE", ieee), ("IEEE", ieee),
                         ("pw_div", real)):
            timed(group, need, dev, card,
                  f"group {gi}, need {sum(need)}, its {n_div} divides by a "
                  f"uniform value {name}", reverse_source=fn)


def launch_bounds(groups, dev, card) -> None:
    """--bounds: each group and need under each of BOUNDS as pass 1's
    launch bound (all built first, one nvcc each, together)."""
    import chip_smoke as cs
    from dsp_stuff_tpu_torch.ops import cuda_build
    from dsp_stuff_tpu_torch.ops import pointwise_kernel as pk
    from dsp_stuff_tpu_torch.ops import pointwise_reverse_kernel as prk
    cases = []
    for gi, (prog, sigs, scals, T) in enumerate(groups):
        cts = cs.reverse_cotangents(prog, sigs, scals, T, dev, 3000 + gi)
        for need in cs.reverse_needs(prog):
            adj = pk.plan_adjoint(prog, sigs, scals, cts, list(need), T).adj
            cases.append((gi, list(need), adj, (prog, sigs, scals, T)))
    real = prk.min_ctas
    try:
        for n in BOUNDS:
            prk.min_ctas = lambda w, n=n: n
            prk.reverse_source.cache_clear()
            srcs = [prk.reverse_source(adj) for _, _, adj, _ in cases]
            for (gi, need, _, _), (_, log) in zip(cases, cuda_build.build_jobs(
                    [("pointwise_reverse_kernel", (), t) for t in srcs])):
                regs = [ln.split(":")[-1].strip() for ln in log.splitlines()
                        if "registers" in ln or ("spill" in ln and
                                                  " 0 bytes spill" not in ln)]
                print(f"group {gi}, need {sum(need)}, {n} CTAs an SM: "
                      f"ptxas {regs}")
            prk._lib.cache_clear()
            for gi, need, adj, group in cases:
                chosen = real(prk.worlds(adj))
                timed(group, need, dev, card,
                      f"group {gi}, need {sum(need)}, {n} CTAs an SM "
                      f"(min_ctas: {chosen})")
    finally:
        prk.min_ctas = real
        prk.reverse_source.cache_clear()
        prk._lib.cache_clear()


if __name__ == "__main__":
    sys.exit(main())
