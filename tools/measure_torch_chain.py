#!/usr/bin/env python3
"""Check, time and profile the chain kernel and its reverse on one NVIDIA
GPU.

    python3 tools/measure_torch_chain.py [--check | --phases]
    python3 tools/measure_torch_chain.py --reverse [--check] [--phases]
                                         [--root DIR ...]

Builds dsp_stuff_tpu_torch's kernels (printing ptxas' register and spill
lines), then holds the chain kernel (csrc/chain_kernel.cu) against
``segment_fallback`` on the card at T = 3 tiles of 64 blocks plus 5
blocks (y and taps in dBFS, rebuilt states in max abs):

* the bench list past one row an SM (B = SMs + 1: the build for two CTAs
  an SM);
* at B = 67 rows (one CTA an SM): every list of chip_smoke.check_lists(),
  both mtap lists, the 40-stage list, and combs with D < 128, D = 64*128
  and D > 64*128;
* the cycle kernel on an oversized program (chip_smoke) against
  cycle_segment.interpret.

With --check it stops there.  Otherwise it times with CUDA events (median
of 5 after a warm-up) at T = 10 s of 48 kHz audio:

* the bench list at B = 1, 128, 512 and 1024, beside segment_fallback,
  with its bound (chip_smoke.chain_bound);
* at B = 128 and 512, each stage kind of the bench list alone (a lone
  scale stage is the tile walk and the signal I/O with no work), and
  config5's [hp, mtap], its hp and its mtap at B = 128 beside
  segment_fallback.

--phases runs the kernel's build with its phase probes
(chain_kernel.phase_cycles) and prints,
for the bench list and config5's [hp, mtap] at B = 128 (one CTA an SM)
and 512 (two), the clock cycles of thread 0 of each CTA in each phase of
the tile walk, averaged over the CTAs, per tile: where a tile's time goes.

--reverse takes the reverse chain kernel (csrc/chain_reverse_kernel.cu)
instead: it builds the record build, the reverse kernel (built for one
CTA an SM at every B; ptxas' registers and spills printed) and, with
--phases, its probe build (-DCRV_PHASES), then

* holds the reverse kernel against ``segment_adjoint`` on every list of
  chip_smoke.reverse_lists() and reverse_edge_lists() (the 40 stages,
  past the operand slots and the cascades' resident constants; a comb
  longer than a tile, its ring in device memory) at [1, 128], [3, 8,320]
  and [SMs + 1, 8,320], and the 40 stages with 1, 2 and 3 slots
  (chip_smoke.capped_slots) at [3, 8,320]: x's gradient in dBFS and the
  states in max abs (--check stops there);
* times it (no --phases, no --root) on the bench list and config5's list
  at B = 128 and 512 x 10 s: the kernel's device time (torch.profiler),
  the path's (``_kernel_segment_adjoint``, CUDA events) and its bound
  (chip_smoke.chain_bound(..., reverse=True));
* --phases: the probe build on the same lists and sizes, the clock cycles
  of thread 0 of each CTA in each phase of the walk (chain_reverse_kernel.
  PHASES), averaged over the CTAs, per tile;
* --root DIR (repeatable): each DIR's reverse kernel (unpack another
  commit there with ``git archive``: its csrc/chain_reverse_kernel.cu and
  headers, built with this checkout's flags, and its own wrapper
  ops/chain_reverse_kernel.py, which must take the same arguments) and
  this checkout's, in turns there and back (DIR ..., this, this, ... DIR)
  on the same lists and sizes: device time and path time of each.

Prints one line per measurement with the card's name and power limit and
exits 1 if a check failed.  Needs a CUDA device; imports nothing of JAX.
"""

import contextlib
import os
import subprocess
import sys
import types

import numpy as np

from torch_roots import load_module, start_build, swapped

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 48_000
T = 10 * SR
B_CHK = 67
T_CHK = 3 * 64 * 128 + 5 * 128


def checks(cs, dev, rng) -> list:
    """The correctness checks of the module docstring; returns the names
    of the failed ones."""
    import torch
    from dsp_stuff_tpu_torch.ops import chain_kernel, chain_segment
    from dsp_stuff_tpu_torch.ops import cycle_segment
    failed = []

    def check(name, stages, lfos=(), b=B_CHK):
        x = torch.as_tensor((rng.standard_normal((b, T_CHK)) * 0.3)
                            .astype(np.float32), device=dev)
        st = cs.seeded_states(stages, b, rng, dev, T=T_CHK, lfos=lfos)
        try:
            k = cs.kernel_segment(x, stages, st)
            p = chain_segment.segment_fallback(x, stages, st)
            torch.cuda.synchronize()
            cs.compare(name, k, p)
        except Exception as e:               # report every case, then fail
            print(f"  FAILED {name}: {type(e).__name__}: {e}")
            failed.append(name)

    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"chain kernel vs segment_fallback, T={T_CHK}:")
    check(f"bench B={n_sm + 1}", cs.bench_stages(), b=n_sm + 1)
    print(f"... B={B_CHK}:")
    lists = dict(cs.check_lists())
    lists["40 stages"] = cs.long_list()
    tile = chain_kernel.M_TILE * 128
    for D in (100, tile, tile + 808):
        lists[f"comb D={D}"] = (("cascade", (("lp", 0.4),)),
                                ("comb", 0.45, D))
    for name, stages in lists.items():
        check(name, stages)
    for name, (stages, lfos) in cs.mtap_lists().items():
        check(name, stages, lfos)

    program, n_taps = cs.oversized_cycle_program()
    ins = cs.cycle_inputs(program, 8, 1024, rng, dev)
    try:
        k = cs.cycle_kernel_run(*ins, program, n_taps)
        p = cycle_segment.interpret(*ins, program, n_taps)
        torch.cuda.synchronize()
        cs.compare_cycle(f"cycle, {len(program)} instructions", k, p)
    except Exception as e:
        print(f"  FAILED oversized cycle program: {type(e).__name__}: {e}")
        failed.append("cycle")
    return failed


def times(cs, dev, rng, card) -> None:
    import torch
    from dsp_stuff_tpu_torch.models import presets
    from dsp_stuff_tpu_torch.ops import chain_kernel, chain_segment
    x_all = torch.as_tensor(
        rng.standard_normal((1024, T), dtype=np.float32) * np.float32(0.25),
        device=dev)

    def line(name, b, ms, extra=""):
        print(f"{name:40s} {ms:9.3f} ms {b * T / SR / (ms / 1e3):>12,.0f} "
              f"audio-s/s{extra}  [{card}]")

    bench = cs.bench_stages()
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    for b in (1, 128, 512, 1024):
        x = x_all[:b]
        st = cs.seeded_states(bench, b, rng, dev)
        ms = cs.cuda_ms(lambda: chain_kernel.chain_kernel_call(x, bench, st))
        plain = cs.cuda_ms(lambda: chain_segment.segment_fallback(
            x, bench, st))
        bms, bby = cs.chain_bound(bench, b, T)
        line(f"bench, B={b}, {chain_kernel.geometry(b, n_sm)[1]} CTA/SM", b,
             ms, f", plain {plain:.3f} ms, bound {bms:.3f} ms by {bby} "
             f"({bms / ms:.1%})")
    h = bench[1]
    kinds = [("scale only", (h,)),
             ("cascade gain+biquad (N=2)", (bench[0],)),
             ("cascade lp+hp (N=2)", (bench[3],)),
             ("ew overdrive", (bench[2],)),
             ("ew distort:Tanh", (bench[5],)),
             ("ew chebyshev", (bench[7],)),
             ("comb D=2400", (bench[9],)),
             ("tap", (("tap", 0),))]
    for b in (128, 512):
        x = x_all[:b]
        for name, stages in kinds:
            st = cs.seeded_states(stages, b, rng, dev)
            ms = cs.cuda_ms(lambda: chain_kernel.chain_kernel_call(
                x, stages, st))
            line(f"{name}, B={b}", b, ms)
    stages5, lfos5 = cs.planned_stages(presets.config5_feedback_16node()[0])
    x = x_all[:128]
    for name, stages in (("config5 [hp, mtap]", stages5),
                         ("config5 hp alone", stages5[:1]),
                         ("config5 mtap alone", stages5[1:])):
        st = cs.seeded_states(stages, 128, rng, dev, T=T,
                              lfos=lfos5 if "mtap" in name else ())
        ms = cs.cuda_ms(lambda: chain_kernel.chain_kernel_call(x, stages, st))
        plain = cs.cuda_ms(lambda: chain_segment.segment_fallback(
            x, stages, st))
        line(f"{name}, B=128", 128, ms, f", plain {plain:.3f} ms")


def phases(cs, dev, rng, card) -> None:
    """Cycles per tile in each phase, from the kernel's probe build."""
    import torch
    from dsp_stuff_tpu_torch.models import presets
    from dsp_stuff_tpu_torch.ops import chain_kernel
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    x_all = torch.as_tensor(
        rng.standard_normal((512, T), dtype=np.float32) * np.float32(0.25),
        device=dev)
    stages5, lfos5 = cs.planned_stages(presets.config5_feedback_16node()[0])
    for name, stages, lfos in (("bench", cs.bench_stages(), ()),
                               ("config5 [hp, mtap]", stages5, lfos5)):
        for b in (128, 512):
            x = x_all[:b]
            st = cs.seeded_states(stages, b, rng, dev, T=T, lfos=lfos)
            chain_kernel.phase_cycles(x, stages, st)        # warm-up
            buf = chain_kernel.phase_cycles(x, stages, st)
            n_tiles = -(-(T // 128) // chain_kernel.M_TILE)
            per = buf.astype(np.float64).mean(axis=0) / n_tiles
            ctas = chain_kernel.geometry(b, n_sm)[1]
            print(f"{name}, B={b} ({ctas} CTA/SM): {per.sum():,.0f} cycles "
                  f"a tile: " + ", ".join(
                      f"{p} {v:,.0f}" for p, v in zip(chain_kernel.PHASES,
                                                      per) if v)
                  + f"  [{card}]")


REVERSE_B = (128, 512)


def reverse_lists(cs) -> dict:
    """The timed lists of --reverse: name -> (stages, lfos)."""
    lists = cs.reverse_lists()
    return {"bench": lists["bench"], "config5": lists["mtap_config5"]}


def reverse_checks(cs, dev, rng) -> list:
    """The reverse kernel against segment_adjoint (module docstring);
    returns the names of the failed cases."""
    import torch
    from dsp_stuff_tpu_torch.ops import chain_segment
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    lists = {**cs.reverse_lists(), **cs.reverse_edge_lists()}
    cases = [(name, stages, lfos, b, t, None)
             for name, (stages, lfos) in lists.items()
             for b, t in ((1, 128), (3, 8320), (n_sm + 1, 8320))]
    cases += [("40 stages", cs.long_list(), (), 3, 8320, n)
              for n in (1, 2, 3)]
    failed = []
    print("reverse chain kernel vs segment_adjoint:")
    for name, stages, lfos, b, t, nslot in cases:
        label = f"{name} [{b}, {t}]" + (f", {nslot} slots" if nslot else "")
        try:
            x, st, cts, recs = cs.chain_reverse_inputs(stages, lfos, b, t,
                                                       rng, dev)
            shapes = tuple(v.shape for v in (x, *st))
            with (cs.capped_slots(nslot) if nslot is not None
                  else contextlib.nullcontext()):
                k = chain_segment._kernel_segment_adjoint(cts, shapes, stages,
                                                          recs, st)
            p = chain_segment.segment_adjoint(cts, shapes, stages, recs, st)
            torch.cuda.synchronize()
            cs.compare_chain_reverse(label, stages, k, p)
        except Exception as e:               # report every case, then fail
            print(f"  FAILED {label}: {type(e).__name__}: {e}")
            failed.append(label)
    return failed


def reverse_case(cs, stages, lfos, b, rng, dev):
    """(run, stages): the kernel path of the reverse at [b, T] on seeded
    cotangents and the record build's records."""
    from dsp_stuff_tpu_torch.ops import chain_segment
    x, st, cts, recs = cs.chain_reverse_inputs(stages, lfos, b, T, rng, dev)
    shapes = tuple(v.shape for v in (x, *st))
    del x

    def run():
        return chain_segment._kernel_segment_adjoint(cts, shapes, stages,
                                                     recs, st)
    return run


def reverse_time(cs, run, stages, b, tag, card) -> tuple:
    """The reverse kernel's device time and its path's on ``run``,
    printed with ``tag``; returns both."""
    dev_ms, n = cs.kernel_device_ms(run, "chain_reverse_kernel")
    dev_ms = float("nan") if dev_ms is None else dev_ms    # not measured
    path_ms = cs.cuda_ms(run)
    bms, bby = cs.chain_bound(stages, b, T, reverse=True)
    print(f"reverse chain kernel{tag}, B={b} x 10 s: kernel {dev_ms:.3f} ms "
          f"(device, {n} launches profiled), path {path_ms:.3f} ms; bound "
          f"{bms:.3f} ms by {bby} ({bms / dev_ms:.1%} of the kernel) "
          f"[{card}]")
    return dev_ms, path_ms


def reverse_phases(cs, dev, rng, card) -> None:
    """Cycles per tile in each phase, from the reverse's probe build."""
    import torch
    from dsp_stuff_tpu_torch.ops import chain_kernel
    from dsp_stuff_tpu_torch.ops import chain_reverse_kernel as crk
    n_tiles = -(-(T // 128) // chain_kernel.M_TILE)
    for name, (stages, lfos) in reverse_lists(cs).items():
        for b in REVERSE_B:
            run = reverse_case(cs, stages, lfos, b, rng, dev)
            got = []

            def probe(*args):
                out, buf = crk.phase_cycles(*args)
                got.append(buf)
                return out
            with swapped(crk, "chain_reverse_call", probe):
                run()                                       # warm-up
                run()
            per = got[-1].astype(np.float64).mean(axis=0) / n_tiles
            print(f"reverse {name}, B={b}: {per.sum():,.0f} "
                  f"cycles a tile: " + ", ".join(
                      f"{p} {v:,.0f}" for p, v in zip(crk.PHASES, per) if v)
                  + f"  [{card}]")
            del run
            torch.cuda.empty_cache()


def other_reverse(root: str):
    """``root``'s reverse wrapper as a module, its library started
    building (its csrc, this checkout's nvcc flags) into
    build/torch_kernels/: (module, library path, nvcc process or None)."""
    mod = load_module(root, os.path.join("dsp_stuff_tpu_torch", "ops",
                                         "chain_reverse_kernel.py"),
                      f"other_chain_reverse_{abs(hash(root))}")
    return (mod, *start_build(root, "chain_reverse_kernel"))


def reverse_turns(cs, dev, rng, card, mods: dict) -> None:
    """The reverse wrappers ``mods`` ({label: module}) in turns, there and
    back (A, B, B, A), on each timed list and B: the medians of each
    one's two rounds."""
    import torch
    import dsp_stuff_tpu_torch.ops as ops
    order = list(mods) + list(mods)[::-1]
    for name, (stages, lfos) in reverse_lists(cs).items():
        for b in REVERSE_B:
            run = reverse_case(cs, stages, lfos, b, rng, dev)
            got = {who: [] for who in mods}
            for who in order:
                with swapped(ops, "chain_reverse_kernel", mods[who]):
                    got[who].append(reverse_time(
                        cs, run, stages, b, f" [{who}], {name}", card))
            for who, rows in got.items():
                k, p = np.median(np.array(rows), axis=0)
                print(f"reverse chain kernel [{who}], {name}, B={b} x 10 s, "
                      f"turns: kernel "
                      f"{', '.join(f'{r[0]:.3f}' for r in rows)} ms (median "
                      f"{k:.3f}), path "
                      f"{', '.join(f'{r[1]:.3f}' for r in rows)} ms (median "
                      f"{p:.3f}) [{card}]")
            del run
            torch.cuda.empty_cache()


def reverse_main(cs, dev, rng, card) -> int:
    """--reverse (module docstring)."""
    import ctypes
    from dsp_stuff_tpu_torch.ops import chain_reverse_kernel as crk
    from dsp_stuff_tpu_torch.ops import cuda_build
    roots = [os.path.abspath(sys.argv[i + 1])
             for i, a in enumerate(sys.argv[:-1]) if a == "--root"]
    others = {os.path.relpath(r, ROOT): other_reverse(r) for r in roots}
    jobs = [("chain_kernel", ("CK_RECORD",), ""),
            ("chain_reverse_kernel", (), "")]
    if "--phases" in sys.argv:
        jobs.append(("chain_reverse_kernel", ("CRV_PHASES",), ""))
    for (name, defines, _), (lib, log) in zip(jobs,
                                              cuda_build.build_jobs(jobs)):
        print_ptxas(f"{name} {list(defines)}", log)
    mods = {}
    for label, (mod, lib, proc) in others.items():
        if proc is not None:
            log, _ = proc.communicate()
            if proc.returncode:
                print(f"nvcc failed on {label}'s reverse kernel:\n{log}")
                return 1
            print_ptxas(f"chain_reverse_kernel [{label}]", log)
        # its _lib binds and checks the library built from its sources
        mod.cuda_build = types.SimpleNamespace(
            load=lambda name, defines=(), lib=ctypes.CDLL(str(lib)): lib)
        mods[label] = mod
    failed = reverse_checks(cs, dev, rng)
    print(f"failed: {failed}" if failed else "all checks passed")
    if failed:
        return 1
    if "--check" in sys.argv:
        return 0
    if "--phases" in sys.argv:
        reverse_phases(cs, dev, rng, card)
    if mods:
        mods["this"] = crk
        reverse_turns(cs, dev, rng, card, mods)
    if "--phases" not in sys.argv and not mods:
        for name, (stages, lfos) in reverse_lists(cs).items():
            for b in REVERSE_B:
                run = reverse_case(cs, stages, lfos, b, rng, dev)
                reverse_time(cs, run, stages, b, f", {name}", card)
    return 0


def print_ptxas(what: str, log: str) -> None:
    """nvcc's ptxas lines of each kernel: its entry, registers, spills."""
    for line in log.splitlines():
        if ("entry function" in line or "registers" in line
                or "spill" in line):
            print(f"  {what} ptxas: {line.strip()}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("measure_torch_chain: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import chip_smoke as cs
    from dsp_stuff_tpu_torch.ops import cuda_build
    from dsp_stuff_tpu_torch.utils import precision

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(card)
    precision.set_policy("fast")
    rng = np.random.default_rng(0)
    dev = torch.device("cuda", 0)
    if "--reverse" in sys.argv:
        return reverse_main(cs, dev, rng, card)
    for name, (lib, log) in cuda_build.build().items():
        print_ptxas(name, log)
    if "--phases" in sys.argv:
        phases(cs, dev, rng, card)
        return 0
    failed = checks(cs, dev, rng)
    if failed or "--check" in sys.argv:
        print(f"failed: {failed}" if failed else "all checks passed")
        return 1 if failed else 0
    times(cs, dev, rng, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
