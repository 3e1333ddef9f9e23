#!/usr/bin/env python3
"""Check, time and profile the cycle kernel and its reverse on one NVIDIA
GPU.

    python3 tools/measure_torch_cycle.py [--check] [--phases] [--times]
                                         [--root DIR ...]

Builds dsp_stuff_tpu_torch's kernels (printing ptxas' register and spill
lines, also of the reverse kernel's builds for config5's, mega_cycle_10's
and the 56-instruction program), then runs the parts asked for, in this
order (no flag: --check --times):

* ``--check``: holds the cycle kernel (csrc/cycle_kernel.cu) against
  ``cycle_segment.interpret`` on the card at the shapes of
  chip_smoke.cycle_cases(): config5's program over a T that wraps its
  comb ring three times with a ragged end, at 64 rows and past one row an
  SM, a ring too large for shared memory (the device-memory path), the
  loop graph's program and a 56-instruction one (taps in dBFS, registers
  and rebuilt states in max abs); and the reverse cycle kernel
  (csrc/cycle_reverse_kernel.cu) against ``interpret_adjoint`` on every
  case of chip_smoke.cycle_reverse_cases() (each feed gradient in dBFS,
  registers and states in max abs);
* ``--phases``: the probe builds of both kernels (-DCY_PHASES,
  -DCR_PHASES; cycle_kernel.phase_cycles, cycle_reverse_kernel.
  phase_cycles) on config5's program at B = 128 and 512 x 10 s: for
  thread 0 and thread 127 of each CTA, the clock cycles of each phase per
  128-sample block, averaged over the CTAs: where a block's time goes;
* ``--times``: with CUDA events (median of 5 after a warm-up) at T = 10 s
  of 48 kHz audio, the cycle kernel on config5's program at B = 128 and
  512 with its bound (chip_smoke.cycle_bound); its reverse there, the
  kernel's device time alone (torch.profiler, the reverse kernel's
  records only) and the time of the kernel path of cycle_segment's
  backward (``_kernel_cycle_adjoint``: the launch with its tables and
  outputs), with its bound and floor (chip_smoke.cycle_reverse_bound,
  cycle_reverse_floor_ms at the SM clock chip_smoke assumes); and the
  envelope kernel chunked at B = 128 and 512 and sequential at B = 4 x
  48,000, each beside its dependent-chain floor: the FP32 operations on
  the path a row cannot start before the last one ended (a block's path
  from the registers the previous block set to the ones it sets; an
  envelope step's compare, select, multiply and add), LAT = 4 cycles each
  at the card's maximum SM clock.  Memory, barrier and shuffle latencies
  are left out, so the floor is a lower bound, like the bound by bytes;
* ``--root DIR`` (repeatable): each DIR's reverse kernel (unpack another
  commit there with ``git archive``; its csrc/cycle_reverse_kernel.cu
  with the header of its own generator, built with this checkout's
  flags) and this checkout's, in turns there and back (DIR ..., this,
  this, ... DIR) on config5's, mega_cycle_10's and the 56-instruction
  program at B = 128 and 512 x 10 s: the kernel's device time and the
  path's time of each, through this checkout's wrapper and tables (the
  builds must share the tables' layout; the build checks it).

Prints one line per measurement with the card's name and power limit and
exits 1 if a check failed.  Needs a CUDA device; imports nothing of JAX.
"""

import contextlib
import ctypes
import os
import subprocess
import sys

import numpy as np

from torch_roots import load_module, start_build, swapped

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 48_000
T = 10 * SR
LAT = 4             # cycles of a dependent FP32 add, multiply or FMA


def block_path_ops(program) -> int:
    """FP32 operations on a block's dependent path through ``program``,
    its instructions taken in series (config5's one loop runs through
    each): a join's adds and scale, lin2's multiply and add past its
    longer join, a comb's add (its ring read is of an earlier block), a
    cascade's longest column (128 products in four sums of 32 FMAs, two
    adds, the carry term's add), one a shaper or scale."""
    def join(ts, scale):
        return len(ts) - 1 + (scale != 1.0)
    ops = 0
    for ins in program:
        if ins[0] == "join":
            ops += join(ins[1], ins[2])
        elif ins[0] == "lin2":
            ops += max(join(ins[1], ins[2]), join(ins[3], ins[4])) + 2
        elif ins[0] == "comb":
            ops += 1
        elif ins[0] == "cascade":
            ops += 128 // 4 + 2 + 1
        elif ins[0] in ("ew", "scale"):
            ops += 1
    return ops


def floor_ms(steps: int, ops_a_step: int, mhz: float) -> float:
    return steps * ops_a_step * LAT / (mhz * 1e3)


def config5(cs):
    from dsp_stuff_tpu_torch.models import presets
    return cs.cycle_program(presets.config5_feedback_16node()[0])


def reverse_programs(cs) -> dict:
    """{name: (program, n_taps)} of the programs whose reverse builds'
    ptxas lines are printed and which --root times."""
    import test_torch_fuzz_gen as gen
    return {"config5": config5(cs),
            "mega_cycle_10": cs.cycle_program(
                gen._random_mega_cycle_graph(10)[0]),
            "56 instructions": cs.oversized_cycle_program()}


def checks(cs, dev, rng) -> list:
    """The correctness checks of the module docstring; returns the names
    of the failed ones."""
    import torch
    import dsp_stuff_tpu_torch as dst
    from dsp_stuff_tpu_torch.ops import cycle_segment
    failed = []
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    print("cycle kernel vs cycle_segment.interpret:")
    for name, program, n_taps, b, t in cs.cycle_cases(n_sm):
        ins = cs.cycle_inputs(program, b, t, rng, dev)
        try:
            k = cs.cycle_kernel_run(*ins, program, n_taps)
            p = cycle_segment.interpret(*ins, program, n_taps)
            torch.cuda.synchronize()
            cs.compare_cycle(f"{name} B={b} T={t}", k, p)
        except Exception as e:               # report every case, then fail
            print(f"  FAILED {name}: {type(e).__name__}: {e}")
            failed.append(name)
    print("reverse cycle kernel vs cycle_segment.interpret_adjoint:")
    with dst.policy("fast"):
        for name, program, n_taps, b, t in cs.cycle_reverse_cases():
            try:
                cts, shapes, recs = cs.reverse_inputs(program, n_taps, b, t,
                                                      rng, dev)
                k = cycle_segment._kernel_cycle_adjoint(cts, shapes, program,
                                                        n_taps, recs)
                p = cycle_segment.interpret_adjoint(cts, shapes, program,
                                                    n_taps, recs)
                torch.cuda.synchronize()
                cs.compare_reverse(name, k, p)
            except Exception as e:
                print(f"  FAILED reverse {name}: {type(e).__name__}: {e}")
                failed.append(f"reverse {name}")
    return failed


def reverse_times(cs, program, n_taps, b, ins, tag, card,
                  pname="config5") -> tuple:
    """The reverse kernel's device time and the kernel path's time on
    ``ins`` (reverse_inputs) for the program named ``pname``, printed with
    ``tag``; returns both."""
    from dsp_stuff_tpu_torch.ops import cycle_segment
    cts, shapes, recs = ins

    def run():
        return cycle_segment._kernel_cycle_adjoint(cts, shapes, program,
                                                   n_taps, recs)

    dev_ms, n = cs.kernel_device_ms(run, "cycle_reverse_kernel")
    dev_ms = float("nan") if dev_ms is None else dev_ms   # not measured
    path_ms = cs.cuda_ms(run)
    bms, bby = cs.cycle_reverse_bound(program, b, T)
    fl = cs.cycle_reverse_floor_ms(program, T)
    print(f"reverse cycle kernel{tag}, {pname} program, B={b} x 10 s: "
          f"kernel {dev_ms:.3f} ms (device, {n} launches profiled), path "
          f"{path_ms:.3f} ms; bound {bms:.3f} ms by {bby} ({bms / dev_ms:.1%}"
          f" of the kernel), dependent-chain floor {fl:.3f} ms ("
          f"{fl / dev_ms:.1%}; {cs.reverse_block_path_ops(program)} "
          f"operations a block) [{card}]")
    return dev_ms, path_ms


def times(cs, dev, rng, card) -> None:
    import torch
    from dsp_stuff_tpu_torch.ops import cycle_kernel, envelope, \
        envelope_kernel
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60).stdout.split()[0])
    program, n_taps = config5(cs)
    ops = block_path_ops(program)
    for b in (128, 512):
        ins = cs.cycle_inputs(program, b, T, rng, dev)
        ms = cs.cuda_ms(lambda: cycle_kernel.cycle_kernel_call(
            *ins, program, n_taps))
        bms, bby = cs.cycle_bound(program, b, T)
        print(f"cycle kernel, config5 program, B={b} x 10 s: {ms:.3f} ms, "
              f"bound {bms:.3f} ms by {bby} ({bms / ms:.1%}), dependent-"
              f"chain floor {floor_ms(T // 128, ops, mhz):.3f} ms ({ops} "
              f"operations a block at {mhz:.0f} MHz) [{card}]")
        del ins
        rins = cs.reverse_inputs(program, n_taps, b, T, rng, dev)
        reverse_times(cs, program, n_taps, b, rins, "", card)
        del rins
    atk = envelope.gain_from_frames(50.0)
    rel = envelope.gain_from_frames(400.0)
    gains = cs.env_gains(atk, rel, dev)
    for b, t, chunk, what in ((128, T, envelope._CHUNK, "chunked"),
                              (512, T, envelope._CHUNK, "chunked"),
                              (4, SR, SR, "sequential")):
        x = torch.as_tensor((rng.standard_normal((b, t)) * 0.5)
                            .astype(np.float32), device=dev)
        e0 = torch.as_tensor(rng.random(b).astype(np.float32), device=dev)
        ms = cs.cuda_ms(lambda: envelope_kernel.peak_envelope_cuda(
            x, gains, e0, chunk=chunk))
        bms, bby = cs.bound(8.0 * b * t, 3.0 * b * t)
        steps = min(t, 2 * chunk)       # a window: the chunk before, its own
        print(f"envelope kernel, {what}, B={b} x {t}: {ms:.3f} ms, bound "
              f"{bms:.4f} ms by {bby}, dependent-chain floor "
              f"{floor_ms(steps, 4, mhz):.3f} ms ({steps} steps of 4 "
              f"operations at {mhz:.0f} MHz) [{card}]")


def print_phases(what, b, buf, names, card) -> None:
    per = buf.astype(np.float64).mean(axis=0) / (T // 128)
    for slot, who in enumerate(("thread 0", "thread 127")):
        print(f"{what}, config5 program, B={b}, {who}: {per[slot].sum():,.0f}"
              f" cycles a block: " + ", ".join(
                  f"{p} {v:,.0f}" for p, v in zip(names, per[slot]) if v)
              + f"  [{card}]")


def phases(cs, dev, rng, card) -> None:
    """Cycles per block in each phase, from both kernels' probe builds."""
    import dsp_stuff_tpu_torch as dst
    from dsp_stuff_tpu_torch.ops import (cycle_kernel, cycle_reverse_kernel,
                                         cycle_segment)
    program, n_taps = config5(cs)
    for b in (128, 512):
        ins = cs.cycle_inputs(program, b, T, rng, dev)
        cycle_kernel.phase_cycles(*ins, program, n_taps)          # warm-up
        buf = cycle_kernel.phase_cycles(*ins, program, n_taps)
        print_phases("cycle kernel", b, buf, cycle_kernel.PHASES, card)
        del ins
    stand_in = cycle_reverse_kernel.cycle_reverse_call
    for b in (128, 512):
        cts, shapes, recs = cs.reverse_inputs(program, n_taps, b, T, rng,
                                              dev)
        bufs = []

        def probe(*args):           # the kernel path, through the probe build
            bufs.append(cycle_reverse_kernel.phase_cycles(*args))
            return stand_in(*args)

        with dst.policy("fast"), swapped(cycle_reverse_kernel,
                                         "cycle_reverse_call", probe):
            for _ in range(2):                                    # warm-up
                cycle_segment._kernel_cycle_adjoint(cts, shapes, program,
                                                    n_taps, recs)
        print_phases("reverse cycle kernel", b, bufs[-1],
                     cycle_reverse_kernel.PHASES, card)
        del cts, recs


def start_other(root: str, program, budget: int):
    """Start building ``root``'s reverse kernel for ``program`` (its source
    with the header of its own generator, this checkout's nvcc flags) into
    build/torch_kernels/; returns (library path, the nvcc process or None
    when built)."""
    mod = load_module(root, os.path.join("dsp_stuff_tpu_torch", "ops",
                                         "cycle_reverse_kernel.py"),
                      "other_cycle_reverse_kernel")
    return start_build(root, "cycle_reverse_kernel",
                       mod.source_for(program, budget))


def turns(cs, dev, rng, card, libs: dict) -> None:
    """The reverse kernel's builds ``libs`` ({label: {program name:
    library}}, {} for this checkout's own) in turns, there and back (A, B,
    C, C, B, A), on each program of reverse_programs at B = 128 and 512:
    the medians of each one's two rounds."""
    import torch
    import dsp_stuff_tpu_torch as dst
    from dsp_stuff_tpu_torch.ops import cycle_reverse_kernel as cr
    order = list(libs) + list(libs)[::-1]
    for pname, (program, n_taps) in reverse_programs(cs).items():
        for b in (128, 512):
            ins = cs.reverse_inputs(program, n_taps, b, T, rng, dev)
            got = {who: [] for who in libs}
            with dst.policy("fast"):
                for who in order:
                    lib = libs[who].get(pname)
                    with (swapped(cr, "_lib", lambda src, d=(), lib=lib: lib)
                          if lib is not None else contextlib.nullcontext()):
                        got[who].append(reverse_times(
                            cs, program, n_taps, b, ins, f" [{who}]", card,
                            pname))
            for who, rows in got.items():
                k, p = np.median(np.array(rows), axis=0)
                print(f"reverse cycle kernel [{who}], {pname} program, B={b}"
                      f" x 10 s, turns: kernel "
                      f"{', '.join(f'{r[0]:.3f}' for r in rows)} ms (median "
                      f"{k:.3f}), path "
                      f"{', '.join(f'{r[1]:.3f}' for r in rows)} ms (median "
                      f"{p:.3f}) [{card}]")
            del ins
            torch.cuda.empty_cache()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("measure_torch_cycle: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import chip_smoke as cs
    from dsp_stuff_tpu_torch.ops import (cuda_build, cycle_kernel,
                                         cycle_reverse_kernel)
    from dsp_stuff_tpu_torch.utils import precision

    parts = {p for p in ("check", "phases", "times") if f"--{p}" in sys.argv}
    roots = [os.path.abspath(sys.argv[i + 1])
             for i, a in enumerate(sys.argv[:-1]) if a == "--root"]
    if not parts and not roots:
        parts = {"check", "times"}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(card)
    precision.set_policy("fast")
    rng = np.random.default_rng(0)
    dev = torch.device("cuda", 0)
    budget = cycle_kernel.budget_of(dev)
    # each other root's reverse kernel for each timed program, its nvcc
    # started now
    others = {(root, name): start_other(root, prog, budget)
              for root in roots
              for name, (prog, _) in reverse_programs(cs).items()}
    # the envelope kernel, the cycle kernel for each program of the forward
    # checks, the reverse for the printed programs and the reverse checks,
    # the record builds of the programs with a shaper and the probe builds,
    # all built together
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    fwd = {name: prog for name, prog, _, _, _ in cs.cycle_cases(n_sm)}
    rev = {name: prog for name, (prog, _) in reverse_programs(cs).items()}
    if "check" in parts:
        for name, prog, _, _, _ in cs.cycle_reverse_cases():
            if prog not in rev.values():
                rev[name] = prog
    if "check" not in parts:
        fwd = {"config5": config5(cs)[0]}
    jobs, names = [("envelope_kernel", (), "")], ["envelope_kernel"]
    for name, p in fwd.items():
        jobs.append(("cycle_kernel", (), cycle_kernel.source_for(p, budget)))
        names.append(name)
    for name, p in rev.items():
        jobs.append(("cycle_reverse_kernel", (),
                     cycle_reverse_kernel.source_for(p, budget)))
        names.append(f"reverse ({name})")
        if cycle_kernel.has_shaper(p):
            jobs.append(("cycle_kernel", ("CY_RECORD",),
                         cycle_kernel.source_for(p, budget, record=True)))
            names.append(f"record build ({name})")
    if "phases" in parts:
        c5 = config5(cs)[0]
        jobs += [("cycle_kernel", ("CY_PHASES",),
                  cycle_kernel.source_for(c5, budget)),
                 ("cycle_reverse_kernel", ("CR_PHASES",),
                  cycle_reverse_kernel.source_for(c5, budget))]
        names += ["config5 [CY_PHASES]", "reverse (config5) [CR_PHASES]"]
    for name, (lib, log) in zip(names, cuda_build.build_jobs(jobs)):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name} ptxas: {line.strip()}")
    libs = {}
    for (root, name), (lib_path, proc) in others.items():
        label = os.path.relpath(root, ROOT)
        if proc is not None:
            log, _ = proc.communicate()
            if proc.returncode:
                print(f"nvcc failed on {label}'s reverse kernel ({name}):\n"
                      f"{log}")
                return 1
            for line in log.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  reverse ({name}) [{label}] ptxas: "
                          f"{line.strip()}")
        libs.setdefault(label, {})[name] = cycle_reverse_kernel.bind(
            ctypes.CDLL(str(lib_path)))
    if "check" in parts:
        failed = checks(cs, dev, rng)
        print(f"failed: {failed}" if failed else "all checks passed")
        if failed:
            return 1
    if "phases" in parts:
        phases(cs, dev, rng, card)
    if "times" in parts:
        times(cs, dev, rng, card)
    if roots:
        libs["this"] = {}
        turns(cs, dev, rng, card, libs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
