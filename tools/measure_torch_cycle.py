#!/usr/bin/env python3
"""Check, time and profile the cycle kernel on one NVIDIA GPU.

    python3 tools/measure_torch_cycle.py [--check | --phases]

Builds dsp_stuff_tpu_torch's kernels (printing ptxas' register and spill
lines), then holds the cycle kernel (csrc/cycle_kernel.cu) against
``cycle_segment.interpret`` on the card at the shapes of
chip_smoke.cycle_cases(): config5's program over a T that wraps its comb
ring three times with a ragged end, at 64 rows and past one row an SM,
a ring too large for shared memory (the device-memory path), the loop
graph's program and a 56-instruction one (taps in dBFS, registers and
rebuilt states in max abs).

With --check it stops there.  Otherwise it times with CUDA events (median
of 5 after a warm-up) at T = 10 s of 48 kHz audio the cycle kernel on
config5's program at B = 128 and 512, with its bound
(chip_smoke.cycle_bound), its reverse (csrc/cycle_reverse_kernel.cu, the
kernel path of cycle_segment's backward) there, with its bound and floor
(chip_smoke.cycle_reverse_bound, cycle_reverse_floor_ms at the SM clock
chip_smoke assumes), and the envelope kernel chunked at B = 128 and
512 and sequential at B = 4 x 48,000, each beside its dependent-chain
floor: the FP32 operations on the path a row cannot start before the
last one ended (a block's path from the registers the previous block set
to the ones it sets; an envelope step's compare, select, multiply and
add), LAT = 4 cycles each at the card's maximum SM clock.  Memory,
barrier and shuffle latencies are left out, so the floor is a lower
bound, like the bound by bytes.

--phases runs the kernel's build with its phase probes
(cycle_kernel.phase_cycles) on config5's program at B = 128 and 512 x
10 s and prints, for thread 0 and thread 127 of each CTA, the clock
cycles of each phase per 128-sample block, averaged over the CTAs: where
a block's time goes.

Prints one line per measurement with the card's name and power limit and
exits 1 if a check failed.  Needs a CUDA device; imports nothing of JAX.
"""

import os
import subprocess
import sys

import numpy as np

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


def checks(cs, dev, rng) -> list:
    """The correctness checks of the module docstring; returns the names
    of the failed ones."""
    import torch
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
    return failed


def times(cs, dev, rng, card) -> None:
    import torch
    from dsp_stuff_tpu_torch.models import presets
    from dsp_stuff_tpu_torch.ops import cycle_kernel, cycle_segment, \
        envelope, envelope_kernel
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60).stdout.split()[0])
    program, n_taps = cs.cycle_program(presets.config5_feedback_16node()[0])
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
        cts, shapes, recs = cs.reverse_inputs(program, n_taps, b, T, rng, dev)
        ms = cs.cuda_ms(lambda: cycle_segment._kernel_cycle_adjoint(
            cts, shapes, program, n_taps, recs))
        bms, bby = cs.cycle_reverse_bound(program, b, T)
        fl = cs.cycle_reverse_floor_ms(program, T)
        print(f"reverse cycle kernel, config5 program, B={b} x 10 s: "
              f"{ms:.3f} ms, bound {bms:.3f} ms by {bby} ({bms / ms:.1%}), "
              f"dependent-chain floor {fl:.3f} ms "
              f"({cs.reverse_block_path_ops(program)} operations a block) "
              f"[{card}]")
        del cts, recs
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


def phases(cs, dev, rng, card) -> None:
    """Cycles per block in each phase, from the kernel's probe build."""
    from dsp_stuff_tpu_torch.models import presets
    from dsp_stuff_tpu_torch.ops import cycle_kernel
    program, n_taps = cs.cycle_program(presets.config5_feedback_16node()[0])
    for b in (128, 512):
        ins = cs.cycle_inputs(program, b, T, rng, dev)
        cycle_kernel.phase_cycles(*ins, program, n_taps)          # warm-up
        buf = cycle_kernel.phase_cycles(*ins, program, n_taps)
        per = buf.astype(np.float64).mean(axis=0) / (T // 128)
        for slot, who in enumerate(("thread 0", "thread 127")):
            print(f"config5 program, B={b}, {who}: {per[slot].sum():,.0f} "
                  f"cycles a block: " + ", ".join(
                      f"{p} {v:,.0f}" for p, v in zip(cycle_kernel.PHASES,
                                                      per[slot]) if v)
                  + f"  [{card}]")
        del ins


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

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(card)
    precision.set_policy("fast")
    rng = np.random.default_rng(0)
    dev = torch.device("cuda", 0)
    # the envelope kernel and the cycle kernel for each program, built
    # together (the probe build of config5's program with --phases)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    cases = {name: prog for name, prog, _, _, _ in cs.cycle_cases(n_sm)}
    if "--phases" in sys.argv:
        cases = {"config5": cases["config5 ring wraps"]}
    d = ("CY_PHASES",) if "--phases" in sys.argv else ()
    budget = cycle_kernel.budget_of(dev)
    jobs = [("envelope_kernel", (), "")] + [
        ("cycle_kernel", d, cycle_kernel.source_for(p, budget))
        for p in cases.values()]
    names = ["envelope_kernel", *cases]
    if "--phases" not in sys.argv and "--check" not in sys.argv:
        jobs.append(("cycle_reverse_kernel", (),
                     cycle_reverse_kernel.source_for(
                         cases["config5 ring wraps"], budget)))
        names.append("reverse (config5)")
    for name, (lib, log) in zip(names, cuda_build.build_jobs(jobs)):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}{list(d) or ''} ptxas: {line.strip()}")
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
