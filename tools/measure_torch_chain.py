#!/usr/bin/env python3
"""Check, time and profile the chain kernel on one NVIDIA GPU.

    python3 tools/measure_torch_chain.py [--check | --phases]

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
    for name, (lib, log) in cuda_build.build().items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name} ptxas: {line.strip()}")
    precision.set_policy("fast")
    rng = np.random.default_rng(0)
    dev = torch.device("cuda", 0)
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
