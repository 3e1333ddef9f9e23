#!/usr/bin/env python3
"""Smoke run of the PyTorch port (dsp_stuff_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from csrc/ with nvcc (one nvcc per
source, and one per cycle block program, since the cycle kernel is built
for each program; all started together) and holds each against its plain
PyTorch version on the card: the chain kernel (every check list, both mtap
lists and a 40-stage list, at one tile and at a walk of three tiles and a
ragged one, also past one row an SM, the build for two CTAs an SM), the
cycle kernel (config5's program over a T that wraps its comb ring three
times with a ragged end, at 64 rows and past one row an SM; a ring too
large for shared memory, in device memory; a loop graph's program and one
past the capacity the kernel once had), the envelope kernel (sequential;
chunked at small chunks on a ragged T, at one row with x's start not
16-byte aligned and NaN in x, and at the main path's shape, each with its
max abs difference, expected 0) and the first-order recurrence kernel
(forward, reverse and per-sample, each also against a float64 solve, at
the fitting path's shape and at edge shapes: T = 1, a tile and one sample
either side, unaligned rows, one long row, many short rows; ten launches
bitwise equal; and its autograd Function against the float64 one).
Then it drives the port's main paths through ``compile_graph(...,
device="cuda")``:

* the 10-node bench chain over 512 streams x 10 s at 48 kHz, with the
  chain kernel's launch count (its plain build: a render without grad
  records nothing), the NumPy oracle, the state handoff and
  the parity policy;
* config5, the 16-node feedback graph (models/presets.py), over 128
  streams x 10 s, with each kernel's launch count (one chain, one cycle,
  one envelope launch), the composed NumPy oracle, a 2 x 5 s handoff and
  the parity policy (4 streams x 1 s, the sequential envelope kernel's
  path, where that kernel is also held against its plain version at that
  shape);
* the pointwise groups (compiler/pointwise.py, csrc/pointwise_kernel.cu,
  one kernel generated and built per group program, all built with the
  others): every fusable form (gain, add, mix, the fan-in average, the
  modulation map, overdrive, chebyshev, eight distort modes) under fast,
  parity and exact at three layouts (float4, one sample a thread, a row's
  tail) with NaN, +-inf, +-0 and subnormals planted, the kernel against
  its plain version (pointwise.interpret) and the eager code on the card
  (bitwise under parity and exact, <= -100 dBFS under fast) and against
  the CPU's plain version; config5, config3 and the fuzz graphs at 4 x
  1 s under the three policies, the kernel route against the plain and
  the eager routes (output, aux, state); config5 at 128 and 512 x 10 s
  and config3 at 512 x 10 s under fast: the routes held, the launches
  (three a config5 render, config5's pre -> overdrive -> distort one of
  them), each group's kernel against its plain version with its bound
  and y.copy_ of the same bytes, the render on both routes in turns;
  config5 streamed on both routes (the replayed block's kernels from its
  DOT dump, process() median and p99); config5's input gradient through
  the groups' Function against the CPU port;
* gradient fitting (train/fit.py) of the bench chain's 16 sliders: one
  loss gradient at 2 streams x 1 s against the CPU port, then five Adam
  steps over 128 streams x 10 s with the first-order kernel's launch count
  (two solves forward, two backward per step) and no plain version
  called; and the graph input -> gain -> envelope -> output, whose
  gradient at 2 x 2 s is held against the CPU port and is taken once at
  128 x 10 s (one chunked envelope launch forward, the per-sample
  first-order kernel backward);
* config3 (4x-oversampled overdrive and Tanh distortion) over 512 streams
  x 10 s: no kernel launched (the converters are banded matrix
  products), stream 0 against the composed oracle with float64
  converters, render time, peak memory and a device-time split, one 4x
  converter beside F.conv1d of the same sums, parity at 4 x 1 s (no
  handoff: the converters keep no state, as in the JAX package);
* config4 (two 48,000-tap FIRs of the 1 s stereo IR, overlap-save through
  cuFFT) over 256 streams x 10 s: streams 0 and 255 over the whole 10 s
  against fir_reference (the warm-up cumsum, then scipy's fftconvolve in
  float64), a 2 x 5 s handoff, render time, peak memory and the device
  time in cuFFT, parity at 4 x 2 s (float64 cuFFT);
* muff over 128 streams x 10 s (one first-order launch a render, no plain
  version) and against the CPU port at 2 x 1 s; config2 (echo -> chorus)
  over 128 streams x 10 s (one chain launch, its mtap stage) against the
  composed oracle, and under parity at 4 x 1 s; mux and demux bitwise
  equal to the CPU port;
* the graph fuzz: _random_graph seeds with fir, mux, demux and the
  envelope and _random_mega_cycle_graph seeds whose cycle programs hold
  two cascades (tests/test_torch_fuzz_gen.py), 4 streams x 1 s each on
  the card against the CPU port, every chain segment and cycle program
  one launch of its kernel;
* the runtime: the signal generator's, soft clip's and the spectrogram's
  divides bitwise against the CPU port; each kernel at the stream's
  shapes, one row of one and of two 128-sample blocks, against its plain
  version; StreamSession over the bench chain (10 s), config5 (3 s) and
  muff (1 s) in 128-sample process() blocks, the block step one captured
  CUDA graph replayed a block: bitwise the eager one-block loop on the
  card, each kernel of the path launched at the capture and none from the
  host at a replay, a replay's kernels by torch.profiler, against the
  card's one render and the CPU port's session, with process_many in
  chunks bitwise equal to process(), per-block wall times, the capture's
  time, the real-time factor, each kernel's device time at [1, 128] in
  the replay and the device-busy share; a capture again on a change of
  the params' structure and of the policy, none on a moved value, and
  NODE_HOOK refused on the card; the bench chain's sliders as CUDA
  tensors edited every block under fast and parity (one capture, bitwise
  the eager loop); slider automation, one capture a stream and each move
  a copy into the buffers the graph reads (the bench chain's gain moved
  every 8 blocks and every block over 3 s, its overdrive's drive every
  block, config5's feedback gain every 64 blocks and every block, its
  envelope's attack every block, the exact bench chain's low-pass ratio
  every block), bitwise the eager loop taking the same values, no block
  after the first over the 2.667 ms a block lasts; the ring API
  (capture chunks, 44.1 kHz stereo reads, resync); the CLI render of
  examples/graphs/config5.json in a subprocess, bitwise the in-process
  render_file; a checkpoint resume; the pitch node; debug_render; and the
  port's three example scripts (dsp_stuff_tpu_torch/examples/) in
  subprocesses;
* the exact policy: the sequential kernel (csrc/sequential_kernel.cu;
  first order with a scalar and a per-sample coefficient, DF1 biquad;
  its build's ptxas report shows no spill) bitwise against its plain
  version at [512, 4096], at edge shapes, at its tile edges (a tile of
  SEQ_RUN samples +- 1, two tiles + 1, R = 33) and on rows not 16-byte
  aligned; the bench chain over 512 streams x 10 s under
  exact (three sequential launches, no chain kernel, no plain version;
  against bench.oracle_chain and the CPU port's exact render, each
  figure with whether it is bitwise; render time and peak memory); the
  bench chain streamed over 1 s in 128-sample blocks as the fast streams
  are, bitwise the eager loop and the card's exact render; config5 and
  the twelve exact-pool fuzz graphs
  (_random_graph(seed, exact=True)) at 4 streams x 1 s against the oracle
  and the CPU port; and the kernel's times at [512, 480,000] against its
  dependent-chain floor;
* gradients on the card: the bench chain's loss gradient with respect
  to its input and to the gain's level alone (the rest fused) through
  the chain kernel at 128 streams x 10 s, config5's input gradient
  through the chain and cycle kernels at 128 x 10 s (each forward one
  launch of its kernels, the bench chain's chain launch its record
  build, and no plain version; each backward one launch of the reverse
  chain kernel, config5's also one of the reverse cycle kernel, and no
  plain version; forward and backward times, the device time split,
  peak memory), each also against the CPU port at 2 x 1 s;
  every slider of config2 and config5 against the CPU port and one Adam
  step of config2 at 128 x 10 s; the sequential kernel's reverse mode
  against its plain version, its sample adjoints and initial-state
  gradients bitwise ([512, 4096], edge shapes, its tile edges, rows not
  16-byte aligned, and the exact gradient's [4, 48000], where both are
  timed) and against a float64
  adjoint at [512, 480,000], where it is timed against its chain floor;
  the bench chain's 16 slider gradients under exact at 4 x 1 s (three
  forward and three reverse sequential launches, no plain loop) and an
  exact one-pole with a per-sample coefficient, against the CPU port;
  render_sharded over one and two shards of the card bitwise the
  unsharded render at 512 x 10 s, and one make_sharded_train_step step
  against the unsharded step;
* the reverse cycle kernel (csrc/cycle_reverse_kernel.cu, built per
  block program) against interpret_adjoint on identical cotangents and
  recorded shaper inputs: config5's, mega_cycle_10's, a Fuzz and a
  HardClip loop at [1, 128], [1, 256] and 64 x 4096, config5's ring
  wrapped three times, a ring in device memory, the 56-instruction
  program, every fuzz graph's cycle program, and config5's at the main
  path's 128 x 10 s, where it is timed (the time of its path, "ms" in
  the kernels line as every kernel's, and its own device time by
  torch.profiler, "device_ms") against its plain version, its bound and
  its dependent-chain floor; the forward's record build
  bitwise its render build;
* the reverse chain kernel (csrc/chain_reverse_kernel.cu) against
  segment_adjoint on identical cotangents and recorded shaper inputs
  (the record build's outputs bitwise the render build's): the bench
  list, taps, two combs and the planner's config2 and config5 lists at
  [1, 128], [3, 8,320] and [8, 48,000]; the 40-stage list (more
  operands than slots, more cascades than shared memory keeps constants
  for) and a comb longer than a tile (its ring in device memory) at [3,
  8,320] and [8, 48,000], the 40 stages also with 1, 2 and 3 slots; at
  the bench list's [128, 480,000] against the eager vjp of
  segment_fallback (the parent's backward, fed that forward's records),
  ten launches bitwise equal, and timed: its path, its own device time,
  its plain version, the eager vjp, its bound, one cascade's transposed
  product as torch.matmul; its path and device time on the bench list at
  [512, 480,000], its first 128 rows there against segment_adjoint;
* the per-node cycle scan (compiler/cycle_loop.py): config5 over 128
  streams x 10 s under parity, exact and fast with its feedback gain
  overridden (the first-order kernel once a block; under exact the
  sequential kernel), the block loop captured in CUDA graphs of 8 blocks
  and replayed, bitwise the eager Python loop on the card (output, aux,
  state), stream 0 against the composed oracle, a second render of the
  same key with no capture, the loop's walls eager and replayed, its
  device time, the captures and replays, the nodes of a chunk's graph
  from its DOT dump with each kernel's launches inside the loop; under
  parity also graphs of 1 and 32 blocks;
* the per-node scan's backward (compiler/cycle_loop.py, _ScanGrad):
  config5 with every slider a leaf over 8 streams x 1 s under parity,
  exact and fast, its loop differentiated as replayed CUDA graphs
  (forward with a checkpoint every SEGMENT blocks; restore, record and
  reverse bodies), against the eager Python loop's autograd on the card
  (the loss and final states bitwise, each slider's gradient within rtol
  1e-5, the input's within 1e-5 max-normalized, each printed with
  whether it is bitwise; five captures, none on a second step) and
  against the CPU port at 2 x 48 blocks (rtol 1e-3); the reverse graph's
  kernels by mode from its DOT dump (the first-order kernel's reverse
  mode once a block under fast, the sequential kernel's under exact);
  three make_train_step steps of config5 under fast at 128 streams x
  10 s (loss, step wall, captures and replays a step, none captured
  after the first; the scan's forward and backward wall and device time;
  peak memory) beside one step of the Python loop under autograd, whose
  loss is bitwise and gradients within the same bounds; and the
  break-even by length, fast and parity at 4 streams x 16, 64 and 375
  blocks, a graph compiled a step, eager against replayed with its
  captures;

and times every kernel against its plain version (the chain kernel on
the bench list at 1, 128, 512 and 1024 streams and on config5's list at
128, each in turns with the plain version, which it must beat at 512 and
128; the first-order kernel scalar forward and per-sample reverse, beside
``y.copy_(b)`` at the same shape as the yardstick of one read and one
write), the whole config5 render at 128 and 512 streams, and the training
step.  Every phase raises on failure.  Needs a CUDA device; imports
nothing of JAX.

Output: progress lines, then one JSON line with the per-kernel record
(each kernel's bound: the larger of its bytes over 3.35 TB/s and its
operations over the peak of the units that do them, from this run's
shapes: 67 TFLOP/s for FP32 on the CUDA cores, 495 TFLOP/s for the chain
kernel's cascade products on the tensor cores, three TF32 products each
for 3xTF32; for the chain kernel also one cascade's product as one
torch.matmul), then the card's
identity as the last line.  Error figures are in dBFS:
20 log10(max |got - want| / max |want|).
"""

import contextlib
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SR = 48_000
B_MAIN = 512
T_MAIN = 10 * SR
B_CHECK, T_CHECK = 64, 4096
# the chain kernel's tile walk: three tiles of 64 blocks and a ragged one
B_TILES, T_TILES = 67, 3 * 64 * 128 + 5 * 128
B_TIMED = (1, 128, 512, 1024)     # the bench list's timed batch sizes
# H100 SXM peaks (data sheet, 700 W, dense): HBM, FP32 on the CUDA cores,
# TF32 on the tensor cores
HBM_TBPS, FP32_TFLOPS, TF32_TFLOPS = 3.35, 67.0, 495.0
Y_BOUND_DB = -100.0       # kernel vs plain, y and taps
STATE_ATOL = 1e-4         # kernel vs plain, rebuilt states
ORACLE_FAST_DB = -80.0    # main path (fast) vs the oracle
HANDOFF_DB = -100.0       # two chained renders vs one
PARITY_DB = -90.0         # parity policy vs the oracle (README bound)
N_TIMED = 5
N_TIMED_SLOW = 2          # plain versions that loop over time in Python
B_C5, B_C5_WIDE = 128, 512
T_CPU_PORT = 94 * 128     # the CPU port's side of a card-vs-CPU check
FO_F64_DB = -90.0         # first-order kernel vs the float64 solve
FO_VS_PLAIN_DB = 6.0      # ... and at most this much worse than plain f32
FO_GRAD_RTOL = 1e-4       # its Function's gradients vs the float64 one
FO_COEFFS = (0.2, 0.6, 0.9, 0.99)
FO_EDGE_COEFFS = (0.2, 0.6, 0.99)   # and 0 and 1, at the float64 bound only
FO_FORMS = ("forward", "reverse", "per-sample forward", "per-sample reverse")
N_DETERMINISM = 10        # first-order launches that must agree bit for bit
N_INNER = 20              # first-order solves timed back to back
FIT_GRAD_RTOL = 1e-3      # fitting gradients, card vs CPU port
FIT_GRAD_ATOL = 1e-6      # ... for a gradient that is about 0
B_FIT = 128               # the training steps' streams (x 10 s)
N_STEPS = 5
B_C3, B_C4, B_MUFF = 512, 256, 128   # config3, config4 and muff (x 10 s)
CARD_VS_CPU_DB = -100.0   # a render on the card vs the CPU port's
# the card's fuzz phase: _random_graph seeds holding fir (5, 15), mux (7,
# 15), demux (7, 13) and the envelope (13, 15); _random_mega_cycle_graph
# seeds whose cycle programs hold two cascades each (10, 67, 76)
FUZZ_GRAPH_SEEDS = (5, 7, 13, 15)
FUZZ_MEGA_SEEDS = (2, 10, 67, 76)
B_FUZZ = 4                # streams of a fuzz render (x 1 s)
# the runtime phase: StreamSession in 128-sample blocks, config5 over 1 s
# and the bench chain over 3 s (10 s and 3 s before the smoke neared its
# time limit)
STREAM_C5_SAMPLES = SR
STREAM_BENCH_SAMPLES = 3 * SR
STREAM_CHUNKS = (5, 375)  # process_many chunks, in blocks
STREAM_DB = -90.0         # streamed vs the card's one render (the JAX bound)
STREAM_CPU_DB = -100.0    # streamed on the card vs on the CPU, first second
PROFILE_TRIES = 5         # profiles of a replay taken for its times
PROFILE_LEAD_IN = 64      # spin kernels that open a profile (_profile_once)
AUTOMATION_EVERY = 8      # blocks between slider moves (bench chain, 1 s)
# config5's feedback gain (0.45 in the preset) moved every 64 blocks: a
# slider in the params runs node by node, so its cycle leaves the cycle
# kernel for the per-node block scan (compile._cycle_program)
AUTOMATION_C5_LEVELS = (0.40, 0.35, 0.30, 0.25)
AUTOMATION_C5_EVERY = 64
AUTOMATION_TRIALS = 2     # sessions of each automated stream (its timing)
AUTOMATION_STALL_S = 5    # seconds of host-only work beside them
AUTOMATION_BENCH_S = 3    # seconds of the bench chain's gain moved a block
AUTOMATION_C5_S = 1       # ... and of config5's feedback gain and attack
GRAPH_DIR = os.path.join(ROOT, "build", "stream_graphs")    # DOT dumps
LFO_FAST_ATOL = 4e-7      # config5's LFO under fast: CUDA's sinf vs the CPU's
PITCH_HZ_ATOL = 0.5       # a 440 Hz tone's detected pitch on the card
PITCH_RTOL = 1e-4         # ... and against the CPU port's
RUNTIME_DIR = os.path.join(ROOT, "build", "smoke_runtime")   # WAVs, files
# the exact phase: the policy's sequential solves on the card
EXACT_DB = -90.0          # exact on the card vs the oracle (the JAX bound)
SEQ_B, SEQ_T = 512, 4096  # the sequential kernel vs its plain version
SEQ_EDGE_SHAPES = ((1, 1), (8, 1), (1, 2), (8, 2), (1, 127), (8, 127),
                   (1, 128), (8, 128), (1, 129), (8, 129), (3, 1001))
# the kernel's tile edges (SQ_RUN samples a tile, 32 rows a CTA,
# csrc/sequential_kernel.cu): a tile +- 1, two tiles + 1, R = 33
SEQ_RUN = 64
SEQ_TILE_SHAPES = ((33, SEQ_RUN - 1), (33, SEQ_RUN), (33, SEQ_RUN + 1),
                   (33, 2 * SEQ_RUN + 1), (33, 4096))
SEQ_MODES = ("first_order", "first_order:per-sample", "biquad")
#: samples of the main shape's plain windows: the recurrence is causal,
#: so the kernel's output over a prefix is the plain loop's on the prefix,
#: and a late window started from the kernel's own state ends in its
#: final state (the plain loops over all 480,000 samples took 77 s)
SEQ_PLAIN_PREFIX = 48_000
SEQ_PLAIN_LATE = 24_000
SEQ_COEFFS = (-1.8, 0.81, 0.1, 0.2, 0.1)   # a resonant biquad
SEQ_A = 0.9173            # the first order's scalar coefficient
# dependent FP32 operations a step of each mode's chain (first order: the
# product and the sum; biquad: a1*y1 and two subtracts), 4 cycles each at
# the H100 SXM's maximum SM clock
SEQ_CHAIN_OPS = {"first_order": 2, "first_order:per-sample": 2, "biquad": 3}
SM_CLOCK_GHZ = 1.98
B_EXACT = 4               # config5 and the exact-pool fuzz (x 1 s)
GRAD_RTOL = 1e-3          # gradients, card vs CPU port (arrays max-normalized)
GRAD_ATOL = 1e-6          # ... a scalar gradient that is about 0
B_GRAD = 128              # the gradient phase's streams (the training step's)
SEQ_REV = {"first_order_reverse": "first_order",     # reverse mode -> forward
           "first_order_reverse_per_sample": "first_order:per-sample",
           "biquad_reverse": "biquad"}
SEQ_REV_DB = -120.0       # reverse mode vs its plain version, sample adjoints
SEQ_REV_F64_DB = -90.0    # ... vs the float64 adjoint at the main shape
SEQ_REV_RTOL = 1e-4       # coefficient gradients, both
B_SHARD, B_SHARD_STEP = 512, 128   # render_sharded (x 10 s), the step (x 1 s)
B_SHARD_MIX = 8           # the step over the card and the CPU (x 1 s)
STEP_RTOL, STEP_ATOL = 1e-5, 1e-6  # sharded step vs unsharded: loss, sliders
EXACT_FUZZ_SEEDS = (4, 9, 16, 25, 36, 49, 64, 81, 100, 121, 169, 196)
B_LOOP = 128              # config5's per-node cycle loop (x 10 s)
LOOP_KS = (1, 8, 32)      # bodies a captured loop graph holds, under parity
N_LOOP_TIMED = 200        # graph replays timed back to back
#: config5 renders of a few blocks up to 1,024 at B_SHORT (375: 1 s), each on
#: a graph compiled for it: the Python loop against the replayed loop, its
#: captures included
LOOP_LENGTHS = (4, 16, 64, 128, 375, 1024)
LENGTH_KS = (1, 8)        # the replayed loop's K in those renders
B_SHORT = 4
# the per-node loop's backward: config5 with every slider a leaf
B_LOOP_GRAD = 8           # streams (x 1 s) against the eager autograd loop
LOOP_GRAD_TOL = 1e-5      # replayed vs eager: arrays max-normalized, sliders
LOOP_GRAD_ATOL = 1e-7     # ... a slider's gradient near 0
LOOP_GRAD_CPU_BLOCKS = 48  # card vs the CPU port, 2 streams
N_LOOP_FIT_STEPS = 3      # make_train_step steps at B_LOOP x 10 s
LOOP_GRAD_LENGTHS = (16, 64, 375)   # blocks at B_SHORT, a graph a step


class PhaseClock:
    """The seconds of each phase of the run: ``lap(name)`` ends the phase
    that began at the last lap (or at the clock's start) and prints it."""

    def __init__(self):
        self.t = time.time()
        self.seconds: dict = {}

    def lap(self, name: str) -> None:
        now = time.time()
        self.seconds[name] = now - self.t
        self.t = now
        print(f"phase {name}: {self.seconds[name]:.1f} s")


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


def reverse_lists():
    """The reverse chain kernel's check lists (the CPU tests' STAGE_LISTS,
    tests/test_torch_grad_fused.py): the bench list, taps around a
    SoftClip, two combs around shapers, and the planner's lists around
    config2's and config5's chorus; name -> (stages, lfos)."""
    lists = {"bench": (bench_stages(), ()),
             "taps": ((("cascade", (("gain", 1.1), ("lp", 0.55))),
                       ("tap", 0), ("ew", "distort:SoftClip", (2.5,)),
                       ("cascade", (("bq", (-0.3, 0.05, 0.8, 0.1, 0.0)),)),
                       ("comb", 0.45, 192), ("tap", 1),
                       ("cascade", (("hp", 0.12),))), ()),
             "comb": ((("comb", 0.6, 300), ("scale", 0.8),
                       ("ew", "distort:SoftClip", (2.0,)),
                       ("comb", 0.3, 130), ("ew", "distort:Atan", (1.5,))),
                      ())}
    lists.update({f"mtap_{k.split()[1]}": v for k, v in mtap_lists().items()})
    return lists


def long_list():
    """40 stages (9 cascades, 9 shapers, 9 taps, 11 scales, 2 combs): past
    the fixed capacity the chain kernel once had (32 stages; 8 cascades,
    rings and taps).  The shapers are the nine bounded ones."""
    from dsp_stuff_tpu_torch.ops.chain_kernel import EW_CODES
    params = {"overdrive": (2.0, 0.5, 0.8), "chebyshev": (2.0, 3.0)}
    out = []
    for i, kind in enumerate(EW_CODES[:9]):
        secs = ((("lp", 0.2 + 0.07 * i),),
                (("hp", 0.1 + 0.03 * i), ("gain", 1.3)),
                (("bq", (-0.3, 0.05, 0.8, 0.1, 0.0)),))[i % 3]
        out += [("cascade", secs), ("ew", kind, params.get(kind, (1.5,))),
                ("scale", 0.95), ("tap", i)]
    return tuple(out) + (("comb", 0.3, 300), ("scale", 0.9),
                         ("comb", 0.25, 100), ("scale", 0.9))


def reverse_edge_lists():
    """The reverse chain kernel's lists past what reverse_lists() reach:
    the 40 stages (18 operands a tile, past the kernel's 4 operand slots;
    9 cascades, more than shared memory keeps constants for through the
    walk) and a comb longer than a tile (D = 64*128 + 476: its ring in
    device memory); name -> (stages, lfos)."""
    return {"40 stages": (long_list(), ()),
            "comb D=8,668": ((("cascade", (("lp", 0.4),)),
                              ("ew", "distort:SoftClip", (2.0,)),
                              ("comb", 0.5, 64 * 128 + 476),
                              ("scale", 0.9)), ())}


@contextlib.contextmanager
def capped_slots(n: int):
    """The reverse chain kernel launched with at most ``n`` operand slots
    (its layout's own, capped): an elementwise run with more operands than
    that takes barriers on its way, its slots refilled between stages."""
    from dsp_stuff_tpu_torch.ops import chain_reverse_kernel as crk
    real = crk.layout

    def fewer(stages, n_ops):
        out = real(stages, n_ops)
        return (min(out[0], n),) + out[1:]
    crk.layout = fewer
    try:
        yield
    finally:
        crk.layout = real


def oversized_cycle_program():
    """(program, n_taps): a block program of 9 feeds, 10 registers, 9
    taps, 9 cascades and 9 combs in 56 instructions with 36 join terms,
    past the fixed capacity the cycle kernel once had (32 instructions
    and terms; 8 feeds, registers, taps, cascades and combs).  Register
    i feeds back into stage i with the mix register 9."""
    from dsp_stuff_tpu_torch.ops.chain_kernel import EW_CODES
    prog = []
    for i, kind in enumerate(EW_CODES[:9]):
        prog += [("join", (("ext", i), ("reg", i), ("reg", 9)), 0.4),
                 ("cascade", (("lp", 0.2 + 0.07 * i),), i),
                 ("comb", 0.3, 128 + 37 * i, i),
                 ("ew", kind, {"overdrive": (2.0, 0.5, 0.8),
                               "chebyshev": (2.0, 3.0)}.get(kind, (1.5,))),
                 ("setreg", i), ("tap", i)]
    prog.append(("join", tuple(("reg", i) for i in range(9)), 0.1))
    prog.append(("setreg", 9))
    return tuple(prog), 9


def big_ring_cycle_program():
    """(program, n_taps): a loop whose second comb's ring (64,000 samples a
    row, 256 KB) cannot stay in shared memory, beside config5's comb of
    7,200 that can."""
    return (("join", (("ext", 0), ("reg", 0)), 0.5),
            ("comb", 0.5, 7200, 0),
            ("cascade", (("lp", 0.4),), 0),
            ("comb", 0.3, 64_000, 1),
            ("setreg", 0), ("tap", 0)), 1


def shaper_cycle_program(kind, params=None):
    """(program, n_taps): a loop through one shaper of ops/chain_kernel.
    EW_CODES: feed and register into a cascade, the shaper, a comb longer
    than a block, the register and a tap."""
    params = params or {"overdrive": (2.0, 0.5, 0.8),
                        "chebyshev": (2.0, 3.0),
                        "distort:Chebyshev4": (0.3,)}.get(kind, (1.5,))
    return (("join", (("ext", 0), ("reg", 0)), 0.5),
            ("cascade", (("lp", 0.3), ("gain", 1.2)), 0),
            ("ew", kind, params), ("comb", 0.4, 200, 0),
            ("setreg", 0), ("tap", 0)), 1


def cycle_reverse_cases():
    """(name, program, n_taps, B, T) of the reverse cycle kernel's checks
    against interpret_adjoint: config5's, mega_cycle_10's (a SoftClip, two
    cascades), a Fuzz and a HardClip loop at [1, 128], [1, 256] and
    [B_CHECK, T_CHECK]; config5's ring wrapped three times with a ragged
    end; a ring too large for shared memory; the 56-instruction program;
    every cycle program of the fuzz graphs."""
    import test_torch_fuzz_gen as gen
    from dsp_stuff_tpu_torch.models import presets
    from dsp_stuff_tpu_torch.ops import cycle_segment
    named = {"config5": cycle_program(presets.config5_feedback_16node()[0]),
             "mega_cycle_10": cycle_program(
                 gen._random_mega_cycle_graph(10)[0]),
             "Fuzz": shaper_cycle_program("distort:Fuzz"),
             "HardClip": shaper_cycle_program("distort:HardClip")}
    out = [(f"{name} [{b}, {t}]", *prog, b, t) for name, prog in named.items()
           for b, t in ((1, 128), (1, 256), (B_CHECK, T_CHECK))]
    out += [("config5 ring wraps", *named["config5"], B_CHECK,
             3 * 7424 + 5 * 128),
            ("ring in device memory", *big_ring_cycle_program(), 8,
             3 * 64_128 + 5 * 128),
            ("56 instructions", *oversized_cycle_program(), B_CHECK,
             T_CHECK)]
    for name, g, _ in fuzz_graphs():
        for i, prog in enumerate(cycle_programs_of(g)):
            out.append((f"fuzz {name} #{i}", prog,
                        cycle_segment._program_counts(prog)[3], B_FUZZ,
                        T_CHECK))
    return out


def cycle_cases(n_sm):
    """(name, program, n_taps, B, T) of the cycle kernel's checks: config5's
    program over a T that wraps its ring (7,200 samples, a spare block
    included 7,424) three times with a ragged end, at B_CHECK rows and
    past one row an SM; a ring too large for shared memory, wrapped three
    times; the loop graph's program and the 56-instruction one."""
    from dsp_stuff_tpu_torch.models import presets
    c5 = cycle_program(presets.config5_feedback_16node()[0])
    t_wrap = 3 * 7424 + 5 * 128
    big = big_ring_cycle_program()
    return [("config5 ring wraps", *c5, B_CHECK, t_wrap),
            ("config5 ring wraps", *c5, n_sm + 1, t_wrap),
            ("ring in device memory", *big, 8, 3 * 64_128 + 5 * 128),
            ("loop graph", *cycle_program(loop_graph()), B_CHECK, T_CHECK),
            ("56 instructions", *oversized_cycle_program(), B_CHECK,
             T_CHECK)]


def planned_stages(graph):
    """(stages, lfos) of the graph's one chain segment, as the planner
    builds it under the fast policy: lfos holds the chorus LFO (rate Hz,
    depth s, base s) of each mtap stage, in stage order."""
    import dsp_stuff_tpu_torch as dst
    cg = dst.compile_graph(graph, device="cpu")
    (run,) = cg._mega_plan
    with dst.policy("fast"):
        stages, specs = cg._mega_stages(run, None)[:2]
    return stages, tuple(sp[2:5] for sp in specs if sp[0] == "mtap")


def mtap_lists():
    """The planner's (stages, lfos) around a chorus: config2's reverb ->
    chorus -> gain and config5's high_pass -> chorus."""
    from dsp_stuff_tpu_torch.models import presets
    return {f"mtap {name}": planned_stages(build()[0])
            for name, build in (("config2", presets.config2_delay_chorus),
                                ("config5", presets.config5_feedback_16node))}


def seeded_states(stages, B, rng, device, T=None, t0=1280, lfos=()):
    """Random per-stream states for a stage list; an mtap stage also gets
    its shared trajectory operands, from its entry of ``lfos`` (see
    planned_stages), for a render of T samples from t0."""
    import torch
    from dsp_stuff_tpu_torch.ops import modfx
    from dsp_stuff_tpu_torch.ops.cascade import _embed_dim, composite_dim
    lfos = iter(lfos)
    out = []
    for st in stages:
        if st[0] == "cascade":
            n = _embed_dim(composite_dim(st[1]))
        elif st[0] in ("comb", "mtap"):
            n = st[2]
        else:
            continue
        out.append(torch.as_tensor(
            (rng.standard_normal((B, n)) * 0.1).astype(np.float32),
            device=device))
        if st[0] == "mtap":
            out.extend(modfx.mtap_shared(*next(lfos), st[2], T, t0,
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


def compare_cycle(name, k, p):
    """Cycle kernel outputs ``k`` (taps, regs, cinfos, hists) against
    interpret's ``p``; returns the largest absolute tap error."""
    tap_db = max(dbfs(host(a), host(b)) for a, b in zip(k[0], p[0]))
    st_err = 0.0
    for a, b in zip(k[1], p[1]):
        st_err = max(st_err, float(np.abs(host(a) - host(b)).max()))
    for ik, ip in zip(k[2], p[2]):
        for a, b in zip(ik, ip):
            st_err = max(st_err, float(np.abs(host(a) - host(b)).max()))
    for a, b in zip(k[3], p[3]):
        st_err = max(st_err, float(np.abs(host(a) - host(b)).max()))
    abs_err = max(float(np.abs(host(a) - host(b)).max())
                  for a, b in zip(k[0], p[0]))
    print(f"  {name:22s} taps {tap_db:8.1f} dBFS  regs+states max abs "
          f"{st_err:.2e}")
    check(all(len(a) == len(b) for a, b in zip(k, p)),
          f"{name}: output structure differs")
    check(tap_db <= Y_BOUND_DB, f"{name}: taps {tap_db:.1f} dBFS")
    check(st_err <= STATE_ATOL, f"{name}: states {st_err:.2e} > {STATE_ATOL}")
    return abs_err


def compare_env(name, k, p):
    """Envelope kernel (env, final) against the plain version's."""
    y_db = dbfs(host(k[0]), host(p[0]))
    st_err = float(np.abs(host(k[1]) - host(p[1])).max())
    abs_err = float(np.abs(host(k[0]) - host(p[0])).max())
    print(f"  {name:22s} y {y_db:8.1f} dBFS, max abs {abs_err:.2e}  final "
          f"max abs {st_err:.2e}")
    check(y_db <= Y_BOUND_DB, f"{name}: y {y_db:.1f} dBFS > {Y_BOUND_DB}")
    check(st_err <= STATE_ATOL, f"{name}: final {st_err:.2e}")
    return abs_err


def handoff(cg, x, name):
    """Two chained renders of the halves of ``x`` [B, 1, T] against one
    render of the whole, under the current policy."""
    import torch
    B, half = x.shape[0], x.shape[-1] // 2
    full, _, _ = cg.render(x, batch_shape=(B,))
    a, _, st = cg.render(x[..., :half].contiguous(), batch_shape=(B,))
    b, _, _ = cg.render(x[..., half:].contiguous(), state=st,
                        batch_shape=(B,))
    d = dbfs(host(torch.cat([a, b], dim=-1)), host(full))
    print(f"{name} state handoff, B={B}: 2 x {half / SR:g} s vs "
          f"{2 * half / SR:g} s: {d:.1f} dBFS")
    check(d <= HANDOFF_DB, f"{name} state handoff {d:.1f} dBFS")


def parity(graph, xp, oracle, name, route="auto"):
    """Render ``xp`` [B, 1, T] (NumPy) under the parity policy on the card
    (its feedback cycles' per-node scans on ``route``) and hold each
    stream against ``oracle`` (each output, where it returns a list of
    them); returns the kernel launches of that render."""
    import torch
    import dsp_stuff_tpu_torch as dst
    with dst.policy("parity"):
        cgp = dst.compile_graph(graph, device="cuda")
        cgp.cycle_loops.route = route
        reset_launches()
        yp, _, _ = cgp.render(xp, batch_shape=(len(xp),))
        torch.cuda.synchronize()
        launches = read_launches()
    worst = -np.inf
    for i in range(len(xp)):
        wants = oracle(xp[i, 0])        # one output, or a list of them
        for j, want in enumerate(wants if isinstance(wants, list)
                                 else [wants]):
            worst = max(worst, dbfs(host(yp[i, j]), want))
    print(f"{name} parity, B={len(xp)} x {xp.shape[-1] / SR:g} s vs "
          f"{oracle.__name__}: {worst:.1f} dBFS, launches {launches}")
    check(worst <= PARITY_DB, f"{name} parity {worst:.1f} dBFS > "
                              f"{PARITY_DB}")
    return launches


def loop_graph():
    """input -> add -> distort -> reverb -> low_pass -> gain -> add (the
    back edge), the reverb also to the output."""
    import dsp_stuff_tpu_torch as dst
    from dsp_stuff_tpu_torch.ids import IdSpace
    g = dst.Graph(IdSpace())
    inp = g.add("input")
    mixa = g.add("add")
    ds = g.add("distort", mode="SoftClip", level=2.0)
    rv = g.add("reverb", seconds=0.004, decay=0.5)
    lp = g.add("low_pass", ratio=0.4)
    fbg = g.add("gain", level=0.45)
    out = g.add("output")
    g.connect(inp, "out", mixa, "a")
    g.chain(mixa, ds, rv, lp, fbg)
    g.connect(fbg, "out", mixa, "b")
    g.connect(rv, "out", out, "in")
    return g


def cycle_program(graph):
    """(program, n_taps) the planner lowers the graph's one SCC to."""
    import dsp_stuff_tpu_torch as dst
    cg = dst.compile_graph(graph, device="cpu")
    comp = next(c for c in cg._sccs if len(c) > 1)
    with dst.policy("fast"):
        program, _, _, taps, _ = cg._cycle_program(comp, None)
    return program, len(taps)


def cycle_inputs(program, B, T, rng, device):
    import torch
    from dsp_stuff_tpu_torch.ops import cycle_segment
    from dsp_stuff_tpu_torch.ops.cascade import _embed_dim, composite_dim
    _, _, n_r, _, n_e = cycle_segment._program_counts(program)

    def t(*shape, scale):
        return torch.as_tensor((rng.standard_normal(shape) * scale)
                               .astype(np.float32), device=device)

    exts = tuple(t(B, T, scale=0.3) for _ in range(n_e))
    regs = tuple(t(B, 128, scale=0.1) for _ in range(n_r))
    states = []
    for ins in program:
        if ins[0] == "cascade":
            states.append(t(B, _embed_dim(composite_dim(ins[1])), scale=0.1))
        elif ins[0] == "comb":
            states.append(t(B, ins[2], scale=0.1))
    return exts, regs, tuple(states)


def cycle_kernel_run(exts, regs, states, program, n_taps):
    from dsp_stuff_tpu_torch.ops import cycle_kernel, cycle_segment
    taps, regs_f, casc_raw, ring_raw = cycle_kernel.cycle_kernel_call(
        exts, regs, states, program, n_taps)
    cinfos, hists = cycle_segment.rebuild(program, exts[0].shape[-1],
                                          casc_raw, ring_raw)
    return taps, regs_f, cinfos, hists


def oracle_config5(x):
    """The composed NumPy oracle of config5 (tests/oracle per-node
    semantics; the feedback SCC per 128-block with the back edge reading
    the previous block), as tests/test_presets.py composes it."""
    import oracle
    F32 = np.float32
    h = oracle.fanin_average
    T = len(x)
    pre = (h([x]) * F32(1.2)).astype(F32)
    lfo, _ = oracle.signal_gen("Sine", 0.6, 0.5, T)
    drive = oracle.mod_map(h([lfo]), 0.0, 1.0)
    od = oracle.overdrive(h([pre]), 6.0, drive, 0.8)
    dist = oracle.soft_clip(h([od]), 4.0)
    ring = np.zeros(int(F32(0.15) * F32(48000.0)), F32)
    z_lp = F32(0.0)
    prev_fbg = np.zeros(128, F32)
    rv_seq = np.empty(T, F32)
    for b in range(0, T, 128):
        mixa = (h([dist[b:b + 128]]) + h([prev_fbg])).astype(F32)
        rv, ring = oracle.reverb(h([mixa]), 0.15, 0.5, ring)
        lp, z_lp = oracle.low_pass(h([rv]), 0.4, z_lp)
        prev_fbg = (h([lp]) * F32(0.45)).astype(F32)
        rv_seq[b:b + 128] = rv
    hp, _ = oracle.high_pass(h([rv_seq]), 0.05)
    ch, _, _ = oracle.chorus(h([hp]), 1.2, 0.003, 0.008, 0.4)
    a, bb, r = h([pre]), h([ch]), F32(0.6)
    mx = ((bb * r).astype(F32) + (a * F32(F32(1.0) - r)).astype(F32)
          ).astype(F32)
    env, _ = oracle.envelope(h([mx]), 50.0, 400.0)
    bq, _ = oracle.biquad_df1(h([env]), 1.0, -0.2, 0.0, 0.8, 0.0, 0.0)
    return h([bq])


def oracle_config2(x):
    """The composed NumPy oracle of config2, echo -> chorus -> gain, as
    tests/test_torch_presets.py composes it (a chorus is not held against
    tests/oracle/graph.py, whose history comes out one sample long)."""
    import oracle
    F32 = np.float32
    h = oracle.fanin_average
    v, _ = oracle.reverb(h([x]), 0.25, 0.45, None)
    v, _, _ = oracle.chorus(h([v]), 0.8, 0.004, 0.012, 0.5)
    return h([(h([v]) * F32(0.9)).astype(F32)])


def fir_reference(x, taps_rev):
    """The FIR node's output (Balanced, a fresh filter) in float64, for IRs
    too long for oracle.fir's per-sample double loop: the reference's
    warm-up, cumsum(x[:N-1] * taps_rev[:N-1]) for g < N-1
    (fir.rs:179-225), then the causal convolution with the un-reversed IR
    (scipy's fftconvolve)."""
    from scipy.signal import fftconvolve
    x = np.asarray(x, np.float64)
    taps = np.asarray(taps_rev, np.float64)
    k = min(len(taps) - 1, len(x))
    y = fftconvolve(x, taps[::-1])[:len(x)]
    y[:k] = np.cumsum(x[:k] * taps[:k])
    return y


def _kernel_modules():
    from dsp_stuff_tpu_torch.ops import (chain_kernel, chain_reverse_kernel,
                                         cycle_kernel, cycle_reverse_kernel,
                                         envelope_kernel, first_order_kernel,
                                         oscillator_kernel,
                                         oscillator_reverse_kernel,
                                         pointwise_kernel,
                                         pointwise_reverse_kernel,
                                         sequential_kernel)
    return {"chain": chain_kernel, "chain_reverse": chain_reverse_kernel,
            "cycle": cycle_kernel, "cycle_reverse": cycle_reverse_kernel,
            "envelope": envelope_kernel, "first_order": first_order_kernel,
            "oscillator": oscillator_kernel,
            "oscillator_reverse": oscillator_reverse_kernel,
            "pointwise": pointwise_kernel,
            "pointwise_reverse": pointwise_reverse_kernel,
            "sequential": sequential_kernel}


def reset_launches():
    """Every kernel's launch count to 0 (the chain kernel's record build's
    too, chain_kernel.RECORD_LAUNCHES, and the reverse pointwise kernel's
    second pass, SUM_LAUNCHES)."""
    for m in _kernel_modules().values():
        m.LAUNCHES = 0
    _kernel_modules()["chain"].RECORD_LAUNCHES = 0
    _kernel_modules()["pointwise_reverse"].SUM_LAUNCHES = 0


def read_launches():
    return {k: m.LAUNCHES for k, m in _kernel_modules().items()}


def only_launches(**launches):
    """The launch counts of a run that launched only ``launches``."""
    out = {k: 0 for k in _kernel_modules()}
    out.update(launches)
    return out


def osc_launches(graph, T: int) -> int:
    """The oscillator kernel's launches in one render of ``graph`` over T
    samples: each active signal generator's (two, or one for a render of
    one block and for Constant: oscillator_kernel.launches_for)."""
    from dsp_stuff_tpu_torch.compiler import compile as comp
    from dsp_stuff_tpu_torch.ops import oscillator_kernel
    active = comp._active_nodes(graph)
    return sum(oscillator_kernel.launches_for(n.params["mode"], T)
               for nid, n in graph.nodes.items()
               if n.cfg_name == "signal_gen" and nid in active)


@contextlib.contextmanager
def forward_and_vjps_counted(plain: dict, vjps: dict, first_order=True):
    """plain_versions_counted for a forward and backward together, the
    pointwise groups' plain version apart: ``vjps`` holds its runs (a
    caller holds them to 0: the groups' forward is the kernel, their
    backward the reverse kernel, ops/pointwise_kernel.PointwiseGroup),
    and the oscillator's (its forward the oscillator kernel, its backward
    the reverse oscillator kernel, ops/gen.Oscillator)."""
    from dsp_stuff_tpu_torch.compiler import pointwise
    from dsp_stuff_tpu_torch.ops import gen
    with plain_versions_counted(plain, first_order=first_order,
                                groups=False), \
            calls_counted([(pointwise, "interpret"),
                           (gen, "oscillator_plain")], vjps):
        yield


def cpu_group_calls(graph, pol="fast", params=None, T=256) -> int:
    """The pointwise groups one render of ``graph`` runs under ``pol``,
    counted on the CPU port's render at [1, T] (the planner's groups and
    the shapers oversampled at R > 1; the plan depends on the graph's
    structure, the policy and which sliders ``params(cg)`` overrides, not
    on the shapes): on the card each is one pointwise kernel launch."""
    import torch
    import dsp_stuff_tpu_torch as dst
    from dsp_stuff_tpu_torch.compiler import compile as comp
    from dsp_stuff_tpu_torch.ops import pointwise_kernel as pk
    counts: dict = {}
    cg = dst.compile_graph(graph, device="cpu")
    n_in = len(cg.input_ids)
    x = torch.zeros((1, n_in, T)) if n_in else None
    with dst.policy(pol), calls_counted([(comp, "group_call"),
                                         (pk, "group_call")], counts):
        cg.render(x, T=T, batch_shape=(1,),
                  params=params(cg) if params else None)
    return counts.get("group_call", 0)


def group_launches(graph, pol, T, params=None) -> int:
    """The pointwise groups a render of T samples under ``pol`` runs when
    its feedback cycles' per-node scans run the Python loop (the host
    counts each block's): a one-block render's (cpu_group_calls), and the
    cycles' groups once more for every further block (the calls a second
    block adds)."""
    one = cpu_group_calls(graph, pol, params, T=128)
    two = cpu_group_calls(graph, pol, params, T=256)
    return one + (two - one) * (T // 128 - 1)


@contextlib.contextmanager
def cycle_groups_off(cg):
    """``cg``'s per-node cycle scans without pointwise groups inside the
    block (each member's eager ops: the route before the cycle's groups),
    the render's own groups kept.  A scan's loop over buffers is keyed on
    its groups, so each way captures its own."""
    cg._cycle_groups = lambda order, heads, interior: ()
    try:
        yield
    finally:
        del cg._cycle_groups


def fanins_off():
    """The renders inside without the fan-ins the pointwise groups take
    outside them (compile.FANIN_GROUPS off: each its eager ops, the route
    before them), the groups kept."""
    from dsp_stuff_tpu_torch.compiler import compile as comp
    return swapped_attr(comp, "FANIN_GROUPS", False)


@contextlib.contextmanager
def groups_through_function(backward):
    """Route every pointwise group of a CPU render through the groups'
    Function (ops/pointwise_kernel.run: the plain version forward,
    ``backward`` as its backward), as the card routes them."""
    from dsp_stuff_tpu_torch.compiler import compile as comp
    from dsp_stuff_tpu_torch.compiler import pointwise as pw
    from dsp_stuff_tpu_torch.ops import pointwise_kernel as pk

    def call(prog, sigs, scals, T, device):
        return pk.run(pw.interpret, prog, sigs, scals, T, device, backward)
    with swapped_attr(comp, "group_call", call), \
            swapped_attr(pk, "group_call", call):
        yield


def cpu_group_backwards(graph, pol="fast", params=None, wrt_input=False,
                        T=256, B=2, route="auto") -> list:
    """The generated reverse source of each pointwise group backward that
    launches the reverse kernel in one loss gradient of ``graph`` under
    ``pol`` (the sliders of ``params(cg)``, leaves that require grad, and
    the input where ``wrt_input``), from the CPU port's at [B, T] with its
    groups routed as the card routes them: one entry a launch on the card
    (the adjoint programs depend on the structure, the policy, what needs
    a gradient and which operands span the batch, not on B > 1 or T).
    ``route`` is the feedback cycles' scan route ("buffers": the replayed
    loop's reverse body, its block's inputs leaves)."""
    import torch
    import dsp_stuff_tpu_torch as dst
    from dsp_stuff_tpu_torch.ops import pointwise_kernel as pk
    from dsp_stuff_tpu_torch.ops import pointwise_reverse_kernel as prk
    got = []

    def rec(prog, sigs, scals, cts, need, Tn, device):
        pl = pk.plan_adjoint(prog, sigs, scals, cts, need, Tn)
        if prk.worlds(pl.adj).outs:
            got.append(prk.reverse_source(pl.adj))
        return pk.group_adjoint(prog, sigs, scals, cts, need, Tn, device)
    cg = dst.compile_graph(graph, device="cpu")
    cg.cycle_loops.route = route
    n_in = len(cg.input_ids)
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (B, n_in, T)).astype(np.float32) * 0.3) if n_in else None
    if x is not None:
        x.requires_grad_(wrt_input)
    with dst.policy(pol), groups_through_function(rec):
        y = cg.render(x, T=T, batch_shape=(B,),
                      params=params(cg) if params else None)[0]
        if y.requires_grad:
            (y * torch.linspace(-1.0, 1.0, T)).sum().backward()
    return got


@contextlib.contextmanager
def calls_counted(targets, counts: dict):
    """Count the calls of each (module, function name) of ``targets`` into
    ``counts`` while the block runs."""
    saved = [(m, n, getattr(m, n)) for m, n in targets]

    def counting(name, fn):
        def wrapped(*a, **k):
            counts[name] = counts.get(name, 0) + 1
            return fn(*a, **k)
        return wrapped

    for m, n, fn in saved:
        setattr(m, n, counting(n, fn))
    try:
        yield counts
    finally:
        for m, n, fn in saved:
            setattr(m, n, fn)


def plain_versions_counted(counts: dict, first_order: bool = False,
                           groups: bool = True):
    """Count calls of the kernels' plain versions while the block runs
    (the main path on the card must call none of them): always the chain
    kernels' (segment_fallback, its record form included, segment_adjoint
    and segment_vjp, the parent's eager backward), the sequential kernel's
    (the exact policy's loops, forward and reverse) and the cycle kernels'
    (interpret, its record form included, and interpret_adjoint);
    ``first_order`` adds the first-order kernel's (a render calls
    _first_order_blocked for a concrete degenerate biquad, which takes no
    kernel in either package); ``groups`` the pointwise groups' forward
    (pointwise.interpret) and the oscillator's (gen.oscillator_plain),
    which a backward counts apart; the reverse
    pointwise kernel's (group_adjoint, interpret_adjoint) and the route it
    replaced (group_vjp) always."""
    from dsp_stuff_tpu_torch.compiler import pointwise
    from dsp_stuff_tpu_torch.ops import (chain_segment, cycle_segment,
                                         envelope, gen, scan)
    from dsp_stuff_tpu_torch.ops import pointwise_kernel as pk
    targets = [(chain_segment, "segment_fallback"),
               (chain_segment, "segment_adjoint"),
               (chain_segment, "segment_vjp"),
               (cycle_segment, "interpret"),
               (cycle_segment, "interpret_adjoint"),
               (envelope, "_chunked_batched"),
               (envelope, "_seq_scan"), (scan, "_first_order_sequential"),
               (scan, "_biquad_sequential"),
               (scan, "_first_order_adjoint_sequential"),
               (scan, "_biquad_adjoint_sequential"),
               (pk, "group_vjp"), (pk, "group_adjoint"),
               (pointwise, "interpret_adjoint")]
    if first_order:
        targets += [(scan, "_first_order_blocked"),
                    (scan, "_first_order_scan")]
    if groups:
        targets += [(pointwise, "interpret"), (gen, "oscillator_plain")]
    return calls_counted(targets, counts)


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


def cuda_ms(fn, n=N_TIMED, inner=1):
    """Median of n CUDA-event timings of fn(), after one warm-up call; each
    timing spans ``inner`` calls back to back and is divided by it (so the
    host enqueues ahead of the card and its time per call drops out)."""
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


def kernel_device_ms(fn, name: str, n: int = 10):
    """(device ms a launch, launches seen) of the kernels whose name holds
    ``name`` over n calls of fn, from torch.profiler after a warm-up (the
    trace loses the first device records of a profile: PROFILE_LEAD_IN
    spin kernels take that loss ahead of the calls).  Up to PROFILE_TRIES
    profiles are taken and the first that shows all n launches is kept;
    (None, the launches the last one showed) when none does: not
    measured."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    count = 0
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILE_LEAD_IN):
                torch.cuda._sleep(1000)
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and name in e.key]
        count = sum(e.count for e in evs)
        if count == n:
            return sum(e.self_device_time_total for e in evs) / n / 1e3, n
    return None, count


def in_turns(fk, fp, n_plain=N_TIMED):
    """(kernel ms, plain ms): each timed twice, in turns kernel, plain,
    plain, kernel, the medians of both rounds."""
    k = [cuda_ms(fk)]
    p = [cuda_ms(fp, n_plain), cuda_ms(fp, n_plain)]
    k.append(cuda_ms(fk))
    return float(np.median(k)), float(np.median(p))


def bound(n_bytes, flops, tc_flops=0.0):
    """(bound ms, what sets it): the least time for moving ``n_bytes``
    over HBM and doing ``flops`` FP32 operations on the CUDA cores and
    ``tc_flops`` TF32 operations on the tensor cores, at the card's peaks
    (the two kinds added: the same warp schedulers dispatch both)."""
    ms_b = n_bytes / (HBM_TBPS * 1e12) * 1e3
    ms_f = (flops / FP32_TFLOPS + tc_flops / TF32_TFLOPS) / 1e12 * 1e3
    return (ms_b, "bytes") if ms_b >= ms_f else (ms_f, "operations")


def casc_flops(sections, blocks):
    """(product, scan) operations of one cascade over ``blocks``
    128-sample blocks: the triangular Toeplitz product (128 * 129 / 2
    multiply-adds a block) with the N-lane carry's products X W and C Ecb,
    and the carry's step C ACt."""
    from dsp_stuff_tpu_torch.ops.cascade import _embed_dim, composite_dim
    N = _embed_dim(composite_dim(sections))
    return (2.0 * blocks * (128 * 129 / 2 + 2 * 128 * N),
            2.0 * blocks * N * N)


def chain_bound(stages, B, T, reverse=False):
    """The chain kernel's bound at [B, T]: bytes of x, y and the taps, the
    states in and out; operations of the cascades (the products on the
    tensor cores, three TF32 products each in 3xTF32; the carry's step on
    the CUDA cores), one a sample a scale or shaper, two a comb sample,
    seven an mtap sample.  ``reverse``: the reverse kernel's, which reads
    y's and the taps' cotangents and the shapers' records and writes x's
    gradient, the states' gradients beside them, and does as many
    operations (the adjoint of each stage: the transposed products, a
    shaper's derivative counted as one)."""
    n_taps = sum(1 for st in stages if st[0] == "tap")
    n_ew = sum(1 for st in stages if st[0] == "ew") if reverse else 0
    n_bytes = 4.0 * B * T * (2 + n_taps + n_ew)
    flops = tc_flops = 0.0
    for st in stages:
        if st[0] == "cascade":
            prod, scan = casc_flops(st[1], B * T // 128)
            tc_flops += 3.0 * prod
            flops += scan
            n_bytes += 4.0 * B * (2 * 8 + 128)
        elif st[0] in ("scale", "ew"):
            flops += B * T
        elif st[0] == "comb":
            flops += 2.0 * B * T
            n_bytes += 4.0 * B * (st[2] + -(-st[2] // 128) * 128)
        elif st[0] == "mtap":
            flops += 7.0 * B * T
            n_bytes += 4.0 * (B * (st[2] + (st[3] + 1) * 128) + 2 * T)
    return bound(n_bytes, flops, tc_flops)


def cycle_bound(program, B, T):
    """The cycle kernel's bound: bytes of the feeds and taps; FP32
    operations (the CUDA cores do them all) of the cascades, the join
    terms, two a comb sample, one a shaper or scale sample."""
    from dsp_stuff_tpu_torch.ops import cycle_segment
    _, _, _, n_t, n_e = cycle_segment._program_counts(program)
    return bound(4.0 * B * T * (n_e + n_t), cycle_flops(program, B, T))


def cycle_reverse_bound(program, B, T):
    """The reverse cycle kernel's bound: bytes of the taps' cotangents and
    the shapers' recorded inputs read and the feeds' gradients written;
    the forward's operations (the adjoint of each instruction does as
    many: the transposed products, the terms' accumulations, the comb's
    multiply and add, a shaper's derivative counted as one)."""
    from dsp_stuff_tpu_torch.ops import cycle_segment
    _, _, _, n_t, n_e = cycle_segment._program_counts(program)
    n_ew = sum(1 for ins in program if ins[0] == "ew")
    return bound(4.0 * B * T * (n_t + n_ew + n_e),
                 cycle_flops(program, B, T))


def reverse_block_path_ops(program) -> int:
    """FP32 operations on a block's dependent path through the reverse
    kernel, its instructions taken in series, in the terms of the
    forward's (tools/measure_torch_cycle.block_path_ops): a setreg's or a
    tap's add, a scale's multiply, a join's scale and its accumulation
    into a register, lin2's two multiplies and accumulation, a comb's add,
    a cascade's longest column (32 FMAs into each of four sums, two adds,
    the carry term's add), one a shaper."""
    ops = 0
    for ins in program:
        if ins[0] in ("setreg", "tap", "scale", "comb", "ew"):
            ops += 1
        elif ins[0] == "join":
            ops += 1 + (ins[2] != 1.0)
        elif ins[0] == "lin2":
            ops += 3
        elif ins[0] == "cascade":
            ops += 128 // 4 + 2 + 1
    return ops


def cycle_reverse_floor_ms(program, T) -> float:
    """The reverse kernel's dependent-chain floor over T / 128 blocks: 4
    cycles an operation of reverse_block_path_ops at SM_CLOCK_GHZ."""
    return T // 128 * reverse_block_path_ops(program) * 4 / (
        SM_CLOCK_GHZ * 1e6)


def cycle_flops(program, B, T) -> float:
    """FP32 operations of a block program over [B, T] (cycle_bound)."""
    flops = 0.0
    for ins in program:
        if ins[0] == "cascade":
            flops += sum(casc_flops(ins[1], B * T // 128))
        elif ins[0] == "join":
            flops += B * T * len(ins[1])
        elif ins[0] == "lin2":
            flops += B * T * (len(ins[1]) + len(ins[3]) + 3)
        elif ins[0] == "comb":
            flops += 2.0 * B * T
        elif ins[0] in ("ew", "scale"):
            flops += B * T
    return flops


def matmul_ms(sections, B, T, dev):
    """One torch.matmul of a cascade stage's product, [B*K, 128] x [128,
    136] ([Ltg | W]) in float32: the library yardstick of one stage."""
    import torch
    from dsp_stuff_tpu_torch.ops import chain_kernel
    Ltg, Wp, _, _, _ = chain_kernel._casc_consts(sections)
    L = torch.as_tensor(np.concatenate([Ltg, Wp], axis=1), device=dev)
    X = torch.randn((B * T // 128, 128), device=dev)
    return cuda_ms(lambda: torch.matmul(X, L))


def matmul_t_ms(sections, B, T, dev):
    """One torch.matmul of a cascade stage's transposed product, [B*K, 128]
    x [128, 136] ([Ltg^T | Ecb^T]) in float32: the library yardstick of
    one reverse stage."""
    import torch
    from dsp_stuff_tpu_torch.ops import chain_kernel
    Ltg, _, Ecb, _, _ = chain_kernel._casc_consts(sections)
    L = torch.as_tensor(np.concatenate([Ltg.T, Ecb.T], axis=1), device=dev)
    X = torch.randn((B * T // 128, 128), device=dev)
    return cuda_ms(lambda: torch.matmul(X, L))


def dbfs_dev(got, want) -> float:
    """dbfs of two tensors on the card, in float64 (no host copy)."""
    err = float((got.double() - want.double()).abs().max())
    ref = float(want.double().abs().max())
    return 20.0 * np.log10(max(err, 1e-30) / max(ref, 1e-30))


def fo_inputs(a_val, B, T, seed, dev, per_sample):
    """(a, b, y0) of a first-order check from a seeded card generator:
    b = 0.3 N(0, 1), y0 = N(0, 1) (not 0); a the scalar a_val as a 0-d
    card tensor, or per sample a_val * U(0.9, 1)."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)
    b = torch.randn((B, T), generator=gen, device=dev) * 0.3
    y0 = torch.randn((B,), generator=gen, device=dev)
    if per_sample:
        a = a_val * (0.9 + 0.1 * torch.rand((B, T), generator=gen,
                                            device=dev))
    else:
        a = torch.full((), a_val, device=dev)
    return a, b, y0


def fo_plain(a, b, y0, reverse, dtype):
    """The first-order kernel's plain version in ``dtype`` (float64: the
    reference solve); ``reverse`` on the time-flipped arrays."""
    from dsp_stuff_tpu_torch.ops import scan
    return scan.first_order_plain(a.to(dtype), b.to(dtype), y0.to(dtype),
                                  reverse)


def fo_edge_shapes():
    """(R, T) of the first-order kernel's edge checks: T = 1, a tile and
    one sample either side, T = 100,003 (rows not 16-byte aligned), one
    long row, many short rows (R = 1,024, and 70,000: more than the
    65,535 blocks a grid's y dimension takes)."""
    from dsp_stuff_tpu_torch.ops import first_order_kernel
    tile = first_order_kernel._lib().first_order_kernel_tile()
    return ((3, 1), (3, tile - 1), (3, tile), (3, tile + 1), (5, 100_003),
            (1, T_MAIN), (1024, 4097), (70_000, 64))


def fo_check(a_val, form, B, T, seed, dev, vs_plain=True, show=True):
    """The first-order kernel and its plain f32 version, each against the
    float64 solve; returns (the largest absolute kernel - plain error, the
    kernel's and the plain version's dBFS against float64).  ``vs_plain``
    also bounds the kernel against the plain version's error."""
    import torch
    from dsp_stuff_tpu_torch.ops import first_order_kernel
    per_sample, reverse = "per-sample" in form, "reverse" in form
    a, b, y0 = fo_inputs(a_val, B, T, seed, dev, per_sample)
    k = first_order_kernel.first_order_cuda(a, b, y0, reverse)
    p = fo_plain(a, b, y0, reverse, torch.float32)
    ref = fo_plain(a, b, y0, reverse, torch.float64)
    torch.cuda.synchronize()
    dk, dp = dbfs_dev(k, ref), dbfs_dev(p, ref)
    abs_err = float((k - p).abs().max())
    if show:
        print(f"  a={a_val:<5} {form:19s} vs f64: kernel {dk:7.1f} dBFS, "
              f"plain f32 {dp:7.1f} dBFS; kernel - plain max abs "
              f"{abs_err:.2e}")
    check(bool(torch.isfinite(k).all()), f"first-order {form} a={a_val}: "
                                         f"kernel output not finite")
    check(dk <= FO_F64_DB, f"first-order {form} a={a_val}: kernel {dk:.1f} "
                           f"dBFS vs f64 > {FO_F64_DB}")
    check(not vs_plain or dk <= dp + FO_VS_PLAIN_DB,
          f"first-order {form} a={a_val}: kernel {dk:.1f} dBFS is more than "
          f"{FO_VS_PLAIN_DB} dB worse than plain f32 ({dp:.1f})")
    return abs_err, dk, dp


def fo_edges(dev) -> None:
    """fo_check at every edge shape and form, a in FO_EDGE_COEFFS at both
    bounds and a = 0 and 1 at the float64 one; one line a shape and
    form."""
    seed = 400
    for B, T in fo_edge_shapes():
        for form in FO_FORMS:
            worst_db, worst_gap = -np.inf, -np.inf
            for a in FO_EDGE_COEFFS + (0.0, 1.0):
                seed += 1
                _, dk, dp = fo_check(a, form, B, T, seed, dev,
                                     vs_plain=a not in (0.0, 1.0), show=False)
                worst_db = max(worst_db, dk)
                if a not in (0.0, 1.0):
                    worst_gap = max(worst_gap, dk - dp)
            print(f"  [{B}, {T}] {form:19s}: kernel vs f64 worst "
                  f"{worst_db:7.1f} dBFS (a in 0..1), at most "
                  f"{worst_gap:+.1f} dB from plain f32")


def fo_determinism(dev, n=N_DETERMINISM) -> None:
    """n launches of the scalar forward and the per-sample reverse solve at
    the fitting path's shape, each bitwise equal to the first."""
    import torch
    from dsp_stuff_tpu_torch.ops import first_order_kernel
    for form, per_sample, reverse in (("scalar forward", False, False),
                                      ("per-sample reverse", True, True)):
        a, b, y0 = fo_inputs(0.99, B_FIT, T_MAIN, 500, dev, per_sample)
        first = first_order_kernel.first_order_cuda(a, b, y0, reverse)
        same = sum(bool(torch.equal(
            first_order_kernel.first_order_cuda(a, b, y0, reverse), first))
            for _ in range(n - 1))
        print(f"  {form}, [{B_FIT}, {T_MAIN}]: {same + 1} of {n} launches "
              f"bitwise equal")
        check(same == n - 1, f"first-order {form}: only {same + 1} of {n} "
                             f"launches bitwise equal")


def fo_function_check(a_val, B, T, seed, dev):
    """FirstOrderAffine's gradients (abar, bbar, y0bar) under ``fast`` on
    the card (the kernel forward and reverse) against the float64 plain
    Function under ``parity``; returns the worst relative error."""
    import torch
    import dsp_stuff_tpu_torch as dst
    from dsp_stuff_tpu_torch.ops import scan
    a, b, y0 = fo_inputs(a_val, B, T, seed, dev, False)
    ybar = torch.randn((B, T), generator=torch.Generator(
        device=dev).manual_seed(seed + 1), device=dev)
    grads = {}
    for pol, dtype in (("fast", torch.float32), ("parity", torch.float64)):
        ins = [v.detach().to(dtype).requires_grad_(True)
               for v in (a, b, y0)]
        with dst.policy(pol):
            y = scan.FirstOrderAffine.apply(*ins)
            (y * ybar.to(dtype)).sum().backward()
        grads[pol] = [v.grad for v in ins]
    errs = [float((g.double() - r).abs().max() / r.abs().max())
            for g, r in zip(grads["fast"], grads["parity"])]
    print(f"  a={a_val:<5} Function gradients vs f64: abar {errs[0]:.2e}, "
          f"bbar {errs[1]:.2e}, y0bar {errs[2]:.2e} (relative)")
    check(max(errs) <= FO_GRAD_RTOL, f"FirstOrderAffine a={a_val}: gradient "
                                     f"error {max(errs):.2e} > {FO_GRAD_RTOL}")
    return max(errs)


def envelope_graph():
    """input -> gain -> envelope -> output (tests/test_fit.py:130)."""
    import dsp_stuff_tpu_torch as dst
    from dsp_stuff_tpu_torch.ids import IdSpace
    g = dst.Graph(IdSpace())
    inp = g.add("input")
    gn = g.add("gain", level=0.5)
    en = g.add("envelope", attack=10.0, release=60.0)
    out = g.add("output")
    g.chain(inp, gn, en, out)
    return g


def hidden_params(cg, **values):
    """cg.init_params() with the first slider of each named node type set:
    values maps cfg_name -> (param, value)."""
    import torch
    p = cg.init_params()
    for cfg, (name, v) in values.items():
        nid = next(str(n.id) for n in cg.graph.nodes.values()
                   if n.cfg_name == cfg)
        p[nid][name] = torch.tensor(v, device=cg.device)
    return p


def render_target(cg, ext, params):
    """The graph's outputs [..., n_out, T] for ``params``, without grad."""
    import torch
    with torch.no_grad():
        _, outs, _ = cg.fn(cg.init_state(), ext, params)
        return torch.stack([outs[i] for i in cg.output_ids], dim=-2)


def loss_grads(cg, ext, target):
    """(loss, {node/param: gradient}) of make_loss_fn at the graph's own
    slider values; a slider with no path to the loss (a knob its
    modulation input overrides) gets 0."""
    import torch
    from dsp_stuff_tpu_torch.train import fit
    p = cg.init_params(requires_grad=True)
    loss = fit.make_loss_fn(cg)(p, cg.init_state(), ext, target)
    loss.backward()
    return loss.detach(), {
        f"{n}/{k}": v.grad if v.grad is not None else torch.zeros(
            (), device=v.device) for n, e in sorted(p.items())
        for k, v in sorted(e.items())}


def grads_card_vs_cpu(name, graph, x_np, hidden, expect_bwd=None):
    """One loss gradient of every slider on the card against the CPU port
    (its plain versions), the target rendered on the CPU from ``hidden``.
    With ``expect_bwd`` (launches by kernel) the card's forward and
    backward launch those and run neither the groups' plain version
    (interpret) nor the oscillator's (oscillator_plain).  Returns the
    card's launches."""
    import torch
    import dsp_stuff_tpu_torch as dst
    cgs = {d: dst.compile_graph(graph, device=d) for d in ("cpu", "cuda")}
    inp = str(cgs["cpu"].input_ids[0])
    tgt = render_target(cgs["cpu"], {inp: torch.from_numpy(x_np)},
                        hidden_params(cgs["cpu"], **hidden))
    got, plain, vjps = {}, {}, {}
    for d, cg in cgs.items():
        reset_launches()
        with (forward_and_vjps_counted(plain, vjps, first_order=False)
              if d == "cuda" else contextlib.nullcontext()):
            got[d] = loss_grads(cg, {inp: torch.as_tensor(x_np, device=d)},
                                tgt.to(d))
    launches = read_launches()
    if expect_bwd is not None:
        check(not vjps and all(launches[k] == v
                               for k, v in expect_bwd.items()),
              f"{name}: launches {launches} (expected {expect_bwd}), the "
              f"plain versions run {vjps}")
    worst = 0.0
    for key, w in got["cpu"][1].items():
        g, w = float(got["cuda"][1][key]), float(w)
        worst = max(worst, abs(g - w) / max(abs(w), 1e-30))
        check(abs(g - w) <= max(FIT_GRAD_RTOL * abs(w), FIT_GRAD_ATOL),
              f"{name}: gradient of {key} {g:.6e} on the card vs {w:.6e} on "
              f"the CPU")
    print(f"{name}, B={x_np.shape[0]} x {x_np.shape[-1] / SR:g} s: "
          f"{len(got['cpu'][1])} slider gradients, card vs CPU port worst "
          f"relative {worst:.2e}; loss {float(got['cuda'][0]):.6e} / "
          f"{float(got['cpu'][0]):.6e}; the card's launches "
          f"{expect_str(launches)}, interpret and oscillator_plain run "
          f"{vjps or 'never'}")
    return launches


def fit_phase(dev, card) -> dict:
    """Gradient fitting on the card (train/fit.py), then the first-order
    kernel's times.  Returns the kernel's launches over the training
    steps and over the envelope graph's gradient, and its (kernel, plain)
    ms scalar forward and per-sample reverse."""
    import torch
    import dsp_stuff_tpu_torch as dst
    from dsp_stuff_tpu_torch.ops import first_order_kernel
    from dsp_stuff_tpu_torch.train import fit
    out = {}
    rngf = np.random.default_rng(12)
    bench_hidden = {"gain": ("level", 2.0), "low_pass": ("ratio", 0.7)}
    with dst.policy("fast"):
        # -- 12. (a) one loss gradient, card vs CPU port ------------------
        grads_card_vs_cpu(
            "bench chain fit", bench_graph(),
            (rngf.standard_normal((2, SR)) * 0.25).astype(np.float32),
            bench_hidden)

        # -- 12. (b) five Adam steps at B_FIT x 10 s ----------------------
        cg = dst.compile_graph(bench_graph(), device="cuda")
        inp = str(cg.input_ids[0])
        gen = torch.Generator(device=dev).manual_seed(13)
        ext = {inp: torch.randn((B_FIT, T_MAIN), generator=gen,
                                device=dev) * 0.25}
        target = render_target(cg, ext, hidden_params(cg, **bench_hidden))
        params = cg.init_params(requires_grad=True)
        step, init_opt = fit.make_train_step(cg, fit.adam(0.03))
        opt = init_opt(params)
        state = cg.init_state()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, secs, launches, plain, vjps = [], [], [], {}, {}
        n_fit = cpu_group_calls(bench_graph(), params=lambda c: (
            c.init_params()))
        n_fit_rev = len(cpu_group_backwards(bench_graph(), params=lambda c: (
            c.init_params(requires_grad=True))))
        with forward_and_vjps_counted(plain, vjps):
            for _ in range(N_STEPS):
                reset_launches()
                t0 = time.time()
                params, opt, loss = step(params, opt, state, ext, target)
                torch.cuda.synchronize()
                secs.append(time.time() - t0)
                launches.append(read_launches())
                losses.append(float(loss))
        peak = torch.cuda.max_memory_allocated()
        print(f"main path (bench chain fit): {N_STEPS} Adam steps over "
              f"[{B_FIT}, {T_MAIN}], losses {losses}, step times "
              f"{[round(t, 4) for t in secs]} s, launches per step "
              f"{launches[-1]}, plain versions called {plain}")
        check(not plain, f"the training steps called plain versions {plain}")
        check(vjps.get("interpret", 0) == 0,
              f"the training steps ran the groups' plain version "
              f"{vjps} times")
        check(all(la == only_launches(first_order=4, pointwise=n_fit,
                                      pointwise_reverse=n_fit_rev)
                  for la in launches),
              f"launches per step {launches}: expected the first-order "
              f"kernel twice forward and twice backward, each of the "
              f"{n_fit} pointwise groups once forward and {n_fit_rev} "
              f"reverse pointwise launches backward")
        check(all(np.isfinite(losses)) and losses[-1] < losses[0],
              f"training losses {losses} are not finite and falling")
        check(all(bool(torch.isfinite(v).all())
                  for e in params.values() for v in e.values()),
              "fitted sliders not finite")
        out["launches"] = sum(la["first_order"] for la in launches)
        out["reverse_launches"] = launches[-1]["pointwise_reverse"]
        print(f"training step (bench chain, 16 sliders): median "
              f"{np.median(secs) * 1e3:.3f} ms at B={B_FIT} x 10 s, peak "
              f"device memory {peak / 2**30:.3f} GiB [{card}]")
        del ext, target, params, opt, cg
        torch.cuda.empty_cache()

        # -- 12. (c) through the envelope ---------------------------------
        grads_card_vs_cpu(
            "envelope graph fit", envelope_graph(),
            (rngf.standard_normal((2, 2 * SR)) * 0.5).astype(np.float32),
            {"gain": ("level", 1.7)})
        cg = dst.compile_graph(envelope_graph(), device="cuda")
        inp = str(cg.input_ids[0])
        ext = {inp: torch.randn((B_FIT, T_MAIN), generator=gen,
                                device=dev) * 0.5}
        target = render_target(cg, ext, hidden_params(
            cg, gain=("level", 1.7)))
        torch.cuda.synchronize()
        plain, vjps = {}, {}
        reset_launches()
        t0 = time.time()
        with forward_and_vjps_counted(plain, vjps):
            loss, grads = loss_grads(cg, ext, target)
            torch.cuda.synchronize()
        sec = time.time() - t0
        env_launches = read_launches()
        print(f"main path (envelope graph fit): loss gradient over "
              f"[{B_FIT}, {T_MAIN}] in {sec * 1e3:.3f} ms (first call), "
              f"launches {env_launches}, plain versions called {plain}, "
              f"gradients { {k: float(v) for k, v in grads.items()} } "
              f"[{card}]")
        check(not plain, f"the envelope fit called plain versions {plain}")
        n_env = cpu_group_calls(envelope_graph(), params=lambda c: (
            c.init_params()))
        n_env_rev = len(cpu_group_backwards(
            envelope_graph(), params=lambda c: c.init_params(
                requires_grad=True)))
        check(vjps.get("interpret", 0) == 0,
              f"the envelope fit ran the groups' plain version {vjps}")
        check(env_launches == only_launches(envelope=1, first_order=1,
                                            pointwise=n_env,
                                            pointwise_reverse=n_env_rev),
              f"envelope fit launched {env_launches}: expected one chunked "
              f"envelope launch, one per-sample first-order solve, "
              f"{n_env} pointwise groups and {n_env_rev} reverse ones")
        check(bool(torch.isfinite(loss)) and all(
            bool(torch.isfinite(v)) for v in grads.values()),
            "envelope fit: loss or gradients not finite")
        out["launches_ps"] = env_launches["first_order"]
        del ext, target, cg

    # -- 13. times of the first-order kernel at the fit's shape -------------
    times = {}
    for name, per_sample, reverse in (("scalar forward", False, False),
                                      ("per-sample reverse", True, True)):
        a, b, y0 = fo_inputs(0.6, B_FIT, T_MAIN, 300, dev, per_sample)
        times[name] = (
            cuda_ms(lambda: first_order_kernel.first_order_cuda(
                a, b, y0, reverse), inner=N_INNER),
            cuda_ms(lambda: fo_plain(a, b, y0, reverse, torch.float32),
                    inner=N_INNER))
        bms, bby = bound((12.0 if per_sample else 8.0) * B_FIT * T_MAIN,
                         2.0 * B_FIT * T_MAIN)
        print(f"first-order kernel, {name}: kernel {times[name][0]:.3f} ms, "
              f"plain {times[name][1]:.3f} ms ({N_INNER} solves back to back) "
              f"at B={B_FIT} x 10 s; bound "
              f"{bms:.3f} ms by {bby} ({bms / times[name][0]:.1%} of it) "
              f"[{card}]")
        del a, b, y0
    b = torch.randn((B_FIT, T_MAIN), device=dev)
    y = torch.empty_like(b)
    copy_ms = cuda_ms(lambda: y.copy_(b), inner=N_INNER)
    print(f"y.copy_(b) at [{B_FIT}, {T_MAIN}] (one read and one write, a "
          f"yardstick): {copy_ms:.3f} ms = "
          f"{8.0 * B_FIT * T_MAIN / (copy_ms * 1e-3) / 1e9:.0f} GB/s [{card}]")
    del b, y
    out["fo_times"] = times["scalar forward"]
    out["fo_times_ps"] = times["per-sample reverse"]
    return out


# -- config3, config4, muff, mux/demux and the fuzz on the card --------------

def oversampled_reference(fn, x, R):
    """tests/oracle's oversampled (the polyphase converters as np.convolve
    in float64, centred) with the port's own low-pass kernel, so that no
    module of the JAX package is imported."""
    from dsp_stuff_tpu_torch.ops.oversample import _lowpass_kernel
    h = _lowpass_kernel(R).astype(np.float64)
    pad = (len(h) - 1) // 2
    T = len(x)
    dil = np.zeros((T - 1) * R + 1, np.float64)
    dil[::R] = x
    xu = np.convolve(dil, h * R)[pad:pad + R * T].astype(np.float32)
    return np.convolve(fn(xu).astype(np.float64), h)[pad::R][:T].astype(
        np.float32)


def oracle_config3(x):
    """config3 composed from tests/oracle: the reference's overdrive
    (overdrive.rs:31-43) and Tanh distortion at 4x inside the float64
    converters, between fan-in hops (tests/test_presets.py)."""
    import oracle
    h = oracle.fanin_average
    v = oversampled_reference(lambda u: oracle.overdrive(u, 8.0, 0.8, 0.9),
                              h([x]), 4)
    v = oversampled_reference(lambda u: oracle.tanh_clip(u, 6.0), h([v]), 4)
    return h([v])


def oracle_config4(taps):
    """A function of x: config4's two outputs, each fir_reference of the
    fan-in hop of x, through the output's hop."""
    import oracle
    h = oracle.fanin_average

    def oracle_config4(x):
        v = h([x])
        return [h([fir_reference(v, t).astype(np.float32)]) for t in taps]
    return oracle_config4


def device_split(fn, groups, kernels=None):
    """(device ms by group, device ms in all) of one call of fn() from
    torch.profiler: each aten op's own device time goes to the first group
    of ``groups`` ({name: op names}) that names it, else to "other".  A
    dict ``kernels`` receives the device ms of the port's kernels by
    launch counter key (kernel_of)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    avgs = prof.key_averages()
    total = sum(e.self_device_time_total for e in avgs
                if e.device_type == DeviceType.CUDA) / 1e3
    out = {name: 0.0 for name in groups}
    out["other"] = 0.0
    for e in avgs:
        key = kernel_of(e.key)
        if kernels is not None and key and e.device_type == DeviceType.CUDA:
            kernels[key] = kernels.get(key, 0.0) + \
                e.self_device_time_total / 1e3
    for e in avgs:
        if e.device_type != DeviceType.CPU or not e.self_device_time_total:
            continue
        name = next((g for g, ops in groups.items() if e.key in ops),
                    "other")
        out[name] += e.self_device_time_total / 1e3
    return out, total


def print_split(what, wall_ms, split, total, card):
    print(f"{what}: wall {wall_ms:.3f} ms (median of {N_TIMED}), device "
          f"{total:.3f} ms, idle {1 - total / wall_ms:.1%}; " + ", ".join(
              f"{k} {v:.3f} ms ({v / total:.1%})" for k, v in split.items())
          + f" [{card}]")


CONVERTER_OPS = {"products": ("aten::mm", "aten::bmm", "aten::addmm"),
                 "windows": ("aten::cat", "aten::constant_pad_nd",
                             "aten::copy_", "aten::clone")}
FIR_OPS = {"cuFFT": ("aten::_fft_r2c", "aten::_fft_c2r"),
           "warm-up cumsum": ("aten::cumsum",),
           "frames": ("aten::cat", "aten::constant_pad_nd", "aten::copy_",
                      "aten::clone")}


def conv1d_upsampler(x, R):
    """The polyphase upsampler of ops/oversample.py as one F.conv1d over x
    [B, T] (R output channels, phase p's 17 taps R h[R (16 - k) + p], the
    input padded by the 8-sample group delay each side), the phases
    interleaved: the same sums as the banded product."""
    import torch
    import torch.nn.functional as F
    from dsp_stuff_tpu_torch.ops.oversample import TAPS_PER_PHASE, \
        _lowpass_kernel
    h = _lowpass_kernel(R).astype(np.float64) * R
    n = TAPS_PER_PHASE + 1
    w = np.zeros((R, 1, n), np.float64)
    for p in range(R):
        for k in range(n):
            if R * (n - 1 - k) + p < len(h):
                w[p, 0, k] = h[R * (n - 1 - k) + p]
    wt = torch.as_tensor(w.astype(np.float32), device=x.device)
    B, T = x.shape
    half = TAPS_PER_PHASE // 2

    def up():
        y = F.conv1d(F.pad(x.reshape(B, 1, T), (half, half)), wt)
        return y.transpose(1, 2).reshape(B, R * T)
    return up


def config3_phase(dev, card) -> dict:
    """config3 (4x-oversampled overdrive -> Tanh distortion) over B_C3
    streams x 10 s through compile_graph(..., device="cuda"), fast: no
    kernel launches (its converters are matrix products, its shapers
    eager ops), the composed oracle on stream 0, times and peak memory,
    one converter beside F.conv1d, then parity at 4 x 1 s.  The converters
    keep no state, so two chained renders differ from one near the
    boundary (tests/test_torch_presets.py pins that to the JAX package):
    no handoff check here."""
    import torch
    import dsp_stuff_tpu_torch as dst
    from dsp_stuff_tpu_torch.models import presets
    from dsp_stuff_tpu_torch.ops import oversample
    out = {}
    g3, _ = presets.config3_oversampled_distortion()
    x_np = (np.random.default_rng(31).standard_normal(
        (B_C3, 1, T_MAIN), dtype=np.float32) * np.float32(0.25))
    x = torch.as_tensor(x_np, device=dev)
    with dst.policy("fast"):
        cg = dst.compile_graph(g3, device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        plain = {}
        reset_launches()
        t0 = time.time()
        with plain_versions_counted(plain, first_order=True):
            y, _, _ = cg.render(x, batch_shape=(B_C3,))
            torch.cuda.synchronize()
        wall = time.time() - t0
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated()
        print(f"main path (config3): render [{B_C3}, 1, {T_MAIN}] in "
              f"{wall:.3f} s (first call), launches {launches}, plain "
              f"versions called {plain}; peak device memory "
              f"{peak / 2**30:.3f} GiB ({(peak - base) / 2**30:.3f} GiB "
              f"above the input) [{card}]")
        check(not plain, f"config3 called plain versions {plain}")
        check(launches == only_launches(pointwise=3),
              f"config3 launched {launches}: its path runs the pointwise "
              f"kernel for each oversampled shaper and the Output's fan-in")
        check(tuple(y.shape) == (B_C3, 1, T_MAIN) and
              bool(torch.isfinite(y).all()),
              f"config3 output {tuple(y.shape)} not finite or misshapen")
        d = dbfs(host(y[0, 0]), oracle_config3(x_np[0, 0]))
        print(f"  stream 0, 10 s vs the composed oracle (float64 "
              f"converters): {d:.1f} dBFS")
        check(d <= ORACLE_FAST_DB, f"config3 vs oracle {d:.1f} dBFS")
        del y
        ms = cuda_ms(lambda: cg.render(x, batch_shape=(B_C3,)))
        split, total = device_split(
            lambda: cg.render(x, batch_shape=(B_C3,)), CONVERTER_OPS)
        print_split(f"config3 render, B={B_C3} x 10 s", ms, split, total,
                    card)
        n = B_C3 * T_MAIN
        bms, bby = bound(8.0 * n, 4 * 1152.0 * n)
        print(f"config3 whole render: {ms:.3f} ms = "
              f"{n / SR / (ms / 1e3):,.0f} audio-s/s; bound {bms:.3f} ms by "
              f"{bby} (four converters of 1,152 FP32 operations a base-rate "
              f"sample; a direct polyphase filter needs about 136) "
              f"[{card}]")
        out["render_ms"], out["peak"] = ms, peak

        # one converter (the 4x upsampler) beside F.conv1d of the same sums
        xs = x.reshape(B_C3, T_MAIN)
        up_conv = conv1d_upsampler(xs, 4)
        d = dbfs_dev(up_conv(), oversample.upsample(xs, 4))
        check(d <= Y_BOUND_DB, f"F.conv1d upsampler vs upsample {d:.1f} dBFS")
        up_ms, conv_ms = in_turns(lambda: oversample.upsample(xs, 4),
                                  up_conv)
        bms, bby = bound(20.0 * n, 1152.0 * n)
        print(f"4x upsampler at [{B_C3}, {T_MAIN}]: banded product "
              f"{up_ms:.3f} ms, F.conv1d of the same sums {conv_ms:.3f} ms "
              f"(agree to {d:.1f} dBFS); bound {bms:.3f} ms by {bby} "
              f"({bms / up_ms:.1%} of it) [{card}]")
        out["up_ms"], out["conv_ms"] = up_ms, conv_ms
        del x, xs
        torch.cuda.empty_cache()
    launches = parity(g3, x_np[:4, :, :SR], oracle_config3, "config3")
    check(launches == only_launches(pointwise=3),
          f"config3 parity launched {launches}")
    return out


def config4_phase(dev, card) -> dict:
    """config4 (two FIR nodes of the 1 s stereo IR, 48,000 taps each) over
    B_C4 streams x 10 s, fast: no kernel launches (cuFFT overlap-save),
    streams 0 and B_C4 - 1 over the whole 10 s against fir_reference, a
    2 x 5 s handoff, times, peak memory and the device time in cuFFT, then
    parity at 4 x 2 s (float64 cuFFT)."""
    import torch
    import dsp_stuff_tpu_torch as dst
    from dsp_stuff_tpu_torch.models import presets
    out = {}
    g4, meta = presets.config4_convolution_reverb()
    taps = [np.asarray(g4.nodes[f].params["taps"], np.float64)
            for f in meta["firs"]]
    ref = oracle_config4(taps)
    N = len(taps[0])
    nfft = 1 << max(int(np.ceil(np.log2(2 * N))), 10)
    frames = -(-(T_MAIN + N - 1) // (nfft - (N - 1)))
    check(T_MAIN + N - 1 > 4 * nfft, "config4's FIR takes one transform")
    print(f"config4: {N} taps a channel; the FIR sees {T_MAIN + N - 1} "
          f"samples > 4 x {nfft}: overlap-save, nfft {nfft}, hop "
          f"{nfft - (N - 1)}, {frames} frames")
    x_np = (np.random.default_rng(41).standard_normal(
        (B_C4, 1, T_MAIN), dtype=np.float32) * np.float32(0.25))
    x = torch.as_tensor(x_np, device=dev)
    with dst.policy("fast"):
        cg = dst.compile_graph(g4, device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        plain = {}
        reset_launches()
        t0 = time.time()
        with plain_versions_counted(plain, first_order=True):
            y, _, _ = cg.render(x, batch_shape=(B_C4,))
            torch.cuda.synchronize()
        wall = time.time() - t0
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated()
        print(f"main path (config4): render [{B_C4}, 1, {T_MAIN}] in "
              f"{wall:.3f} s (first call), launches {launches}, plain "
              f"versions called {plain}; peak device memory "
              f"{peak / 2**30:.3f} GiB ({(peak - base) / 2**30:.3f} GiB "
              f"above the input) [{card}]")
        check(not plain, f"config4 called plain versions {plain}")
        check(launches == only_launches(pointwise=2),
              f"config4 launched {launches}: its path runs no kernel but "
              f"the pointwise kernel of each Output's fan-in")
        check(tuple(y.shape) == (B_C4, 2, T_MAIN) and
              bool(torch.isfinite(y).all()),
              f"config4 output {tuple(y.shape)} not finite or misshapen")
        for i in (0, B_C4 - 1):
            for k, want in enumerate(ref(x_np[i, 0])):
                d = dbfs(host(y[i, k]), want)
                print(f"  stream {i}, output {k}, 10 s vs fir_reference: "
                      f"{d:.1f} dBFS")
                check(d <= ORACLE_FAST_DB, f"config4 stream {i} output {k} "
                                           f"vs reference {d:.1f} dBFS")
        del y
        ms = cuda_ms(lambda: cg.render(x, batch_shape=(B_C4,)))
        split, total = device_split(
            lambda: cg.render(x, batch_shape=(B_C4,)), FIR_OPS)
        print_split(f"config4 render, B={B_C4} x 10 s", ms, split, total,
                    card)
        n = B_C4 * T_MAIN
        print(f"config4 whole render: {ms:.3f} ms = "
              f"{n / SR / (ms / 1e3):,.0f} audio-s/s [{card}]")
        out["render_ms"], out["peak"], out["fft_ms"] = ms, peak, \
            split["cuFFT"]
        handoff(cg, x[:B_CHECK], "config4")
        del x
        torch.cuda.empty_cache()
    launches = parity(g4, x_np[:4, :, :2 * SR], ref, "config4")
    check(launches == only_launches(pointwise=2),
          f"config4 parity launched {launches}")
    return out


def muff_graph():
    import dsp_stuff_tpu_torch as dst
    from dsp_stuff_tpu_torch.ids import IdSpace
    g = dst.Graph(IdSpace())
    inp = g.add("input")
    mf = g.add("muff", toan=0.3, level=0.8, sustain=0.6)
    out = g.add("output")
    g.chain(inp, mf, out)
    return g


def mux_demux_graph():
    """input -> demux (B) -> both ports of mux (B) -> output
    (tests/test_graph.py)."""
    import dsp_stuff_tpu_torch as dst
    from dsp_stuff_tpu_torch.ids import IdSpace
    g = dst.Graph(IdSpace())
    inp = g.add("input")
    dmx = g.add("demux", out_port="B")
    mx = g.add("mux", in_port="B")
    out = g.add("output")
    g.connect(inp, "out", dmx, "in")
    g.connect(dmx, "b", mx, "b")
    g.connect(dmx, "a", mx, "a")
    g.connect(mx, "out", out, "in")
    return g


def card_vs_cpu(graph, x_np, pol="fast"):
    """(card render, CPU port render) of x_np [B, 1, T] as NumPy."""
    import dsp_stuff_tpu_torch as dst
    with dst.policy(pol):
        got = {}
        for d in ("cuda", "cpu"):
            y, _, _ = dst.compile_graph(graph, device=d).render(
                x_np, batch_shape=(len(x_np),))
            got[d] = host(y)
    return got["cuda"], got["cpu"]


def muff_phase(dev, card) -> None:
    """muff over B_MUFF streams x 10 s on the card, fast: its tone stack's
    one-pole is one first-order kernel launch a render, no plain version
    called; 2 x 1 s against the CPU port."""
    import torch
    import dsp_stuff_tpu_torch as dst
    g = muff_graph()
    x_np = (np.random.default_rng(51).standard_normal(
        (B_MUFF, 1, T_MAIN), dtype=np.float32) * np.float32(0.3))
    x = torch.as_tensor(x_np, device=dev)
    with dst.policy("fast"):
        cg = dst.compile_graph(g, device="cuda")
        torch.cuda.synchronize()
        plain = {}
        reset_launches()
        with plain_versions_counted(plain, first_order=True):
            y, _, st = cg.render(x, batch_shape=(B_MUFF,))
            torch.cuda.synchronize()
        launches = read_launches()
        ms = cuda_ms(lambda: cg.render(x, batch_shape=(B_MUFF,)))
    print(f"main path (muff): render [{B_MUFF}, 1, {T_MAIN}], launches "
          f"{launches}, plain versions called {plain}; {ms:.3f} ms median "
          f"of {N_TIMED} [{card}]")
    check(not plain, f"muff called plain versions {plain}")
    check(launches == only_launches(first_order=1, pointwise=1),
          f"muff launched {launches}: expected one first-order launch and "
          f"one pointwise group (the Output's fan-in)")
    check(bool(torch.isfinite(y).all()), "muff output not finite")
    gpu, cpu = card_vs_cpu(g, x_np[:2, :, :SR])
    d = dbfs(gpu, cpu)
    print(f"  muff, 2 x 1 s, card vs CPU port: {d:.1f} dBFS")
    check(d <= CARD_VS_CPU_DB, f"muff card vs CPU {d:.1f} dBFS")
    del x, y, st


def config2_phase(dev, card) -> None:
    """config2 (echo -> chorus -> gain) over B_C5 streams x 10 s on the
    card, fast: one chain launch (its mtap stage), no plain version, stream
    0's first second against the composed oracle (ORACLE_FAST_DB); parity
    at 4 x 1 s against it (PARITY_DB)."""
    import torch
    import dsp_stuff_tpu_torch as dst
    from dsp_stuff_tpu_torch.models import presets
    g2 = presets.config2_delay_chorus()[0]
    x_np = (np.random.default_rng(61).standard_normal(
        (B_C5, 1, T_MAIN), dtype=np.float32) * np.float32(0.3))
    with dst.policy("fast"):
        cg = dst.compile_graph(g2, device="cuda")
        x = torch.as_tensor(x_np, device=dev)
        torch.cuda.synchronize()
        plain = {}
        reset_launches()
        with plain_versions_counted(plain):
            y, _, _ = cg.render(x, batch_shape=(B_C5,))
            torch.cuda.synchronize()
        launches = read_launches()
    check(not plain, f"config2 called plain versions {plain}")
    check(launches == only_launches(chain=1),
          f"config2 launched {launches}: expected one chain launch")
    check(tuple(y.shape) == (B_C5, 1, T_MAIN)
          and bool(torch.isfinite(y).all()), "config2 output")
    d = dbfs(host(y[0, 0, :SR]), oracle_config2(x_np[0, 0, :SR]))
    print(f"main path (config2): render [{B_C5}, 1, {T_MAIN}], launches "
          f"{expect_str(launches)}, no plain version; stream 0, first second "
          f"vs the composed oracle: {d:.1f} dBFS (<= {ORACLE_FAST_DB}) "
          f"[{card}]")
    check(d <= ORACLE_FAST_DB, f"config2 fast vs oracle {d:.1f} dBFS")
    del x, y
    parity(g2, x_np[:4, :, :SR], oracle_config2, "config2")


def examples_phase(card) -> None:
    """The port's example scripts (dsp_stuff_tpu_torch/examples/) at their
    default sizes on the card, each in a new process, the three started
    together (the kernels are built by the earlier phases): exit 0, output
    naming the card, the fit's loss finite and lower at the end than at
    its first step."""
    t0 = time.time()
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", f"dsp_stuff_tpu_torch.examples.{name}"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name in ("streaming", "render_batch", "fit_amp")}
    try:
        for name, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=600)
            wall = time.time() - t0
            check(proc.returncode == 0, f"example {name} exit "
                                        f"{proc.returncode}: {stderr[-2000:]}")
            lines = stdout.strip().splitlines()
            check(bool(lines) and "cuda" in stdout,
                  f"example {name} printed {lines[-3:]}")
            if name == "fit_amp":
                losses = [float(v) for v in re.findall(r"loss ([0-9.e+-]+)",
                                                       stdout)]
                check(len(losses) >= 2 and np.isfinite(losses).all()
                      and losses[-1] < losses[0], f"fit_amp losses {losses}")
            print(f"example {name} on the card: exit 0 within {wall:.1f} s "
                  f"of the three's start (a new process) [{card}]; "
                  f"{lines[0]} | {lines[-1]}")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def mux_demux_phase() -> None:
    """mux and demux on the card, bitwise equal to the CPU port."""
    x_np = (np.random.default_rng(61).standard_normal(
        (4, 1, SR), dtype=np.float32) * np.float32(0.3))
    for pol in ("fast", "parity"):
        gpu, cpu = card_vs_cpu(mux_demux_graph(), x_np, pol)
        print(f"mux / demux, 4 x 1 s, {pol}: card vs CPU port "
              f"{'bitwise equal' if np.array_equal(gpu, cpu) else 'DIFFER'}")
        check(np.array_equal(gpu, cpu), f"mux/demux {pol}: card != CPU")


def fuzz_graphs():
    """(name, graph, input id) of the card's fuzz phase, from the port's
    fuzz generators (tests/test_torch_fuzz_gen.py)."""
    import test_torch_fuzz_gen as gen
    out = [(f"_random_graph({s})", *gen._random_graph(s)[:2])
           for s in FUZZ_GRAPH_SEEDS]
    out += [(f"_random_mega_cycle_graph({s})",
             *gen._random_mega_cycle_graph(s)[:2]) for s in FUZZ_MEGA_SEEDS]
    return out


def cycle_programs_of(graph):
    """The block programs the planner lowers the graph's feedback SCCs to
    under fast."""
    import dsp_stuff_tpu_torch as dst
    from dsp_stuff_tpu_torch.compiler.compile import _is_cycle
    cg = dst.compile_graph(graph, device="cpu")
    with dst.policy("fast"):
        got = [cg._cycle_program(c, None) for c in cg._sccs
               if _is_cycle(graph, c)]
    return [p[0] for p in got if p is not None]


def fuzz_phase(dev, card) -> dict:
    """The fuzz graphs on the card against the CPU port, fast, B_FUZZ x
    1 s: every chain segment and cycle program the evaluator calls is one
    launch of its kernel, no plain version runs; returns the launches of
    all the graphs."""
    import torch
    import dsp_stuff_tpu_torch as dst
    from dsp_stuff_tpu_torch.compiler import compile as tcompile
    from dsp_stuff_tpu_torch.ops import chain_segment
    rng = np.random.default_rng(71)
    totals = only_launches()
    worst = -np.inf
    for name, g, inp in fuzz_graphs():
        x_np = (rng.standard_normal((B_FUZZ, SR), dtype=np.float32)
                * np.float32(0.25))
        with dst.policy("fast"):
            want, _, _ = dst.compile_graph(g, device="cpu").render(
                {str(inp): torch.from_numpy(x_np)}, batch_shape=(B_FUZZ,))
            cg = dst.compile_graph(g, device="cuda")
            xd = {str(inp): torch.as_tensor(x_np, device=dev)}
            calls, plain = {}, {}
            reset_launches()
            with calls_counted([(chain_segment, "chain_segment"),
                                (tcompile, "cycle_segment"),
                                (tcompile, "group_call")], calls), \
                    plain_versions_counted(plain):
                got, _, _ = cg.render(xd, batch_shape=(B_FUZZ,))
                torch.cuda.synchronize()
            launches = read_launches()
        d = dbfs(host(got), host(want))
        worst = max(worst, d)
        kinds = sorted({n.cfg_name for n in g.nodes.values()}
                       - {"input", "output"})
        print(f"  {name:28s} card vs CPU port {d:7.1f} dBFS, launches "
              f"{launches}; {kinds}")
        check(not plain, f"fuzz {name} called plain versions {plain}")
        check(launches["chain"] == calls.get("chain_segment", 0) and
              launches["cycle"] == calls.get("cycle_segment", 0) and
              launches["pointwise"] == calls.get("group_call", 0),
              f"fuzz {name}: launches {launches} vs fused calls {calls}")
        check(launches["envelope"] >= ("envelope" in kinds),
              f"fuzz {name}: an envelope node launched no envelope kernel")
        check(launches["oscillator"] == osc_launches(g, SR),
              f"fuzz {name}: {launches['oscillator']} oscillator launches, "
              f"expected {osc_launches(g, SR)}")
        check(d <= CARD_VS_CPU_DB, f"fuzz {name}: card vs CPU {d:.1f} dBFS")
        for k, v in launches.items():
            totals[k] += v
    print(f"fuzz on the card, {len(fuzz_graphs())} graphs, B={B_FUZZ} x 1 s: "
          f"worst {worst:.1f} dBFS against the CPU port, launches {totals}")
    check(all(totals[k] for k in ("chain", "cycle", "envelope")),
          f"the fuzz graphs did not reach every kernel: {totals}")
    return totals


# -- the runtime on the card ---------------------------------------------------

def same_on_both(what, pairs) -> None:
    """Each (card tensor, CPU tensor) pair bitwise equal."""
    import torch
    ok = all(torch.equal(k.cpu(), c) for k, c in pairs)
    print(f"  {what}: card vs CPU port {'bitwise equal' if ok else 'DIFFER'}")
    check(ok, f"{what}: card != CPU port")


def divide_checks(dev) -> None:
    """The three divides that are true f32 divides on the card (a divisor
    on the device; by a Python float CUDA multiplies by the reciprocal),
    bitwise against the CPU port: the signal generator's phase step
    (Triangle and Square at 997 Hz, 4 streams x 10 s, fast and parity),
    config5's LFO (its phase under both policies and its waveform under
    parity, an f64 sine rounded once; under fast CUDA's sinf rounds
    otherwise than the CPU's sin, within LFO_FAST_ATOL), soft clip over
    1e6 inputs, and the spectrogram's tilt of 1 s of magnitudes (the whole
    spectrogram within CARD_VS_CPU_DB: cuFFT and the interpolation's
    product sum in another order than the CPU)."""
    import torch
    import dsp_stuff_tpu_torch as dst
    from dsp_stuff_tpu_torch.models import presets
    from dsp_stuff_tpu_torch.ops import fftspec, gen, shaping
    g5, meta5 = presets.config5_feedback_16node()
    lfo = next(n for n in g5.nodes.values() if n.cfg_name == "signal_gen")
    mode, freq, amp = (lfo.params[k] for k in ("mode", "frequency",
                                               "amplitude"))
    rng = np.random.default_rng(81)
    xs = torch.from_numpy((rng.standard_normal(1_000_000) * 1.5)
                          .astype(np.float32))
    f997 = torch.full((4, T_MAIN), 997.0)
    for pol in ("fast", "parity"):
        with dst.policy(pol):
            for wave in ("Triangle", "Square"):
                same_on_both(f"signal_gen {wave} 997 Hz, 4 x 10 s, {pol}",
                             zip(gen.oscillator(wave, 0.8, f997.to(dev),
                                                T_MAIN),
                                 gen.oscillator(wave, 0.8, f997, T_MAIN)))
            same_on_both(f"config5 LFO phase ({mode} {freq} Hz), 10 s, {pol}",
                         zip(gen._block_totals(freq, T_MAIN, 128, SR, 0.0,
                                               dev),
                             gen._block_totals(freq, T_MAIN, 128, SR, 0.0,
                                               "cpu")))
            yk, _ = gen.oscillator(mode, amp, freq, T_MAIN, device=dev)
            yc, _ = gen.oscillator(mode, amp, freq, T_MAIN, device="cpu")
            if pol == "parity":
                same_on_both(f"config5 LFO waveform, 10 s, {pol}",
                             [(yk, yc)])
            else:
                err = float((yk.cpu() - yc).abs().max())
                print(f"  config5 LFO waveform, 10 s, {pol}: card vs CPU "
                      f"port max abs {err:.2e} (sinf)")
                check(err <= LFO_FAST_ATOL, f"config5 LFO {pol}: {err:.2e}")
            same_on_both(f"soft clip, 1e6 inputs, {pol}",
                         [(shaping.soft_clip(xs.to(dev), 1.3),
                           shaping.soft_clip(xs, 1.3))])
    spec = next(n for n in g5.nodes.values() if n.cfg_name == "spectrogram")
    fft = int(spec.params["fft_size"])
    lo, hi = float(spec.params["lower_bound"]), float(spec.params["upper_bound"])
    x1 = torch.from_numpy((rng.standard_normal(SR) * 0.3).astype(np.float32))
    freqs, keep = fftspec._kept_bins(fft, lo, hi, SR)
    frames = x1[:SR // fft * fft].reshape(-1, fft)
    win = torch.from_numpy(np.hanning(fft).astype(np.float32))
    mag = (torch.abs(torch.fft.rfft(frames * win, dim=-1)) / fft)[..., keep]
    same_on_both("spectrogram tilt, 1 s of magnitudes",
                 [(fftspec.tilt(mag.to(dev), freqs[keep]),
                   fftspec.tilt(mag, freqs[keep]))])
    _, ck = fftspec.spectrogram(x1.to(dev), fft, lo, hi)
    _, cc = fftspec.spectrogram(x1, fft, lo, hi)
    d = dbfs(host(ck), host(cc))
    print(f"  spectrogram of 1 s: card vs CPU port {d:.1f} dBFS (cuFFT)")
    check(d <= CARD_VS_CPU_DB, f"spectrogram card vs CPU {d:.1f} dBFS")


def env_gains(atk, rel, dev):
    """The envelope kernel's gains: (attack, release) as one [2] f32
    tensor on the card, which the kernel reads from device memory."""
    import torch
    return torch.tensor([atk, rel], dtype=torch.float32, device=dev)


def stream_kernel_checks(dev) -> None:
    """Each kernel of the stream's path at one row of one 128-sample block
    and of two (block_size 256) against its plain version, at the kernel
    checks' limits: the chain kernel (a tile of 64 blocks holding one or
    two) on the bench list and config5's mtap list, the cycle kernel on
    config5's program (the feed staging with one or two blocks), the
    sequential envelope kernel, the first-order kernel scalar forward (one
    ragged tile), also against float64."""
    import torch
    from dsp_stuff_tpu_torch.models import presets
    from dsp_stuff_tpu_torch.ops import (chain_segment, cycle_segment,
                                         envelope, envelope_kernel,
                                         first_order_kernel)
    rng = np.random.default_rng(91)
    program, n_taps = cycle_program(presets.config5_feedback_16node()[0])
    lists = {"bench": (bench_stages(), ()),
             "mtap config5": mtap_lists()["mtap config5"]}
    atk = envelope.gain_from_frames(50.0)
    rel = envelope.gain_from_frames(400.0)
    seed = 900
    for T in (128, 256):
        for name, (stages, lfos) in lists.items():
            x = torch.as_tensor((rng.standard_normal((1, T)) * 0.3)
                                .astype(np.float32), device=dev)
            st = seeded_states(stages, 1, rng, dev, T=T, lfos=lfos)
            k = kernel_segment(x, stages, st)
            p = chain_segment.segment_fallback(x, stages, st)
            torch.cuda.synchronize()
            compare(f"chain {name} [1, {T}]", k, p)
        ins = cycle_inputs(program, 1, T, rng, dev)
        k = cycle_kernel_run(*ins, program, n_taps)
        p = cycle_segment.interpret(*ins, program, n_taps)
        torch.cuda.synchronize()
        compare_cycle(f"cycle config5 [1, {T}]", k, p)
        xe = torch.as_tensor((rng.standard_normal((1, T)) * 0.5)
                             .astype(np.float32), device=dev)
        e0 = torch.as_tensor(rng.random(1).astype(np.float32), device=dev)
        k = envelope_kernel.peak_envelope_cuda(xe, env_gains(atk, rel, dev),
                                               e0, chunk=T)
        p = envelope._seq_scan(xe, atk, rel, e0)
        torch.cuda.synchronize()
        compare_env(f"envelope sequential [1, {T}]", k, p)
        worst = -np.inf
        for a in FO_COEFFS:
            seed += 1
            fo_check(a, "forward", 1, T, seed, dev, show=False)
            a_, b_, y0_ = fo_inputs(a, 1, T, seed, dev, False)
            k = first_order_kernel.first_order_cuda(a_, b_, y0_, False)
            worst = max(worst, dbfs_dev(k, fo_plain(a_, b_, y0_, False,
                                                    torch.float32)))
        print(f"  first-order forward [1, {T}]    y {worst:8.1f} dBFS vs plain "
              f"(a in {FO_COEFFS}; vs f64 <= {FO_F64_DB})")
        check(worst <= Y_BOUND_DB, f"first-order [1, {T}]: {worst:.1f} dBFS")


#: the hand-written kernels by their __global__ names in csrc/ -> the
#: launch counters' keys
KERNEL_NAMES = (("pointwise_reverse_kernel", "pointwise_reverse"),
                ("pointwise_kernel", "pointwise"),
                ("sequential_reverse_kernel", "sequential"),
                ("sequential_kernel", "sequential"),
                ("cycle_reverse_kernel", "cycle_reverse"),
                ("chain_reverse_kernel", "chain_reverse"),
                ("chain_kernel", "chain"), ("cycle_kernel", "cycle"),
                ("envelope_kernel", "envelope"), ("fo_chained", "first_order"),
                ("oscillator_clock_kernel", "oscillator"),
                ("oscillator_wave_kernel", "oscillator"))


def kernel_of(name: str):
    """The launch counter's key of a kernel's name (demangled or mangled),
    or None for a kernel that is not one of the port's."""
    for k, key in KERNEL_NAMES:
        if k in name:
            return key
    return None


def instance_of(name: str):
    """What a kernel's device time is kept under: its counter key, and for
    the sequential kernels the template's mode as well (sequential<0>:
    first order, <1>: per-sample, <2>: biquad)."""
    key = kernel_of(name)
    m = re.search(r"sequential(?:_reverse)?_kernel(?:<|ILi)(\d+)", name)
    return f"{key}<{m.group(1)}>" if key == "sequential" and m else key


#: the kinds of a CUDA graph node that put work on the card (each is one
#: device event of a profiled replay)
WORK_NODES = ("KERNEL", "MEMCPY", "MEMSET")


def graph_nodes(sess, name) -> dict:
    """The nodes of the session's captured step, counted from the graph
    itself (its DOT dump, cudaGraphDebugDotPrint): by kind, and the
    port's kernels by launch counter key and by instance_of.
    Deterministic: what the replays run, whatever a profiler sees."""
    os.makedirs(GRAPH_DIR, exist_ok=True)
    path = os.path.join(GRAPH_DIR, re.sub(r"\W+", "_", name) + ".dot")
    sess.step.dump_graph(path)
    return dot_nodes(path)


def dot_nodes(path) -> dict:
    """The nodes of a captured graph's DOT dump at ``path``: by kind, and
    the port's kernels by launch counter key and by instance_of."""
    with open(path) as f:
        text = f.read()
    out = {"kinds": {}, "ours": {}, "inst": {}, "at": [], "path": path,
           "names": {}}
    starts = [m.start() for m in re.finditer(
        r'^\s*"graph_\d+_node_\d+"\s*\[', text, re.M)]
    for a, b in zip(starts, starts[1:] + [len(text)]):
        node = text[a:b]
        m = re.search(r'label="[{\s]*([A-Z_]+)', node)
        kind = m.group(1) if m else "?"
        out["kinds"][kind] = out["kinds"].get(kind, 0) + 1
        if kind == "KERNEL":
            key, inst = kernel_of(node), instance_of(node)
            if key is not None:
                out["at"].append((out["kinds"]["KERNEL"] - 1, inst))
                out["ours"][key] = out["ours"].get(key, 0) + 1
                out["inst"][inst] = out["inst"].get(inst, 0) + 1
            fn = re.search(r"(_Z\w+)", node)
            name = fn.group(1)[:48] if fn else "?"
            out["names"][name] = out["names"].get(name, 0) + 1
    out["work"] = sum(out["kinds"].get(k, 0) for k in WORK_NODES)
    return out


def profile_block(sess, block, gn) -> dict:
    """One process() call's device work by torch.profiler: kernels (all,
    and the port's by instance_of with their device time), host-to-device
    and device-to-host copies, memsets, their device time and the call's
    wall time.  ``gn`` is the captured graph's node count (graph_nodes),
    the witness a profile is held against: it is kept only when its
    device events are exactly the graph's work nodes and the call's copy
    in and out, its kernels the graph's kernel nodes and the port's
    kernels the graph's by instance.  The trace of a profile loses its
    first device records (seen on an H100: the first 1-11 kernels of a
    replay, the input's copy among them, in every profile of a call),
    so each profile opens with PROFILE_LEAD_IN spin kernels that take
    that loss; how many of them it showed is kept in ``lead_in``.  Up
    to PROFILE_TRIES profiles are taken; returns the first kept, with
    ``tries`` and ``rejected`` (the event counts of those that were
    not), or None when none was kept: the replay's times are then not
    measured."""
    rejected = []
    want = gn["kinds"].get("KERNEL", 0)
    for tries in range(1, PROFILE_TRIES + 1):
        p = _profile_once(sess, block)
        if (p["events"] == gn["work"] + 2 and p["kernels"] == want
                and p["ours"] == gn["inst"]):
            p["tries"], p["rejected"] = tries, rejected
            return p
        rejected.append(p["events"])
        order = [n for _, n in sorted(p["order"])]
        at = [(i, instance_of(n)) for i, n in enumerate(order)
              if kernel_of(n)]
        print(f"  (profile {tries} of a replay: {p['events']} device events "
              f"of {gn['work'] + 2}, {p['kernels']} kernels of {want}, the "
              f"port's at {at} (the graph's at {gn['at']}); "
              f"{p['lead_in']} of {PROFILE_LEAD_IN} lead-in kernels seen: "
              f"rejected)")
    return None


def _profile_once(sess, block) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile
    sess.process(block)                      # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # the trace loses the first device records of a profile; short
        # spin kernels take that loss ahead of the call
        for _ in range(PROFILE_LEAD_IN):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sess.process(block)
        wall = time.perf_counter() - t0
    out = {"kernels": 0, "h2d": 0, "d2h": 0, "memset": 0, "device_us": 0.0,
           "wall_us": wall * 1e6, "ours": {}, "ours_us": {}, "copies": {},
           "events": 0, "order": [], "lead_in": 0}
    names: dict = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        n = e.name
        if "spin_kernel" in n:
            out["lead_in"] += 1
            continue
        out["events"] += 1
        us = (e.device_time_total if hasattr(e, "device_time_total")
              else e.cuda_time_total)
        # a graph's copy node may run as a copy kernel (memcpy32_post)
        copy = n.startswith(("Memcpy", "Memset", "memcpy"))
        if copy:
            out["copies"][n[:40]] = out["copies"].get(n[:40], 0) + 1
        if n.startswith("Memcpy HtoD"):
            out["h2d"] += 1
        elif n.startswith("Memcpy DtoH"):
            out["d2h"] += 1
        elif n.startswith("Memset"):
            out["memset"] += 1
        elif not copy:
            out["kernels"] += 1
            out["order"].append((e.time_range.start, n))
            names[n[:60]] = names.get(n[:60], 0) + 1
            inst = instance_of(n)
            if inst is not None:
                out["ours"][inst] = out["ours"].get(inst, 0) + 1
                out["ours_us"][inst] = out["ours_us"].get(inst, 0.0) + us
        out["device_us"] += us
    out["top"] = sorted(names.items(), key=lambda kv: -kv[1])[:6]
    return out


def eager_stream(cg, blocks, key, params=None):
    """The eager one-block loop on the card, the stream's reference: the
    session's step as it ran before the block graph (``cg.fn`` on a rebound
    state whose counters are Python ints, every kernel and op launched from
    the host), over ``blocks`` [n, 128]; returns (output 0 [n*128], the
    kernels' launches of each block)."""
    import torch
    xs = torch.as_tensor(blocks, device=cg.device)
    state = cg.init_state()
    outs, per_block = [], []
    for j in range(len(blocks)):
        prev = read_launches()
        state, o, _ = cg.fn(state, {key: xs[j]}, params)
        outs.append(o[cg.output_ids[0]].expand(xs.shape[-1]))
        now = read_launches()
        per_block.append({k: now[k] - prev[k] for k in now})
    return host(torch.cat(outs)), per_block


def stream_run(name, graph, x_np, dev, card, expect, policy="fast",
               first_order=False, bounds=None) -> dict:
    """StreamSession on the card over x_np in 128-sample process() blocks
    under ``policy``, its step one captured CUDA graph replayed a block:
    bitwise the eager one-block loop on the card (``eager_stream``, whose
    every block launches ``expect`` and no plain version); the first
    process() captures (``expect`` launched twice: the warm-up and the
    capture) and every later block is a replay that launches nothing from
    the host; against
    the card's one render of x_np (STREAM_DB; bitwise under exact) and the
    CPU port's session over the first second (STREAM_CPU_DB);
    process_many in chunks of STREAM_CHUNKS blocks and in one call bitwise
    equal to process(); no kernel built on the way (the render's builds
    serve the stream); per-block wall times, the capture's time,
    process_many's real-time factor; the captured graph's nodes from its
    DOT dump, whose kernels of the port must be ``expect``; one replay by
    the profiler (a profile that lost an event rejected): its copies,
    kernels, their device times (beside ``bounds``, {instance_of: (ms,
    by)} at [1, 128]) and the device-busy share."""
    import torch
    import dsp_stuff_tpu_torch as dst
    from dsp_stuff_tpu_torch.ops import cuda_build
    builds = set(cuda_build.BUILD_DIR.glob("*.so"))
    n = len(x_np) // 128
    blocks = x_np.reshape(n, 128)
    rec = {"name": name, "policy": policy}
    want_twice = {k: 2 * v for k, v in expect.items()}
    with dst.policy(policy):
        cg = dst.compile_graph(graph, device="cuda")
        key = str(cg.input_ids[0])
        plain = {}
        with plain_versions_counted(plain, first_order=first_order):
            ref, per_block = eager_stream(cg, blocks, key)
            bad = [(j, d) for j, d in enumerate(per_block) if d != expect]
            check(not bad, f"{name} eager loop: blocks launched other than "
                           f"{expect}: {bad[:3]} ({len(bad)} blocks)")
            sess = dst.StreamSession(graph, device="cuda")
            out = np.empty(n * 128, np.float32)
            times = np.empty(n)
            torch.cuda.synchronize()
            reset_launches()
            for j in range(n):
                t0 = time.perf_counter()
                y = sess.process({key: blocks[j]})
                times[j] = time.perf_counter() - t0
                out[j * 128:(j + 1) * 128] = y[0]
                if j == 0:
                    first = read_launches()
            total = read_launches()
            rec["capture_ms"] = sess.step.capture_s * 1e3
            check(first == want_twice and total == want_twice,
                  f"{name} stream: the capture launched {first} and the "
                  f"replays {({k: total[k] - first[k] for k in total})}; "
                  f"expected {want_twice} (warm-up and capture), then none")
            check((sess.step.captures, sess.step.replays) == (1, n),
                  f"{name} stream: {sess.step.captures} captures, "
                  f"{sess.step.replays} replays for {n} blocks")
            check(bool(np.isfinite(out).all()), f"{name} stream not finite")
            check(np.array_equal(out, ref),
                  f"{name}: the replayed stream is not the eager loop: "
                  f"{dbfs(out, ref):.1f} dBFS")
            for c in STREAM_CHUNKS:
                s2 = dst.StreamSession(graph, device="cuda")
                got = np.concatenate([
                    s2.process_many({key: x_np[i * 128:(i + c) * 128]})[0]
                    for i in range(0, n, c)])
                check(np.array_equal(got, out),
                      f"{name}: process_many in chunks of {c} != process()")
            s3 = dst.StreamSession(graph, device="cuda")
            s3.process_many({key: x_np[:128]})          # captures
            gn = rec["graph"] = graph_nodes(s3, name)
            s3.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = s3.process_many({key: x_np})[0]
            rec["many_ms"] = (time.perf_counter() - t0) * 1e3
            check(np.array_equal(got, out),
                  f"{name}: process_many in one call != process()")
            ours = {k: v for k, v in expect.items() if v}
            pr = rec["profile"] = profile_block(s3, {key: blocks[0]}, gn)
        check(not plain, f"{name} stream called plain versions {plain}")
        want, _, _ = dst.compile_graph(graph, device="cuda").render(
            {key: torch.as_tensor(x_np, device=dev)})
        rec["vs_render_db"] = dbfs(out, host(want[0]))
        rec["vs_render_bitwise"] = bool(np.array_equal(out, host(want[0])))
        cpu = dst.StreamSession(graph, device="cpu")
        cpu_out = np.concatenate([cpu.process({key: blocks[j]})[0]
                                  for j in range(min(n, SR // 128))])
        rec["vs_cpu_db"] = dbfs(out[:cpu_out.size], cpu_out)
    new = set(cuda_build.BUILD_DIR.glob("*.so")) - builds
    check(not new, f"{name} stream built kernels {sorted(new)}")
    ms = times * 1e3
    rec.update(first_ms=float(ms[0]), median_ms=float(np.median(ms[1:])),
               p99_ms=float(np.percentile(ms[1:], 99)),
               launches={k: v for k, v in expect.items() if v})
    rtf = (n * 128 / SR) / (rec["many_ms"] / 1e3)
    rec["rtf"] = rtf
    # the profiled call's wall holds the profiler's own cost: the share is
    # of the unprofiled median block
    rec["busy"] = (pr["device_us"] / (rec["median_ms"] * 1e3) if pr
                   else None)
    print(f"StreamSession ({name}), {n} process() blocks of 128 = "
          f"{n * 128 / SR:g} s, {policy}, one CUDA graph replayed a block "
          f"[{card}]:")
    print(f"  bitwise the eager one-block loop on the card ({expect_str(ours)}"
          f" a block there, no plain version); process_many in chunks of "
          f"{STREAM_CHUNKS} blocks and in one call bitwise equal to "
          f"process()")
    print(f"  vs the card's one render {rec['vs_render_db']:.1f} dBFS "
          f"(bitwise: {rec['vs_render_bitwise']}; <= {STREAM_DB}); vs the CPU "
          f"port's session, first second {rec['vs_cpu_db']:.1f} dBFS "
          f"(<= {STREAM_CPU_DB})")
    print(f"  capture (warm-up included) {rec['capture_ms']:.1f} ms, once: "
          f"{expect_str(ours)} launched twice (warm-up, capture), none from "
          f"the host in {n - 1} replays; no kernel built")
    print(f"  process() wall a block: first {rec['first_ms']:.3f} ms "
          f"(capture included), then median {rec['median_ms']:.3f} ms, p99 "
          f"{rec['p99_ms']:.3f} ms (a block lasts {128 / SR * 1e3:.3f} ms at "
          f"48 kHz)")
    print(f"  process_many of {n} blocks in one call: {rec['many_ms']:.1f} ms "
          f"= {rtf:.2f}x real time")
    print(f"  the captured graph (its DOT dump): nodes {gn['kinds']}; the "
          f"port's kernels {expect_str(gn['ours'])} "
          f"({expect_str(gn['inst'])})")
    if pr is None:
        print(f"  one replayed process() by torch.profiler: not measured (no "
              f"profile of {PROFILE_TRIES} showed the graph's "
              f"{gn['kinds'].get('KERNEL', 0)} kernel nodes)")
    else:
        print(f"  one replayed process() by torch.profiler (profile "
              f"{pr['tries']}, rejected {pr['rejected']}; {pr['lead_in']} of "
              f"{PROFILE_LEAD_IN} lead-in kernels seen; {pr['events']} "
              f"device events = the graph's {gn['work']} work nodes and the "
              f"call's copy in and out): {pr['kernels']} kernels "
              f"({expect_str(pr['ours'])} of the port's), "
              f"{pr['events'] - pr['kernels']} copies and memsets: "
              f"{pr['h2d']} host-to-device, {pr['d2h']} device-to-host, "
              f"{pr['memset']} memsets ({pr['copies']}), device busy "
              f"{pr['device_us']:.1f} us, {rec['busy']:.1%} of the median "
              f"block (the profiled call's wall {pr['wall_us']:.1f} us); "
              f"most launched: {pr['top']}")
        for k, us in sorted(pr["ours_us"].items()):
            b = (bounds or {}).get(k)
            extra = (f", bound {b[0] * 1e3:.3f} us by {b[1]} "
                     f"({b[0] * 1e3 / us:.1%} of it)" if b and us > 0 else "")
            print(f"  {k} kernel at [1, 128] in the replay: {us:.3f} us "
                  f"device time ({pr['ours'][k]} launch(es)){extra}")
    rec["kernel_us"] = dict(pr["ours_us"]) if pr else {}
    rec["kernel_n"] = dict(gn["inst"])
    check(gn["ours"] == ours,
          f"{name}: the captured graph holds the kernels {gn['ours']}, not "
          f"{ours} (nodes {gn['kinds']})")
    check(rec["vs_render_db"] <= STREAM_DB,
          f"{name} stream vs render {rec['vs_render_db']:.1f} dBFS")
    if policy == "exact":
        check(rec["vs_render_bitwise"], f"{name}: the exact stream is not "
                                        f"bitwise the card's exact render")
    check(rec["vs_cpu_db"] <= STREAM_CPU_DB,
          f"{name} stream card vs CPU {rec['vs_cpu_db']:.1f} dBFS")
    return rec


def expect_str(launches: dict) -> str:
    return ", ".join(f"{k} x{v}" for k, v in sorted(launches.items()) if v) \
        or "no kernel"


def recapture_check(card) -> None:
    """A session on the card captures again when its params' structure or
    the policy change, and not when a value moves; each stretch is
    bitwise the eager loop taking the same turns; a session asked for, or
    run, while NODE_HOOK is set raises."""
    import dsp_stuff_tpu_torch as dst
    from dsp_stuff_tpu_torch.compiler import compile as tcompile
    g = bench_graph()
    gain = str(sorted(g.nodes)[1])
    blocks = (np.random.default_rng(141).standard_normal((16, 128)) * 0.3
              ).astype(np.float32)
    turns = (("fast", None), ("fast", {gain: {"level": 2.0}}),
             ("parity", {gain: {"level": 2.0}}),
             ("parity", {gain: {"level": 0.7}}))
    sess = dst.StreamSession(g, device="cuda")
    key = str(sess.cg.input_ids[0])
    got, want = [], []
    state = sess.cg.init_state()
    import torch
    xs = torch.as_tensor(blocks, device=sess.device)
    for t, (pol, params) in enumerate(turns):
        with dst.policy(pol):
            sess.params = params
            for j in range(4 * t, 4 * t + 4):
                got.append(sess.process({key: blocks[j]})[0])
                state, o, _ = sess.cg.fn(state, {key: xs[j]}, params)
                want.append(host(o[sess.cg.output_ids[0]]))
    same = np.array_equal(np.concatenate(got), np.concatenate(want))
    print(f"recapture on the card: 4 turns of 4 blocks (fast; a gain level "
          f"set; parity; the level moved): {sess.step.captures} captures, "
          f"{sess.step.replays} "
          f"replays, bitwise the eager loop taking the same turns: {same} "
          f"[{card}]")
    check(sess.step.captures == 3, f"{sess.step.captures} captures, not 3")
    check(same, "the recaptured stream is not the eager loop")
    tcompile.NODE_HOOK = lambda nid, cfg, outs: None
    try:
        for what, fn in (("a new session", lambda: dst.StreamSession(
                              g, device="cuda")),
                         ("a block", lambda: sess.process({key: blocks[0]}))):
            try:
                fn()
            except RuntimeError as e:
                check("NODE_HOOK" in str(e), f"NODE_HOOK: {e}")
            else:
                check(False, f"{what} on the card ran while NODE_HOOK was set")
    finally:
        tcompile.NODE_HOOK = None
    print("  NODE_HOOK set: a new session on the card and a block of a "
          "running one raise")


def automation_run(name, graph, node, param, values, every, x_np,
                   card, policy="fast") -> dict:
    """Slider automation on the card: a stream whose one slider
    (``node``'s ``param``) takes the next of ``values`` every ``every``
    process() blocks, a new params dict each time.  The params keep one
    structure, so the session captures once (its first block) and each
    move is a copy into the buffers the captured graph reads
    (runtime/block_graph.py).  Each session is bitwise the eager one-block
    loop taking the same values as Python floats.

    The stream runs as a live rack's audio thread does: pinned to one
    core, the garbage collector off.  The machine's cores are taken away
    now and then for a few ms, which no block's work causes
    (``host_stalls`` measures it in the same run with host-only work).  So
    the stream runs in ``AUTOMATION_TRIALS`` sessions over the same
    blocks and values, and a block counts as over the 2.667 ms a block
    lasts (a live stream's underrun without more buffering) when it runs
    over in every session: a cost of the block's own work recurs at its
    index, a stall of the machine does not.  Each session's raw count is
    printed beside it.  Times and counts are the first session's."""
    import gc
    import os
    import torch
    import dsp_stuff_tpu_torch as dst
    n = len(x_np) // 128
    blocks = x_np.reshape(n, 128)
    turns = [{str(node): {param: float(values[j // every])}}
             for j in range(n)]
    block_ms = 128 / SR * 1e3
    cores = os.sched_getaffinity(0)
    trials = []
    with dst.policy(policy):
        for _ in range(AUTOMATION_TRIALS):
            sess = dst.StreamSession(graph, device="cuda")
            key = str(sess.cg.input_ids[0])
            got, times = np.empty(n * 128, np.float32), np.empty(n)
            gc.collect()
            gc.disable()
            os.sched_setaffinity(0, {max(cores)})
            try:
                for j in range(n):
                    if j % every == 0:
                        sess.params = turns[j]
                    t0 = time.perf_counter()
                    got[j * 128:(j + 1) * 128] = sess.process(
                        {key: blocks[j]})[0]
                    times[j] = time.perf_counter() - t0
            finally:
                os.sched_setaffinity(0, cores)
                gc.enable()
            trials.append((got, times * 1e3, sess.step.captures))
        cg = sess.cg
        xs = torch.as_tensor(blocks, device=sess.device)
        state, want = cg.init_state(), []
        for j in range(n):
            state, o, _ = cg.fn(state, {key: xs[j]}, turns[j])
            want.append(host(o[cg.output_ids[0]]))
    want = np.concatenate(want)
    got, ms, captures = trials[0]
    moved = np.arange(every, n, every)
    steady = np.setdiff1d(np.arange(1, n), moved)
    raw = [np.nonzero(t[1][1:] > block_ms)[0] + 1 for t in trials]
    every_session = np.nonzero(np.min([t[1] for t in trials], axis=0)[1:]
                               > block_ms)[0] + 1
    rec = {"blocks": n, "every": every, "policy": policy,
           "captures": [t[2] for t in trials], "first_ms": float(ms[0]),
           "moved_median_ms": float(np.median(ms[moved])),
           "moved_p99_ms": float(np.percentile(ms[moved], 99)),
           "moved_max_ms": float(ms[moved].max()),
           "steady_median_ms": (float(np.median(ms[steady])) if len(steady)
                                else None),
           "steady_p99_ms": (float(np.percentile(ms[steady], 99))
                             if len(steady) else None),
           "over": int(len(every_session)),
           "over_raw": [[(int(j), float(t[1][j])) for j in r]
                        for r, t in zip(raw, trials)],
           "wall_s": float(ms.sum() / 1e3), "audio_s": n * 128 / SR,
           "bitwise": [bool(np.array_equal(t[0], want)) for t in trials]}
    gn = graph_nodes(sess, f"automation {name}")
    rec["graph"] = {k: gn[k] for k in ("kinds", "ours", "inst")}
    print(f"slider automation ({name}): {node}'s {param} set anew every "
          f"{every} block{'s' if every > 1 else ''} over {n} process() "
          f"blocks ({rec['audio_s']:.3f} s of audio), {policy}, "
          f"{AUTOMATION_TRIALS} sessions [{card}]:")
    steady_s = ("every block moved" if not len(steady) else
                f"the other blocks median {rec['steady_median_ms']:.3f} ms, "
                f"p99 {rec['steady_p99_ms']:.3f} ms")
    print(f"  captures {rec['captures']} for 1 params structure; the first "
          f"block (the capture) {rec['first_ms']:.3f} ms; a moved block "
          f"median {rec['moved_median_ms']:.3f} ms, p99 "
          f"{rec['moved_p99_ms']:.3f} ms, max {rec['moved_max_ms']:.3f} ms; "
          f"{steady_s}; blocks after the first over the {block_ms:.3f} ms a "
          f"block lasts: {[len(r) for r in raw]} in each session "
          f"{[r[:8] for r in rec['over_raw']]}, {rec['over']} in every "
          f"session; "
          f"{rec['wall_s']:.3f} s wall; bitwise the eager loop taking the "
          f"same values: {rec['bitwise']}; the captured step (its DOT dump): "
          f"nodes {gn['kinds']}, the port's kernels {expect_str(gn['ours'])}")
    check(all(c == 1 for c in rec["captures"]),
          f"{name} automation: captures {rec['captures']} for one params "
          f"structure")
    check(all(rec["bitwise"]), f"{name} automation is not the eager loop: "
          f"{dbfs(got, want):.1f} dBFS")
    check(rec["over"] == 0, f"{name} automation: {rec['over']} blocks after "
          f"the first over {block_ms:.3f} ms in every session")
    return rec


def host_stalls(seconds, card) -> dict:
    """The machine's own stalls, the witness for ``automation_run``'s
    sessions: host-only work (NumPy, no CUDA) in iterations of 0.5 ms for
    ``seconds``, on one pinned core with the garbage collector off, as
    the automated streams run; the iterations that took over 1.5 ms and
    over the 2.667 ms a block lasts, and the longest."""
    import gc
    import os
    a = np.random.default_rng(0).standard_normal(4096)
    cores = os.sched_getaffinity(0)
    its = []
    gc.disable()
    os.sched_setaffinity(0, {max(cores)})
    try:
        end = time.perf_counter() + seconds
        while time.perf_counter() < end:
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < 0.5e-3:
                a = np.sin(a)
            its.append(time.perf_counter() - t0)
    finally:
        os.sched_setaffinity(0, cores)
        gc.enable()
    ms = np.array(its) * 1e3
    rec = {"iterations": len(ms), "over_1.5": int((ms > 1.5).sum()),
           "over_block": int((ms > 128 / SR * 1e3).sum()),
           "max_ms": float(ms.max())}
    print(f"the machine's stalls: {rec['iterations']} iterations of 0.5 ms "
          f"host-only work over {seconds} s on one pinned core: "
          f"{rec['over_1.5']} over 1.5 ms, {rec['over_block']} over "
          f"{128 / SR * 1e3:.3f} ms, the longest {rec['max_ms']:.3f} ms "
          f"[{card}]")
    return rec


def tensor_slider_check(card) -> None:
    """The bench chain's sliders as CUDA tensors, edited in place every
    block, under fast and parity: one capture a session, each block a
    copy of the tensors into the step's buffers (under parity the low-
    and high-pass solves build their powers on the card: no host read in
    the capture), bitwise the eager loop taking the same tensors."""
    import torch
    import dsp_stuff_tpu_torch as dst
    g = bench_graph()
    sliders = {"gain": "level", "biquad": "a1", "overdrive": "drive",
               "low_pass": "ratio", "high_pass": "ratio",
               "distort": "level", "chebyshev": "level_pos",
               "reverb": "decay"}
    ids = {cn: str(i) for i, nd in sorted(g.nodes.items())
           for cn in sliders if nd.cfg_name == cn}
    rng = np.random.default_rng(151)
    blocks = (rng.standard_normal((12, 128)) * 0.3).astype(np.float32)
    for pol in ("fast", "parity"):
        with dst.policy(pol):
            sess = dst.StreamSession(g, device="cuda")
            base = {ids[cn]: {n: float(g.nodes[int(ids[cn])].params[n])}
                    for cn, n in sliders.items()}
            live = {nid: {n: torch.tensor(v, device=sess.device)
                          for n, v in e.items()} for nid, e in base.items()}
            sess.params = live
            key = str(sess.cg.input_ids[0])
            xs = torch.as_tensor(blocks, device=sess.device)
            state, got, want = sess.cg.init_state(), [], []
            for j in range(len(blocks)):
                scale = 1.0 + 0.05 * np.sin(j)
                for nid, e in live.items():
                    for n, t in e.items():
                        t.fill_(base[nid][n] * scale)
                got.append(sess.process({key: blocks[j]})[0])
                state, o, _ = sess.cg.fn(state, {key: xs[j]}, live)
                want.append(host(o[sess.cg.output_ids[0]]))
            same = np.array_equal(np.concatenate(got), np.concatenate(want))
        print(f"tensor sliders on the card ({len(sliders)} of the bench "
              f"chain, edited in place every block, {pol}): "
              f"{sess.step.captures} capture(s), {sess.step.replays} "
              f"replays, bitwise the eager loop taking the same tensors: "
              f"{same} [{card}]")
        check(sess.step.captures == 1,
              f"tensor sliders, {pol}: {sess.step.captures} captures")
        check(same, f"tensor sliders, {pol}: not the eager loop")


def automation_values(base, n, lo, hi):
    """n slider values swept around ``base`` inside [lo, hi], a new one a
    block (no two neighbours equal)."""
    v = base * (1.0 + 0.25 * np.sin(2.0 * np.pi * np.arange(n) / 97.0)
                + 0.01 * (np.arange(n) % 2))
    return [float(x) for x in np.clip(v, lo, hi)]


def ring_check(graph) -> None:
    """The ring API on the card: 1 s of a 220 Hz tone fed in irregular
    64-400-sample capture chunks (examples/streaming.py), pumped, and
    drained at 44.1 kHz stereo; then resync.  Each read is as long as
    asked and finite, an underrun is silence, resync empties the input
    rings and arms the catch-up counter."""
    import dsp_stuff_tpu_torch as dst
    with dst.policy("fast"):
        sess = dst.StreamSession(graph, device="cuda")
        inp, out = sess.cg.input_ids[0], sess.cg.output_ids[0]
        rng = np.random.default_rng(0)
        sig = (np.sin(2 * np.pi * 220.0 * np.arange(SR) / SR) * 0.5
               ).astype(np.float32)
        pos, n_dev, reads, silent = 0, 200, 0, 0
        while pos < SR:
            k = int(rng.integers(64, 400))
            sess.feed(inp, sig[pos:pos + k])
            pos += k
            while sess.pump():
                pass
            rs = sess._resamplers.get((out, 44_100))
            short = rs is not None and (sess.out_rings[out].readable
                                        < rs.input_needed(n_dev))
            y = sess.drain_output(out, n_dev, device_rate=44_100, stereo=True)
            check(y.shape == (2 * n_dev,) and bool(np.isfinite(y).all()),
                  f"ring read {reads}: shape {y.shape} or not finite")
            check(not short or not y.any(), "an underrun was not silent")
            reads += 1
            silent += int(not y.any())
        sess.feed(inp, sig[:100])
        sess.resync()
        check(all(r.readable == 0 for r in sess.in_rings.values())
              and sess._catchup[out] == 5, "resync left input or no catch-up")
    print(f"ring API on the card: {pos} samples fed in 64-400-sample chunks, "
          f"{reads} reads of {n_dev} stereo frames at 44.1 kHz ({silent} "
          f"silent underruns), resync drained the input rings")


def cli_check(dev, card) -> None:
    """render_file and ``python -m dsp_stuff_tpu_torch render`` of config5
    over a 10 s noise WAV on the card (a subprocess; the kernels are built
    by the earlier phases, so its time holds no nvcc): the WAV bitwise the
    in-process render_file's, also with --out-rate 44100 --stereo; nodes
    and inspect exit 0."""
    import dsp_stuff_tpu_torch as dst
    from dsp_stuff_tpu_torch.io import native, wav as wav_io
    os.makedirs(RUNTIME_DIR, exist_ok=True)
    g_json = os.path.join(ROOT, "examples", "graphs", "config5.json")
    in_wav = os.path.join(RUNTIME_DIR, "noise_10s.wav")
    wav_io.write_wav(in_wav, (np.random.default_rng(101).standard_normal(
        T_MAIN) * 0.3).astype(np.float32))
    print("host library: " + ("built from native/dsp_host.cpp" if
                              native.available() else
                              "not built: the NumPy ring and resampler"))
    for extra, kw in (((), {}), (("--out-rate", "44100", "--stereo"),
                                 {"out_rate": 44_100, "stereo_out": True})):
        out_wav = os.path.join(RUNTIME_DIR, f"cli_{len(extra)}.wav")
        t0 = time.time()
        r = subprocess.run([sys.executable, "-m", "dsp_stuff_tpu_torch",
                            "render", g_json, "--in", in_wav, "--out",
                            out_wav, "--policy", "fast", *extra], cwd=ROOT,
                           capture_output=True, text=True, timeout=600)
        wall = time.time() - t0
        check(r.returncode == 0, f"CLI render {extra} exit {r.returncode}: "
                                 f"{r.stderr[-2000:]}")
        data, rate = wav_io.read_wav(out_wav)
        with dst.policy("fast"):
            t0 = time.time()
            want, _ = dst.render_file(g_json, in_wav, device="cuda", **kw)
            t_in = time.time() - t0
        print(f"CLI render config5 10 s {' '.join(extra) or '(48 kHz mono)'}"
              f": exit 0 in {wall:.2f} s wall (a new process; nvcc not "
              f"included), {data.shape} at {rate} Hz, bitwise the in-process "
              f"render_file's ({t_in:.2f} s) [{card}]; "
              f"{r.stdout.strip().splitlines()[0]}")
        check(np.array_equal(data, want), f"CLI render {extra} != render_file")
    for args in (["nodes"], ["inspect", g_json]):
        r = subprocess.run([sys.executable, "-m", "dsp_stuff_tpu_torch",
                            *args], cwd=ROOT, capture_output=True, text=True,
                           timeout=300)
        check(r.returncode == 0, f"CLI {args[0]} exit {r.returncode}")
    print("CLI nodes and inspect: exit 0")


def checkpoint_check(dev) -> None:
    """config5 over 4 streams: 5 s rendered, its state saved, loaded on the
    card, 5 s more, against one 10 s render (HANDOFF_DB)."""
    import torch
    import dsp_stuff_tpu_torch as dst
    from dsp_stuff_tpu_torch.models import presets
    g5, _ = presets.config5_feedback_16node()
    x = torch.as_tensor((np.random.default_rng(111).standard_normal(
        (4, 1, T_MAIN)) * 0.3).astype(np.float32), device=dev)
    half = T_MAIN // 2
    path = os.path.join(RUNTIME_DIR, "config5_5s.npz")
    with dst.policy("fast"):
        cg = dst.compile_graph(g5, device="cuda")
        full, _, _ = cg.render(x, batch_shape=(4,))
        a, _, st = cg.render(x[..., :half].contiguous(), batch_shape=(4,))
        dst.save_checkpoint(path, g5, state=st, meta={"t": half})
        g2, st2, _, meta = dst.load_checkpoint(path, device="cuda")
        b, _, _ = dst.compile_graph(g2, device="cuda").render(
            x[..., half:].contiguous(), state=st2, batch_shape=(4,))
    d = dbfs(host(torch.cat([a, b], dim=-1)), host(full))
    print(f"checkpoint on the card: config5, 4 x 5 s, saved, loaded, 5 s more "
          f"vs one 10 s render: {d:.1f} dBFS (meta {meta})")
    check(d <= HANDOFF_DB, f"checkpoint resume {d:.1f} dBFS")


def pitch_check(dev) -> None:
    """A 440 Hz tone (4 streams x 1 s, four phases) through a pitch node on
    the card: every window voiced, within PITCH_HZ_ATOL, note "A 4";
    against the CPU port, voicing equal and frequency within PITCH_RTOL."""
    import dsp_stuff_tpu_torch as dst
    from dsp_stuff_tpu_torch.ids import IdSpace
    from dsp_stuff_tpu_torch.ops.pitch_mpm import note_name
    g = dst.Graph(IdSpace())
    inp = g.add("input")
    pt = g.add("pitch")
    g.connect(inp, "out", pt, "in")
    t = np.arange(SR) / SR
    x = np.stack([0.5 * np.sin(2 * np.pi * 440.0 * t + ph)
                  for ph in (0.0, 0.7, 1.9, 3.0)]).astype(np.float32)[:, None]
    res = {}
    for d in ("cuda", "cpu"):
        _, aux, _ = dst.compile_graph(g, device=d).render(x, batch_shape=(4,))
        res[d] = {k: v.cpu().numpy() for k, v in aux[f"pitch:{pt.id}"].items()}
    k, c = res["cuda"], res["cpu"]
    err = float(np.abs(k["frequency"] - 440.0).max())
    names = {note_name(nr) for nr in k["note_nr"].ravel()}
    rel = float(np.abs(k["frequency"] / c["frequency"] - 1.0).max())
    print(f"pitch on the card, 4 x 1 s at 440 Hz: {k['voiced'].sum()} of "
          f"{k['voiced'].size} windows voiced, max |f - 440| {err:.3f} Hz, "
          f"notes {sorted(names)}; vs the CPU port: voicing "
          f"{'equal' if np.array_equal(k['voiced'], c['voiced']) else 'DIFFERS'}"
          f", frequency within {rel:.1e}")
    check(bool(k["voiced"].all()), "pitch: a window unvoiced")
    check(err <= PITCH_HZ_ATOL, f"pitch off by {err:.3f} Hz")
    check(names == {"A 4"}, f"pitch notes {names}")
    check(np.array_equal(k["voiced"], c["voiced"]), "pitch voicing differs")
    check(rel <= PITCH_RTOL, f"pitch card vs CPU {rel:.1e}")


def debug_check(card) -> None:
    """debug_render of config5 over 1 s of noise on the card: every node
    with an output reported, no NaN or Inf; the slowest nodes."""
    import dsp_stuff_tpu_torch as dst
    from dsp_stuff_tpu_torch.models import presets
    from dsp_stuff_tpu_torch.utils import obs
    g5, _ = presets.config5_feedback_16node()
    x = (np.random.default_rng(121).standard_normal((1, SR)) * 0.3
         ).astype(np.float32)
    t0 = time.time()
    with dst.policy("fast"):
        outs, report = obs.debug_render(g5, x, device="cuda")
    wall = time.time() - t0
    want = {nid for nid, n in g5.nodes.items() if n.spec.outputs}
    got = {r["node"] for r in report}
    bad = [r for r in report if r["nan"] or r["inf"]]
    slow = sorted(report, key=lambda r: -r["ms"])[:3]
    print(f"debug_render(config5, device=\"cuda\"), 1 s: {len(got)} of "
          f"{len(want)} nodes with outputs reported, {len(bad)} with NaN or "
          f"Inf, {wall:.2f} s; slowest "
          f"{[(r['cfg'], round(r['ms'], 2)) for r in slow]} ms [{card}]")
    check(got == want, f"debug_render reported {sorted(got)}, not "
                       f"{sorted(want)}")
    check(not bad and bool(np.isfinite(outs).all()),
          f"debug_render NaN or Inf: {bad}")


def runtime_phase(dev, card) -> dict:
    """The runtime on the card: the divides, the kernels at the stream's
    shapes, StreamSession over the bench chain and config5, the ring API,
    render_file and the CLI, checkpoints, pitch and debug_render."""
    from dsp_stuff_tpu_torch.models import presets
    print("true f32 divides, card vs CPU port:")
    divide_checks(dev)
    print("kernels at the stream's shapes vs plain:")
    stream_kernel_checks(dev)
    rng = np.random.default_rng(131)
    g5 = presets.config5_feedback_16node()[0]
    stages5 = planned_stages(g5)[0]
    program5 = cycle_program(g5)[0]
    recs = {}
    for name, g, T, expect, first_order, bnds in (
            ("bench chain", bench_graph(), STREAM_BENCH_SAMPLES,
             only_launches(chain=1),
             False, {"chain": chain_bound(bench_stages(), 1, 128)}),
            ("config5", g5, STREAM_C5_SAMPLES,
             only_launches(chain=1, cycle=1, envelope=1, pointwise=3,
                           oscillator=1), False,
             {"chain": chain_bound(stages5, 1, 128),
              "cycle": cycle_bound(program5, 1, 128),
              "envelope": bound(8.0 * 128, 3.0 * 128),
              "oscillator": osc_bound(1, 128)}),
            ("muff", muff_graph(), SR,
             only_launches(first_order=1, pointwise=1), True,
             {"first_order": bound(8.0 * 128, 2.0 * 128)})):
        x = (rng.standard_normal(T) * 0.3).astype(np.float32)
        recs[name] = stream_run(name, g, x, dev, card, expect,
                                first_order=first_order, bounds=bnds)
    # config5 under parity over 1 s: the feedback cycle's per-node scan
    # inside the captured step, its two groups a block
    recs["config5 parity"] = stream_run(
        "config5 parity", g5, (np.random.default_rng(133).standard_normal(SR)
                               * 0.3).astype(np.float32), dev, card,
        only_launches(envelope=1, pointwise=5, oscillator=1),
        policy="parity",
        bounds={"envelope": bound(8.0 * 128, 3.0 * 128),
                "oscillator": osc_bound(1, 128)})
    recapture_check(card)
    tensor_slider_check(card)
    recs["host stalls"] = host_stalls(AUTOMATION_STALL_S, card)
    g = bench_graph()
    gain = sorted(g.nodes)[1]
    n_auto = SR // 128
    recs["automation bench"] = automation_run(
        "bench chain", g, gain, "level",
        [1.0 + 0.01 * i for i in range(-(-n_auto // AUTOMATION_EVERY))],
        AUTOMATION_EVERY, (rng.standard_normal(n_auto * 128) * 0.3)
        .astype(np.float32), card)
    fbg = next(i for i, nd in sorted(g5.nodes.items())
               if nd.cfg_name == "gain" and nd.params["level"] == 0.45)
    recs["automation config5"] = automation_run(
        "config5", g5, fbg, "level", AUTOMATION_C5_LEVELS,
        AUTOMATION_C5_EVERY, (rng.standard_normal(
            len(AUTOMATION_C5_LEVELS) * AUTOMATION_C5_EVERY * 128) * 0.3)
        .astype(np.float32), card)
    # a slider moved every block: the bench chain's gain (its head), its
    # overdrive's drive (the middle of the chain), config5's feedback gain
    # (inside the SCC) and its envelope's attack, the exact bench chain's
    # low-pass ratio
    of = {cn: next(i for i, nd in sorted(gr.nodes.items())
                   if nd.cfg_name == cn)
          for gr, cn in ((g, "overdrive"), (g, "low_pass"))}
    env5 = next(i for i, nd in sorted(g5.nodes.items())
                if nd.cfg_name == "envelope")
    for label, gr, nid, param, base, lo, hi, secs, pol in (
            ("bench chain", g, gain, "level", 1.2, 0.0, 10.0,
             AUTOMATION_BENCH_S, "fast"),
            ("bench chain overdrive", g, of["overdrive"], "drive", 0.6, 0.0,
             1.0, 1, "fast"),
            ("config5 feedback", g5, fbg, "level", 0.45, 0.0, 10.0,
             AUTOMATION_C5_S, "fast"),
            ("config5 envelope", g5, env5, "attack", 50.0, 0.0, 1000.0,
             AUTOMATION_C5_S, "fast"),
            ("exact bench chain low-pass", g, of["low_pass"], "ratio", 0.6,
             0.0, 1.0, 1, "exact")):
        n = secs * SR // 128
        recs[f"automation {label} every block"] = automation_run(
            label, gr, nid, param, automation_values(base, n, lo, hi), 1,
            (rng.standard_normal(n * 128) * 0.3).astype(np.float32), card,
            policy=pol)
    # a moved feedback gain takes config5's cycle off its block program:
    # the per-node scan's two groups in the captured step
    for label in ("config5", "config5 feedback every block"):
        got = recs[f"automation {label}"]["graph"]["ours"]
        check(got.get("pointwise") == 5,
              f"automation {label}: the captured step holds the kernels "
              f"{got}, expected five pointwise groups (three and the "
              f"cycle's two)")
    ring_check(g5)
    cli_check(dev, card)
    checkpoint_check(dev)
    pitch_check(dev)
    debug_check(card)
    return recs


# -- the exact policy on the card ---------------------------------------------

def seq_array(arr, dev, offset=0):
    """``arr`` as a float32 tensor on ``dev`` that starts ``offset`` floats
    into its storage (1: not 16-byte aligned)."""
    import torch
    arr = torch.as_tensor(np.asarray(arr, np.float32))
    flat = torch.empty(arr.numel() + offset, dtype=torch.float32, device=dev)
    t = flat[offset:].view(arr.shape)
    t.copy_(arr)
    return t


def seq_inputs(mode, R, T, rng, dev, offset=0):
    """The sequential kernel's inputs in ``mode`` (SEQ_MODES) at [R, T] on
    ``dev``: (a, b, y0) for the first order, (x, coeffs, state [R, 4]) for
    the biquad.  ``offset`` floats shift the start of every [R, T] array
    (1: not 16-byte aligned, the kernel's single-float copies)."""
    import torch

    def on_dev(arr):
        return seq_array(arr, dev, offset)

    x = on_dev(rng.standard_normal((R, T)) * 0.5)
    if mode == "biquad":
        return (x, torch.tensor(SEQ_COEFFS, dtype=torch.float32, device=dev),
                on_dev(rng.standard_normal((R, 4)) * 0.3))
    a = (on_dev(rng.uniform(-0.99, 0.99, (R, T)))
         if mode == "first_order:per-sample"
         else torch.tensor(SEQ_A, dtype=torch.float32, device=dev))
    return a, x, on_dev(rng.standard_normal(R) * 0.3)


def seq_kernel(mode, ins):
    """(y, final state) of the sequential kernel on ``ins``."""
    from dsp_stuff_tpu_torch.ops import sequential_kernel
    if mode == "biquad":
        return sequential_kernel.biquad_sequential_cuda(*ins)
    return sequential_kernel.first_order_sequential_cuda(*ins)


def seq_plain(mode, ins):
    """(y, final state) of the kernel's plain version on ``ins``."""
    import torch
    from dsp_stuff_tpu_torch.ops import scan
    if mode == "biquad":
        x, c, st = ins
        y, fin = scan._biquad_sequential(x, *c.unbind(0), tuple(st.unbind(1)))
        return y, torch.stack(fin, dim=1)
    y = scan._first_order_sequential(*ins)
    return y, y[:, -1]


def seq_compare(mode, ins, label: str, loud: bool):
    """The sequential kernel against its plain version on ``ins``, bit for
    bit (y and the final state); returns (the max abs difference, 0, and
    the plain version's one call in ms, by CUDA events)."""
    import torch
    k = seq_kernel(mode, ins)
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    p = seq_plain(mode, ins)
    t1.record()
    torch.cuda.synchronize()
    err = max(float((a - b).abs().max()) for a, b in zip(k, p))
    same = all(torch.equal(a, b) for a, b in zip(k, p))
    if loud:
        print(f"  {mode:24s} {label}: max abs {err:.1e}, bitwise {same}")
    check(same, f"sequential kernel {mode} {label}: not bitwise its plain "
                f"version (max abs {err:.2e})")
    return err, t0.elapsed_time(t1)


def seq_window(mode, ins, y, start: int, stop: int):
    """The inputs of ``mode``'s solve (seq_inputs) over samples [start,
    stop), started from the state the kernel's output ``y`` holds before
    ``start`` (the inputs' own state at 0)."""
    import torch
    if mode == "biquad":
        x, c, st = ins
        if start:
            st = torch.stack([x[:, start - 1], x[:, start - 2],
                              y[:, start - 1], y[:, start - 2]], dim=1)
        return x[:, start:stop], c, st
    a, b, y0 = ins
    return (a[:, start:stop] if a.dim() else a, b[:, start:stop],
            y[:, start - 1] if start else y0)


def seq_compare_windows(mode, ins, label: str):
    """The sequential kernel over all of ``ins`` against its plain version
    on two windows of the same inputs, bit for bit: the first
    SEQ_PLAIN_PREFIX samples from the inputs' state, and the last
    SEQ_PLAIN_LATE from the kernel's own state there (y and the final
    state).  Returns (the max abs difference, the plain version's prefix
    call in ms by CUDA events, its samples)."""
    import torch
    y, fin = seq_kernel(mode, ins)
    T = y.shape[-1]
    p, late = min(SEQ_PLAIN_PREFIX, T), max(0, T - SEQ_PLAIN_LATE)
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    yp, _ = seq_plain(mode, seq_window(mode, ins, y, 0, p))
    t1.record()
    yl, fl = seq_plain(mode, seq_window(mode, ins, y, late, T))
    torch.cuda.synchronize()
    pairs = [(y[:, :p], yp), (y[:, late:], yl), (fin, fl)]
    err = max(float((a - b).abs().max()) for a, b in pairs)
    same = all(torch.equal(a, b) for a, b in pairs)
    print(f"  {mode:24s} {label}: samples [0, {p}) and [{late}, {T}) from "
          f"the kernel's state, and the final state: max abs {err:.1e}, "
          f"bitwise {same}")
    check(same, f"sequential kernel {mode} {label}: not bitwise its plain "
                f"version on its windows (max abs {err:.2e})")
    return err, t0.elapsed_time(t1), p


def seq_check(mode, R, T, rng, dev, offset=0) -> float:
    """seq_compare on seq_inputs(mode, R, T, rng, dev, offset); returns the
    max abs difference (0)."""
    label = f"[{R}, {T}]" + (" unaligned" if offset else "")
    return seq_compare(mode, seq_inputs(mode, R, T, rng, dev, offset), label,
                       R * T >= SEQ_B * SEQ_T or bool(offset))[0]


def seq_floor_ms(mode, T) -> float:
    """The dependent chain's floor of a row of T steps (any number of
    rows): SEQ_CHAIN_OPS FP32 operations a step, 4 cycles each."""
    return T * SEQ_CHAIN_OPS[mode] * 4 / (SM_CLOCK_GHZ * 1e9) * 1e3


def seq_bound(mode, R, T):
    """The bound of one solve at [R, T]: its signal read and y written
    (and a per-sample a read), its FP32 operations."""
    n_bytes = 4.0 * R * T * (3 if mode == "first_order:per-sample" else 2)
    flops = (9.0 if mode == "biquad" else 2.0) * R * T
    return bound(n_bytes, flops)


#: the exact bench chain's solves in one stream block, by the sequential
#: kernel's template instance: low_pass and high_pass (first order, mode
#: 0) and the biquad (mode 2), each over [1, 128]
EXACT_BLOCK = {"sequential<0>": ("first_order", 2),
               "sequential<2>": ("biquad", 1)}


def exact_block_bounds():
    """Each instance's bound in one exact stream block: seq_bound of its
    solves, taken as rows of one solve."""
    return {k: seq_bound(mode, n, 128) for k, (mode, n) in EXACT_BLOCK.items()}


def sequential_launches(cg, T: int) -> int:
    """The sequential kernel's launches of an exact render of T samples:
    one a recurrence node (biquad, low pass, high pass, muff), one a block
    for a member of a feedback cycle (the per-node block scan)."""
    from dsp_stuff_tpu_torch.compiler.compile import _is_cycle
    n = 0
    for comp in cg._sccs:
        rec = sum(cg._nodes[nid].cfg_name in ("biquad", "low_pass",
                                              "high_pass", "muff")
                  for nid in comp)
        n += rec * (T // cg.block_size if _is_cycle(cg.graph, comp) else 1)
    return n


def oracle_evaluate(graph, ext, T: int):
    """tests/oracle/graph.py's block-wise interpreter over the port's graph:
    its loop, per-node steps and states (oracle_graph._init_state, _step),
    with the port's copies of the three helpers that function imports from
    the JAX package (SCC order, active nodes, ParamSpec), so that nothing
    of the JAX package is imported.  ext {input id: [T] f32}; returns
    {output id: [T] f32}."""
    from oracle import graph as og
    import oracle
    from dsp_stuff_tpu_torch.compiler.compile import _active_nodes
    from dsp_stuff_tpu_torch.compiler.scc import condensation_topo_order
    from dsp_stuff_tpu_torch.registry import ParamSpec
    F32 = np.float32
    B = og.BUF
    active = _active_nodes(graph)
    nodes = {nid: n for nid, n in graph.nodes.items() if nid in active}
    edges = {nid: set() for nid in nodes}
    for l in graph.links:
        if l.src in nodes and l.dst in nodes:
            edges[l.src].add(l.dst)
    comps = condensation_topo_order(sorted(nodes), edges)
    states = {nid: og._init_state(n) for nid, n in nodes.items()}
    out_ids = [nid for nid, n in nodes.items()
               if getattr(n.spec.impl, "graph_output", False)]
    outs = {nid: np.zeros(T, F32) for nid in out_ids}
    prev: dict = {}
    zero = np.zeros(B, F32)
    for b0 in range(0, T, B):
        cur: dict = {}

        def port_avg(nid, port):
            srcs = [cur.get((l.src, l.src_port), prev.get((l.src, l.src_port),
                                                          zero))
                    for l in graph.in_links(nid, port)]
            return (og._h(srcs), len(srcs)) if srcs else (zero, 0)

        for comp in comps:
            for nid in sorted(comp):
                spec = nodes[nid].spec
                if getattr(spec.impl, "graph_input", False):
                    cur[(nid, "out")] = np.asarray(ext[nid][b0:b0 + B], F32)
                    continue
                if spec.is_sink or getattr(spec.impl, "graph_output", False):
                    continue
                ins = {port: port_avg(nid, port)[0] for port in spec.inputs}
                params = {}
                for ps in spec.params:
                    value = nodes[nid].params[ps.name]
                    if isinstance(ps, ParamSpec) and ps.as_input:
                        sig, n = port_avg(nid, ps.name)
                        params[ps.name] = (oracle.mod_map(sig, ps.lo, ps.hi)
                                           if n else F32(value))
                    else:
                        params[ps.name] = (F32(value) if isinstance(
                            ps, ParamSpec) else value)
                for port, val in og._step(nodes[nid], states[nid], ins,
                                          params).items():
                    cur[(nid, port)] = val
        for nid in out_ids:
            outs[nid][b0:b0 + B] = port_avg(nid, "in")[0]
        prev = cur
    return outs


def exact_render(graph, x, B, expect, name, dev, finite=True):
    """An exact render of x [B, 1, T] (NumPy) on the card, its launches
    ``expect`` and no plain version called, finite unless ``finite`` is
    False, a graph with a cycle rendered again through the replayed
    cycle loop, bitwise; returns (outputs, CompiledGraph, wall s, peak
    GiB, the sequential kernel's launches by mode)."""
    import torch
    import dsp_stuff_tpu_torch as dst
    from dsp_stuff_tpu_torch.compiler.compile import _is_cycle
    from dsp_stuff_tpu_torch.ops import sequential_kernel
    with dst.policy("exact"):
        cg = dst.compile_graph(graph, device="cuda")
        # the Python loop over a cycle's blocks first, whose launches the
        # host counts (sequential_launches)
        cg.cycle_loops.route = "eager"
        xd = torch.as_tensor(x, device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        plain, modes = {}, {}
        reset_launches()
        t0 = time.time()
        with plain_versions_counted(plain, first_order=True), calls_counted(
                [(sequential_kernel, "first_order_sequential_cuda"),
                 (sequential_kernel, "biquad_sequential_cuda")], modes):
            y, _, _ = cg.render(xd, batch_shape=(B,))
            torch.cuda.synchronize()
        wall = time.time() - t0
        launches = read_launches()
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    if any(_is_cycle(graph, comp) for comp in cg._sccs):
        # again with the cycles' block loops replayed as CUDA graphs
        # (whatever their length), bitwise the Python loop
        with dst.policy("exact"):
            cg.cycle_loops.route = "buffers"
            again, _, _ = cg.render(xd, batch_shape=(B,))
        check(torch.equal(again.view(torch.int32), y.view(torch.int32)),
              f"{name} under exact: the replayed cycle loop differs from "
              f"the Python loop")
    check(not plain, f"{name} under exact called plain versions {plain}")
    check(launches == expect, f"{name} under exact launched {launches}, "
                              f"expected {expect}")
    check(sum(modes.values()) == launches["sequential"],
          f"{name}: the sequential kernel's launches {modes} by mode")
    check(not finite or bool(torch.isfinite(y).all()),
          f"{name} under exact not finite")
    by_mode = {"first_order": modes.get("first_order_sequential_cuda", 0),
               "biquad": modes.get("biquad_sequential_cuda", 0)}
    return y, cg, wall, peak, by_mode


def cpu_exact(graph, x):
    """The CPU port's exact render of x [B, 1, T] (NumPy)."""
    import dsp_stuff_tpu_torch as dst
    with dst.policy("exact"):
        y, _, _ = dst.compile_graph(graph, device="cpu").render(
            x, batch_shape=(len(x),))
    return host(y)


def held(name, got, want, limit) -> float:
    """dBFS of got against want, printed with whether it is bitwise, held
    to ``limit``."""
    d = dbfs(got, want)
    print(f"  {name}: {d:.1f} dBFS (<= {limit}), bitwise "
          f"{bool(np.array_equal(got, want))}")
    check(d <= limit, f"{name}: {d:.1f} dBFS > {limit}")
    return d


def finite_dbfs(name, got, want) -> float:
    """dbfs over the samples where ``want`` is finite, after checking that
    ``got`` holds the same non-finite values (a feedback loop whose gain
    passes 1 overflows in both) everywhere else."""
    bad = ~np.isfinite(want)
    check(np.array_equal(~np.isfinite(got), bad)
          and np.array_equal(got[bad], want[bad], equal_nan=True),
          f"{name}: the non-finite samples differ")
    if np.array_equal(got[~bad], want[~bad]):
        return float("-inf")          # also where both are silent
    return dbfs(got[~bad], want[~bad])


def exact_phase(dev, card, b_main=B_MAIN, t_main=T_MAIN) -> dict:
    """The exact policy on the card: the sequential kernel bit for bit
    against its plain version (SEQ_MODES at [SEQ_B, SEQ_T], the edge
    shapes, unaligned rows); the bench chain over b_main x t_main (three
    launches, no chain kernel, no plain version; against the oracle and the
    CPU port's exact render; wall time and peak memory), config5 and the
    exact-pool fuzz graphs at B_EXACT x 1 s against the oracle and the CPU
    port, the bench chain streamed over 1 s bitwise its render, and the
    kernel at [b_main, t_main], timed there, bit for bit against its plain
    version on a prefix and a late window of the same inputs
    (seq_compare_windows; the plain version timed on the prefix); first
    the divide fence by a Python number, bitwise the CPU's."""
    import torch
    import dsp_stuff_tpu_torch as dst
    import test_torch_fuzz_gen as gen
    from bench import oracle_chain
    from dsp_stuff_tpu_torch.models import presets
    from dsp_stuff_tpu_torch.utils import precision
    t_phase = time.time()
    rec = {}
    # the divide fence by a Python number on the card: a true divide (by a
    # device scalar), bitwise the CPU's
    xq = (np.random.default_rng(95).standard_normal(1 << 16)
          * 3).astype(np.float32)
    for d in (3.0, 0.1, 48000.0):
        for fn in (precision.div_ieee, precision.exact_div):
            check(np.array_equal(host(fn(torch.as_tensor(xq, device=dev), d)),
                                 fn(torch.from_numpy(xq), d).numpy()),
                  f"{fn.__name__}(x, {d}) on the card: not bitwise the CPU's")
    print("div_ieee and exact_div by 3.0, 0.1 and 48000.0 on the card: "
          "bitwise the CPU's")
    rng = np.random.default_rng(90)
    print(f"sequential kernel vs plain, bitwise, [{SEQ_B}, {SEQ_T}], edge "
          f"shapes {SEQ_EDGE_SHAPES}, tile edges {SEQ_TILE_SHAPES}, "
          f"unaligned rows:")
    for mode in SEQ_MODES:
        errs = [seq_check(mode, SEQ_B, SEQ_T, rng, dev)]
        for r, t in SEQ_EDGE_SHAPES + SEQ_TILE_SHAPES:
            if mode != "biquad" or t >= 2:
                errs.append(seq_check(mode, r, t, rng, dev))
        errs += [seq_check(mode, 3, 1001, rng, dev, offset=1),
                 seq_check(mode, 8, 4096, rng, dev, offset=1),
                 seq_check(mode, 33, 2 * SEQ_RUN + 1, rng, dev, offset=1)]
        rec[f"{mode}:err"] = max(errs)
    print(f"  {len(SEQ_EDGE_SHAPES) + len(SEQ_TILE_SHAPES)} edge shapes a "
          f"mode: bitwise")

    # the bench chain at full width
    g = bench_graph()
    x_np = (np.random.default_rng(91).standard_normal((b_main, 1, t_main),
                                                      dtype=np.float32)
            * np.float32(0.25))
    n_seq = 3
    n_groups = cpu_group_calls(g, "exact")
    y, cg, wall, peak, by_mode = exact_render(
        g, x_np, b_main, only_launches(sequential=n_seq, pointwise=n_groups),
        "bench chain", dev)
    check(by_mode == {"first_order": 2, "biquad": 1},
          f"bench chain under exact: sequential launches by mode {by_mode}")
    print(f"bench chain under exact, [{b_main}, 1, {t_main}]: render "
          f"{wall:.3f} s (first call), peak {peak:.2f} GiB, sequential "
          f"launches {by_mode} (biquad, low pass, high pass), no chain "
          f"kernel, no plain version [{card}]")
    head = min(SR, t_main)
    rec["bench_oracle_db"] = held(
        "stream 0, first second vs bench.oracle_chain",
        host(y[0, 0, :head]), oracle_chain(x_np[0, 0, :head]), EXACT_DB)
    rec["bench_cpu_db"] = held(
        f"streams 0-1, first {T_CPU_PORT} samples vs the CPU port's exact "
        f"render", host(y[:2, :, :T_CPU_PORT]),
        cpu_exact(g, x_np[:2, :, :T_CPU_PORT]), CARD_VS_CPU_DB)
    del y
    xd = torch.as_tensor(x_np, device=dev)
    with dst.policy("exact"):
        rec["bench_render_ms"] = cuda_ms(
            lambda: cg.render(xd, batch_shape=(b_main,)), 3)
    del xd
    torch.cuda.empty_cache()
    print(f"  render {rec['bench_render_ms']:.3f} ms median of 3 = "
          f"{b_main * t_main / SR / (rec['bench_render_ms'] / 1e3):,.0f} "
          f"audio-s/s [{card}]")
    rec["launches"] = by_mode

    # streamed over 1 s: one CUDA graph replayed a block, bitwise the
    # eager loop and the card's exact render
    rec["stream"] = stream_run(
        "bench chain, exact", g, x_np[0, 0, :SR].copy(), dev, card,
        only_launches(sequential=n_seq, pointwise=n_groups), policy="exact",
        first_order=True,
        bounds=exact_block_bounds())
    check({k: n for k, n in rec["stream"]["kernel_n"].items()
           if k != "pointwise"} == {k: n for k, (_, n)
                                        in EXACT_BLOCK.items()},
          f"exact stream: the graph's sequential instances "
          f"{rec['stream']['kernel_n']}, not {EXACT_BLOCK}")

    # config5 at B_EXACT x 1 s
    g5, _ = presets.config5_feedback_16node()
    x5 = (np.random.default_rng(92).standard_normal((B_EXACT, 1, SR),
                                                    dtype=np.float32)
          * np.float32(0.3))
    cg5 = dst.compile_graph(g5, device="cpu")
    n5 = sequential_launches(cg5, SR)
    g5n = group_launches(g5, "exact", SR)
    y5, _, wall, _, _ = exact_render(
        g5, x5, B_EXACT, only_launches(envelope=1, sequential=n5,
                                       pointwise=g5n,
                                       oscillator=osc_launches(g5, SR)),
        "config5", dev)
    print(f"config5 under exact, [{B_EXACT}, 1, {SR}]: render {wall:.3f} s, "
          f"1 envelope, {n5} sequential launches (the loop's one-pole once "
          f"a block) and {g5n} pointwise (three groups, the loop's two "
          f"once a block), no chain or cycle kernel [{card}]")
    y5 = host(y5)
    rec["c5_oracle_db"] = held("stream 0 vs the composed oracle",
                               y5[0, 0], oracle_config5(x5[0, 0]), EXACT_DB)
    rec["c5_cpu_db"] = held(
        f"first {T_CPU_PORT} samples vs the CPU port's exact render",
        y5[..., :T_CPU_PORT], cpu_exact(g5, x5[..., :T_CPU_PORT]),
        CARD_VS_CPU_DB)

    # the exact-pool fuzz graphs at B_EXACT x 1 s
    rng = np.random.default_rng(93)
    n_bitwise, worst_or, worst_cpu = 0, -np.inf, -np.inf
    print(f"exact-pool fuzz graphs (_random_graph(seed, exact=True)) under "
          f"exact, [{B_EXACT}, 1, {SR}], vs the oracle (stream 0) and the CPU "
          f"port over the first {T_CPU_PORT} samples:")
    for seed in EXACT_FUZZ_SEEDS:
        gf, inp, outn = gen._random_graph(seed, exact=True)
        xf = (rng.standard_normal((B_EXACT, 1, SR), dtype=np.float32)
              * np.float32(0.25))
        nf = sequential_launches(dst.compile_graph(gf, device="cpu"), SR)
        yf, cgf, _, _, _ = exact_render(
            gf, xf, B_EXACT, only_launches(
                sequential=nf, pointwise=group_launches(gf, "exact", SR)),
            f"fuzz seed {seed}", dev, finite=False)
        yf = host(yf)[..., :T_CPU_PORT]
        want = oracle_evaluate(gf, {inp: xf[0, 0, :T_CPU_PORT]},
                               T_CPU_PORT)[outn]
        got = yf[0, cgf.output_ids.index(outn)]
        d_or = finite_dbfs(f"exact fuzz seed {seed} vs oracle", got, want)
        d_cpu = finite_dbfs(f"exact fuzz seed {seed} vs CPU", yf,
                            cpu_exact(gf, xf[..., :T_CPU_PORT]))
        same = bool(np.array_equal(got, want, equal_nan=True))
        n_bitwise += same
        worst_or, worst_cpu = max(worst_or, d_or), max(worst_cpu, d_cpu)
        n_bad = int((~np.isfinite(want)).sum())
        print(f"  seed {seed:3d}: vs oracle {d_or:7.1f} dBFS (bitwise "
              f"{same}), vs CPU port {d_cpu:7.1f} dBFS, {nf} sequential "
              f"launches" + (f"; {n_bad} samples of stream 0 overflow, in "
                             f"the oracle too" if n_bad else ""))
        check(d_or <= EXACT_DB, f"exact fuzz seed {seed} vs oracle "
                                f"{d_or:.1f} dBFS")
        check(d_cpu <= CARD_VS_CPU_DB, f"exact fuzz seed {seed} vs CPU "
                                       f"{d_cpu:.1f} dBFS")
    print(f"  {n_bitwise} of {len(EXACT_FUZZ_SEEDS)} bitwise against the "
          f"oracle; worst {worst_or:.1f} dBFS vs oracle, {worst_cpu:.1f} vs "
          f"the CPU port")
    rec.update(fuzz_bitwise=n_bitwise, fuzz_oracle_db=worst_or,
               fuzz_cpu_db=worst_cpu)

    # the kernel at the main path's shape, timed there, bit for bit against
    # its plain version on a prefix and a late window of the same inputs
    # (the plain loop once on the prefix: its steps of a few launches each)
    rng = np.random.default_rng(94)
    for mode in SEQ_MODES:
        ins = seq_inputs(mode, b_main, t_main, rng, dev)
        ms = cuda_ms(lambda: seq_kernel(mode, ins))
        err, plain_ms, n_plain = seq_compare_windows(
            mode, ins, f"[{b_main}, {t_main}]")
        del ins
        rec[f"{mode}:err"] = max(rec[f"{mode}:err"], err)
        bms, bby = seq_bound(mode, b_main, t_main)
        floor = seq_floor_ms(mode, t_main)
        rec[mode] = dict(ms=ms, plain_ms=plain_ms, bound=(bms, bby),
                         floor=floor, plain_shape=[b_main, n_plain])
        print(f"sequential kernel, {mode}, [{b_main}, {t_main}]: {ms:.3f} ms "
              f"(chain floor {floor:.3f} ms, {floor / ms:.1%} of it; bound "
              f"{bms:.3f} ms by {bby}); its plain version {plain_ms:.1f} ms "
              f"at [{b_main}, {n_plain}] [{card}]")
        torch.cuda.empty_cache()
    print(f"exact phase: {time.time() - t_phase:.1f} s")
    return rec


# -- gradients on the card ------------------------------------------------------

def grad_close(name, got, want, rtol=GRAD_RTOL, atol=GRAD_ATOL) -> float:
    """A gradient on the card against the CPU port's: an array
    max-normalized (max |got - want| / max |want| <= rtol), a scalar
    within rtol or ``atol`` near 0.  Returns the relative error."""
    g = np.asarray(got.detach().double().cpu() if hasattr(got, "detach")
                   else got, np.float64)
    w = np.asarray(want.detach().double().cpu() if hasattr(want, "detach")
                   else want, np.float64)
    check(g.shape == w.shape, f"{name}: shape {g.shape} vs {w.shape}")
    if g.ndim:
        err = float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))
        check(bool(np.isfinite(g).all()) and err <= rtol,
              f"{name}: gradient max-normalized error {err:.2e} > {rtol}")
        return err
    err = float(abs(g - w) / max(abs(w), 1e-30))
    check(bool(np.isfinite(g)) and abs(g - w) <= max(rtol * abs(w), atol),
          f"{name}: gradient {float(g):.6e} on the card vs {float(w):.6e}")
    return err


def loss_and_grads(cg, x, target, params=None, wrt_input=True,
                   first_order=True):
    """make_loss_fn's loss of the graph over x [B, T] (its one input) with
    override sliders ``params`` (leaf tensors that require grad) and its
    gradients, the input's first; the forward's and the backward's
    launches and plain calls apart (``first_order``: the first-order
    kernel's plain versions counted too, as plain_versions_counted says),
    the forward's launches of the chain kernel's record build, the
    backward's runs of the pointwise groups' plain version (a group's
    backward is its vjp, by design), the forward + backward wall time and
    the peak device memory (GiB; 0 on the CPU)."""
    from dsp_stuff_tpu_torch.compiler import pointwise
    from dsp_stuff_tpu_torch.ops import chain_kernel
    import torch
    from dsp_stuff_tpu_torch.train import fit
    dev = cg.device
    xt = x.detach().clone().requires_grad_(wrt_input)
    params = params or {}
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
    plain = {}
    reset_launches()
    t0 = time.time()
    with plain_versions_counted(plain, first_order=first_order):
        loss = fit.make_loss_fn(cg)(params, cg.init_state(),
                                    {str(cg.input_ids[0]): xt}, target)
    fwd = read_launches()
    fwd_record = chain_kernel.RECORD_LAUNCHES
    reset_launches()
    plain_bwd, group_vjps = {}, {}
    with plain_versions_counted(plain_bwd, first_order=first_order,
                                groups=False), calls_counted(
            [(pointwise, "interpret")], group_vjps):
        loss.backward()
        if cuda:
            torch.cuda.synchronize()
    wall = time.time() - t0
    bwd = read_launches()
    peak = torch.cuda.max_memory_allocated(dev) / 2**30 if cuda else 0.0
    grads = ([xt.grad] if wrt_input else []) + [
        v.grad for _, e in sorted(params.items()) for _, v in sorted(e.items())]
    return dict(loss=loss.detach(), grads=grads, fwd=fwd, bwd=bwd,
                fwd_record=fwd_record, plain=plain, plain_bwd=plain_bwd,
                group_vjps=group_vjps.get("interpret", 0), wall=wall,
                peak=peak)


def slider_params(cg, cfg, name):
    """{node: {name: leaf tensor}} for the first node of type ``cfg`` at
    its graph value: the subset a fit of that one slider overrides."""
    import torch
    nid = min(n.id for n in cg.graph.nodes.values() if n.cfg_name == cfg)
    v = float(np.float32(cg.graph.nodes[nid].params[name]))
    return {str(nid): {name: torch.tensor(v, device=cg.device,
                                          requires_grad=True)}}


def grad_pair(name, graph, x_np, tgt_np, dev, subset=None, wrt_input=True):
    """One loss gradient (the input's, or a slider subset's) on the card
    ``dev`` against the CPU port on the same inputs; returns the worst
    error."""
    import torch
    import dsp_stuff_tpu_torch as dst
    cpu, card = (loss_and_grads(
        cg, torch.as_tensor(x_np, device=d), torch.as_tensor(tgt_np, device=d),
        slider_params(cg, *subset) if subset else None, wrt_input)
        for d in ("cpu", dev) for cg in [dst.compile_graph(graph, device=d)])
    worst = grad_close(f"{name}: loss", card["loss"], cpu["loss"])
    for i, (g, w) in enumerate(zip(card["grads"], cpu["grads"])):
        worst = max(worst, grad_close(f"{name}: gradient {i}", g, w))
    print(f"  {name}, [{x_np.shape[0]}, {x_np.shape[-1]}]: card vs CPU port "
          f"worst {worst:.2e} (rtol {GRAD_RTOL}); forward launches on the "
          f"card {card['fwd']}")
    return worst


def fused_grad_main(name, cg, x, target, expect, subset=None,
                    wrt_input=True, card="", first_order=True,
                    expect_bwd=None, expect_record=None):
    """A loss gradient through the fused kernels on the card at full
    width: the forward launches ``expect`` (of its chain launches
    ``expect_record`` the record build's, where given) and calls no plain
    version; with ``expect_bwd`` (launches by kernel) the backward
    launches those and calls no plain version either (nor the groups'
    interpret); prints the forward + backward time, the peak memory and
    what the backward launches and calls."""
    r = loss_and_grads(cg, x, target,
                       slider_params(cg, *subset) if subset else None,
                       wrt_input, first_order)
    check(not r["plain"], f"{name}: the forward called plain versions "
                          f"{r['plain']}")
    if expect_bwd is not None:
        check(not r["plain_bwd"] and not r["group_vjps"],
              f"{name}: the backward called plain versions "
              f"{r['plain_bwd']} and the groups' {r['group_vjps']} times")
        check(all(r["bwd"][k] == v for k, v in expect_bwd.items()),
              f"{name}: the backward launched {r['bwd']}, expected "
              f"{expect_bwd}")
    check(r["fwd"] == expect, f"{name}: the forward launched {r['fwd']}, "
                              f"expected {expect}")
    if expect_record is not None:
        check(r["fwd_record"] == expect_record,
              f"{name}: the forward launched the chain kernel's record "
              f"build {r['fwd_record']} times, expected {expect_record}")
    check(all(bool(g.isfinite().all()) for g in r["grads"]),
          f"{name}: gradients not finite")
    print(f"main path ({name}), [{x.shape[0]}, {x.shape[-1]}]: forward + "
          f"backward {r['wall'] * 1e3:.1f} ms (first call), peak "
          f"{r['peak']:.2f} GiB, forward launches {r['fwd']} "
          f"({r['fwd_record']} of the record build) and no plain "
          f"version, backward launches {r['bwd']}, plain versions in the "
          f"backward {r['plain_bwd'] or 'none'} (and {r['group_vjps']} "
          f"runs of the pointwise groups' plain version) [{card}]")
    return r


GRAD_OPS = {
    "products": ("aten::mm", "aten::bmm", "aten::addmm"),
    "shaper math": ("aten::atan", "aten::tanh", "aten::exp", "aten::sin",
                    "aten::cos", "aten::pow", "aten::sqrt",
                    "aten::reciprocal", "aten::tanh_backward"),
    "elementwise": ("aten::mul", "aten::add", "aten::sub", "aten::div",
                    "aten::where", "aten::neg", "aten::abs", "aten::sign",
                    "aten::clamp", "aten::maximum", "aten::minimum",
                    "aten::mul_", "aten::add_", "aten::fill_",
                    "aten::zero_", "aten::sum", "aten::mean"),
    "copies": ("aten::cat", "aten::copy_", "aten::clone",
               "aten::constant_pad_nd", "aten::roll", "aten::index",
               "aten::slice_backward", "aten::select_backward",
               "aten::index_select", "aten::index_add_", "aten::flip")}


def grad_split(name, cg, x, target, card) -> dict:
    """The input gradient's forward and backward apart (wall, medians of
    three after a first call), one forward + backward's device time by
    torch.profiler, split by op group ("other": the ops outside the
    groups and the port's kernels, whose ctypes launches the profiler
    counts there; their own device times are printed too), and the peak
    device memory of one forward + backward (GiB)."""
    import torch
    from dsp_stuff_tpu_torch.train import fit
    key = str(cg.input_ids[0])

    def run():
        xt = x.detach().clone().requires_grad_(True)
        loss = fit.make_loss_fn(cg)({}, cg.init_state(), {key: xt}, target)
        torch.cuda.synchronize()
        t1 = time.time()
        loss.backward()
        torch.cuda.synchronize()
        return t1, time.time()

    fwd, bwd = [], []
    run()
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.time()
        t1, t2 = run()
        fwd.append((t1 - t0) * 1e3)
        bwd.append((t2 - t1) * 1e3)
    kernels = {}
    split, total = device_split(run, GRAD_OPS, kernels)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(cg.device)
    run()
    peak = torch.cuda.max_memory_allocated(cg.device) / 2**30
    rec = dict(fwd_ms=float(np.median(fwd)), bwd_ms=float(np.median(bwd)),
               device_ms=total, split=split, kernels=kernels, peak=peak)
    print(f"{name}: forward {rec['fwd_ms']:.3f} ms, backward "
          f"{rec['bwd_ms']:.3f} ms (wall, medians of 3), peak {peak:.3f} "
          f"GiB; one forward + "
          f"backward on the card {total:.3f} ms: " + ", ".join(
              f"{k} {v:.3f} ms ({v / max(total, 1e-9):.1%})"
              for k, v in split.items()) + "; the port's kernels in it: "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in sorted(kernels.items()))
          + f" [{card}]")
    return rec


def seq_rev_inputs(mode, R, T, rng, dev, offset=0):
    """The forward solve's inputs in ``mode``'s forward form, its output y
    (the sequential kernel's) and a cotangent ybar, [R, T] on ``dev``;
    ``offset`` as for seq_inputs, y and ybar too."""
    fwd = SEQ_REV[mode]
    ins = seq_inputs(fwd, R, T, rng, dev, offset)
    y = seq_kernel(fwd, ins)[0]
    if offset:
        y = seq_array(y.cpu(), dev, offset)
    ybar = seq_array(rng.standard_normal((R, T), dtype=np.float32), dev,
                     offset)
    return ins, y, ybar


def seq_rev_kernel(mode, ins, y, ybar):
    """The reverse mode's outputs: (lam, abar: row sums [R] f64 or [R, T],
    y0bar [R]) or (xbar, the state's gradient [R, 4], row sums [R, 5]
    f64)."""
    from dsp_stuff_tpu_torch.ops import sequential_kernel
    if mode == "biquad_reverse":
        x, c, st = ins
        return sequential_kernel.biquad_reverse_cuda(x, y, c, st, ybar)
    a, _, y0 = ins
    return sequential_kernel.first_order_reverse_cuda(a, y, y0, ybar)


def seq_rev_plain(mode, ins, y, ybar):
    """The reverse mode's plain version on the same inputs."""
    from dsp_stuff_tpu_torch.ops import scan
    if mode == "biquad_reverse":
        x, c, st = ins
        return scan._biquad_adjoint_sequential(x, y, c, st, ybar)
    a, _, y0 = ins
    return scan._first_order_adjoint_sequential(a, y, y0, ybar)


def seq_rev_parts(mode, out):
    """({name: sample adjoint}, the coefficients' gradients, float64 [n])
    of a reverse mode's outputs: the row sums added over the rows."""
    import torch
    if mode == "biquad_reverse":
        xbar, sbar, acc = out
        return {"xbar": xbar, "state": sbar}, acc.sum(0)
    lam, abar, y0bar = out
    if mode == "first_order_reverse_per_sample":
        return ({"lam": lam, "abar": abar, "y0bar": y0bar},
                torch.zeros(0, dtype=torch.float64, device=lam.device))
    return {"lam": lam, "y0bar": y0bar}, abar.sum().reshape(1)


def seq_rev_f64(mode, ins, y, ybar):
    """The adjoint in float64 at the same trajectory y: the parity path's
    blocked solves on the flipped cotangent (``first_order_plain``; for
    the biquad ``_biquad_blocked`` with b = (1, 0, 0), whose output it
    rounds to f32), the rest in float64."""
    import torch
    import torch.nn.functional as F
    from dsp_stuff_tpu_torch.ops import scan
    yb = ybar.double()
    if mode == "biquad_reverse":
        x, c, st = ins
        a1, a2, b0, b1, b2 = (float(v) for v in c)
        zero = torch.zeros(x.shape[0], dtype=torch.float64, device=x.device)
        g = scan._biquad_blocked(yb.flip(-1), (a1, a2, 1.0, 0.0, 0.0),
                                 (zero,) * 4, torch.float64)[0]
        g = g.flip(-1).double()
        G1, G2 = F.pad(g[:, 1:], (0, 1)), F.pad(g[:, 2:], (0, 2))
        xd, yd, sd = x.double(), y.double(), st.double()
        acc = torch.stack([
            -((G1 * yd).sum() + (g[:, 0] * sd[:, 2]).sum()),
            -((G2 * yd).sum() + (g[:, 1] * sd[:, 2]).sum()
              + (g[:, 0] * sd[:, 3]).sum()),
            (g * xd).sum(),
            (G1 * xd).sum() + (g[:, 0] * sd[:, 0]).sum(),
            (G2 * xd).sum() + (g[:, 1] * sd[:, 0]).sum()
            + (g[:, 0] * sd[:, 1]).sum()])
        sbar = torch.stack([b1 * g[:, 0] + b2 * g[:, 1], b2 * g[:, 0],
                            -a1 * g[:, 0] - a2 * g[:, 1], -a2 * g[:, 0]], -1)
        return {"xbar": b0 * g + b1 * G1 + b2 * G2, "state": sbar}, acc
    a, _, y0 = ins
    a, yd, y0d = a.double(), y.double(), y0.double()
    per_sample = a.dim() > 0
    a_next = F.pad(a[:, 1:], (0, 1)) if per_sample else a
    lam = scan.first_order_plain(a_next, yb, torch.zeros_like(y0d),
                                 reverse=True)
    p = lam * torch.cat([y0d[:, None], yd[:, :-1]], dim=-1)
    y0bar = (a[:, 0] if per_sample else a) * lam[:, 0]
    if per_sample:
        return ({"lam": lam, "abar": p, "y0bar": y0bar},
                torch.zeros(0, dtype=torch.float64, device=a.device))
    return {"lam": lam, "y0bar": y0bar}, p.sum().reshape(1)


def seq_rev_compare(mode, got, want, label, limit, rtol, bitwise=False):
    """Sample adjoints within ``limit`` dBFS (printed with whether they are
    bitwise; with ``bitwise`` they must be, the initial state's gradient
    too), coefficient gradients within ``rtol``; returns (worst dBFS,
    worst coefficient error, the samples' max abs difference)."""
    import torch
    arrs_g, coef_g = got
    arrs_w, coef_w = want
    worst, abs_err, same = -np.inf, 0.0, True
    for k, g in arrs_g.items():
        w = arrs_w[k]
        worst = max(worst, dbfs_dev(g, w))
        abs_err = max(abs_err, float((g.double() - w.double()).abs().max()))
        same = same and g.dtype == w.dtype and bool(torch.equal(g, w))
    check(same or not bitwise, f"{mode} {label}: the sample adjoints or the "
                               f"initial state's gradient are not bitwise "
                               f"the plain version's")
    cerr = 0.0
    if coef_g.numel():
        cerr = float(((coef_g - coef_w).abs()
                      / coef_w.abs().clamp_min(1e-30)).max())
        same = same and bool(torch.equal(coef_g, coef_w))
    print(f"  {mode:30s} {label}: sample adjoints {worst:.1f} dBFS, "
          f"coefficient gradients rel {cerr:.2e}, bitwise {same}")
    check(worst <= limit, f"{mode} {label}: {worst:.1f} dBFS > {limit}")
    check(cerr <= rtol, f"{mode} {label}: coefficient gradients rel "
                        f"{cerr:.2e} > {rtol}")
    return worst, cerr, abs_err


def seq_rev_bound(mode, R, T):
    """The reverse mode's bound at [R, T]: its arrays read (ybar and y; a
    per-sample a; the biquad's x) and written (lam or xbar; a per-sample
    abar) once, its operations (the float64 adds counted as FP32)."""
    n_bytes = 4.0 * R * T * {"first_order_reverse": 3,
                             "first_order_reverse_per_sample": 5,
                             "biquad_reverse": 4}[mode]
    flops = {"first_order_reverse": 4.0, "first_order_reverse_per_sample":
             3.0, "biquad_reverse": 19.0}[mode] * R * T
    return bound(n_bytes, flops)


def modulated_filters():
    """input -> low_pass -> high_pass -> output, whose ratios a caller
    drives sample by sample (override sliders [B, T]): under exact each
    solve takes the sequential kernel's per-sample mode."""
    import dsp_stuff_tpu_torch as dst
    g = dst.Graph()
    inp = g.add("input")
    lp = g.add("low_pass", ratio=0.9)
    hp = g.add("high_pass", ratio=0.3)
    g.chain(inp, lp, hp, g.add("output"))
    return g, (str(lp.id), str(hp.id))


def exact_bench_grads(graph, xe, te, dev):
    """The bench chain's loss gradients under exact (all 16 sliders and
    the input) on the CPU and the card; the card's sequential launches by
    wrapper, its launches, the plain loops it called and its groups'
    vjps."""
    import torch
    import dsp_stuff_tpu_torch as dst
    from dsp_stuff_tpu_torch.ops import sequential_kernel
    from dsp_stuff_tpu_torch.train import fit
    got, modes, plain, vjps = {}, {}, {}, {}
    wrappers = [(sequential_kernel, n) for n in (
        "first_order_sequential_cuda", "biquad_sequential_cuda",
        "first_order_reverse_cuda", "biquad_reverse_cuda")]
    with dst.policy("exact"):
        for key, d in (("cpu", "cpu"), ("card", dev)):
            cg = dst.compile_graph(graph, device=d)
            x = torch.as_tensor(xe, device=d).requires_grad_(True)
            p = cg.init_params(requires_grad=True)
            reset_launches()
            with contextlib.ExitStack() as stack:
                if key == "card":
                    stack.enter_context(forward_and_vjps_counted(plain,
                                                                 vjps))
                    stack.enter_context(calls_counted(wrappers, modes))
                loss = fit.make_loss_fn(cg)(p, cg.init_state(),
                                            {str(cg.input_ids[0]): x},
                                            torch.as_tensor(te, device=d))
                loss.backward()
            got[key] = (loss.detach(), x.grad, p)
    return got, modes, read_launches(), plain, vjps.get("interpret", 0)


def sharded_step_check(name, cg, m, x_np, tgt_np) -> None:
    """Two Adam steps of make_sharded_train_step over mesh ``m`` against
    make_train_step on the whole batch, the second after the caller
    scaled every slider in place: the loss, the summed gradients (card vs
    CPU bound) and the sliders after each step."""
    import torch
    from dsp_stuff_tpu_torch.train import fit
    dev = cg.device
    ext = {str(cg.input_ids[0]): torch.as_tensor(x_np, device=dev)}
    tgt = torch.as_tensor(tgt_np, device=dev)
    res = {}
    for key, (step, init_opt) in (
            ("unsharded", fit.make_train_step(cg, fit.adam(1e-2))),
            ("sharded", fit.make_sharded_train_step(cg, m, fit.adam(1e-2)))):
        params = cg.init_params(requires_grad=True)
        opt = init_opt(params)
        res[key] = []
        for i in range(2):
            if i:
                with torch.no_grad():
                    for e in params.values():
                        for v in e.values():
                            v.mul_(0.9)
            params, opt, loss = step(params, opt, cg.init_state(), ext, tgt)
            res[key].append((float(loss), {
                f"{n}/{k}": (float(v.detach()), v.grad.detach().clone())
                for n, e in params.items() for k, v in e.items()}))
    worst = worst_g = 0.0
    for i, ((lw, pw), (lg, pg)) in enumerate(zip(res["unsharded"],
                                                 res["sharded"])):
        for key, g, w in [("loss", lg, lw)] + [
                (k, pg[k][0], v[0]) for k, v in sorted(pw.items())]:
            check(abs(g - w) <= max(STEP_RTOL * abs(w), STEP_ATOL),
                  f"sharded step over {name}, step {i}: {key} {g:.8e} vs "
                  f"{w:.8e}")
            worst = max(worst, abs(g - w) / max(abs(w), 1e-30))
        for k, v in sorted(pw.items()):
            worst_g = max(worst_g, grad_close(
                f"sharded step over {name}, step {i}: gradient {k}",
                pg[k][1], v[1]))
    print(f"make_sharded_train_step over {name} ({m.size} shards), bench "
          f"chain [{x_np.shape[0]}, {x_np.shape[-1]}], two steps, the "
          f"sliders scaled in place between them: the loss and "
          f"{len(res['unsharded'][0][1])} sliders vs the unsharded step "
          f"worst relative {worst:.2e} (rtol {STEP_RTOL}), the summed "
          f"gradients {worst_g:.2e} (rtol {GRAD_RTOL})")


def grad_phase(dev, card, b_grad=B_GRAD, t_main=T_MAIN) -> dict:
    """Gradients on the card: through the fused chain and cycle kernels
    (the bench chain's input and gain level at b_grad x t_main, config5's
    input at b_grad x t_main, its backward one launch of the reverse
    cycle kernel and no plain version, with its device-time split), every
    slider of config2 and config5, one Adam step of config2, the
    sequential kernel's reverse mode against its
    plain version and a float64 adjoint (timed at [B_MAIN, t_main], and
    against its plain version at the exact gradient's [B_EXACT, SR]), the
    bench chain's 16 slider gradients under exact, a low_pass and a
    high_pass with per-sample ratios under exact, render_sharded over the
    card's meshes and make_sharded_train_step over two shards of the card
    and over the card and the CPU; each gradient against the CPU port at
    2 x 1 s (exact: 4 x 1 s).  Returns the reverse mode's records and
    launches."""
    import torch
    import dsp_stuff_tpu_torch as dst
    from dsp_stuff_tpu_torch.models import presets
    from dsp_stuff_tpu_torch.ops import sequential_kernel
    from dsp_stuff_tpu_torch.parallel import mesh
    from dsp_stuff_tpu_torch.train import fit
    t_phase = time.time()
    rec = {}
    rng = np.random.default_rng(120)

    def sig(*shape, scale=0.25):
        return (rng.standard_normal(shape, dtype=np.float32)
                * np.float32(scale))

    g_bench = bench_graph()
    g5, _ = presets.config5_feedback_16node()
    g2, _ = presets.config2_delay_chorus()
    with dst.policy("fast"):
        # -- the bench chain through the chain kernel -----------------------
        print(f"gradients through the fused kernels, card vs CPU port (fast), "
              f"[2, {T_CPU_PORT}]:")
        x2, t2 = sig(2, T_CPU_PORT), sig(2, 1, T_CPU_PORT, scale=0.1)
        grad_pair("bench chain, input", g_bench, x2, t2, dev)
        grad_pair("bench chain, gain level alone", g_bench, x2, t2, dev,
                  subset=("gain", "level"), wrt_input=False)
        cg = dst.compile_graph(g_bench, device=dev)
        x = torch.as_tensor(sig(b_grad, t_main), device=dev)
        tgt = torch.as_tensor(sig(b_grad, 1, t_main, scale=0.1), device=dev)
        rec["bench_input"] = fused_grad_main(
            "bench chain, input gradient", cg, x, tgt,
            only_launches(chain=1), card=card,
            expect_bwd={"chain_reverse": 1, "chain": 0}, expect_record=1)
        rec["bench_split"] = grad_split(
            f"bench chain input gradient, [{b_grad}, {t_main}]", cg, x, tgt,
            card)
        rec["bench_level"] = fused_grad_main(
            "bench chain, gain level alone, the rest fused", cg, x, tgt,
            only_launches(chain=1, pointwise=1), subset=("gain", "level"),
            wrt_input=False, card=card,
            expect_bwd={"chain_reverse": 1, "chain": 0,
                        "pointwise_reverse": 1, "pointwise": 0},
            expect_record=1)
        del x, tgt, cg
        torch.cuda.empty_cache()

        # -- config5 through the cycle kernel and its reverse ---------------
        grad_pair("config5, input", g5, x2, t2, dev)
        cg5 = dst.compile_graph(g5, device=dev)
        x = torch.as_tensor(sig(b_grad, t_main), device=dev)
        tgt = torch.as_tensor(sig(b_grad, 1, t_main, scale=0.1), device=dev)
        # config5's degenerate biquad takes _first_order_blocked in either
        # package (plain_versions_counted)
        rec["c5_input"] = fused_grad_main(
            "config5, input gradient", cg5, x, tgt,
            only_launches(chain=1, cycle=1, envelope=1, pointwise=3,
                          oscillator=2),
            card=card, first_order=False,
            expect_bwd={"chain_reverse": 1, "chain": 0, "cycle_reverse": 1,
                        "cycle": 0, "pointwise": 0, "pointwise_reverse": 3},
            expect_record=0)
        rec["c5_split"] = grad_split(
            f"config5 input gradient, [{b_grad}, {t_main}]", cg5, x, tgt,
            card)
        again = loss_and_grads(cg5, x, tgt, None, True, False)
        rec["c5_input"]["wall_again"] = again["wall"]
        print(f"  config5 input gradient, [{b_grad}, {t_main}], a second "
              f"call: forward + backward {again['wall'] * 1e3:.1f} ms, peak "
              f"{again['peak']:.2f} GiB, backward launches {again['bwd']} "
              f"[{card}]")
        del x, tgt, cg5, again
        torch.cuda.empty_cache()

        # -- every slider of config2 and config5 ----------------------------
        print(f"every slider, card vs CPU port (fast, node by node) "
              f"[{time.time() - t_phase:.0f} s]:")
        rngf = np.random.default_rng(121)
        grads_card_vs_cpu("config2 (chorus) fit", g2,
                          (rngf.standard_normal((2, T_CPU_PORT)) * 0.3)
                          .astype(np.float32), {"gain": ("level", 0.6)})
        # the LFO's sliders among them: the reverse oscillator kernel's two
        # passes (the wave's, the sums'), no recompute of the plain version
        rec["c5_every"] = grads_card_vs_cpu(
            "config5 (feedback cycle) fit", g5,
            (rngf.standard_normal((2, T_CPU_PORT)) * 0.3).astype(np.float32),
            {"gain": ("level", 1.0)},
            expect_bwd={"oscillator": 2, "oscillator_reverse": 2})
        cg2 = dst.compile_graph(g2, device=dev)
        ext = {str(cg2.input_ids[0]): torch.as_tensor(sig(b_grad, t_main),
                                                      device=dev)}
        tgt = torch.as_tensor(sig(b_grad, 1, t_main, scale=0.1), device=dev)
        params = cg2.init_params(requires_grad=True)
        step, init_opt = fit.make_train_step(cg2, fit.adam(1e-2))
        opt = init_opt(params)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launches()
        t0 = time.time()
        params, opt, loss = step(params, opt, cg2.init_state(), ext, tgt)
        torch.cuda.synchronize()
        rec["c2_step_s"] = time.time() - t0
        check(bool(torch.isfinite(loss)) and all(
            bool(torch.isfinite(v)) for e in params.values()
            for v in e.values()), "config2 Adam step: not finite")
        print(f"main path (config2 fit): one Adam step of its "
              f"{sum(len(e) for e in params.values())} sliders over "
              f"[{b_grad}, {t_main}] in {rec['c2_step_s'] * 1e3:.1f} ms "
              f"(first call), peak "
              f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB, "
              f"launches {read_launches()}, loss {float(loss):.6e} [{card}]")
        del ext, tgt, params, opt, cg2
        torch.cuda.empty_cache()

    # -- the sequential kernel's reverse mode -----------------------------------
    print(f"sequential kernel, reverse mode, vs its plain version, "
          f"[{SEQ_B}, {SEQ_T}] and edge shapes [{time.time() - t_phase:.0f} "
          f"s]:")
    rng_s = np.random.default_rng(122)
    for mode in SEQ_REV:
        errs = []
        for r, t, off in ((SEQ_B, SEQ_T, 0), (1, 1, 0), (5, 2, 0), (33, 3, 0),
                          (3, 130, 0), *((r, t, 0) for r, t in
                                         SEQ_TILE_SHAPES),
                          (3, 1001, 1), (33, 2 * SEQ_RUN + 1, 1)):
            ins, y, ybar = seq_rev_inputs(mode, r, t, rng_s, dev, off)
            errs.append(seq_rev_compare(
                mode, seq_rev_parts(mode, seq_rev_kernel(mode, ins, y, ybar)),
                seq_rev_parts(mode, seq_rev_plain(mode, ins, y, ybar)),
                f"[{r}, {t}]" + (" unaligned" if off else ""), SEQ_REV_DB,
                SEQ_REV_RTOL, bitwise=True)[2])
        rec[f"{mode}:err"] = max(errs)
    print(f"sequential kernel, reverse mode, [{B_MAIN}, {t_main}]: vs the "
          f"float64 adjoint, and timed [{time.time() - t_phase:.0f} s]:")
    for mode in SEQ_REV:
        ins, y, ybar = seq_rev_inputs(mode, B_MAIN, t_main, rng_s, dev)
        seq_rev_compare(mode,
                        seq_rev_parts(mode, seq_rev_kernel(mode, ins, y,
                                                           ybar)),
                        seq_rev_f64(mode, ins, y, ybar), "vs float64",
                        SEQ_REV_F64_DB, SEQ_REV_RTOL)
        torch.cuda.empty_cache()
        ms = cuda_ms(lambda: seq_rev_kernel(mode, ins, y, ybar))
        bms, bby = seq_rev_bound(mode, B_MAIN, t_main)
        floor = seq_floor_ms(SEQ_REV[mode], t_main)
        rec[f"{mode}:big"] = dict(ms=ms, bound=(bms, bby), floor=floor)
        print(f"  {mode}: {ms:.3f} ms (chain floor {floor:.3f} ms, "
              f"{floor / ms:.1%} of it; bound {bms:.3f} ms by {bby}) "
              f"[{card}]")
        del ins, y, ybar
        torch.cuda.empty_cache()
    # the main path's shape, the exact gradient's [B_EXACT, 1 s]: the
    # kernel timed against its plain version, bit for bit
    print(f"sequential kernel, reverse mode, [{B_EXACT}, {SR}] (the exact "
          f"gradient's shape), vs its plain version, both timed:")
    for mode in SEQ_REV:
        ins, y, ybar = seq_rev_inputs(mode, B_EXACT, SR, rng_s, dev)
        ms = cuda_ms(lambda: seq_rev_kernel(mode, ins, y, ybar))
        k = seq_rev_parts(mode, seq_rev_kernel(mode, ins, y, ybar))
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        p = seq_rev_parts(mode, seq_rev_plain(mode, ins, y, ybar))
        t1.record()
        torch.cuda.synchronize()
        err = seq_rev_compare(mode, k, p, f"[{B_EXACT}, {SR}]", SEQ_REV_DB,
                              SEQ_REV_RTOL, bitwise=True)[2]
        rec[f"{mode}:err"] = max(rec[f"{mode}:err"], err)
        bms, bby = seq_rev_bound(mode, B_EXACT, SR)
        floor = seq_floor_ms(SEQ_REV[mode], SR)
        rec[mode] = dict(ms=ms, plain_ms=t0.elapsed_time(t1),
                         bound=(bms, bby), floor=floor)
        print(f"  {mode}: {ms:.3f} ms (chain floor {floor:.3f} ms, "
              f"{floor / ms:.1%} of it; bound {bms:.3f} ms by {bby}); its "
              f"plain version {rec[mode]['plain_ms']:.1f} ms [{card}]")
        del ins, y, ybar, k, p

    # -- gradients under exact ------------------------------------------------
    print(f"gradients under exact, card vs CPU port, [2, {T_CPU_PORT}] "
          f"[{time.time() - t_phase:.0f} s]:")
    xe = np.random.default_rng(123).standard_normal(
        (2, T_CPU_PORT), dtype=np.float32) * np.float32(0.25)
    te = np.random.default_rng(124).standard_normal(
        (2, 1, T_CPU_PORT), dtype=np.float32) * np.float32(0.1)
    got, by_mode, launches, plain, vjps = exact_bench_grads(g_bench, xe, te,
                                                            dev)
    check(not plain, f"exact bench gradient called plain loops {plain}")
    check(by_mode == {"first_order_sequential_cuda": 2,
                      "biquad_sequential_cuda": 1,
                      "first_order_reverse_cuda": 2,
                      "biquad_reverse_cuda": 1},
          f"exact bench gradient: sequential launches by wrapper {by_mode}")
    n_groups = cpu_group_calls(g_bench, "exact", lambda c: c.init_params())
    n_rev = len(cpu_group_backwards(
        g_bench, "exact", lambda c: c.init_params(requires_grad=True), True))
    check(launches == only_launches(sequential=6, pointwise=n_groups,
                                    pointwise_reverse=n_rev) and vjps == 0,
          f"exact bench gradient launched {launches}, {vjps} runs of the "
          f"groups' plain version")
    worst = max(grad_close("exact bench: loss", got["card"][0],
                           got["cpu"][0]),
                grad_close("exact bench: input", got["card"][1],
                           got["cpu"][1]))
    n = 0
    for nid, e in sorted(got["cpu"][2].items()):
        for k, v in sorted(e.items()):
            worst = max(worst, grad_close(f"exact bench: {nid}/{k}",
                                          got["card"][2][nid][k].grad,
                                          v.grad))
            n += 1
    print(f"  bench chain under exact: {n} slider gradients and the input's, "
          f"card vs CPU port worst {worst:.2e}; the card's sequential "
          f"launches {by_mode}, no plain loop")
    rec["rev_launches"] = {
        "first_order_reverse": by_mode.get("first_order_reverse_cuda", 0),
        "biquad_reverse": by_mode.get("biquad_reverse_cuda", 0)}
    # per-sample coefficients: a low_pass and a high_pass whose ratios
    # move sample by sample, through compile_graph
    g_mod, mod_ids = modulated_filters()
    rng_m = np.random.default_rng(125)
    ratios = [rng_m.uniform(lo, hi, xe.shape).astype(np.float32)
              for lo, hi in ((0.5, 0.99), (0.05, 0.6))]
    wt = rng_m.standard_normal((len(xe), 1, xe.shape[-1]), dtype=np.float32)
    pg = {}
    with dst.policy("exact"):
        for key, d in (("cpu", "cpu"), ("card", dev)):
            cg = dst.compile_graph(g_mod, device=d)
            p = {nid: {"ratio": torch.as_tensor(r, device=d)
                       .requires_grad_(True)}
                 for nid, r in zip(mod_ids, ratios)}
            x = torch.as_tensor(xe, device=d).requires_grad_(True)
            modes, plain, vjps = {}, {}, {}
            reset_launches()
            with contextlib.ExitStack() as stack:
                if key == "card":
                    stack.enter_context(forward_and_vjps_counted(plain,
                                                                 vjps))
                    stack.enter_context(calls_counted(
                        [(sequential_kernel, n) for n in (
                            "first_order_sequential_cuda",
                            "first_order_reverse_cuda")], modes))
                y = cg.render(x[:, None], batch_shape=(len(xe),),
                              params=p)[0]
                (y * torch.as_tensor(wt, device=d)).sum().backward()
            pg[key] = (y.detach(), [p[n]["ratio"].grad for n in mod_ids],
                       x.grad, modes, read_launches(), plain,
                       vjps.get("interpret", 0))
    check(not pg["card"][5], f"modulated filters under exact: plain loops "
                             f"{pg['card'][5]}")
    check(pg["card"][3] == {"first_order_sequential_cuda": 2,
                            "first_order_reverse_cuda": 2}
          and pg["card"][4] == only_launches(sequential=4, pointwise=1,
                                             pointwise_reverse=1)
          and pg["card"][6] == 0,
          f"modulated filters under exact: launches {pg['card'][3]} "
          f"{pg['card'][4]}")
    check(bool(torch.equal(pg["card"][0].cpu(), pg["cpu"][0])),
          "modulated filters under exact: the render on the card is not "
          "bitwise the CPU's")
    worst = max([grad_close(f"modulated filters, exact: ratio {i}", g, w)
                 for i, (g, w) in enumerate(zip(pg["card"][1],
                                                pg["cpu"][1]))]
                + [grad_close("modulated filters, exact: input",
                              pg["card"][2], pg["cpu"][2])])
    print(f"  low_pass -> high_pass with per-sample ratios {list(xe.shape)} "
          f"under exact: the render bitwise the CPU's, gradients of both "
          f"ratio curves and the input worst {worst:.2e}; sequential "
          f"launches {pg['card'][3]} (all per-sample), no plain loop")
    rec["rev_launches"]["first_order_reverse_per_sample"] = \
        pg["card"][3].get("first_order_reverse_cuda", 0)

    # -- data parallelism over streams --------------------------------------
    print(f"data parallelism [{time.time() - t_phase:.0f} s]:")
    with dst.policy("fast"):
        cg = dst.compile_graph(g_bench, device=dev)
        x = torch.as_tensor(sig(B_SHARD, 1, t_main), device=dev)
        want, _, st_want = cg.render(x, batch_shape=(B_SHARD,))
        for name, m in (("make_mesh()", mesh.make_mesh()),
                        ("two shards of the card",
                         mesh.make_mesh([dev, dev]))):
            reset_launches()
            got_y, _, st = mesh.render_sharded(cg, x, m)
            launches = read_launches()
            same = bool(torch.equal(got_y, want)) and all(
                bool(torch.equal(st[k][kk], v))
                if isinstance(v, torch.Tensor) else st[k][kk] == v
                for k, e in st_want.items() if isinstance(e, dict)
                for kk, v in e.items())
            print(f"render_sharded over {name} ({m.size} shard(s)), bench "
                  f"chain [{B_SHARD}, 1, {t_main}]: bitwise the unsharded "
                  f"render and state {same}, launches {launches}")
            check(same, f"render_sharded over {name}: not bitwise "
                        f"({dbfs_dev(got_y, want):.1f} dBFS)")
            check(launches == only_launches(chain=m.size),
                  f"render_sharded over {name} launched {launches}")
            del got_y, st
        del x, want, st_want
        torch.cuda.empty_cache()
        for name, devs, B in (("two shards of the card", [dev, dev],
                               B_SHARD_STEP),
                              ("the card and the CPU", [dev, "cpu"],
                               B_SHARD_MIX)):
            sharded_step_check(name, cg, mesh.make_mesh(devs), sig(B, SR),
                               sig(B, 1, SR, scale=0.1))
    print(f"gradient phase: {time.time() - t_phase:.1f} s")
    return rec


# -- the reverse cycle kernel ----------------------------------------------

def _leaves(tree):
    """The tensors of nested tuples, in order."""
    if isinstance(tree, (tuple, list)):
        return [t for sub in tree for t in _leaves(sub)]
    return [tree]


def reverse_inputs(program, n_taps, B, T, rng, dev):
    """(cotangents, operand shapes, recorded inputs) of the reverse kernel
    for ``program`` over [B, T]: seeded operands, a seeded cotangent of
    every output (flatten_outputs' order), and the shapers' inputs
    recorded once by the forward kernel's record build, whose outputs
    must be bitwise the render build's."""
    import torch
    from dsp_stuff_tpu_torch.ops import cycle_kernel, cycle_segment
    ins = cycle_inputs(program, B, T, rng, dev)
    recs = ()
    if cycle_kernel.has_shaper(program):
        raw, recs = cycle_kernel.cycle_kernel_call(*ins, program, n_taps,
                                                   record=True)
        same = all(torch.equal(a, b) for a, b in zip(
            _leaves(raw), _leaves(cycle_kernel.cycle_kernel_call(
                *ins, program, n_taps))))
        check(same, "the record build's outputs are not the render "
                    "build's")
    flat = cycle_segment.flatten_outputs(cycle_kernel_run(*ins, program,
                                                          n_taps))
    cts = tuple(torch.as_tensor((rng.standard_normal(tuple(t.shape))
                                 * 0.5).astype(np.float32), device=dev)
                for t in flat)
    return cts, tuple(tuple(t.shape for t in g) for g in ins), recs


def compare_reverse(name, k, p):
    """Reverse kernel gradients ``k`` (feeds, registers, states) against
    interpret_adjoint's ``p``: each feed's in dBFS (max-normalized), the
    registers' and states' in max abs; returns (the worst feed dBFS, the
    largest absolute feed error)."""
    check(all(len(a) == len(b) for a, b in zip(k, p)),
          f"{name}: output structure differs")
    f_db, f_abs, st_err = -np.inf, 0.0, 0.0
    for a, b in zip(k[0], p[0]):
        a, b = host(a), host(b)
        check(a.shape == b.shape, f"{name}: shapes {a.shape} vs {b.shape}")
        f_abs = max(f_abs, float(np.abs(a - b).max()))
        if np.abs(b).max() > 0:
            f_db = max(f_db, dbfs(a, b))
        else:                          # a feed no term reads
            check(not np.abs(a).any(), f"{name}: an unread feed's gradient")
    for a, b in zip((*k[1], *k[2]), (*p[1], *p[2])):
        a, b = host(a), host(b)
        check(a.shape == b.shape, f"{name}: shapes {a.shape} vs {b.shape}")
        st_err = max(st_err, float(np.abs(a - b).max()))
    print(f"  {name:34s} feeds {f_db:8.1f} dBFS  registers+states max abs "
          f"{st_err:.2e}")
    check(f_db <= Y_BOUND_DB, f"{name}: feed gradients {f_db:.1f} dBFS")
    check(st_err <= STATE_ATOL, f"{name}: register and state gradients "
                                f"{st_err:.2e} > {STATE_ATOL}")
    return f_db, f_abs


def cycle_reverse_phase(dev, card) -> dict:
    """The reverse cycle kernel against interpret_adjoint on identical
    inputs (cycle_reverse_cases, and config5's program at the main path's
    [B_C5, T_MAIN], where both are timed), the record build bitwise the
    render build; the kernel's time beside its bound and its
    dependent-chain floor.  Returns those numbers."""
    import torch
    import dsp_stuff_tpu_torch as dst
    from dsp_stuff_tpu_torch.models import presets
    from dsp_stuff_tpu_torch.ops import cycle_segment
    t_phase = time.time()
    rng = np.random.default_rng(130)
    print("reverse cycle kernel vs interpret_adjoint (the shapers' inputs "
          "from the record build, bitwise the render build's):")
    with dst.policy("fast"):
        for name, program, n_taps, b, t in cycle_reverse_cases():
            cts, shapes, recs = reverse_inputs(program, n_taps, b, t, rng,
                                               dev)
            k = cycle_segment._kernel_cycle_adjoint(cts, shapes, program,
                                                    n_taps, recs)
            p = cycle_segment.interpret_adjoint(cts, shapes, program,
                                                n_taps, recs)
            torch.cuda.synchronize()
            compare_reverse(name, k, p)
        del k, p
        program, n_taps = cycle_program(presets.config5_feedback_16node()[0])
        cts, shapes, recs = reverse_inputs(program, n_taps, B_C5, T_MAIN,
                                           rng, dev)

        def run():
            return cycle_segment._kernel_cycle_adjoint(cts, shapes, program,
                                                       n_taps, recs)

        k = run()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        p = cycle_segment.interpret_adjoint(cts, shapes, program, n_taps,
                                            recs)
        e1.record()
        torch.cuda.synchronize()
        _, err = compare_reverse(f"config5 [{B_C5}, {T_MAIN}]", k, p)
        del k, p
        torch.cuda.empty_cache()
        path_ms = cuda_ms(run)
        ms, n_prof = kernel_device_ms(run, "cycle_reverse_kernel")
    # "ms" is the path's time, as every kernel's in the kernels line; the
    # kernel's own device time goes beside it as "device_ms"
    rec = dict(ms=path_ms, device_ms=ms, plain_ms=e0.elapsed_time(e1),
               err=err, bound=cycle_reverse_bound(program, B_C5, T_MAIN),
               floor=cycle_reverse_floor_ms(program, T_MAIN))
    bms, bby = rec["bound"]
    dev = (f"{ms:.3f} ms the kernel's device time ({n_prof} launches "
           f"profiled)" if ms is not None else
           f"the kernel's device time not measured (no profile showed its "
           f"launches, the last {n_prof})")
    print(f"reverse cycle kernel, config5's program, [{B_C5}, {T_MAIN}]: "
          f"{dev}, {path_ms:.3f} ms the kernel's path (median of "
          f"{N_TIMED}), its plain version {rec['plain_ms']:.1f} ms (one "
          f"call); bound {bms:.3f} ms by {bby} ({bms / path_ms:.1%} of the "
          f"path), dependent-chain floor {rec['floor']:.3f} ms "
          f"({reverse_block_path_ops(program)} operations a block at "
          f"{SM_CLOCK_GHZ} GHz, {rec['floor'] / (ms or path_ms):.1%} of the "
          f"{'kernel' if ms is not None else 'path'}) [{card}]")
    print(f"reverse cycle phase: {time.time() - t_phase:.1f} s")
    return rec


def chain_reverse_inputs(stages, lfos, B, T, rng, dev):
    """(x's shape, states, cotangents, recorded inputs) of the reverse
    chain kernel for ``stages`` over [B, T]: seeded operands, a seeded
    cotangent of every output (flatten_outputs' order), and the shapers'
    inputs recorded by the forward kernel's record build, whose outputs
    must be bitwise the render build's."""
    import torch
    from dsp_stuff_tpu_torch.ops import chain_kernel, chain_segment
    x = torch.as_tensor((rng.standard_normal((B, T)) * 0.3)
                        .astype(np.float32), device=dev)
    st = seeded_states(stages, B, rng, dev, T=T, lfos=lfos)
    if chain_kernel.has_shaper(stages):
        outs, recs = chain_segment._kernel_segment(x, stages, st,
                                                   record=True)
        same = all(torch.equal(a, b) for a, b in zip(
            _leaves(outs), _leaves(kernel_segment(x, stages, st))))
        check(same, "the chain kernel's record build's outputs are not the "
                    "render build's")
    else:
        outs, recs = kernel_segment(x, stages, st), ()
    flat = chain_segment.flatten_outputs(outs)
    cts = tuple(torch.as_tensor((rng.standard_normal(tuple(t.shape))
                                 * 0.5).astype(np.float32), device=dev)
                for t in flat)
    return x, st, cts, recs


def compare_chain_reverse(name, stages, k, p, rtol=None):
    """Reverse chain kernel gradients ``k`` (x's, the states') against the
    plain version's ``p``: x's in dBFS (max-normalized), the states' in
    max abs; with ``rtol``, every gradient max-normalized within it
    instead (against the eager vjp).  Returns (x's dBFS, its largest
    absolute error)."""
    from dsp_stuff_tpu_torch.ops import chain_segment
    shared = chain_segment._shared_slots(stages)
    kx, px = host(k[0]), host(p[0])
    check(kx.shape == px.shape, f"{name}: x's gradient {kx.shape} vs "
                                f"{px.shape}")
    x_db = dbfs(kx, px)
    x_abs = float(np.abs(kx - px).max())
    st_err = 0.0
    for i, (a, b) in enumerate(zip(k[1], p[1])):
        if i in shared:
            check(a is None, f"{name}: a trajectory operand's gradient")
            continue
        a, b = host(a), host(b)
        check(a.shape == b.shape, f"{name}: shapes {a.shape} vs {b.shape}")
        st_err = max(st_err, float(
            np.abs(a - b).max() / (max(np.abs(b).max(), 1e-30)
                                   if rtol is not None else 1.0)))
    if rtol is not None:
        x_rel = x_abs / max(float(np.abs(px).max()), 1e-30)
        print(f"  {name:34s} x {x_rel:.2e}, states {st_err:.2e} "
              f"(max-normalized, rtol {rtol})")
        check(x_rel <= rtol and st_err <= rtol,
              f"{name}: gradients {x_rel:.2e} / {st_err:.2e} > {rtol}")
        return x_db, x_abs
    print(f"  {name:34s} x {x_db:8.1f} dBFS  states max abs {st_err:.2e}")
    check(bool(np.isfinite(kx).all()), f"{name}: x's gradient not finite")
    check(x_db <= Y_BOUND_DB, f"{name}: x's gradient {x_db:.1f} dBFS")
    check(st_err <= STATE_ATOL, f"{name}: state gradients {st_err:.2e} > "
                                f"{STATE_ATOL}")
    return x_db, x_abs


def chain_reverse_phase(dev, card) -> dict:
    """The reverse chain kernel against segment_adjoint on identical
    cotangents and recorded inputs (reverse_lists at [1, 128], [3, 8,320]
    and [8, 48,000], reverse_edge_lists at the last two, the 40 stages
    also with 1, 2 and 3 operand slots at [3, 8,320]), the record build
    bitwise the render build; at the
    main path's [B_GRAD, T_MAIN] on the bench list against the eager vjp
    (segment_vjp, the parent's backward), ten launches bitwise equal, and
    timed: the kernel's path, its own device time, its plain version, the
    eager vjp, its bound and one cascade's transposed product as
    torch.matmul; and the kernel's path and device time on the bench list
    at [B_MAIN, T_MAIN], its first B_GRAD rows there against
    segment_adjoint.  Returns those numbers."""
    import torch
    import dsp_stuff_tpu_torch as dst
    from dsp_stuff_tpu_torch.ops import chain_segment
    t_phase = time.time()
    rng = np.random.default_rng(140)
    print("reverse chain kernel vs segment_adjoint (the shapers' inputs "
          "from the record build, bitwise the render build's):")
    errs = []
    cases = [(name, stages, lfos, b, t, None)
             for name, (stages, lfos) in reverse_lists().items()
             for b, t in ((1, 128), (3, 8320), (8, 48_000))]
    cases += [(name, stages, lfos, b, t, None)
              for name, (stages, lfos) in reverse_edge_lists().items()
              for b, t in ((3, 8320), (8, 48_000))]
    cases += [("40 stages", long_list(), (), 3, 8320, n) for n in (1, 2, 3)]
    with dst.policy("fast"):
        for name, stages, lfos, b, t, nslot in cases:
            x, st, cts, recs = chain_reverse_inputs(stages, lfos, b, t, rng,
                                                    dev)
            shapes = tuple(v.shape for v in (x, *st))
            with (capped_slots(nslot) if nslot is not None
                  else contextlib.nullcontext()):
                k = chain_segment._kernel_segment_adjoint(cts, shapes, stages,
                                                          recs, st)
            p = chain_segment.segment_adjoint(cts, shapes, stages, recs, st)
            torch.cuda.synchronize()
            label = f"{name} [{b}, {t}]" + (f", {nslot} slots" if nslot
                                            else "")
            errs.append(compare_chain_reverse(label, stages, k, p)[1])
        del x, st, cts, recs, k, p
        torch.cuda.empty_cache()
        stages, lfos = reverse_lists()["bench"]
        x, st, cts, recs = chain_reverse_inputs(stages, lfos, B_GRAD, T_MAIN,
                                                rng, dev)
        shapes = tuple(v.shape for v in (x, *st))

        def run():
            return chain_segment._kernel_segment_adjoint(cts, shapes, stages,
                                                         recs, st)

        k = run()
        # the eager vjp linearizes at segment_fallback's forward: held
        # against the kernel fed that forward's records (the kernel's own
        # records differ by its 3xTF32 rounding, which moves a few inputs
        # of chebyshev across its kink at 0, where the derivative jumps)
        need = (True,) * (1 + len(st))
        vjp = chain_segment.segment_vjp(x, stages, st, cts, need)
        _, frecs = chain_segment.segment_fallback(x, stages, st, record=True)
        kf = chain_segment._kernel_segment_adjoint(cts, shapes, stages, frecs,
                                                   st)
        compare_chain_reverse(f"bench [{B_GRAD}, {T_MAIN}] vs the eager vjp",
                              stages, kf, (vjp[0], vjp[1:]), rtol=GRAD_RTOL)
        ews = [st_ for st_ in stages if st_[0] == "ew"]
        flips = sum(int(((a >= 0) != (b >= 0)).sum()) for a, b, st_ in
                    zip(recs, frecs, ews) if st_[1] == "chebyshev")
        rel = float((k[0] - vjp[0]).abs().max() / vjp[0].abs().max())
        print(f"  the kernel on its own records vs the eager vjp: x "
              f"{rel:.2e} max-normalized; chebyshev inputs of opposite sign "
              f"in the two forwards: {flips}")
        del vjp, frecs, kf
        torch.cuda.empty_cache()
        same = all(torch.equal(k[0], run()[0]) and all(
            torch.equal(a, b) for a, b in zip(k[1], run()[1]))
            for _ in range(N_DETERMINISM - 1))
        check(same, f"the reverse chain kernel's {N_DETERMINISM} launches "
                    f"differ")
        print(f"  {N_DETERMINISM} launches at [{B_GRAD}, {T_MAIN}]: bitwise "
              f"equal")
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        p = chain_segment.segment_adjoint(cts, shapes, stages, recs, st)
        e1.record()
        torch.cuda.synchronize()
        _, err = compare_chain_reverse(f"bench [{B_GRAD}, {T_MAIN}]", stages,
                                       k, p)
        del k, p
        torch.cuda.empty_cache()
        path_ms = cuda_ms(run)
        ms, n_prof = kernel_device_ms(run, "chain_reverse_kernel")
        vjp_ms = cuda_ms(lambda: chain_segment.segment_vjp(
            x, stages, st, cts, need), N_TIMED_SLOW)
        lib_ms = matmul_t_ms(stages[0][1], B_GRAD, T_MAIN, dev)
        del x, st, cts, recs
        torch.cuda.empty_cache()
        # the wide batch: B_MAIN rows, four waves of one CTA an SM
        x, st, cts, recs = chain_reverse_inputs(stages, lfos, B_MAIN, T_MAIN,
                                                rng, dev)
        shapes = tuple(v.shape for v in (x, *st))
        del x
        path_w = cuda_ms(run)
        ms_w, n_w = kernel_device_ms(run, "chain_reverse_kernel")
        # its first B_GRAD rows against the plain version (rows are
        # independent)
        kw = run()
        kw = (kw[0][:B_GRAD], tuple(g[:B_GRAD] for g in kw[1]))
        p = chain_segment.segment_adjoint(
            tuple(c[:B_GRAD] for c in cts),
            tuple((B_GRAD,) + tuple(v[1:]) for v in shapes), stages,
            tuple(r[:B_GRAD] for r in recs), tuple(v[:B_GRAD] for v in st))
        torch.cuda.synchronize()
        errs.append(compare_chain_reverse(
            f"bench [{B_MAIN}, {T_MAIN}], rows 0-{B_GRAD - 1}", stages, kw,
            p)[1])
        del st, cts, recs, kw, p
        torch.cuda.empty_cache()
    rec = dict(ms=path_ms, device_ms=ms, plain_ms=e0.elapsed_time(e1),
               vjp_ms=vjp_ms, lib_ms=lib_ms, err=max(errs + [err]),
               bound=chain_bound(stages, B_GRAD, T_MAIN, reverse=True),
               ms_wide=path_w, device_ms_wide=ms_w,
               bound_wide=chain_bound(stages, B_MAIN, T_MAIN, reverse=True))
    bw, _ = rec["bound_wide"]
    dev_w = (f"{ms_w:.3f} ms the kernel's device time ({n_w} launches "
             f"profiled, bound {bw:.3f} ms, {bw / ms_w:.1%})"
             if ms_w is not None else
             f"the kernel's device time not measured (no profile showed its "
             f"launches, the last {n_w})")
    print(f"reverse chain kernel, bench list, [{B_MAIN}, {T_MAIN}]: {dev_w}, "
          f"{path_w:.3f} ms the kernel's path [{card}]")
    bms, bby = rec["bound"]
    dev_s = (f"{ms:.3f} ms the kernel's device time ({n_prof} launches "
             f"profiled)" if ms is not None else
             f"the kernel's device time not measured (no profile showed its "
             f"launches, the last {n_prof})")
    print(f"reverse chain kernel, bench list, [{B_GRAD}, {T_MAIN}]: {dev_s}, "
          f"{path_ms:.3f} ms the kernel's path (median of {N_TIMED}), its "
          f"plain version {rec['plain_ms']:.1f} ms (one call), the eager "
          f"vjp {vjp_ms:.3f} ms; bound {bms:.3f} ms by {bby} "
          f"({bms / (ms or path_ms):.1%} of the "
          f"{'kernel' if ms is not None else 'path'}); one cascade's "
          f"transposed product as torch.matmul {lib_ms:.3f} ms [{card}]")
    print(f"reverse chain phase: {time.time() - t_phase:.1f} s")
    return rec


def timed_cycles(cg) -> list:
    """Wrap ``cg._eval_cycle`` so that each call appends (wall ms, CUDA
    event ms) of the feedback cycle's evaluation, the card synchronized
    on both sides: the loop's wall time and its span on the device."""
    import torch
    spans: list = []
    inner = cg._eval_cycle

    def timed(*args, **kwargs):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e0.record()
        inner(*args, **kwargs)
        e1.record()
        torch.cuda.synchronize()
        spans.append(((time.perf_counter() - t0) * 1e3, e0.elapsed_time(e1)))
    cg._eval_cycle = timed
    return spans


def chunk_device_ms(loop, bodies: int, first: int, n: int) -> float:
    """Device ms of one replay of the loop's graph of ``bodies`` bodies:
    ``n`` replays back to back from block ``first`` (the counter stays
    inside the render), over CUDA events.  The buffers are left as the
    replays leave them; a render loads them again."""
    import torch
    graph = loop.graphs[bodies][0]
    loop.counter.fill_(first)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    e0.record()
    for _ in range(n):
        graph.replay()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / n


def loop_group_bounds(loop) -> tuple:
    """The bytes bounds in us of a loop body's pointwise groups, all of a
    block together, at the loop's rows x its block: forward, each signal
    operand read and each output written once; reverse, each signal
    operand and each output's cotangent read and each signal's gradient
    written once (the scan's lowered groups, ``_CycleScan._lowerings``)."""
    rows = math.prod(next(iter(loop.prev.values())).shape[:-1])
    fwd = rev = 0
    for prog, sigs, _, written in loop.scan._lowerings.values():
        fwd += len(sigs) + len(written)
        rev += 2 * len(sigs) + len(written)
    one = 4.0 * rows * loop.block
    return bound(one * fwd, 0.0)[0] * 1e3, bound(one * rev, 0.0)[0] * 1e3


def replay_kernel_us(graph, n: int) -> dict:
    """Each of the port's kernels in ``n`` replays of a captured ``graph``
    by torch.profiler (opened with PROFILE_LEAD_IN spin kernels, which
    take the trace's loss of its first device records): {instance_of
    (the reverse pointwise kernel's pass 2 apart, "pointwise_reverse:
    sums"): (device us a launch, launches a replay)}."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_LEAD_IN):
            torch.cuda._sleep(1000)
        for _ in range(n):
            graph.replay()
        torch.cuda.synchronize()
    us: dict = {}
    count: dict = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        inst = instance_of(e.name)
        if inst is None:
            continue
        if "kernel_sums" in e.name:
            inst += ":sums"
        us[inst] = us.get(inst, 0.0) + (
            e.device_time_total if hasattr(e, "device_time_total")
            else e.cuda_time_total)
        count[inst] = count.get(inst, 0) + 1
    return {k: (us[k] / count[k], count[k] / n) for k in us}


def reverse_kernel_us(loop, n: int) -> dict:
    """replay_kernel_us of a differentiated loop's reverse graph over
    ``n`` (<= SEGMENT) blocks from the first block past its head, on the
    records its last backward left (the counter and the segment's first
    block set so that every replay reads a record slot it wrote)."""
    from dsp_stuff_tpu_torch.compiler import cycle_loop
    graph = next(g for k, (g, _) in loop.graphs.items()
                 if isinstance(k, tuple) and k[0] == "reverse")
    n = min(n, cycle_loop.SEGMENT)
    first = int(loop.grad.seg)
    loop.grad.seg.fill_(first)
    loop.counter.fill_(first + n)
    return replay_kernel_us(graph, n)


def loop_graph_nodes(cg, name, bodies) -> dict:
    """The nodes of the last loop's graph of ``bodies`` bodies, from its
    DOT dump."""
    os.makedirs(GRAPH_DIR, exist_ok=True)
    path = os.path.join(GRAPH_DIR, re.sub(r"\W+", "_", name) + ".dot")
    cg.cycle_loops.dump_graph(path, bodies)
    return dot_nodes(path)


def same_tree(a, b) -> bool:
    """Equal trees of states and aux: tensors bitwise, the rest equal."""
    import torch
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same_tree(a[k], b[k]) for k in a)
    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.shape == b.shape
                and torch.equal(a, b))
    return type(a) is type(b) and a == b


def cycle_loop_phase(dev, card) -> dict:
    """config5's feedback cycle through the per-node scan at B_LOOP x 10 s
    under parity, exact and fast with the feedback gain overridden (the
    per-node route with the first-order kernel): the loop captured in
    CUDA graphs of K = CHUNK bodies and replayed (compiler/cycle_loop.py),
    bitwise the eager Python loop on the card (output, aux, state), stream
    0's first second against the composed oracle, a second render of the
    same key with no capture; walls of the loop eager and replayed, its
    device time (the graphs replayed back to back), captures, replays,
    the nodes of one chunk from its DOT dump and the launches of each
    kernel inside the replayed loop (the cycle's two pointwise groups once
    a block); the loop without its groups, bitwise, its kernels a block
    and both loops' times in turns (loop_groups_turns); under parity also
    K in LOOP_KS.  Returns each path's record."""
    import torch
    import dsp_stuff_tpu_torch as dst
    from dsp_stuff_tpu_torch.compiler import cycle_loop
    from dsp_stuff_tpu_torch.models import presets
    t_phase = time.time()
    g5, _ = presets.config5_feedback_16node()
    fbg = next(i for i, nd in sorted(g5.nodes.items())
               if nd.cfg_name == "gain" and nd.params["level"] == 0.45)
    x_np = (np.random.default_rng(140).standard_normal((B_LOOP, 1, T_MAIN),
                                                       dtype=np.float32)
            * np.float32(0.3))
    x = torch.as_tensor(x_np, device=dev)
    ref = oracle_config5(x_np[0, 0, :SR])
    K = cycle_loop.CHUNK
    paths = (("parity", "parity", None, PARITY_DB),
             ("exact", "exact", None, EXACT_DB),
             ("fast-override", "fast", {str(fbg): {"level": 0.45}},
              ORACLE_FAST_DB))
    out = {}
    for name, pol, params, limit in paths:
        with dst.policy(pol):
            cg = dst.compile_graph(g5, device="cuda")
            loops = cg.cycle_loops
            spans = timed_cycles(cg)

            def render(route, chunk=K):
                loops.route, cycle_loop.CHUNK = route, chunk
                reset_launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got = cg.render(x, batch_shape=(B_LOOP,), params=params)
                torch.cuda.synchronize()
                return got, (time.perf_counter() - t0) * 1e3, spans[-1]

            torch.cuda.reset_peak_memory_stats(dev)
            eager, wall_e1, span_e1 = render("eager")
            peak_e = torch.cuda.max_memory_allocated(dev) / 2**30
            check(loops.captures == loops.replays == 0,
                  f"{name}: the eager route captured")
            torch.cuda.reset_peak_memory_stats(dev)
            replayed, wall_r1, span_r1 = render("auto")
            peak = torch.cuda.max_memory_allocated(dev) / 2**30
            plan, caps1, cap_s = loops.plan, loops.captures, loops.capture_s
            check(plan is not None and plan[1] > 0,
                  f"{name}: the loop did not run as graphs: {plan}")
            bit = all(same_tree(a, b) for a, b in zip(replayed, eager))
            err = dbfs(host(replayed[0]), host(eager[0]))
            print(f"cycle loop, config5 {name}, [{B_LOOP}, 1, {T_MAIN}]: "
                  f"replayed vs eager on the card: output, aux and state "
                  f"bitwise {bit} ({err:.1f} dBFS)")
            check(bit, f"{name}: the replayed loop is not bitwise the eager "
                       f"loop ({err:.1f} dBFS)")
            r0 = loops.replays
            again, wall_r2, span_r2 = render("auto")
            check(loops.captures == caps1,
                  f"{name}: a second render of the same key captured "
                  f"{loops.captures - caps1} graphs")
            check(loops.replays - r0 == plan[1] + plan[2],
                  f"{name}: {loops.replays - r0} replays, plan {plan}")
            check(torch.equal(again[0], replayed[0]),
                  f"{name}: two replayed renders differ")
            _, wall_e2, span_e2 = render("eager")
            y0 = host(replayed[0][0, 0, :SR])
            d = dbfs(y0, ref)
            print(f"  stream 0, first second vs the composed oracle: "
                  f"{d:.1f} dBFS (<= {limit}), bitwise "
                  f"{bool(np.array_equal(y0, ref))}")
            check(d <= limit, f"{name} vs the oracle {d:.1f} dBFS")
            loop = loops.last
            head, full, rest = plan
            nodes = {k: loop_graph_nodes(cg, f"cycle loop {name} {k}", k)
                     for k in (K, 1) if k in loop.graphs}
            inside = {}
            for k, count in ((K, full), (1, rest)):
                for inst, n in (nodes.get(k, {}).get("inst") or {}).items():
                    inside[inst] = inside.get(inst, 0) + n * count
            dev_k = chunk_device_ms(loop, K, head, min(N_LOOP_TIMED, full))
            dev_1 = (chunk_device_ms(loop, 1, head, N_LOOP_TIMED)
                     if 1 in loop.graphs else 0.0)
            device_ms = dev_k * full + dev_1 * rest
            nk = nodes[K]
            print(f"  loop wall ms, eager {span_e1[0]:.1f} / {span_e2[0]:.1f} "
                  f"(first / last render), replayed {span_r1[0]:.1f} (first "
                  f"render: {caps1} captures in {cap_s * 1e3:.1f} ms, warm-up "
                  f"included) / {span_r2[0]:.1f}; its span on the card (CUDA "
                  f"events) eager {span_e2[1]:.1f}, replayed {span_r2[1]:.1f}; "
                  f"device time of the replayed loop {device_ms:.1f} ms "
                  f"({dev_k:.3f} ms a {K}-body replay x {full}, {dev_1:.3f} "
                  f"x {rest}; head {head} eager blocks); render wall eager "
                  f"{wall_e1:.1f} / {wall_e2:.1f}, replayed {wall_r1:.1f} / "
                  f"{wall_r2:.1f}; peak GiB eager {peak_e:.2f}, replayed "
                  f"{peak:.2f} [{card}]")
            want = {"fast-override": "first_order",
                    "exact": "sequential<0>"}.get(name)
            check(want is None or inside.get(want, 0) >= full + rest,
                  f"{name}: the replayed loop launched {inside}, expected "
                  f"{want} once a block")
            print(f"  K = {K}: {loops.replays - r0} replays a render "
                  f"({full} x {K} bodies + {rest} x 1); one chunk's graph: "
                  f"{nk['kinds']}, the port's kernels {nk['inst']}, plain "
                  f"kernels by name (top 8) "
                  f"{sorted(nk['names'].items(), key=lambda kv: -kv[1])[:8]}; "
                  f"the port's launches inside the replayed loop {inside}")
            check(nk["ours"].get("pointwise", 0) == 2 * K
                  and inside.get("pointwise", 0) == 2 * (full * K + rest),
                  f"{name}: the replayed loop's bodies launch the pointwise "
                  f"kernel {nk['ours'].get('pointwise', 0)} times a chunk "
                  f"of {K}, {inside.get('pointwise', 0)} in all; expected "
                  f"the cycle's two groups once a block")
            rec = dict(plan=plan, captures=caps1, capture_ms=cap_s * 1e3,
                       loop_eager_ms=span_e2[0], loop_replayed_ms=span_r2[0],
                       loop_first_ms=span_r1[0], device_ms=device_ms,
                       chunk_ms=dev_k, inside=inside, oracle_db=d,
                       render_eager_ms=wall_e2, render_replayed_ms=wall_r2,
                       peak_eager_gib=peak_e, peak_gib=peak)
            rec["groups"] = loop_groups_turns(cg, name, render, replayed,
                                              nk, head, full, card)
            if name == "parity":
                # each K captured first, then two rounds of renders in
                # turns (the loops of every K stay cached)
                caps = {}
                for k in LOOP_KS:
                    c0, s0 = loops.captures, loops.capture_s
                    render("auto", k)
                    caps[k] = (loops.captures - c0,
                               (loops.capture_s - s0) * 1e3)
                walls = {k: [] for k in LOOP_KS}
                for _ in range(2):
                    for k in LOOP_KS:
                        got, _, span = render("auto", k)
                        check(same_tree(got[2], eager[2])
                              and torch.equal(got[0], eager[0]),
                              f"{name}, K = {k}: not bitwise the eager loop")
                        walls[k].append(span[0])
                rec["ks"] = {}
                for k in LOOP_KS:
                    render("auto", k)
                    hk, fk, _ = loops.plan
                    rec["ks"][k] = (walls[k], chunk_device_ms(
                        loops.last, k, hk, min(N_LOOP_TIMED, fk)), caps[k])
                print(f"  parity by K (turns): loop wall ms, device ms a "
                      f"body, captures and their ms on a cached graph; "
                      + "; ".join(
                          f"K = {k}: {w[0]:.1f} / {w[1]:.1f}, {dk / k:.4f}, "
                          f"{c[0]} in {c[1]:.1f}"
                          for k, (w, dk, c) in sorted(rec["ks"].items()))
                      + f" [{card}]")
            out[name] = rec
            del eager, replayed, again, loop, cg, loops
            torch.cuda.empty_cache()
    cycle_loop.CHUNK = K
    out["lengths"] = cycle_loop_lengths(dev, card)
    print(f"cycle loop phase: {time.time() - t_phase:.1f} s")
    return out


def loop_groups_turns(cg, name, render, replayed, nk, head, full,
                      card) -> dict:
    """The replayed loop without the fan-ins its pointwise groups take
    (fanins_off: the reverb's fan-in divide a kernel a block, the route
    before them) and without its groups (cycle_groups_off: each member's
    eager ops, the route before the cycle's groups) against the loop as
    shipped (``replayed``, its chunk's nodes ``nk``): bitwise (output,
    aux, state); a block's kernels, pointwise launches and copies from
    each graph's DOT dump; the loop's wall and device time a render (CUDA
    events over the K-body graph replayed back to back,
    ``chunk_device_ms``) in turns, shipped, no fan-ins, no groups, no
    groups, no fan-ins, shipped.  Returns the records."""
    import torch
    from dsp_stuff_tpu_torch.compiler import cycle_loop
    K = cycle_loop.CHUNK
    loops = cg.cycle_loops
    ways = {"groups": contextlib.nullcontext, "no fan-ins": fanins_off,
            "no groups": lambda: cycle_groups_off(cg)}
    nodes = {"groups": nk}
    for way in ("no fan-ins", "no groups"):
        with ways[way]():
            other, _, _ = render("auto")
            nodes[way] = loop_graph_nodes(cg, f"cycle loop {name} {way}", K)
        bit = all(same_tree(a, b) for a, b in zip(other, replayed))
        err = dbfs(host(other[0]), host(replayed[0]))
        check(bit, f"{name}: the replayed loop as shipped is not bitwise "
                   f"the replayed loop with {way} ({err:.1f} dBFS)")
        del other
    walls = {way: [] for way in ways}
    devs = {way: [] for way in ways}
    order = ("groups", "no fan-ins", "no groups")
    for way in order + order[::-1]:
        with ways[way]():
            _, _, span = render("auto")
            loop = loops.last
            walls[way].append(span[0])
            devs[way].append(chunk_device_ms(loop, K, head,
                                             min(N_LOOP_TIMED, full))
                             * (full / K))
        torch.cuda.synchronize()

    # the port's kernels in replays of the groups' loop (the last render)
    loop = loops.last
    loop.counter.fill_(head)
    kus = replay_kernel_us(loop.graphs[K][0], min(20, full) // K)

    def per_block(nodes):
        return dict(kernels=nodes["kinds"].get("KERNEL", 0) / K,
                    pointwise=nodes["ours"].get("pointwise", 0) / K,
                    copies=(nodes["kinds"].get("MEMCPY", 0)
                            + nodes["kinds"].get("MEMSET", 0)) / K)
    rec = {"bitwise": True, "walls": walls, "device_ms": devs,
           "with": per_block(nk), "without": per_block(nodes["no groups"]),
           "without_fanins": per_block(nodes["no fan-ins"]),
           "kernel_us": kus, "bound_us": loop_group_bounds(loop)[0]}
    blocks = {"groups": rec["with"], "no fan-ins": rec["without_fanins"],
              "no groups": rec["without"]}
    print(f"  as shipped / without the groups' fan-ins / without the "
          f"cycle's groups (each member's eager ops), bitwise True: a "
          f"block " + " / ".join(f"{blocks[w]['kernels']:g}" for w in order)
          + " kernels, pointwise " + " / ".join(
              f"{blocks[w]['pointwise']:g}" for w in order)
          + ", copies and memsets " + " / ".join(
              f"{blocks[w]['copies']:g}" for w in order)
          + f" (DOT dumps); in turns ({', '.join(order + order[::-1])}) "
          f"the loop's wall ms " + ", ".join(
              f"{walls[w][i]:.1f}" for i, w in
              [(0, w) for w in order] + [(1, w) for w in order[::-1]])
          + f", device ms of its {full} replayed blocks " + ", ".join(
              f"{devs[w][i]:.1f}" for i, w in
              [(0, w) for w in order] + [(1, w) for w in order[::-1]])
          + f" [{card}]")
    print(f"  the port's kernels in a replayed body by torch.profiler "
          f"(device us a launch, launches a body): "
          + ", ".join(f"{k} {u:.3f} x {c:g}" for k, (u, c)
                      in sorted(kus.items()))
          + f"; the groups' bytes bound {rec['bound_us']:.4f} us a body "
            f"[{card}]")
    return rec


def cycle_loop_lengths(dev, card) -> dict:
    """The render a user makes with ``dst.render``: a graph compiled for
    the call, rendered once.  config5 under parity and exact at B_SHORT x
    each of LOOP_LENGTHS blocks, each render on a graph compiled for it:
    the Python loop ("eager") against the replayed loop ("buffers", at
    each K of LENGTH_KS), its warm-up and captures included, in turns
    (eager, 1, 8, 8, 1, eager), each bitwise the eager render; the
    render's wall (compile excluded) and the peak memory above what was
    allocated before it.  Prints what the route "auto" takes at each
    length.  Returns {policy: {blocks: {route: ([ms, ms], [GiB, GiB])}}}."""
    import torch
    import dsp_stuff_tpu_torch as dst
    from dsp_stuff_tpu_torch.compiler import cycle_loop
    from dsp_stuff_tpu_torch.models import presets
    g5, _ = presets.config5_feedback_16node()
    K = cycle_loop.CHUNK
    rng = np.random.default_rng(160)
    out = {}
    for pol in ("parity", "exact"):
        rows = out[pol] = {}

        def render(x, route, chunk=K):
            cycle_loop.CHUNK = chunk
            with dst.policy(pol):
                cg = dst.compile_graph(g5, device="cuda")
                cg.cycle_loops.route = route
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated(dev)
                torch.cuda.reset_peak_memory_stats(dev)
                t0 = time.perf_counter()
                y, _, _ = cg.render(x, batch_shape=(B_SHORT,))
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                gib = (torch.cuda.max_memory_allocated(dev) - base) / 2**30
            cycle_loop.CHUNK = K
            return y, ms, gib, cg.cycle_loops.plan

        x0 = torch.as_tensor(rng.standard_normal(
            (B_SHORT, 1, 128 * LOOP_LENGTHS[0]), dtype=np.float32) * 0.3,
            device=dev)
        for route in ("eager", "buffers"):
            render(x0, route)                    # the process warm
        for nb in LOOP_LENGTHS:
            x = torch.as_tensor(rng.standard_normal(
                (B_SHORT, 1, 128 * nb), dtype=np.float32) * 0.3, device=dev)
            k0, k1 = LENGTH_KS
            got = {"eager": ([], []), f"K = {k0}": ([], []),
                   f"K = {k1}": ([], [])}
            want = None
            for route, chunk in (("eager", K), ("buffers", k0),
                                 ("buffers", k1), ("buffers", k1),
                                 ("buffers", k0), ("eager", K)):
                y, ms, gib, plan = render(x, route, chunk)
                label = "eager" if route == "eager" else f"K = {chunk}"
                got[label][0].append(ms)
                got[label][1].append(gib)
                if want is None:
                    want = y
                check(torch.equal(y.view(torch.int32),
                                  want.view(torch.int32)),
                      f"{pol} at {nb} blocks: {label} differs from eager")
                check((plan is None) == (route == "eager"),
                      f"{pol} at {nb} blocks, {label}: plan {plan}")
                del y
            rows[nb] = got
            takes = ("replayed" if nb >= cycle_loop.MIN_BLOCKS else "eager")
            print(f"cycle loop by length, config5 {pol}, [{B_SHORT}, 1, "
                  f"{128 * nb}] ({nb} blocks), a graph compiled a render: "
                  + "; ".join(f"{label} {ms[0]:.1f} / {ms[1]:.1f} ms, peak "
                              f"{gib[0] * 1024:.1f} / {gib[1] * 1024:.1f} MiB"
                              for label, (ms, gib) in got.items())
                  + f"; auto takes {takes} [{card}]")
            del x, want
    torch.cuda.empty_cache()
    return out


def loop_grads(cg, route, x, target, state=None):
    """One differentiated render of config5 on ``route`` with every slider
    a leaf: (loss, {slider: gradient}, the input's gradient, the final
    state, wall ms).  The input is [B, T] on the graph's device."""
    import torch
    from dsp_stuff_tpu_torch.train import fit
    cg.cycle_loops.route = route
    params = cg.init_params(requires_grad=True)
    xx = x.clone().requires_grad_()
    state = cg.init_state() if state is None else state
    sync = cg.device.type == "cuda"
    if sync:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    st, outs, _ = cg.fn(state, {str(min(cg.input_ids)): xx}, params)
    y = torch.stack([outs[i] for i in cg.output_ids], dim=-2)
    loss = torch.mean(fit.mse_loss(y, target))
    loss.backward()
    if sync:
        torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    grads = {f"{n}:{k}": v.grad for n, e in params.items()
             for k, v in e.items()}
    return loss.detach(), grads, xx.grad, st, ms


def held_grads(what, got, want, rtol, atol) -> tuple:
    """Each slider's and the input's gradient of ``got`` against ``want``
    (loop_grads' tuples): an array max-normalized within ``rtol``, a
    slider within ``rtol`` or ``atol`` near 0, a slider no block reads
    without a gradient in both.  Returns (worst slider error, input
    error, every gradient bitwise)."""
    import torch
    worst, bit = 0.0, True
    check(got[1].keys() == want[1].keys(), f"{what}: sliders differ")
    for k, w in want[1].items():
        g = got[1][k]
        check((g is None) == (w is None), f"{what}: {k} has a gradient in "
                                          f"one run only")
        if w is None:
            continue
        err = grad_close(f"{what}, slider {k}", g, w, rtol, atol)
        worst = max(worst, err if abs(float(w)) > atol else 0.0)
        bit = bit and torch.equal(g.cpu(), w.cpu())
    x_err = grad_close(f"{what}, the input", got[2], want[2], rtol)
    bit = bit and torch.equal(got[2].cpu(), want[2].cpu())
    return worst, x_err, bit


#: the port's kernels in a reverse graph's DOT dump by mode: the
#: first-order kernel forward (fo_chained<., false>: the block's forward
#: run again) and reverse (<., true>), the sequential kernel forward and
#: its reverse mode, the pointwise kernel (the groups' forward run again)
#: and the reverse pointwise kernel's passes 1 and 2
REVERSE_MODES = (("first_order:reverse", r"fo_chainedILb[01]ELb1E"),
                 ("first_order", r"fo_chainedILb[01]ELb0E"),
                 ("sequential:reverse", r"sequential_reverse_kernelILi\d"),
                 ("sequential", r"sequential_kernelILi\d"),
                 ("pointwise", r"pointwise_kernelILb[01]E"),
                 ("pointwise_reverse", r"pointwise_reverse_kernelILb[01]E"),
                 ("pointwise_reverse:sums", r"pointwise_reverse_kernel_sums"))


def reverse_launches(cg, name) -> dict:
    """The port's kernels in the last loop's reverse graph (one block),
    from its DOT dump: {mode of REVERSE_MODES: launches}, and under
    "kernels" every kernel node of the graph."""
    nodes = loop_graph_nodes(cg, name, "reverse")
    with open(nodes["path"]) as f:
        text = f.read()
    out = {"kernels": nodes["kinds"].get("KERNEL", 0)}
    for mode, pat in REVERSE_MODES:
        n = len(re.findall(pat, text))
        if n:
            out[mode] = n
    return out


@contextlib.contextmanager
def scan_spans(spans: dict):
    """Time the differentiated loop's forward (``_Loop.checkpointed``) and
    backward (``_Loop.backward``) by CUDA events, the card synchronized
    after each: appends (wall ms, device ms) to spans["forward"] and
    spans["backward"]."""
    import torch
    from dsp_stuff_tpu_torch.compiler import cycle_loop
    real = {n: getattr(cycle_loop._Loop, n) for n in ("checkpointed",
                                                      "backward")}

    def timed(name):
        def call(self, *args, **kwargs):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            e0.record()
            out = real[name](self, *args, **kwargs)
            e1.record()
            torch.cuda.synchronize()
            spans[{"checkpointed": "forward"}.get(name, name)].append(
                ((time.perf_counter() - t0) * 1e3, e0.elapsed_time(e1)))
            return out
        return call
    try:
        for n in real:
            setattr(cycle_loop._Loop, n, timed(n))
        yield spans
    finally:
        for n, f in real.items():
            setattr(cycle_loop._Loop, n, f)


def cycle_loop_grad_phase(dev, card) -> dict:
    """The backward of the per-node cycle scan (compiler/cycle_loop.py,
    ``_ScanGrad``): config5 with every slider a leaf at B_LOOP_GRAD x 1 s
    under parity, exact and fast, the replayed loop differentiated
    (forward, checkpoints, record and reverse bodies as CUDA graphs)
    against the Python loop's autograd on the card (loss, each slider's
    gradient, the input's, the final states; a second step captures
    nothing) and against the eager ops' Python loop (no groups in the
    cycle's block), and the card against the CPU port at 2 x
    LOOP_GRAD_CPU_BLOCKS blocks; the reverse graph's kernels from its DOT
    dump (the reverse pointwise kernel once a group), with and without
    the cycle's groups; then make_train_step steps of config5 under fast
    at B_LOOP x 10 s, with and without the cycle's groups in turns (loss,
    step wall, captures, replays, the scan's forward and backward time,
    peak memory) beside one step of the Python loop; then the break-even
    by length (LOOP_GRAD_LENGTHS blocks at B_SHORT, a graph compiled a
    step).  Returns the records."""
    import torch
    import dsp_stuff_tpu_torch as dst
    from dsp_stuff_tpu_torch.compiler import cycle_loop
    from dsp_stuff_tpu_torch.models import presets
    from dsp_stuff_tpu_torch.train import fit
    t_phase = time.time()
    g5, meta = presets.config5_feedback_16node()
    inp = str(meta["input"])
    rng = np.random.default_rng(170)

    def inputs(b, nb, device):
        x = rng.standard_normal((b, 128 * nb), dtype=np.float32) * 0.3
        t = rng.standard_normal((b, 1, 128 * nb), dtype=np.float32) * 0.1
        return (torch.as_tensor(x, device=device),
                torch.as_tensor(t, device=device))

    out = {}
    nb1 = SR // 128
    for pol in ("parity", "exact", "fast"):
        x, tgt = inputs(B_LOOP_GRAD, nb1, dev)
        with dst.policy(pol):
            cg = dst.compile_graph(g5, device="cuda")
            loops = cg.cycle_loops
            eager = loop_grads(cg, "eager", x, tgt)
            check(loops.plan is None and loops.captures == 0,
                  f"{pol}: the eager route ran the loop over buffers")
            got = loop_grads(cg, "auto", x, tgt)
            caps = dict(loops.captured)
            check(set(caps) == {"forward", "save", "restore", "record",
                                "reverse"} and all(v == 1 for v in
                                                   caps.values()),
                  f"{pol}: captures {caps}")
            r0 = loops.replays
            again = loop_grads(cg, "auto", x, tgt)
            check(dict(loops.captured) == caps,
                  f"{pol}: a second step captured {dict(loops.captured)}")
            head, full, rest = loops.plan
            n = nb1 - head
            segs = -(-n // cycle_loop.SEGMENT)
            check(loops.replays - r0 == full + rest + 2 * segs + 2 * n,
                  f"{pol}: {loops.replays - r0} replays, plan "
                  f"{loops.plan}")
            check(torch.equal(got[0], eager[0]),
                  f"{pol}: the loss differs from the eager loop's")
            check(same_tree(got[3], eager[3]),
                  f"{pol}: the final states differ from the eager loop's")
            worst, x_err, bit = held_grads(f"{pol} replayed vs eager", got,
                                           eager, LOOP_GRAD_TOL,
                                           LOOP_GRAD_ATOL)
            again_bit = held_grads(f"{pol} second step", again, got,
                                   LOOP_GRAD_TOL, LOOP_GRAD_ATOL)[2]
            rev = reverse_launches(cg, f"cycle loop grad {pol}")
            want = {"fast": "first_order:reverse",
                    "exact": "sequential:reverse"}.get(pol)
            check(want is None or rev.get(want) == 1,
                  f"{pol}: the reverse graph launches {rev}, expected "
                  f"{want} once a block")
            check(rev.get("pointwise_reverse") == 2,
                  f"{pol}: the reverse graph launches {rev}, expected the "
                  f"reverse pointwise kernel once a group (two) a block")
            # the eager ops' Python loop (no groups in the cycle's block)
            # under autograd, and the replayed loop without groups: its
            # reverse graph's kernels
            with cycle_groups_off(cg):
                ops = loop_grads(cg, "eager", x, tgt)
                loop_grads(cg, "auto", x, tgt)
                rev_n = reverse_launches(cg, f"cycle loop grad {pol} no "
                                             f"groups")
            check(torch.equal(got[0], ops[0]) and same_tree(got[3], ops[3]),
                  f"{pol}: the loss or the states differ from the eager "
                  f"ops' loop")
            worst_o, x_err_o, bit_o = held_grads(
                f"{pol} replayed vs the eager ops' loop", got, ops,
                LOOP_GRAD_TOL, LOOP_GRAD_ATOL)
            print(f"cycle loop backward, config5 {pol}, every slider a "
                  f"leaf, [{B_LOOP_GRAD}, {SR}] ({nb1} blocks, head {head}, "
                  f"S = {cycle_loop.SEGMENT}): replayed vs the eager "
                  f"autograd loop on the card: loss and states bitwise, "
                  f"worst slider {worst:.2e} (rtol {LOOP_GRAD_TOL}), input "
                  f"{x_err:.2e} max-normalized, gradients bitwise {bit}; "
                  f"captures {caps}, none on the second step (its "
                  f"gradients bitwise the first's {again_bit}); "
                  f"{loops.replays - r0} replays a step; the port's kernels "
                  f"a block in the reverse graph {rev}; step wall eager "
                  f"{eager[4]:.1f} ms, replayed {got[4]:.1f} (captures "
                  f"included) / {again[4]:.1f} ms [{card}]")
            print(f"  against the eager ops' Python loop under autograd (no "
                  f"groups in the cycle's block): loss and states bitwise, "
                  f"worst slider {worst_o:.2e}, input {x_err_o:.2e} "
                  f"max-normalized, gradients bitwise {bit_o}; the reverse "
                  f"graph without the cycle's groups {rev_n} [{card}]")
            out[pol] = dict(worst=worst, x_err=x_err, bitwise=bit,
                            captures=caps, reverse=rev, eager_ms=eager[4],
                            first_ms=got[4], ms=again[4], blocks=n,
                            ops_worst=worst_o, ops_x_err=x_err_o,
                            ops_bitwise=bit_o, reverse_no_groups=rev_n)
            del eager, got, again, ops, cg, loops
        # the card against the CPU port (the buffers' backward on both)
        xc, tc = inputs(2, LOOP_GRAD_CPU_BLOCKS, "cpu")
        with dst.policy(pol):
            cpu = loop_grads(dst.compile_graph(g5, device="cpu"), "buffers",
                             xc, tc)
            card_ = loop_grads(dst.compile_graph(g5, device="cuda"),
                               "buffers", xc.to(dev), tc.to(dev))
        check(abs(float(card_[0]) - float(cpu[0]))
              <= GRAD_RTOL * abs(float(cpu[0])), f"{pol}: loss vs the CPU")
        w_cpu, x_cpu, _ = held_grads(f"{pol} card vs CPU", card_, cpu,
                                     GRAD_RTOL, GRAD_ATOL)
        print(f"  card vs the CPU port, [2, {128 * LOOP_GRAD_CPU_BLOCKS}]: "
              f"worst slider {w_cpu:.2e}, input {x_cpu:.2e} (rtol "
              f"{GRAD_RTOL})")
        out[pol].update(cpu_worst=w_cpu, cpu_x_err=x_cpu)
        torch.cuda.empty_cache()

    # -- fit steps at full width, with and without the cycle's groups ------
    # (each way's first step captures its loop; then in turns: with,
    # without, without, with; each way from the same initial sliders)
    x, tgt = inputs(B_LOOP, T_MAIN // 128, dev)
    ext = {inp: x}
    with dst.policy("fast"):
        cg = dst.compile_graph(g5, device="cuda")
        loops = cg.cycle_loops
        step, init = fit.make_train_step(cg, fit.adam(1e-2))
        ways = ("groups", "no groups")
        params = {w: cg.init_params(requires_grad=True) for w in ways}
        opt = {w: init(params[w]) for w in ways}
        spans = {w: {"forward": [], "backward": []} for w in ways}
        all_steps = {w: [] for w in ways}
        firsts = {}
        torch.cuda.reset_peak_memory_stats(dev)
        osc_rev, vjps = [], {}
        for w in ways + ("groups", "no groups", "no groups", "groups"):
            c0, r0 = loops.captures, loops.replays
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            reset_launches()
            with scan_spans(spans[w]), (
                    cycle_groups_off(cg) if w == "no groups"
                    else contextlib.nullcontext()), \
                    forward_and_vjps_counted({}, vjps, first_order=False):
                e0.record()
                _, opt[w], loss = step(params[w], opt[w], cg.init_state(),
                                       ext, tgt)
                e1.record()
                torch.cuda.synchronize()
            osc_rev.append(read_launches()["oscillator_reverse"])
            if w not in firsts:
                firsts[w] = (float(loss), {
                    f"{n}:{kk}": vv.grad.clone()
                    for n, e in params[w].items() for kk, vv in e.items()
                    if vv.grad is not None})
            all_steps[w].append(dict(
                loss=float(loss), ms=e0.elapsed_time(e1),
                captures=loops.captures - c0, replays=loops.replays - r0,
                peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30))
        # the LFO's sliders are leaves: the reverse oscillator kernel's two
        # passes a step, the plain versions never run
        check(not vjps and all(n == 2 for n in osc_rev),
              f"fit steps: reverse oscillator launches {osc_rev}, the plain "
              f"versions run {vjps}")
        print(f"  fit steps: the reverse oscillator kernel launched "
              f"{osc_rev} times a step, interpret and oscillator_plain run "
              f"never")
        steps, first = all_steps["groups"], firsts["groups"][1]
        check(all(s["captures"] == 0 for w in ways
                  for s in all_steps[w][1:]),
              f"fit steps after each way's first captured: {all_steps}")
        check(all(np.isfinite(s["loss"]) for w in ways
                  for s in all_steps[w]), f"loss {all_steps}")
        check(firsts["groups"][0] == firsts["no groups"][0],
              f"the first step's loss with the cycle's groups "
              f"{firsts['groups'][0]} vs without {firsts['no groups'][0]}")
        check(firsts["no groups"][1].keys() == first.keys(),
              "the first step's sliders with a gradient differ with and "
              "without the cycle's groups")
        worst_n = 0.0
        for k, v in firsts["no groups"][1].items():
            worst_n = max(worst_n, grad_close(
                f"fit step 1 with vs without the cycle's groups, {k}",
                first[k], v, LOOP_GRAD_TOL, LOOP_GRAD_ATOL))
        for w in ways:
            for i, (s, (fw, fd), (bw, bd)) in enumerate(zip(
                    all_steps[w], spans[w]["forward"],
                    spans[w]["backward"])):
                print(f"fit step {i + 1} ({w} in the cycle's block), "
                      f"config5 fast, every slider a leaf, [{B_LOOP}, "
                      f"{T_MAIN}]: loss {s['loss']:.9g}, step "
                      f"{s['ms']:.1f} ms (CUDA events), {s['captures']} "
                      f"captures, {s['replays']} replays; the cycle's scan "
                      f"forward {fw:.1f} ms wall / {fd:.1f} device, backward "
                      f"{bw:.1f} / {bd:.1f}; peak {s['peak_gib']:.2f} GiB "
                      f"[{card}]")
        print(f"  the first step with the cycle's groups vs without: loss "
              f"bitwise, worst slider gradient {worst_n:.2e} (rtol "
              f"{LOOP_GRAD_TOL}); in turns (steps 2 and 3 of each) "
              f"{steps[1]['ms']:.1f}, {steps[2]['ms']:.1f} ms with against "
              f"{all_steps['no groups'][1]['ms']:.1f}, "
              f"{all_steps['no groups'][2]['ms']:.1f} without [{card}]")
        params, opt = params["groups"], opt["groups"]
        spans = spans["groups"]
        rev_us = reverse_kernel_us(loops.last, 20)
        rev_bound = loop_group_bounds(loops.last)[1]
        print(f"  the port's kernels in the fit's replayed reverse body by "
              f"torch.profiler (device us a launch, launches a block): "
              + ", ".join(f"{k} {u:.3f} x {c:g}" for k, (u, c)
                          in sorted(rev_us.items()))
              + f"; the groups' reverse bytes bound {rev_bound:.4f} us a "
                f"block [{card}]")
        n = T_MAIN // 128 - loops.plan[0]
        out["fit"] = dict(steps=steps, forward=spans["forward"],
                          backward=spans["backward"], blocks=n,
                          osc_reverse=osc_rev[-1],
                          reverse=reverse_launches(cg, "cycle loop grad fit"),
                          no_groups=all_steps["no groups"],
                          no_groups_worst=worst_n, kernel_us=rev_us,
                          bound_us=rev_bound)
        del loops, cg, step, opt, params
        torch.cuda.empty_cache()
        # the parent's route: the Python loop under autograd, one step
        cg = dst.compile_graph(g5, device="cuda")
        cg.cycle_loops.route = "eager"
        step, init = fit.make_train_step(cg, fit.adam(1e-2))
        params = cg.init_params(requires_grad=True)
        opt = init(params)
        torch.cuda.reset_peak_memory_stats(dev)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        _, opt, loss = step(params, opt, cg.init_state(), ext, tgt)
        e1.record()
        torch.cuda.synchronize()
        eager_ms = e0.elapsed_time(e1)
        eager_peak = torch.cuda.max_memory_allocated(dev) / 2**30
        check(float(loss) == steps[0]["loss"],
              f"the eager step's loss {float(loss)} vs {steps[0]['loss']}")
        worst = 0.0
        for k, w in first.items():
            v = params[k.split(":")[0]][k.split(":")[1]].grad
            worst = max(worst, grad_close(f"fit step 1, {k}", v, w,
                                          LOOP_GRAD_TOL, LOOP_GRAD_ATOL))
        print(f"  the Python loop under autograd, one step: {eager_ms:.1f} "
              f"ms, peak {eager_peak:.2f} GiB; its loss bitwise the "
              f"replayed step's, worst slider gradient {worst:.2e}; the "
              f"replayed steps {steps[1]['ms']:.1f} / {steps[2]['ms']:.1f} "
              f"ms ({eager_ms / steps[2]['ms']:.2f}x) [{card}]")
        out["fit"].update(eager_ms=eager_ms, eager_peak_gib=eager_peak,
                          eager_worst=worst)
        del cg, step, opt, params, x, tgt, ext
        torch.cuda.empty_cache()

    # -- the break-even by length -----------------------------------------
    lengths = {}
    for pol in ("fast", "parity"):
        for nb in LOOP_GRAD_LENGTHS:
            x, tgt = inputs(B_SHORT, nb, dev)
            walls = {"eager": [], "replayed": []}
            for route in ("eager", "buffers", "buffers", "eager"):
                with dst.policy(pol):
                    cg = dst.compile_graph(g5, device="cuda")
                    got = loop_grads(cg, route, x, tgt)
                walls["eager" if route == "eager" else "replayed"].append(
                    got[4])
                check((cg.cycle_loops.plan is None) == (route == "eager"),
                      f"{pol} at {nb} blocks, {route}: plan "
                      f"{cg.cycle_loops.plan}")
                check(cg.cycle_loops.captures == (0 if route == "eager"
                                                  else 5),
                      f"{pol} at {nb} blocks, {route}: "
                      f"{cg.cycle_loops.captures} captures")
            lengths[(pol, nb)] = walls
            print(f"cycle loop backward by length, config5 {pol}, "
                  f"[{B_SHORT}, {128 * nb}] ({nb} blocks), a graph compiled "
                  f"a step: eager {walls['eager'][0]:.1f} / "
                  f"{walls['eager'][1]:.1f} ms, replayed (its 5 captures "
                  f"included) {walls['replayed'][0]:.1f} / "
                  f"{walls['replayed'][1]:.1f} ms [{card}]")
    out["lengths"] = lengths
    torch.cuda.empty_cache()
    print(f"cycle loop grad phase: {time.time() - t_phase:.1f} s")
    return out


# -- the pointwise groups (compiler/pointwise.py, csrc/pointwise_kernel.cu) --

PW_FAST_DB = -100.0       # a group's kernel vs its plain version, fast
PW_SHAPES = ((4, 4096), (3, 1030), (1, 1027))  # float4, scalar, float4 + tail
PW_SPECIALS = (float("nan"), float("inf"), float("-inf"), 0.0, -0.0, 1e-40,
               -1e-40, 1e30, -1e30, 1.0, -1.0, 20.0, -20.0)
B_PW_WIDE = 512           # config5's second width (x 10 s)
PW_GRAPH_ROUTES = ("kernel", "groups", "plain", "eager")
ONE_FORM_SEEDS = (8, 27)  # fuzz graphs whose fan-ins make one-form groups


def pointwise_forms():
    """{name: (signals, sliders, lower, eager)} of every fusable form:
    ``signals`` the count of its signal operands (the second an unbatched
    [T] one, as an LFO), ``sliders`` its scalar operands' values,
    ``lower(b, xs, ps, pol)`` its lowering (compiler/pointwise.py) and
    ``eager(xs, ps)`` the eager code it mirrors (the node's process_seq,
    compile._avg, compile._map_mod)."""
    from dsp_stuff_tpu_torch.compiler import compile as comp
    from dsp_stuff_tpu_torch.compiler import pointwise as pw
    from dsp_stuff_tpu_torch.nodes.shapers import (Chebyshev, Distort,
                                                   Overdrive)
    from dsp_stuff_tpu_torch.nodes.simple import Add, Gain, Mix
    from dsp_stuff_tpu_torch.ops.shaping import BYPASS_EPS
    from dsp_stuff_tpu_torch.registry import ParamSpec

    def node(cls, ports, **select):
        def run(xs, ps):
            return cls.process_seq({**ps, **select}, None,
                                   dict(zip(ports, xs)))[0]["out"]
        return run

    drive = ParamSpec("drive", 0.0, 1.0, 0.0, as_input=True)
    forms = {
        "avg of 3": (3, {"divisor": float(comp._fanin_divisor(3))},
                     lambda b, xs, ps, pol: pw.avg(b, xs, ps["divisor"]),
                     lambda xs, ps: comp._avg(xs, xs[0].shape[-1])[0]),
        "map_mod": (1, {}, lambda b, xs, ps, pol: pw.map_mod(b, xs[0], 0.0,
                                                             1.0),
                    lambda xs, ps: comp._map_mod(xs[0], drive)),
        "gain": (1, {"level": 1.2}, lambda b, xs, ps, pol: pw.gain(
            b, xs[0], ps["level"]), node(Gain, ("in",))),
        "add": (2, {}, lambda b, xs, ps, pol: pw.add(b, *xs),
                node(Add, ("a", "b"))),
        "mix": (2, {"ratio": 0.6}, lambda b, xs, ps, pol: pw.mix(
            b, *xs, ps["ratio"]), node(Mix, ("a", "b"))),
        "overdrive": (1, {"boost": 6.0, "drive": 0.7, "level": 0.8},
                      lambda b, xs, ps, pol: pw.overdrive(
                          b, xs[0], ps["boost"], ps["drive"], ps["level"],
                          pol), node(Overdrive, ("in",), oversample="1")),
        "overdrive, drive modulated": (
            2, {"boost": 6.0, "level": 0.8},
            lambda b, xs, ps, pol: pw.overdrive(
                b, xs[0], ps["boost"], pw.map_mod(b, xs[1], 0.0, 1.0),
                ps["level"], pol),
            lambda xs, ps: Overdrive.process_seq(
                {**ps, "drive": comp._map_mod(xs[1], drive),
                 "oversample": "1"}, None, {"in": xs[0]})[0]["out"]),
        "chebyshev": (1, {"level_pos": 2.0, "level_neg": 4.0},
                      lambda b, xs, ps, pol: pw.chebyshev_asym(
                          b, xs[0], ps["level_pos"], ps["level_neg"], pol),
                      node(Chebyshev, ("in",))),
        "chebyshev, one side bypassed": (
            1, {"level_pos": BYPASS_EPS, "level_neg": 0.0},
            lambda b, xs, ps, pol: pw.chebyshev_asym(
                b, xs[0], ps["level_pos"], ps["level_neg"], pol),
            node(Chebyshev, ("in",))),
    }
    for mode, lower in pw.DISTORT_FORMS.items():
        forms[f"distort {mode}"] = (
            1, {"level": 4.0},
            lambda b, xs, ps, pol, lower=lower: lower(b, xs[0], ps["level"],
                                                      pol),
            node(Distort, ("in",), mode=mode, oversample="1"))
    forms["distort SoftClip, bypassed"] = (
        1, {"level": float(np.nextafter(np.float32(BYPASS_EPS),
                                        np.float32(0)))},
        forms["distort SoftClip"][2], forms["distort SoftClip"][3])
    return forms


def pointwise_program(form, pol):
    """(program, slider names) of a form of pointwise_forms()."""
    from dsp_stuff_tpu_torch.compiler import pointwise as pw
    n_x, sliders, lower, _ = form
    b = pw.Builder()
    xs = [b.sig() for _ in range(n_x)]
    ps = {k: b.scal() for k in sliders}
    return b.program([lower(b, xs, ps, pol)]), list(sliders)


def pointwise_inputs(n_x, shape, dev, seed):
    """n_x signal operands: the first [B, T] N(0, 0.7) with every one of
    PW_SPECIALS planted (NaN, +-inf, +-0, subnormals, the clip points), the
    others an unbatched [T] sine with a NaN."""
    import torch
    rng = np.random.default_rng(seed)
    B, T = shape
    x = (rng.standard_normal((B, T)) * 0.7).astype(np.float32)
    flat = x.reshape(-1)
    flat[rng.choice(flat.size, len(PW_SPECIALS), replace=False)] = \
        PW_SPECIALS
    out = [torch.as_tensor(x, device=dev)]
    for i in range(1, n_x):
        s = np.sin(np.arange(T) * (0.01 * i) + i).astype(np.float32)
        s[rng.integers(T)] = np.nan
        out.append(torch.as_tensor(s, device=dev))
    return out


def bits_same(got, want) -> bool:
    """Bit for bit on every sample but NaN, NaN at the same samples."""
    import torch
    if got.shape != want.shape:
        return False
    nan = torch.isnan(want)
    return bool(torch.equal(torch.isnan(got), nan) and torch.equal(
        got[~nan].view(torch.int32), want[~nan].view(torch.int32)))


def nonfinite_dbfs(what, got, want) -> float:
    """dBFS over the samples where ``want`` is finite, after checking that
    the others hold the same non-finite values."""
    import torch
    bad = ~torch.isfinite(want)
    check(torch.equal(~torch.isfinite(got), bad)
          and torch.equal(torch.nan_to_num(got[bad]),
                          torch.nan_to_num(want[bad])),
          f"{what}: the non-finite samples differ")
    if torch.equal(got[~bad], want[~bad]):
        return float("-inf")          # also where both are silent
    return dbfs_dev(got[~bad], want[~bad])


def pointwise_held(what, got, want, pol) -> float:
    """A group's kernel against its plain version (or the eager ops):
    bitwise under parity and exact, <= PW_FAST_DB under fast (printed
    with whether it is bitwise).  Returns the max abs difference on the
    finite samples."""
    same = bits_same(got, want)
    if pol != "fast":
        check(same, f"{what}: not bitwise under {pol}")
    d = nonfinite_dbfs(what, got, want)
    check(d <= PW_FAST_DB, f"{what}: {d:.1f} dBFS > {PW_FAST_DB}")
    fin = got.isfinite() & want.isfinite()
    return float((got[fin].double() - want[fin].double()).abs().max()) \
        if bool(fin.any()) else 0.0


def pointwise_form_checks(dev) -> dict:
    """Each form of pointwise_forms() under fast, parity and exact, at
    PW_SHAPES with the specials planted: the kernel (group_call) against
    its plain version (pointwise.interpret) and against the eager code, on
    the card, and the card's kernel against the CPU's plain version.
    Returns {policy: (forms bitwise vs plain, forms, worst fast dBFS)}."""
    import torch
    import dsp_stuff_tpu_torch as dst
    from dsp_stuff_tpu_torch.compiler import pointwise as pw
    from dsp_stuff_tpu_torch.ops import pointwise_kernel as pk
    from dsp_stuff_tpu_torch.utils.precision import scalar_on
    out = {}
    for pol in ("fast", "parity", "exact"):
        n_bit, n, worst = 0, 0, -np.inf
        with dst.policy(pol):
            for i, (name, form) in enumerate(pointwise_forms().items()):
                prog, names = pointwise_program(form, pol)
                bit = True
                for j, shape in enumerate(PW_SHAPES):
                    xs = pointwise_inputs(form[0], shape, dev, 1000 * i + j)
                    scals = [scalar_on(float(form[1][k]), dev) for k in names]
                    k = pk.group_call(prog, xs, scals, shape[1], dev)[0]
                    p = pw.interpret(prog, xs, scals, shape[1], dev)[0]
                    e = form[3](xs, dict(form[1]))
                    c = pw.interpret(prog, [x.cpu() for x in xs],
                                     [s.cpu() for s in scals], shape[1],
                                     torch.device("cpu"))[0]
                    torch.cuda.synchronize()
                    what = f"{name} {pol} {list(shape)}"
                    pointwise_held(what + " vs plain", k, p, pol)
                    pointwise_held(what + " vs eager", k, e, pol)
                    same = bits_same(k, p)
                    bit &= same
                    if pol == "fast" and not same:
                        worst = max(worst, nonfinite_dbfs(what, k, p))
                    d = nonfinite_dbfs(what + " vs CPU", k.cpu(), c)
                    check(d <= CARD_VS_CPU_DB,
                          f"{what}: vs the CPU port {d:.1f} dBFS")
                n += 1
                n_bit += bit
        print(f"  {pol}: {n_bit} of {n} forms bitwise against the plain "
              f"version at {[list(s) for s in PW_SHAPES]} (specials "
              f"planted); worst fast form {worst:.1f} dBFS")
        out[pol] = (n_bit, n, worst)
    return out


@contextlib.contextmanager
def pointwise_route(route: str):
    """Render through ``route``: "kernel" (the groups' kernels, as
    shipped), "groups" (the groups' kernels without the fan-ins they take
    outside them, compile.FANIN_GROUPS off: each such fan-in its eager
    ops), "plain" (each group's plain version, pointwise.interpret, on the
    card) or "eager" (no groups: every node's eager ops, the oversampled
    shapers too)."""
    from dsp_stuff_tpu_torch.compiler import compile as comp
    from dsp_stuff_tpu_torch.compiler import pointwise as pw
    from dsp_stuff_tpu_torch.ops import oversample
    from dsp_stuff_tpu_torch.ops import pointwise_kernel as pk
    saved = [(comp, "group_call", comp.group_call),
             (pk, "group_call", pk.group_call),
             (comp, "POINTWISE_FUSION", comp.POINTWISE_FUSION),
             (comp, "FANIN_GROUPS", comp.FANIN_GROUPS),
             (oversample, "shaper_call", oversample.shaper_call)]
    if route == "groups":
        comp.FANIN_GROUPS = False
    elif route == "plain":
        comp.group_call = pk.group_call = pw.interpret
    elif route == "eager":
        comp.POINTWISE_FUSION = False
        oversample.shaper_call = lambda fn, x, *a: fn(x, *a)
    try:
        yield
    finally:
        for m, n, v in saved:
            setattr(m, n, v)


def route_renders(cg, x, batch, routes=PW_GRAPH_ROUTES) -> dict:
    """{route: (outputs, aux, state, launches)} of one render of x."""
    import torch
    out = {}
    for route in routes:
        with pointwise_route(route):
            reset_launches()
            y, aux, st = cg.render(x, batch_shape=batch)
            torch.cuda.synchronize()
            out[route] = (y, aux, st, read_launches())
    return out


def route_leaves(res):
    """The tensors of a render's (outputs, aux, state), flattened."""
    import torch
    leaves = []

    def walk(v):
        if isinstance(v, torch.Tensor):
            leaves.append(v)
        elif isinstance(v, dict):
            for k in sorted(v, key=str):
                walk(v[k])
        elif isinstance(v, (tuple, list)):
            for w in v:
                walk(w)
    walk(res[:3])
    return leaves


def routes_held(what, res, pol) -> bool:
    """The kernel route's render (outputs, aux with the knobs, state)
    against the groups route's, bitwise under every policy (the fan-ins a
    group takes are the eager divide and map, op for op), and the plain
    and the eager route's: bitwise under parity and exact, <= PW_FAST_DB
    under fast; returns whether every leaf is bitwise."""
    import torch
    bit = True
    k = route_leaves(res["kernel"])
    for route in ("groups", "plain", "eager"):
        if route not in res:
            continue
        other = route_leaves(res[route])
        check(len(k) == len(other), f"{what}: the {route} route's render "
              f"has another structure")
        for i, (a, b) in enumerate(zip(k, other)):
            if route == "groups":
                same = (bits_same(a, b) if a.dtype.is_floating_point
                        else a.shape == b.shape and bool(torch.equal(a, b)))
                check(same, f"{what} leaf {i}: not bitwise the groups route")
            elif a.dtype.is_floating_point:
                pointwise_held(f"{what} leaf {i} vs {route}", a.float(),
                               b.float(), pol)
                bit &= bits_same(a.float(), b.float())
            else:
                check(bool((a == b).all()), f"{what} leaf {i} vs {route}")
    return bit


def pointwise_graphs():
    """(name, graph) of the graphs the pointwise phase renders at
    B_EXACT x 1 s under parity and exact: config5, the fuzz graphs whose
    plans hold a group, the exact pool's seed 36 (a group of five), and
    two fuzz graphs with one-form groups (seed 8: two fan-ins of two
    sources outside the groups; seed 27: three sources into a chorus, its
    mix modulated by one node)."""
    import test_torch_fuzz_gen as gen
    from dsp_stuff_tpu_torch.models import presets
    out = [("config5", presets.config5_feedback_16node()[0]),
           ("config3", presets.config3_oversampled_distortion()[0])]
    out += [(name, g) for name, g, _ in fuzz_graphs()]
    out.append(("_random_graph(36, exact)",
                gen._random_graph(36, exact=True)[0]))
    out += [(f"_random_graph({s})", gen._random_graph(s)[0])
            for s in ONE_FORM_SEEDS]
    return out


def pointwise_small_renders(dev) -> dict:
    """pointwise_graphs() at B_EXACT x 1 s under fast, parity and exact:
    the kernel route against the plain and the eager routes.  Returns
    {policy: (renders bitwise, renders, group launches)}."""
    import dsp_stuff_tpu_torch as dst
    out = {}
    for pol in ("fast", "parity", "exact"):
        n_bit, n, launches, solo = 0, 0, 0, 0
        for i, (name, g) in enumerate(pointwise_graphs()):
            x = (np.random.default_rng(300 + i).standard_normal(
                (B_EXACT, 1, SR)) * 0.3).astype(np.float32)
            with dst.policy(pol):
                cg = dst.compile_graph(g, device="cuda")
                res = route_renders(cg, x, (B_EXACT,))
            n_bit += routes_held(f"{name} {pol}", res, pol)
            n += 1
            launches += res["kernel"][3]["pointwise"]
            solo += (res["kernel"][3]["pointwise"]
                     - res["groups"][3]["pointwise"])
            check(res["eager"][3]["pointwise"] == 0,
                  f"{name}: the eager route launched the pointwise kernel")
        print(f"  {pol}: {n_bit} of {n} renders bitwise (output, aux, "
              f"state) against the groups, the plain and the eager routes "
              f"(the groups route bitwise in all), {launches} group "
              f"launches, {solo} of them one-form groups")
        check(solo > 0, f"{pol}: no one-form group ran")
        out[pol] = (n_bit, n, launches)
    return out


def smoke_graphs():
    """(name, graph) of every graph the smoke renders in-process, for the
    collection of their group programs (pointwise_sources)."""
    import test_torch_fuzz_gen as gen
    from dsp_stuff_tpu_torch.models import presets
    out = [("bench", bench_graph()), ("muff", muff_graph()),
           ("mux/demux", mux_demux_graph()), ("envelope", envelope_graph()),
           ("loop", loop_graph())]
    out += [(name, presets.PRESETS[name]()[0])
            for name in ("config2", "config4", "config5")]
    out += [(name, g) for name, g in pointwise_graphs() if name != "config5"]
    out += [(f"_random_graph({s}, exact)", gen._random_graph(s, exact=True)[0])
            for s in EXACT_FUZZ_SEEDS]
    out += list(fuzz_group_graphs().items())
    return out


def pointwise_sources() -> list:
    """The generated source of every group program the smoke launches, so
    that one nvcc each builds them all together: each form's under the
    three policies, and each group of smoke_graphs() under the three
    policies with and without the fan-ins the groups take (the kernel and
    the groups route), collected from the CPU port's renders at [1, 256] (a
    program depends on the graph's structure and the policy, not on the
    shapes or the sliders' values)."""
    import torch
    import dsp_stuff_tpu_torch as dst
    from dsp_stuff_tpu_torch.compiler import compile as comp
    from dsp_stuff_tpu_torch.ops import pointwise_kernel as pk
    from dsp_stuff_tpu_torch.compiler import pointwise as pw
    programs = set()
    for pol in ("fast", "parity", "exact"):
        for form in pointwise_forms().values():
            programs.add(pointwise_program(form, pol)[0])
        for kind in ("scal", "sig"):           # fuzz_group_phase's forms
            b = pw.Builder()
            xv = b.sig()
            programs.add(b.program([pw.fuzz(b, xv, getattr(b, kind)(),
                                             pol)]))
    plain = pk.group_call

    def spy(prog, *args):
        programs.add(prog)
        return plain(prog, *args)
    x = torch.zeros((1, 1, 256))
    with contextlib.ExitStack() as stack:
        for m in (comp, pk):
            stack.enter_context(swapped_attr(m, "group_call", spy))
        for _, g in smoke_graphs():
            cg = dst.compile_graph(g, device="cpu")
            n_in = len(cg.input_ids)
            for pol in ("fast", "parity", "exact"):
                for route in ("kernel", "groups"):
                    with dst.policy(pol), pointwise_route(route):
                        cg.render(x.expand(1, n_in, 256) if n_in else None,
                                  T=256, batch_shape=(1,))
            # a feedback gain overridden (a float; a stream's moved
            # slider): the cycle's per-node scan and its groups under fast
            for nid in sorted(n for c in cg._sccs if len(c) > 1 for n in c
                              if cg._nodes[n].cfg_name == "gain")[-1:]:
                with dst.policy("fast"):
                    cg.render(x.expand(1, n_in, 256) if n_in else None, T=256,
                              batch_shape=(1,),
                              params={str(nid): {"level": 0.4}})
    return sorted({pk.source(p) for p in programs})


@contextlib.contextmanager
def swapped_attr(obj, name, value):
    """``obj.name`` set to ``value`` inside the block."""
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


FP64_TFLOPS = 34.0        # H100 SXM FP64 on the CUDA cores (data sheet)
N_GROUP_CALLS = 10        # group calls timed back to back
N_PW_BLOCKS = 375         # config5 process() blocks timed a route (1 s)


def group_bytes(sigs, outs) -> float:
    """The bytes one launch of a group must move: each signal operand
    read once, each output written once."""
    return 4.0 * (sum(s.numel() for s in sigs) + sum(y.numel() for y in outs))


def group_bound(prog, sigs, outs):
    """(bound ms, by) of one launch of the group ``prog``: group_bytes over
    HBM against its per-sample operations (an f64 one at the FP64 rate; a
    transcendental counted as one, which understates it) over the
    outputs' samples."""
    uniform: list = []
    f32 = f64 = 0
    for op, dt, args, _ in prog.ops:
        u = op in ("scal", "const") or (bool(args)
                                        and all(uniform[a] for a in args))
        uniform.append(u)
        if not u and op not in ("sig", "zero"):
            if dt == "f64" or op == "f32":
                f64 += 1
            else:
                f32 += 1
    n = max(y.numel() for y in outs)
    return bound(group_bytes(sigs, outs),
                 n * (f32 + f64 * FP32_TFLOPS / FP64_TFLOPS))


def groups_of_render(cg, x, batch) -> list:
    """The (program, signals, scalars, T) of each pointwise group one
    render of x runs, in order, the oversampled shapers' passes too (the
    render runs through the kernels)."""
    import torch
    from dsp_stuff_tpu_torch.compiler import compile as comp
    from dsp_stuff_tpu_torch.ops import pointwise_kernel as pk
    got = []
    call = pk.group_call

    def spy(prog, sigs, scals, T, device):
        got.append((prog, list(sigs), list(scals), T))
        return call(prog, sigs, scals, T, device)
    with swapped_attr(comp, "group_call", spy), \
            swapped_attr(pk, "group_call", spy):
        cg.render(x, batch_shape=batch)
        torch.cuda.synchronize()
    return got


def group_times(what, groups, dev, card) -> list:
    """Each group's kernel against its plain version (pointwise.interpret:
    the eager ops it replaces, one op at a time) on the same operands:
    CUDA events over N_GROUP_CALLS calls back to back (so the host's time
    a call, the wrapper's layout and ctypes, drops out where the card's is
    longer), in turns, and the kernel's own device time by torch.profiler;
    with its bound and ``y.copy_`` of the same bytes.  Returns [(kernel
    ms, plain ms, bound, copy ms, max abs err, device ms)]."""
    import torch
    from dsp_stuff_tpu_torch.compiler import pointwise as pw
    from dsp_stuff_tpu_torch.ops import pointwise_kernel as pk
    out = []
    for prog, sigs, scals, T in groups:
        k = pk.group_call(prog, sigs, scals, T, dev)
        p = pw.interpret(prog, sigs, scals, T, dev)
        torch.cuda.synchronize()
        err = max(pointwise_held(f"{what} group vs plain", a, b, "fast")
                  for a, b in zip(k, p))
        bit = all(bits_same(a, b) for a, b in zip(k, p))
        bnd = group_bound(prog, sigs, k)
        src = torch.empty(int(group_bytes(sigs, k) // 8), device=dev)
        dst_ = torch.empty_like(src)
        def fk():
            return pk.group_call(prog, sigs, scals, T, dev)

        def fp():
            return pw.interpret(prog, sigs, scals, T, dev)
        km = [cuda_ms(fk, inner=N_GROUP_CALLS)]
        pm = [cuda_ms(fp, inner=N_GROUP_CALLS) for _ in range(2)]
        km.append(cuda_ms(fk, inner=N_GROUP_CALLS))
        km, pm = float(np.median(km)), float(np.median(pm))
        dm = kernel_device_ms(fk, "pointwise_kernel")[0]
        cm = cuda_ms(lambda: dst_.copy_(src), inner=N_GROUP_CALLS)
        shape = "x".join(str(d) for d in max((y.shape for y in k),
                                             key=len))
        print(f"  {what}: a group of {len(prog.ops)} ops, {prog.n_sig} "
              f"signals in, {len(prog.outs)} out, [{shape}]: kernel "
              f"{km:.3f} ms (device {dm if dm is None else round(dm, 3)}), "
              f"plain {pm:.3f} ms ({pm / km:.1f}x), bound "
              f"{bnd[0]:.3f} ms by {bnd[1]} ({bnd[0] / km:.1%} of it), "
              f"y.copy_ of the same bytes {cm:.3f} ms; bitwise {bit} "
              f"[{card}]")
        out.append((km, pm, bnd, cm, err, dm))
        del k, p, src, dst_
    return out


def route_times(cg, x, batch):
    """(kernel route ms, eager route ms) of one render, in turns."""
    def timed(route):
        def fn():
            with pointwise_route(route):
                cg.render(x, batch_shape=batch)
        return fn
    return in_turns(timed("kernel"), timed("eager"))


def fanin_device_turns(what, cg, x, batch, card) -> dict:
    """One render of ``cg`` on the kernel route (the groups with the
    fan-ins they take) and the groups route (without them) in turns,
    kernel, groups, groups, kernel: each render's device time and device
    records (kernels, copies, fills) from torch.profiler
    (render_device_ms).  Returns {route: [(ms, records), ...]}."""
    out: dict = {"kernel": [], "groups": []}
    for route in ("kernel", "groups", "groups", "kernel"):
        def fn():
            with pointwise_route(route):
                cg.render(x, batch_shape=batch)
        out[route].append(render_device_ms(fn))
    print(f"  {what}: device time of one render, kernel (the groups' "
          f"fan-ins) / groups route in turns: "
          + ", ".join(f"{route} {ms:.3f} ms ({n} device records)"
                      for route in ("kernel", "groups")
                      for ms, n in out[route]) + f" [{card}]")
    return out


def render_device_ms(fn) -> tuple:
    """(device ms, device records) of one call of fn() from
    torch.profiler after a warm-up: every device record's own time (the
    kernels, copies and fills), PROFILE_LEAD_IN spin kernels opening the
    profile (the trace loses its first records) and left out."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_LEAD_IN):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA
           and "sleep" not in e.name.lower() and "spin" not in e.name.lower()]
    return sum(e.self_device_time_total for e in evs) / 1e3, len(evs)


def stream_routes(dev, card) -> dict:
    """config5 streamed in 128-sample process() blocks on each route (the
    kernel route as shipped, the groups route without the fan-ins they
    take, the eager route): the captured graph's nodes from its DOT dump
    and the process() wall a block over N_PW_BLOCKS blocks (median,
    p99), the routes in turns; the kernel route's replay (its blocks and
    final state) bitwise the other routes'."""
    import torch
    import dsp_stuff_tpu_torch as dst
    from dsp_stuff_tpu_torch.models import presets
    g5 = presets.config5_feedback_16node()[0]
    x = (np.random.default_rng(140).standard_normal(N_PW_BLOCKS * 128)
         * 0.3).astype(np.float32)
    out = {}
    routes = ("kernel", "groups", "eager")
    with dst.policy("fast"):
        for rnd in range(2):
            for route in routes if rnd == 0 else routes[::-1]:
                with pointwise_route(route):
                    sess = dst.StreamSession(g5, device="cuda")
                    key = str(sess.cg.input_ids[0])
                    ys, times = [], []
                    for j in range(N_PW_BLOCKS):
                        t0 = time.perf_counter()
                        ys.append(sess.process({key: x[j * 128:
                                                     (j + 1) * 128]})[0])
                        times.append(time.perf_counter() - t0)
                    gn = graph_nodes(sess, f"config5 {route} route")
                r = out.setdefault(route, {"times": [], "y": None})
                r["times"] += times[1:]
                r["y"] = np.concatenate(ys)
                r["state"] = sess.state
                r["nodes"] = gn
    for route in routes[1:]:
        check(np.array_equal(out["kernel"]["y"], out[route]["y"])
              and same_tree(out["kernel"]["state"], out[route]["state"]),
              f"config5 stream: the kernel route's blocks and state are not "
              f"bitwise the {route} route's")
        print(f"  config5 stream: the kernel route's {N_PW_BLOCKS} blocks "
              f"and final state bitwise the {route} route's [{card}]")
    for r in out.values():
        del r["state"]
    for route, r in out.items():
        ms = np.asarray(r["times"]) * 1e3
        r.update(median=float(np.median(ms)),
                 p99=float(np.percentile(ms, 99)),
                 kernels=r["nodes"]["kinds"].get("KERNEL", 0))
        print(f"  config5 stream, {route} route: a replayed block holds "
              f"{r['kernels']} kernels ({r['nodes']['kinds']}; the port's "
              f"{expect_str(r['nodes']['ours'])}); process() median "
              f"{r['median']:.3f} ms, p99 {r['p99']:.3f} ms over "
              f"{2 * (N_PW_BLOCKS - 1)} blocks in two turns [{card}]")
    check(out["kernel"]["nodes"]["ours"].get("pointwise") == 3,
          "config5 stream: the captured block holds "
          f"{out['kernel']['nodes']['ours']}, not three pointwise groups")
    torch.cuda.synchronize()
    return out


def pointwise_grad(dev, card) -> float:
    """config5's input gradient at 2 x T_CPU_PORT through the groups'
    Function on the card (its forward the kernel, its backward the reverse
    kernel: no run of the plain version) against the CPU port, rtol
    GRAD_RTOL; returns the relative error."""
    import torch
    import dsp_stuff_tpu_torch as dst
    from dsp_stuff_tpu_torch.compiler import pointwise as pw
    from dsp_stuff_tpu_torch.models import presets
    from dsp_stuff_tpu_torch.ops import pointwise_kernel as pk
    g5 = presets.config5_feedback_16node()[0]
    rng = np.random.default_rng(141)
    x = (rng.standard_normal((2, T_CPU_PORT)) * 0.3).astype(np.float32)
    tgt = (rng.standard_normal((2, 1, T_CPU_PORT)) * 0.1).astype(np.float32)
    got = {}
    with dst.policy("fast"):
        for d in ("cpu", dev):
            cg = dst.compile_graph(g5, device=d)
            calls = {}
            with calls_counted([(pk, "_kernel_group"), (pw, "interpret")],
                               calls):
                r = loss_and_grads(cg, torch.as_tensor(x, device=d),
                                   torch.as_tensor(tgt, device=d), None,
                                   True, False)
            got[str(d)] = (r, calls)
    card_r, calls = got[str(dev)]
    check(calls.get("_kernel_group") == 3 and card_r["group_vjps"] == 0
          and card_r["fwd"]["pointwise"] == 3
          and card_r["bwd"]["pointwise_reverse"] == 3
          and not card_r["plain_bwd"],
          f"config5 gradient: the groups' Function ran {calls}, the plain "
          f"version {card_r['group_vjps']} times, the backward launched "
          f"{card_r['bwd']} and called {card_r['plain_bwd']}")
    err = grad_close("config5 input gradient through the groups' Function",
                     card_r["grads"][0], got["cpu"][0]["grads"][0])
    print(f"  config5 input gradient, [2, {T_CPU_PORT}], through the groups' "
          f"Function (forward 3 kernel launches, backward 3 reverse kernel "
          f"launches, no plain version): card vs CPU port {err:.2e} (rtol "
          f"{GRAD_RTOL}) [{card}]")
    return err


PW_REV_DB = -100.0        # the reverse kernel's per-element gradients
PW_REV_RTOL = 1e-5        # ... its sums (reduced gradients), or
PW_REV_ATOL = 1e-7        # ... this near 0 (both vs autograd)
N_REV_LAUNCHES = 10       # reverse launches that must agree bit for bit
B_PW_REV_C3 = 32          # config3's shaper passes at R = 4 (x 10 s)
#: config5's first group cut to these T at B_C5: the rows chunked (gy > 1)
REV_CHUNKED_T = (48_000, 128)


def reverse_needs(prog) -> list:
    """What the smoke holds a group's reverse kernel to: every operand
    needing a gradient (sums to each slider and [T] signal), and the first
    signal alone (an input gradient: the main path's program)."""
    n = prog.n_sig + prog.n_scal
    needs = [(True,) * n]
    if prog.n_sig and n > 1:
        needs.append((True,) + (False,) * (n - 1))
    return needs


def reverse_cotangents(prog, sigs, scals, T, dev, seed) -> list:
    """N(0, 1) cotangents of the group's outputs, on ``dev``."""
    import torch
    from dsp_stuff_tpu_torch.ops import pointwise_kernel as pk
    shapes = pk.layout(prog, tuple(s.shape for s in sigs),
                       tuple(s.shape for s in scals), T)[2]
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(shp, generator=g, device=dev) for shp in shapes]


def sums_close(got, want, rtol=PW_REV_RTOL, atol=PW_REV_ATOL) -> bool:
    """A reduced gradient within rtol, max-normalized (a scalar: relative),
    or atol near 0; the non-finite entries the same."""
    import torch
    bad = ~torch.isfinite(want)
    if not (torch.equal(~torch.isfinite(got), bad) and torch.equal(
            torch.nan_to_num(got[bad]), torch.nan_to_num(want[bad]))):
        return False
    g, w = got[~bad].double(), want[~bad].double()
    if not g.numel():
        return True
    return float((g - w).abs().max()) <= max(
        rtol * float(w.abs().max()), atol)


def reverse_held(what, prog, sigs, scals, cts, need, T, dev) -> tuple:
    """The reverse kernel (ops/pointwise_reverse_kernel.reverse_group)
    against autograd through interpret (ops/pointwise_kernel.group_vjp)
    on the same cotangents: each per-element gradient <= PW_REV_DB
    (max-normalized, the non-finite samples the same), each sum within
    PW_REV_RTOL or PW_REV_ATOL.  Where autograd's float32 sum cancels past
    that, the kernel's sum must be the plain version's float64 sum
    (group_adjoint with sums64, rtol 1e-6) and autograd's farther from
    it.  Returns (max abs error of the per-element gradients, whether
    every gradient is bitwise, the sums held by the float64 rule)."""
    import torch
    from dsp_stuff_tpu_torch.ops import pointwise_kernel as pk
    from dsp_stuff_tpu_torch.ops import pointwise_reverse_kernel as prk
    k = prk.reverse_group(prog, sigs, scals, cts, need, T, dev)
    w = pk.group_vjp(prog, sigs, scals, cts, need, T, dev)
    torch.cuda.synchronize()
    F = pk.layout(prog, tuple(s.shape for s in sigs),
                  tuple(s.shape for s in scals), T)[0]
    n_full = int(np.prod(F))
    err, bit, held64, p64 = 0.0, True, 0, None
    for i, (a, b) in enumerate(zip(k, w)):
        if not need[i]:
            check(a is None, f"{what}: a gradient of operand {i}, which "
                             f"needs none")
            continue
        if a is None:
            check(not bool(b.any()), f"{what}: operand {i} got no "
                                     f"gradient, autograd's is not 0")
            continue
        check(a.shape == b.shape, f"{what}: gradient {i} of shape "
                                  f"{tuple(a.shape)}, autograd's "
                                  f"{tuple(b.shape)}")
        bit &= bits_same(a, b)
        if a.numel() == n_full:
            d = nonfinite_dbfs(f"{what} gradient {i}", a, b)
            check(d <= PW_REV_DB, f"{what}: gradient {i} {d:.1f} dBFS > "
                                  f"{PW_REV_DB}")
            fin = a.isfinite() & b.isfinite()
            if bool(fin.any()):
                err = max(err, float((a[fin].double() - b[fin].double())
                                     .abs().max()))
        elif not sums_close(a, b):
            if p64 is None:
                p64 = pk.group_adjoint(prog, sigs, scals, cts, need, T, dev,
                                       sums64=True)
            q = p64[i].double()
            off_k = float((a.double() - q).abs().nan_to_num().max())
            off_w = float((b.double() - q).abs().nan_to_num().max())
            check(sums_close(a, p64[i], 1e-6, 0.0) and off_w >= off_k,
                  f"{what}: sum {i} {a.flatten()[:4].tolist()} on the card, "
                  f"autograd's {b.flatten()[:4].tolist()}, the float64 "
                  f"sum's {p64[i].flatten()[:4].tolist()}")
            held64 += 1
    return err, bit, held64


def pointwise_reverse_forms(dev) -> dict:
    """Each form of pointwise_forms() under fast, parity and exact at
    PW_SHAPES (the specials planted, the sliders scalar operands, a second
    signal an unbatched [T] one), every operand needing a gradient and
    the input alone: the reverse kernel against autograd through
    interpret (reverse_held).  Returns {policy: (cases bitwise, cases,
    sums held by the float64 rule)}."""
    import torch
    import dsp_stuff_tpu_torch as dst
    from dsp_stuff_tpu_torch.utils.precision import scalar_on
    out = {}
    for pol in ("fast", "parity", "exact"):
        n_bit = n = n64 = 0
        with dst.policy(pol):
            for i, (name, form) in enumerate(pointwise_forms().items()):
                prog, names = pointwise_program(form, pol)
                for j, shape in enumerate(PW_SHAPES):
                    xs = pointwise_inputs(form[0], shape, dev, 1000 * i + j)
                    scals = [scalar_on(float(form[1][k]), dev) for k in names]
                    cts = reverse_cotangents(prog, xs, scals, shape[1], dev,
                                             2000 * i + j)
                    for need in reverse_needs(prog):
                        _, bit, h = reverse_held(
                            f"{name} {pol} {list(shape)} reverse, need "
                            f"{sum(need)}", prog, xs, scals, cts, list(need),
                            shape[1], dev)
                        n_bit += bit
                        n += 1
                        n64 += h
        print(f"  {pol}: {n_bit} of {n} form cases bitwise against autograd "
              f"through interpret at {[list(s) for s in PW_SHAPES]} (every "
              f"gradient <= {PW_REV_DB} dBFS, sums rtol {PW_REV_RTOL}; "
              f"{n64} sums held by the float64 rule)")
        out[pol] = (n_bit, n, n64)
        torch.cuda.synchronize()
    return out


def reverse_bound(prog, sigs, scals, cts, need, T):
    """(bound ms, by) of one reverse call, the same work whatever its
    layout: the bytes it must move (each operand and cotangent read once,
    each gradient written once; no workspace, whose size follows the
    layout) over HBM against the full world's operations (an f64 one at
    the FP64 rate, a transcendental counted as one; each per-element one
    over [rows, T], each per-sample one, pr_col's, over T)."""
    from dsp_stuff_tpu_torch.ops import pointwise_kernel as pk
    from dsp_stuff_tpu_torch.ops import pointwise_reverse_kernel as prk
    pl = pk.plan_adjoint(prog, sigs, scals, cts, need, T)
    w = prk.worlds(pl.adj)
    ln = prk.plan_reverse(pl, sigs[0].device)
    n_bytes = 4.0 * (sum(t.numel() for t in ln.ins)
                     + sum(t.numel() for t in ln.outs))
    col = set(prk.hoisted(pl.adj))
    ops = 0.0
    for v in w.stmts["F"]:
        op, dt, _, _ = pl.adj.ops[v]
        if op in ("sig", "ct"):
            continue
        n = T if v in col else ln.rows * T
        ops += n * (FP32_TFLOPS / FP64_TFLOPS
                    if dt == "f64" or op == "f32" else 1.0)
    return bound(n_bytes, ops)


def reverse_layout(prog, sigs, scals, cts, need, T) -> str:
    """A reverse call's layout (ops/pointwise_reverse_kernel.plan_reverse):
    rows a thread, pass 1's grid, where the per-sample tail runs, and the
    launches a call."""
    from dsp_stuff_tpu_torch.ops import pointwise_kernel as pk
    from dsp_stuff_tpu_torch.ops import pointwise_reverse_kernel as prk
    pl = pk.plan_adjoint(prog, sigs, scals, cts, need, T)
    ln = prk.plan_reverse(pl, sigs[0].device)
    w = prk.worlds(pl.adj)
    tail = ("; the per-sample tail in pass "
            f"{1 if prk.tail_in_pass1(w, ln.grid[1]) else 2}"
            if w.reds[("F", "C")] else "")
    return (f"rch {ln.rch}, grid {ln.grid[0]} x {ln.grid[1]}{tail}; "
            f"{int(ln.pass1) + int(ln.pass2)} launch(es) a call")


def reverse_group_checks(what, groups, dev, card, timed=False) -> list:
    """Each group of a render (groups_of_render) under both of
    reverse_needs: the reverse kernel against autograd (reverse_held);
    with ``timed`` also timed against the route it replaced (group_vjp:
    autograd through interpret) on the same operands, CUDA events over
    N_GROUP_CALLS calls back to back, in turns, the kernel's device time
    by torch.profiler (each pass's and their sum), with its bound.  Returns
    [(need, max abs err, bitwise, kernel ms, plain ms, bound, device
    ms)] a group and need (times None where not timed)."""
    import torch
    from dsp_stuff_tpu_torch.ops import pointwise_kernel as pk
    from dsp_stuff_tpu_torch.ops import pointwise_reverse_kernel as prk
    out = []
    for gi, (prog, sigs, scals, T) in enumerate(groups):
        cts = reverse_cotangents(prog, sigs, scals, T, dev, 3000 + gi)
        for need in reverse_needs(prog):
            need = list(need)
            label = f"{what} group {gi} reverse, need {sum(need)}"
            err, bit, h = reverse_held(label, prog, sigs, scals, cts, need,
                                       T, dev)
            km = pm = dm = bnd = None
            if timed:
                def fk():
                    return prk.reverse_group(prog, sigs, scals, cts, need, T,
                                             dev)

                def fp():
                    return pk.group_vjp(prog, sigs, scals, cts, need, T, dev)
                ks = [cuda_ms(fk, inner=N_GROUP_CALLS)]
                ps = [cuda_ms(fp, n=2, inner=2) for _ in range(2)]
                ks.append(cuda_ms(fk, inner=N_GROUP_CALLS))
                km, pm = float(np.median(ks)), float(np.median(ps))
                bnd = reverse_bound(prog, sigs, scals, cts, need, T)
                prk.SUM_LAUNCHES = 0
                fk()
                # each pass's device time (pass 2: ..._kernel_sums)
                passes = [kernel_device_ms(fk, "pointwise_reverse_kernel<")[0]]
                if prk.SUM_LAUNCHES:
                    passes.append(kernel_device_ms(
                        fk, "pointwise_reverse_kernel_sums")[0])
                dm = None if None in passes else sum(passes)
                torch.cuda.synchronize()
                lay = reverse_layout(prog, sigs, scals, cts, need, T)
                print(f"  {label}: kernel {km:.3f} ms (device "
                      f"{dm if dm is None else round(dm, 3)}, by pass "
                      f"{[p if p is None else round(p, 3) for p in passes]}"
                      f"; {lay}), autograd "
                      f"through interpret {pm:.3f} ms ({pm / km:.1f}x), "
                      f"bound {bnd[0]:.3f} ms by {bnd[1]} ({bnd[0] / km:.1%} "
                      f"of it); bitwise {bit}, {h} sums by the float64 rule "
                      f"[{card}]")
            else:
                print(f"  {label}: bitwise {bit}, per-element max abs error "
                      f"{err:.3e}, {h} sums by the float64 rule")
            out.append((tuple(need), err, bit, km, pm, bnd, dm,
                        passes if timed else None))
    return out


N_DIV_SIGNIFICANDS = 256    # random f32 divisors held over every dividend
N_DIV_PAIRS_F64 = 2**30     # random f64 pairs


def divide_check(divisors, n_pairs: int, seed: int, device) -> tuple:
    """Hold pw_div (csrc/pointwise_ops.cuh) to the IEEE divide on the card
    (csrc/pointwise_divide_check.cu): every f32 dividend by each of
    ``divisors`` against __fdiv_rn, and ``n_pairs`` pseudo-random f64 pairs
    of ``seed`` against __ddiv_rn.  Returns (f32 results whose bits
    differ, one such (divisor, dividend bits) or None, f64 results that
    differ, one such pair's index or None)."""
    import ctypes
    import torch
    from dsp_stuff_tpu_torch.ops import cuda_build
    device = torch.device(device)
    lib = cuda_build.load("pointwise_divide_check")
    p, i32, u64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_ulonglong
    lib.pointwise_divide_check.argtypes = [p, i32, u64, u64, p, p, i32, i32,
                                           p]
    lib.pointwise_divide_check.restype = ctypes.c_int
    ds = torch.as_tensor(divisors, dtype=torch.float32, device=device)
    bad = torch.zeros(2, dtype=torch.int64, device=device)
    first = torch.zeros(2, dtype=torch.int64, device=device)
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    rc = lib.pointwise_divide_check(
        ds.data_ptr(), ds.numel(), n_pairs, seed, bad.data_ptr(),
        first.data_ptr(), n_sm, device.index,
        torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"pointwise divide check launch failed: CUDA "
                           f"error {rc}")
    n32, n64 = bad.tolist()
    f32, f64 = first.tolist()
    where32 = (float(ds[f32 >> 32]), f32 & 0xFFFFFFFF) if n32 else None
    return n32, where32, n64, f64 if n64 else None


def divide_checks_reverse(groups, dev, card) -> dict:
    """The reverse kernel's divide by a uniform divisor (pointwise_ops.cuh:
    pw_div through pw_recip's reciprocal) against the IEEE divide on the
    card (divide_check, csrc/pointwise_divide_check.cu): every one of the
    2^32 f32 dividends by N_DIV_SIGNIFICANDS random divisors (significands
    at exponents in [-30, 30], inside and outside the fast path's range,
    both signs) and by config5's uniform divisors (its groups' scalar
    operands and constant divisors), against __fdiv_rn; N_DIV_PAIRS_F64
    random f64 pairs against __ddiv_rn.  Any result whose bits differ
    fails the run.  Returns the counts."""
    import torch
    rng = np.random.default_rng(22)
    n = N_DIV_SIGNIFICANDS
    ds = (np.where(rng.random(n) < 0.5, -1.0, 1.0) * rng.uniform(1, 2, n)
          * 2.0 ** rng.integers(-30, 31, n)).astype(np.float32)
    c5 = set()
    for prog, _, scals, _ in groups:
        c5 |= {float(v) for v in scals}
        c5 |= {float(prog.ops[a[1]][3]) for op, _, a, _ in prog.ops
               if op == "div" and prog.ops[a[1]][0] == "const"}
    c5 = sorted(c5)
    t0 = time.time()
    n32, where32, n64, where64 = divide_check(
        np.concatenate([ds, np.asarray(c5, np.float32)]), N_DIV_PAIRS_F64,
        22, dev)
    torch.cuda.synchronize()
    secs = time.time() - t0
    print(f"  pw_div vs __fdiv_rn: {n + len(c5)} divisors ({n} random, "
          f"config5's {c5}) x 2^32 dividends: {n32} mismatches; vs "
          f"__ddiv_rn: {N_DIV_PAIRS_F64} random f64 pairs: {n64} "
          f"mismatches; {secs:.1f} s [{card}]")
    check(n32 == 0 and n64 == 0,
          f"pw_div differs from the IEEE divide: f32 {n32} (e.g. divisor, "
          f"dividend bits {where32}), f64 {n64} (pair {where64})")
    return {"f32_divisors": n + len(c5), "f32_mismatches": n32,
            "f64_pairs": N_DIV_PAIRS_F64, "f64_mismatches": n64,
            "seconds": secs}


def reverse_chunked_checks(group, dev, card) -> list:
    """config5's first group with every operand needing a gradient (its
    [T] LFO's gradient summed over the rows), its signals cut to their
    first T samples for each of REV_CHUNKED_T: the layout of a short T
    (ops/pointwise_reverse_kernel.launch_shape: ROW_CHUNK rows a chunk,
    gy > 1, pass 1's partials one a sample and chunk, the per-sample tail
    in pass 2), held against autograd (reverse_held) and N_REV_LAUNCHES
    launches bitwise equal (reverse_determinism).  Returns [(T, max abs
    error, bitwise, sums by the float64 rule)]."""
    import torch
    from dsp_stuff_tpu_torch.ops import pointwise_kernel as pk
    from dsp_stuff_tpu_torch.ops import pointwise_reverse_kernel as prk
    prog, sigs, scals, _ = group
    need = list(reverse_needs(prog)[0])
    out = []
    for T in REV_CHUNKED_T:
        cut = [s[..., :T].contiguous() for s in sigs]
        cts = reverse_cotangents(prog, cut, scals, T, dev, 5000 + T)
        pl = pk.plan_adjoint(prog, cut, scals, cts, need, T)
        ln = prk.plan_reverse(pl, dev)
        gy = ln.grid[1]
        check(gy > 1 and not prk.tail_in_pass1(prk.worlds(pl.adj), gy)
              and ln.pass2, f"config5 group 0 at [{cut[0].shape[0]}, {T}] "
                            f"does not run the chunked layout (rch "
                            f"{ln.rch}, grid {ln.grid})")
        label = (f"config5 group 0 reverse, [{cut[0].shape[0]}, {T}], need "
                 f"{sum(need)}")
        err, bit, h = reverse_held(label, prog, cut, scals, cts, need, T, dev)
        print(f"  {label}: {reverse_layout(prog, cut, scals, cts, need, T)};"
              f" bitwise {bit}, per-element max abs error {err:.3e}, {h} "
              f"sums by the float64 rule [{card}]")
        reverse_determinism(prog, cut, scals, T, dev)
        out.append((T, err, bit, h))
        del cut, cts, pl, ln
    torch.cuda.empty_cache()
    return out


def reverse_determinism(prog, sigs, scals, T, dev, n=N_REV_LAUNCHES):
    """n calls of the reverse kernel with every operand needing a gradient
    (both passes) on the same inputs: every gradient bitwise the first
    call's; then one call captured in a CUDA graph (no host read, no
    tensor from host data) and replayed: bitwise the same."""
    import torch
    from dsp_stuff_tpu_torch.ops import pointwise_reverse_kernel as prk
    cts = reverse_cotangents(prog, sigs, scals, T, dev, 4000)
    need = list(reverse_needs(prog)[0])

    def call():
        return prk.reverse_group(prog, sigs, scals, cts, need, T, dev)

    def same(got, want):
        return all((a is None and b is None) or bits_same(a, b)
                   for a, b in zip(got, want))
    first = call()
    for _ in range(n - 1):
        check(same(call(), first),
              "the reverse pointwise kernel is not bitwise equal to itself")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    from dsp_stuff_tpu_torch.utils.capture import no_collection
    graph = torch.cuda.CUDAGraph()
    with no_collection(), torch.cuda.graph(graph):
        captured = call()
    graph.replay()
    torch.cuda.synchronize()
    check(same(captured, first), "the reverse pointwise kernel replayed "
                                 "from a CUDA graph differs")
    print(f"  {n} reverse launches (both passes, {sum(need)} gradients) "
          f"bitwise equal to each other, and a captured call replayed")
    del graph, captured


def pointwise_reverse_sources() -> list:
    """The generated reverse source of every adjoint program the smoke
    launches, so that one nvcc each builds them all together: the forms'
    under the three policies (both needs, batched and one-row shapes),
    config5's and config3's groups (both needs) and each gradient path's
    groups (cpu_group_backwards), from CPU runs at small shapes (an
    adjoint program depends on the structure, the policy, what needs a
    gradient and which operands span the batch)."""
    import torch
    import dsp_stuff_tpu_torch as dst
    from dsp_stuff_tpu_torch.compiler import compile as comp
    from dsp_stuff_tpu_torch.compiler import pointwise as pw
    from dsp_stuff_tpu_torch.models import presets
    from dsp_stuff_tpu_torch.ops import pointwise_kernel as pk
    from dsp_stuff_tpu_torch.ops import pointwise_reverse_kernel as prk
    from dsp_stuff_tpu_torch.utils.precision import scalar_on
    cpu = torch.device("cpu")
    srcs = set()

    def add(prog, sigs, scals, T, needs=None):
        cts = [torch.zeros(shp) for shp in pk.layout(
            prog, tuple(s.shape for s in sigs),
            tuple(s.shape for s in scals), T)[2]]
        for need in needs or reverse_needs(prog):
            pl = pk.plan_adjoint(prog, sigs, scals, cts, need, T)
            if prk.worlds(pl.adj).outs:
                srcs.add(prk.reverse_source(pl.adj))
    for pol in ("fast", "parity", "exact"):
        with dst.policy(pol):
            for form in pointwise_forms().values():
                prog, names = pointwise_program(form, pol)
                for rows in (4, 1):
                    add(prog, pointwise_inputs(form[0], (rows, 64), cpu, 0),
                        [scalar_on(1.0, cpu) for _ in names], 64)
    for g in (presets.config5_feedback_16node()[0],
              presets.config3_oversampled_distortion()[0]):
        cg = dst.compile_graph(g, device="cpu")
        x = torch.zeros((2, 1, 256))
        got = []
        call = pk.group_call

        def spy(prog, sigs, scals, T, device):
            got.append((prog, list(sigs), list(scals), T))
            return call(prog, sigs, scals, T, device)
        with dst.policy("fast"), swapped_attr(comp, "group_call", spy), \
                swapped_attr(pk, "group_call", spy):
            cg.render(x, batch_shape=(2,))
            for prog, sigs, scals, T in got:
                add(prog, sigs, scals, T)
    g5 = presets.config5_feedback_16node()[0]
    g2 = presets.config2_delay_chorus()[0]
    g_mod, mod_ids = modulated_filters()

    def every(cg):
        return cg.init_params(requires_grad=True)

    def ratios(cg):
        return {n: {"ratio": torch.full((2, 256), 0.5, requires_grad=True)}
                for n in mod_ids}
    paths = [(bench_graph(), "fast", every, False),
             (bench_graph(), "fast", lambda c: slider_params(c, "gain",
                                                             "level"), False),
             (bench_graph(), "exact", every, True),
             (envelope_graph(), "fast", every, False),
             (g2, "fast", every, False),
             (g5, "fast", None, True),
             (g_mod, "exact", ratios, True)]
    paths += [(g5, pol, every, wrt) for pol in ("fast", "parity", "exact")
              for wrt in (False, True)]
    for graph, pol, params, wrt in paths:
        srcs.update(cpu_group_backwards(graph, pol, params, wrt))
    # the Fuzz groups' staged reverse builds: the one-node form (the level
    # a slider and a signal) and gain -> Fuzz -> mix's gradient
    for pol in ("fast", "parity", "exact"):
        with dst.policy(pol):
            for kind in ("scal", "sig"):
                b = pw.Builder()
                xv = b.sig()
                prog = b.program([pw.fuzz(b, xv, getattr(b, kind)(), pol)])
                add(prog, [torch.zeros(4, 256)] * prog.n_sig,
                    [scalar_on(1.0, cpu)] * prog.n_scal, 256)
    fz_graph = fuzz_group_graphs()["gain -> Fuzz -> mix"]
    fz = str(next(n for n, v in fz_graph.nodes.items()
                  if v.cfg_name == "distort"))
    srcs.update(cpu_group_backwards(fz_graph, "fast", lambda c: {fz: {
        "level": torch.tensor(2.5, requires_grad=True)}}, True))
    # the feedback cycle's groups in the replayed loop's reverse body
    # (every block input a leaf), config5's 21 blocks past its head
    for pol in ("fast", "parity", "exact"):
        for wrt in (False, True):
            srcs.update(cpu_group_backwards(g5, pol, every, wrt, T=21 * 128,
                                            route="buffers"))
    return sorted(srcs)


def pointwise_phase(dev, card) -> dict:
    """The pointwise groups on the card: every form against its plain
    version and the eager code (pointwise_form_checks); config5, config3
    and the fuzz graphs at B_EXACT x 1 s under fast, parity and exact, the
    kernel route against the plain and the eager routes
    (pointwise_small_renders); config5 at B_C5 and B_PW_WIDE x 10 s and
    config3 at B_C3 x 10 s under fast: the routes' renders held, launches,
    each group's kernel against its plain version, bound and y.copy_, the
    render on both routes in turns; config5 streamed on both routes
    (stream_routes); config5's input gradient through the groups'
    Function (pointwise_grad).  The reverse kernel: every form against
    autograd through interpret (pointwise_reverse_forms), each group of
    config5 at B_C5 and B_PW_WIDE x 10 s and of config3's render at
    B_PW_REV_C3 x 10 s (its shapers' passes at R = 4) under both
    reverse_needs, config5's timed against the route it replaced at B_C5
    (reverse_group_checks), and N_REV_LAUNCHES launches bitwise equal;
    config5's first group cut to short T, its rows chunked
    (reverse_chunked_checks).  Returns the kernels line's figures."""
    import torch
    import dsp_stuff_tpu_torch as dst
    from dsp_stuff_tpu_torch.models import presets
    t_phase = time.time()
    rec = {}
    print("pointwise groups, each form vs its plain version and the eager "
          "code, the card's kernel vs the CPU's plain version:")
    rec["forms"] = pointwise_form_checks(dev)
    print("pointwise groups' reverse kernel, each form vs autograd through "
          "interpret:")
    rec["rev_forms"] = pointwise_reverse_forms(dev)
    print(f"pointwise groups, renders at [{B_EXACT}, 1, {SR}], the kernel "
          f"route vs the plain and the eager routes:")
    rec["small"] = pointwise_small_renders(dev)
    g5 = presets.config5_feedback_16node()[0]
    g3 = presets.config3_oversampled_distortion()[0]
    rng = np.random.default_rng(142)
    for name, g, B in (("config5", g5, B_C5), ("config5", g5, B_PW_WIDE),
                       ("config3", g3, B_C3)):
        what = f"{name}, B={B} x 10 s, fast"
        x = torch.as_tensor(rng.standard_normal((B, 1, T_MAIN),
                                                dtype=np.float32)
                            * np.float32(0.3), device=dev)
        with dst.policy("fast"):
            cg = dst.compile_graph(g, device="cuda")
            routes = ("kernel", "groups", "eager") if name == "config3" \
                else PW_GRAPH_ROUTES
            res = route_renders(cg, x, (B,), routes)
            bit = routes_held(what, res, "fast")
            launches = res["kernel"][3]
            print(f"pointwise groups, {what}: launches {launches}; the "
                  f"kernel route vs the {' and '.join(routes[1:])} "
                  f"route(s) bitwise {bit} (<= {PW_FAST_DB} dBFS) [{card}]")
            del res
            groups = groups_of_render(cg, x, (B,))
            times = group_times(what, groups, dev, card)
            rev = None
            if name == "config5" and B == B_C5:
                print("pointwise groups' reverse kernel, its divide by a "
                      "uniform divisor vs the IEEE divide:")
                rec["divide"] = divide_checks_reverse(groups, dev, card)
            if name == "config5":
                print(f"pointwise groups' reverse kernel, {what}, vs autograd "
                      f"through interpret:")
                rev = reverse_group_checks(what, groups, dev, card,
                                           timed=B == B_C5)
                if B == B_C5:
                    reverse_determinism(*groups[0][:3], groups[0][3], dev)
                    print(f"pointwise groups' reverse kernel, config5's "
                          f"first group at [{B}, T] for T in "
                          f"{REV_CHUNKED_T} (the rows chunked), vs autograd "
                          f"through interpret:")
                    rec["rev_chunked"] = reverse_chunked_checks(groups[0],
                                                                dev, card)
            del groups
            kr, er = route_times(cg, x, (B,))
            fan = (fanin_device_turns(what, cg, x, (B,), card)
                   if name == "config5" else None)
        print(f"  {what}: the whole render {kr:.3f} ms on the kernel route "
              f"against {er:.3f} ms on the eager route (in turns) [{card}]")
        rec[(name, B)] = dict(launches=launches["pointwise"], times=times,
                              render=(kr, er), bitwise=bit, reverse=rev,
                              fanins=fan)
        del x, cg
        torch.cuda.empty_cache()
    check(rec[("config5", B_C5)]["launches"] == 3
          and rec[("config3", B_C3)]["launches"] == 3,
          "config5's and config3's renders launch three groups each")
    print(f"pointwise groups' reverse kernel, config3 at [{B_PW_REV_C3}, 1, "
          f"{T_MAIN}] (its shapers' passes at R = 4), vs autograd:")
    x = torch.as_tensor(rng.standard_normal((B_PW_REV_C3, 1, T_MAIN),
                                            dtype=np.float32)
                        * np.float32(0.3), device=dev)
    with dst.policy("fast"):
        groups = groups_of_render(dst.compile_graph(g3, device="cuda"), x,
                                  (B_PW_REV_C3,))
        rec["rev_config3"] = reverse_group_checks("config3", groups, dev,
                                                  card)
    del x, groups
    torch.cuda.empty_cache()
    print("pointwise groups, config5 streamed (one CUDA graph a block):")
    rec["stream"] = stream_routes(dev, card)
    rec["grad"] = pointwise_grad(dev, card)
    print(f"pointwise phase: {time.time() - t_phase:.1f} s")
    return rec


# -- the signal generator's oscillator kernel, Fuzz in the groups -------------

OSC_T = (128, 256, T_MAIN)    # the oscillator checks: a block, two, 10 s
OSC_MODES = ("Sine", "Triangle", "Square", "Constant")
#: dependent operations a block on the clock's carry: the f64 add under
#: fast; the f32 add and the remainder under parity and exact
OSC_CHAIN_OPS = {"fast": 1, "parity": 2}
B_FUZZ_GROUP = 4          # the Fuzz graphs' renders (x 1 s)
B_FUZZ_TIMED = 128        # the Fuzz group timed (x 10 s)


def osc_bound(rows, T, mod_bytes=0.0):
    """(bound ms, by) of one oscillator call writing [rows, T]: the wave
    written once (and ``mod_bytes`` of modulations read once), against
    its per-sample operations (the step's divide, the total's add, the
    phase's add, the product by 2 pi, the sine and the amplitude's
    product, one operation each)."""
    return bound(4.0 * rows * T + mod_bytes, 6.0 * rows * T)


def osc_floor_ms(T, pol) -> float:
    """The oscillator's dependent-chain floor over T samples:
    OSC_CHAIN_OPS a block over the T / 128 blocks of the carry, and two
    in-block sums of 128 adds (the clock pass's block sum, the wave pass's
    last lane), 4 cycles an operation at SM_CLOCK_GHZ."""
    ops = (T // 128 * OSC_CHAIN_OPS["fast" if pol == "fast" else "parity"]
           + 2 * 128)
    return ops * 4 / (SM_CLOCK_GHZ * 1e9) * 1e3


@contextlib.contextmanager
def lfo_route(route: str):
    """The signal generator through ``route``: "kernel" (the oscillator
    kernel, as shipped) or "eager" (its plain version, the eager ops the
    kernel replaced)."""
    from dsp_stuff_tpu_torch.nodes import gen as ngen
    from dsp_stuff_tpu_torch.ops import gen
    if route == "eager":
        with swapped_attr(ngen, "oscillator", gen.oscillator_plain):
            yield
    else:
        yield


def osc_clocks_held(what, f, T, c0, dev, yk, yp) -> tuple:
    """Under fast with a modulated frequency, where the kernel's running
    f64 sum and the plain version's torch.cumsum may associate otherwise:
    the kernel's block clocks (its clock pass alone) against the plain
    version's, each within one f32 ulp, and the waves bitwise but in the
    blocks whose clock differs.  Returns (clocks that differ, clocks)."""
    import torch
    from dsp_stuff_tpu_torch.ops import gen
    from dsp_stuff_tpu_torch.ops import oscillator_kernel as ok
    kc, kfin = ok.block_clocks_cuda(f, T, c0, exact=False)
    _, pcl, pfin = gen._block_totals(f, T, 128, SR, c0, dev)
    nb = T // 128
    pc = pcl[..., ::128].reshape(kc.shape)
    kd, pd = host(kc).astype(np.float64), host(pc)
    ulp = np.spacing(np.abs(pd)).astype(np.float64)
    worst = float((np.abs(kd - pd) / ulp).max())
    check(worst <= 1.0, f"{what}: block clocks {worst:.1f} ulps from the "
                        f"plain version's")
    differ = (kc != pc).reshape(*pfin.shape, nb)
    yb = yk.reshape(*yk.shape[:-1], nb, 128)
    pb = yp.reshape(*yp.shape[:-1], nb, 128)
    bad = ((yb != pb) & ~(torch.isnan(yb) & torch.isnan(pb))).any(-1)
    stray = bad & ~torch.broadcast_to(differ, bad.shape)
    check(not bool(stray.any()), f"{what}: the wave differs in a block "
                                 f"whose clock is the plain version's")
    return int(differ.sum()), int(differ.numel())


def oscillator_checks(dev) -> dict:
    """The oscillator kernel against its plain version on the card: the
    four modes under fast, parity and exact, a frequency slider at 0.5 and
    997 Hz, a [T] and a [4, T] modulation, the amplitude a slider and a
    [4, T] modulation, clock0 0.25, T in OSC_T: wave and final clock
    bitwise (under fast with a modulated frequency, the clocks within one
    f32 ulp: osc_clocks_held), one or two launches a call and no plain
    version run; the kernel's remainder against torch.remainder."""
    import torch
    import dsp_stuff_tpu_torch as dst
    from dsp_stuff_tpu_torch.ops import gen
    from dsp_stuff_tpu_torch.ops import oscillator_kernel as ok
    rng = np.random.default_rng(150)
    c0 = torch.tensor(0.25, device=dev)
    rec = {"cases": 0, "bitwise": 0, "err": 0.0, "clocks_differ": 0,
           "clocks": 0}
    for T in OSC_T:
        t = np.arange(T)
        freqs = {"0.5 Hz": 0.5, "997 Hz": 997.0,
                 "[T]": torch.as_tensor((300.0 + 250.0 * np.sin(t / 3000.0))
                                        .astype(np.float32), device=dev),
                 "[4, T]": torch.as_tensor(
                     (500.0 + 300.0 * rng.standard_normal((4, T)))
                     .astype(np.float32), device=dev)}
        amps = {"0.6": 0.6, "[4, T]": torch.as_tensor(
            rng.uniform(-1.0, 1.0, (4, T)).astype(np.float32), device=dev)}
        for pol in ("fast", "parity", "exact"):
            n = n_bit = 0
            for mode in OSC_MODES:
                for fk, f in freqs.items():
                    for ak, a in amps.items():
                        what = (f"oscillator {mode} {pol} T={T}, frequency "
                                f"{fk}, amplitude {ak}")
                        plain = {}
                        with dst.policy(pol):
                            ok.LAUNCHES = 0
                            with calls_counted([(gen, "oscillator_plain"),
                                                (gen, "_block_totals")],
                                               plain):
                                yk, ck = gen.oscillator(mode, a, f, T, c0)
                            nl = ok.LAUNCHES
                            yp, cp = gen.oscillator_plain(mode, a, f, T, c0)
                        torch.cuda.synchronize()
                        check(not plain, f"{what}: the kernel's route ran "
                                         f"the plain version {plain}")
                        check(nl == ok.launches_for(mode, T) and nl in (1, 2),
                              f"{what}: {nl} launches")
                        same = (bits_same(yk, yp)
                                and bits_same(ck.reshape(-1), cp.reshape(-1)))
                        if not same:
                            check(pol == "fast" and not isinstance(f, float)
                                  and mode != "Constant",
                                  f"{what}: not bitwise the plain version")
                            d, m = osc_clocks_held(what, f, T, c0, dev, yk,
                                                   yp)
                            rec["clocks_differ"] += d
                            rec["clocks"] += m
                        n += 1
                        n_bit += same
                        fin = yp.isfinite() & yk.isfinite()
                        if bool(fin.any()):
                            rec["err"] = max(rec["err"], float(
                                (yk[fin] - yp[fin]).abs().max()))
            print(f"  T={T}, {pol}: {n_bit} of {n} calls bitwise (wave and "
                  f"final clock) against the plain version on the card")
            rec["cases"] += n
            rec["bitwise"] += n_bit
    print(f"  fast with a modulated frequency: {rec['clocks_differ']} of "
          f"{rec['clocks']} block clocks of the calls that differ not the "
          f"plain version's (each within one f32 ulp; the waves bitwise "
          f"elsewhere); max abs error over all calls {rec['err']:.3e}")
    x32 = torch.as_tensor(np.concatenate([
        np.array([0.0, -0.0, 1e-9, -1e-9, 0.5, 1.0, -1.0, 2.0**23,
                  -(2.0**23), 2.0**24 + 2, -(2.0**30), np.inf, -np.inf,
                  np.nan, 1e-45, -1e-45, 1 - 2.0**-24, -(1 - 2.0**-24),
                  np.nextafter(np.float32(1), np.float32(2))], np.float32),
        (rng.standard_normal(1 << 20) * 40).astype(np.float32)]),
        device=dev)
    x64 = torch.cat([x32.double()[:-1000], torch.as_tensor(
        rng.standard_normal(1000) * 1e6, device=dev)])
    y32, y64 = ok.remainder_cuda(x32, x64)
    w32, w64 = torch.remainder(x32, 1.0), torch.remainder(x64, 1.0)
    torch.cuda.synchronize()
    ok64 = bool(torch.equal(torch.isnan(y64), torch.isnan(w64)) and torch.equal(
        y64.nan_to_num().view(torch.int64), w64.nan_to_num().view(torch.int64)))
    check(bits_same(y32, w32) and ok64,
          "the oscillator's remainder is not torch.remainder(x, 1)")
    print(f"  the kernel's remainder (x - trunc(x), + 1 below 0) bitwise "
          f"torch.remainder(x, 1) over {x32.numel():,} f32 and f64 values "
          f"(around 0 and 1, past a wrap, integers, +-inf, NaN)")
    return rec


def oscillator_phase(dev, card) -> dict:
    """The oscillator kernel on the card: oscillator_checks; config5's LFO
    (Sine 0.5 Hz, amplitude 0.6) at [1, T_MAIN] under fast and parity,
    kernel and plain version in turns (CUDA events), its device time by
    pass (torch.profiler) beside its bound and its dependent-chain floor,
    and at [1, 128] (N_GROUP_CALLS calls back to back); the Function on
    the card: gradients of a loss through the LFO (amplitude, frequency,
    a downstream input) bitwise autograd through the plain version.
    Returns the kernels line's figures."""
    import torch
    import dsp_stuff_tpu_torch as dst
    from dsp_stuff_tpu_torch.ops import gen
    t_phase = time.time()
    print("oscillator kernel vs its plain version on the card:")
    rec = oscillator_checks(dev)
    c0 = torch.tensor(0.25, device=dev)
    rec["times"] = {}
    for pol in ("fast", "parity"):
        with dst.policy(pol):
            for T in (T_MAIN, 128):
                def fk():
                    return gen.oscillator("Sine", 0.6, 0.5, T, c0)

                def fp():
                    return gen.oscillator_plain("Sine", 0.6, 0.5, T, c0)
                if T == 128:
                    tk = cuda_ms(fk, inner=N_GROUP_CALLS)
                    tp = cuda_ms(fp, inner=N_GROUP_CALLS)
                else:
                    tk, tp = in_turns(fk, fp, N_TIMED_SLOW)
                dev_ms = {p: kernel_device_ms(fk, f"oscillator_{p}_kernel")[0]
                          for p in (("wave",) if T == 128
                                    else ("clock", "wave"))}
                bnd = osc_bound(1, T)
                floor = osc_floor_ms(T, pol)
                rec["times"][(pol, T)] = dict(ms=tk, plain_ms=tp,
                                              device_ms=dev_ms, bound=bnd,
                                              floor=floor)
                print(f"  config5's LFO (Sine 0.5 Hz), [1, {T}], {pol}: "
                      f"kernel {tk:.4f} ms, plain {tp:.3f} ms "
                      f"({tp / tk:.1f}x); device ms by pass {dev_ms}; bound "
                      f"{bnd[0] * 1e3:.3f} us by {bnd[1]}, dependent-chain "
                      f"floor {floor * 1e3:.3f} us ("
                      f"{floor / tk:.1%} of the kernel) [{card}]")
    # the Function on the card: its backward the reverse kernel, against
    # the plain adjoint as its backward and autograd through the plain
    # version (the route the reverse kernel replaced)
    from dsp_stuff_tpu_torch.ops import oscillator_kernel as ok
    from dsp_stuff_tpu_torch.ops import oscillator_reverse_kernel as ork
    rng = np.random.default_rng(151)
    T = 4 * SR
    x = torch.as_tensor(rng.standard_normal((4, T)).astype(np.float32),
                        device=dev)
    w = torch.as_tensor(rng.standard_normal((4, T)).astype(np.float32),
                        device=dev)

    def adjoint_route(mode, a, f, n, c):
        from dsp_stuff_tpu_torch.utils.precision import get_policy
        exact = get_policy().name != "fast"
        return gen.run(lambda m, a_, f_, n_, c_: ok.oscillator_cuda(
            m, a_, f_, n_, c_, exact), mode, a, f, n, c,
            backward=gen.adjoint_backward)
    for pol in ("fast", "parity"):
        worst = 0.0
        for mode in ("Sine", "Triangle"):
            grads, recomputed = {}, {}
            for route in ("kernel", "adjoint", "plain"):
                a = torch.tensor(0.6, device=dev, requires_grad=True)
                f = torch.tensor(3.0, device=dev, requires_grad=True)
                xx = x.clone().requires_grad_(True)
                with dst.policy(pol):
                    fn = {"kernel": gen.oscillator, "adjoint": adjoint_route,
                          "plain": gen.oscillator_plain}[route]
                    y, _ = fn(mode, a, f, T, c0)
                    ork.LAUNCHES = 0
                    with calls_counted([(gen, "oscillator_plain"),
                                        (gen, "oscillator_adjoint")],
                                       recomputed.setdefault(route, {})):
                        ((y * xx) * w).sum().backward()
                    if route == "kernel":
                        check(ork.LAUNCHES == 2 and not recomputed[route],
                              f"oscillator {mode} {pol}: the backward "
                              f"launched the reverse kernel {ork.LAUNCHES} "
                              f"times, ran {recomputed[route]}")
                grads[route] = [a.grad, f.grad, xx.grad]
            torch.cuda.synchronize()
            check(all(bits_same(g.reshape(-1), h.reshape(-1))
                      for g, h in zip(grads["kernel"], grads["adjoint"])),
                  f"oscillator {mode} {pol}: the reverse kernel's gradients "
                  f"are not the plain adjoint's")
            for i, (g, h) in enumerate(zip(grads["kernel"], grads["plain"])):
                worst = max(worst, grad_close(
                    f"oscillator {mode} {pol} gradient {i} vs autograd", g,
                    h))
        print(f"  the Function's gradients (amplitude, frequency, a "
              f"downstream input) at [4, {T}], {pol}: the reverse kernel "
              f"(two launches a backward, no plain version run) bitwise "
              f"the plain adjoint as the backward, against autograd "
              f"through the plain version worst {worst:.2e} (rtol "
              f"{GRAD_RTOL})")
    print(f"oscillator phase: {time.time() - t_phase:.1f} s")
    return rec


OSC_REV_DB = -100.0       # the reverse oscillator kernel's per-sample
OSC_REV_RTOL = 1e-6       # ... and summed gradients vs its plain version


def osc_reverse_bound(rows, T, mod_bytes=0.0):
    """(bound ms, by) of one reverse oscillator call over [rows, T]: the
    wave's cotangent read once (and ``mod_bytes`` of modulated operands
    read and per-sample gradients written once), against its per-sample
    operations (the step's divide, the total's add, the phase's add, the
    product by 2 pi, the sine, the cosine, the amplitude gradient's
    product, g_w's, the derivative's two products, the block sum's f64
    add and the chain's add: twelve, one operation each)."""
    return bound(4.0 * rows * T + mod_bytes, 12.0 * rows * T)


def osc_reverse_floor_ms(T) -> float:
    """The reverse's dependent-chain floor over T samples: the carry over
    the T / 128 blocks (an add a block, f64 under fast, f32 under parity),
    a slider frequency's block chains (128 adds a block, a thread a block
    of SUM_THREADS, in T / 128 / SUM_THREADS rounds) and pass A's last
    lane's in-block sum (128 adds), 4 cycles an operation at
    SM_CLOCK_GHZ."""
    from dsp_stuff_tpu_torch.ops import oscillator_reverse_kernel as ork
    nb = T // 128
    ops = nb + 128 * -(-nb // ork.SUM_THREADS) + 128
    return ops * 4 / (SM_CLOCK_GHZ * 1e9) * 1e3


def osc_autograd(mode, a, f, T, c0, ct_y, ct_clock):
    """Autograd through oscillator_plain (the route the reverse kernel
    replaced): the gradients of amp, freq and clock0 (None where none)."""
    import torch
    from dsp_stuff_tpu_torch.ops import gen
    ops = [t.detach().clone().requires_grad_(True) for t in (a, f, c0)]
    with torch.enable_grad():
        y, c = gen.oscillator_plain(mode, *ops[:2], T, ops[2])
        pairs = [(o, ct) for o, ct in zip((y, c), (ct_y, ct_clock))
                 if ct is not None and o.requires_grad]
        if not pairs:
            return [None] * 3
        return list(torch.autograd.grad([o for o, _ in pairs], ops,
                                        [ct for _, ct in pairs],
                                        allow_unused=True))


def osc_grads_held(what, got, want, rtol) -> tuple:
    """Gradients ``got`` against ``want``: None in both or neither; a
    per-sample one <= OSC_REV_DB (max-normalized, ``rtol`` for a sum);
    returns (max abs error, every one bitwise)."""
    err, bit = 0.0, True
    for i, (g, w) in enumerate(zip(got, want)):
        check((g is None) == (w is None), f"{what}: gradient {i} "
                                          f"{'missing' if g is None else ''}")
        if g is None:
            continue
        check(g.shape == w.shape, f"{what}: gradient {i} shape")
        bit &= bits_same(g.reshape(-1), w.reshape(-1))
        if g.dim():
            d = dbfs_dev(g, w)
            check(d <= OSC_REV_DB, f"{what}: gradient {i} {d:.1f} dBFS")
        else:
            check(sums_close(g, w, rtol, 1e-12),
                  f"{what}: gradient {i} {float(g):.9e} vs {float(w):.9e}")
        err = max(err, float((g.double() - w.double()).abs().max()))
    return err, bit


def oscillator_reverse_checks(dev) -> dict:
    """The reverse oscillator kernel against its plain version
    (gen.oscillator_adjoint) on the same cotangents: the four modes under
    fast, parity and exact, a frequency slider at 0.5 and 997 Hz, a [T]
    and a [4, T] modulation, the amplitude a slider and a [4, T]
    modulation, clock0 0.25, T in OSC_T, the final clock's cotangent
    present and absent (OSC_REV_DB per sample, OSC_REV_RTOL a sum, printed
    with whether bitwise), its launches the plan's passes and no plain
    version run; against autograd through oscillator_plain (the route it
    replaced) at T = 128 and 256 for every case and config5's LFO at
    T_MAIN (rtol GRAD_RTOL, or where autograd's f32 sum cancels past it,
    the plain adjoint's float64 sum within OSC_REV_RTOL and autograd
    farther from it); ten launches bitwise equal."""
    import torch
    import dsp_stuff_tpu_torch as dst
    from dsp_stuff_tpu_torch.ops import gen
    from dsp_stuff_tpu_torch.ops import oscillator_kernel as ok
    from dsp_stuff_tpu_torch.ops import oscillator_reverse_kernel as ork
    rng = np.random.default_rng(160)
    gen_ = torch.Generator(device=dev).manual_seed(161)
    c0 = torch.tensor(0.25, device=dev)
    need = (True, True, True)
    rec = {"cases": 0, "bitwise": 0, "err": 0.0, "autograd": 0,
           "autograd_f64": 0, "autograd_worst": 0.0}
    for T in OSC_T:
        t = np.arange(T)
        freqs = {"0.5 Hz": 0.5, "997 Hz": 997.0,
                 "[T]": (300.0 + 250.0 * np.sin(t / 3000.0)),
                 "[4, T]": 500.0 + 300.0 * rng.standard_normal((4, T))}
        amps = {"0.6": 0.6, "[4, T]": rng.uniform(-1.0, 1.0, (4, T))}
        freqs = {k: torch.as_tensor(np.asarray(v, np.float32), device=dev)
                 for k, v in freqs.items()}
        amps = {k: torch.as_tensor(np.asarray(v, np.float32), device=dev)
                for k, v in amps.items()}
        for pol in ("fast", "parity", "exact"):
            n = n_bit = 0
            with dst.policy(pol):
                for mode in OSC_MODES:
                    for fk, f in freqs.items():
                        for ak, a in amps.items():
                            y, c, cl = ok.oscillator_cuda(
                                mode, a, f, T, c0, pol != "fast")
                            ct_y = torch.randn(y.shape, generator=gen_,
                                               device=dev)
                            ct_c = torch.randn(c.shape, generator=gen_,
                                               device=dev)
                            for cc in (None, ct_c):
                                what = (f"reverse oscillator {mode} {pol} "
                                        f"T={T}, frequency {fk}, amplitude "
                                        f"{ak}, final clock's cotangent "
                                        f"{'absent' if cc is None else 'present'}")
                                plain = {}
                                ork.LAUNCHES = 0
                                with calls_counted(
                                        [(gen, "oscillator_plain"),
                                         (gen, "oscillator_adjoint"),
                                         (gen, "_block_totals")], plain):
                                    got = ork.oscillator_reverse_cuda(
                                        mode, a, f, T, c0, ct_y, cc, need,
                                        cl)
                                nl = ork.LAUNCHES
                                want = gen.oscillator_adjoint(
                                    mode, a, f, T, c0, ct_y, cc, need)
                                torch.cuda.synchronize()
                                check(not plain, f"{what}: ran {plain}")
                                ln = ork.plan_reverse(mode, a, f, T, c0,
                                                      ct_y, cc, need, cl)
                                check(nl == ork.passes_of(ln.passes),
                                      f"{what}: {nl} launches")
                                err, bit = osc_grads_held(
                                    what, got, want, OSC_REV_RTOL)
                                rec["err"] = max(rec["err"], err)
                                n += 1
                                n_bit += bit
                                if T <= 256:
                                    osc_vs_autograd(what, mode, a, f, T, c0,
                                                    ct_y, cc, got, want, rec)
            print(f"  T={T}, {pol}: {n_bit} of {n} calls bitwise (every "
                  f"gradient) against the plain adjoint on the card")
            rec["cases"] += n
            rec["bitwise"] += n_bit
    # config5's LFO at the main path's length, and ten launches
    ct = torch.randn((T_MAIN,), generator=gen_, device=dev)
    a, f = (torch.tensor(v, device=dev) for v in (0.6, 0.5))
    for pol in ("fast", "parity"):
        with dst.policy(pol):
            _, _, cl = ok.oscillator_cuda("Sine", a, f, T_MAIN, c0,
                                          pol != "fast")
            got = ork.oscillator_reverse_cuda("Sine", a, f, T_MAIN, c0, ct,
                                              None, need, cl)
            want = gen.oscillator_adjoint("Sine", a, f, T_MAIN, c0, ct, None,
                                          need)
            osc_vs_autograd(f"config5's LFO {pol} [1, {T_MAIN}]", "Sine", a,
                            f, T_MAIN, c0, ct, None, got, want, rec)
            for _ in range(N_REV_LAUNCHES - 1):
                again = ork.oscillator_reverse_cuda("Sine", a, f, T_MAIN, c0,
                                                    ct, None, need, cl)
                check(all(bits_same(g.reshape(-1), h.reshape(-1))
                          for g, h in zip(again, got)),
                      f"the reverse oscillator kernel ({pol}) is not "
                      f"bitwise equal to itself")
    torch.cuda.synchronize()
    print(f"  {N_REV_LAUNCHES} launches at config5's LFO [1, {T_MAIN}] "
          f"bitwise equal (fast, parity); against autograd through "
          f"oscillator_plain (T = 128 and 256 every case, config5's LFO at "
          f"{T_MAIN}): {rec['autograd']} gradients, worst "
          f"{rec['autograd_worst']:.2e} max-normalized (rtol {GRAD_RTOL}), "
          f"{rec['autograd_f64']} sums held by the float64 rule; max abs "
          f"error against the plain adjoint over all calls {rec['err']:.3e}")
    return rec


def osc_vs_autograd(what, mode, a, f, T, c0, ct_y, ct_clock, got, want,
                    rec) -> None:
    """The kernel's gradients ``got`` against autograd through
    oscillator_plain: within GRAD_RTOL (max-normalized), or where
    autograd's f32 sum cancels past it, the plain adjoint's float64 sum
    (``want``) within OSC_REV_RTOL and autograd's farther from it."""
    ref = osc_autograd(mode, a, f, T, c0, ct_y, ct_clock)
    for i, (g, r, p) in enumerate(zip(got, ref, want)):
        check((g is None) == (r is None), f"{what}: gradient {i} vs "
                                          f"autograd's")
        if g is None:
            continue
        r = r.reshape(g.shape)
        e = float((g.double() - r.double()).abs().max()
                  / r.double().abs().max().clamp_min(1e-30))
        rec["autograd"] += 1
        if e <= GRAD_RTOL:
            rec["autograd_worst"] = max(rec["autograd_worst"], e)
            continue
        off_k = float((g.double() - p.double()).abs().max())
        off_r = float((r.double() - p.double()).abs().max())
        check(g.dim() == 0 and sums_close(g, p, OSC_REV_RTOL, 1e-12)
              and off_r >= off_k,
              f"{what}: gradient {i} {g.flatten()[:3].tolist()} against "
              f"autograd's {r.flatten()[:3].tolist()}, the float64 sum's "
              f"{p.flatten()[:3].tolist()}")
        rec["autograd_f64"] += 1
        print(f"  {what}: gradient {i} {float(g):.9e} on the card, "
              f"autograd's f32 sum {float(r):.9e}, the plain adjoint's "
              f"float64 {float(p):.9e}")


def oscillator_reverse_phase(dev, card) -> dict:
    """The reverse oscillator kernel on the card: oscillator_reverse_checks;
    config5's LFO (Sine 0.5 Hz, amplitude 0.6, every operand a gradient,
    the wave's cotangent alone) at [1, T_MAIN] under fast and parity, the
    kernel and its plain version in turns (CUDA events), its device time
    by pass (torch.profiler) beside its bound and its dependent-chain
    floor.  Returns the kernels line's figures."""
    import torch
    import dsp_stuff_tpu_torch as dst
    from dsp_stuff_tpu_torch.ops import gen
    from dsp_stuff_tpu_torch.ops import oscillator_kernel as ok
    from dsp_stuff_tpu_torch.ops import oscillator_reverse_kernel as ork
    t_phase = time.time()
    print("reverse oscillator kernel vs its plain version on the card:")
    rec = oscillator_reverse_checks(dev)
    c0 = torch.tensor(0.25, device=dev)
    a, f = (torch.tensor(v, device=dev) for v in (0.6, 0.5))
    ct = torch.randn((T_MAIN,), device=dev,
                     generator=torch.Generator(device=dev).manual_seed(162))
    need = (True, True, True)
    rec["times"] = {}
    for pol in ("fast", "parity"):
        with dst.policy(pol):
            _, _, cl = ok.oscillator_cuda("Sine", a, f, T_MAIN, c0,
                                          pol != "fast")

            def fk():
                return ork.oscillator_reverse_cuda("Sine", a, f, T_MAIN, c0,
                                                   ct, None, need, cl)

            def fp():
                return gen.oscillator_adjoint("Sine", a, f, T_MAIN, c0, ct,
                                              None, need)
            tk, tp = in_turns(fk, fp, N_TIMED_SLOW)
            dev_ms = {p: kernel_device_ms(fk, f"oscillator_reverse_{p}_"
                                              f"kernel")[0]
                      for p in ("wave", "sum")}
        bnd = osc_reverse_bound(1, T_MAIN)
        floor = osc_reverse_floor_ms(T_MAIN)
        total = (None if None in dev_ms.values()
                 else sum(dev_ms.values()))
        rec["times"][pol] = dict(ms=tk, plain_ms=tp, device_ms=total,
                                 by_pass=dev_ms, bound=bnd, floor=floor)
        print(f"  config5's LFO (Sine 0.5 Hz) backward, [1, {T_MAIN}], "
              f"{pol}: kernel {tk:.4f} ms, plain adjoint {tp:.3f} ms "
              f"({tp / tk:.1f}x); device ms by pass {dev_ms}; bound "
              f"{bnd[0] * 1e3:.3f} us by {bnd[1]}, dependent-chain floor "
              f"{floor * 1e3:.3f} us"
              + (f" ({floor / total:.1%} of the device time)" if total
                 else "") + f" [{card}]")
    print(f"reverse oscillator phase: {time.time() - t_phase:.1f} s")
    return rec


def fuzz_group_graphs() -> dict:
    """{name: graph} of the Fuzz graphs the smoke renders: input -> gain
    -> Fuzz -> mix (with the input) -> output; the same with the Fuzz at
    oversample "4" and its level from an LFO; a Fuzz inside a feedback
    cycle (add -> Fuzz -> low_pass -> gain -> add)."""
    import dsp_stuff_tpu_torch as dst
    from dsp_stuff_tpu_torch.ids import IdSpace
    out = {}
    for name, over, mod in (("gain -> Fuzz -> mix", "1", False),
                            ("Fuzz oversample 4, level from an LFO", "4",
                             True)):
        g = dst.Graph(IdSpace())
        inp = g.add("input")
        gn = g.add("gain", level=1.7)
        fz = g.add("distort", mode="Fuzz", level=2.5, oversample=over)
        mx = g.add("mix", ratio=0.4)
        o = g.add("output")
        g.chain(inp, gn, fz)
        g.connect(fz, "out", mx, "a")
        g.connect(inp, "out", mx, "b")
        g.connect(mx, "out", o, "in")
        if mod:
            lfo = g.add("signal_gen", mode="Sine", frequency=3.0,
                        amplitude=0.9)
            g.connect(lfo, "out", fz, "level")
        out[name] = g
    g = dst.Graph(IdSpace())
    inp, add = g.add("input"), g.add("add")
    fz = g.add("distort", mode="Fuzz", level=3.0)
    lp, fb, o = g.add("low_pass", ratio=0.3), g.add("gain", level=0.4), \
        g.add("output")
    g.connect(inp, "out", add, "a")
    g.chain(add, fz, lp, fb)
    g.connect(fb, "out", add, "b")
    g.connect(lp, "out", o, "in")
    out["Fuzz in a feedback cycle"] = g
    return out


@contextlib.contextmanager
def fuzz_groups_off():
    """The renders inside with no Fuzz in the pointwise groups (each Fuzz
    its eager shaping.fuzz: the route before them)."""
    from dsp_stuff_tpu_torch.compiler import pointwise as pw
    real = pw.node_form

    def form(cfg, sel):
        if cfg == "distort" and sel.get("mode") == "Fuzz":
            return None
        return real(cfg, sel)
    with swapped_attr(pw, "node_form", form):
        yield


def fuzz_group_phase(dev, card) -> dict:
    """Fuzz in the pointwise groups on the card: the fuzz form's kernel
    (a staged program, three warp block maxima) against the eager
    shaping.fuzz and its plain version, under fast, parity and exact, at
    PW_SHAPES' float4 shape with an all-zero block and PW_SPECIALS
    planted; fuzz_group_graphs() at B_FUZZ_GROUP x 1 s (the cycle's
    block program and its per-node scan) on the kernel route against the
    route without Fuzz in the groups and the eager route (bitwise under
    parity and exact, <= PW_FAST_DB under fast), no Fuzz's eager code run
    (no torch.amax of it), the launches printed; the Fuzz group of
    gain -> Fuzz -> mix at B_FUZZ_TIMED x 10 s timed against its plain
    version and its bytes bound (group_times); its gradient through the
    groups' Function (group_vjp, by design) against autograd through the
    eager ops.  Returns the kernels line's figures."""
    import torch
    import dsp_stuff_tpu_torch as dst
    from dsp_stuff_tpu_torch.compiler import compile as comp
    from dsp_stuff_tpu_torch.compiler import pointwise as pw
    from dsp_stuff_tpu_torch.ops import pointwise_kernel as pk
    from dsp_stuff_tpu_torch.ops import shaping
    from dsp_stuff_tpu_torch.utils.precision import scalar_on
    t_phase = time.time()
    rec = {}
    B, T = PW_SHAPES[0]
    print(f"Fuzz groups, the fuzz form's kernel vs the eager shaping.fuzz, "
          f"[{B}, {T}], specials and an all-zero block planted:")
    for pol in ("fast", "parity", "exact"):
        xs = pointwise_inputs(1, (B, T), dev, 777)
        xs[0][1, 128:256] = 0.0
        lv = torch.as_tensor(np.random.default_rng(778).uniform(
            0.0, 8.0, (B, T)).astype(np.float32), device=dev)
        for kind, level in (("slider", 3.0), ("[B, T]", lv)):
            b = pw.Builder()
            xv = b.sig()
            lvv = b.scal() if kind == "slider" else b.sig()
            prog = b.program([pw.fuzz(b, xv, lvv, pol)])
            sigs = xs if kind == "slider" else xs + [lv]
            scals = [scalar_on(level, dev)] if kind == "slider" else []
            with dst.policy(pol):
                pk.LAUNCHES = 0
                k = pk.group_call(prog, sigs, scals, T, dev)[0]
                n = pk.LAUNCHES
                e = shaping.fuzz(xs[0], level, 128)
                p = pw.interpret(prog, sigs, scals, T, dev)[0]
                c = pw.interpret(prog, [s.cpu() for s in sigs],
                                 [s.cpu() for s in scals], T,
                                 torch.device("cpu"))[0]
            torch.cuda.synchronize()
            what = f"Fuzz group {pol}, level {kind}"
            check(n == 1, f"{what}: {n} launches")
            check(bool(torch.isnan(k[1, 128:256]).all()),
                  f"{what}: the all-zero block is not NaN")
            pointwise_held(what + " vs eager", k, e, pol)
            pointwise_held(what + " vs plain", k, p, pol)
            d = nonfinite_dbfs(what + " vs CPU", k.cpu(), c)
            print(f"  {what}: bitwise the eager fuzz {bits_same(k, e)}, the "
                  f"plain version {bits_same(k, p)}, vs the CPU's plain "
                  f"version {d:.1f} dBFS [{card}]")
    rng = np.random.default_rng(779)
    launches = {}
    fuzz_runs = {}
    for name, g in fuzz_group_graphs().items():
        x = (rng.standard_normal((B_FUZZ_GROUP, 1, SR)) * 0.3).astype(
            np.float32)
        x[1, 0, 256:384] = 0.0
        xd = torch.as_tensor(x, device=dev)
        for fusion in ((True, False) if "cycle" in name else (True,)):
            for pol in ("fast", "parity", "exact"):
                with swapped_attr(comp, "CYCLE_FUSION", fusion), \
                        dst.policy(pol):
                    cg = dst.compile_graph(g, device="cuda")
                    res = {}
                    with calls_counted([(shaping, "fuzz")], fuzz_runs):
                        res["kernel"] = route_renders(cg, xd, (B_FUZZ_GROUP,),
                                                      ("kernel",))["kernel"]
                    with fuzz_groups_off():
                        # a graph of its own: a plan is kept per graph
                        res["groups"] = route_renders(
                            dst.compile_graph(g, device="cuda"), xd,
                            (B_FUZZ_GROUP,), ("kernel",))["kernel"]
                    res["eager"] = route_renders(cg, xd, (B_FUZZ_GROUP,),
                                                 ("eager",))["eager"]
                what = f"{name}{'' if fusion else ' (per-node scan)'} {pol}"
                k = route_leaves(res["kernel"])
                bit = True
                for route in ("groups", "eager"):
                    other = route_leaves(res[route])
                    check(len(k) == len(other), f"{what}: the {route} route "
                                                f"has another structure")
                    for i, (a, b2) in enumerate(zip(k, other)):
                        if a.dtype.is_floating_point:
                            pointwise_held(f"{what} leaf {i} vs {route}",
                                           a.float(), b2.float(), pol)
                            bit &= bits_same(a.float(), b2.float())
                        else:
                            check(bool((a == b2).all()),
                                  f"{what} leaf {i} vs {route}")
                launches[what] = res["kernel"][3]
                print(f"  {what}, [{B_FUZZ_GROUP}, 1, {SR}]: the kernel "
                      f"route bitwise the route without Fuzz in the groups "
                      f"and the eager route: {bit}; launches "
                      f"{expect_str(res['kernel'][3])}, without "
                      f"{expect_str(res['groups'][3])} [{card}]")
    check(not fuzz_runs, f"a Fuzz node ran its eager shaping.fuzz (its "
                         f"torch.amax) on the kernel route: {fuzz_runs}")
    rec["launches"] = launches
    g = fuzz_group_graphs()["gain -> Fuzz -> mix"]
    x = torch.as_tensor(rng.standard_normal((B_FUZZ_TIMED, 1, T_MAIN),
                                            dtype=np.float32)
                        * np.float32(0.3), device=dev)
    with dst.policy("fast"):
        cg = dst.compile_graph(g, device="cuda")
        groups = [gr for gr in groups_of_render(cg, x, (B_FUZZ_TIMED,))
                  if pw.has_bmax(gr[0])]
        check(len(groups) == 1, f"gain -> Fuzz -> mix: {len(groups)} Fuzz "
                                f"groups")
        rec["times"] = group_times(f"Fuzz group (gain -> Fuzz -> mix), "
                                   f"B={B_FUZZ_TIMED} x 10 s, fast", groups,
                                   dev, card)[0]
    del x, groups
    # the gradient through a Fuzz group: the groups' Function, its
    # backward the reverse kernel's staged build (one call, group_vjp and
    # interpret not run)
    from dsp_stuff_tpu_torch.ops import pointwise_reverse_kernel as prk
    xs = torch.as_tensor(rng.standard_normal((4, SR)).astype(np.float32),
                         device=dev)
    w = torch.as_tensor(rng.standard_normal((4, SR)).astype(np.float32),
                        device=dev)
    b = pw.Builder()
    prog = b.program([pw.fuzz(b, b.sig(), b.scal(), "fast")])
    with dst.policy("fast"):
        got, want = [], []
        for route in ("group", "eager"):
            xx = xs.clone().requires_grad_(True)
            lv = torch.tensor(2.5, device=dev, requires_grad=True)
            y = (pk.group_call(prog, [xx], [lv], SR, dev)[0]
                 if route == "group" else shaping.fuzz(xx, lv, 128))
            prk.LAUNCHES, ran = 0, {}
            with calls_counted([(pk, "group_vjp"), (pw, "interpret")], ran):
                (y * w).sum().backward()
            if route == "group":
                check(prk.LAUNCHES == 1 and not ran,
                      f"a Fuzz group's backward: {prk.LAUNCHES} reverse "
                      f"calls, ran {ran}")
            (got if route == "group" else want).extend([xx.grad, lv.grad])
    torch.cuda.synchronize()
    errs = [grad_close(f"Fuzz group gradient {i}", g_, w_)
            for i, (g_, w_) in enumerate(zip(got, want))]
    rec["grad_err"] = max(errs)
    print(f"  a Fuzz group's gradient (x and its level) through the "
          f"groups' Function (the reverse kernel, one call) against "
          f"autograd through the eager fuzz, [4, {SR}]: worst "
          f"{rec['grad_err']:.2e} (rtol {GRAD_RTOL}) [{card}]")
    rec["reverse"] = fuzz_reverse_checks(dev, card)
    rec["graph_grad"] = fuzz_graph_grad(dev, card)
    print(f"Fuzz group phase: {time.time() - t_phase:.1f} s")
    return rec


#: the Fuzz reverse checks' shapes: a float4 shape, three rows, the main
#: path's
FUZZ_REV_SHAPES = ((4, 4096), (3, 1024), (B_FUZZ_TIMED, T_MAIN))


def fuzz_reverse_inputs(shape, dev, seed):
    """x [B, T] N(0, 0.5) on ``dev`` with a NaN, an inf and a -inf, an
    all-zero block and a block of ties (its max at three samples)
    planted."""
    import torch
    B, T = shape
    x = (np.random.default_rng(seed).standard_normal(shape) * 0.5).astype(
        np.float32)
    x[0, 300], x[min(2, B - 1), 700], x[0, 900] = np.nan, np.inf, -np.inf
    x[1, 128:256] = 0.0
    x[B - 1, 10], x[B - 1, 40], x[B - 1, 77] = 3.0, -3.0, 3.0
    return torch.as_tensor(x, device=dev)


def fuzz_reverse_checks(dev, card) -> dict:
    """The reverse kernel's staged build on a Fuzz group (one node, the
    level a slider and a [B, T] modulation) at FUZZ_REV_SHAPES under fast,
    parity and exact, NaN, inf, all-zero and tied blocks planted, every
    operand and x alone needing a gradient: against autograd through
    interpret (reverse_held: row 43's bounds, the non-finite samples
    exactly autograd's) and against group_adjoint(sums64=True) (bitwise
    expected: per element <= PW_REV_DB, a sum rtol 1e-6); ten launches
    bitwise; the slider case at [B_FUZZ_TIMED, T_MAIN] under fast timed
    against group_vjp beside its bound (reverse_group_checks).  Returns
    the counts and the timed record."""
    import torch
    import dsp_stuff_tpu_torch as dst
    from dsp_stuff_tpu_torch.compiler import pointwise as pw
    from dsp_stuff_tpu_torch.ops import pointwise_kernel as pk
    from dsp_stuff_tpu_torch.ops import pointwise_reverse_kernel as prk
    from dsp_stuff_tpu_torch.utils.precision import scalar_on
    t0 = time.time()
    print("the reverse pointwise kernel on Fuzz groups (the staged build), "
          "specials, an all-zero block and ties planted:")
    out = {"cases": 0, "vjp_bitwise": 0, "plain_bitwise": 0, "held64": 0}
    for pol in ("fast", "parity", "exact"):
        with dst.policy(pol):
            for j, shape in enumerate(FUZZ_REV_SHAPES):
                B, T = shape
                x = fuzz_reverse_inputs(shape, dev, 790 + j)
                for kind in ("slider", "[B, T]"):
                    b = pw.Builder()
                    xv = b.sig()
                    lvv = b.scal() if kind == "slider" else b.sig()
                    prog = b.program([pw.fuzz(b, xv, lvv, pol)])
                    if kind == "slider":
                        sigs, scals = [x], [scalar_on(2.5, dev)]
                    else:
                        sigs, scals = [x, torch.rand(
                            shape, device=dev,
                            generator=torch.Generator(device=dev)
                            .manual_seed(j)) * 4.0], []
                    cts = reverse_cotangents(prog, sigs, scals, T, dev,
                                             800 + j)
                    for need in reverse_needs(prog):
                        need = list(need)
                        what = (f"Fuzz reverse {pol} {list(shape)}, level "
                                f"{kind}, need {sum(need)}")
                        _, bit, h = reverse_held(what, prog, sigs, scals,
                                                 cts, need, T, dev)
                        k = prk.reverse_group(prog, sigs, scals, cts, need,
                                              T, dev)
                        p = pk.group_adjoint(prog, sigs, scals, cts, need,
                                             T, dev, sums64=True)
                        torch.cuda.synchronize()
                        same = True
                        for i, (a, q) in enumerate(zip(k, p)):
                            check((a is None) == (q is None),
                                  f"{what}: gradient {i} vs the plain's")
                            if a is None:
                                continue
                            same &= bits_same(a, q)
                            if a.dim():
                                d = nonfinite_dbfs(f"{what} vs plain", a, q)
                                check(d <= PW_REV_DB, f"{what}: gradient {i} "
                                                      f"{d:.1f} dBFS")
                            else:
                                check(sums_close(a, q, 1e-6, 0.0),
                                      f"{what}: sum {i} vs the plain's")
                        out["cases"] += 1
                        out["vjp_bitwise"] += bit
                        out["plain_bitwise"] += same
                        out["held64"] += h
                        del k, p
                del x, sigs, scals, cts
                torch.cuda.empty_cache()
        print(f"  {pol}: {out['cases']} cases so far, bitwise autograd "
              f"through interpret {out['vjp_bitwise']}, bitwise the plain "
              f"adjoint {out['plain_bitwise']}, sums by the float64 rule "
              f"{out['held64']}")
    b = pw.Builder()
    prog = b.program([pw.fuzz(b, b.sig(), b.scal(), "fast")])
    with dst.policy("fast"):
        reverse_determinism(prog, [fuzz_reverse_inputs((4, 4096), dev, 795)],
                            [scalar_on(2.5, dev)], 4096, dev)
        x = torch.as_tensor(np.random.default_rng(796).standard_normal(
            (B_FUZZ_TIMED, T_MAIN), dtype=np.float32) * np.float32(0.3),
            device=dev)
        timed = reverse_group_checks(
            f"Fuzz group, B={B_FUZZ_TIMED} x 10 s, fast",
            [(prog, [x], [scalar_on(2.5, dev)], T_MAIN)], dev, card,
            timed=True)
    out["times"] = next(r for r in timed if sum(r[0]) > 1)
    del x, timed
    torch.cuda.empty_cache()
    print(f"  Fuzz reverse checks: {time.time() - t0:.1f} s")
    return out


def fuzz_graph_grad(dev, card) -> dict:
    """gain -> Fuzz -> mix through compile_graph on the card, the loss's
    gradient with respect to the input and the Fuzz level: at
    [B_FUZZ_TIMED, T_MAIN] one reverse pointwise call (the group's) and
    neither interpret nor oscillator_plain run, forward or backward;
    at [2, SR] against the CPU port (rtol GRAD_RTOL)."""
    import torch
    import dsp_stuff_tpu_torch as dst
    g = fuzz_group_graphs()["gain -> Fuzz -> mix"]
    fz = str(next(n for n, v in g.nodes.items() if v.cfg_name == "distort"))
    rng = np.random.default_rng(797)

    def grads(d, B, T, counted):
        cg = dst.compile_graph(g, device=d)
        x = torch.as_tensor(rng.standard_normal((B, 1, T), dtype=np.float32)
                            * np.float32(0.3), device=d).requires_grad_(True)
        w = torch.as_tensor(rng.standard_normal((B, 1, T), dtype=np.float32),
                            device=d)
        lv = torch.tensor(2.5, device=d, requires_grad=True)
        plain, vjps = {}, {}
        reset_launches()
        t0 = time.time()
        with (forward_and_vjps_counted(plain, vjps, first_order=False)
              if counted else contextlib.nullcontext()):
            y = cg.render(x, batch_shape=(B,), params={fz: {"level": lv}})[0]
            (y * w).sum().backward()
        if counted:
            torch.cuda.synchronize()
        return x.grad, lv.grad, read_launches(), plain, vjps, time.time() - t0

    rec = {}
    leaf = (lambda c: {fz: {"level": torch.tensor(2.5, requires_grad=True)}})
    n_fwd = cpu_group_calls(g, "fast", leaf)
    n_rev = len(cpu_group_backwards(g, "fast", leaf, True))
    with dst.policy("fast"):
        gx, gl, launches, plain, vjps, wall = grads(dev, B_FUZZ_TIMED,
                                                    T_MAIN, True)
        check(not vjps and not plain and launches == only_launches(
            pointwise=n_fwd, pointwise_reverse=n_rev) and n_rev >= 1,
              f"gain -> Fuzz -> mix gradient: launches {launches} (expected "
              f"{n_fwd} groups, {n_rev} reverse calls), plain versions "
              f"{plain}, {vjps}")
        check(bool(torch.isfinite(gx).all()) and bool(torch.isfinite(gl)),
              "gain -> Fuzz -> mix gradient not finite")
        print(f"main path (gain -> Fuzz -> mix gradient, the input and the "
              f"Fuzz level), [{B_FUZZ_TIMED}, {T_MAIN}]: forward + backward "
              f"{wall * 1e3:.1f} ms (first call), launches "
              f"{expect_str(launches)}, no plain version [{card}]")
        rec["launches"] = launches
        del gx, gl
        torch.cuda.empty_cache()
        seed = rng.bit_generator.state
        card_ = grads(dev, 2, SR, False)
        rng.bit_generator.state = seed
        cpu = grads("cpu", 2, SR, False)
    rec["cpu_err"] = max(grad_close(f"gain -> Fuzz -> mix gradient {i}, card "
                                    f"vs CPU", a, b2)
                         for i, (a, b2) in enumerate(zip(card_[:2], cpu[:2])))
    print(f"  gain -> Fuzz -> mix gradient [2, {SR}], card vs CPU port: "
          f"worst {rec['cpu_err']:.2e} (rtol {GRAD_RTOL})")
    return rec


def osc_stream_turns(dev, card) -> dict:
    """config5 streamed in 128-sample process() blocks with the LFO on the
    kernel route and on the eager route (its plain version), in turns
    kernel, eager, eager, kernel, under fast and parity: a replayed
    block's kernels from its DOT dump and the process() wall a block over
    N_PW_BLOCKS blocks (median, p99), the routes' blocks and state
    bitwise; and the per-node loop's kernels a block (a parity render at
    B_SHORT x 1 s, the loop's graph from its DOT dump) on both routes,
    which the LFO outside config5's cycle must not move."""
    import dsp_stuff_tpu_torch as dst
    from dsp_stuff_tpu_torch.models import presets
    g5 = presets.config5_feedback_16node()[0]
    x = (np.random.default_rng(141).standard_normal(N_PW_BLOCKS * 128)
         * 0.3).astype(np.float32)
    out = {}
    for pol in ("fast", "parity"):
        res = {}
        for route in ("kernel", "eager", "eager", "kernel"):
            with lfo_route(route), dst.policy(pol):
                sess = dst.StreamSession(g5, device="cuda")
                key = str(sess.cg.input_ids[0])
                ys, times = [], []
                for j in range(N_PW_BLOCKS):
                    t0 = time.perf_counter()
                    ys.append(sess.process({key: x[j * 128:(j + 1) * 128]})[0])
                    times.append(time.perf_counter() - t0)
                gn = graph_nodes(sess, f"config5 {pol} LFO {route} route")
            r = res.setdefault(route, {"times": []})
            r["times"] += times[1:]
            r["y"], r["state"], r["nodes"] = np.concatenate(ys), sess.state, gn
        check(np.array_equal(res["kernel"]["y"], res["eager"]["y"])
              and same_tree(res["kernel"]["state"], res["eager"]["state"]),
              f"config5 stream {pol}: the LFO's kernel route is not bitwise "
              f"its eager route")
        for route, r in res.items():
            ms = np.asarray(r["times"]) * 1e3
            r.update(median=float(np.median(ms)),
                     p99=float(np.percentile(ms, 99)),
                     kernels=r["nodes"]["kinds"].get("KERNEL", 0))
            print(f"  config5 stream, {pol}, the LFO's {route} route: a "
                  f"replayed block holds {r['kernels']} kernels (the port's "
                  f"{expect_str(r['nodes']['ours'])}); process() median "
                  f"{r['median']:.3f} ms, p99 {r['p99']:.3f} ms over "
                  f"{2 * (N_PW_BLOCKS - 1)} blocks in two turns [{card}]")
            del r["state"], r["y"]
        check(res["kernel"]["nodes"]["ours"].get("oscillator") == 1,
              f"config5 stream {pol}: the block holds "
              f"{res['kernel']['nodes']['ours']}, not one oscillator launch")
        out[pol] = res
    import torch
    xs = torch.as_tensor((np.random.default_rng(142).standard_normal(
        (B_SHORT, 1, SR)) * 0.3).astype(np.float32), device=dev)
    loop = {}
    for route in ("kernel", "eager"):
        with lfo_route(route), dst.policy("parity"):
            cg = dst.compile_graph(g5, device="cuda")
            cg.render(xs, batch_shape=(B_SHORT,))
            loop[route] = loop_graph_nodes(cg, f"config5 loop LFO {route}",
                                           None)
    check(loop["kernel"]["kinds"] == loop["eager"]["kinds"],
          f"config5's per-node loop: a body's nodes {loop['kernel']['kinds']} "
          f"on the kernel route, {loop['eager']['kinds']} on the eager")
    print(f"  config5's per-node loop under parity: a body's nodes "
          f"{loop['kernel']['kinds']} on both of the LFO's routes (the LFO "
          f"is outside the cycle) [{card}]")
    out["loop"] = loop
    return out


def main() -> int:
    import torch
    t_start = time.time()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import dsp_stuff_tpu_torch as dst
    from dsp_stuff_tpu_torch.models import presets
    from dsp_stuff_tpu_torch.ops import (chain_segment, cuda_build,
                                         cycle_kernel, cycle_reverse_kernel,
                                         cycle_segment, envelope,
                                         envelope_kernel)
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
    clock = PhaseClock()

    # -- 2. build: one nvcc per kernel source, and one per cycle program
    # (the cycle kernel, its record build for a program with a shaper and
    # its reverse are built for each block program), all started
    # together --------------------------------------------------------------
    t0 = time.time()
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    cycle_programs = {name: prog for name, prog, _, _, _ in cycle_cases(n_sm)}
    for name, g, _ in fuzz_graphs():
        for i, prog in enumerate(cycle_programs_of(g)):
            if prog not in cycle_programs.values():
                cycle_programs[f"fuzz {name} #{i}"] = prog
    for name, prog, _, _, _ in cycle_reverse_cases():
        if prog not in cycle_programs.values():
            cycle_programs[name] = prog
    budget = cycle_kernel.budget_of(dev)
    jobs = [(n, (), "") for n in cuda_build.STATIC_KERNELS]
    labels = list(cuda_build.STATIC_KERNELS)
    jobs.append(("pointwise_divide_check", (), ""))
    labels.append("pointwise_divide_check")
    jobs.append(("chain_kernel", ("CK_RECORD",), ""))
    labels.append("chain_kernel record build")
    for name, prog in cycle_programs.items():
        jobs.append(("cycle_kernel", (), cycle_kernel.source_for(prog,
                                                                 budget)))
        jobs.append(("cycle_reverse_kernel", (),
                     cycle_reverse_kernel.source_for(prog, budget)))
        labels += [f"cycle_kernel ({name})", f"cycle_reverse_kernel ({name})"]
        if cycle_kernel.has_shaper(prog):
            jobs.append(("cycle_kernel", ("CY_RECORD",),
                         cycle_kernel.source_for(prog, budget, record=True)))
            labels.append(f"cycle_kernel record build ({name})")
    # the pointwise kernel, once per group program the smoke launches, and
    # its reverse once per adjoint program
    for i, src in enumerate(pointwise_sources()):
        jobs.append(("pointwise_kernel", (), src))
        labels.append(f"pointwise_kernel (group program {i})")
    t_rev = time.time()
    for i, src in enumerate(pointwise_reverse_sources()):
        jobs.append(("pointwise_reverse_kernel", (), src))
        labels.append(f"pointwise_reverse_kernel (adjoint program {i})")
    print(f"the reverse pointwise kernel's adjoint programs collected in "
          f"{time.time() - t_rev:.1f} s")
    built = cuda_build.build_jobs(jobs)
    print(f"nvcc build of {len(built)} kernels: {time.time() - t0:.1f} s")
    for label, (lib, log) in zip(labels, built):
        print(f"  {label} -> {os.path.relpath(lib, ROOT)}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print("    ptxas:", line.strip())
        if label == "sequential_kernel":
            spills = [ln for ln in log.splitlines() if "spill" in ln]
            check(all(" 0 bytes spill stores, 0 bytes spill loads" in ln
                      for ln in spills),
                  f"the sequential kernel spills: {spills}")

    clock.lap("build")
    rng = np.random.default_rng(0)
    # the new kernels' checks draw from their own generator, so the bench
    # chain's phases see the same inputs as before they existed
    rng5 = np.random.default_rng(5)
    rec = {}
    with dst.policy("fast"):
        # -- 3. each kernel against its plain version on the card ---------
        print(f"chain kernel vs segment_fallback, B={B_CHECK}, T={T_CHECK}:")
        for name, stages in check_lists().items():
            x = torch.as_tensor((rng.standard_normal((B_CHECK, T_CHECK))
                                 * 0.3).astype(np.float32), device=dev)
            st = seeded_states(stages, B_CHECK, rng, dev, T=T_CHECK)
            k = kernel_segment(x, stages, st)
            p = chain_segment.segment_fallback(x, stages, st)
            torch.cuda.synchronize()
            compare(name, k, p)
        for name, (stages, lfos) in mtap_lists().items():
            x = torch.as_tensor((rng5.standard_normal((B_CHECK, T_CHECK))
                                 * 0.3).astype(np.float32), device=dev)
            st = seeded_states(stages, B_CHECK, rng5, dev, T=T_CHECK,
                               lfos=lfos)
            k = kernel_segment(x, stages, st)
            p = chain_segment.segment_fallback(x, stages, st)
            torch.cuda.synchronize()
            compare(name, k, p)

        # the tile walk: three tiles and a ragged one, at B_TILES rows (one
        # CTA an SM), then past one row an SM (the build for two)
        rng14 = np.random.default_rng(14)
        tile_lists = {name: (st_, ()) for name, st_ in check_lists().items()}
        tile_lists.update(mtap_lists())
        tile_lists["40 stages"] = (long_list(), ())
        print(f"chain kernel vs segment_fallback, B={B_TILES}, "
              f"T={T_TILES} (4 tiles, the last ragged):")
        runs = [(name, stages, lfos, B_TILES)
                for name, (stages, lfos) in tile_lists.items()]
        runs += [(f"{name} B={n_sm + 1}", *tile_lists[name], n_sm + 1)
                 for name in ("bench", "mtap config5")]
        for name, stages, lfos, b in runs:
            x = torch.as_tensor((rng14.standard_normal((b, T_TILES))
                                 * 0.3).astype(np.float32), device=dev)
            st = seeded_states(stages, b, rng14, dev, T=T_TILES, lfos=lfos)
            k = kernel_segment(x, stages, st)
            p = chain_segment.segment_fallback(x, stages, st)
            torch.cuda.synchronize()
            compare(name, k, p)

        print("cycle kernel vs cycle_segment.interpret:")
        programs = {"config5": cycle_program(
                        presets.config5_feedback_16node()[0]),
                    "loop graph": cycle_program(loop_graph())}
        # config5's ring wrapped three times, past one row an SM, a ring in
        # device memory, the loop graph and 56 instructions (each case from
        # its own generator: the later phases' inputs stay as they were)
        for i, (name, program, n_taps, b, t) in enumerate(cycle_cases(n_sm)):
            ins = cycle_inputs(program, b, t, np.random.default_rng(15 + i),
                               dev)
            k = cycle_kernel_run(*ins, program, n_taps)
            p = cycle_segment.interpret(*ins, program, n_taps)
            torch.cuda.synchronize()
            compare_cycle(f"{name} B={b} T={t}", k, p)
        del k, p, ins

        atk = envelope.gain_from_frames(50.0)
        rel = envelope.gain_from_frames(400.0)
        print("envelope kernel vs plain:")
        xe = torch.as_tensor((rng5.standard_normal((B_CHECK, T_CHECK))
                              * 0.5).astype(np.float32), device=dev)
        e0 = torch.as_tensor(rng5.random(B_CHECK).astype(np.float32),
                             device=dev)
        gains = env_gains(atk, rel, dev)
        seq_k = envelope_kernel.peak_envelope_cuda(xe, gains, e0,
                                                   chunk=T_CHECK)
        seq_p = envelope._seq_scan(xe, atk, rel, e0)
        torch.cuda.synchronize()
        compare_env(f"sequential B={B_CHECK} T={T_CHECK}", seq_k, seq_p)
        # the chunked form at small chunks on a ragged T, at B = 1 with x's
        # start not 16-byte aligned, and NaN in x
        rng16 = np.random.default_rng(16)
        for b, t, chunk in ((1, 5 * 1000 + 77, 1000), (B_CHECK, 3 * 4096 + 5,
                                                        4096)):
            flat = torch.as_tensor((rng16.standard_normal(b * t + 1) * 0.5)
                                   .astype(np.float32), device=dev)
            xu = flat[1:].view(b, t)                   # unaligned start
            xu[0, t // 3] = float("nan")
            eu = torch.as_tensor(rng16.random(b).astype(np.float32),
                                 device=dev)
            ck = envelope_kernel.peak_envelope_cuda(xu, gains, eu,
                                                    chunk=chunk)
            cp = envelope._chunked_batched(xu, atk, rel, eu, chunk)
            torch.cuda.synchronize()
            check(torch.equal(torch.isnan(ck[0]), torch.isnan(cp[0])),
                  f"chunked B={b} T={t}: NaN positions differ")
            compare_env(f"chunked B={b} T={t} chunk={chunk}",
                        tuple(torch.nan_to_num(v) for v in ck),
                        tuple(torch.nan_to_num(v) for v in cp))
        xc = torch.as_tensor((rng5.standard_normal((B_C5, T_MAIN)) * 0.5)
                             .astype(np.float32), device=dev)
        ec0 = torch.as_tensor(rng5.random(B_C5).astype(np.float32),
                              device=dev)
        ch_k = envelope_kernel.peak_envelope_cuda(xc, gains, ec0,
                                                  chunk=envelope._CHUNK)
        ch_p = envelope._chunked_batched(xc, atk, rel, ec0, envelope._CHUNK)
        torch.cuda.synchronize()
        rec["chunk_err"] = compare_env(f"chunked B={B_C5} T={T_MAIN}",
                                       ch_k, ch_p)
        del ch_k, ch_p, seq_k, seq_p

        print(f"first-order kernel vs plain f32 vs float64, B={B_C5}, "
              f"T={T_MAIN}:")
        errs = {form: max(fo_check(a, form, B_C5, T_MAIN, 100 + i, dev)[0]
                          for i, a in enumerate(FO_COEFFS))
                for form in FO_FORMS}
        rec["fo_err"] = max(errs["forward"], errs["reverse"])
        rec["fo_err_ps"] = max(errs["per-sample forward"],
                               errs["per-sample reverse"])
        print("first-order kernel at edge shapes:")
        fo_edges(dev)
        print(f"first-order kernel, {N_DETERMINISM} launches:")
        fo_determinism(dev)
        rec["fo_grad_err"] = max(fo_function_check(a, B_C5, T_MAIN, 200 + i,
                                                   dev)
                                 for i, a in enumerate(FO_COEFFS))
        torch.cuda.empty_cache()

        # -- 4. the bench chain's main path -------------------------------
        g = bench_graph()
        cg = dst.compile_graph(g, device="cuda")
        x_np = (rng.standard_normal((B_MAIN, 1, T_MAIN), dtype=np.float32)
                * np.float32(0.25))
        x = torch.as_tensor(x_np, device=dev)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.time()
        outs, _aux, _state = cg.render(x, batch_shape=(B_MAIN,))
        torch.cuda.synchronize()
        wall = time.time() - t0
        bench_launches = read_launches()
        print(f"main path (bench chain): render [{B_MAIN}, 1, {T_MAIN}] in "
              f"{wall:.3f} s (first call), launches {bench_launches}")
        check(bench_launches == only_launches(chain=1),
              f"bench chain launched {bench_launches}, expected one chain "
              f"kernel launch")
        check(_kernel_modules()["chain"].RECORD_LAUNCHES == 0,
              "a render without grad launched the chain kernel's record "
              "build")
        check(tuple(outs.shape) == (B_MAIN, 1, T_MAIN),
              f"output shape {tuple(outs.shape)}")
        check(bool(torch.isfinite(outs).all()), "main path output not finite")
        ref = oracle_chain(x_np[0, 0, :SR])
        d = dbfs(host(outs[0, 0, :SR]), ref)
        print(f"  stream 0, first second vs bench.oracle_chain: {d:.1f} dBFS")
        check(d <= ORACLE_FAST_DB, f"main path vs oracle {d:.1f} dBFS")
        del outs, _state

        # -- 5. state handoff ---------------------------------------------
        handoff(cg, x[:B_CHECK], "bench chain")

    clock.lap("kernels vs plain, the bench chain's main path")
    # -- 6. parity on the card ----------------------------------------------
    parity(g, x_np[:4, :, :SR], oracle_chain, "bench chain")

    # -- 7. times of the chain kernel (bench stage list) ----------------------
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
        render_ms = cuda_ms(lambda: cg.render(x, batch_shape=(B_MAIN,)))
        del x, xs, st
        # the bench list at each timed B, kernel and plain version in turns
        # (their own generator: the later phases' inputs stay as they were)
        rng7 = np.random.default_rng(7)
        chain_times = {}
        for b in B_TIMED:
            xb = torch.as_tensor((rng7.standard_normal((b, T_MAIN),
                                                       dtype=np.float32)
                                  * np.float32(0.25)), device=dev)
            stb = seeded_states(stages, b, rng7, dev)
            chain_times[b] = in_turns(
                lambda: kernel_segment(xb, stages, stb),
                lambda: chain_segment.segment_fallback(xb, stages, stb))
            del xb, stb
        bench_lib_ms = matmul_ms(stages[0][1], B_MAIN, T_MAIN, dev)
    for b, (tk, tp) in chain_times.items():
        bms, bby = chain_bound(stages, b, T_MAIN)
        print(f"chain kernel, bench list, B={b} x 10 s: kernel {tk:.3f} ms "
              f"({b * T_MAIN / SR / (tk / 1e3):,.0f} audio-s/s), plain "
              f"{tp:.3f} ms, bound {bms:.3f} ms by {bby} "
              f"({bms / tk:.1%} of it) [{card}]")
    check(chain_times[B_MAIN][0] < chain_times[B_MAIN][1],
          f"the chain kernel is not faster than segment_fallback at "
          f"B={B_MAIN}: {chain_times[B_MAIN]}")
    ms, plain_ms = chain_times[B_MAIN]
    print(f"one cascade's product as one torch.matmul, [{B_MAIN} x "
          f"{T_MAIN // 128}, 128] x [128, 136]: {bench_lib_ms:.3f} ms [{card}]")
    print(f"whole render (kernel path): {render_ms:.3f} ms median of "
          f"{N_TIMED} = {B_MAIN * T_MAIN / SR / (render_ms / 1e3):,.0f} "
          f"audio-s/s at B={B_MAIN} x 10 s [{card}]")

    clock.lap("bench chain parity, chain kernel times")
    # -- 8. config5's main path ---------------------------------------------
    g5, meta5 = presets.config5_feedback_16node()
    x5_np = (rng5.standard_normal((B_C5, 1, T_MAIN), dtype=np.float32)
             * np.float32(0.3))
    x5 = torch.as_tensor(x5_np, device=dev)
    with dst.policy("fast"):
        cg5 = dst.compile_graph(g5, device="cuda")
        torch.cuda.synchronize()
        plain = {}
        reset_launches()
        t0 = time.time()
        with plain_versions_counted(plain):
            y5, aux5, _ = cg5.render(x5, batch_shape=(B_C5,))
            torch.cuda.synchronize()
        wall = time.time() - t0
        c5_launches = read_launches()
        print(f"main path (config5): render [{B_C5}, 1, {T_MAIN}] in "
              f"{wall:.3f} s (first call), launches {c5_launches}, plain "
              f"versions called {plain}")
        check(not plain, f"config5's main path called plain versions "
                         f"{plain}")
        check(c5_launches == only_launches(chain=1, cycle=1, envelope=1,
                                           pointwise=3, oscillator=2),
              f"config5 launched {c5_launches}, expected one chain (mtap), "
              f"one cycle, one (chunked) envelope launch, three "
              f"pointwise groups (pre -> overdrive -> distort, the mix, "
              f"the Output's fan-in) and the LFO's two oscillator passes")
        check(tuple(y5.shape) == (B_C5, 1, T_MAIN),
              f"config5 output shape {tuple(y5.shape)}")
        check(bool(torch.isfinite(y5).all()), "config5 output not finite")
        cols = aux5[f"spectrogram:{meta5['spectrogram']}"]["columns"]
        check(tuple(cols.shape[:2]) == (B_C5, 250)
              and bool(torch.isfinite(cols).all()),
              f"config5 spectrogram columns {tuple(cols.shape)}")
        d = dbfs(host(y5[0, 0, :SR]), oracle_config5(x5_np[0, 0, :SR]))
        print(f"  stream 0, first second vs the composed oracle: "
              f"{d:.1f} dBFS")
        check(d <= ORACLE_FAST_DB, f"config5 vs oracle {d:.1f} dBFS")
        del y5, aux5, cols

        # -- 9. config5 state handoff -------------------------------------
        handoff(cg5, x5[:B_CHECK], "config5")

    clock.lap("config5's main path")
    # -- 10. config5 parity (the sequential envelope kernel's path) -----------
    # its cycle's scan as the Python loop, whose group launches the host
    # counts (the replayed loop: cycle_loop_phase)
    par_launches = parity(g5, x5_np[:4, :, :SR], oracle_config5, "config5",
                          route="eager")
    n_par = group_launches(g5, "parity", SR)
    check(par_launches == only_launches(envelope=1, pointwise=n_par,
                                        oscillator=osc_launches(g5, SR)),
          f"config5 parity launched {par_launches}, expected one "
          f"sequential envelope launch, {n_par} pointwise (three groups "
          f"and the feedback cycle's two once a block) and the LFO's two "
          f"oscillator passes")
    # the sequential kernel against _seq_scan at the shape that path gives
    # it (its own generator: the later phases' inputs stay as they were)
    rng10 = np.random.default_rng(10)
    xs_env = torch.as_tensor((rng10.standard_normal((4, SR)) * 0.5)
                             .astype(np.float32), device=dev)
    es0 = torch.as_tensor(rng10.random(4).astype(np.float32), device=dev)
    seq_k = envelope_kernel.peak_envelope_cuda(xs_env, gains, es0,
                                               chunk=SR)
    seq_p = envelope._seq_scan(xs_env, atk, rel, es0)
    torch.cuda.synchronize()
    rec["seq_err"] = compare_env(f"sequential B=4 T={SR}", seq_k, seq_p)
    del seq_k, seq_p

    clock.lap("config5 parity")
    # -- 11. times: each kernel against its plain version, and config5 --------
    with dst.policy("fast"):
        times = {}                 # (kernel ms, plain ms) by kernel
        stages5, lfos5 = planned_stages(g5)
        x5r = x5.reshape(B_C5, T_MAIN)
        st5 = seeded_states(stages5, B_C5, rng5, dev, T=T_MAIN, lfos=lfos5)
        k = kernel_segment(x5r, stages5, st5)
        p = chain_segment.segment_fallback(x5r, stages5, st5)
        torch.cuda.synchronize()
        print(f"kernel vs segment_fallback, B={B_C5}, T={T_MAIN}:")
        _, mtap_err = compare("mtap config5 (main-path shape)", k, p)
        del k, p
        times["chain_mtap"] = in_turns(
            lambda: kernel_segment(x5r, stages5, st5),
            lambda: chain_segment.segment_fallback(x5r, stages5, st5))
        check(times["chain_mtap"][0] < times["chain_mtap"][1],
              f"the chain kernel is not faster than segment_fallback on "
              f"config5's list at B={B_C5}: {times['chain_mtap']}")
        mtap_lib_ms = matmul_ms(stages5[0][1], B_C5, T_MAIN, dev)
        program, n_taps = programs["config5"]
        ins = cycle_inputs(program, B_C5, T_MAIN, rng5, dev)
        k = cycle_kernel_run(*ins, program, n_taps)
        p = cycle_segment.interpret(*ins, program, n_taps)
        torch.cuda.synchronize()
        print(f"cycle kernel vs interpret, B={B_C5}, T={T_MAIN}:")
        cycle_err = compare_cycle("config5 (main-path shape)", k, p)
        del k, p
        times["cycle"] = (
            cuda_ms(lambda: cycle_kernel_run(*ins, program, n_taps)),
            cuda_ms(lambda: cycle_segment.interpret(*ins, program, n_taps),
                    N_TIMED_SLOW))
        del ins
        times["env_chunk"] = (
            cuda_ms(lambda: envelope_kernel.peak_envelope_cuda(
                xc, gains, ec0, chunk=envelope._CHUNK)),
            cuda_ms(lambda: envelope._chunked_batched(
                xc, atk, rel, ec0, envelope._CHUNK), N_TIMED_SLOW))
        times["env_seq"] = (
            cuda_ms(lambda: envelope_kernel.peak_envelope_cuda(
                xs_env, gains, es0, chunk=SR)),
            cuda_ms(lambda: envelope._seq_scan(xs_env, atk, rel, es0),
                    N_TIMED_SLOW))
        del xc, xs_env
        render5_ms = cuda_ms(lambda: cg5.render(x5, batch_shape=(B_C5,)))
        del x5r, st5
        x5w = torch.as_tensor(
            (rng5.standard_normal((B_C5_WIDE, 1, T_MAIN), dtype=np.float32)
             * np.float32(0.3)), device=dev)
        render5w_ms = cuda_ms(lambda: cg5.render(x5w,
                                                 batch_shape=(B_C5_WIDE,)))
        del x5w
    for what, (tk, tp), shape in (
            ("chain segment with mtap (config5)", times["chain_mtap"],
             f"B={B_C5} x 10 s"),
            ("cycle kernel (config5 program)", times["cycle"],
             f"B={B_C5} x 10 s"),
            ("envelope, chunked", times["env_chunk"], f"B={B_C5} x 10 s"),
            ("envelope, sequential", times["env_seq"], "B=4 x 1 s")):
        print(f"{what}: kernel {tk:.3f} ms, plain {tp:.3f} ms at {shape} "
              f"[{card}]")
    bms, bby = chain_bound(stages5, B_C5, T_MAIN)
    print(f"chain kernel, config5's list: bound {bms:.3f} ms by {bby} "
          f"({bms / times['chain_mtap'][0]:.1%} of it); its cascade's product "
          f"as one torch.matmul {mtap_lib_ms:.3f} ms [{card}]")
    for b_, t in ((B_C5, render5_ms), (B_C5_WIDE, render5w_ms)):
        print(f"config5 whole render: {t:.3f} ms median of {N_TIMED} = "
              f"{b_ * T_MAIN / SR / (t / 1e3):,.0f} audio-s/s at B={b_} x "
              f"10 s [{card}]")

    del x5
    torch.cuda.empty_cache()
    clock.lap("kernel times, config5 renders")
    # -- 11b. the pointwise groups ------------------------------------------
    pw = pointwise_phase(dev, card)
    clock.lap("pointwise")
    torch.cuda.empty_cache()
    # -- 11c. the signal generator's oscillator kernel, Fuzz in the groups
    osc = oscillator_phase(dev, card)
    clock.lap("oscillator")
    torch.cuda.empty_cache()
    orv = oscillator_reverse_phase(dev, card)
    clock.lap("reverse oscillator")
    torch.cuda.empty_cache()
    fzg = fuzz_group_phase(dev, card)
    clock.lap("Fuzz groups")
    torch.cuda.empty_cache()
    print("config5 streamed with the LFO on the kernel and the eager route:")
    ost = osc_stream_turns(dev, card)
    clock.lap("LFO stream turns")
    torch.cuda.empty_cache()
    fit_rec = fit_phase(dev, card)
    clock.lap("fit")
    torch.cuda.empty_cache()

    # -- 14. config3 and config4 at full width, muff, mux / demux ------------
    config3_phase(dev, card)
    clock.lap("config3")
    torch.cuda.empty_cache()
    config4_phase(dev, card)
    clock.lap("config4")
    torch.cuda.empty_cache()
    muff_phase(dev, card)
    config2_phase(dev, card)
    mux_demux_phase()
    clock.lap("muff, config2, mux / demux")

    # -- 15. the graph fuzz on the card -------------------------------------
    print(f"fuzz graphs on the card vs the CPU port, fast, B={B_FUZZ} x 1 s:")
    fuzz_phase(dev, card)
    clock.lap("fuzz")

    # -- 16. the runtime on the card ----------------------------------------
    torch.cuda.empty_cache()
    rt = runtime_phase(dev, card)
    clock.lap("runtime")
    examples_phase(card)
    clock.lap("examples")

    # -- 17. the exact policy on the card -----------------------------------
    torch.cuda.empty_cache()
    ex = exact_phase(dev, card)
    clock.lap("exact")

    # -- 18. gradients on the card ------------------------------------------
    torch.cuda.empty_cache()
    gr = grad_phase(dev, card)
    clock.lap("gradients")
    torch.cuda.empty_cache()
    crv = chain_reverse_phase(dev, card)
    clock.lap("chain reverse")
    torch.cuda.empty_cache()
    rv = cycle_reverse_phase(dev, card)
    clock.lap("cycle reverse")
    torch.cuda.empty_cache()
    cl = cycle_loop_phase(dev, card)
    clock.lap("cycle loop")
    torch.cuda.empty_cache()
    clg = cycle_loop_grad_phase(dev, card)
    clock.lap("cycle loop backward")

    def stream_us(rec, key, bnd):
        """The kernel's device time in one replayed stream block, with its
        bound at [1, 128] (every launch of it in the block)."""
        return {"stream_block_us": rec["kernel_us"].get(key),
                "stream_block_launches": rec["kernel_n"].get(key),
                "stream_bound_us": bnd[0] * 1e3, "stream_bound_by": bnd[1]}

    def entry(name, source, replaces, launches, err, t, bnd, lib_ms=None,
              **extra):
        return {"name": name, "route": "cuda",
                "source": f"dsp_stuff_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": t[0], "plain_ms": t[1],
                "bound_ms": bnd[0], "bound_by": bnd[1],
                "bound_share": bnd[0] / t[0], "library_ms": lib_ms, **extra}

    def seq_entry(mode, replaces, rec=ex, launches=ex["launches"],
                  shape=(B_MAIN, T_MAIN), **extra):
        m = rec[mode]
        if "plain_shape" in m:
            extra["plain_shape"] = m["plain_shape"]
        return entry(f"sequential_kernel:{mode}", "sequential_kernel.cu",
                     replaces, launches[mode], rec[f"{mode}:err"],
                     (m["ms"], m["plain_ms"]), m["bound"],
                     floor_ms=m["floor"], shape=list(shape), **extra)

    program5 = programs["config5"][0]
    osc_t, orv_t = osc["times"], orv["times"]
    fzr = fzg["reverse"]["times"]
    pw5, pw5w, pw3 = (pw[(name, b)] for name, b in (
        ("config5", B_C5), ("config5", B_PW_WIDE), ("config3", B_C3)))
    # the reverse kernel: config5's first group (pre -> overdrive ->
    # distort) at B_C5 x 10 s, the input gradient's program (need 1)
    rev5 = [r for r in pw5["reverse"] if sum(r[0]) == 1]
    rev5_all = [r for r in pw5["reverse"] if sum(r[0]) > 1]
    print("phase seconds: " + json.dumps(
        {k: round(v, 1) for k, v in clock.seconds.items()}))
    print(f"chip_smoke total: {time.time() - t_start:.1f} s [{card}]")
    print(json.dumps({"kernels": [
        entry("chain_kernel", "chain_kernel.cu",
              "dsp_stuff_tpu/ops/pallas_chain.py:459",
              bench_launches["chain"], abs_err, (ms, plain_ms),
              chain_bound(bench_stages(), B_MAIN, T_MAIN), bench_lib_ms,
              **stream_us(rt["bench chain"], "chain",
                          chain_bound(bench_stages(), 1, 128))),
        entry("chain_kernel:mtap", "chain_kernel.cu",
              "dsp_stuff_tpu/ops/pallas_chain.py:459",
              c5_launches["chain"], mtap_err, times["chain_mtap"],
              chain_bound(stages5, B_C5, T_MAIN), mtap_lib_ms,
              **stream_us(rt["config5"], "chain",
                          chain_bound(stages5, 1, 128))),
        entry("pointwise_kernel", "pointwise_kernel.cu",
              "dsp_stuff_tpu/compiler/compile.py:230",
              c5_launches["pointwise"], pw5["times"][0][4],
              pw5["times"][0][:2], pw5["times"][0][2],
              group="pre -> overdrive -> distort (config5)",
              shape=[B_C5, T_MAIN], copy_ms=pw5["times"][0][3],
              device_ms=pw5["times"][0][5],
              ms_wide=pw5w["times"][0][0], plain_ms_wide=pw5w["times"][0][1],
              bound_ms_wide=pw5w["times"][0][2][0],
              shape_wide=[B_PW_WIDE, T_MAIN],
              groups_config5=[(*t[:2], t[5]) for t in pw5["times"]],
              groups_config3=[(*t[:2], t[5]) for t in pw3["times"]],
              launches_config3=pw3["launches"],
              render_ms_config5=pw5["render"],
              render_ms_config3=pw3["render"],
              render_device_ms_config5={
                  b: {r: [t[0] for t in ts] for r, ts in rec["fanins"].items()}
                  for b, rec in ((B_C5, pw5), (B_PW_WIDE, pw5w))},
              stream_block_kernels={r: v["kernels"] for r, v
                                    in pw["stream"].items()},
              stream_block_ms={r: (v["median"], v["p99"]) for r, v
                               in pw["stream"].items()},
              loop_launches={p: cl[p]["inside"].get("pointwise", 0)
                             for p in ("parity", "exact", "fast-override")},
              loop_block_us={p: cl[p]["groups"]["kernel_us"].get("pointwise")
                             for p in ("parity", "exact", "fast-override")},
              loop_bound_us=cl["parity"]["groups"]["bound_us"],
              loop_bound_us_one_row=cl["parity"]["groups"]["bound_us"]
              / B_LOOP, loop_shape=[B_LOOP, 128],
              stream_parity_block_us=rt["config5 parity"]["kernel_us"].get(
                  "pointwise"),
              stream_parity_block_launches=rt["config5 parity"][
                  "kernel_n"].get("pointwise"),
              fuzz_group_ms=fzg["times"][0],
              fuzz_group_plain_ms=fzg["times"][1],
              fuzz_group_bound_ms=fzg["times"][2][0],
              fuzz_group_device_ms=fzg["times"][5],
              fuzz_group_shape=[B_FUZZ_TIMED, T_MAIN],
              fuzz_grad_err=fzg["grad_err"],
              fuzz_graph_grad_launches=fzg["graph_grad"]["launches"]),
        entry("oscillator_kernel", "oscillator_kernel.cu",
              "dsp_stuff_tpu/ops/gen.py:97", c5_launches["oscillator"],
              osc["err"], (osc_t[("fast", T_MAIN)]["ms"],
                           osc_t[("fast", T_MAIN)]["plain_ms"]),
              osc_t[("fast", T_MAIN)]["bound"],
              floor_ms=osc_t[("fast", T_MAIN)]["floor"],
              device_ms=osc_t[("fast", T_MAIN)]["device_ms"],
              shape=[1, T_MAIN],
              ms_parity=osc_t[("parity", T_MAIN)]["ms"],
              plain_ms_parity=osc_t[("parity", T_MAIN)]["plain_ms"],
              floor_ms_parity=osc_t[("parity", T_MAIN)]["floor"],
              device_ms_parity=osc_t[("parity", T_MAIN)]["device_ms"],
              ms_one_block={p: osc_t[(p, 128)]["ms"]
                            for p in ("fast", "parity")},
              plain_ms_one_block={p: osc_t[(p, 128)]["plain_ms"]
                                  for p in ("fast", "parity")},
              checks_bitwise=[osc["bitwise"], osc["cases"]],
              clocks_differ=[osc["clocks_differ"], osc["clocks"]],
              **stream_us(rt["config5"], "oscillator", osc_bound(1, 128)),
              stream_parity_block_us=rt["config5 parity"]["kernel_us"].get(
                  "oscillator"),
              stream_block_kernels={p: {r: v["kernels"] for r, v
                                        in ost[p].items()}
                                    for p in ("fast", "parity")},
              stream_block_ms={p: {r: (v["median"], v["p99"]) for r, v
                                   in ost[p].items()}
                               for p in ("fast", "parity")}),
        entry("pointwise_reverse_kernel", "pointwise_reverse_kernel.cu",
              "dsp_stuff_tpu/compiler/compile.py:230",
              gr["c5_input"]["bwd"]["pointwise_reverse"],
              max(r[1] for r in rev5), rev5[0][3:5], rev5[0][5],
              group="pre -> overdrive -> distort (config5), the input's "
                    "gradient", shape=[B_C5, T_MAIN], device_ms=rev5[0][6],
              groups_config5=[(*r[3:5], r[6]) for r in rev5],
              bound_ms_groups=[r[5][0] for r in rev5],
              device_ms_by_pass=rev5[0][7],
              ms_every_gradient=rev5_all[0][3],
              plain_ms_every_gradient=rev5_all[0][4],
              bound_ms_every_gradient=rev5_all[0][5][0],
              device_ms_every_gradient_by_pass=rev5_all[0][7],
              divide_check=pw["divide"],
              launches_fit_step=fit_rec["reverse_launches"],
              config5_input_grad_device_ms=gr["c5_split"]["device_ms"],
              config5_input_grad_elementwise_ms=gr["c5_split"]["split"].get(
                  "elementwise"),
              config5_input_grad_peak_gib=gr["c5_split"]["peak"],
              loop_reverse_launches=clg["fit"]["reverse"].get(
                  "pointwise_reverse", 0) * clg["fit"]["blocks"],
              loop_reverse_block_us=clg["fit"]["kernel_us"].get(
                  "pointwise_reverse"),
              loop_reverse_sums_us=clg["fit"]["kernel_us"].get(
                  "pointwise_reverse:sums"),
              loop_reverse_bound_us=clg["fit"]["bound_us"],
              loop_shape=[B_LOOP, 128],
              fuzz_reverse_ms=fzr[3], fuzz_reverse_plain_ms=fzr[4],
              fuzz_reverse_bound_ms=fzr[5][0],
              fuzz_reverse_bound_by=fzr[5][1],
              fuzz_reverse_device_ms=fzr[6],
              fuzz_reverse_shape=[B_FUZZ_TIMED, T_MAIN],
              fuzz_reverse_checks=[fzg["reverse"][k] for k in (
                  "plain_bitwise", "vjp_bitwise", "cases")]),
        entry("oscillator_reverse_kernel", "oscillator_reverse_kernel.cu",
              "dsp_stuff_tpu/ops/gen.py:97", clg["fit"]["osc_reverse"],
              orv["err"],
              (orv_t["fast"]["ms"], orv_t["fast"]["plain_ms"]),
              orv_t["fast"]["bound"], floor_ms=orv_t["fast"]["floor"],
              device_ms=orv_t["fast"]["device_ms"],
              device_ms_by_pass=orv_t["fast"]["by_pass"],
              shape=[1, T_MAIN], ms_parity=orv_t["parity"]["ms"],
              plain_ms_parity=orv_t["parity"]["plain_ms"],
              floor_ms_parity=orv_t["parity"]["floor"],
              device_ms_parity=orv_t["parity"]["device_ms"],
              device_ms_by_pass_parity=orv_t["parity"]["by_pass"],
              checks_bitwise=[orv["bitwise"], orv["cases"]],
              launches_every_slider_card_vs_cpu=gr["c5_every"][
                  "oscillator_reverse"]),
        entry("cycle_kernel", "cycle_kernel.cu",
              "dsp_stuff_tpu/ops/pallas_cycle.py:220",
              c5_launches["cycle"], cycle_err, times["cycle"],
              cycle_bound(program5, B_C5, T_MAIN),
              **stream_us(rt["config5"], "cycle",
                          cycle_bound(program5, 1, 128))),
        entry("chain_reverse_kernel", "chain_reverse_kernel.cu",
              "dsp_stuff_tpu/ops/chain_segment.py:246",
              gr["bench_input"]["bwd"]["chain_reverse"], crv["err"],
              (crv["ms"], crv["plain_ms"]), crv["bound"], crv["lib_ms"],
              device_ms=crv["device_ms"], vjp_ms=crv["vjp_ms"],
              shape=[B_GRAD, T_MAIN], ms_wide=crv["ms_wide"],
              device_ms_wide=crv["device_ms_wide"],
              bound_ms_wide=crv["bound_wide"][0], shape_wide=[B_MAIN, T_MAIN],
              launches_config5=gr["c5_input"]["bwd"]["chain_reverse"]),
        entry("cycle_kernel:reverse", "cycle_reverse_kernel.cu",
              "dsp_stuff_tpu/ops/cycle_segment.py:270",
              gr["c5_input"]["bwd"]["cycle_reverse"], rv["err"],
              (rv["ms"], rv["plain_ms"]), rv["bound"], floor_ms=rv["floor"],
              device_ms=rv["device_ms"], shape=[B_C5, T_MAIN]),
        entry("envelope_kernel:chunked", "envelope_kernel.cu",
              "dsp_stuff_tpu/ops/pallas_envelope.py:203",
              c5_launches["envelope"], rec["chunk_err"], times["env_chunk"],
              bound(8.0 * B_C5 * T_MAIN, 3.0 * B_C5 * T_MAIN)),
        entry("envelope_kernel:sequential", "envelope_kernel.cu",
              "dsp_stuff_tpu/ops/pallas_envelope.py:65",
              par_launches["envelope"], rec["seq_err"], times["env_seq"],
              bound(8.0 * 4 * SR, 3.0 * 4 * SR),
              **stream_us(rt["config5"], "envelope",
                          bound(8.0 * 128, 3.0 * 128))),
        entry("first_order_kernel", "first_order_kernel.cu",
              "dsp_stuff_tpu/ops/pallas_scan.py:102",
              fit_rec["launches"], rec["fo_err"], fit_rec["fo_times"],
              bound(8.0 * B_FIT * T_MAIN, 2.0 * B_FIT * T_MAIN),
              **stream_us(rt["muff"], "first_order",
                          bound(8.0 * 128, 2.0 * 128)),
              loop_launches=cl["fast-override"]["inside"].get("first_order",
                                                               0),
              loop_reverse_launches=clg["fit"]["reverse"].get(
                  "first_order:reverse", 0) * clg["fit"]["blocks"]),
        entry("first_order_kernel:per-sample", "first_order_kernel.cu",
              "dsp_stuff_tpu/ops/pallas_scan.py:102",
              fit_rec["launches_ps"], rec["fo_err_ps"], fit_rec["fo_times_ps"],
              bound(12.0 * B_FIT * T_MAIN, 2.0 * B_FIT * T_MAIN)),
        seq_entry("first_order", "dsp_stuff_tpu/ops/scan.py:299",
                  **stream_us(ex["stream"], "sequential<0>",
                              exact_block_bounds()["sequential<0>"]),
                  loop_launches=cl["exact"]["inside"].get("sequential<0>",
                                                          0)),
        seq_entry("biquad", "dsp_stuff_tpu/ops/scan.py:745",
                  **stream_us(ex["stream"], "sequential<2>",
                              exact_block_bounds()["sequential<2>"])),
        seq_entry("first_order_reverse", "dsp_stuff_tpu/ops/scan.py:299",
                  gr, gr["rev_launches"], (B_EXACT, SR),
                  loop_reverse_launches=clg["exact"]["reverse"].get(
                      "sequential:reverse", 0) * clg["exact"]["blocks"]),
        seq_entry("first_order_reverse_per_sample",
                  "dsp_stuff_tpu/ops/scan.py:299", gr, gr["rev_launches"],
                  (B_EXACT, SR)),
        seq_entry("biquad_reverse", "dsp_stuff_tpu/ops/scan.py:745", gr,
                  gr["rev_launches"], (B_EXACT, SR)),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
