"""Wrapper of the reverse cycle kernel (csrc/cycle_reverse_kernel.cu):
generate, pack, build, bind, launch.

The kernel is the vjp of a feedback SCC's block program
(ops/cycle_segment.py): the counterpart of the reverse scan that XLA
compiles for the JAX package's ``_cycle_vjp``
(dsp_stuff_tpu/ops/cycle_segment.py:270, the vjp of its interpret).  As
the forward (ops/cycle_kernel.py), it is built once per program:
``reverse_source`` writes the program's block adjoint as straight-line
CUDA, the program's instructions in reverse order, one statement each,
with every constant a literal, and ops/cuda_build.py builds
csrc/cycle_reverse_kernel.cu with it at first use, bound with ``ctypes``.
Nothing is imported, built or loaded when this module is imported.

It reads the forward's packed cascade constants
(``cycle_kernel.cycle_casc_consts``) and lays out its shared memory with
the forward's ``smem_plan``: its staged streams are the taps' cotangents
and the shapers' inputs that the forward's record build writes, its rows
the flow's adjoint, its carries and rings the carry adjoints and the
combs' future adjoints.

``cycle_reverse_call`` takes only CUDA tensors and raises on anything the
kernel cannot take; there is no fallback.  Its plain PyTorch version is
ops/cycle_segment.interpret_adjoint.  ``LAUNCHES`` counts the kernel's
launches.  ``phase_cycles`` runs the build with the kernel's phase probes
(tools/measure_torch_cycle.py --phases).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from dsp_stuff_tpu_torch.ops import cuda_build, cycle_kernel
from dsp_stuff_tpu_torch.ops.chain_kernel import (C, EW_CODES, NS,
                                                  _casc_consts, to_device)
from dsp_stuff_tpu_torch.ops.cycle_segment import _tanh20

#: launches of the kernel in this process (a test or a smoke run resets it)
LAUNCHES = 0
#: shared memory an SM holds on the card the kernels are built for (sm_90a,
#: 228 KiB), and what a CTA takes beside its dynamic shared memory (the
#: 1 KiB the system reserves, the kernel's static arrays)
SM_SMEM, CTA_SMEM = 233_472, 1024 + 64
#: the most CTAs an SM the kernel's launch bound asks room for: four cap a
#: thread at 128 registers, one wave at 512 rows on 132 SMs
MAX_CTAS = 4
#: the probes' CR_PH_* order in csrc/cycle_reverse_kernel.cu
PHASES = ("stage", "join", "product", "carry", "comb", "ew", "feeds",
          "barrier", "block loop")

# The packed tables' records, mirrored field for field by
# csrc/cycle_reverse_kernel.cu (CrHeader, CrCasc, CrComb).
HEADER = np.dtype(
    [(f"off_{f}", "<i8") for f in ("gext", "src", "greg_in", "greg_out",
                                   "casc", "comb")]
    + [(f, "<i4") for f in ("n_regs", "n_casc", "n_comb", "n_ext", "n_src",
                            "smem_bytes", "prog_bytes", "sm_src", "sm_gy",
                            "pad0", "pad1", "pad2")])
CASC = np.dtype([(f, "<u8") for f in ("consts", "seed_x", "seed_c", "g_s0")]
                + [(f, "<i4") for f in ("sm_consts", "sm_cbuf", "n", "pad")])
COMB = np.dtype([(f, "<u8") for f in ("ct_hist", "g_hist", "scratch")]
                + [(f, "<i4") for f in ("sm_ring", "d", "rl2")]
                + [("decay", "<f4")])
#: the pointer tables after the header, in order
_TABLES = ("gext", "src", "greg_in", "greg_out", "casc", "comb")
_RECORDS = {"casc": CASC, "comb": COMB}


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures on a build of the reverse kernel (this
    module's, or another checkout's that a measuring tool loads) and check
    its record sizes and layout constants against this module's and the
    forward's: raises when they differ."""
    for name in ("cycle_reverse_abi", "cycle_reverse_shape"):
        getattr(lib, name).restype = ctypes.c_int
    lib.cycle_reverse_shape.argtypes = [ctypes.c_int]
    lib.cycle_reverse_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.cycle_reverse_launch.restype = ctypes.c_int
    want = HEADER.itemsize | CASC.itemsize << 8 | COMB.itemsize << 16
    if lib.cycle_reverse_abi() != want:
        raise RuntimeError(
            f"reverse cycle kernel ABI mismatch: the library's record sizes "
            f"are {lib.cycle_reverse_abi():#x}, the packer's {want:#x}")
    shape = tuple(lib.cycle_reverse_shape(i) for i in range(4))
    want_shape = (cycle_kernel.NCONST, cycle_kernel.FB, cycle_kernel.RS,
                  cycle_kernel.WS)
    if shape != want_shape:
        raise RuntimeError(f"reverse cycle kernel built with layout {shape},"
                           f" the packer's {want_shape}")
    return lib


@functools.lru_cache(maxsize=16)
def _lib(source: str, defines: tuple = ()) -> ctypes.CDLL:
    """The reverse kernel's library for the generated block adjoint
    ``source``, built with ``defines``, bound."""
    return bind(cuda_build.load("cycle_reverse_kernel", defines, source))


def counts(program: tuple):
    """(n_casc, n_comb, n_regs, n_taps, n_exts, n_ew) of a block program,
    checked by the forward's ``plan``: raises on what the kernels cannot
    take."""
    return (*cycle_kernel.plan(tuple(program)),
            sum(1 for ins in program if ins[0] == "ew"))


def ctas_an_sm(smem_bytes: int) -> int:
    """The CTAs an SM the kernel's launch bound asks room for (CR_CTAS):
    as many as an SM's shared memory holds at ``smem_bytes`` of dynamic
    shared memory a CTA, from 1 to MAX_CTAS.  More would cap a thread's
    registers for CTAs that cannot be resident."""
    return max(1, min(MAX_CTAS, SM_SMEM // (smem_bytes + CTA_SMEM)))


def reverse_source(program: tuple, casc_smem: tuple, ring_smem: tuple,
                   ctas: int = MAX_CTAS) -> str:
    """The generated header of the reverse kernel for ``program``: CY_NREG,
    CY_NEXT, CY_NSRC, CY_NCOMB, CY_BLOCK_BARRIER, CR_CTAS (``ctas``, the
    launch bound's CTAs an SM), CR_HOLD_* for a program of one cascade
    (its constants held in registers), and cy_block_adjoint
    (left out when the kernel reads the sizes alone, CR_SIZES_ONLY), one
    line per instruction of the program in reverse order, each ending in a
    comment with its index and op, the rules of
    cycle_segment.interpret_adjoint in its order of operations;
    ``casc_smem`` and ``ring_smem`` say per cascade and per comb whether
    its constants or ring are in shared memory.  Raises on what ``plan``
    refuses."""
    n_c, n_b, n_r, n_t, n_e, n_ew = counts(program)
    lit = cycle_kernel._lit
    out = [f"#define CY_NREG {max(n_r, 1)}",
           f"#define CY_NEXT {max(n_e, 1)}",
           f"#define CY_NSRC {n_t + n_ew}",
           f"#define CY_NCOMB {n_b}",
           f"#define CY_BLOCK_BARRIER {int(n_c == 0 and n_b > 0)}",
           f"#define CR_CTAS {int(ctas)}"]
    if n_c == 1:                # its constants stay in registers
        secs = next(ins[1] for ins in program if ins[0] == "cascade")
        out += [f"#define CR_HOLD_N {_casc_consts(secs)[4]}",
                f"#define CR_HOLD_SM {'true' if casc_smem[0] else 'false'}"]
    out += ["#ifndef CR_SIZES_ONLY",
            "__device__ __forceinline__ void cy_block_adjoint(CrCtx& x, "
            "float (&g)[CY_NREG], const CrHold& hold) {",
           "  float f = 0.0f, s = 0.0f, sa = 0.0f, sb = 0.0f;",
           "  float e[CY_NEXT] = {};"]

    def terms(ts, var):
        return [f"g[{j}] = g[{j}] + {var};" if kind == "reg" else
                f"e[{j}] = e[{j}] + {var};" for kind, j in ts]

    k = n_ew
    for i in reversed(range(len(program))):
        ins = program[i]
        op = ins[0]
        if op == "setreg":
            st = [f"f = f + g[{ins[1]}];", f"g[{ins[1]}] = 0.0f;"]
        elif op == "tap":
            st = [f"f = f + cr_in(x, {ins[1]});"]
        elif op == "scale":
            st = [f"f = f * {lit(ins[1])};"]
        elif op == "ew":
            k -= 1
            p = [float(v) for v in ins[2]] + [0.0] * (4 - len(ins[2]))
            if ins[1] == "chebyshev":         # its two denominators
                p[2:] = [_tanh20(float(np.float32(v))) for v in p[:2]]
            st = [f"f = cr_ew<{EW_CODES.index(ins[1])}>(x, f, "
                  f"cr_in(x, {n_t + k}), " + ", ".join(lit(v) for v in p)
                  + ");"]
        elif op == "comb":
            _, decay, D, bi = ins
            sm = "true" if ring_smem[bi] else "false"
            st = [f"f = cr_comb<{int(D)}, {sm}>(x, {int(bi)}, f, "
                  f"{lit(decay)});"]
        elif op == "cascade":
            ci = int(ins[2])
            sm = "true" if casc_smem[ci] else "false"
            N = _casc_consts(ins[1])[4]
            st = [f"f = cr_cascade_held<{N}>(x, {ci}, f, hold);" if n_c == 1
                  else f"f = cr_cascade<{N}, {sm}>(x, {ci}, f);"]
        elif op == "join":
            st = [f"s = f * {lit(ins[2])};" if ins[2] != 1.0 else "s = f;"]
            st += terms(ins[1], "s") + ["f = 0.0f;"]
        else:                                   # lin2
            _, tA, sA, tB, sB, cA, cB = ins
            st = [f"sa = f * {lit(cA)};", f"sb = f * {lit(cB)};"]
            st += [f"sa = sa * {lit(sA)};"] if sA != 1.0 else []
            st += [f"sb = sb * {lit(sB)};"] if sB != 1.0 else []
            st += terms(tA, "sa") + terms(tB, "sb") + ["f = 0.0f;"]
        out.append("  " + " ".join(st) + f"  // {i} {op}")
    out += ["  cr_feeds(x, e);", "}", "#endif"]
    return "\n".join(out) + "\n"


def placement(program: tuple, budget: int):
    """The shared-memory plan (the forward's ``smem_plan``) of the reverse
    kernel for ``program``: its staged streams are the taps' cotangents
    and the shapers' inputs.  Returns (plan, table sizes)."""
    n_c, n_b, n_r, n_t, n_e, n_ew = counts(program)
    sizes = {"gext": n_e, "src": n_t + n_ew, "greg_in": n_r,
             "greg_out": n_r, "casc": n_c, "comb": n_b}
    rl2 = tuple((-(-int(ins[2]) // C) + 1) * C for ins in program
                if ins[0] == "comb")
    return cycle_kernel.smem_plan(_layout(sizes)[1], n_t + n_ew, n_c, rl2,
                                  budget), sizes


def source_for(program: tuple, budget: int) -> str:
    """The generated block adjoint of ``program`` under the placement its
    shared-memory plan gives at ``budget``, and the launch bound that
    plan's size leaves."""
    (_, _, consts, rings, total), _ = placement(tuple(program), budget)
    return reverse_source(tuple(program), tuple(o >= 0 for o in consts),
                          tuple(o >= 0 for o in rings), ctas_an_sm(total))


def _layout(sizes: dict):
    """Byte offsets of the pointer tables (``sizes`` entries each, after
    the header) and their end, each 16-byte aligned."""
    offs, end = {}, HEADER.itemsize
    for name in _TABLES:
        offs[name] = -(-end // 16) * 16
        rec = _RECORDS.get(name)
        end = offs[name] + (rec.itemsize if rec is not None else 8) * \
            sizes[name]
    return offs, -(-end // 16) * 16


def pack_tables(n_regs: int, tables: dict, sec: dict,
                smem_bytes: int) -> np.ndarray:
    """The packed tables, a uint8 array: the header, then ``tables``' entries
    in ``_TABLES`` order (integers; for "casc" one (consts, seed_x,
    seed_c, g_s0, sm_consts, sm_cbuf, n) per cascade, for "comb" one
    (ct_hist, g_hist, scratch, sm_ring, d, rl2, decay) per comb).
    ``sec`` holds the staged streams' ("feeds") and the adjoint rows'
    ("xs") offsets of the shared-memory plan."""
    sizes = {k: len(tables[k]) for k in _TABLES}
    offs, end = _layout(sizes)
    buf = np.zeros(end, np.uint8)
    hdr = np.zeros((), HEADER)
    hdr["n_regs"], hdr["n_casc"], hdr["n_comb"] = (n_regs, sizes["casc"],
                                                   sizes["comb"])
    hdr["n_ext"], hdr["n_src"] = sizes["gext"], sizes["src"]
    hdr["smem_bytes"], hdr["prog_bytes"] = smem_bytes, end
    hdr["sm_src"], hdr["sm_gy"] = sec["feeds"], sec["xs"]
    for name, o in offs.items():
        hdr[f"off_{name}"] = o

    def put(off, arr):
        raw = np.frombuffer(np.ascontiguousarray(arr).tobytes(), np.uint8)
        buf[off:off + raw.size] = raw

    put(0, hdr)
    for name in _TABLES:
        rec = _RECORDS.get(name)
        if rec is not None:
            arr = np.zeros(sizes[name], rec)
            for i, entry in enumerate(tables[name]):
                arr[i] = tuple(entry) + (0,) * (len(rec.names) - len(entry))
        else:
            arr = np.asarray(tables[name], np.uint64)
        put(offs[name], arr)
    return buf


def _check(t, shape, dev, what: str):
    """``t`` (or None) as the kernel reads it: a contiguous float32 CUDA
    tensor of ``shape`` on ``dev``; raises otherwise."""
    if t is None:
        return None
    if (not isinstance(t, torch.Tensor) or tuple(t.shape) != tuple(shape)
            or t.dtype != torch.float32 or t.device != dev
            or not t.is_contiguous()):
        got = (f"{t.dtype} {tuple(t.shape)} on {t.device}"
               if isinstance(t, torch.Tensor) else type(t).__name__)
        raise ValueError(f"reverse cycle kernel: {what} must be a contiguous "
                         f"float32 {list(shape)} tensor on {dev}, got {got}")
    return t


def cycle_reverse_call(ct_taps: tuple, ct_regs: tuple, seeds: tuple,
                       ct_hists: tuple, recs: tuple, program: tuple,
                       n_ext: int, B: int, T: int, dev):
    """The vjp of the block program over B rows of T samples (T % 128 ==
    0) on ``dev``: ct_taps n_t x [B, T], ct_regs n_r x [B, 128] (the final
    registers'), seeds per cascade (the last block's input seed [B, 128],
    the seed of the carry entering it [B, N]) (cycle_segment.cinfo_seeds),
    ct_hists per comb [B, D], each None where there is no cotangent; recs
    n_ew x [B, T], the shapers' inputs (the forward's record build) ->
    (feed gradients n_ext x [B, T], register gradients n_r x [B, 128],
    per cascade [B, 8] (its carry lanes), per comb [B, D])."""
    return _run(ct_taps, ct_regs, seeds, ct_hists, recs, program, n_ext, B,
                T, dev)


def phase_cycles(ct_taps: tuple, ct_regs: tuple, seeds: tuple,
                 ct_hists: tuple, recs: tuple, program: tuple, n_ext: int,
                 B: int, T: int, dev) -> np.ndarray:
    """``cycle_reverse_call`` once in the kernel's build with its phase
    probes (-DCR_PHASES), for tools/measure_torch_cycle.py --phases:
    returns the clock cycles threads 0 and 127 of each CTA (of the first
    4096) spent in each phase, uint64 [CTAs, 2, len(PHASES)]."""
    _run(ct_taps, ct_regs, seeds, ct_hists, recs, program, n_ext, B, T, dev,
         ("CR_PHASES",))
    lib = _lib(source_for(tuple(program), cycle_kernel.budget_of(dev)),
               ("CR_PHASES",))
    lib.cycle_reverse_phases.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.cycle_reverse_phases.restype = ctypes.c_int
    torch.cuda.synchronize(dev)
    buf = np.zeros((min(B, 4096), 2, len(PHASES)), np.uint64)
    rc = lib.cycle_reverse_phases(buf.ctypes.data, buf.shape[0])
    if rc:
        raise RuntimeError(f"reading the phase counters: CUDA error {rc}")
    return buf


def _run(ct_taps: tuple, ct_regs: tuple, seeds: tuple, ct_hists: tuple,
         recs: tuple, program: tuple, n_ext: int, B: int, T: int, dev,
         defines: tuple = ()):
    """``cycle_reverse_call`` in the kernel's build with ``defines``."""
    global LAUNCHES
    program = tuple(program)
    n_c, n_b, n_r, n_t, n_e, n_ew = counts(program)
    if not isinstance(dev, torch.device) or dev.type != "cuda":
        raise ValueError(f"reverse cycle kernel: needs a CUDA device, got "
                         f"{dev}")
    if B < 1 or T < C or T % C:
        raise ValueError(f"reverse cycle kernel: T={T} must be a positive "
                         f"multiple of {C}; B={B} must be >= 1")
    if (n_ext, len(ct_taps), len(ct_regs), len(seeds), len(ct_hists),
            len(recs)) != (n_e, n_t, n_r, n_c, n_b, n_ew):
        raise ValueError(
            f"reverse cycle kernel: {n_ext} feeds, {len(ct_taps)} tap, "
            f"{len(ct_regs)} register, {len(seeds)} cascade, "
            f"{len(ct_hists)} history cotangents and {len(recs)} recorded "
            f"inputs for a program of {n_e}, {n_t}, {n_r}, {n_c}, {n_b} and "
            f"{n_ew}")
    (sec, cbuf, sm_consts, sm_rings, smem_bytes), _ = placement(
        program, cycle_kernel.budget_of(dev))
    source = reverse_source(program, tuple(o >= 0 for o in sm_consts),
                            tuple(o >= 0 for o in sm_rings),
                            ctas_an_sm(smem_bytes))

    def empty(n):
        return torch.empty((B, n), dtype=torch.float32, device=dev)

    def ptr(t):
        return 0 if t is None else t.data_ptr()

    tables = {k: [] for k in _TABLES}
    g_ext = tuple(empty(T) for _ in range(n_e))
    g_regs = tuple(empty(C) for _ in range(n_r))
    tables["gext"] = [g.data_ptr() for g in g_ext]
    tables["src"] = [ptr(_check(t, (B, T), dev, f"tap {i}'s cotangent"))
                     for i, t in enumerate(ct_taps)]
    if any(r is None for r in recs):
        raise ValueError("reverse cycle kernel: every shaper's input must "
                         "be recorded")
    tables["src"] += [_check(r, (B, T), dev, f"shaper {i}'s input")
                      .data_ptr() for i, r in enumerate(recs)]
    tables["greg_in"] = [ptr(_check(t, (B, C), dev, f"register {i}'s "
                                    f"cotangent"))
                         for i, t in enumerate(ct_regs)]
    tables["greg_out"] = [g.data_ptr() for g in g_regs]
    g_states, keep = [], []
    ci = bi = 0
    for ins in program:
        if ins[0] == "cascade":
            consts = cycle_kernel._casc_consts_device(ins[1], dev)
            N = _casc_consts(ins[1])[4]
            sx, sc = seeds[ci]
            _check(sx, (B, C), dev, f"cascade {ci}'s input seed")
            sc8 = None
            if sc is not None:
                if sc.shape[-1] > NS:
                    raise ValueError(f"reverse cycle kernel: cascade {ci}'s "
                                     f"carry seed has {sc.shape[-1]} lanes")
                sc8 = torch.zeros((B, NS), dtype=torch.float32, device=dev)
                sc8[:, :sc.shape[-1]] = _check(
                    sc, (B, sc.shape[-1]), dev, f"cascade {ci}'s carry seed")
            g_s0 = empty(NS)
            tables["casc"].append((consts.data_ptr(), ptr(sx), ptr(sc8),
                                   g_s0.data_ptr(), sm_consts[ci], cbuf[ci],
                                   N))
            keep += [consts, sc8]
            g_states.append(g_s0)
            ci += 1
        elif ins[0] == "comb":
            D = int(ins[2])
            rl2 = (-(-D // C) + 1) * C
            cth = _check(ct_hists[bi], (B, D), dev,
                         f"comb {bi}'s history cotangent")
            g_h = empty(D)
            scratch = empty(rl2) if sm_rings[bi] < 0 else None
            keep.append(scratch)
            tables["comb"].append((ptr(cth), g_h.data_ptr(), ptr(scratch),
                                   sm_rings[bi], D, rl2,
                                   float(np.float32(ins[1]))))
            g_states.append(g_h)
            bi += 1

    buf = pack_tables(n_r, tables, sec, smem_bytes)
    prog = to_device(buf, dev)
    rc = _lib(source, tuple(defines)).cycle_reverse_launch(
        prog.data_ptr(), buf.size, smem_bytes, B, T, dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"reverse cycle kernel launch failed: CUDA error "
                           f"{rc} ({buf.size} bytes of tables, {smem_bytes} "
                           f"bytes of shared memory)")
    LAUNCHES += 1
    return g_ext, g_regs, tuple(g_states)
