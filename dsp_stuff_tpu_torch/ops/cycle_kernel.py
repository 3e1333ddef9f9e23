"""Wrapper of the cycle kernel (csrc/cycle_kernel.cu): generate, pack,
build, bind, launch.

The kernel replaces dsp_stuff_tpu/ops/pallas_cycle.py:cycle_kernel_call:
a feedback SCC's block program (ops/cycle_segment.py) over a whole
render, with registers, cascade carries and comb rings kept on the card.
As the JAX package traces its Pallas kernel once per static program
(pallas_cycle._build_kernel), ``program_source`` writes the program's
block as straight-line CUDA over the kernel's helpers (every constant a
literal), and ops/cuda_build.py builds csrc/cycle_kernel.cu with it, once
per program, at first use, bound with ``ctypes``.  Nothing is imported,
built or loaded when this module is imported.

The pointer tables go to the card packed (``pack_program``): a header,
then the feeds, taps, registers, a record per cascade and per comb, sized
from the program and copied once per call.  ``smem_plan`` lays out the
kernel's shared memory: the tables, the staged feeds, the cascades' input
rows and carries, then each cascade's constants (``cycle_casc_consts``)
and each comb's working ring while they fit the card's shared memory per
block; what does not fit stays in device memory (a ring in a scratch ring
of the same length), and the generated code names each placement.

``cycle_kernel_call`` takes only CUDA tensors and raises on anything the
kernel cannot take; there is no fallback.  Its ``record`` build
(-DCY_RECORD) also writes each shaper's input, the residuals of the
reverse kernel (ops/cycle_reverse_kernel.py); without the define the
generated text and the build are the render's.  The plain PyTorch version of
the same function is ops/cycle_segment.interpret.  ``LAUNCHES`` counts
the kernel's launches.  ``phase_cycles`` runs the build with the
kernel's phase probes (tools/measure_torch_cycle.py --phases).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from dsp_stuff_tpu_torch.ops import cuda_build
from dsp_stuff_tpu_torch.utils.capture import device_cache
from dsp_stuff_tpu_torch.ops.chain_kernel import (C, EW_CODES, NS,
                                                  _casc_consts, _seeded_ring,
                                                  to_device)

_OPS = ("join", "lin2", "cascade", "comb", "ew", "scale", "setreg", "tap")

#: launches of the kernel in this process (a test or a smoke run resets it)
LAUNCHES = 0
#: the probes' CY_PH_* order in csrc/cycle_kernel.cu
PHASES = ("feed", "join", "product", "carry", "comb", "ew", "taps",
          "barrier", "block loop")

# Layout constants, mirrored by csrc/cycle_kernel.cu (cycle_kernel_shape):
FB = 8          # feed blocks in flight
RS = 168        # stride of a reversed Toeplitz row copy (zeros to 159)
WS = 132        # row stride of W^T
OFF_R, OFF_W = 0, 4 * RS
OFF_E = OFF_W + NS * WS
OFF_A = OFF_E + NS * C
NCONST = OFF_A + NS * NS        # floats of a cascade's constants

# The packed tables' records, mirrored field for field by
# csrc/cycle_kernel.cu (CyHeader, CyCasc, CyComb).
HEADER = np.dtype(
    [(f"off_{f}", "<i8") for f in ("ext", "tap", "reg0", "reg_out", "casc",
                                   "comb")]
    + [(f, "<i4") for f in ("n_regs", "n_casc", "n_comb", "n_ext", "n_tap",
                            "smem_bytes", "prog_bytes", "sm_feeds", "sm_xs",
                            "pad0", "pad1", "pad2")])
CASC = np.dtype([(f, "<u8") for f in ("consts", "s0", "carry_out",
                                      "xlast_out")]
                + [(f, "<i4") for f in ("sm_consts", "sm_cbuf", "n", "pad")])
COMB = np.dtype([("raw", "<u8"), ("scratch", "<u8"), ("sm_ring", "<i4"),
                 ("rl", "<i4"), ("rl2", "<i4"), ("pad", "<i4")])
#: the pointer tables after the header, in order
_TABLES = ("ext", "tap", "reg0", "reg_out", "casc", "comb")
#: shared memory the kernel keeps for itself (its static arrays, the phase
#: probes' counters), left out of the plan's budget
STATIC_SMEM = 1024


@functools.lru_cache(maxsize=16)
def _lib(source: str, defines: tuple = ()) -> ctypes.CDLL:
    """The cycle kernel library for the generated block code ``source``,
    built with ``defines``, bound and its record sizes and layout
    constants checked against this module's."""
    lib = cuda_build.load("cycle_kernel", defines, source)
    lib.cycle_kernel_abi.argtypes = []
    lib.cycle_kernel_abi.restype = ctypes.c_int
    lib.cycle_kernel_shape.argtypes = [ctypes.c_int]
    lib.cycle_kernel_shape.restype = ctypes.c_int
    if "CY_RECORD" in defines:          # its launch takes the rec buffer
        lib.cycle_kernel_record_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        lib.cycle_kernel_record_launch.restype = ctypes.c_int
    else:
        lib.cycle_kernel_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.cycle_kernel_launch.restype = ctypes.c_int
    want = HEADER.itemsize | CASC.itemsize << 8 | COMB.itemsize << 16
    if lib.cycle_kernel_abi() != want:
        raise RuntimeError(
            f"cycle kernel ABI mismatch: the library's record sizes are "
            f"{lib.cycle_kernel_abi():#x}, the packer's {want:#x}")
    shape = tuple(lib.cycle_kernel_shape(i) for i in range(4))
    if shape != (NCONST, FB, RS, WS):
        raise RuntimeError(f"cycle kernel built with layout {shape}, the "
                           f"packer's {(NCONST, FB, RS, WS)}")
    return lib


def _rows(t, B: int, n: int, dev, what: str):
    if (not isinstance(t, torch.Tensor) or t.shape != (B, n)
            or t.dtype != torch.float32 or t.device != dev
            or not t.is_contiguous()):
        got = (f"{t.dtype} {tuple(t.shape)} on {t.device}"
               if isinstance(t, torch.Tensor) else type(t).__name__)
        raise ValueError(f"cycle kernel: {what} must be a contiguous float32 "
                         f"[{B}, {n}] tensor on {dev}, got {got}")
    return t


def plan(program: tuple):
    """The counts (n_casc, n_comb, n_regs, n_taps, n_exts) of a block
    program, checked: raises on what the kernel cannot take."""
    from dsp_stuff_tpu_torch.ops.cycle_segment import _program_counts
    program = tuple(program)
    counts = _program_counts(program)
    n_r = counts[2]

    def check_terms(ts):
        if not ts:
            raise ValueError("cycle kernel: a join needs at least one term")
        for kind, j in ts:
            if not ((kind == "ext" and j >= 0)
                    or (kind == "reg" and 0 <= j < n_r)):
                raise ValueError(f"cycle kernel: bad term {(kind, j)!r} "
                                 f"for {n_r} registers")

    n_casc = n_comb = 0
    for ins in program:
        op = ins[0]
        if op not in _OPS:
            raise ValueError(f"cycle kernel: unknown instruction {op!r}")
        if op == "join":
            check_terms(ins[1])
        elif op == "lin2":
            check_terms(ins[1])
            check_terms(ins[3])
        elif op == "cascade":
            if ins[2] != n_casc:
                raise ValueError("cycle kernel: cascade indices must count "
                                 "up from 0 in program order")
            n_casc += 1
        elif op == "comb":
            _, _, D, bi = ins
            if bi != n_comb or int(D) < C:
                raise ValueError(f"cycle kernel: comb {bi} (D={D}) must have "
                                 f"D >= {C} and indices counting up from 0")
            n_comb += 1
        elif op == "ew":
            if ins[1] not in EW_CODES:
                raise ValueError(f"cycle kernel: unknown shaper {ins[1]!r}")
            if len(ins[2]) > 4:
                raise ValueError(f"cycle kernel: shaper {ins[1]!r} has "
                                 f"{len(ins[2])} params")
    return counts


def _lit(v) -> str:
    """float32 ``v`` as an exact CUDA literal."""
    f = np.float32(v)
    if not np.isfinite(f):
        return f"__int_as_float({int(f.view(np.int32))})"
    return f"{float(f).hex()}f"


def program_source(program: tuple, casc_smem: tuple, ring_smem: tuple,
                   record: bool = False) -> str:
    """The generated header of the kernel for ``program``: CY_NREG,
    CY_BLOCK_BARRIER, CY_HOLD_* for a program of one cascade (its
    constants held in registers) and cy_block, one statement per
    operation of the program in its order, as cycle_segment.interpret
    computes them (joins summed left to right and scaled when the scale
    is not 1, lin2 as B*cB + A*cA); ``casc_smem`` and ``ring_smem`` say
    per cascade and per comb whether its constants or ring are in shared
    memory.  ``record`` (the build with -DCY_RECORD) adds a
    ``cy_record(x, k, f)`` line before the k-th shaper: it writes the
    shaper's input, the reverse kernel's residual; without it the text is
    the render build's."""
    n_c, n_b, n_r, _, _ = plan(program)
    out = [f"#define CY_NREG {max(n_r, 1)}",
           f"#define CY_BLOCK_BARRIER {int(n_c == 0 and n_b > 0)}"]
    if n_c == 1:                # its constants stay in registers
        secs = next(ins[1] for ins in program if ins[0] == "cascade")
        out += [f"#define CY_HOLD_N {_casc_consts(secs)[4]}",
                f"#define CY_HOLD_SM {'true' if casc_smem[0] else 'false'}"]
    out += ["__device__ __forceinline__ void cy_block(CyCtx& x, "
            "float (&r)[CY_NREG], const CyHold& hold) {",
            "  float f = 0.0f;"]

    def term(t):
        return f"r[{int(t[1])}]" if t[0] == "reg" else \
            f"cy_feed(x, {int(t[1])})"

    def join(ts, scale, var):
        out.append(f"  {var} = {term(ts[0])};")
        for t in ts[1:]:
            out.append(f"  {var} = {var} + {term(t)};")
        if scale != 1.0:
            out.append(f"  {var} = {var} * {_lit(scale)};")

    probe = "  CY_USE(f); CY_PHASE(CY_PH_JOIN);"
    n_ew = 0
    for ins in program:
        op = ins[0]
        out.append(f"  // {op}")
        if op == "join":
            join(ins[1], ins[2], "f")
            out.append(probe)
        elif op == "lin2":
            _, tA, sA, tB, sB, cA, cB = ins
            out.append("  {")
            out.append("  float a, bb;")
            join(tA, sA, "a")
            join(tB, sB, "bb")
            out.append(f"  f = bb * {_lit(cB)} + a * {_lit(cA)};")
            out.append("  }")
            out.append(probe)
        elif op == "cascade":
            ci = int(ins[2])
            N = _casc_consts(ins[1])[4]
            sm = "true" if casc_smem[ci] else "false"
            out.append(f"  f = cy_cascade_held<{N}>(x, {ci}, f, hold);"
                       if n_c == 1 else
                       f"  f = cy_cascade<{N}, {sm}>(x, {ci}, f);")
        elif op == "comb":
            _, decay, D, bi = ins
            sm = "true" if ring_smem[bi] else "false"
            out.append(f"  f = cy_comb<{int(D)}, {sm}>(x, {int(bi)}, f, "
                       f"{_lit(decay)});")
        elif op == "ew":
            if record:
                out.append(f"  cy_record(x, {n_ew}, f);")
            n_ew += 1
            p = [float(v) for v in ins[2]] + [0.0] * (4 - len(ins[2]))
            out.append(f"  f = cy_ew<{EW_CODES.index(ins[1])}>(x, f, "
                       + ", ".join(_lit(v) for v in p) + ");")
        elif op == "scale":
            out.append(f"  f = f * {_lit(ins[1])};")
            out.append(probe)
        elif op == "setreg":
            out.append(f"  r[{int(ins[1])}] = f;")
        else:                                   # tap
            out.append(f"  cy_tap(x, {int(ins[1])}, f);")
    out.append("}")
    return "\n".join(out) + "\n"


@functools.lru_cache(maxsize=64)
def cycle_casc_consts(sections: tuple) -> np.ndarray:
    """One cascade's constants as the kernel reads them, f32 [NCONST]:
    R [4, RS], copy q holding h[128 + q - j] at j (h = Ltg[0], the
    Toeplitz row; zeros outside 0..127), so that R[q, 128 + q - c + i]
    = Ltg[i, c] for c = q (mod 4); W^T [NS, WS] (W [C, NS] transposed,
    rows padded); Ecb [NS, C]; ACt [NS, NS]."""
    from dsp_stuff_tpu_torch.ops.chain_kernel import casc_tile_consts
    casc_tile_consts(sections)                  # checks Ltg is Toeplitz
    Ltg, Wp, Ecb, ACt, _N = _casc_consts(sections)
    h = Ltg[0]
    out = np.zeros(NCONST, np.float32)
    R = out[OFF_R:OFF_W].reshape(4, RS)
    for q in range(4):
        k = 128 + q - np.arange(RS)             # the tap index at j
        ok = (k >= 0) & (k < C)
        R[q, ok] = h[k[ok]]
    out[OFF_W:OFF_E].reshape(NS, WS)[:, :C] = Wp.T
    out[OFF_E:OFF_A] = Ecb.ravel()
    out[OFF_A:] = ACt.ravel()
    return out


@device_cache(maxsize=64)
def _casc_consts_device(sections: tuple, device: torch.device):
    return torch.as_tensor(cycle_casc_consts(sections), device=device)


def _align(n: int) -> int:
    return -(-n // 16) * 16


def layout(sizes: dict):
    """Byte offsets of the packed tables' sections (the pointer tables of
    ``_TABLES`` with ``sizes`` entries each, after the header) and their
    end, each 16-byte aligned."""
    rec = {"casc": CASC.itemsize, "comb": COMB.itemsize}
    offs, end = {}, HEADER.itemsize
    for name in _TABLES:
        offs[name] = _align(end)
        end = offs[name] + rec.get(name, 8) * sizes[name]
    return offs, _align(end)


def smem_plan(prog_bytes: int, n_ext: int, n_casc: int, ring_lengths: tuple,
              budget: int):
    """The kernel's dynamic shared memory, in bytes from its start: the
    packed tables (``prog_bytes``), the staged feeds [n_ext, FB, C], the
    cascades' two input rows [2, C], a carry buffer [2, NS] per cascade;
    then, in program order while the total stays within ``budget``, each
    cascade's constants [NCONST] and each comb's working ring of
    ``ring_lengths`` floats (rl2).  Returns (sections {"feeds", "xs"},
    cbuf offsets, constants offsets, ring offsets (-1: in device memory),
    total bytes)."""
    sec = {"feeds": prog_bytes}
    sec["xs"] = sec["feeds"] + 4 * C * FB * n_ext
    end = sec["xs"] + 4 * 2 * C
    cbuf = []
    for _ in range(n_casc):
        cbuf.append(end)
        end += 4 * 2 * NS
    if end > budget:
        raise ValueError(f"cycle kernel: the tables, feeds and carries take "
                         f"{end} bytes of shared memory, more than the "
                         f"{budget} a block may have")

    def place(nbytes):
        nonlocal end
        if end + nbytes > budget:
            return -1
        at, end = end, end + nbytes
        return at

    consts = [place(4 * NCONST) for _ in range(n_casc)]
    rings = [place(4 * rl2) for rl2 in ring_lengths]
    return sec, cbuf, consts, rings, end


def pack_program(n_regs: int, tables: dict, smem: tuple) -> np.ndarray:
    """The packed tables, a uint8 array: the header, then the pointer
    tables: ``tables`` maps each name of ``_TABLES`` to its entries
    (integers; for "casc" one (consts, s0, carry_out, xlast_out,
    sm_consts, sm_cbuf, n) per cascade, for "comb" one (raw, scratch,
    sm_ring, rl, rl2) per comb).  ``smem`` is (sections, smem_bytes) of
    ``smem_plan``, which starts with the tables' own bytes (``layout``)."""
    sizes = {k: len(tables[k]) for k in _TABLES}
    offs, end = layout(sizes)
    sec, smem_bytes = smem
    buf = np.zeros(end, np.uint8)
    hdr = np.zeros((), HEADER)
    hdr["n_regs"], hdr["n_casc"] = n_regs, sizes["casc"]
    hdr["n_comb"], hdr["n_ext"], hdr["n_tap"] = (sizes["comb"], sizes["ext"],
                                                 sizes["tap"])
    hdr["smem_bytes"], hdr["prog_bytes"] = smem_bytes, end
    for name, o in offs.items():
        hdr[f"off_{name}"] = o
    for name in ("feeds", "xs"):
        hdr[f"sm_{name}"] = sec[name]

    def put(off, arr):
        raw = np.frombuffer(np.ascontiguousarray(arr).tobytes(), np.uint8)
        buf[off:off + raw.size] = raw

    put(0, hdr)
    for name in _TABLES:
        if name in ("casc", "comb"):
            arr = np.zeros(sizes[name], CASC if name == "casc" else COMB)
            for i, p in enumerate(tables[name]):
                arr[i] = tuple(p) + (0,)
        else:
            arr = np.asarray(tables[name], np.uint64)
        put(offs[name], arr)
    return buf


def placement(program: tuple, n_ext: int, budget: int):
    """The shared-memory plan of ``program`` (``smem_plan``) with its
    tables' size: (plan, prog_bytes)."""
    n_c, n_b, n_r, n_t, n_e = plan(program)
    sizes = {"ext": n_ext, "tap": n_t, "reg0": n_r, "reg_out": n_r,
             "casc": n_c, "comb": n_b}
    prog_bytes = layout(sizes)[1]
    rls = [-(-int(ins[2]) // C) * C for ins in program if ins[0] == "comb"]
    return smem_plan(prog_bytes, n_ext, n_c, tuple(rl + C for rl in rls),
                     budget), prog_bytes


def budget_of(dev) -> int:
    """The dynamic shared memory a CTA of the kernel may plan on ``dev``."""
    return torch.cuda.get_device_properties(
        dev).shared_memory_per_block_optin - STATIC_SMEM


def source_for(program: tuple, budget: int, record: bool = False) -> str:
    """The generated block code of ``program`` under the placement its
    shared-memory plan gives at ``budget`` (``record``: the record
    build's)."""
    program = tuple(program)
    n_e = plan(program)[4]
    (_, _, consts, rings, _), _ = placement(program, n_e, budget)
    return program_source(program, tuple(o >= 0 for o in consts),
                          tuple(o >= 0 for o in rings), record)


def has_shaper(program: tuple) -> bool:
    """Whether the program has an ``ew`` instruction (a residual to record
    for the reverse kernel)."""
    return any(ins[0] == "ew" for ins in program)


def cycle_kernel_call(exts: tuple, regs0: tuple, states: tuple,
                      program: tuple, n_taps: int, record: bool = False):
    """exts: n_e x [B, T] f32 CUDA (T % 128 == 0); regs0: n_r x [B, 128];
    states: per cascade [B, N], per comb [B, D], in program order ->
    (taps n_t x [B, T], regs_f n_r x [B, 128],
     per cascade (carry_last [B, 8], x_last [B, 128]),
     per comb ring [B, NR, 128]).
    ``record`` launches the record build (-DCY_RECORD; the same outputs,
    bitwise) and returns (those outputs, recs): recs n_ew x [B, T], the
    input of each shaper in program order, views of one [n_ew, B, T]
    buffer.  A program with no shaper has no record build."""
    if not record:
        return _run(exts, regs0, states, program, n_taps)
    if not has_shaper(program):
        raise ValueError("cycle kernel: a program with no shaper records "
                         "nothing")
    return _run(exts, regs0, states, program, n_taps, ("CY_RECORD",))


def phase_cycles(exts: tuple, regs0: tuple, states: tuple, program: tuple,
                 n_taps: int) -> np.ndarray:
    """``cycle_kernel_call`` once in the kernel's build with its phase
    probes (-DCY_PHASES), for tools/measure_torch_cycle.py --phases:
    returns the clock cycles threads 0 and 127 of each CTA (of the first
    4096) spent in each phase, uint64 [CTAs, 2, len(PHASES)]."""
    _run(exts, regs0, states, program, n_taps, ("CY_PHASES",))
    lib = _lib(source_for(program, budget_of(exts[0].device)),
               ("CY_PHASES",))
    lib.cycle_kernel_phases.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.cycle_kernel_phases.restype = ctypes.c_int
    torch.cuda.synchronize(exts[0].device)
    buf = np.zeros((min(exts[0].shape[0], 4096), 2, len(PHASES)), np.uint64)
    rc = lib.cycle_kernel_phases(buf.ctypes.data, buf.shape[0])
    if rc:
        raise RuntimeError(f"reading the phase counters: CUDA error {rc}")
    return buf


def _run(exts: tuple, regs0: tuple, states: tuple, program: tuple,
         n_taps: int, defines: tuple = ()):
    """``cycle_kernel_call`` in the kernel's build with ``defines``."""
    global LAUNCHES
    program = tuple(program)
    # the program is checked first, whatever the tensors
    n_c, n_b, n_r, n_t, n_e = plan(program)
    if not exts or not all(isinstance(e, torch.Tensor) and e.is_cuda
                           for e in exts):
        raise ValueError("cycle kernel: the external feeds must be CUDA "
                         "tensors (at least one)")
    dev = exts[0].device
    if exts[0].dim() != 2:
        raise ValueError(f"cycle kernel: feeds must be [B, T], got "
                         f"{tuple(exts[0].shape)}")
    B, T = exts[0].shape
    if B < 1 or T < C or T % C:
        raise ValueError(f"cycle kernel: T={T} must be a positive multiple "
                         f"of {C}; B={B} must be >= 1")
    if (len(exts), len(regs0), n_taps) != (n_e, n_r, n_t):
        raise ValueError(f"cycle kernel: {len(exts)} feeds, {len(regs0)} "
                         f"registers and {n_taps} taps for a program of "
                         f"{n_e}, {n_r} and {n_t}")
    if len(states) != n_c + n_b:
        raise ValueError(f"cycle kernel: {len(states)} states for "
                         f"{n_c + n_b} stateful instructions")

    (sec, cbuf, sm_consts, sm_rings, smem_bytes), _ = placement(
        program, n_e, budget_of(dev))
    record = "CY_RECORD" in defines
    source = program_source(program, tuple(o >= 0 for o in sm_consts),
                            tuple(o >= 0 for o in sm_rings), record)
    tables = {k: [] for k in _TABLES}
    tables["ext"] = [_rows(e, B, T, dev, f"feed {i}").data_ptr()
                     for i, e in enumerate(exts)]
    taps = tuple(torch.empty((B, T), dtype=torch.float32, device=dev)
                 for _ in range(n_t))
    tables["tap"] = [t.data_ptr() for t in taps]
    regs_f = tuple(torch.empty((B, C), dtype=torch.float32, device=dev)
                   for _ in range(n_r))
    tables["reg0"] = [_rows(r0, B, C, dev, f"register {i}").data_ptr()
                      for i, r0 in enumerate(regs0)]
    tables["reg_out"] = [rf.data_ptr() for rf in regs_f]
    casc_raw, rings, keep = [], [], []
    si = ci = bi = 0
    for ins in program:
        if ins[0] == "cascade":
            consts = _casc_consts_device(ins[1], dev)
            N = _casc_consts(ins[1])[4]
            s0 = states[si]
            si += 1
            if s0.shape[-1] > NS or s0.shape != (B, s0.shape[-1]) \
                    or s0.device != dev:
                raise ValueError(f"cycle kernel: cascade state must be "
                                 f"[{B}, <= {NS}] on {dev}, got "
                                 f"{tuple(s0.shape)} on {s0.device}")
            s0p = torch.zeros((B, NS), dtype=torch.float32, device=dev)
            s0p[:, :s0.shape[-1]] = s0
            carry_out = torch.empty((B, NS), dtype=torch.float32, device=dev)
            xlast = torch.empty((B, C), dtype=torch.float32, device=dev)
            tables["casc"].append(
                (consts.data_ptr(), s0p.data_ptr(), carry_out.data_ptr(),
                 xlast.data_ptr(), sm_consts[ci], cbuf[ci], N))
            ci += 1
            keep += [consts, s0p]
            casc_raw.append((carry_out, xlast))
        elif ins[0] == "comb":
            D = int(ins[2])
            RL = -(-D // C) * C
            ring = _seeded_ring(states[si], B, D, RL, dev, "comb history")
            si += 1
            scratch = None
            if sm_rings[bi] < 0:
                scratch = torch.empty((B, RL + C), dtype=torch.float32,
                                      device=dev)
                keep.append(scratch)
            tables["comb"].append(
                (ring.data_ptr(), 0 if scratch is None
                 else scratch.data_ptr(), sm_rings[bi], RL, RL + C))
            bi += 1
            rings.append(ring.view(B, RL // C, C))

    buf = pack_program(n_r, tables, (sec, smem_bytes))
    prog = to_device(buf, dev)
    lib = _lib(source, tuple(defines))
    stream = torch.cuda.current_stream(dev).cuda_stream
    if record:
        n_ew = sum(1 for ins in program if ins[0] == "ew")
        rec = torch.empty((n_ew, B, T), dtype=torch.float32, device=dev)
        rc = lib.cycle_kernel_record_launch(
            prog.data_ptr(), buf.size, smem_bytes, B, T, rec.data_ptr(),
            dev.index, stream)
    else:
        rc = lib.cycle_kernel_launch(prog.data_ptr(), buf.size, smem_bytes,
                                     B, T, dev.index, stream)
    if rc != 0:
        raise RuntimeError(f"cycle kernel launch failed: CUDA error {rc}"
                           f" ({buf.size} bytes of tables, {smem_bytes} "
                           f"bytes of shared memory)")
    LAUNCHES += 1
    out = taps, regs_f, tuple(casc_raw), tuple(rings)
    return (out, tuple(rec.unbind(0))) if record else out
