"""Wrapper of the cycle kernel (csrc/cycle_kernel.cu): pack, bind, launch.

The kernel replaces dsp_stuff_tpu/ops/pallas_cycle.py:cycle_kernel_call:
a feedback SCC's block program (ops/cycle_segment.py) over a whole
render, with registers, cascade carries and comb rings kept on the card.
It is CUDA C++ for sm_90a, built by ops/cuda_build.py at first use and
bound with ``ctypes``.  Nothing is imported, built or loaded when this
module is imported.

The program goes to the card packed (``pack_program``): a header, the
instruction records, the join terms and the pointer tables, sized from
the program and copied once per call, so the kernel has no fixed
program capacity.

``cycle_kernel_call`` takes only CUDA tensors and raises on anything the
kernel cannot take; there is no fallback.  The plain PyTorch version of
the same function is ops/cycle_segment.interpret.  ``LAUNCHES`` counts
the kernel's launches.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from dsp_stuff_tpu_torch.ops import cuda_build
from dsp_stuff_tpu_torch.ops.chain_kernel import (C, EW_CODES, NS,
                                                  _casc_consts,
                                                  _casc_device_consts,
                                                  _seeded_ring, to_device)

_REG = 0x10000
_OPS = {"join": 0, "lin2": 1, "cascade": 2, "comb": 3, "ew": 4, "scale": 5,
        "setreg": 6, "tap": 7}

#: launches of the kernel in this process (a test or a smoke run resets it)
LAUNCHES = 0

# The packed program's records, mirrored field for field by
# csrc/cycle_kernel.cu (CyHeader, CyIns, CyCasc).
HEADER = np.dtype([("n_ins", "<i4"), ("n_regs", "<i4"), ("n_casc", "<i4"),
                   ("n_comb", "<i4")]
                  + [(f"off_{f}", "<i8") for f in (
                      "ins", "terms", "ext", "tap", "reg0", "reg_out",
                      "casc", "ring")])
INS = np.dtype([("op", "<i4"), ("idx", "<i4"), ("n", "<i4"), ("ta", "<i4"),
                ("na", "<i4"), ("tb", "<i4"), ("nb", "<i4"), ("pad", "<i4"),
                ("p", "<f4", (4,))])
CASC = np.dtype([(f, "<u8") for f in ("ltg", "w", "ecb", "act", "s0",
                                      "carry_out", "xlast_out", "pad")])
#: the pointer tables after the terms, in order
_TABLES = ("ext", "tap", "reg0", "reg_out", "casc", "ring")


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("cycle_kernel")
    lib.cycle_kernel_abi.argtypes = []
    lib.cycle_kernel_abi.restype = ctypes.c_int
    lib.cycle_kernel_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.cycle_kernel_launch.restype = ctypes.c_int
    want = HEADER.itemsize | INS.itemsize << 8 | CASC.itemsize << 16
    if lib.cycle_kernel_abi() != want:
        raise RuntimeError(
            f"cycle kernel ABI mismatch: the library's record sizes are "
            f"{lib.cycle_kernel_abi():#x}, the packer's {want:#x}")
    return lib


def _f32(v) -> float:
    return float(np.float32(v))


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
    """The instruction records and join terms of a block program, checked:
    (INS array, int32 terms, (n_casc, n_comb, n_regs, n_taps, n_exts)).
    Raises on what the kernel cannot take; pointers come later
    (``pack_program``)."""
    from dsp_stuff_tpu_torch.ops.cycle_segment import _program_counts
    program = tuple(program)
    counts = _program_counts(program)
    n_r = counts[2]
    rec = np.zeros(len(program), INS)
    terms: list[int] = []

    def add_terms(ts) -> tuple[int, int]:
        if not ts:
            raise ValueError("cycle kernel: a join needs at least one term")
        start = len(terms)
        for kind, j in ts:
            if kind == "ext" and 0 <= j < _REG:
                terms.append(int(j))
            elif kind == "reg" and 0 <= j < n_r:
                terms.append(_REG | int(j))
            else:
                raise ValueError(f"cycle kernel: bad term {(kind, j)!r} "
                                 f"for {n_r} registers")
        return start, len(ts)

    n_casc = n_comb = 0
    for k, ins in enumerate(program):
        op = ins[0]
        if op not in _OPS:
            raise ValueError(f"cycle kernel: unknown instruction {op!r}")
        r = rec[k]
        r["op"] = _OPS[op]
        if op == "join":
            r["ta"], r["na"] = add_terms(ins[1])
            r["p"][0] = np.float32(ins[2])
        elif op == "lin2":
            _, tA, sA, tB, sB, cA, cB = ins
            r["ta"], r["na"] = add_terms(tA)
            r["tb"], r["nb"] = add_terms(tB)
            r["p"][:] = np.asarray((sA, sB, cA, cB), np.float32)
        elif op == "cascade":
            if ins[2] != n_casc:
                raise ValueError("cycle kernel: cascade indices must count "
                                 "up from 0 in program order")
            r["idx"], r["n"] = n_casc, _casc_consts(ins[1])[4]
            n_casc += 1
        elif op == "comb":
            _, decay, D, bi = ins
            D = int(D)
            if bi != n_comb or D < C:
                raise ValueError(f"cycle kernel: comb {bi} (D={D}) must have "
                                 f"D >= {C} and indices counting up from 0")
            r["idx"], r["n"] = n_comb, D
            r["p"][0] = np.float32(decay)
            n_comb += 1
        elif op == "ew":
            if ins[1] not in EW_CODES:
                raise ValueError(f"cycle kernel: unknown shaper {ins[1]!r}")
            r["idx"] = EW_CODES.index(ins[1])
            r["p"][:len(ins[2])] = np.asarray(ins[2], np.float32)
        elif op == "scale":
            r["p"][0] = np.float32(ins[1])
        else:                                   # setreg, tap
            r["idx"] = int(ins[1])
    return rec, np.asarray(terms, np.int32), counts


def _align(n: int) -> int:
    return -(-n // 16) * 16


def layout(n_ins: int, n_terms: int, sizes: dict):
    """Byte offsets of the packed program's sections (ins, terms, then the
    pointer tables of ``_TABLES`` with ``sizes`` entries each) and its
    end, each 16-byte aligned."""
    offs = {"ins": _align(HEADER.itemsize)}
    offs["terms"] = _align(offs["ins"] + n_ins * INS.itemsize)
    end = offs["terms"] + 4 * n_terms
    for name in _TABLES:
        offs[name] = _align(end)
        end = offs[name] + (CASC.itemsize if name == "casc" else 8) * sizes[
            name]
    return offs, _align(end)


def pack_program(records, terms, n_regs: int, tables: dict) -> np.ndarray:
    """The packed program, a uint8 array: the header, ``records`` and
    ``terms`` (from ``plan``), then the pointer tables: ``tables`` maps
    each name of ``_TABLES`` to its pointers (integers; for "casc" one
    7-tuple ltg, w, ecb, act, s0, carry_out, xlast_out per cascade)."""
    sizes = {k: len(tables[k]) for k in _TABLES}
    offs, end = layout(len(records), len(terms), sizes)
    buf = np.zeros(end, np.uint8)
    hdr = np.zeros((), HEADER)
    hdr["n_ins"], hdr["n_regs"] = len(records), n_regs
    hdr["n_casc"], hdr["n_comb"] = sizes["casc"], sizes["ring"]
    for name, o in offs.items():
        hdr[f"off_{name}"] = o

    def put(off, arr):
        raw = np.frombuffer(np.ascontiguousarray(arr).tobytes(), np.uint8)
        buf[off:off + raw.size] = raw

    put(0, hdr)
    put(offs["ins"], np.asarray(records, INS))
    put(offs["terms"], np.asarray(terms, np.int32))
    for name in _TABLES:
        if name == "casc":
            arr = np.zeros(sizes[name], CASC)
            for i, p in enumerate(tables[name]):
                arr[i] = tuple(p) + (0,)
        else:
            arr = np.asarray(tables[name], np.uint64)
        put(offs[name], arr)
    return buf


def cycle_kernel_call(exts: tuple, regs0: tuple, states: tuple,
                      program: tuple, n_taps: int):
    """exts: n_e x [B, T] f32 CUDA (T % 128 == 0); regs0: n_r x [B, 128];
    states: per cascade [B, N], per comb [B, D], in program order ->
    (taps n_t x [B, T], regs_f n_r x [B, 128],
     per cascade (carry_last [B, 8], x_last [B, 128]),
     per comb ring [B, NR, 128])."""
    global LAUNCHES
    program = tuple(program)
    # the program is checked and packed first, whatever the tensors
    records, terms, (n_c, n_b, n_r, n_t, n_e) = plan(program)
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
    si = 0
    for ins in program:
        if ins[0] == "cascade":
            Ltg, Wp, Ecb, ACt, N = _casc_device_consts(ins[1], dev)
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
            tables["casc"].append(tuple(t.data_ptr() for t in (
                Ltg, Wp, Ecb, ACt, s0p, carry_out, xlast)))
            keep.append(s0p)
            casc_raw.append((carry_out, xlast))
        elif ins[0] == "comb":
            D = int(ins[2])
            RL = -(-D // C) * C
            ring = _seeded_ring(states[si], B, D, RL, dev, "comb history")
            si += 1
            tables["ring"].append(ring.data_ptr())
            rings.append(ring.view(B, RL // C, C))

    buf = pack_program(records, terms, n_r, tables)
    prog = to_device(buf, dev)
    rc = _lib().cycle_kernel_launch(
        prog.data_ptr(), buf.size, n_r, n_c, B, T, dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"cycle kernel launch failed: CUDA error {rc} "
                           f"(a program of {buf.size} bytes, {n_r} "
                           f"registers, {n_c} cascades)")
    LAUNCHES += 1
    return taps, regs_f, tuple(casc_raw), tuple(rings)
