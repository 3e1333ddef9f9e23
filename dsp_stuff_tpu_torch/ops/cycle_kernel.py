"""Wrapper of the cycle kernel (csrc/cycle_kernel.cu): bind and launch.

The kernel replaces dsp_stuff_tpu/ops/pallas_cycle.py:cycle_kernel_call:
a feedback SCC's block program (ops/cycle_segment.py) over a whole
render, with registers, cascade carries and comb rings kept on the card.
It is CUDA C++ for sm_90a, built by ops/cuda_build.py at first use and
bound with ``ctypes``.  Nothing is imported, built or loaded when this
module is imported.

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
                                                  _casc_device_consts,
                                                  _seeded_ring)

MAX_INS = 32
MAX_TERMS = 32
MAX_EXT = 8
MAX_REG = 8
MAX_TAP = 8
MAX_CASC = 8
MAX_COMB = 8
_REG = 0x10000
_OPS = {"join": 0, "lin2": 1, "cascade": 2, "comb": 3, "ew": 4, "scale": 5,
        "setreg": 6, "tap": 7}

#: launches of the kernel in this process (a test or a smoke run resets it)
LAUNCHES = 0


class _Ins(ctypes.Structure):
    _fields_ = [("op", ctypes.c_int), ("idx", ctypes.c_int),
                ("n", ctypes.c_int), ("ta", ctypes.c_int),
                ("na", ctypes.c_int), ("tb", ctypes.c_int),
                ("nb", ctypes.c_int), ("pad_", ctypes.c_int),
                ("p", ctypes.c_float * 4)]


class _Program(ctypes.Structure):
    _fields_ = [("n_ins", ctypes.c_int), ("n_regs", ctypes.c_int),
                ("ins", _Ins * MAX_INS),
                ("terms", ctypes.c_int * MAX_TERMS),
                ("ext", ctypes.c_void_p * MAX_EXT),
                ("tap", ctypes.c_void_p * MAX_TAP),
                ("reg0", ctypes.c_void_p * MAX_REG),
                ("reg_out", ctypes.c_void_p * MAX_REG),
                ("ltg", ctypes.c_void_p * MAX_CASC),
                ("w", ctypes.c_void_p * MAX_CASC),
                ("ecb", ctypes.c_void_p * MAX_CASC),
                ("act", ctypes.c_void_p * MAX_CASC),
                ("s0", ctypes.c_void_p * MAX_CASC),
                ("carry_out", ctypes.c_void_p * MAX_CASC),
                ("xlast_out", ctypes.c_void_p * MAX_CASC),
                ("ring", ctypes.c_void_p * MAX_COMB)]


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("cycle_kernel")
    lib.cycle_kernel_abi.argtypes = []
    lib.cycle_kernel_abi.restype = ctypes.c_int
    lib.cycle_kernel_launch.argtypes = [
        ctypes.POINTER(_Program), ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]
    lib.cycle_kernel_launch.restype = ctypes.c_int
    if lib.cycle_kernel_abi() != ctypes.sizeof(_Program):
        raise RuntimeError(
            f"cycle kernel ABI mismatch: the library's program struct is "
            f"{lib.cycle_kernel_abi()} bytes, ctypes' "
            f"{ctypes.sizeof(_Program)}")
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


def cycle_kernel_call(exts: tuple, regs0: tuple, states: tuple,
                      program: tuple, n_taps: int):
    """exts: n_e x [B, T] f32 CUDA (T % 128 == 0); regs0: n_r x [B, 128];
    states: per cascade [B, N], per comb [B, D], in program order ->
    (taps n_t x [B, T], regs_f n_r x [B, 128],
     per cascade (carry_last [B, 8], x_last [B, 128]),
     per comb ring [B, NR, 128])."""
    global LAUNCHES
    from dsp_stuff_tpu_torch.ops.cycle_segment import _program_counts
    program = tuple(program)
    n_c, n_b, n_r, n_t, n_e = _program_counts(program)
    n_terms = sum(len(ins[1]) if ins[0] == "join"
                  else len(ins[1]) + len(ins[3]) if ins[0] == "lin2" else 0
                  for ins in program)
    # the capacity is checked first, whatever the tensors: a program the
    # planner lowers may exceed it, and the kernel refuses it on any device
    if (len(program) > MAX_INS or n_terms > MAX_TERMS or n_e > MAX_EXT
            or n_r > MAX_REG or n_t > MAX_TAP or n_c > MAX_CASC
            or n_b > MAX_COMB):
        raise ValueError(
            f"cycle kernel: the program ({len(program)} instructions, "
            f"{n_terms} join terms, {n_e} feeds, {n_r} registers, {n_t} "
            f"taps, {n_c} cascades, {n_b} combs) exceeds the kernel's "
            f"capacity ({MAX_INS}, {MAX_TERMS}, {MAX_EXT}, {MAX_REG}, "
            f"{MAX_TAP}, {MAX_CASC}, {MAX_COMB})")
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

    prog = _Program()
    prog.n_ins = len(program)
    prog.n_regs = n_r
    for i, e in enumerate(exts):
        prog.ext[i] = _rows(e, B, T, dev, f"feed {i}").data_ptr()
    taps = tuple(torch.empty((B, T), dtype=torch.float32, device=dev)
                 for _ in range(n_t))
    for i, t in enumerate(taps):
        prog.tap[i] = t.data_ptr()
    regs_f = tuple(torch.empty((B, C), dtype=torch.float32, device=dev)
                   for _ in range(n_r))
    for i, (r0, rf) in enumerate(zip(regs0, regs_f)):
        prog.reg0[i] = _rows(r0, B, C, dev, f"register {i}").data_ptr()
        prog.reg_out[i] = rf.data_ptr()

    terms: list[int] = []

    def add_terms(ts) -> tuple[int, int]:
        start = len(terms)
        for kind, j in ts:
            if kind == "ext":
                terms.append(int(j))
            elif kind == "reg" and 0 <= j < n_r:
                terms.append(_REG | int(j))
            else:
                raise ValueError(f"cycle kernel: bad term {(kind, j)!r} "
                                 f"for {n_r} registers")
        if not ts or len(terms) > MAX_TERMS:
            raise ValueError("cycle kernel: a join needs 1..32 terms in all")
        return start, len(ts)

    casc_raw, rings = [], []
    si = 0
    for k, ins in enumerate(program):
        I = prog.ins[k]
        op = ins[0]
        if op not in _OPS:
            raise ValueError(f"cycle kernel: unknown instruction {op!r}")
        I.op = _OPS[op]
        if op == "join":
            I.ta, I.na = add_terms(ins[1])
            I.p[0] = _f32(ins[2])
        elif op == "lin2":
            _, tA, sA, tB, sB, cA, cB = ins
            I.ta, I.na = add_terms(tA)
            I.tb, I.nb = add_terms(tB)
            I.p[0], I.p[1], I.p[2], I.p[3] = (_f32(sA), _f32(sB), _f32(cA),
                                              _f32(cB))
        elif op == "cascade":
            ci = len(casc_raw)
            if ins[2] != ci:
                raise ValueError("cycle kernel: cascade indices must count "
                                 "up from 0 in program order")
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
            I.idx, I.n = ci, N
            prog.ltg[ci], prog.w[ci] = Ltg.data_ptr(), Wp.data_ptr()
            prog.ecb[ci], prog.act[ci] = Ecb.data_ptr(), ACt.data_ptr()
            prog.s0[ci] = s0p.data_ptr()
            prog.carry_out[ci] = carry_out.data_ptr()
            prog.xlast_out[ci] = xlast.data_ptr()
            casc_raw.append((carry_out, xlast))
        elif op == "comb":
            _, decay, D, bi = ins
            D = int(D)
            if bi != len(rings) or D < C:
                raise ValueError(f"cycle kernel: comb {bi} (D={D}) must have "
                                 f"D >= {C} and indices counting up from 0")
            RL = -(-D // C) * C
            ring = _seeded_ring(states[si], B, D, RL, dev, "comb history")
            si += 1
            I.idx, I.n = len(rings), D
            I.p[0] = _f32(decay)
            prog.ring[len(rings)] = ring.data_ptr()
            rings.append(ring.view(B, RL // C, C))
        elif op == "ew":
            if ins[1] not in EW_CODES:
                raise ValueError(f"cycle kernel: unknown shaper {ins[1]!r}")
            I.idx = EW_CODES.index(ins[1])
            for j, pv in enumerate(ins[2]):
                I.p[j] = _f32(pv)
        elif op == "scale":
            I.p[0] = _f32(ins[1])
        else:                                   # setreg, tap
            I.idx = int(ins[1])
    prog.terms[:len(terms)] = terms

    rc = _lib().cycle_kernel_launch(
        ctypes.byref(prog), B, T, dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"cycle kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return taps, regs_f, tuple(casc_raw), tuple(rings)
