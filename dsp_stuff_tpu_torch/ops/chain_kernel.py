"""Wrapper of the chain kernel (csrc/chain_kernel.cu): bind and launch.

The kernel replaces dsp_stuff_tpu/ops/pallas_chain.py:chain_kernel_call,
every stage included (cascade, scale, ew, tap, comb and the chorus's
mtap).  It is CUDA C++ for sm_90a, built by ops/cuda_build.py at first
use and bound with ``ctypes`` through a plain C entry point.  Nothing is
imported, built or loaded when this module is imported.

``chain_kernel_call`` takes only CUDA tensors and raises on anything the
kernel cannot take; there is no fallback.  The plain PyTorch version of
the same function is ops/chain_segment.segment_fallback.  ``LAUNCHES``
counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from dsp_stuff_tpu_torch.ops import cuda_build

C = 128        # samples per block
NS = 8         # padded carry lanes (cascade.MAX_RUN_DIM embeds <= 8)
MAX_STAGES = 32
MAX_CASC = 8
MAX_RING = 8   # comb and mtap rings together
MAX_TAP = 8

#: elementwise stage kinds in the kernel's EW_* code order (csrc/stages.cuh)
EW_CODES = ("overdrive", "chebyshev", "distort:HardClip", "distort:SoftClip",
            "distort:Tanh", "distort:RecipSoftClip", "distort:Fuzz",
            "distort:Sin", "distort:Atan", "distort:Square",
            "distort:Chebyshev4")
_KIND = {"cascade": 0, "scale": 1, "ew": 2, "tap": 3, "comb": 4, "mtap": 5}

#: launches of the kernel in this process (a test or a smoke run resets it)
LAUNCHES = 0


class _Stage(ctypes.Structure):
    _fields_ = [("kind", ctypes.c_int), ("idx", ctypes.c_int),
                ("n", ctypes.c_int), ("p", ctypes.c_float * 3)]


class _Program(ctypes.Structure):
    _fields_ = [("n_stages", ctypes.c_int), ("pad_", ctypes.c_int),
                ("st", _Stage * MAX_STAGES),
                ("ltg", ctypes.c_void_p * MAX_CASC),
                ("w", ctypes.c_void_p * MAX_CASC),
                ("ecb", ctypes.c_void_p * MAX_CASC),
                ("act", ctypes.c_void_p * MAX_CASC),
                ("s0", ctypes.c_void_p * MAX_CASC),
                ("carry_out", ctypes.c_void_p * MAX_CASC),
                ("xlast_out", ctypes.c_void_p * MAX_CASC),
                ("ring", ctypes.c_void_p * MAX_RING),
                ("mq", ctypes.c_void_p * MAX_RING),
                ("mr", ctypes.c_void_p * MAX_RING),
                ("mfr", ctypes.c_void_p * MAX_RING),
                ("tap", ctypes.c_void_p * MAX_TAP)]


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("chain_kernel")
    lib.chain_kernel_abi.argtypes = []
    lib.chain_kernel_abi.restype = ctypes.c_int
    lib.chain_kernel_launch.argtypes = [
        ctypes.POINTER(_Program), ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.chain_kernel_launch.restype = ctypes.c_int
    if lib.chain_kernel_abi() != ctypes.sizeof(_Program):
        raise RuntimeError(
            f"chain kernel ABI mismatch: the library's program struct is "
            f"{lib.chain_kernel_abi()} bytes, ctypes' "
            f"{ctypes.sizeof(_Program)}")
    return lib


@functools.lru_cache(maxsize=64)
def _casc_consts(sections: tuple):
    """(Ltg [C,C], W [C,NS], Ecb [NS,C], ACt [NS,NS], N) f32 NumPy for one
    cascade stage, padded to the NS-lane carry layout (rows >= N of Ecb
    and ACt are zero)."""
    from dsp_stuff_tpu_torch.ops.cascade import _cascade_constants
    Ltg, W, E, P, N, _B, _l1, _ = _cascade_constants(sections, C, ())
    Wp = np.zeros((C, NS), np.float32)
    Wp[:, :N] = W
    Ecb = np.zeros((NS, C), np.float32)
    Ecb[:N, :] = E.T
    ACt = np.zeros((NS, NS), np.float32)
    ACt[:N, :N] = P[C].astype(np.float32).T
    return Ltg, Wp, Ecb, ACt, N


@functools.lru_cache(maxsize=64)
def _casc_device_consts(sections: tuple, device: torch.device):
    """The cascade constants as contiguous f32 tensors on ``device``."""
    Ltg, Wp, Ecb, ACt, N = _casc_consts(sections)
    return tuple(torch.as_tensor(a, device=device).contiguous()
                 for a in (Ltg, Wp, Ecb, ACt)) + (N,)


def _check_stages(stages: tuple) -> None:
    counts = {"cascade": 0, "ring": 0, "tap": 0}
    for st in stages:
        if st[0] not in _KIND:
            raise ValueError(f"chain kernel: unknown stage {st[0]!r}")
        if st[0] == "ew" and st[1] not in EW_CODES:
            raise ValueError(f"chain kernel: unknown shaper {st[1]!r}")
        kind = "ring" if st[0] in ("comb", "mtap") else st[0]
        if kind in counts:
            counts[kind] += 1
    if len(stages) > MAX_STAGES:
        raise ValueError(f"chain kernel: {len(stages)} stages > {MAX_STAGES}")
    for kind, cap in (("cascade", MAX_CASC), ("ring", MAX_RING),
                      ("tap", MAX_TAP)):
        if counts[kind] > cap:
            raise ValueError(f"chain kernel: {counts[kind]} {kind} stages "
                             f"> {cap}")


def _seeded_ring(hist, B: int, n: int, RL: int, dev, what: str):
    """A [B, RL] ring holding ``hist`` [B, n] in its last n samples:
    linear position p is the sample at time p - RL (mod RL)."""
    if hist.shape != (B, n) or hist.device != dev:
        raise ValueError(f"kernel {what} must be [{B}, {n}] on {dev}, got "
                         f"{tuple(hist.shape)} on {hist.device}")
    ring = torch.zeros((B, RL), dtype=torch.float32, device=dev)
    ring[:, RL - n:] = hist
    return ring


def _shared_operand(t, shape, dtype, dev, what: str):
    if (not isinstance(t, torch.Tensor) or t.shape != shape
            or t.dtype != dtype or t.device != dev):
        got = (f"{t.dtype} {tuple(t.shape)} on {t.device}"
               if isinstance(t, torch.Tensor) else type(t).__name__)
        raise ValueError(f"chain kernel: mtap {what} must be {dtype} "
                         f"{tuple(shape)} on {dev}, got {got}")
    return t.contiguous()


def chain_kernel_call(x: torch.Tensor, stages: tuple, state_in: tuple):
    """x [B, T] f32 CUDA, contiguous, T % 128 == 0 -> (y [B, T],
    per-cascade (carry_last [B, NS], x_last [B, C]),
    per-comb or mtap ring [B, NR, C] in stage order,
    per-tap emitted sequence [B, T]).

    ``state_in`` holds, per stateful stage in order: for a cascade the
    composite state [B, N]; for a comb the history [B, D]; for an mtap
    four entries, the input history [B, L] and the shared trajectory
    operands q [T/128] int32, r [T] int32 and frac [T] float32
    (modfx.mtap_shared)."""
    global LAUNCHES
    stages = tuple(stages)
    _check_stages(stages)
    if not (isinstance(x, torch.Tensor) and x.is_cuda):
        raise ValueError("chain kernel: x must be a CUDA tensor")
    if x.dtype != torch.float32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"chain kernel: x must be a contiguous [B, T] "
                         f"float32 tensor, got {x.dtype} {tuple(x.shape)}")
    B, T = x.shape
    if B < 1 or T < C or T % C:
        raise ValueError(f"chain kernel: T={T} must be a positive multiple "
                         f"of {C}; B={B} must be >= 1")
    n_state = sum({"cascade": 1, "comb": 1, "mtap": 4}.get(st[0], 0)
                  for st in stages)
    if len(state_in) != n_state:
        raise ValueError(f"chain kernel: {len(state_in)} state entries for "
                         f"the stages' {n_state}")

    dev = x.device
    prog = _Program()
    prog.n_stages = len(stages)
    casc_raw, rings, taps = [], [], []
    si = 0
    for k, st in enumerate(stages):
        s = prog.st[k]
        s.kind = _KIND[st[0]]
        if st[0] == "cascade":
            ci = len(casc_raw)
            Ltg, Wp, Ecb, ACt, N = _casc_device_consts(st[1], dev)
            s0 = state_in[si]
            si += 1
            if s0.shape != (B, N) or s0.device != dev:
                raise ValueError(f"chain kernel: cascade state must be "
                                 f"[{B}, {N}] on {dev}, got "
                                 f"{tuple(s0.shape)} on {s0.device}")
            s0p = torch.zeros((B, NS), dtype=torch.float32, device=dev)
            s0p[:, :N] = s0
            carry_out = torch.empty((B, NS), dtype=torch.float32, device=dev)
            xlast = torch.empty((B, C), dtype=torch.float32, device=dev)
            s.idx, s.n = ci, N
            prog.ltg[ci], prog.w[ci] = Ltg.data_ptr(), Wp.data_ptr()
            prog.ecb[ci], prog.act[ci] = Ecb.data_ptr(), ACt.data_ptr()
            prog.s0[ci] = s0p.data_ptr()
            prog.carry_out[ci] = carry_out.data_ptr()
            prog.xlast_out[ci] = xlast.data_ptr()
            casc_raw.append((carry_out, xlast))
        elif st[0] == "comb":
            bi = len(rings)
            D = int(st[2])
            if D < 1:
                raise ValueError(f"chain kernel: comb delay {D} < 1")
            RL = -(-D // C) * C
            ring = _seeded_ring(state_in[si], B, D, RL, dev, "comb history")
            si += 1
            s.idx, s.n = bi, D
            s.p[0] = float(np.float32(st[1]))
            prog.ring[bi] = ring.data_ptr()
            rings.append(ring.view(B, RL // C, C))
        elif st[0] == "mtap":
            bi = len(rings)
            _, mix, L, NH, _EV, _RS = st
            L, NH = int(L), int(NH)
            if L < 1 or NH != -(-L // C):
                raise ValueError(f"chain kernel: mtap NH={NH} must be "
                                 f"ceil(L/{C}) for L={L}")
            RL = (NH + 1) * C
            ring = _seeded_ring(state_in[si], B, L, RL, dev, "mtap history")
            q = _shared_operand(state_in[si + 1], (T // C,), torch.int32,
                                dev, "q")
            r = _shared_operand(state_in[si + 2], (T,), torch.int32, dev, "r")
            fr = _shared_operand(state_in[si + 3], (T,), torch.float32, dev,
                                 "frac")
            si += 4
            s.idx, s.n = bi, NH
            s.p[0] = float(np.float32(mix))
            prog.ring[bi] = ring.data_ptr()
            prog.mq[bi], prog.mr[bi], prog.mfr[bi] = (
                q.data_ptr(), r.data_ptr(), fr.data_ptr())
            rings.append(ring.view(B, NH + 1, C))
        elif st[0] == "tap":
            ti = int(st[1])
            if not 0 <= ti < MAX_TAP:
                raise ValueError(f"chain kernel: tap index {ti}")
            while len(taps) <= ti:
                taps.append(None)
            taps[ti] = torch.empty((B, T), dtype=torch.float32, device=dev)
            s.idx = ti
            prog.tap[ti] = taps[ti].data_ptr()
        elif st[0] == "scale":
            s.p[0] = float(np.float32(st[1]))
        else:                                   # ew
            s.idx = EW_CODES.index(st[1])
            for j, pv in enumerate(st[2]):
                s.p[j] = float(np.float32(pv))
    if any(t is None for t in taps):
        raise ValueError("chain kernel: tap indices must be 0..n_taps-1")
    y = torch.empty_like(x)
    rc = _lib().chain_kernel_launch(
        ctypes.byref(prog), x.data_ptr(), y.data_ptr(), B, T,
        dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"chain kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return y, tuple(casc_raw), tuple(rings), tuple(taps)
