"""Wrapper of the reverse chain kernel (csrc/chain_reverse_kernel.cu):
pack, bind, launch.

The kernel is the vjp of a chain segment (ops/chain_segment.py): the
counterpart of the program XLA compiles for the JAX package's
``_segment_vjp`` (dsp_stuff_tpu/ops/chain_segment.py:246, whose bwd is
jax.vjp of its segment_fallback).  It is CUDA C++ for sm_90a, built by
ops/cuda_build.py at first use and bound with ``ctypes`` through a plain
C entry point.  Nothing is imported, built or loaded when this module is
imported.

It takes the forward's stage program (ops/chain_kernel.plan and
pack_program, the same header and stage records; a shaper's record holds
its ordinal, chebyshev's also its two denominators) with its own cascade
and ring records: per cascade the forward's packed constants, the running
carry adjoint, the state's gradient and the seeds of the info cotangents;
per comb or mtap its ring, the new history's cotangent and the history's
gradient (an mtap also its trajectory operands).  The tap pointers are the
taps' cotangents, the record pointers the shapers' inputs that the
forward's record build wrote.

``chain_reverse_call`` takes only CUDA tensors and raises on anything the
kernel cannot take; there is no fallback.  Its plain PyTorch version is
ops/chain_segment.segment_adjoint.  ``LAUNCHES`` counts the kernel's
launches.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from dsp_stuff_tpu_torch.ops import chain_kernel, cuda_build
from dsp_stuff_tpu_torch.ops.chain_kernel import C, M_TILE, NS

#: launches of the kernel in this process (a test or a smoke run resets it)
LAUNCHES = 0
#: dynamic shared memory of a CTA beside the mtap's run starts: two tiles
#: [64][132], the carry buffers [2][64][12] and the row h [2][136], f32
SMEM_BASE = 4 * (2 * M_TILE * 132 + 2 * M_TILE * 12 + 2 * 136)
#: shared memory a CTA may take on the card the kernel is built for
#: (sm_90a: 227 KiB)
SMEM_MAX = 232_448

# The cascade and ring records, mirrored field for field by
# csrc/chain_reverse_kernel.cu (CrvCasc, CrvRing).
CASC = np.dtype([(f, "<u8") for f in ("hp", "w", "ecb", "act", "gcarry",
                                      "g_state", "seed_x", "seed_c")])
RING = np.dtype([(f, "<u8") for f in ("ring", "ct_hist", "g_hist", "mq",
                                      "mr", "mfr")]
                + [("n", "<i4"), ("nh", "<i4"), ("pad", "<u8")])


@functools.lru_cache(maxsize=2)
def _lib(defines: tuple = ()) -> ctypes.CDLL:
    """The reverse kernel's library built with ``defines``, bound: its
    argument types set, its record sizes and layout checked against this
    module's."""
    lib = cuda_build.load("chain_reverse_kernel", defines)
    for name in ("chain_reverse_abi", "chain_reverse_shape"):
        getattr(lib, name).restype = ctypes.c_int
    lib.chain_reverse_shape.argtypes = [ctypes.c_int]
    lib.chain_reverse_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]
    lib.chain_reverse_launch.restype = ctypes.c_int
    want = (chain_kernel.HEADER.itemsize | chain_kernel.STAGE.itemsize << 8
            | CASC.itemsize << 16 | RING.itemsize << 24)
    if lib.chain_reverse_abi() != want:
        raise RuntimeError(
            f"reverse chain kernel ABI mismatch: the library's record sizes "
            f"are {lib.chain_reverse_abi():#x}, the packer's {want:#x}")
    shape = (lib.chain_reverse_shape(0), lib.chain_reverse_shape(1))
    if shape != (M_TILE, SMEM_BASE):
        raise RuntimeError(f"reverse chain kernel built with layout {shape}, "
                           f"the wrapper's {(M_TILE, SMEM_BASE)}")
    return lib


def reverse_records(stages: tuple):
    """The forward's stage records (``chain_kernel.plan``) for the
    reverse: chebyshev's two denominators (its plain version's
    ``_tanh(_safe_level(level))``) in p[2], p[3].  Returns (records,
    counts)."""
    from dsp_stuff_tpu_torch.ops.cycle_segment import _tanh20
    records, counts = chain_kernel.plan(tuple(stages))
    for r, st in zip(records, stages):
        if st[0] == "ew" and st[1] == "chebyshev":
            r["p"][2:] = [_tanh20(float(np.float32(v))) for v in st[2]]
    return records, counts


def run_span(stages: tuple) -> int:
    """The ints of shared memory the mtap stages' run starts take: the
    largest (NH + 1) * 128 + 64 * 128 of them, 0 with no mtap."""
    return max(((int(st[3]) + 1) * C + M_TILE * C for st in stages
                if st[0] == "mtap"), default=0)


def _check(t, shape, dev, what: str):
    """``t`` (or None) as the kernel reads it: a contiguous float32 CUDA
    tensor of ``shape`` on ``dev``, 16-byte aligned; raises otherwise."""
    if t is None:
        return None
    if (not isinstance(t, torch.Tensor) or tuple(t.shape) != tuple(shape)
            or t.dtype != torch.float32 or t.device != dev
            or not t.is_contiguous()):
        got = (f"{t.dtype} {tuple(t.shape)} on {t.device}"
               if isinstance(t, torch.Tensor) else type(t).__name__)
        raise ValueError(f"reverse chain kernel: {what} must be a contiguous "
                         f"float32 {list(shape)} tensor on {dev}, got {got}")
    return chain_kernel.aligned(t)


def chain_reverse_call(ct_y, ct_taps: tuple, seeds: tuple, ct_hists: tuple,
                       recs: tuple, stages: tuple, shared: tuple, B: int,
                       T: int, dev):
    """The vjp of a chain segment over B rows of T samples (T % 128 == 0)
    on ``dev``: ct_y [B, T] (y's cotangent), ct_taps per tap [B, T], seeds
    per cascade (the last block's input seed [B, 128], the seed of the
    carry entering it [B, N]; cycle_segment.cinfo_seeds), ct_hists per
    comb [B, D] and per mtap [B, L] in stage order, each None where there
    is no cotangent; recs per ``ew`` stage its input [B, T] (the forward's
    record build); shared the mtap trajectory operands (q, r, frac) of
    each mtap, in order -> (x's gradient [B, T], per stateful stage in
    order its state's gradient: a cascade's [B, 8] (its carry lanes), a
    history's [B, D] or [B, L])."""
    global LAUNCHES
    stages = tuple(stages)
    records, (n_casc, n_ring, n_tap) = reverse_records(stages)
    n_ew = sum(1 for st in stages if st[0] == "ew")
    if not isinstance(dev, torch.device) or dev.type != "cuda":
        raise ValueError(f"reverse chain kernel: needs a CUDA device, got "
                         f"{dev}")
    if B < 1 or T < C or T % C:
        raise ValueError(f"reverse chain kernel: T={T} must be a positive "
                         f"multiple of {C}; B={B} must be >= 1")
    n_mtap = sum(1 for st in stages if st[0] == "mtap")
    if (len(ct_taps), len(seeds), len(ct_hists), len(recs), len(shared)) != (
            n_tap, n_casc, n_ring, n_ew, 3 * n_mtap):
        raise ValueError(
            f"reverse chain kernel: {len(ct_taps)} tap, {len(seeds)} cascade "
            f"and {len(ct_hists)} history cotangents, {len(recs)} recorded "
            f"inputs and {len(shared)} trajectory operands for a list of "
            f"{n_tap}, {n_casc}, {n_ring}, {n_ew} and {3 * n_mtap}")
    if any(r is None for r in recs):
        raise ValueError("reverse chain kernel: every shaper's input must be "
                         "recorded")
    span = run_span(stages)
    if SMEM_BASE + 4 * span > SMEM_MAX:
        raise ValueError(f"reverse chain kernel: an mtap ring of "
                         f"{span - M_TILE * C} samples needs "
                         f"{SMEM_BASE + 4 * span} bytes of shared memory, "
                         f"past the card's {SMEM_MAX}")

    def ptr(t):
        return 0 if t is None else t.data_ptr()

    keep = []                     # what the kernel reads, alive until queued
    casc_recs, ring_recs, g_states = [], [], []
    ci = hi = mi = 0
    for st in stages:
        if st[0] == "cascade":
            consts, offs, N = chain_kernel._casc_tile_device(st[1], dev)
            sx, sc = seeds[ci]
            sx = _check(sx, (B, C), dev, f"cascade {ci}'s input seed")
            sc8 = None
            if sc is not None:
                sc8 = torch.zeros((B, NS), dtype=torch.float32, device=dev)
                sc8[:, :N] = _check(sc, (B, N), dev,
                                    f"cascade {ci}'s carry seed")
            gcarry = torch.zeros((B, NS), dtype=torch.float32, device=dev)
            g_s = torch.empty((B, NS), dtype=torch.float32, device=dev)
            base = consts.data_ptr()
            casc_recs.append(tuple(base + 4 * o for o in offs) + (
                gcarry.data_ptr(), g_s.data_ptr(), ptr(sx), ptr(sc8)))
            keep += [consts, sx, sc8, gcarry]
            g_states.append(g_s)
            ci += 1
        elif st[0] in ("comb", "mtap"):
            n = int(st[2])
            cth = _check(ct_hists[hi], (B, n), dev,
                         f"history {hi}'s cotangent")
            g_h = torch.empty((B, n), dtype=torch.float32, device=dev)
            if st[0] == "comb":
                ring = torch.zeros((B, -(-n // C) * C), dtype=torch.float32,
                                   device=dev)
                ring_recs.append((ring.data_ptr(), ptr(cth), g_h.data_ptr(),
                                  0, 0, 0, n, 0))
            else:
                NH = int(st[3])
                ring = torch.zeros((B, 2, (NH + 1) * C), dtype=torch.float32,
                                   device=dev)
                q, r, fr = (chain_kernel._shared_operand(t, shp, dt, dev, w)
                            for t, shp, dt, w in zip(
                                shared[3 * mi:3 * mi + 3],
                                ((T // C,), (T,), (T,)),
                                (torch.int32, torch.int32, torch.float32),
                                ("q", "r", "frac")))
                ring_recs.append((ring.data_ptr(), ptr(cth), g_h.data_ptr(),
                                  q.data_ptr(), r.data_ptr(), fr.data_ptr(),
                                  n, NH))
                keep += [q, r, fr]
                mi += 1
            keep += [ring, cth]
            g_states.append(g_h)
            hi += 1
    taps = [_check(t, (B, T), dev, f"tap {i}'s cotangent")
            for i, t in enumerate(ct_taps)]
    recs = [_check(r, (B, T), dev, f"shaper {i}'s input")
            for i, r in enumerate(recs)]
    keep += taps + recs
    ybar = (torch.zeros((B, T), dtype=torch.float32, device=dev)
            if ct_y is None else _check(ct_y, (B, T), dev, "y's cotangent"))
    prog = chain_kernel.to_device(chain_kernel.pack_program(
        records, casc_recs, ring_recs, [ptr(t) for t in taps],
        [r.data_ptr() for r in recs], CASC, RING), dev)
    grid, ctas = chain_kernel.geometry(B, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    gx = torch.empty((B, T), dtype=torch.float32, device=dev)
    rc = _lib().chain_reverse_launch(
        prog.data_ptr(), ybar.data_ptr(), gx.data_ptr(), grid, T, ctas, span,
        dev.index, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"reverse chain kernel launch failed: CUDA error "
                           f"{rc} ({SMEM_BASE + 4 * span} bytes of shared "
                           f"memory)")
    LAUNCHES += 1
    return gx, tuple(g_states)
