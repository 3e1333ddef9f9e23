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
pack_program, the same header and stage records; chebyshev's record also
holds its two denominators) with its own records: per cascade the
forward's packed constants with powers (ACt^T)^p of its carry
step (``casc_powers``), the state's gradient and the seeds of the info
cotangents; per comb or mtap its ring (a comb's in shared memory when it
fits), the new history's cotangent and the history's gradient (an mtap
also its window starts q); and the operand table (OP): every tile of a
shaper's record (the forward's record build), of a tap's cotangent and
of the mtap's r and frac, in the order the reverse walk uses them
(``operands``; a stage record's ``rec`` is its index), which the kernel
stages ahead into ``layout``'s slots of shared memory.  The kernel writes
every buffer it reads first, so nothing is allocated zeroed, and a
missing y cotangent is a null pointer.

``chain_reverse_call`` takes only CUDA tensors and raises on anything the
kernel cannot take; there is no fallback.  Its plain PyTorch version is
ops/chain_segment.segment_adjoint.  ``LAUNCHES`` counts the kernel's
launches.  ``phase_cycles`` runs the build with the kernel's phase probes
(tools/measure_torch_chain.py --reverse --phases).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from dsp_stuff_tpu_torch.ops import chain_kernel, cuda_build
from dsp_stuff_tpu_torch.ops.chain_kernel import C, M_TILE, NS
from dsp_stuff_tpu_torch.utils.capture import device_cache

#: the probes' PV_* order in csrc/chain_reverse_kernel.cu
PHASES = ("wait", "open", "product", "scan", "W^T", "ew loads", "ew math",
          "comb", "mtap starts", "mtap gather", "mtap write", "out")
#: launches of the kernel in this process (a test or a smoke run resets it)
LAUNCHES = 0
#: the powers (ACt^T)^p a cascade packs for the carry scan: its step over a
#: block, and the steps over 1, 2 and 4 chunks of CHUNK blocks
CHUNK = 8
POWERS = (1, CHUNK, 2 * CHUNK, 4 * CHUNK)
NPOW = len(POWERS)
#: a cascade's constants in shared memory: the row h [2][136], Ecb
#: [2][8][132] (rows padded) and the powers [4][8][8], f32
CONSTS_BYTES = 4 * (2 * 136 + 2 * NS * 132 + NPOW * NS * NS)
#: dynamic shared memory of a CTA before its carries, slots, rings,
#: resident constants and run starts: two tiles [64][132], the carry
#: buffers [2][64][12] and one cascade's constants, f32, then 8 mbarriers
SMEM_BASE = 4 * (2 * M_TILE * 132 + 2 * M_TILE * 12) + CONSTS_BYTES + 8 * 8
#: operand slots at most, and the bytes of one (a tile of an operand)
SLOTS, SLOT_BYTES = 4, 4 * M_TILE * C
#: shared memory a CTA may take on the card the kernel is built for
#: (sm_90a: 227 KiB)
SMEM_MAX = 232_448

# The cascade, ring and operand records, mirrored field for field by
# csrc/chain_reverse_kernel.cu (CrvCasc, CrvRing, CrvOp).
CASC = np.dtype([(f, "<u8") for f in ("hp", "w", "ecb", "apow", "g_state",
                                      "seed_x", "seed_c")]
                + [("coff", "<i4"), ("pad", "<i4")])
RING = np.dtype([(f, "<u8") for f in ("ring", "ct_hist", "g_hist", "mq")]
                + [("n", "<i4"), ("nh", "<i4"), ("soff", "<i4"),
                   ("pad", "<i4")])
OP = np.dtype([("src", "<u8"), ("ld", "<i8")])


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
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]
    lib.chain_reverse_launch.restype = ctypes.c_int
    want = (chain_kernel.HEADER.itemsize | chain_kernel.STAGE.itemsize << 8
            | CASC.itemsize << 16 | RING.itemsize << 24)
    if lib.chain_reverse_abi() != want:
        raise RuntimeError(
            f"reverse chain kernel ABI mismatch: the library's record sizes "
            f"are {lib.chain_reverse_abi():#x}, the packer's {want:#x}")
    shape = tuple(lib.chain_reverse_shape(i) for i in range(6))
    mine = (M_TILE, SMEM_BASE, SLOTS, NPOW, OP.itemsize, CONSTS_BYTES // 4)
    if shape != mine:
        raise RuntimeError(f"reverse chain kernel built with layout {shape}, "
                           f"the wrapper's {mine}")
    return lib


@functools.lru_cache(maxsize=64)
def casc_powers(sections: tuple) -> np.ndarray:
    """(ACt^T)^p for p in POWERS, f32 [NPOW, NS, NS], for one cascade: the
    carry adjoint's step over p blocks (row-vector form, c @ P), by
    squaring in float64 from the f32 ACt the forward packs (zero past
    N)."""
    p = chain_kernel._casc_consts(tuple(sections))[3].astype(np.float64).T
    sq = {1: p}
    while max(sq) < POWERS[-1]:
        sq[2 * max(sq)] = sq[max(sq)] @ sq[max(sq)]
    return np.stack([sq[k] for k in POWERS]).astype(np.float32)


@device_cache(maxsize=64)
def _casc_device(sections: tuple, device: torch.device):
    """The forward's packed constants of a cascade and its powers on
    ``device``: (tensor, float offsets of hp, w, ecb, apow)."""
    arr, offs, _ = chain_kernel.casc_tile_consts(tuple(sections))
    full = np.concatenate([arr, casc_powers(tuple(sections)).ravel()])
    return torch.as_tensor(full, device=device), offs[:3] + (arr.size,)


def operands(stages: tuple, taps_live=None) -> list:
    """The operands of a tile in the order the reverse walk uses them (the
    stages from the last): (stage index, what), what "rec" for a shaper's
    record, "tap" for a tap's cotangent (only the taps in ``taps_live``,
    all by default), "r" and "frac" for an mtap."""
    out = []
    for i in reversed(range(len(stages))):
        kind = stages[i][0]
        if kind == "ew":
            out.append((i, "rec"))
        elif kind == "tap" and (taps_live is None
                                or int(stages[i][1]) in taps_live):
            out.append((i, "tap"))
        elif kind == "mtap":
            out += [(i, "r"), (i, "frac")]
    return out


def reverse_records(stages: tuple, taps_live=None):
    """The forward's stage records (``chain_kernel.plan``) for the
    reverse: ``rec`` the stage's first operand in ``operands`` order (-1:
    none), chebyshev's two denominators (its plain version's
    ``_tanh(_safe_level(level))``) in p[2], p[3].  Returns (records,
    counts); a shaper's ordinal among the shapers (its record) is the
    ``rec`` of ``chain_kernel.plan``'s records."""
    from dsp_stuff_tpu_torch.ops.cycle_segment import _tanh20
    records, counts = chain_kernel.plan(tuple(stages))
    records["rec"] = -1
    for j, (i, what) in enumerate(operands(stages, taps_live)):
        if what != "frac":
            records[i]["rec"] = j
    for r, st in zip(records, stages):
        if st[0] == "ew" and st[1] == "chebyshev":
            r["p"][2:] = [_tanh20(float(np.float32(v))) for v in st[2]]
    return records, counts


@functools.lru_cache(maxsize=64)
def _plan(stages: tuple, taps_live: frozenset):
    """What a call packs that its stages and live taps fix, once: (each
    stage's shaper ordinal, the counts, the operands, the reverse's stage
    records)."""
    plain, counts = chain_kernel.plan(stages)
    return (tuple(int(r) for r in plain["rec"]), counts,
            tuple(operands(stages, taps_live)),
            reverse_records(stages, taps_live)[0])


def run_span(stages: tuple) -> int:
    """The ints of shared memory the mtap stages' run starts take: the
    largest (NH + 1) * 128 + 64 * 128 of them, 0 with no mtap."""
    return max(((int(st[3]) + 1) * C + M_TILE * C for st in stages
                if st[0] == "mtap"), default=0)


@functools.lru_cache(maxsize=64)
def layout(stages: tuple, n_ops: int):
    """The kernel's dynamic shared memory for ``stages`` with ``n_ops``
    operands a tile: (nslot, bytes, the run starts' float offset, per comb
    or mtap in order its ring's float offset, per cascade in order the
    float offset of its constants kept for the walk; -1 where they stay in
    device memory).  After SMEM_BASE: 32 B a cascade, a slot per operand
    of a tile (at most SLOTS; an mtap uses two at once), the combs' rings
    of a tile or less while they fit, then the cascades' constants while
    they fit, the run starts last.  Raises when the slots an operand needs
    do not fit beside the run starts."""
    n_casc = sum(1 for st in stages if st[0] == "cascade")
    span = 4 * run_span(stages)
    need = 2 if any(st[0] == "mtap" for st in stages) else min(n_ops, 1)
    fixed = SMEM_BASE + 32 * n_casc
    nslot = min(n_ops, SLOTS, max(0, (SMEM_MAX - fixed - span) // SLOT_BYTES))
    if nslot < need:
        raise ValueError(
            f"reverse chain kernel: {need} operand slots and an mtap ring of "
            f"{max(span // 4 - M_TILE * C, 0)} samples need "
            f"{fixed + need * SLOT_BYTES + span} bytes of shared memory, past "
            f"the card's {SMEM_MAX}")
    off = fixed + nslot * SLOT_BYTES
    soffs, coffs = [], []
    for st in stages:
        if st[0] == "comb":
            rl = 4 * (-(-int(st[2]) // C) * C)
            if rl <= SLOT_BYTES and off + rl + span <= SMEM_MAX:
                soffs.append(off // 4)
                off += rl
                continue
        if st[0] in ("comb", "mtap"):
            soffs.append(-1)
    for st in stages:
        if st[0] == "cascade":
            fits = off + CONSTS_BYTES + span <= SMEM_MAX
            coffs.append(off // 4 if fits else -1)
            off += CONSTS_BYTES if fits else 0
    return nslot, off + span, off // 4, tuple(soffs), tuple(coffs)


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
    return _call(ct_y, ct_taps, seeds, ct_hists, recs, stages, shared, B, T,
                 dev)


def _call(ct_y, ct_taps: tuple, seeds: tuple, ct_hists: tuple, recs: tuple,
          stages: tuple, shared: tuple, B: int, T: int, dev,
          defines: tuple = ()):
    """``chain_reverse_call`` in the kernel's build with ``defines``."""
    global LAUNCHES
    stages = tuple(stages)
    taps_live = frozenset(i for i, t in enumerate(ct_taps) if t is not None)
    ordinal, (n_casc, n_ring, n_tap), order, records = _plan(stages,
                                                            taps_live)
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
    nslot, smem, first_off, soffs, coffs = layout(stages, len(order))

    def ptr(t):
        return 0 if t is None else t.data_ptr()

    keep = []                     # what the kernel reads, alive until queued
    casc_recs, ring_recs, g_states = [], [], []
    mtap_ops = {}
    ci = hi = mi = 0
    for i, st in enumerate(stages):
        if st[0] == "cascade":
            consts, offs = _casc_device(st[1], dev)
            sx, sc = seeds[ci]
            sx = _check(sx, (B, C), dev, f"cascade {ci}'s input seed")
            sc = _check(sc, (B, int(records[i]["n"])), dev,
                        f"cascade {ci}'s carry seed")
            g_s = torch.empty((B, NS), dtype=torch.float32, device=dev)
            base = consts.data_ptr()
            casc_recs.append(tuple(base + 4 * o for o in offs) + (
                g_s.data_ptr(), ptr(sx), ptr(sc), coffs[ci]))
            keep += [consts, sx, sc]
            g_states.append(g_s)
            ci += 1
        elif st[0] in ("comb", "mtap"):
            n = int(st[2])
            cth = _check(ct_hists[hi], (B, n), dev,
                         f"history {hi}'s cotangent")
            g_h = torch.empty((B, n), dtype=torch.float32, device=dev)
            if st[0] == "comb":
                ring = None if soffs[hi] >= 0 else torch.empty(
                    (B, -(-n // C) * C), dtype=torch.float32, device=dev)
                ring_recs.append((ptr(ring), ptr(cth), g_h.data_ptr(), 0, n,
                                  0, soffs[hi], 0))
            else:
                NH = int(st[3])
                ring = torch.empty((B, 2, (NH + 1) * C), dtype=torch.float32,
                                   device=dev)
                q, r, fr = (chain_kernel._shared_operand(t, shp, dt, dev, w)
                            for t, shp, dt, w in zip(
                                shared[3 * mi:3 * mi + 3],
                                ((T // C,), (T,), (T,)),
                                (torch.int32, torch.int32, torch.float32),
                                ("q", "r", "frac")))
                ring_recs.append((ring.data_ptr(), ptr(cth), g_h.data_ptr(),
                                  q.data_ptr(), n, NH, -1, 0))
                mtap_ops[i] = {"r": r, "frac": fr}
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
    ops = []                      # the operand table, (src, ld) flattened
    for i, what in order:
        if what == "rec":
            ops += [recs[ordinal[i]].data_ptr(), T]
        elif what == "tap":
            ops += [taps[int(stages[i][1])].data_ptr(), T]
        else:
            ops += [mtap_ops[i][what].data_ptr(), 0]
    ybar = _check(ct_y, (B, T), dev, "y's cotangent")
    prog = chain_kernel.to_device(chain_kernel.pack_program(
        records, casc_recs, ring_recs, [], ops, CASC, RING), dev)
    gx = torch.empty((B, T), dtype=torch.float32, device=dev)
    rc = _lib(tuple(defines)).chain_reverse_launch(
        prog.data_ptr(), ptr(ybar), gx.data_ptr(), B, T, nslot, first_off,
        smem, dev.index or 0,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"reverse chain kernel launch failed: CUDA error "
                           f"{rc} ({smem} bytes of shared memory)")
    LAUNCHES += 1
    return gx, tuple(g_states)


def phase_cycles(*args):
    """``chain_reverse_call(*args)`` once in the kernel's build with its
    phase probes (-DCRV_PHASES): returns (its outputs, the clock cycles
    thread 0 of each CTA (of the first 4096) spent in each phase of its
    walk, uint64 [CTAs, len(PHASES)])."""
    out = _call(*args, defines=("CRV_PHASES",))
    lib = _lib(("CRV_PHASES",))
    lib.chain_reverse_phases.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.chain_reverse_phases.restype = ctypes.c_int
    torch.cuda.synchronize(out[0].device)
    buf = np.zeros((min(out[0].shape[0], 4096), len(PHASES)), np.uint64)
    rc = lib.chain_reverse_phases(buf.ctypes.data, buf.shape[0])
    if rc:
        raise RuntimeError(f"reading the phase counters: CUDA error {rc}")
    return out, buf
