"""Wrapper of the chain kernel (csrc/chain_kernel.cu): pack, bind, launch.

The kernel replaces dsp_stuff_tpu/ops/pallas_chain.py:chain_kernel_call,
every stage included (cascade, scale, ew, tap, comb and the chorus's
mtap).  It is CUDA C++ for sm_90a, built by ops/cuda_build.py at first
use and bound with ``ctypes`` through a plain C entry point.  Nothing is
imported, built or loaded when this module is imported.

The stage list goes to the card as one packed program (``pack_program``):
a header, the stage records, a pointer record per cascade and per ring,
and the tap pointers, sized from the list and copied once per call, so
the kernel has no fixed stage capacity.  A CTA walks one row in tiles of
64 blocks; ``geometry`` picks the build (one or two CTAs an SM) from B.

``chain_kernel_call`` takes only CUDA tensors and raises on anything the
kernel cannot take; there is no fallback.  The plain PyTorch version of
the same function is ops/chain_segment.segment_fallback.  ``LAUNCHES``
counts the kernel's launches (both builds), ``RECORD_LAUNCHES`` those of
its record build (-DCK_RECORD: the same outputs, and each ``ew`` stage's
input written to a record [B, T] whose pointer sits in the program, for
the reverse chain kernel, ops/chain_reverse_kernel.py).
``phase_cycles`` runs the build with the kernel's phase probes
(tools/measure_torch_chain.py --phases).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from dsp_stuff_tpu_torch.ops import cuda_build
from dsp_stuff_tpu_torch.utils.capture import device_cache, hold

C = 128        # samples per block
NS = 8         # padded carry lanes (cascade.MAX_RUN_DIM embeds <= 8)
M_TILE = 64    # blocks of a tile, its M-rows
PHASES = ("wait", "open", "product", "scan", "C Ecb", "elementwise", "comb",
          "mtap", "out")   # the probes' PH_* order in csrc/chain_kernel.cu

#: elementwise stage kinds in the kernel's EW_* code order (csrc/stages.cuh)
EW_CODES = ("overdrive", "chebyshev", "distort:HardClip", "distort:SoftClip",
            "distort:Tanh", "distort:RecipSoftClip", "distort:Fuzz",
            "distort:Sin", "distort:Atan", "distort:Square",
            "distort:Chebyshev4")
_KIND = {"cascade": 0, "scale": 1, "ew": 2, "tap": 3, "comb": 4, "mtap": 5}

#: launches of the kernel in this process (a test or a smoke run resets it)
LAUNCHES = 0
#: ... of them, the record build's
RECORD_LAUNCHES = 0

# The packed program's records, mirrored field for field by
# csrc/chain_tiles.cuh (CkHeader, CkStage, shared with the reverse kernel)
# and csrc/chain_kernel.cu (CkCasc, CkRing).
HEADER = np.dtype([("n_stages", "<i4"), ("n_casc", "<i4"), ("n_ring", "<i4"),
                   ("n_tap", "<i4"), ("off_stage", "<i8"),
                   ("off_casc", "<i8"), ("off_ring", "<i8"),
                   ("off_tap", "<i8"), ("off_rec", "<i8"), ("pad", "<i8")])
STAGE = np.dtype([("kind", "<i4"), ("idx", "<i4"), ("n", "<i4"),
                  ("rec", "<i4"), ("p", "<f4", (4,))])
CASC = np.dtype([(f, "<u8") for f in ("hp", "w", "ecb", "act", "carry",
                                      "carry_out", "xlast_out", "pad")])
RING = np.dtype([(f, "<u8") for f in ("ring", "mq", "mr", "mfr")])


@functools.lru_cache(maxsize=4)
def _lib(defines: tuple = ()) -> ctypes.CDLL:
    """The chain kernel library built with ``defines``, bound: its
    argument types set, its record sizes and tile height checked against
    this module's."""
    lib = cuda_build.load("chain_kernel", defines)
    lib.chain_kernel_abi.argtypes = []
    lib.chain_kernel_abi.restype = ctypes.c_int
    lib.chain_kernel_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.chain_kernel_launch.restype = ctypes.c_int
    lib.chain_kernel_shape.restype = ctypes.c_int
    if lib.chain_kernel_shape() != M_TILE:
        raise RuntimeError(f"chain kernel built for tiles of "
                           f"{lib.chain_kernel_shape()} blocks, the wrapper "
                           f"assumes {M_TILE}")
    want = (HEADER.itemsize | STAGE.itemsize << 8 | CASC.itemsize << 16
            | RING.itemsize << 24)
    if lib.chain_kernel_abi() != want:
        raise RuntimeError(
            f"chain kernel ABI mismatch: the library's record sizes are "
            f"{lib.chain_kernel_abi():#x}, the packer's {want:#x}")
    return lib


def geometry(B: int, n_sm: int = 132) -> tuple[int, int]:
    """(grid, ctas) of the launch for B rows on a card of ``n_sm`` SMs: a
    CTA a row, of the kernel built for ``ctas`` CTAs an SM: one, with the
    whole register file, while the grid fits the SMs at one CTA each;
    two past that."""
    if B < 1 or n_sm < 1:
        raise ValueError(f"geometry: B={B} and n_sm={n_sm} must be >= 1")
    return B, 1 if B <= n_sm else 2


def _tf32_rna(a):
    """float32 ``a`` rounded to TF32 (10 mantissa bits) to nearest, ties
    away from zero, as cvt.rna.tf32.f32 rounds; the low 13 bits clear."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def tf32_split(a):
    """(hi, lo) TF32 parts of float32 ``a``: hi = rna(a), lo =
    rna(a - hi), the 3xTF32 operands of the kernel's products."""
    a = np.asarray(a, np.float32)
    hi = _tf32_rna(a)
    return hi, _tf32_rna(a - hi)


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
def casc_tile_consts(sections: tuple):
    """The chain kernel's constants of one cascade, one flat f32 array:
    hp [2, 136] (the Toeplitz row h = Ltg[0] after 8 zeros, TF32 hi and
    lo), W [2, C, NS], Ecb [2, NS, C] (hi and lo) and ACt [NS, NS];
    returns (array, offsets of the four parts, N)."""
    Ltg, Wp, Ecb, ACt, N = _casc_consts(sections)
    h = Ltg[0]
    i = np.arange(C)
    toe = np.where(i[None, :] >= i[:, None],
                   h[np.clip(i[None, :] - i[:, None], 0, C - 1)], 0.0)
    if not np.array_equal(toe.astype(np.float32), Ltg):
        raise AssertionError("cascade taps Ltg are not Toeplitz")
    hp = np.zeros(C + 8, np.float32)
    hp[8:] = h
    parts = (np.stack(tf32_split(hp)), np.stack(tf32_split(Wp)),
             np.stack(tf32_split(Ecb)), ACt)
    offs = np.cumsum([0] + [p.size for p in parts])
    return (np.concatenate([p.ravel() for p in parts]).astype(np.float32),
            tuple(int(o) for o in offs[:4]), N)


@device_cache(maxsize=64)
def _casc_tile_device(sections: tuple, device: torch.device):
    arr, offs, N = casc_tile_consts(sections)
    return torch.as_tensor(arr, device=device), offs, N


def plan(stages: tuple):
    """The stage records of a stage list, checked: a STAGE array (kind,
    index into the cascade / ring / tap / shaper tables, n, an ``ew``
    stage's ordinal among them (its record), params) and
    the counts (n_casc, n_ring, n_tap).  Raises on what the kernel cannot
    take; pointers come later (``pack_program``)."""
    rec = np.zeros(len(stages), STAGE)
    n_casc = n_ring = n_ew = 0
    taps = set()
    for k, st in enumerate(stages):
        if st[0] not in _KIND:
            raise ValueError(f"chain kernel: unknown stage {st[0]!r}")
        r = rec[k]
        r["kind"] = _KIND[st[0]]
        if st[0] == "cascade":
            r["idx"], r["n"] = n_casc, casc_tile_consts(st[1])[2]
            n_casc += 1
        elif st[0] == "comb":
            D = int(st[2])
            if D < 1:
                raise ValueError(f"chain kernel: comb delay {D} < 1")
            r["idx"], r["n"] = n_ring, D
            r["p"][0] = np.float32(st[1])
            n_ring += 1
        elif st[0] == "mtap":
            _, mix, L, NH, _EV, _RS = st
            L, NH = int(L), int(NH)
            if L < 1 or NH != -(-L // C):
                raise ValueError(f"chain kernel: mtap NH={NH} must be "
                                 f"ceil(L/{C}) for L={L}")
            r["idx"], r["n"] = n_ring, NH
            r["p"][0] = np.float32(mix)
            n_ring += 1
        elif st[0] == "tap":
            ti = int(st[1])
            if ti < 0 or ti in taps:
                raise ValueError(f"chain kernel: tap index {ti}")
            taps.add(ti)
            r["idx"] = ti
        elif st[0] == "scale":
            r["p"][0] = np.float32(st[1])
        else:                                   # ew
            if st[1] not in EW_CODES:
                raise ValueError(f"chain kernel: unknown shaper {st[1]!r}")
            if len(st[2]) > 4:
                raise ValueError(f"chain kernel: shaper {st[1]!r} has "
                                 f"{len(st[2])} params")
            r["idx"], r["rec"] = EW_CODES.index(st[1]), n_ew
            r["p"][:len(st[2])] = np.asarray(st[2], np.float32)
            n_ew += 1
    if taps != set(range(len(taps))):
        raise ValueError("chain kernel: tap indices must be 0..n_taps-1")
    return rec, (n_casc, n_ring, len(taps))


def has_shaper(stages: tuple) -> bool:
    """Whether the list has an ``ew`` stage: an input the reverse needs
    recorded (every other stage is linear), which the record build
    writes."""
    return any(st[0] == "ew" for st in stages)


def _align(n: int) -> int:
    return -(-n // 16) * 16


def layout(n_stages: int, n_casc: int, n_ring: int, n_tap: int,
           n_rec: int = 0, casc=CASC, ring=RING):
    """Byte offsets (stage, casc, ring, tap, rec, end) of the packed
    program's sections, each 16-byte aligned, for cascade and ring
    records of the dtypes ``casc`` and ``ring``."""
    off_stage = _align(HEADER.itemsize)
    off_casc = _align(off_stage + n_stages * STAGE.itemsize)
    off_ring = _align(off_casc + n_casc * casc.itemsize)
    off_tap = _align(off_ring + n_ring * ring.itemsize)
    off_rec = _align(off_tap + 8 * n_tap)
    return (off_stage, off_casc, off_ring, off_tap, off_rec,
            _align(off_rec + 8 * n_rec))


def pack_program(records, casc_ptrs, ring_ptrs, tap_ptrs, rec_ptrs=(),
                 casc=CASC, ring=RING) -> np.ndarray:
    """The packed program, a uint8 array: the header, ``records`` (from
    ``plan``), then per cascade its record (here 7 pointers: hp, w, ecb,
    act, carry, carry_out, xlast_out), per ring its record (here 4: ring,
    mq, mr, mfr; 0 where a comb has none), the tap pointers and the
    record build's ``rec_ptrs``, all as integers; the reverse kernel
    packs its own records (``casc``, ``ring``) in the same layout."""
    n_casc, n_ring, n_tap = len(casc_ptrs), len(ring_ptrs), len(tap_ptrs)
    offs = layout(len(records), n_casc, n_ring, n_tap, len(rec_ptrs), casc,
                  ring)
    buf = np.zeros(offs[5], np.uint8)
    hdr = np.zeros((), HEADER)
    hdr["n_stages"], hdr["n_casc"] = len(records), n_casc
    hdr["n_ring"], hdr["n_tap"] = n_ring, n_tap
    for name, o in zip(("off_stage", "off_casc", "off_ring", "off_tap",
                        "off_rec"), offs):
        hdr[name] = o
    buf[:HEADER.itemsize] = np.frombuffer(hdr.tobytes(), np.uint8)

    def put(off, arr):
        raw = np.frombuffer(np.ascontiguousarray(arr).tobytes(), np.uint8)
        buf[off:off + raw.size] = raw

    def recs(ptrs, dt):
        arr = np.zeros(len(ptrs), dt)
        for i, p in enumerate(ptrs):
            arr[i] = tuple(p) + (0,) * (len(dt.names) - len(p))
        return arr

    put(offs[0], np.asarray(records, STAGE))
    put(offs[1], recs(casc_ptrs, casc))
    put(offs[2], recs(ring_ptrs, ring))
    put(offs[3], np.asarray(tap_ptrs, np.uint64))
    put(offs[4], np.asarray(rec_ptrs, np.uint64))
    return buf


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
    return aligned(t.contiguous())


def aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it where its start is not 16-byte aligned: the
    kernels read their inputs 16 bytes a lane (here x and the mtap
    operands; the first-order kernel's b and a per-sample a)."""
    return t.clone() if t.data_ptr() % 16 else t


def to_device(buf: np.ndarray, dev) -> torch.Tensor:
    """A packed program on ``dev``: copied from pinned memory without
    waiting for the stream (the caching host allocator keeps the pinned
    block until the copy is done).  Inside a stream session's capture the
    copy becomes a node of the graph that reads the pinned block at every
    replay, so the block is held as long as the graph (utils/capture)."""
    pinned = hold(torch.from_numpy(buf).pin_memory())
    return pinned.to(dev, non_blocking=True)


def chain_kernel_call(x: torch.Tensor, stages: tuple, state_in: tuple,
                      record: bool = False):
    """x [B, T] f32 CUDA, contiguous, T % 128 == 0 -> (y [B, T],
    per-cascade (carry_last [B, NS], x_last [B, C]),
    per-comb or mtap ring [B, NR, C] in stage order,
    per-tap emitted sequence [B, T]).

    ``state_in`` holds, per stateful stage in order: for a cascade the
    composite state [B, N]; for a comb the history [B, D]; for an mtap
    four entries, the input history [B, L] and the shared trajectory
    operands q [T/128] int32, r [T] int32 and frac [T] float32
    (modfx.mtap_shared).  ``record`` launches the record build (the same
    outputs) and returns ``(outputs, recs)``: each ``ew`` stage's input
    [B, T], in stage order; a list with no shaper has no record build."""
    if not record:
        return _run(x, stages, state_in)
    if not has_shaper(stages):
        raise ValueError("chain kernel: a list with no shaper records "
                         "nothing")
    return _run(x, stages, state_in, ("CK_RECORD",))


def phase_cycles(x: torch.Tensor, stages: tuple,
                 state_in: tuple) -> np.ndarray:
    """``chain_kernel_call`` once in the kernel's build with its phase
    probes (-DCK_PHASES), for tools/measure_torch_chain.py --phases:
    returns the clock cycles thread 0 of each CTA (of the first 4096)
    spent in each phase of its walk, uint64 [CTAs, len(PHASES)]."""
    _run(x, stages, state_in, ("CK_PHASES",))
    lib = _lib(("CK_PHASES",))
    lib.chain_kernel_phases.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.chain_kernel_phases.restype = ctypes.c_int
    torch.cuda.synchronize(x.device)
    buf = np.zeros((min(x.shape[0], 4096), len(PHASES)), np.uint64)
    rc = lib.chain_kernel_phases(buf.ctypes.data, buf.shape[0])
    if rc:
        raise RuntimeError(f"reading the phase counters: CUDA error {rc}")
    return buf


def _run(x: torch.Tensor, stages: tuple, state_in: tuple,
         defines: tuple = ()):
    """``chain_kernel_call`` in the kernel's build with ``defines``."""
    global LAUNCHES, RECORD_LAUNCHES
    stages = tuple(stages)
    records, (n_casc, n_ring, n_tap) = plan(stages)
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
    casc_raw, rings, taps = [], [], [None] * n_tap
    casc_ptrs, ring_ptrs = [], []
    keep = []        # what the kernel reads, alive until it is queued
    si = 0
    for st in stages:
        if st[0] == "cascade":
            consts, offs, N = _casc_tile_device(st[1], dev)
            s0 = state_in[si]
            si += 1
            if s0.shape != (B, N) or s0.device != dev:
                raise ValueError(f"chain kernel: cascade state must be "
                                 f"[{B}, {N}] on {dev}, got "
                                 f"{tuple(s0.shape)} on {s0.device}")
            carry = torch.zeros((B, NS), dtype=torch.float32, device=dev)
            carry[:, :N] = s0
            # the kernel writes the N live lanes of carry_out
            carry_out = torch.zeros((B, NS), dtype=torch.float32, device=dev)
            xlast = torch.empty((B, C), dtype=torch.float32, device=dev)
            base = consts.data_ptr()
            casc_ptrs.append(tuple(base + 4 * o for o in offs) + (
                carry.data_ptr(), carry_out.data_ptr(), xlast.data_ptr()))
            keep += [consts, carry]
            casc_raw.append((carry_out, xlast))
        elif st[0] == "comb":
            D = int(st[2])
            RL = -(-D // C) * C
            ring = _seeded_ring(state_in[si], B, D, RL, dev, "comb history")
            si += 1
            ring_ptrs.append((ring.data_ptr(), 0, 0, 0))
            rings.append(ring.view(B, RL // C, C))
        elif st[0] == "mtap":
            L, NH = int(st[2]), int(st[3])
            RL = (NH + 1) * C
            ring = _seeded_ring(state_in[si], B, L, RL, dev, "mtap history")
            q = _shared_operand(state_in[si + 1], (T // C,), torch.int32,
                                dev, "q")
            r = _shared_operand(state_in[si + 2], (T,), torch.int32, dev, "r")
            fr = _shared_operand(state_in[si + 3], (T,), torch.float32, dev,
                                 "frac")
            si += 4
            ring_ptrs.append((ring.data_ptr(), q.data_ptr(), r.data_ptr(),
                              fr.data_ptr()))
            keep += [q, r, fr]
            rings.append(ring.view(B, NH + 1, C))
        elif st[0] == "tap":
            taps[int(st[1])] = torch.empty((B, T), dtype=torch.float32,
                                           device=dev)
    record = "CK_RECORD" in defines
    recs = tuple(torch.empty((B, T), dtype=torch.float32, device=dev)
                 for st in stages if st[0] == "ew") if record else ()
    prog = to_device(pack_program(records, casc_ptrs, ring_ptrs,
                                  [t.data_ptr() for t in taps],
                                  [r.data_ptr() for r in recs]), dev)
    grid, ctas = geometry(B, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    x = aligned(x)
    y = torch.empty_like(x)
    rc = _lib(defines).chain_kernel_launch(
        prog.data_ptr(), x.data_ptr(), y.data_ptr(), grid, T, ctas,
        dev.index, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"chain kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    out = y, tuple(casc_raw), tuple(rings), tuple(taps)
    if record:
        RECORD_LAUNCHES += 1
        return out, recs
    return out
