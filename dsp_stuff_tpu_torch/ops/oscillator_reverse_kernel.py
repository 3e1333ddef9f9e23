"""Wrapper of the reverse oscillator kernel
(csrc/oscillator_reverse_kernel.cu): lay out, bind, launch.

The kernel is the signal generator's backward on the card: the
counterpart of the vjp that XLA compiles for ``jax.grad`` through the JAX
package's ``jax.jit(self.fn)`` of dsp_stuff_tpu/ops/gen.py
``_block_totals`` and ``oscillator``, as ops/oscillator_kernel.py is of
the forward.  It is CUDA C++ for sm_90a, built by ops/cuda_build.py at
first use and bound with ``ctypes``.  Nothing is imported, built or
loaded when this module is imported.

A call is at most three launches (:func:`passes_of`): the wave pass (the
amplitude's gradient, each block's phase-gradient sum), the summing pass
(the reverse carry over the blocks, clock0's gradient, a slider's sums)
and, for a modulated frequency, the frequency pass.  It reads the
forward's block clocks (the third item of ``oscillator_cuda``), so the
serial carry is not run forward again.

An operand whose form the kernel does not take natively (an amplitude or
frequency of [..., 1], a [T] one over several rows, one that spans part
of the batch, a clock0 that spans part of it) is expanded over the rows
and its per-row gradient summed back here in float64, as autograd sums a
broadcast.

:func:`oscillator_reverse_cuda` takes only CUDA tensors and raises on
anything the kernel cannot take; there is no fallback.  Its plain version
is ops/gen.py:oscillator_adjoint.  :func:`plan_reverse` lays a call out on
tensors of any device (the CPU tests model the kernel's walk on it).
``LAUNCHES`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from dsp_stuff_tpu_torch.ops import cuda_build
from dsp_stuff_tpu_torch.ops.oscillator_kernel import (BLOCK, MAX_GRID, MODES,
                                                       clock_index, layout)
from dsp_stuff_tpu_torch.utils.sums64 import sum_to64

#: launches of the kernel in this process (a test or a smoke run resets it)
LAUNCHES = 0

# Geometry, mirrored by csrc/oscillator_reverse_kernel.cu (ORV_WARPS,
# ORV_SUM_THREADS)
WARPS = 8
SUM_THREADS = 1024

#: what a gradient takes (ORV_NONE, ORV_ELEM, ORV_SUM)
NONE, ELEM, SUM = 0, 1, 2
_F32, _F64 = torch.float32, torch.float64


class ReverseLaunch(NamedTuple):
    """A backward laid out: the operands over the rows as the forward's
    layout gives them (``freq``, ``amp`` with their strides, ``c0``
    [crows]), the forward's block clocks [crows, nb] (None for one
    block), the cotangents (``ct`` [rows, T], ``ct_clock`` [crows], or
    None), the gradient buffers and how each is taken (``ga``, ``gf``:
    NONE, ELEM, SUM; ``gc`` whether clock0's is, ``c0_shared`` whether
    one clock0 served several clock rows), the workspaces (``gph``
    [crows, T], ``gclk`` and ``gbs`` [crows, nb], ``gc0r`` [crows],
    ``pamp`` [crows * nb] f64, or None), the counts, the mode's code,
    the passes (bit 0 A, 1 B, 2 C), pass A's and C's grid, and ``back``:
    how the buffers become the operands' gradients."""
    freq: torch.Tensor
    f_sb: int
    f_st: int
    amp: torch.Tensor
    a_sb: int
    a_st: int
    c0: torch.Tensor
    clocks: torch.Tensor | None
    ct: torch.Tensor | None
    ct_clock: torch.Tensor | None
    g_amp: torch.Tensor | None
    g_freq: torch.Tensor | None
    g_c0: torch.Tensor | None
    gph: torch.Tensor | None
    gclk: torch.Tensor | None
    gbs: torch.Tensor | None
    gc0r: torch.Tensor | None
    pamp: torch.Tensor | None
    rows: int
    crows: int
    T: int
    nb: int
    mode: int
    ga: int
    gf: int
    gc: bool
    c0_shared: bool
    passes: int
    grid: int
    back: tuple


def passes_of(passes: int) -> int:
    """The launches of a call that runs ``passes`` (bits)."""
    return bin(passes).count("1")


def _over_rows(t: torch.Tensor, n: int, T: int):
    """An operand ([rows or 1, T or 1] with its strides) materialized over
    n rows and T, contiguous: the ELEM form of one the kernel does not
    take as it is."""
    return t.expand(n, T).contiguous()


def _sum_back(g: torch.Tensor, shape, lead_shape) -> torch.Tensor:
    """A [n, T] (or [n]) gradient over the layout's rows as an operand of
    ``shape``: reshaped to ``lead_shape`` (the rows' batch, T) and summed
    in float64 where the operand is narrower, rounded once."""
    return sum_to64(g.reshape(lead_shape), shape)


def plan_reverse(mode: str, amp: torch.Tensor, freq: torch.Tensor, T: int,
                 clock0: torch.Tensor, ct_y, ct_clock, need,
                 clocks) -> ReverseLaunch:
    """Lay out the backward of a call of :func:`oscillator_kernel.plan`'s
    operands (f32 tensors of one device): the cotangents ``ct_y`` (the
    wave's shape) and ``ct_clock`` (the final clock's), or None; ``need``
    (amplitude, frequency, clock0); ``clocks`` the forward's block clocks
    [crows, T / 128] (None for one block or Constant).  Allocates the
    gradient buffers and workspaces."""
    lo = layout(mode, amp, freq, T, clock0)
    dev = amp.device
    need_a, need_f, need_c = (bool(n) for n in need)
    rows, nb = lo.rows, lo.nb
    code = MODES[mode]
    constant = mode == "Constant"
    crows = rows if constant else lo.crows
    wave = mode in ("Sine", "Triangle") and ct_y is not None
    reach = not constant and (wave or ct_clock is not None)
    f2, f_sb, f_st, a2, a_sb, a_st, c2 = (lo.freq, lo.f_sb, lo.f_st, lo.amp,
                                          lo.a_sb, lo.a_st, lo.c0)
    back = {}
    # the amplitude's gradient
    ga = NONE
    if need_a and ct_y is not None:
        if a2.numel() == 1:
            ga = SUM
            back["amp"] = (tuple(amp.shape), tuple(amp.shape))
        else:
            if not (a_st and (a_sb or rows == 1)):
                a2, a_sb, a_st = _over_rows(a2, rows, T), T, 1
            ga = ELEM
            back["amp"] = (tuple(amp.shape), (*lo.batch, T))
    # the frequency's
    gf = NONE
    if need_f and reach:
        if f2.numel() == 1:
            gf = SUM
            back["freq"] = (tuple(freq.shape), tuple(freq.shape))
        else:
            if not (f_st and (f_sb or crows == 1)):
                f2, f_sb, f_st = _over_rows(f2, crows, T), T, 1
            gf = ELEM
            back["freq"] = (tuple(freq.shape),
                            (*lo.batch, T) if not lo.one else (T,))
    # clock0's
    gc = need_c and reach
    c0_shared = gc and crows > 1 and clock0.numel() == 1
    if gc:
        back["c0"] = (tuple(clock0.shape),
                      (1,) if c0_shared else ((1,) if lo.one else lo.batch))
    # the cotangents over the rows
    ct = None
    if ct_y is not None:
        ct = ct_y.reshape(rows, T)
        if not ct.is_contiguous() or ct.data_ptr() % 16:
            ct = ct.contiguous()
            if ct.data_ptr() % 16:
                ct = ct.clone(memory_format=torch.contiguous_format)
    ctc = None
    if ct_clock is not None and not constant:
        if lo.one:
            ctc = ct_clock.reshape(1)
        elif tuple(lo.cbatch) == tuple(lo.batch):
            ctc = ct_clock.reshape(crows)
        else:
            # the clock rows were expanded: the cotangent goes to the rows
            # the final clock was taken from
            z = torch.zeros(lo.batch, dtype=_F32, device=dev)
            idx = clock_index(lo.batch, lo.cbatch)
            z[idx] = ct_clock.reshape(z[idx].shape)
            ctc = z.reshape(crows)
        ctc = ctc.contiguous()

    def buf(n, dtype=_F32):
        return torch.empty(n, dtype=dtype, device=dev)
    g_amp = (buf((rows, T)) if ga == ELEM else buf(1) if ga == SUM
             else None)
    g_freq = (buf((crows, T)) if gf == ELEM else buf(1) if gf == SUM
              else None)
    g_c0 = buf(1 if c0_shared else crows) if gc else None
    phase = wave and (gf != NONE or gc)
    gph = buf((crows, T)) if phase and gf != NONE else None
    gclk = buf(crows * nb) if phase else None
    gbs = buf(crows * nb) if gf != NONE else None
    gc0r = buf(crows) if c0_shared else None
    pamp = buf(crows * nb, _F64) if ga == SUM else None
    passes = ((1 if ct is not None and (ga != NONE or phase) else 0)
              | (2 if ga == SUM or gf != NONE or gc else 0)
              | (4 if gf == ELEM else 0))
    if not constant and nb > 1 and passes & 5:
        if clocks is None or tuple(clocks.shape) != (crows, nb):
            got = None if clocks is None else tuple(clocks.shape)
            raise ValueError(f"oscillator reverse kernel: the forward's "
                             f"block clocks must be [{crows}, {nb}], got "
                             f"{got}")
    grid = min(-(-crows * nb // WARPS), MAX_GRID)
    return ReverseLaunch(
        f2, f_sb, f_st, a2, a_sb, a_st, c2,
        None if constant or nb == 1 else clocks, ct, ctc, g_amp, g_freq,
        g_c0, gph, gclk, gbs, gc0r, pamp, rows, crows, T, nb, code, ga, gf,
        gc, c0_shared, passes, grid, tuple(sorted(back.items())))


def shaped_grads(ln: ReverseLaunch, mode: str, ct_clock, need) -> tuple:
    """The buffers of a launch as (g_amp, g_freq, g_clock0), each of its
    operand's shape (None where not taken); Constant's clock0 takes the
    final clock's cotangent as it is (its final clock is clock0)."""
    back = dict(ln.back)
    out = []
    for key, g in (("amp", ln.g_amp), ("freq", ln.g_freq), ("c0", ln.g_c0)):
        out.append(None if key not in back else _sum_back(g, *back[key]))
    if mode == "Constant" and need[2]:
        out[2] = ct_clock
    return tuple(out)


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("oscillator_reverse_kernel")
    p, ll, i, f = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, \
        ctypes.c_float
    lib.oscillator_reverse_launch.argtypes = [
        p, ll, i, p, ll, i, p, p, p, p, p, p, p, p, p, p, p, p, ll, ll, ll,
        f, i, i, i, i, i, i, i, i, i, p]
    lib.oscillator_reverse_launch.restype = i
    lib.oscillator_reverse_geometry.argtypes = []
    lib.oscillator_reverse_geometry.restype = i
    want = BLOCK | WARPS << 8 | SUM_THREADS << 12
    if lib.oscillator_reverse_geometry() != want:
        raise RuntimeError(f"oscillator reverse kernel built with geometry "
                           f"{lib.oscillator_reverse_geometry():#x}, the "
                           f"wrapper's {want:#x}")
    return lib


def oscillator_reverse_cuda(mode: str, amp: torch.Tensor, freq: torch.Tensor,
                            T: int, clock0: torch.Tensor, ct_y, ct_clock,
                            need, clocks, sample_rate: float = 48_000.0):
    """(g_amp, g_freq, g_clock0) of the signal generator on the card, the
    backward of ``oscillator_cuda(mode, amp, freq, T, clock0, exact)``
    under the current policy: ``clocks`` its third
    item, ``ct_y`` and ``ct_clock`` the cotangents of its wave and final
    clock (None: none), ``need`` a bool an operand.  Each gradient has its
    operand's shape; None where not needed or where no cotangent reaches
    it (gen.Oscillator's backward on the card)."""
    global LAUNCHES
    from dsp_stuff_tpu_torch.utils.precision import get_policy
    if not (isinstance(amp, torch.Tensor) and amp.is_cuda):
        raise ValueError("oscillator reverse kernel: operands must be CUDA "
                         "tensors")
    for c in (ct_y, ct_clock):
        if c is not None and (not c.is_cuda or c.dtype != _F32):
            raise ValueError("oscillator reverse kernel: cotangents must be "
                             "float32 CUDA tensors")
    ln = plan_reverse(mode, amp, freq, T, clock0, ct_y, ct_clock, need,
                      clocks)
    if ln.passes:
        dev = amp.device
        ptr = (lambda t: None if t is None else t.data_ptr())  # noqa: E731
        rc = _lib().oscillator_reverse_launch(
            ln.freq.data_ptr(), ln.f_sb, ln.f_st, ln.amp.data_ptr(), ln.a_sb,
            ln.a_st, ln.c0.data_ptr(), ptr(ln.clocks), ptr(ln.ct),
            ptr(ln.ct_clock), ptr(ln.g_amp), ptr(ln.g_freq), ptr(ln.g_c0),
            ptr(ln.gph), ptr(ln.gclk), ptr(ln.gbs), ptr(ln.gc0r),
            ptr(ln.pamp), ln.rows, ln.crows, T, float(sample_rate), ln.mode,
            int(get_policy().name != "fast"), ln.ga, ln.gf, int(ln.gc),
            int(ln.c0_shared), ln.passes, ln.grid, dev.index,
            torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"oscillator reverse kernel launch failed: "
                               f"CUDA error {rc}")
        LAUNCHES += passes_of(ln.passes)
    return shaped_grads(ln, mode, ct_clock, need)
