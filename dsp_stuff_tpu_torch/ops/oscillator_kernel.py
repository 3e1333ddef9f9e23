"""Wrapper of the oscillator kernel (csrc/oscillator_kernel.cu): lay out,
bind, launch.

The kernel is the signal generator's forward on the card: the counterpart
of what XLA compiles for dsp_stuff_tpu/ops/gen.py ``_block_totals`` and
``oscillator`` inside ``jax.jit`` (no TPU kernel of the JAX package holds
it).  It is CUDA C++ for sm_90a, built by ops/cuda_build.py at first use
and bound with ``ctypes``.  Nothing is imported, built or loaded when this
module is imported.

A call is two launches: the clock pass (each block's clock, and the final
clock) and the wave pass; a render of one 128-sample block (a stream
block, the per-node cycle scan's block) and the Constant mode are one
launch of the wave pass (:func:`launches_for`).  Amplitude, frequency and
the first clock are read from device memory, so a moved slider rebuilds
nothing and a captured stream block replays the launches reading the moved
value.

:func:`oscillator_cuda` takes only CUDA tensors and raises on anything the
kernel cannot take; there is no fallback.  The plain version is
ops/gen.py:oscillator_plain; ops/gen.oscillator dispatches.
:func:`plan` lays a call out on tensors of any device (the CPU tests
model the kernel's walk on it).  ``LAUNCHES`` counts the kernel's
launches.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from dsp_stuff_tpu_torch.ops import cuda_build

#: launches of the kernel in this process (a test or a smoke run resets it)
LAUNCHES = 0

# Geometry, mirrored by csrc/oscillator_kernel.cu (OSC_BLOCK,
# OSC_CLOCK_THREADS, OSC_WAVE_WARPS)
BLOCK = 128
CLOCK_THREADS = 1024
WAVE_WARPS = 8
MAX_GRID = 2**31 - 1
MAX_CLOCK_GRID = 65535

MODES = {"Sine": 0, "Triangle": 1, "Square": 2, "Constant": 3}


def launches_for(mode: str, T: int) -> int:
    """The kernel's launches for one call of ``mode`` over T samples: the
    wave pass alone for Constant and for one block, else the clock pass
    and the wave pass."""
    return 1 if mode == "Constant" or T == BLOCK else 2


class OscLaunch(NamedTuple):
    """A call laid out: the frequency over the clock rows and the amplitude
    over the output rows, each [rows or 1, T or 1] with its row and time
    strides, the first clock [crows], the buffers (``y`` [rows, T], the
    block clocks [crows, nb] of the clock pass or None, the final clock
    [crows] or None for Constant), the views that are the outputs (the
    wave of the eager shape and the final clock of the clock batch, or
    None for Constant), the counts, the mode's code, whether the clock
    comes from the wave pass alone (``fused``) and the grids."""
    freq: torch.Tensor
    f_sb: int
    f_st: int
    amp: torch.Tensor
    a_sb: int
    a_st: int
    c0: torch.Tensor
    y: torch.Tensor
    clocks: torch.Tensor | None
    final: torch.Tensor | None
    out: torch.Tensor
    out_clock: torch.Tensor | None
    rows: int
    crows: int
    T: int
    nb: int
    mode: int
    fused: bool
    grids: tuple


def _span(shape, batch) -> str:
    """How an operand of ``shape`` (its last axis T or 1) spans ``batch``:
    "none" (one row for all), "full", or "part" (it must be expanded)."""
    lead = (1,) * (len(batch) + 1 - len(shape)) + tuple(shape)
    if math.prod(lead[:-1]) == 1:
        return "none"
    return "full" if tuple(lead[:-1]) == tuple(batch) else "part"


def _rows_of(t: torch.Tensor, batch, T: int):
    """``t`` (0-d, or [..., T or 1]) over the rows of ``batch`` as a 2-D
    tensor with its row and time strides: stride 0 where it spans none of
    the batch (or is uniform in time), expanded where it spans part."""
    t2 = t.reshape(1, 1) if t.dim() == 0 else t
    st = 1 if t2.shape[-1] == T else 0
    span = _span(t2.shape, batch)
    rows = math.prod(batch)
    if span == "none":
        t2 = t2.reshape(1, t2.shape[-1])
    elif span == "full":
        t2 = t2.reshape(rows, t2.shape[-1])
    else:
        t2 = t2.expand(*batch, t2.shape[-1]).reshape(rows, t2.shape[-1])
    if st and t2.stride(-1) != 1:
        t2 = t2.contiguous()
    return t2, (t2.stride(0) if span != "none" else 0), st


class OscLayout(NamedTuple):
    """A call's operands over its rows (:func:`layout`): the frequency
    over the clock rows and the amplitude over the output rows, each
    [rows or 1, T or 1] with its row and time strides, the first clock
    [crows] (for Constant: the amplitude in the frequency's and the
    clock's place), the counts, the eager shapes of the wave, its batch
    and the clock batch, and whether one clock row serves every row."""
    freq: torch.Tensor
    f_sb: int
    f_st: int
    amp: torch.Tensor
    a_sb: int
    a_st: int
    c0: torch.Tensor
    rows: int
    crows: int
    T: int
    nb: int
    out_shape: tuple
    batch: tuple
    cbatch: tuple
    one: bool


def layout(mode: str, amp: torch.Tensor, freq: torch.Tensor, T: int,
           clock0: torch.Tensor) -> OscLayout:
    """Lay a call's operands out over its rows (f32 tensors of one device,
    as :func:`plan` takes them); allocates nothing but an operand that
    spans part of the batch, expanded."""
    if mode not in MODES:
        raise ValueError(mode)
    if T < BLOCK or T % BLOCK:
        raise ValueError(f"T={T} must be a positive multiple of {BLOCK}")
    dev = amp.device
    for name, t in (("amplitude", amp), ("frequency", freq),
                    ("clock", clock0)):
        if t.dtype != torch.float32 or t.device != dev:
            raise ValueError(f"oscillator kernel: {name} must be a float32 "
                             f"tensor on {dev}, got {t.dtype} on {t.device}")
    for name, t in (("amplitude", amp), ("frequency", freq)):
        if t.dim() and t.shape[-1] not in (T, 1):
            raise ValueError(f"oscillator kernel: {name} of shape "
                             f"{tuple(t.shape)} for T={T}")
    nb = T // BLOCK
    if mode == "Constant":
        out_shape = tuple(torch.broadcast_shapes(amp.shape, (T,)))
        batch = out_shape[:-1]
        rows = math.prod(batch)
        a2, a_sb, a_st = _rows_of(amp, batch, T)
        return OscLayout(a2, 0, 0, a2, a_sb, a_st, a2, rows, 1, T, nb,
                         out_shape, batch, (), True)
    fb = tuple(freq.shape[:-1]) if freq.dim() else ()
    cbatch = tuple(torch.broadcast_shapes(fb, clock0.shape))
    out_shape = tuple(torch.broadcast_shapes((*cbatch, T), amp.shape))
    batch = out_shape[:-1]
    rows = math.prod(batch)
    # the clock rows: one for all, or the output's rows (a clock batch
    # that spans part of the output's is expanded to it)
    one = math.prod(cbatch) == 1
    crow_batch = (1,) if one else batch
    crows = 1 if one else rows
    f2, f_sb, f_st = _rows_of(freq, crow_batch, T)
    c2 = clock0.reshape(()) if one else clock0
    c2 = c2.expand(crow_batch).reshape(crows).contiguous()
    a2, a_sb, a_st = _rows_of(amp, batch, T)
    return OscLayout(f2, f_sb, f_st, a2, a_sb, a_st, c2, rows, crows, T, nb,
                     out_shape, batch, cbatch, one)


def clock_index(batch, cbatch) -> tuple:
    """The index of the clock batch's rows in the output batch's (a clock
    batch that spans part of it was expanded to it)."""
    lead = (1,) * (len(batch) - len(cbatch)) + tuple(cbatch)
    return tuple(slice(0, 1) if c == 1 and b != 1 else slice(None)
                 for c, b in zip(lead, batch))


def plan(mode: str, amp: torch.Tensor, freq: torch.Tensor, T: int,
         clock0: torch.Tensor) -> OscLaunch:
    """Lay out a call on f32 tensors of one device: ``amp`` and ``freq``
    0-d or [..., T] (or [..., 1]), ``clock0`` the clock at the first block
    (its shape a batch).  The shapes are the plain version's: the wave is
    the broadcast of the clock batch's [..., T] (the frequency's batch and
    the clock's) and the amplitude, the final clock the clock batch; for
    Constant, the amplitude over T and no clock."""
    lo = layout(mode, amp, freq, T, clock0)
    dev, rows, nb = amp.device, lo.rows, lo.nb
    y = torch.empty((rows, T), dtype=torch.float32, device=dev)
    if mode == "Constant":
        return OscLaunch(lo.amp, 0, 0, lo.amp, lo.a_sb, lo.a_st, lo.amp, y,
                         None, None, y.reshape(lo.out_shape), None, rows, 1,
                         T, nb, MODES[mode], True,
                         (min(-(-rows * nb // WAVE_WARPS), MAX_GRID),))
    crows = lo.crows
    final = torch.empty((crows,), dtype=torch.float32, device=dev)
    if lo.one:
        out_clock = final.reshape(lo.cbatch)
    else:
        idx = clock_index(lo.batch, lo.cbatch)
        out_clock = final.reshape(lo.batch)[idx].reshape(lo.cbatch)
    fused = nb == 1
    clocks = None if fused else torch.empty((crows, nb), dtype=torch.float32,
                                            device=dev)
    wave = min(-(-rows * nb // WAVE_WARPS), MAX_GRID)
    grids = (wave,) if fused else (min(crows, MAX_CLOCK_GRID), wave)
    return OscLaunch(lo.freq, lo.f_sb, lo.f_st, lo.amp, lo.a_sb, lo.a_st,
                     lo.c0, y, clocks, final, y.reshape(lo.out_shape),
                     out_clock, rows, crows, T, nb, MODES[mode], fused,
                     grids)


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("oscillator_kernel")
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.oscillator_kernel_launch.argtypes = [
        i, p, ll, i, p, ll, i, p, p, p, p, ll, ll, ll, ctypes.c_float, i, i,
        i, i, i, p]
    lib.oscillator_kernel_launch.restype = i
    lib.oscillator_rem_launch.argtypes = [p, p, p, p, ll, i, p]
    lib.oscillator_rem_launch.restype = i
    lib.oscillator_kernel_geometry.argtypes = []
    lib.oscillator_kernel_geometry.restype = i
    want = BLOCK | CLOCK_THREADS << 8 | WAVE_WARPS << 20
    if lib.oscillator_kernel_geometry() != want:
        raise RuntimeError(f"oscillator kernel built with geometry "
                           f"{lib.oscillator_kernel_geometry():#x}, the "
                           f"wrapper's {want:#x}")
    return lib


def _launch(ln: OscLaunch, passes, exact: bool, sample_rate: float) -> None:
    """Launch ``passes`` (0 the clock pass, 1 the wave pass) of a laid-out
    call on the current stream; raises on a refused launch."""
    lib = _lib()
    dev = ln.y.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptr = (lambda t: 0 if t is None else t.data_ptr())   # noqa: E731
    grids = dict(zip((1,) if ln.fused else (0, 1), ln.grids))
    for pas in passes:
        rc = lib.oscillator_kernel_launch(
            pas, ln.freq.data_ptr(), ln.f_sb, ln.f_st, ln.amp.data_ptr(),
            ln.a_sb, ln.a_st, ln.c0.data_ptr(), ptr(ln.clocks),
            ptr(ln.final), ln.y.data_ptr(), ln.rows, ln.crows, ln.T,
            float(sample_rate), ln.mode, int(bool(exact)), int(ln.fused),
            grids[pas], dev.index, stream)
        if rc != 0:
            raise RuntimeError(f"oscillator kernel launch failed: CUDA "
                               f"error {rc}")


def oscillator_cuda(mode: str, amp: torch.Tensor, freq: torch.Tensor, T: int,
                    clock0: torch.Tensor, exact: bool,
                    sample_rate: float = 48_000.0):
    """(wave, final clock, block clocks) of the signal generator on the
    card: ``amp``, ``freq`` and ``clock0`` f32 CUDA tensors (see
    :func:`plan`), ``exact`` the parity and exact policies' f32 carry and
    f64 sine (fast: the f64 running sum and sinf).  Constant returns
    ``clock0`` itself, as the plain version does.  The block clocks are
    each block's clock [crows, T / 128] as the clock pass wrote it (None
    for one block and for Constant), which the reverse kernel reads
    (ops/oscillator_reverse_kernel.py)."""
    global LAUNCHES
    if not (isinstance(amp, torch.Tensor) and amp.is_cuda):
        raise ValueError("oscillator kernel: operands must be CUDA tensors")
    ln = plan(mode, amp, freq, T, clock0)
    passes = (1,) if ln.fused else (0, 1)
    _launch(ln, passes, exact, sample_rate)
    LAUNCHES += len(passes)
    return (ln.out, clock0 if ln.out_clock is None else ln.out_clock,
            ln.clocks)


def block_clocks_cuda(freq: torch.Tensor, T: int, clock0: torch.Tensor,
                      exact: bool, sample_rate: float = 48_000.0):
    """(each block's clock [crows, T / 128], the final clock [crows]) from
    the clock pass alone over T > 128 samples (a check: not on any path,
    not counted)."""
    one = torch.ones((), dtype=torch.float32, device=freq.device)
    ln = plan("Sine", one, freq, T, clock0)
    if ln.fused:
        raise ValueError("oscillator kernel: one block has no clock pass")
    _launch(ln, (0,), exact, sample_rate)
    return ln.clocks, ln.final


def remainder_cuda(x32: torch.Tensor, x64: torch.Tensor):
    """The kernel's ``torch.remainder(x, 1)`` over f32 and f64 CUDA tensors
    of one length (a check: not on any path, not counted)."""
    if not (x32.is_cuda and x64.is_cuda and x32.dtype == torch.float32
            and x64.dtype == torch.float64 and x32.numel() == x64.numel()):
        raise ValueError("oscillator remainder check: f32 and f64 CUDA "
                         "tensors of one length")
    x32, x64 = x32.contiguous(), x64.contiguous()
    y32, y64 = torch.empty_like(x32), torch.empty_like(x64)
    rc = _lib().oscillator_rem_launch(
        x32.data_ptr(), y32.data_ptr(), x64.data_ptr(), y64.data_ptr(),
        x32.numel(), x32.device.index,
        torch.cuda.current_stream(x32.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"oscillator remainder check failed: CUDA error "
                           f"{rc}")
    return y32, y64
