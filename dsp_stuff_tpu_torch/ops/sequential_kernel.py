"""Wrapper of the sequential recurrence kernel (csrc/sequential_kernel.cu):
bind and launch.

The kernel runs the exact policy's linear recurrences one sample after the
other in the reference's operation order, one thread a row: the first
order y[t] = a y[t-1] + b[t] (a scalar or per-sample a) and the DF1 biquad
b0 x + b1 x1 + b2 x2 - a1 y1 - a2 y2.  A CTA owns 32 rows and gives each
of its warps one job: a memory warp stages tiles of 64 samples in a
shared-memory ring and writes results back, a chain warp runs the
recurrence, and a prep warp (the biquad's x terms) or the reverse mode's
epilogue warps (everything computed from the chain's tile: sample
adjoints, the coefficients' float64 sums) do the rest; the CPU model of
that schedule is tests/test_torch_sequential_tiles.py.  The JAX package
has no TPU kernel for them: its exact policy runs them as ``lax.scan``
loops (dsp_stuff_tpu/ops/scan.py:_first_order_sequential and
_biquad_sequential), of which the kernel is the counterpart on the card.
It is CUDA C++ for sm_90a, built by ops/cuda_build.py at first use and
bound with ``ctypes``.  Nothing is imported, built or loaded when this
module is imported.

``first_order_sequential_cuda`` and ``biquad_sequential_cuda`` take only
CUDA tensors and raise on anything the kernel cannot take; there is no
fallback.  The plain PyTorch versions are ops/scan._first_order_sequential
and ops/scan._biquad_sequential.  The kernel's reverse mode,
``first_order_reverse_cuda`` and ``biquad_reverse_cuda``, walks each row
backwards for the adjoints (the exact policy's gradients on the card,
ops/scan.py's ``SequentialFirstOrder`` and ``SequentialBiquad``); its plain
versions are ops/scan._first_order_adjoint_sequential and
_biquad_adjoint_sequential.  ``LAUNCHES`` counts the kernel's launches,
forward and reverse, one a call.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from dsp_stuff_tpu_torch.ops import cuda_build

#: launches of the kernel in this process (a test or a smoke run resets it)
LAUNCHES = 0

_FIRST_ORDER, _FIRST_ORDER_PS, _BIQUAD = 0, 1, 2


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare ``sequential_kernel_launch``'s C signature on a build of the
    kernel (this module's, or a probe's that a measuring tool loads)."""
    lib.sequential_kernel_launch.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    lib.sequential_kernel_launch.restype = ctypes.c_int
    lib.sequential_reverse_launch.argtypes = [
        ctypes.c_int, *[ctypes.c_void_p] * 10, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    lib.sequential_reverse_launch.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return bind(cuda_build.load("sequential_kernel"))


def _check(t, name: str, shape, device) -> None:
    if (not isinstance(t, torch.Tensor) or t.dtype != torch.float32
            or tuple(t.shape) != tuple(shape) or t.device != device
            or not t.is_contiguous()):
        got = (f"{t.dtype} {tuple(t.shape)} on {t.device}"
               if isinstance(t, torch.Tensor) else type(t).__name__)
        raise ValueError(f"sequential kernel: {name} must be a contiguous "
                         f"float32 {list(shape)} tensor on {device}, got "
                         f"{got}")


def _rows(x) -> tuple[int, int]:
    if not (isinstance(x, torch.Tensor) and x.is_cuda):
        raise ValueError("sequential kernel: the signal must be a CUDA tensor "
                         "(the plain versions in ops/scan.py take CPU "
                         "tensors)")
    if x.dim() != 2 or x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"sequential kernel: the signal must be [R, T] with "
                         f"R, T >= 1, got {tuple(x.shape)}")
    if x.shape[0] >= 2**31:
        raise ValueError(f"sequential kernel: {x.shape[0]} rows exceed the "
                         f"grid")
    return x.shape


def _launch(mode, x, a, coef, s_in, s_out_shape):
    global LAUNCHES
    R, T = x.shape
    y = torch.empty_like(x)
    s_out = torch.empty(s_out_shape, dtype=torch.float32, device=x.device)
    rc = _lib().sequential_kernel_launch(
        mode, x.data_ptr(), a.data_ptr() if a is not None else None,
        coef.data_ptr() if coef is not None else None, s_in.data_ptr(),
        y.data_ptr(), s_out.data_ptr(), R, T, x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"sequential kernel launch failed: CUDA error "
                           f"{rc}")
    LAUNCHES += 1
    return y, s_out


def first_order_sequential_cuda(a: torch.Tensor, b: torch.Tensor,
                                y0: torch.Tensor):
    """(y [R, T], y[:, -1] [R]) with y[t] = a y[t-1] + b[t], y[-1] = y0:
    the product a y rounded, then the sum.

    b [R, T] f32 CUDA, contiguous; a a 0-d f32 tensor on b's device (read
    by the kernel, no host sync) or a per-sample [R, T] one; y0 [R]."""
    R, T = _rows(b)
    _check(b, "b", (R, T), b.device)
    per_sample = isinstance(a, torch.Tensor) and a.dim() > 0
    _check(a, "a", (R, T) if per_sample else (), b.device)
    _check(y0, "y0", (R,), b.device)
    return _launch(_FIRST_ORDER_PS if per_sample else _FIRST_ORDER, b, a,
                   None, y0, (R,))


def biquad_sequential_cuda(x: torch.Tensor, coeffs: torch.Tensor,
                           state: torch.Tensor):
    """(y [R, T], final state [R, 4]) of the DF1 biquad
    y[t] = b0 x[t] + b1 x[t-1] + b2 x[t-2] - a1 y[t-1] - a2 y[t-2], summed
    left to right, each product rounded on its own.

    x [R, T] f32 CUDA, contiguous; coeffs [5] = (a1, a2, b0, b1, b2) on x's
    device; state [R, 4] = (x1, x2, y1, y2), as is the final state."""
    R, T = _rows(x)
    _check(x, "x", (R, T), x.device)
    _check(coeffs, "coeffs", (5,), x.device)
    _check(state, "state", (R, 4), x.device)
    return _launch(_BIQUAD, x, None, coeffs, state, (R, 4))


def _ptr(t):
    return t.data_ptr() if t is not None else None


def _launch_reverse(mode, ybar, a, y, x, coef, s_in, ga_shape, s_shape,
                    acc_shape):
    global LAUNCHES
    R, T = ybar.shape
    dev = ybar.device
    gx = torch.empty_like(ybar)
    ga = (torch.empty(ga_shape, dtype=torch.float32, device=dev)
          if ga_shape else None)
    s_out = torch.empty(s_shape, dtype=torch.float32, device=dev)
    acc = (torch.empty(acc_shape, dtype=torch.float64, device=dev)
           if acc_shape else None)
    rc = _lib().sequential_reverse_launch(
        mode, ybar.data_ptr(), _ptr(a), y.data_ptr(), _ptr(x), _ptr(coef),
        s_in.data_ptr(), gx.data_ptr(), _ptr(ga), s_out.data_ptr(),
        _ptr(acc), R, T, dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"sequential kernel (reverse) launch failed: "
                           f"CUDA error {rc}")
    LAUNCHES += 1
    return gx, ga, s_out, acc


def first_order_reverse_cuda(a: torch.Tensor, y: torch.Tensor,
                             y0: torch.Tensor, ybar: torch.Tensor):
    """The adjoint of y[t] = a y[t-1] + b[t], y[-1] = y0, for the output
    cotangent ybar: (lam [R, T] = bbar, abar, y0bar [R]), with

        lam[t] = ybar[t] + a[t+1] lam[t+1],  lam[T] = 0,
        abar[t] = lam[t] y[t-1]  (y[-1] = y0),  y0bar = a[0] lam[0];

    abar is [R, T] for a per-sample a, and for a 0-d a each row's sum in
    float64 ([R], from t = T-1 down to 0).  y [R, T] is the forward's
    output; every tensor f32 CUDA, contiguous, on ybar's device."""
    R, T = _rows(ybar)
    _check(ybar, "ybar", (R, T), ybar.device)
    _check(y, "y", (R, T), ybar.device)
    per_sample = isinstance(a, torch.Tensor) and a.dim() > 0
    _check(a, "a", (R, T) if per_sample else (), ybar.device)
    _check(y0, "y0", (R,), ybar.device)
    lam, abar, y0bar, acc = _launch_reverse(
        _FIRST_ORDER_PS if per_sample else _FIRST_ORDER, ybar, a, y, None,
        None, y0, (R, T) if per_sample else None, (R,),
        None if per_sample else (R,))
    return lam, (abar if per_sample else acc), y0bar


def biquad_reverse_cuda(x: torch.Tensor, y: torch.Tensor,
                        coeffs: torch.Tensor, state: torch.Tensor,
                        ybar: torch.Tensor):
    """The adjoint of the DF1 biquad (``biquad_sequential_cuda``) for the
    output cotangent ybar: (xbar [R, T], the initial state's gradient
    [R, 4], the coefficients' gradients as float64 row sums [R, 5]), with

        g[t] = ybar[t] - a1 g[t+1] - a2 g[t+2],  g[T] = g[T+1] = 0,
        xbar[t] = b0 g[t] + b1 g[t+1] + b2 g[t+2].

    x, y [R, T] are the forward's input and output, coeffs [5] = (a1, a2,
    b0, b1, b2), state [R, 4] its initial (x1, x2, y1, y2); f32 CUDA,
    contiguous, on ybar's device."""
    R, T = _rows(ybar)
    for t, name in ((ybar, "ybar"), (x, "x"), (y, "y")):
        _check(t, name, (R, T), ybar.device)
    _check(coeffs, "coeffs", (5,), ybar.device)
    _check(state, "state", (R, 4), ybar.device)
    xbar, _, sbar, acc = _launch_reverse(_BIQUAD, ybar, None, y, x, coeffs,
                                         state, None, (R, 4), (R, 5))
    return xbar, sbar, acc
