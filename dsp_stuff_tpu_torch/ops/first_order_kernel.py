"""Wrapper of the first-order recurrence kernel (csrc/first_order_kernel.cu):
bind and launch.

The kernel replaces dsp_stuff_tpu/ops/pallas_scan.py:first_order_pallas,
y[t] = a * y[t-1] + b[t], and also takes a per-sample coefficient and the
reverse direction, which the backward passes need.  It is CUDA C++ for
sm_90a, built by ops/cuda_build.py at first use and bound with ``ctypes``.
Nothing is imported, built or loaded when this module is imported.

``first_order_cuda`` takes only CUDA tensors and raises on anything the
kernel cannot take; there is no fallback.  The plain PyTorch versions are
ops/scan._first_order_blocked (scalar a) and ops/scan._first_order_scan
(per-sample a).  ``LAUNCHES`` counts the solves: one per call, each a
memset of the scratch (the tiles' status words and the ticket counter)
and one grid launch.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from dsp_stuff_tpu_torch.ops import cuda_build
from dsp_stuff_tpu_torch.ops.chain_kernel import aligned

#: solves launched in this process (a test or a smoke run resets it)
LAUNCHES = 0


@functools.lru_cache(maxsize=None)
def _lib(defines: tuple = ()) -> ctypes.CDLL:
    lib = cuda_build.load("first_order_kernel", tuple(defines))
    lib.first_order_kernel_tile.argtypes = []
    lib.first_order_kernel_tile.restype = ctypes.c_int
    lib.first_order_kernel_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.first_order_kernel_launch.restype = ctypes.c_int
    return lib


def n_tiles(T: int, tile: int) -> int:
    """Tiles a row: a row whose start is not 16-byte aligned (T % 4 != 0)
    is laid out up to 3 samples later, so it may take one more."""
    return -(-(T + (3 if T % 4 else 0)) // tile)


def _check(t, name: str, shape, device) -> None:
    if (not isinstance(t, torch.Tensor) or t.dtype != torch.float32
            or tuple(t.shape) != tuple(shape) or t.device != device
            or not t.is_contiguous()):
        got = (f"{t.dtype} {tuple(t.shape)} on {t.device}"
               if isinstance(t, torch.Tensor) else type(t).__name__)
        raise ValueError(f"first-order kernel: {name} must be a contiguous "
                         f"float32 {list(shape)} tensor on {device}, got "
                         f"{got}")


def first_order_cuda(a: torch.Tensor, b: torch.Tensor, y0: torch.Tensor,
                     reverse: bool = False,
                     defines: tuple = ()) -> torch.Tensor:
    """y [R, T] with y[t] = a y[t-1] + b[t], y[-1] = y0 (``reverse``:
    y[t] = a y[t+1] + b[t], y[T] = y0).

    b [R, T] f32 CUDA, contiguous; a a 0-d f32 tensor on b's device (read
    by the kernel, no host sync) or a per-sample [R, T] one; y0 [R].
    ``defines`` builds the kernel with other build options (FO_THREADS=,
    FO_SPAN=, FO_NSTAGE=, the FO_NO_WAIT probe), for measuring."""
    global LAUNCHES
    if not (isinstance(b, torch.Tensor) and b.is_cuda):
        raise ValueError("first-order kernel: b must be a CUDA tensor (the "
                         "plain versions in ops/scan.py take CPU tensors)")
    if b.dim() != 2 or b.shape[0] < 1 or b.shape[1] < 1:
        raise ValueError(f"first-order kernel: b must be [R, T] with R, T "
                         f">= 1, got {tuple(b.shape)}")
    R, T = b.shape
    _check(b, "b", (R, T), b.device)
    per_sample = isinstance(a, torch.Tensor) and a.dim() > 0
    _check(a, "a", (R, T) if per_sample else (), b.device)
    _check(y0, "y0", (R,), b.device)
    lib = _lib(tuple(defines))
    ntiles = n_tiles(T, lib.first_order_kernel_tile())
    if R * ntiles >= 2**31:
        raise ValueError(f"first-order kernel: {R} rows of {ntiles} tiles "
                         f"exceed the grid")
    b = aligned(b)                  # read 16 bytes a thread, as is a
    if per_sample:
        a = aligned(a)
    y = torch.empty_like(b)
    scratch = torch.empty(R * ntiles + 1, dtype=torch.int64, device=b.device)
    rc = lib.first_order_kernel_launch(
        b.data_ptr(), a.data_ptr(), int(per_sample), y0.data_ptr(),
        y.data_ptr(), scratch.data_ptr(), R, T, ntiles, int(bool(reverse)),
        b.device.index, torch.cuda.current_stream(b.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"first-order kernel launch failed: CUDA error "
                           f"{rc}")
    LAUNCHES += 1
    return y
