"""Wrapper of the envelope kernel (csrc/envelope_kernel.cu): bind, launch.

The kernel replaces dsp_stuff_tpu/ops/pallas_envelope.py's two TPU
kernels: ``peak_envelope_pallas_chunked`` (two passes over chunks) and
``peak_envelope_pallas`` (one sequential pass, here one chunk of length
T).  It is CUDA C++ for sm_90a, built by ops/cuda_build.py at first use
and bound with ``ctypes``.  Nothing is imported, built or loaded when this
module is imported.

One launch computes either: the lane of chunk p >= 1 runs chunk p - 1
from a zero start (pass 1, its final kept), then chunk p from that final
(pass 2), which are _chunked_batched's operations in its order, so the
two agree bitwise.  The two gains are read from device memory, as the
Pallas kernels read theirs from a (1, 2) SMEM array: a slider of a stream
moves them with a copy, and a captured CUDA graph replays the launch
unchanged.

``peak_envelope_cuda`` takes only CUDA tensors and raises on anything the
kernel cannot take; there is no fallback.  The plain PyTorch versions are
ops/envelope._chunked_batched and ops/envelope._seq_scan.  ``LAUNCHES``
counts the kernel's launches (one per call, chunked or sequential).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from dsp_stuff_tpu_torch.ops import cuda_build

#: launches of the kernel in this process (a test or a smoke run resets it)
LAUNCHES = 0


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("envelope_kernel")
    lib.envelope_kernel_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    lib.envelope_kernel_launch.restype = ctypes.c_int
    return lib


def chunks(T: int, chunk: int) -> tuple[int, int]:
    """(chunk length, chunks P) of a [.., T] follower with ``chunk``: one
    chunk of T when chunk >= T (the sequential follower)."""
    return (T, 1) if chunk >= T else (chunk, -(-T // chunk))


def peak_envelope_cuda(x: torch.Tensor, gains: torch.Tensor,
                       env0: torch.Tensor, chunk: int):
    """x [B, T] f32 CUDA, contiguous; gains [2] f32 on x's device,
    (attack, release) from envelope.gain_from_frames (a 0-d tensor gives
    both); env0 [B] -> (env [B, T], final [B], a view of env's last
    column).

    ``chunk >= T`` runs the sequential follower; a shorter chunk the
    chunk-parallel one (each chunk's start from the previous chunk run
    from a zero start).  One launch either way."""
    global LAUNCHES
    if not (isinstance(x, torch.Tensor) and x.is_cuda):
        raise ValueError("envelope kernel: x must be a CUDA tensor")
    if x.dtype != torch.float32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"envelope kernel: x must be a contiguous [B, T] "
                         f"float32 tensor, got {x.dtype} {tuple(x.shape)}")
    B, T = x.shape
    if B < 1 or T < 1 or chunk < 1:
        raise ValueError(f"envelope kernel: B={B}, T={T}, chunk={chunk} "
                         f"must be positive")
    if (not isinstance(env0, torch.Tensor) or env0.shape != (B,)
            or env0.dtype != torch.float32 or env0.device != x.device
            or not env0.is_contiguous()):
        raise ValueError(f"envelope kernel: env0 must be a contiguous "
                         f"float32 [{B}] tensor on {x.device}")
    if (not isinstance(gains, torch.Tensor) or gains.shape not in ((), (2,))
            or gains.dtype != torch.float32 or gains.device != x.device):
        raise ValueError(f"envelope kernel: gains must be a float32 [2] "
                         f"(or 0-d) tensor on {x.device}")
    gains = gains.expand(2).contiguous()
    length, P = chunks(T, chunk)
    y = torch.empty_like(x)
    rc = _lib().envelope_kernel_launch(
        x.data_ptr(), y.data_ptr(), env0.data_ptr(), gains.data_ptr(), B, T,
        length, P, x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"envelope kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return y, y[:, -1]
