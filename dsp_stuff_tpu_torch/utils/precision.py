"""Global precision policy of the PyTorch port.

The reference computes in f32 with strictly sequential per-sample loops
(e.g. low_pass.rs:36-41, biquad.rs:87).  Vectorizing those recurrences
reassociates floating-point ops, which changes rounding.  The policy
decides how the ops trade accuracy against speed:

* ``fast``    -- f32 everywhere, blocked Toeplitz solves for the linear
                 recurrences, fused chain segments (the GPU kernel).
* ``parity``  -- float64 internals for the linear-recurrence solves, the
                 FIR's accumulation and the transcendental shapers, node
                 by node.  Matches the
                 Rust reference to <= -90 dBFS on supported graphs.
* ``exact``   -- the linear recurrences strictly sequential in f32, in
                 the reference's operation order (ops/scan.py:
                 ``_first_order_sequential``, ``_biquad_sequential`` on
                 the CPU, the sequential kernel on the card); everything
                 else as under ``parity``.  Bitwise the NumPy oracle on
                 the CPU on the reassociation-free, transcendental-free
                 node pool (PARITY.md:102-109); on the card held to
                 parity's -90 dBFS against the oracle.  Slow on the CPU;
                 for verification.

This module holds the port's own policy state, separate from the JAX
package's.  The policy is read when a graph renders.

Every float32 matrix product of the port runs in full float32: TF32 is
switched off for both the matmul and the cuDNN paths (TF32 keeps ~10
mantissa bits, far outside the fast policy's error budget).
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from dsp_stuff_tpu_torch.utils.capture import device_cache
from dsp_stuff_tpu_torch.utils.sliders import Data

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    name: str
    # dtype used inside the linear-recurrence solves
    scan_internal_dtype: str = "float32"
    # dtype of the FIR's accumulation: its convolution and warm-up sums
    # (the reference accumulates in f64, fir.rs:204-216)
    fir_accum_dtype: str = "float32"
    # evaluate the linear recurrences strictly sequentially, per sample
    # (bit-order parity with the reference's loops)
    sequential_recurrences: bool = False


FAST = PrecisionPolicy("fast", scan_internal_dtype="float32",
                       fir_accum_dtype="float32")
PARITY = PrecisionPolicy("parity", scan_internal_dtype="float64",
                         fir_accum_dtype="float64")
EXACT = PrecisionPolicy("exact", scan_internal_dtype="float32",
                        fir_accum_dtype="float64",
                        sequential_recurrences=True)

_POLICIES = {p.name: p for p in (FAST, PARITY, EXACT)}

_current = PARITY


def get_policy() -> PrecisionPolicy:
    return _current


def set_policy(p: str | PrecisionPolicy) -> PrecisionPolicy:
    global _current
    _current = _POLICIES[p if isinstance(p, str) else p.name]
    return _current


@contextlib.contextmanager
def policy(p: str | PrecisionPolicy):
    prev = get_policy()
    set_policy(p)
    try:
        yield get_policy()
    finally:
        set_policy(prev)


def gemm_precision(l1: float | None = None) -> str:
    """float32 matmul precision for the signal-sized Toeplitz products.

    The JAX package picks bf16x3 or HIGHEST per tap-row l1 norm on a TPU.
    The port always runs full float32 (``"highest"`` in
    ``torch.set_float32_matmul_precision`` terms; TF32 is off, see the
    module docstring), so ``l1`` does not change the answer."""
    return "highest"


# -- the JAX package's bit-exactness fences --------------------------------
# There they defend against XLA's value-changing rewrites (FMA contraction
# across ops, recip-mul for divides).  Eager PyTorch runs each op as its
# own kernel and rounds once per op, so the multiplies are plain ops; a
# divide needs its divisor on the device (``scalar_on``).

@device_cache(maxsize=4096)
def scalar_on(value: float, device, dtype=torch.float32) -> torch.Tensor:
    """``value`` as a cached 0-d tensor on ``device`` (never written to).
    As a divisor it makes a true divide: PyTorch's CUDA divide by a Python
    float (a host scalar) multiplies by its reciprocal, 1 ulp off the
    reference's divide for many inputs; by a device tensor it divides (on
    the CPU both are true divides).  As a constant it is copied to the
    card once, not at every call: a streamed block would otherwise wait
    for one host-to-device copy per constant, and a captured one could
    not make it (a capture underway holds the tensor, utils/capture)."""
    return torch.tensor(value, dtype=dtype, device=device)


def on_device(v, device, dtype=torch.float32) -> torch.Tensor:
    """``v`` as a ``dtype`` tensor on ``device``: a Python or NumPy scalar
    the cached 0-d tensor of ``scalar_on``, a slider of a stream step
    (utils/sliders.Data) its buffer holding the same value, anything else
    converted."""
    if isinstance(v, (int, float, np.number)):
        return scalar_on(float(v), device, dtype)
    if isinstance(v, Data):
        return v.on(device, dtype)
    return torch.as_tensor(v, dtype=dtype, device=device)


def mul_unfused(a, b):
    return a * b


def div_ieee(a, b):
    """a / b rounded once, on every device: a Python or NumPy number
    divisor (rounded to f32 first, as the JAX package's) of a CUDA tensor
    becomes a cached device scalar, since CUDA's divide by a host scalar
    multiplies by the reciprocal."""
    if (isinstance(b, (int, float, np.number)) and isinstance(a, torch.Tensor)
            and a.is_cuda):
        b = scalar_on(float(np.float32(b)), a.device)
    return a / b


def exact_mul(a, b):
    return a * b


def exact_div(a, b):
    return div_ieee(a, b)
