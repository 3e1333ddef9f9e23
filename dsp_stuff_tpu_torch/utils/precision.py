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

The JAX package's third policy, ``exact`` (bit-order parity, CPU only,
PARITY.md:102-109), is not ported yet: selecting it raises.

This module holds the port's own policy state, separate from the JAX
package's.  The policy is read when a graph renders.

Every float32 matrix product of the port runs in full float32: TF32 is
switched off for both the matmul and the cuDNN paths (TF32 keeps ~10
mantissa bits, far outside the fast policy's error budget).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools

import numpy as np
import torch

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


FAST = PrecisionPolicy("fast", scan_internal_dtype="float32",
                       fir_accum_dtype="float32")
PARITY = PrecisionPolicy("parity", scan_internal_dtype="float64",
                         fir_accum_dtype="float64")

_POLICIES = {p.name: p for p in (FAST, PARITY)}

_current = PARITY


def get_policy() -> PrecisionPolicy:
    return _current


def set_policy(p: str | PrecisionPolicy) -> PrecisionPolicy:
    global _current
    name = p if isinstance(p, str) else p.name
    if name == "exact":
        raise NotImplementedError(
            "precision policy 'exact' is not ported to dsp_stuff_tpu_torch "
            "yet (ROADMAP Queue 1, 'Left from Slice A'; its bitwise "
            "contract holds on the CPU only, Queue 3 item 4)")
    _current = _POLICIES[name]
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
# own kernel and rounds once per op, so the fenced forms are plain ops.

@functools.lru_cache(maxsize=4096)
def scalar_on(value: float, device, dtype=torch.float32) -> torch.Tensor:
    """``value`` as a cached 0-d tensor on ``device`` (never written to).
    As a divisor it makes a true divide: PyTorch's CUDA divide by a Python
    float (a host scalar) multiplies by its reciprocal, 1 ulp off the
    reference's divide for many inputs; by a device tensor it divides (on
    the CPU both are true divides).  As a constant it is copied to the
    card once, not at every call: a streamed block would otherwise wait
    for one host-to-device copy per constant."""
    return torch.tensor(value, dtype=dtype, device=device)


def on_device(v, device, dtype=torch.float32) -> torch.Tensor:
    """``v`` as a ``dtype`` tensor on ``device``: a Python or NumPy scalar
    the cached 0-d tensor of ``scalar_on``, anything else converted."""
    if isinstance(v, (int, float, np.number)):
        return scalar_on(float(v), device, dtype)
    return torch.as_tensor(v, dtype=dtype, device=device)


def mul_unfused(a, b):
    return a * b


def div_ieee(a, b):
    return a / b


def exact_mul(a, b):
    return a * b


def exact_div(a, b):
    return a / b
