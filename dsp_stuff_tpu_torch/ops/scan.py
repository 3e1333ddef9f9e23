"""Linear-recurrence lowering: IIR filters as blocked Toeplitz solves.

The reference evaluates all IIR state sequentially per sample on the CPU
(one-pole smoothers low_pass.rs:36-41 / high_pass.rs:36-41, DirectForm1
biquad biquad.rs:79-89).  Here a constant-coefficient recurrence splits
into chunks of C = 128 samples: the zero-state response of every chunk is
one triangular-Toeplitz matrix product, and only the chunk-end carries
recur, over T/C elements (recursively blocked the same way).

The precision policy picks the dtype of the whole solve: float32 under
``fast`` (the constants are built in f64 NumPy and cast once, as in the
JAX package), native float64 under ``parity``.  All functions take
``[..., T]`` tensors with any leading batch dimensions.

Concrete (Python float) coefficients build their constants on the host.
A slider of a stream step (utils/sliders.Data) takes the same route: the
host derives the constants from its value with ``sliders.lift``, and the
solve reads them from the buffers the step refills when the slider
moves, so it is bitwise the float route.  Tensor coefficients are the
gradient-fitting path: ``first_order_affine`` runs
``FirstOrderAffine``, whose forward and backward are the first-order
kernel (ops/first_order_kernel.py) for a CUDA tensor under ``fast`` and
the plain versions otherwise; ``biquad_df1`` builds its impulse response
from the tensors, so autograd reaches every coefficient.

Under ``exact`` (``sequential_recurrences``) every solve is tested for it
first, before any of the shortcuts above, and runs sample by sample in
f32 in the reference's operation order: ``_first_order_sequential`` and
``_biquad_sequential`` on the CPU (differentiable by their own autograd),
the sequential kernel (ops/sequential_kernel.py) on the card, whose
reverse mode is the backward of ``SequentialFirstOrder`` and
``SequentialBiquad``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from dsp_stuff_tpu_torch.ops import first_order_kernel, sequential_kernel
from dsp_stuff_tpu_torch.utils.capture import device_cache
from dsp_stuff_tpu_torch.utils.precision import get_policy, on_device
from dsp_stuff_tpu_torch.utils.sliders import Data, form, item, lift, num

# chunk length of the blocked solves: y_chunk = B @ Lt is a [K, C] @ [C, C]
# product, ~C multiply-adds per sample
_BLOCK_C = 128


def policy_dtype() -> torch.dtype:
    """The solve dtype of the current precision policy."""
    return (torch.float64 if get_policy().scan_internal_dtype == "float64"
            else torch.float32)


def _np_dtype(dtype: torch.dtype):
    return np.float64 if dtype == torch.float64 else np.float32


def _const(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return const_on(arr, like.device)


def const_on(arr: np.ndarray, device) -> torch.Tensor:
    """A NumPy constant as a tensor on ``device``, copied there once per
    content and device (a streamed block needs the same constants as the
    one before it; the tensor is never written to).  A Data (a constant
    derived from a stream's slider) is its buffer, a tensor itself."""
    if isinstance(arr, Data):
        return arr.on(device)
    if isinstance(arr, torch.Tensor):
        return arr
    arr = np.ascontiguousarray(arr)
    return _const_on(arr.tobytes(), arr.dtype.str, arr.shape, device)


@device_cache(maxsize=256)
def _const_on(raw: bytes, dtype: str, shape: tuple, device) -> torch.Tensor:
    return torch.tensor(np.frombuffer(raw, dtype).reshape(shape),
                        device=device)


def _pad_last(x: torch.Tensor, pad: int) -> torch.Tensor:
    return F.pad(x, (0, pad)) if pad else x


def _f32(v) -> float:
    return float(np.float32(v))


@functools.lru_cache(maxsize=256)
def scalar_power_toeplitz(a: float, n: int, row_ge_col: bool = False,
                          dtype=np.float32):
    """(pows [n+1], Lt [n, n], a^n) NumPy constants for a scalar ``a``.

    Default orientation: Lt[j, i] = a^(i-j) for i >= j (column form, the
    ``B @ Lt`` zero-state response); ``row_ge_col`` flips to
    Lt[i, j] = a^(i-j) for i >= j.  Powers accumulate by cumulative product
    in ``dtype`` (float32 for the fast policy, as in the JAX package)."""
    i = np.arange(n)
    pows = np.concatenate([np.ones(1, dtype),
                           np.cumprod(np.full(n, a, dtype), dtype=dtype)])
    diff = (i[:, None] - i[None, :]) if row_ge_col else \
        (i[None, :] - i[:, None])
    Lt = np.where(diff >= 0, pows[np.clip(diff, 0, n)], 0.0).astype(dtype)
    return pows, Lt, pows[n]


def first_order_affine(a, b, y0):
    """y[t] = a[t] * y[t-1] + b[t] along the last axis, y[-1] = y0.

    ``a`` is a scalar (a Python float, or a 0-d tensor that may require
    grad) or a per-sample tensor of b's shape; ``b`` is [..., T]; ``y0``
    broadcasts to b[..., 0].  Returns y with b's shape, f32.

    Under ``exact`` the sequential solve runs (``_first_order_exact``).
    Otherwise a Python float (or a stream's slider, utils/sliders.Data) on
    the CPU, or under ``parity``, keeps the host-constant blocked solve.
    Everything else runs ``FirstOrderAffine``: on a CUDA tensor under
    ``fast`` that is the first-order kernel, at any T and batch (a float
    becomes a device scalar)."""
    b = torch.as_tensor(b, dtype=torch.float32)
    y0 = torch.as_tensor(y0, dtype=torch.float32, device=b.device)
    if isinstance(a, torch.Tensor):
        if a.device != b.device:
            raise ValueError(f"first_order_affine: a is on {a.device}, b on "
                             f"{b.device}")
        if a.dim() and a.shape != b.shape:
            raise ValueError(f"first_order_affine: a per-sample a must have "
                             f"b's shape {tuple(b.shape)}, got "
                             f"{tuple(a.shape)}")
    if get_policy().sequential_recurrences:
        return _first_order_exact(a, b, y0)
    fast = policy_dtype() == torch.float32
    if not isinstance(a, torch.Tensor):
        a = lift(_f32, a)
        if not (fast and b.is_cuda):
            dt = policy_dtype()
            y = _first_order_blocked(a, b.to(dt), y0.to(dt), dtype=dt)
            return y.to(torch.float32)
        a = on_device(a, b.device)
    return FirstOrderAffine.apply(a.to(torch.float32), b,
                                  y0.expand(b.shape[:-1]))


def first_order_solve(a, b, y0, reverse: bool = False):
    """The recurrence at the current policy, outside autograd: under
    ``exact`` the sequential solve (the sequential kernel on the card), else
    the first-order kernel for a CUDA tensor under ``fast``, the plain
    versions (``_first_order_blocked``, ``_first_order_scan``) otherwise.

    a is a 0-d tensor or a per-sample tensor of b's shape, b [..., T], y0
    b's batch shape.  ``reverse`` runs  y[t] = a[t] y[t+1] + b[t],
    y[T] = y0.  Returns y of b's shape, f32 (f64 for an f64 b under
    ``parity``, so that the Function can be checked in float64)."""
    if get_policy().sequential_recurrences:
        if reverse:
            b = b.flip(-1)
            a = a.flip(-1) if a.dim() else a
        y = _first_order_exact(a.detach(), b.detach(), y0.detach())
        return y.flip(-1) if reverse else y
    dt = policy_dtype()
    out_dt = torch.float64 if (dt == torch.float64
                               and b.dtype == torch.float64) else torch.float32
    shape = b.shape
    if dt == torch.float64 and a.dim() == 0:
        # parity: the blocked solve with its powers built on the device
        # from the 0-d a (no host read: a captured stream step takes a
        # tensor slider this way; on the CPU the same float64 numbers as
        # the host-built powers of first_order_plain)
        b, y0 = b.detach().to(dt), y0.detach().to(dt)
        y = _first_order_blocked(a.detach().to(dt),
                                 b.flip(-1) if reverse else b, y0, dtype=dt)
        return (y.flip(-1) if reverse else y).to(out_dt)
    if dt == torch.float32 and b.is_cuda:
        R = int(np.prod(shape[:-1], dtype=np.int64))
        T = shape[-1]
        y = first_order_kernel.first_order_cuda(
            a.detach().to(torch.float32).reshape(
                (R, T) if a.dim() else ()).contiguous(),
            b.detach().to(torch.float32).reshape(R, T).contiguous(),
            y0.detach().to(torch.float32).reshape(R).contiguous(), reverse)
        return y.reshape(shape)
    return first_order_plain(a.detach().to(dt), b.detach().to(dt),
                             y0.detach().to(dt), reverse).to(out_dt)


def first_order_plain(a, b, y0, reverse: bool = False):
    """The first-order kernel's plain version in b's dtype, on any device:
    ``_first_order_blocked`` for a 0-d a, ``_first_order_scan`` for a
    per-sample one; ``reverse`` solves the time-flipped arrays."""
    if reverse:
        b = b.flip(-1)
        a = a.flip(-1) if a.dim() else a
    y = (_first_order_scan(a, b, y0) if a.dim()
         else _first_order_blocked(float(a), b, y0, dtype=b.dtype))
    return y.flip(-1) if reverse else y


class FirstOrderAffine(torch.autograd.Function):
    """y[t] = a[t] y[t-1] + b[t], y[-1] = y0, differentiable in a, b, y0.

    The JAX package differentiates its XLA blocked solve (its Pallas kernel
    has no derivative rule).  Here the adjoint is the same recurrence run
    backwards in time with the next sample's coefficient,

        lam[t] = ybar[t] + a[t+1] lam[t+1],   lam[T] = 0,

    solved by ``first_order_solve(..., reverse=True)``: the first-order
    kernel on the card, the plain version otherwise.  Then bbar = lam,
    y0bar = a[0] lam[0] and abar[t] = lam[t] y[t-1] (y[-1] = y0), summed
    over every sample in float64 for a scalar a."""

    @staticmethod
    def forward(ctx, a, b, y0):
        y = first_order_solve(a, b, y0)
        ctx.save_for_backward(a, y, y0)
        return y

    @staticmethod
    def backward(ctx, ybar):
        a, y, y0 = ctx.saved_tensors
        a_next = a if a.dim() == 0 else F.pad(a[..., 1:], (0, 1))
        lam = first_order_solve(a_next, ybar,
                                torch.zeros(y.shape[:-1], dtype=y.dtype,
                                            device=y.device), reverse=True)
        abar = y0bar = None
        if ctx.needs_input_grad[0]:
            if a.dim() == 0:
                abar = (torch.sum(lam[..., 1:] * y[..., :-1],
                                  dtype=torch.float64)
                        + torch.sum(lam[..., 0] * y0, dtype=torch.float64)
                        ).to(a.dtype)
            else:
                abar = lam * torch.cat([y0[..., None], y[..., :-1]], dim=-1)
        if ctx.needs_input_grad[2]:
            y0bar = (a if a.dim() == 0 else a[..., 0]) * lam[..., 0]
        return abar, lam, y0bar


def needs_grad(tensors) -> bool:
    """Whether autograd must see an op over ``tensors``: grad mode is on
    and one of them requires grad."""
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


def _first_order_exact(a, b, y0):
    """y[t] = a[t] y[t-1] + b[t] under ``exact``, sample by sample: the
    sequential kernel for a CUDA tensor (``SequentialFirstOrder`` when
    autograd must see it), the plain ``_first_order_sequential`` for a CPU
    one.  ``a`` is a Python float, a 0-d tensor or a per-sample tensor of
    b's shape; y0 broadcasts to b[..., 0]."""
    a = on_device(lift(_f32, a), b.device) \
        if not isinstance(a, torch.Tensor) else a.to(torch.float32)
    y0 = y0.to(torch.float32).expand(b.shape[:-1])
    if not b.is_cuda:
        return _first_order_sequential(a, b, y0)
    return run_first_order(_first_order_kernel,
                           sequential_kernel.first_order_reverse_cuda, a, b,
                           y0)


def _first_order_kernel(a, b, y0):
    return sequential_kernel.first_order_sequential_cuda(a, b, y0)[0]


def run_first_order(forward, reverse, a, b, y0):
    """The card's route of an exact first-order solve: rows [R, T] for
    ``forward(a, b, y0)``, through ``SequentialFirstOrder`` (with
    ``reverse``) when autograd must see it.  a 0-d or b's shape, y0 b's
    batch shape; a test passes the plain versions."""
    shape = b.shape
    R = int(np.prod(shape[:-1], dtype=np.int64))
    ins = (a.reshape(R, shape[-1]).contiguous() if a.dim()
           else a.contiguous(), b.reshape(R, shape[-1]).contiguous(),
           y0.reshape(R).contiguous())
    if needs_grad(ins):
        y = SequentialFirstOrder.apply(forward, reverse, *ins)
    else:
        y = forward(*ins)
    return y.reshape(shape)


class SequentialFirstOrder(torch.autograd.Function):
    """The exact policy's first-order solve on the card under autograd
    (the counterpart of jax.grad through the JAX package's lax.scan loop,
    ops/scan.py:_first_order_sequential).

    ``apply(forward, reverse, a, b, y0)``, a 0-d or [R, T], b [R, T], y0
    [R]: ``forward(a, b, y0)`` (the sequential kernel; a test passes
    ``_first_order_sequential``) gives y, which is saved with a and y0 and
    never recomputed; the backward runs ``reverse(a, y, y0, ybar)`` (the
    kernel's reverse mode, or ``_first_order_adjoint_sequential``) for
    (lam, abar, y0bar) and returns bbar = lam, abar (a 0-d a's row sums
    added in float64) and y0bar: the arithmetic of FirstOrderAffine's
    backward, in sequential order."""

    @staticmethod
    def forward(ctx, forward, reverse, a, b, y0):
        y = forward(a, b, y0)
        ctx.reverse = reverse
        ctx.save_for_backward(a, y, y0)
        return y

    @staticmethod
    def backward(ctx, ybar):
        a, y, y0 = ctx.saved_tensors
        lam, abar, y0bar = ctx.reverse(a, y, y0, ybar.contiguous())
        if a.dim() == 0:
            abar = abar.sum(dtype=torch.float64).to(a.dtype)
        return None, None, abar, lam, y0bar


class SequentialBiquad(torch.autograd.Function):
    """The exact policy's DF1 biquad on the card under autograd (the
    counterpart of jax.grad through ops/scan.py:_biquad_sequential's
    lax.scan loop in the JAX package).

    ``apply(forward, reverse, x, coeffs, state)``, x [R, T], coeffs [5] =
    (a1, a2, b0, b1, b2), state [R, 4] the initial (x1, x2, y1, y2):
    ``forward(x, coeffs, state)`` (the sequential kernel, or a plain
    stand-in) gives (y, final state [R, 4]); y is saved with x, coeffs and
    state.  The backward adds the final state's cotangents to the samples
    it holds (x[T-1], x[T-2], y[T-1], y[T-2]; at T = 1 the second pair is
    the initial x1, y1), runs ``reverse(x, y, coeffs, state, ybar)`` (the
    kernel's reverse mode, or ``_biquad_adjoint_sequential``) for (xbar,
    the initial state's gradient, the coefficients' float64 row sums) and
    adds the rows' sums in float64."""

    @staticmethod
    def forward(ctx, forward, reverse, x, coeffs, state):
        ctx.set_materialize_grads(False)
        y, fin = forward(x, coeffs, state)
        ctx.reverse = reverse
        ctx.save_for_backward(x, y, coeffs, state)
        return y, fin

    @staticmethod
    def backward(ctx, ybar, finbar):
        x, y, coeffs, state = ctx.saved_tensors
        T = x.shape[-1]
        ybar = torch.zeros_like(y) if ybar is None else ybar.clone()
        if finbar is not None:
            ybar[:, T - 1] += finbar[:, 2]
            if T >= 2:
                ybar[:, T - 2] += finbar[:, 3]
        xbar, sbar, acc = ctx.reverse(x, y, coeffs, state,
                                      ybar.contiguous())
        if finbar is not None:
            xbar[:, T - 1] += finbar[:, 0]
            if T >= 2:
                xbar[:, T - 2] += finbar[:, 1]
            else:
                sbar[:, 0] += finbar[:, 1]
                sbar[:, 2] += finbar[:, 3]
        cbar = acc.sum(0, dtype=torch.float64).to(coeffs.dtype)
        return None, None, xbar, cbar, sbar


def _first_order_sequential(a, b, y0):
    """The exact policy's first-order solve, sample by sample in f32: per
    step the product a[t] * y then the sum with b[t], each rounded (the
    JAX package's ops/scan.py:_first_order_sequential; low_pass.rs:36-41).
    ``a`` is a 0-d tensor or a per-sample tensor of b's shape, b [..., T],
    y0 b's batch shape.  The plain version of the sequential kernel, on
    any device; differentiable."""
    a_t = a.unbind(-1) if a.dim() else None
    y = y0
    ys = []
    for t, bt in enumerate(b.unbind(-1)):
        y = (a_t[t] if a_t is not None else a) * y + bt
        ys.append(y)
    return torch.stack(ys, dim=-1)


def _first_order_adjoint_sequential(a, y, y0, ybar):
    """The reverse mode's plain version for the first order, on any
    device: (lam, abar, y0bar) of y[t] = a[t] y[t-1] + b[t] for the output
    cotangent ybar, with the sequential kernel's roundings in its order
    (see ``sequential_kernel.first_order_reverse_cuda``): lam[t] = ybar[t]
    + a[t+1] lam[t+1] sample by sample from t = T-1 down to 0 in f32,
    abar[t] = lam[t] y[t-1] (per sample, or for a 0-d a each row's sum in
    float64, added from t = T-1 down), y0bar = a[0] lam[0].  a 0-d or y's
    shape, y and ybar [..., T], y0 the batch shape."""
    per_sample = a.dim() > 0
    a_t = a.unbind(-1) if per_sample else None
    lam = torch.zeros_like(ybar[..., 0])
    a_next = torch.zeros_like(lam) if per_sample else a
    lams = []
    for t, yb in reversed(list(enumerate(ybar.unbind(-1)))):
        lam = yb + a_next * lam
        lams.append(lam)
        if per_sample:
            a_next = a_t[t]
    y0bar = a_next * lam
    lam = torch.stack(lams[::-1], dim=-1)
    p = lam * torch.cat([y0[..., None], y[..., :-1]], dim=-1)
    if per_sample:
        return lam, p, y0bar
    return lam, _sum_backwards(p.double()), y0bar


def _sum_backwards(p):
    """p [..., T] (float64) summed over its last axis from t = T-1 down to
    0, one add at a time: the reverse mode's order."""
    acc = torch.zeros_like(p[..., 0])
    for t in range(p.shape[-1] - 1, -1, -1):
        acc = acc + p[..., t]
    return acc


def _biquad_adjoint_sequential(x, y, coeffs, state, ybar):
    """The reverse mode's plain version for the DF1 biquad, on any
    device: (xbar, the initial state's gradient [..., 4], the
    coefficients' float64 row sums [..., 5]) for the output cotangent ybar,
    with the sequential kernel's roundings in its order (see
    ``sequential_kernel.biquad_reverse_cuda``): g sample by sample from
    t = T-1 down to 0 in f32, the rest from it.  x, y, ybar [..., T],
    coeffs [5] = (a1, a2, b0, b1, b2), state [..., 4] the initial (x1, x2,
    y1, y2)."""
    a1, a2, b0, b1, b2 = coeffs.unbind(0)
    x1, x2, y1, y2 = state.unbind(-1)
    g1 = g2 = torch.zeros_like(ybar[..., 0])
    gs = []
    for yb in reversed(ybar.unbind(-1)):
        g = yb - a1 * g1 - a2 * g2
        gs.append(g)
        g2, g1 = g1, g
    g = torch.stack(gs[::-1], dim=-1)
    G1 = F.pad(g[..., 1:], (0, 1))                            # g[t+1]
    G2 = F.pad(g[..., 2:], (0, min(2, g.shape[-1])))         # g[t+2]
    xbar = b0 * g + b1 * G1 + b2 * G2
    # per t the f32 products of a1, a2, b0, b1, b2's sums, added in
    # float64 from t = T-1 down, then the initial state's boundary terms
    acc = _sum_backwards(torch.stack([G1 * y, G2 * y, g * x, G1 * x, G2 * x],
                                     dim=-2).double())
    zero = torch.zeros_like(g1)
    acc = acc + torch.stack([g1 * y1, g2 * y1, zero, g1 * x1, g2 * x1],
                            dim=-1).double()
    acc = acc + torch.stack([zero, g1 * y2, zero, zero, g1 * x2],
                            dim=-1).double()
    sbar = torch.stack([b1 * g1 + b2 * g2, b2 * g1, -(a1 * g1) - a2 * g2,
                        -(a2 * g1)], dim=-1)
    return xbar, sbar, acc * acc.new_tensor([-1.0, -1.0, 1.0, 1.0, 1.0])


def _first_order_scan(a, b, y0):
    """y[t] = a[t] y[t-1] + b[t] for a per-sample a [..., T]: a
    Hillis-Steele scan over the affine maps (a, b), log2 T passes in the
    inputs' dtype -- the plain version of the kernel's per-sample form,
    and the counterpart of the JAX package's associative scan."""
    T = b.shape[-1]
    b = b.clone()
    b[..., 0] += a[..., 0] * y0
    d = 1
    while d < T:
        # (a, b)[t] <- (a[t] a[t-d], a[t] b[t-d] + b[t]) for t >= d
        b = torch.cat([b[..., :d], a[..., d:] * b[..., :-d] + b[..., d:]],
                      dim=-1)
        a = torch.cat([a[..., :d], a[..., d:] * a[..., :-d]], dim=-1)
        d *= 2
    return b


def _power_consts(a, n: int, npdt):
    """(pows [n+1], Lt [n, n], a^n) of ``scalar_power_toeplitz`` (column
    form); for a 0-d tensor a the same on its device, the powers by a
    cumulative product (no host read)."""
    if not isinstance(a, torch.Tensor):
        return scalar_power_toeplitz(a, n, False, npdt)
    pows = torch.cat([a.new_ones(1), torch.cumprod(a.expand(n), 0)])
    return pows, _toeplitz(pows, n), pows[n]


def _scalar(v):
    """A host number as a Python float; a 0-d tensor stays one."""
    return v if isinstance(v, torch.Tensor) else float(v)


def _ends_taps(pows, C: int, scale, npdt):
    """The chunk-end taps a^(C-1-j), with ``scale`` folded in."""
    if isinstance(pows, torch.Tensor):
        return pows[:C].flip(0)
    taps = pows[C - 1::-1]
    return (taps * npdt(scale)).astype(npdt) if scale != 1.0 else taps


def _scaled(Lt, scale, npdt):
    return (Lt * npdt(scale)).astype(npdt) if scale != 1.0 else Lt


def _from1(v):
    return v[1:]


def _first_order_blocked(a: float, b, y0, C: int = _BLOCK_C, scale=1.0,
                         dtype=torch.float32):
    """Constant-coefficient first-order recurrence as matrix products.

    ``scale`` solves  y[t] = a y[t-1] + scale b[t]  with the factor folded
    into the tap constants.  Split T into K chunks of C.  Within a chunk
    the zero-state response is

        z[k, i] = sum_{j<=i} a^(i-j) b[k, j]  =  (B @ Lt)[k, i].

    Chunk carries follow  e_k = a^C e_{k-1} + z[k, C-1], itself a
    first-order recurrence of length K: solved recursively above C chunks,
    by one Toeplitz product above 8, sequentially below.  The carry folds
    back as  y[k, i] = z[k, i] + e_{k-1} a^(i+1).

    ``a`` and ``scale`` may be Data (a stream's slider): every constant is
    then derived on the host as for a float, and read from its buffer.
    ``a`` may be a 0-d tensor in ``dtype`` (``scale`` 1): the constants are
    then built on its device (``_power_consts``)."""
    npdt = _np_dtype(dtype)
    b = b.to(dtype)
    T = b.shape[-1]
    batch = b.shape[:-1]
    K = -(-T // C)
    B = _pad_last(b, K * C - T).reshape(*batch, K, C)

    consts = lift(_power_consts, a, C, npdt)
    pows, Lt, aC = (item(consts, i) for i in range(3))
    ends_taps = lift(_ends_taps, pows, C, scale, npdt)
    Lt = lift(_scaled, Lt, scale, npdt)

    ends = B @ _const(ends_taps, b)                               # [..., K]
    y0b = torch.as_tensor(y0, dtype=dtype, device=b.device).expand(batch)
    aC = lift(_scalar, aC)
    if K > C:
        e = _first_order_blocked(aC, ends, y0b, C, dtype=dtype)
    elif K > 8:
        Lt2 = item(lift(_power_consts, aC, K, npdt), 1)
        ends0 = ends.clone()
        ends0[..., 0] += num(aC, y0b) * y0b
        e = ends0 @ _const(Lt2, b)
    else:
        prev = y0b
        es = []
        for k in range(K):
            prev = num(aC, prev) * prev + ends[..., k]
            es.append(prev)
        e = torch.stack(es, dim=-1)
    # carry INTO chunk k is e_{k-1} (y0 for k = 0)
    carry_in = torch.cat([y0b[..., None], e[..., :-1]], dim=-1)  # [..., K]
    y = (B @ _const(Lt, b)
         + carry_in[..., :, None] * _const(lift(_from1, pows), b))
    return y.reshape(*batch, K * C)[..., :T]


def biquad_df1(x, a1, a2, b0, b1, b2, state=None):
    """DirectForm1 biquad (biquad crate semantics, used by biquad.rs:79-89):

        y[t] = b0*x[t] + b1*x[t-1] + b2*x[t-2] - a1*y[t-1] - a2*y[t-2]

    ``state = (x1, x2, y1, y2)`` (previous inputs/outputs, defaults 0).
    Returns (y, new_state).  Coefficients are scalars, already divided by
    a0.  Under ``exact`` the sequential solve runs (``_biquad_exact``),
    whatever the coefficients.  Otherwise concrete ones build the solve's
    constants on the host, and under ``fast`` the two degenerate forms take
    cheaper paths: a1 == a2 == 0 is
    a 3-tap FIR, and a2 == b1 == b2 == 0 a scaled first-order recurrence
    (the bench chain's biquad is this shape).  Any 0-d tensor coefficient
    takes the full blocked solve built from the tensors
    (``_biquad_blocked_traced``), whatever their values, as the JAX
    package's traced route does: that is how a2, b1 and b2 get gradients
    while they sit at 0.  A stream's sliders (utils/sliders.Data) take the
    concrete route; which form runs is read with ``sliders.form``."""
    x = torch.as_tensor(x, dtype=torch.float32)
    batch = x.shape[:-1]
    if x.shape[-1] < 2:
        raise ValueError("biquad_df1 needs T >= 2")
    if state is None:
        state = (0.0, 0.0, 0.0, 0.0)
    state = tuple(torch.as_tensor(s, dtype=torch.float32, device=x.device)
                  .expand(batch) for s in state)
    cvals = (a1, a2, b0, b1, b2)
    if get_policy().sequential_recurrences:
        return _biquad_exact(x, cvals, state)
    if any(isinstance(c, torch.Tensor) for c in cvals):
        coeffs = tuple(torch.as_tensor(c, dtype=torch.float32,
                                       device=x.device) for c in cvals)
        return _biquad_blocked_traced(x, coeffs, state, policy_dtype())
    cf = tuple(lift(_f32, c) for c in cvals)
    if policy_dtype() == torch.float32:
        shape = form(lift(_biquad_form, *cf))
        if shape in ("gain", "fir"):
            return _biquad_pure_fir(x, cf, state, shape == "gain")
        if shape == "first_order":
            return _biquad_degenerate(x, cf, state)
        return _biquad_blocked(x, cf, state, torch.float32)
    return _biquad_blocked(x, cf, state, torch.float64)


def _biquad_form(a1, a2, b0, b1, b2) -> str:
    """The fast policy's route for concrete coefficients: a gain or a
    3-tap FIR (a1 == a2 == 0), a scaled first-order recurrence
    (a2 == b1 == b2 == 0), else the full blocked solve."""
    if a1 == 0.0 and a2 == 0.0:
        return "gain" if b1 == 0.0 and b2 == 0.0 else "fir"
    if a2 == 0.0 and b1 == 0.0 and b2 == 0.0:
        return "first_order"
    return "full"


def _pack_f32(*cvals):
    return np.asarray([np.float32(c) for c in cvals], np.float32)


def _biquad_exact(x, cvals: tuple, state):
    """The biquad under ``exact``, sample by sample: the sequential kernel
    for a CUDA tensor (``SequentialBiquad`` when autograd must see it),
    the plain ``_biquad_sequential`` for a CPU one.  Coefficients are
    Python floats or 0-d tensors (a1, a2, b0, b1, b2); state (x1, x2, y1,
    y2) of x's batch shape."""
    coeffs = tuple(
        c.to(device=x.device, dtype=torch.float32)
        if isinstance(c, torch.Tensor)
        else on_device(lift(_f32, c), x.device) for c in cvals)
    if not x.is_cuda:
        return _biquad_sequential(x, *coeffs, state)
    if all(not isinstance(c, torch.Tensor) for c in cvals):
        packed = _const(lift(_pack_f32, *cvals), x)
    else:
        packed = torch.stack(coeffs)
    return run_biquad(sequential_kernel.biquad_sequential_cuda,
                      sequential_kernel.biquad_reverse_cuda, x, packed,
                      state)


def run_biquad(forward, reverse, x, coeffs, state):
    """The card's route of an exact biquad: rows [R, T] for ``forward(x,
    coeffs, state)``, through ``SequentialBiquad`` (with ``reverse``) when
    autograd must see it.  coeffs [5], state (x1, x2, y1, y2) of x's batch
    shape; returns (y, final state) as ``biquad_df1`` does.  A test passes
    the plain versions."""
    shape = x.shape
    R = int(np.prod(shape[:-1], dtype=np.int64))
    ins = (x.reshape(R, shape[-1]).contiguous(), coeffs,
           torch.stack([s.reshape(R) for s in state], dim=-1))
    if needs_grad(ins):
        y, fin = SequentialBiquad.apply(forward, reverse, *ins)
    else:
        y, fin = forward(*ins)
    return y.reshape(shape), tuple(fin[:, i].reshape(shape[:-1])
                                   for i in range(4))


def _biquad_sequential(x, a1, a2, b0, b1, b2, state):
    """The exact policy's biquad, sample by sample in f32 with the biquad
    crate's op order (DirectForm1::run; the JAX package's ops/scan.py:
    _biquad_sequential): out = b0*x + b1*x1 + b2*x2 - a1*y1 - a2*y2, left
    to right, each product and sum rounded.  Coefficients 0-d tensors,
    x [..., T], state (x1, x2, y1, y2) of x's batch shape.  Returns (y,
    (x1, x2, y1, y2)).  The plain version of the sequential kernel, on any
    device; differentiable."""
    x1, x2, y1, y2 = state
    ys = []
    for xt in x.unbind(-1):
        out = b0 * xt + b1 * x1 + b2 * x2 - a1 * y1 - a2 * y2
        x1, x2, y1, y2 = xt, x1, out, y1
        ys.append(out)
    return torch.stack(ys, dim=-1), (x1, x2, y1, y2)


def _biquad_pure_fir(x, cf: tuple, state, gain: bool):
    """DF1 biquad with a1 == a2 == 0: a pure 3-tap FIR with the carried
    x-history prefix (a gain when b1 == b2 == 0 too).  State layout
    matches the full biquad."""
    _a1, _a2, b0, b1, b2 = cf
    x1, x2, _y1, _y2 = state
    if gain:
        y = x * num(b0, x)
    else:
        xp = torch.cat([x2[..., None], x1[..., None], x], dim=-1)
        y = (num(b0, x) * xp[..., 2:] + num(b1, x) * xp[..., 1:-1]
             + num(b2, x) * xp[..., :-2])
    return y, (x[..., -1], x[..., -2], y[..., -1], y[..., -2])


def _biquad_degenerate(x, cf: tuple, state):
    """DF1 biquad with a2 == b1 == b2 == 0:  y[t] = b0 x[t] - a1 y[t-1],
    the first-order blocked solve with b0 folded into its taps.  The
    y-history seed y1 is the recurrence's y0."""
    a1, _a2, b0, _b1, _b2 = cf
    _x1, _x2, y1, _y2 = state
    y = _first_order_blocked(lift(_neg_f32, a1), x, y1, scale=b0)
    return y, (x[..., -1], x[..., -2], y[..., -1], y[..., -2])


def _neg_f32(v) -> float:
    return float(np.float32(-np.float32(v)))


@functools.lru_cache(maxsize=128)
def _biquad_ir(cf: tuple, C: int):
    """(h [C+1], g [C+1]) f64: the recursive-part impulse response of
    y[t] = -a1 y[t-1] - a2 y[t-2] and the numerator-folded response
    g[t] = b0 h[t] + b1 h[t-1] + b2 h[t-2]."""
    a1, a2, b0, b1, b2 = cf
    h = np.empty(C + 1, np.float64)
    h[0] = 1.0
    hm1, hm2 = 1.0, 0.0
    for t in range(1, C + 1):
        cur = -a1 * hm1 - a2 * hm2
        h[t] = cur
        hm2, hm1 = hm1, cur
    g = b0 * h
    g[1:] += b1 * h[:-1]
    g[2:] += b2 * h[:-2]
    return h, g


def _biquad_consts(a1, a2, b0, b1, b2, C: int, npdt):
    """The host constants of ``_biquad_blocked``: (h, hs, Ltg, S, M,
    (h[C-1], h[C-2], h[C-3])) in ``npdt``."""
    h64, g64 = _biquad_ir((a1, a2, b0, b1, b2), C)
    h = h64.astype(npdt)
    g = g64.astype(npdt)
    hs = np.concatenate([np.zeros(1, npdt), h[:C - 1]])      # h[i-1], [C]
    i = np.arange(C)
    Ltg = np.where(i[:, None] <= i[None, :],
                   g[np.clip(i[None, :] - i[:, None], 0, C)], 0.0).astype(npdt)
    # one [C, 4] side product: chunk-end zero-state responses z[k, C-1] /
    # z[k, C-2] and the raw samples x[k, C-1] / x[k, C-2] the next
    # chunk's numerator reaches back to
    S = np.zeros((C, 4), npdt)
    S[:, 0] = g[C - 1 - np.arange(C)]
    S[:C - 1, 1] = g[C - 2 - np.arange(C - 1)]
    S[C - 1, 2] = 1.0
    S[C - 2, 3] = 1.0
    M = np.asarray([[h64[C], -a2 * h64[C - 1]],
                    [h64[C - 1], -a2 * h64[C - 2]]]).astype(npdt)
    return h, hs, Ltg, S, M, (float(h[C - 1]), float(h[C - 2]),
                              float(h[C - 3]))


def _slice(v, lo, hi):
    return v[lo:hi]


def _biquad_blocked(x, cf: tuple, state, dtype, C: int = _BLOCK_C):
    """Second-order recurrence as blocked matrix products.

    Per chunk of C: the zero-state response is one GEMM against the
    Toeplitz of g (the numerator folded into the impulse response); each
    chunk's first two outputs reach back two inputs into the previous
    chunk (a rank-2 correction d0 h[i] + d1 h[i-1]); the chunk-end pair
    drives the 2-vector boundary recurrence s_k = M s_{k-1} + w_k
    (_vec2_recurrence), folded back as  s1 h[i+1] - a2 s2 h[i].  The
    coefficients may be Data (a stream's sliders)."""
    npdt = _np_dtype(dtype)
    a1, a2, b0, b1, b2 = cf
    x1, x2, y1, y2 = (s.to(dtype) for s in state)
    T = x.shape[-1]
    batch = x.shape[:-1]
    consts = lift(_biquad_consts, *cf, C, npdt)
    h, hs, Ltg, S, M_np, hC = (item(consts, i) for i in range(6))

    K = -(-T // C)
    X = _pad_last(x.to(dtype), K * C - T).reshape(*batch, K, C)
    side = X @ _const(S, X)                                   # [..., K, 4]

    xlast1 = torch.cat([x1[..., None], side[..., :-1, 2]], dim=-1)  # [..., K]
    xlast2 = torch.cat([x2[..., None], side[..., :-1, 3]], dim=-1)
    d0 = num(b1, xlast1) * xlast1 + num(b2, xlast2) * xlast2
    d1 = num(b2, xlast1) * xlast1
    hC1, hC2, hC3 = (num(item(hC, i), d0) for i in range(3))
    w = torch.stack([side[..., :, 0] + d0 * hC1 + d1 * hC2,
                     side[..., :, 1] + d0 * hC2 + d1 * hC3], dim=-1)

    s0 = torch.stack([y1, y2], dim=-1)                        # [..., 2]
    w[..., 0, :] += torch.einsum("ij,...j->...i", _const(M_np, X), s0)
    s = _vec2_recurrence(M_np, w)
    # carry INTO chunk k is s_{k-1} (s0 for k = 0)
    s_in = torch.cat([s0[..., None, :], s[..., :-1, :]], dim=-2)

    y = (X @ _const(Ltg, X)
         + s_in[..., :, 0:1] * _const(lift(_slice, h, 1, None), X)
         - num(a2, s_in) * s_in[..., :, 1:2]
         * _const(lift(_slice, h, None, -1), X)
         + d0[..., :, None] * _const(lift(_slice, h, None, C), X)
         + d1[..., :, None] * _const(hs, X))
    y = y.reshape(*batch, K * C)[..., :T].to(torch.float32)
    return y, (x[..., -1], x[..., -2], y[..., -1], y[..., -2])


def _powers(M, n: int):
    """[M^1, ..., M^n] of a square tensor M by repeated doubling: log2 n
    batched products, differentiable."""
    P = M[None]
    while P.shape[0] < n:
        P = torch.cat([P, P @ P[-1]])     # M^k M^m = M^(k+m), k <= m
    return P[:n]


def _toeplitz(v, C: int):
    """Lt[j, i] = v[i - j] for j <= i, else 0 ([C, C, *v.shape[1:]]) from
    a tensor v of at least C entries along its first axis.  index_select,
    whose backward is one index_add (an indexing backward would sort)."""
    i = torch.arange(C, device=v.device)
    diff = i[None, :] - i[:, None]
    keep = (diff >= 0).reshape(C, C, *(1,) * (v.dim() - 1))
    taps = v.index_select(0, diff.clamp(0, C).flatten()).reshape(
        C, C, *v.shape[1:])
    return torch.where(keep, taps, torch.zeros((), dtype=v.dtype,
                                               device=v.device))


def _biquad_blocked_traced(x, coeffs, state, dtype, C: int = _BLOCK_C):
    """``_biquad_blocked`` with 0-d tensor coefficients (the JAX package's
    traced route, ops/scan.py:_biquad_blocked): the impulse response
    h[t] = (A^t)[0, 0] comes from the powers of the companion matrix
    A = [[-a1, -a2], [1, 0]], every constant of the solve (the Toeplitz of
    g, the side product, the boundary matrix M) is built from h, and the
    boundary chain runs ``_vec2_recurrence`` with a tensor M, so autograd
    reaches all five coefficients."""
    a1, a2, b0, b1, b2 = (c.to(dtype) for c in coeffs)
    x1, x2, y1, y2 = (s.to(dtype) for s in state)
    T = x.shape[-1]
    batch = x.shape[:-1]
    one = torch.ones((1,), dtype=dtype, device=x.device)
    zero = torch.zeros((1,), dtype=dtype, device=x.device)
    A = torch.stack([torch.stack([-a1, -a2]), torch.cat([one, zero])])
    h = torch.cat([one, _powers(A, C)[:, 0, 0]])             # [C+1]
    g = (b0 * h + b1 * torch.cat([zero, h[:-1]])
         + b2 * torch.cat([zero, zero, h[:-2]]))

    K = -(-T // C)
    X = _pad_last(x.to(dtype), K * C - T).reshape(*batch, K, C)
    hs = torch.cat([zero, h[:C - 1]])                        # h[i-1], [C]
    Ltg = _toeplitz(g, C)
    pick = np.zeros((C, 2), _np_dtype(dtype))
    pick[C - 1, 0] = pick[C - 2, 1] = 1.0
    S = torch.cat([torch.stack([g[:C].flip(0),
                                torch.cat([g[:C - 1].flip(0), zero])], -1),
                   _const(pick, X)], dim=-1)                 # [C, 4]
    side = X @ S                                             # [..., K, 4]

    xlast1 = torch.cat([x1[..., None], side[..., :-1, 2]], dim=-1)
    xlast2 = torch.cat([x2[..., None], side[..., :-1, 3]], dim=-1)
    d0 = b1 * xlast1 + b2 * xlast2
    d1 = b2 * xlast1
    w = torch.stack([side[..., :, 0] + d0 * h[C - 1] + d1 * h[C - 2],
                     side[..., :, 1] + d0 * h[C - 2] + d1 * h[C - 3]], dim=-1)
    M = torch.stack([torch.stack([h[C], -a2 * h[C - 1]]),
                     torch.stack([h[C - 1], -a2 * h[C - 2]])])
    s0 = torch.stack([y1, y2], dim=-1)                       # [..., 2]
    w = torch.cat([w[..., :1, :] + torch.einsum("ij,...j->...i", M, s0)[
        ..., None, :], w[..., 1:, :]], dim=-2)
    s = _vec2_recurrence(M, w)
    s_in = torch.cat([s0[..., None, :], s[..., :-1, :]], dim=-2)

    y = (X @ Ltg
         + s_in[..., :, 0:1] * h[1:]
         - a2 * s_in[..., :, 1:2] * h[:-1]
         + d0[..., :, None] * h[:C]
         + d1[..., :, None] * hs)
    y = y.reshape(*batch, K * C)[..., :T].to(torch.float32)
    return y, (x[..., -1], x[..., -2], y[..., -1], y[..., -2])


@functools.lru_cache(maxsize=64)
def _power_tensor(M_bytes: bytes, n: int, C2: int, dtype):
    """(Mpow [C2+1, n, n], Lt [C2, C2, n, n]) with Lt[j, i] = M^(i-j) for
    j <= i: powers chained in f64, cast once to ``dtype``."""
    M64 = np.frombuffer(M_bytes, dtype).reshape(n, n).astype(np.float64)
    Mpow = np.empty((C2 + 1, n, n), np.float64)
    Mpow[0] = np.eye(n)
    for t in range(1, C2 + 1):
        Mpow[t] = M64 @ Mpow[t - 1]
    Mpow = Mpow.astype(dtype)
    i = np.arange(C2)
    Lt = np.where((i[:, None] <= i[None, :])[..., None, None],
                  Mpow[np.clip(i[None, :] - i[:, None], 0, C2)],
                  0.0).astype(dtype)
    return Mpow, Lt


def _contiguous(M, npdt):
    return np.ascontiguousarray(M, npdt)


def _matrix_powers(M, C2: int):
    """``_power_tensor`` of a contiguous NumPy M."""
    return _power_tensor(M.tobytes(), M.shape[0], C2, M.dtype.type)


def _vecn_recurrence(M_np: np.ndarray, w, C2: int = 128):
    """s_k = M s_{k-1} + w_k with a constant [n, n] NumPy M (or Data, a
    stream's slider), s_{-1} = 0, w [..., K, n].  Within a chunk of C2
    steps the zero-state response is one product against the masked power
    tensor Lt[j, i] = M^(i-j); chunk carries recurse.  Eight steps or
    fewer run sequentially."""
    M_np = lift(_contiguous, M_np, _np_dtype(w.dtype))
    n = M_np.shape[0]
    K = w.shape[-2]
    batch = w.shape[:-2]
    if K <= 8:
        M = _const(M_np, w)
        prev = torch.zeros_like(w[..., 0, :])
        out = []
        for k in range(K):
            prev = torch.einsum("ij,...j->...i", M, prev) + w[..., k, :]
            out.append(prev)
        return torch.stack(out, dim=-2)

    KG = -(-K // C2)
    pad = KG * C2 - K
    wp = F.pad(w, (0, 0, 0, pad)) if pad else w
    W = wp.reshape(*batch, KG, C2, n)
    powers = lift(_matrix_powers, M_np, C2)
    Mpow, Lt = item(powers, 0), item(powers, 1)
    zs = torch.einsum("jiab,...kjb->...kia", _const(Lt, w), W)
    ends = zs[..., :, C2 - 1, :]                            # [..., KG, n]
    e = _vecn_recurrence(item(Mpow, C2), ends, C2)
    carry_in = torch.cat([torch.zeros_like(e[..., :1, :]), e[..., :-1, :]],
                         dim=-2)
    s = zs + torch.einsum("iab,...kb->...kia", _const(lift(_from1, Mpow), w),
                          carry_in)
    return s.reshape(*batch, KG * C2, n)[..., :K, :]


def _vec2_recurrence(M, w, C2: int = 128):
    """s_k = M s_{k-1} + w_k for a constant [2, 2] M, s_{-1} = 0: the
    biquad's boundary chain.  A NumPy M takes the n-dim solver with host
    constants; a tensor M (fitted coefficients) the JAX package's traced-M
    solver, with the power tensor built from M on the device."""
    if tuple(M.shape) != (2, 2):
        raise ValueError(f"_vec2_recurrence needs a [2, 2] M, got "
                         f"{tuple(M.shape)}")
    if not isinstance(M, torch.Tensor):
        return _vecn_recurrence(M, w, C2)
    K = w.shape[-2]
    batch = w.shape[:-2]
    if K <= 8:
        prev = torch.zeros_like(w[..., 0, :])
        out = []
        for k in range(K):
            prev = torch.einsum("ij,...j->...i", M, prev) + w[..., k, :]
            out.append(prev)
        return torch.stack(out, dim=-2)
    KG = -(-K // C2)
    pad = KG * C2 - K
    wp = F.pad(w, (0, 0, 0, pad)) if pad else w
    W = wp.reshape(*batch, KG, C2, 2)
    Mpow = torch.cat([torch.eye(2, dtype=M.dtype, device=M.device)[None],
                      _powers(M, C2)])                        # M^0..M^C2
    zs = torch.einsum("jiab,...kjb->...kia", _toeplitz(Mpow, C2), W)
    ends = zs[..., :, C2 - 1, :]                              # [..., KG, 2]
    e = _vec2_recurrence(Mpow[C2], ends, C2)
    carry_in = torch.cat([torch.zeros_like(e[..., :1, :]), e[..., :-1, :]],
                         dim=-2)
    s = zs + torch.einsum("iab,...kb->...kia", Mpow[1:], carry_in)
    return s.reshape(*batch, KG * C2, 2)[..., :K, :]
