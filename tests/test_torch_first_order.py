"""The port's first-order recurrence (dsp_stuff_tpu_torch/ops/scan.py:
first_order_affine, FirstOrderAffine, first_order_solve) and the CPU-side
half of its CUDA kernel (ops/first_order_kernel.py) against the JAX
package and the NumPy oracle.

The CUDA kernel runs only on a GPU (chip_smoke.py holds it against the
plain versions and a float64 solve there).  Here the plain versions, which
a CPU tensor takes, are held against the JAX package: its Pallas kernel in
interpret mode (called as tests/test_pallas.py calls it), its
first_order_affine with an array coefficient, and jax.grad of its
first_order_affine.

Bounds, each with the worst the CPU measured:
  plain vs pallas interpret / oracle.low_pass   <= -90 dBFS (-128.9)
  reverse and per-sample a vs JAX               <= -110 dBFS (-130.5)
  gradients (abar, bbar, y0bar) vs jax.grad     rtol 1e-4 (1.6e-6)
  float64 gradcheck                             torch's defaults
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle
from dsp_stuff_tpu.ops import scan as jscan
from dsp_stuff_tpu.ops.pallas_scan import first_order_pallas
from dsp_stuff_tpu.utils import precision as jprec
from dsp_stuff_tpu_torch.ops import first_order_kernel as tfk
from dsp_stuff_tpu_torch.ops import scan as tscan
from dsp_stuff_tpu_torch.utils import precision as tprec

PALLAS_DB = -90.0
VS_JAX_DB = -110.0
GRAD_RTOL = 1e-4


@pytest.fixture(autouse=True)
def _torch_env():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    prev = tprec.get_policy()
    yield
    tprec.set_policy(prev)
    torch.set_num_threads(threads)


def _fast_affine(a, b, y0):
    """The port's first_order_affine with a 0-d tensor coefficient under
    ``fast`` on the CPU: FirstOrderAffine, the plain blocked solve."""
    with tprec.policy("fast"):
        return tscan.first_order_affine(
            torch.tensor(np.float32(a)), torch.from_numpy(np.asarray(b)),
            torch.tensor(np.float32(y0))).numpy()


@pytest.mark.parametrize("T", [100, 8192, 20000])
def test_plain_matches_pallas_interpret_and_oracle(T):
    x = np.random.default_rng(0).standard_normal(T).astype(np.float32)
    b = x * np.float32(0.1)
    got = _fast_affine(0.9, b, 0.3)
    pk = np.asarray(first_order_pallas(np.float32(0.9), b, np.float32(0.3),
                                       interpret=True))
    want, _ = oracle.low_pass(x, 0.9, np.float32(0.3))
    assert oracle.max_err_dbfs(got, want) <= PALLAS_DB
    assert oracle.max_err_dbfs(got, pk) <= PALLAS_DB


def test_plain_matches_pallas_interpret_batch():
    xb = np.random.default_rng(1).standard_normal((3, 9000)).astype(np.float32)
    b = xb * np.float32(0.2)
    got = _fast_affine(0.8, b, 0.0)
    pk = np.asarray(first_order_pallas(np.float32(0.8), b, np.float32(0.0),
                                       interpret=True))
    for i in range(3):
        want, _ = oracle.low_pass(xb[i], 0.8)
        assert oracle.max_err_dbfs(got[i], want) <= PALLAS_DB, i
        assert oracle.max_err_dbfs(got[i], pk[i]) <= PALLAS_DB, i


def _dbfs(got, want):
    return oracle.max_err_dbfs(np.asarray(got), np.asarray(want))


def _inputs(seed, B=3, T=2500, per_sample=False, a=0.9):
    rng = np.random.default_rng(seed)
    b = (rng.standard_normal((B, T)) * 0.3).astype(np.float32)
    y0 = rng.standard_normal(B).astype(np.float32)
    av = (a * rng.uniform(0.8, 1.0, (B, T))).astype(np.float32) \
        if per_sample else np.float32(a)
    return av, b, y0


@pytest.mark.parametrize("pol", ["fast", "parity"])
@pytest.mark.parametrize("per_sample", [False, True])
def test_reverse_matches_jax_on_flipped_input(pol, per_sample):
    """reverse: y[t] = a[t] y[t+1] + b[t], y[T] = y0, is the forward
    recurrence on the time-flipped arrays."""
    a, b, y0 = _inputs(2, per_sample=per_sample)
    flip = (lambda v: v[..., ::-1].copy()) if per_sample else (lambda v: v)
    with jprec.policy(pol):
        want = np.asarray(jscan.first_order_affine(
            jnp.asarray(flip(a)), jnp.asarray(b[..., ::-1].copy()),
            jnp.asarray(y0)))[..., ::-1]
    with tprec.policy(pol):
        got = tscan.first_order_solve(torch.tensor(a), torch.from_numpy(b),
                                      torch.from_numpy(y0), reverse=True)
    assert got.dtype == torch.float32
    assert _dbfs(got.numpy(), want) <= VS_JAX_DB


@pytest.mark.parametrize("pol", ["fast", "parity"])
@pytest.mark.parametrize("T", [1, 300, 4099])
def test_time_varying_matches_jax_associative_scan(pol, T):
    """A per-sample coefficient, zeros included, against the JAX package's
    associative scan at the policy's internal dtype."""
    a, b, y0 = _inputs(3, T=T, per_sample=True)
    a[:, ::7] = 0.0
    with jprec.policy(pol):
        want = np.asarray(jscan.first_order_affine(
            jnp.asarray(a), jnp.asarray(b), jnp.asarray(y0)))
    with tprec.policy(pol):
        got = tscan.first_order_affine(torch.from_numpy(a),
                                       torch.from_numpy(b),
                                       torch.from_numpy(y0))
    assert _dbfs(got.numpy(), want) <= VS_JAX_DB


def test_scan_matches_sequential_loop():
    """The plain per-sample solve (Hillis-Steele) against the recurrence
    written out, in float64: equal to rounding."""
    a, b, y0 = _inputs(4, B=2, T=1000, per_sample=True)
    a, b, y0 = (np.asarray(v, np.float64) for v in (a, b, y0))
    want = np.empty_like(b)
    y = y0.copy()
    for t in range(b.shape[-1]):
        y = a[:, t] * y + b[:, t]
        want[:, t] = y
    got = tscan._first_order_scan(torch.from_numpy(a), torch.from_numpy(b),
                                  torch.from_numpy(y0)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def _grads_jax(a, b, y0, ybar, pol="fast"):
    with jprec.policy(pol):
        def f(aa, bb, yy):
            return jnp.sum(jscan.first_order_affine(aa, bb, yy) * ybar)
        return jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(a), jnp.asarray(b),
                                              jnp.asarray(y0))


def _grads_port(a, b, y0, ybar, pol="fast"):
    at, bt, yt = (torch.tensor(np.asarray(v), requires_grad=True)
                  for v in (a, b, y0))
    with tprec.policy(pol):
        y = tscan.first_order_affine(at, bt, yt)
        torch.sum(y * torch.from_numpy(ybar)).backward()
    return at.grad, bt.grad, yt.grad


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("a", [0.2, 0.6, 0.99, "per-sample"])
def test_gradients_match_jax_grad(a):
    """abar, bbar and y0bar of FirstOrderAffine against jax.grad of the JAX
    package's first_order_affine (AD through its XLA blocked solve, or its
    associative scan for a per-sample a)."""
    per_sample = a == "per-sample"
    av, b, y0 = _inputs(5, T=1000 if per_sample else 2500,
                        per_sample=per_sample, a=0.95 if per_sample else a)
    ybar = np.random.default_rng(6).standard_normal(b.shape).astype(
        np.float32)
    want = _grads_jax(av, b, y0, ybar)
    got = _grads_port(av, b, y0, ybar)
    for name, g, w in zip(("abar", "bbar", "y0bar"), got, want):
        assert g.shape == np.shape(w), name
        assert _rel(g.numpy(), w) <= GRAD_RTOL, (name, _rel(g.numpy(), w))


@pytest.mark.parametrize("a", [0.0, 1.0])
def test_gradients_at_the_slider_ends(a):
    """The ratio slider spans [0, 1] and clamp_params can land on either
    end: the solve and its gradients stay finite and match jax.grad."""
    av, b, y0 = _inputs(7, a=a)
    ybar = np.random.default_rng(8).standard_normal(b.shape).astype(
        np.float32)
    want = _grads_jax(av, b, y0, ybar)
    got = _grads_port(av, b, y0, ybar)
    for g, w in zip(got, want):
        assert np.isfinite(g.numpy()).all()
        assert _rel(g.numpy(), w) <= GRAD_RTOL


@pytest.mark.parametrize("per_sample", [False, True])
def test_gradcheck_float64(per_sample):
    """torch.autograd.gradcheck of FirstOrderAffine in float64 (the plain
    float64 solve under ``parity``) on a [2, 300] input."""
    g = torch.Generator().manual_seed(0)
    a = (0.9 * torch.rand((2, 300) if per_sample else (), generator=g,
                          dtype=torch.float64)).requires_grad_(True)
    b = torch.randn((2, 300), generator=g, dtype=torch.float64,
                    requires_grad=True)
    y0 = torch.randn(2, generator=g, dtype=torch.float64, requires_grad=True)
    with tprec.policy("parity"):
        assert torch.autograd.gradcheck(tscan.FirstOrderAffine.apply,
                                        (a, b, y0))


def test_concrete_coefficient_keeps_the_host_constant_path():
    """A Python float on the CPU is today's host-constant blocked solve,
    bit for bit, and launches nothing."""
    a, b, y0 = _inputs(9)
    before = tfk.LAUNCHES
    with tprec.policy("fast"):
        got = tscan.first_order_affine(float(a), torch.from_numpy(b),
                                       torch.from_numpy(y0))
        want = tscan._first_order_blocked(float(a), torch.from_numpy(b),
                                          torch.from_numpy(y0))
        via_fn = tscan.first_order_affine(torch.tensor(a),
                                          torch.from_numpy(b),
                                          torch.from_numpy(y0))
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_array_equal(via_fn.numpy(), want.numpy())
    assert tfk.LAUNCHES == before


def test_kernel_wrapper_refuses_cpu_tensors():
    """No fallback inside the wrapper: a CPU tensor is refused, and the
    launch count does not move."""
    before = tfk.LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        tfk.first_order_cuda(torch.tensor(0.5), torch.zeros((2, 256)),
                             torch.zeros(2))
    assert tfk.LAUNCHES == before


def test_rejects_mismatched_per_sample_coefficient():
    with pytest.raises(ValueError, match="shape"):
        tscan.first_order_affine(torch.zeros(5), torch.zeros((2, 5)), 0.0)
