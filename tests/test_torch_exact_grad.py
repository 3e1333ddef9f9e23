"""The exact policy's gradients on the card's route: the autograd Functions
over the sequential kernel (ops/scan.py ``SequentialFirstOrder`` and
``SequentialBiquad``) and the plain versions of the kernel's reverse mode
(``_first_order_adjoint_sequential``, ``_biquad_adjoint_sequential``).

The kernel runs only on the card (chip_smoke.grad_phase holds its reverse
mode against these plain loops there).  Here the Functions run with the
plain forward loops and the plain reverse loops standing in for the
kernel, as ``run_first_order`` / ``run_biquad`` route a CUDA tensor, and
are held

* against autograd straight through the plain forward loops (the CPU's
  exact path): y bitwise; every gradient within rtol 1e-5, arrays
  max-normalized (max |got - want| / max |want|), at T = 1, 2, 3, 130
  (the biquad's boundary terms at t = 0, 1 and its final state at T = 1,
  2 are where an off-by-one would show) and 1 or 5 rows (5: not a
  multiple of the kernel's 32-row CTA);
* against jax.grad of the JAX package's sequential loops under its exact
  policy (lax.scan's VJP), rtol 1e-5 as test_torch_exact.py holds the CPU
  path: the sums over samples run in another order;
* through compile_graph: the bench chain's 16 slider gradients under
  exact, its solves routed as on the card, against the CPU path's and
  jax.grad's, rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dsp_stuff_tpu as dj
from dsp_stuff_tpu.ops import scan as jscan
from dsp_stuff_tpu.train import fit as jfit
from dsp_stuff_tpu.utils import precision as jprec
import dsp_stuff_tpu_torch as dt
from dsp_stuff_tpu_torch.ids import IdSpace as TIdSpace
from dsp_stuff_tpu_torch.ops import scan as tscan
from dsp_stuff_tpu_torch.train import fit as tfit
from dsp_stuff_tpu_torch.utils import precision as tprec
from dsp_stuff_tpu_torch.utils.precision import on_device

F32 = np.float32
RTOL = 1e-5
SHAPES = [(r, t) for t in (1, 2, 3, 130) for r in (1, 5)]
BQ_COEFFS = {"general": (-0.3, 0.05, 0.8, 0.1, -0.05),
             "resonant": (-1.8, 0.81, 0.1, 0.2, 0.1)}


@pytest.fixture(autouse=True)
def _torch_env():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    prev = tprec.get_policy()
    yield
    tprec.set_policy(prev)
    torch.set_num_threads(threads)


def _held(got, want, rtol=RTOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= rtol, err
    return err


def fo_plain(a, b, y0):
    return tscan._first_order_sequential(a, b, y0)


def bq_plain(x, c, st):
    y, fin = tscan._biquad_sequential(x, *c.unbind(0), tuple(st.unbind(-1)))
    return y, torch.stack(fin, dim=-1)


def _fo_inputs(R, T, per_sample, seed):
    rng = np.random.default_rng(seed)
    a = (rng.uniform(-0.95, 0.95, (R, T)) if per_sample
         else np.asarray(0.83)).astype(F32)
    return (a, (rng.standard_normal((R, T)) * 0.5).astype(F32),
            (rng.standard_normal(R) * 0.3).astype(F32),
            rng.standard_normal((R, T)).astype(F32))


def _bq_inputs(R, T, coeffs, seed):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal((R, T)) * 0.5).astype(F32),
            np.asarray(BQ_COEFFS[coeffs], F32),
            (rng.standard_normal((R, 4)) * 0.3).astype(F32),
            rng.standard_normal((R, T)).astype(F32),
            rng.standard_normal((R, 4)).astype(F32))


def _leaves(arrs):
    return [torch.tensor(a, requires_grad=True) for a in arrs]


# -- the Functions against the plain loops' autograd --------------------------

@pytest.mark.parametrize("per_sample", [False, True],
                         ids=["scalar", "per-sample"])
@pytest.mark.parametrize("R,T", SHAPES)
def test_first_order_function_matches_plain_autograd(R, T, per_sample):
    a, b, y0, w = _fo_inputs(R, T, per_sample, 10 * T + R)
    fn = _leaves((a, b, y0))
    y = tscan.SequentialFirstOrder.apply(
        fo_plain, tscan._first_order_adjoint_sequential, *fn)
    (y * torch.from_numpy(w)).sum().backward()
    ref = _leaves((a, b, y0))
    y_ref = fo_plain(*ref)
    (y_ref * torch.from_numpy(w)).sum().backward()
    assert torch.equal(y, y_ref)
    for got, want in zip(fn, ref):
        _held(got.grad.numpy(), want.grad.numpy())


@pytest.mark.parametrize("coeffs", sorted(BQ_COEFFS))
@pytest.mark.parametrize("R,T", SHAPES)
def test_biquad_function_matches_plain_autograd(R, T, coeffs):
    """With cotangents on y and on the final state (x1, x2, y1, y2): at
    T = 1 its x2 and y2 are the initial x1 and y1."""
    x, c, st, w, wf = _bq_inputs(R, T, coeffs, 10 * T + R)
    fn = _leaves((x, c, st))
    y, fin = tscan.SequentialBiquad.apply(
        bq_plain, tscan._biquad_adjoint_sequential, *fn)
    ((y * torch.from_numpy(w)).sum() + (fin * torch.from_numpy(wf)).sum()
     ).backward()
    ref = _leaves((x, c, st))
    y_ref, fin_ref = bq_plain(*ref)
    ((y_ref * torch.from_numpy(w)).sum()
     + (fin_ref * torch.from_numpy(wf)).sum()).backward()
    assert torch.equal(y, y_ref) and torch.equal(fin, fin_ref)
    for got, want in zip(fn, ref):
        _held(got.grad.numpy(), want.grad.numpy())
    # each coefficient on its own, against the adjoint in float64 at the
    # same trajectory: autograd through the loop sums the per-sample terms
    # in f32 (1.4e-3 off float64 on the resonant a1 at T = 130), the
    # Function in float64, so a small coefficient gradient left by
    # cancellation is held to the float64 one
    fb = torch.from_numpy(wf).double()
    yb = torch.from_numpy(w).double().clone()
    yb[:, T - 1] += fb[:, 2]
    if T >= 2:
        yb[:, T - 2] += fb[:, 3]
    _, _, acc = tscan._biquad_adjoint_sequential(
        torch.from_numpy(x).double(), y.detach().double(),
        torch.from_numpy(c).double(), torch.from_numpy(st).double(), yb)
    np.testing.assert_allclose(fn[1].grad.numpy(), acc.sum(0).numpy(),
                               rtol=RTOL, atol=1e-6)


@pytest.mark.parametrize("which", ["y", "final"])
def test_biquad_function_one_cotangent(which):
    """Only y, or only the final state, carries a cotangent: the other
    arrives as None and counts as zeros."""
    x, c, st, w, wf = _bq_inputs(5, 130, "resonant", 3)
    fn, ref = _leaves((x, c, st)), _leaves((x, c, st))
    outs = tscan.SequentialBiquad.apply(
        bq_plain, tscan._biquad_adjoint_sequential, *fn)
    outs_ref = bq_plain(*ref)
    k, wt = (0, w) if which == "y" else (1, wf)
    (outs[k] * torch.from_numpy(wt)).sum().backward()
    (outs_ref[k] * torch.from_numpy(wt)).sum().backward()
    for got, want in zip(fn, ref):
        _held(got.grad.numpy(), want.grad.numpy())


# -- against jax.grad under exact ---------------------------------------------

@pytest.mark.parametrize("per_sample", [False, True],
                         ids=["scalar", "per-sample"])
@pytest.mark.parametrize("R,T", [(1, 1), (1, 2), (5, 3), (5, 130)])
def test_first_order_function_matches_jax_grad(R, T, per_sample):
    a, b, y0, w = _fo_inputs(R, T, per_sample, 7 * T + R)
    fn = _leaves((a, b, y0))
    with tprec.policy("exact"):
        y = tscan.SequentialFirstOrder.apply(
            fo_plain, tscan._first_order_adjoint_sequential, *fn)
    (y * torch.from_numpy(w)).sum().backward()

    def loss(aa, bb, yy):
        return jnp.sum(jscan._first_order_sequential(aa, bb, yy) * w)

    with jprec.policy("exact"):
        want = jax.grad(loss, argnums=(0, 1, 2))(a, b, y0)
    for got, wj in zip(fn, want):
        _held(got.grad.numpy(), np.asarray(wj))


@pytest.mark.parametrize("coeffs", sorted(BQ_COEFFS))
@pytest.mark.parametrize("R,T", [(1, 1), (1, 2), (5, 3), (5, 130)])
def test_biquad_function_matches_jax_grad(R, T, coeffs):
    x, c, st, w, wf = _bq_inputs(R, T, coeffs, 7 * T + R)
    fn = _leaves((x, c, st))
    with tprec.policy("exact"):
        y, fin = tscan.SequentialBiquad.apply(
            bq_plain, tscan._biquad_adjoint_sequential, *fn)
    ((y * torch.from_numpy(w)).sum() + (fin * torch.from_numpy(wf)).sum()
     ).backward()

    def loss(xx, cc, ss):
        y, fin = jscan._biquad_sequential(xx, *cc, tuple(ss.T))
        return jnp.sum(y * w) + jnp.sum(jnp.stack(fin, -1) * wf)

    with jprec.policy("exact"):
        want = jax.grad(loss, argnums=(0, 1, 2))(x, c, st)
    for got, wj in zip(fn, want):
        _held(got.grad.numpy(), np.asarray(wj))


# -- the reverse loops' arithmetic --------------------------------------------

def test_reverse_wrappers_take_only_cuda_tensors():
    """The reverse mode's wrappers never fall back: a CPU tensor raises
    (before any build)."""
    from dsp_stuff_tpu_torch.ops import sequential_kernel
    b = torch.zeros((2, 8))
    with pytest.raises(ValueError, match="CUDA"):
        sequential_kernel.first_order_reverse_cuda(
            torch.tensor(0.5), b, torch.zeros(2), b)
    with pytest.raises(ValueError, match="CUDA"):
        sequential_kernel.biquad_reverse_cuda(b, b, torch.zeros(5),
                                              torch.zeros((2, 4)), b)


def test_first_order_adjoint_pins_its_order():
    """The plain reverse loop is the kernel's sequence of roundings: lam by
    the f32 recurrence from the end, abar as f32 products summed in
    float64 from t = T-1 down, y0bar = a lam[0] (a float64 NumPy model
    of the same steps, each rounded to f32 where the kernel rounds)."""
    a, b, y0, w = _fo_inputs(3, 70, False, 1)
    y = fo_plain(*map(torch.from_numpy, (a, b, y0))).numpy()
    lam_t, acc_t, y0bar_t = tscan._first_order_adjoint_sequential(
        torch.from_numpy(a), torch.from_numpy(y), torch.from_numpy(y0),
        torch.from_numpy(w))
    lam = np.zeros(3, F32)
    acc = np.zeros(3, np.float64)
    lams = np.empty((3, 70), F32)
    yprev = np.concatenate([y0[:, None], y[:, :-1]], axis=1)
    for t in range(69, -1, -1):
        lam = (w[:, t] + F32(a) * lam).astype(F32)
        lams[:, t] = lam
        acc = acc + (lam * yprev[:, t]).astype(F32).astype(np.float64)
    np.testing.assert_array_equal(lam_t.numpy(), lams)
    np.testing.assert_array_equal(acc_t.numpy(), acc)
    np.testing.assert_array_equal(y0bar_t.numpy(), (F32(a) * lam))


# -- through compile_graph ----------------------------------------------------

def _card_route(monkeypatch):
    """Route the exact solves as a CUDA tensor routes them (run_first_order
    / run_biquad, the Functions when autograd must see them), with the
    plain loops standing in for the kernel's two modes; returns the calls
    of each stand-in."""
    calls = {"forward": 0, "reverse": 0}

    def counted(fn, key):
        def wrapped(*args):
            calls[key] += 1
            return fn(*args)
        return wrapped

    def fo_exact(a, b, y0):
        a = on_device(float(np.float32(a)), b.device) \
            if not isinstance(a, torch.Tensor) else a.to(torch.float32)
        y0 = y0.to(torch.float32).expand(b.shape[:-1])
        return tscan.run_first_order(
            counted(fo_plain, "forward"),
            counted(tscan._first_order_adjoint_sequential, "reverse"),
            a, b, y0)

    def bq_exact(x, cvals, state):
        coeffs = torch.stack([
            c.to(torch.float32) if isinstance(c, torch.Tensor)
            else torch.tensor(float(np.float32(c))) for c in cvals])
        return tscan.run_biquad(
            counted(bq_plain, "forward"),
            counted(tscan._biquad_adjoint_sequential, "reverse"),
            x, coeffs, state)

    monkeypatch.setattr(tscan, "_first_order_exact", fo_exact)
    monkeypatch.setattr(tscan, "_biquad_exact", bq_exact)
    return calls


def _bench_pair(T):
    import __graft_entry__
    with jprec.policy("exact"):
        cgj, inp = __graft_entry__._build(T, seconds=0.003)
    gt = dt.loads_graph(dj.dumps_graph(cgj.graph), ids=TIdSpace())
    return cgj, dt.compile_graph(gt, device="cpu"), str(inp)


def _port_grads(cgt, inp, x, target, pj):
    pt = {n: {k: torch.tensor(float(np.asarray(v)), requires_grad=True)
              for k, v in e.items()} for n, e in pj.items()}
    xt = torch.tensor(x, requires_grad=True)
    with tprec.policy("exact"):
        loss = tfit.make_loss_fn(cgt)(pt, cgt.init_state(), {inp: xt},
                                      torch.from_numpy(target))
        loss.backward()
    return loss.detach(), pt, xt.grad


def test_bench_chain_exact_gradients_on_the_card_route(monkeypatch):
    """All 16 sliders and the input of the bench chain under exact: the
    card's route (three forward solves and three reverse ones, none of
    the CPU's plain-loop autograd) against the CPU path and jax.grad
    under the JAX package's exact policy."""
    T = 1024
    rng = np.random.default_rng(31)
    x = (rng.standard_normal((2, T)) * 0.25).astype(F32)
    target = (rng.standard_normal((2, 1, T)) * 0.1).astype(F32)
    cgj, cgt, inp = _bench_pair(T)
    pj = jax.tree.map(np.asarray, cgj.init_params())
    l_cpu, p_cpu, gx_cpu = _port_grads(cgt, inp, x, target, pj)
    calls = _card_route(monkeypatch)
    l_card, p_card, gx_card = _port_grads(cgt, inp, x, target, pj)
    assert calls == {"forward": 3, "reverse": 3}
    with jprec.policy("exact"):
        lj, (gj, gxj) = jax.value_and_grad(
            jfit.make_loss_fn(cgj), argnums=(0, 2))(
                pj, cgj.init_state(), {inp: x}, target)
    assert float(l_card) == float(l_cpu)
    np.testing.assert_allclose(float(l_card), float(lj), rtol=RTOL)
    leaves = [(n, k) for n in sorted(p_card) for k in sorted(p_card[n])]
    assert len(leaves) == 16
    for n, k in leaves:
        for want in (p_cpu[n][k].grad, gj[n][k]):
            np.testing.assert_allclose(float(p_card[n][k].grad),
                                       float(want), rtol=RTOL, atol=1e-9,
                                       err_msg=f"{n}/{k}")
    _held(gx_card.numpy(), gx_cpu.numpy())
    _held(gx_card.numpy(), np.asarray(gxj[inp]))
