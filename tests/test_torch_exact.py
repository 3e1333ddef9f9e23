"""The port's exact precision policy on the CPU, held bitwise
(``assert_array_equal``).

* The sequential solves' plain versions (ops/scan.py:
  ``_first_order_sequential`` with a scalar or per-sample a, and
  ``_biquad_sequential``) against the JAX package's functions of the same
  names, run on the CPU, and against a float32 NumPy loop written here, at
  edge shapes (T = 1 for the first order, 2 for the biquad; T = 127, 128,
  129; one row and eight) from carried states.
* Ports of the JAX package's exact tests against tests/oracle:
  tests/test_nodes_oracle.py (low pass, high pass, FIR, the generator's
  non-transcendental modes, the biquad, the envelope after a fast call of
  the same shape) and tests/test_graph.py (three-way fan-in, a chain, the
  polynomial distortions, mix, the reverb, through compile_graph).
* Routing under exact: none of the blocked, Toeplitz, cascade,
  chain-segment or cycle-segment paths is called, the sequential plain
  versions are.
* Gradients under exact on the CPU go through the plain loops' autograd,
  held against jax.grad under the JAX package's exact policy (the card's
  route, the kernel's reverse mode, is test_torch_exact_grad.py's); the
  kernel wrapper's refusal of CPU tensors.
* The divide and multiply fences (utils/precision.py) against the JAX
  package's.

The kernel itself (csrc/sequential_kernel.cu) runs only on the card:
chip_smoke.py holds it bitwise against these plain versions there.
"""

import jax
import numpy as np
import pytest
import torch

import dsp_stuff_tpu_torch as dt
import oracle
from chip_smoke import calls_counted
from dsp_stuff_tpu.ops import scan as jscan
from dsp_stuff_tpu.utils import precision as jprec
from dsp_stuff_tpu_torch.compiler import compile as tcompile
from dsp_stuff_tpu_torch.ids import IdSpace
from dsp_stuff_tpu_torch.ops import cascade as tcasc
from dsp_stuff_tpu_torch.ops import chain_segment as tcs
from dsp_stuff_tpu_torch.ops import envelope as tenv
from dsp_stuff_tpu_torch.ops import fir as tfir
from dsp_stuff_tpu_torch.ops import gen as tgen
from dsp_stuff_tpu_torch.ops import scan as tscan
from dsp_stuff_tpu_torch.ops import sequential_kernel
from dsp_stuff_tpu_torch.utils import precision as tprec

F32 = np.float32
T_NODE = 1024

# (R, T) of the plain versions' checks: T = 1 (2 for the biquad, which
# needs two samples), a 128-sample block and a sample either side
FO_SHAPES = [(r, t) for t in (1, 127, 128, 129) for r in (1, 8)]
BQ_SHAPES = [(r, t) for t in (2, 127, 128, 129) for r in (1, 8)]
# (a1, a2, b0, b1, b2): a general section and a resonant one
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


def _sig(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(F32)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=F32))


# -- the policy -------------------------------------------------------------

def test_set_policy_exact_round_trip():
    """set_policy("exact") selects the exact policy (it used to raise), and
    the context manager restores the one before it."""
    prev = tprec.set_policy("parity")
    assert prev.name == "parity"
    got = tprec.set_policy("exact")
    assert got is tprec.EXACT and tprec.get_policy() is tprec.EXACT
    assert (got.sequential_recurrences, got.scan_internal_dtype,
            got.fir_accum_dtype) == (True, "float32", "float64")
    assert not tprec.FAST.sequential_recurrences
    assert not tprec.PARITY.sequential_recurrences
    with dt.policy("fast") as p:
        assert p.name == "fast"
    assert tprec.get_policy() is tprec.EXACT
    tprec.set_policy(tprec.PARITY)
    with dt.policy(tprec.EXACT) as p:
        assert p is tprec.EXACT
    assert tprec.get_policy() is tprec.PARITY
    with pytest.raises(KeyError):
        tprec.set_policy("bitwise")


# -- the plain versions against JAX and a NumPy loop ------------------------

def _np_first_order(a, b, y0):
    y = y0.copy()
    out = np.empty_like(b)
    for t in range(b.shape[-1]):
        at = a[..., t] if a.ndim else a
        y = (at * y).astype(F32) + b[..., t]
        out[..., t] = y
    return out


@pytest.mark.parametrize("per_sample", [False, True],
                         ids=["scalar", "per-sample"])
@pytest.mark.parametrize("R,T", FO_SHAPES)
def test_first_order_sequential_vs_jax(R, T, per_sample):
    rng = np.random.default_rng(10 * R + T)
    b = _sig(rng.integers(1 << 30), (R, T), 0.5)
    y0 = _sig(rng.integers(1 << 30), (R,), 0.5)
    a = (rng.uniform(-0.99, 0.99, (R, T)).astype(F32) if per_sample
         else F32(0.9173))
    got = tscan._first_order_sequential(_t(a), _t(b), _t(y0)).numpy()
    want = np.asarray(jax.jit(jscan._first_order_sequential)(a, b, y0))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _np_first_order(a, b, y0))
    # and the policy's entry point, with y0 carried
    with dt.policy("exact"):
        aff = tscan.first_order_affine(
            _t(a) if per_sample else float(a), _t(b), _t(y0))
    np.testing.assert_array_equal(aff.numpy(), want)


def _np_biquad(x, cf, state):
    a1, a2, b0, b1, b2 = (F32(c) for c in cf)
    x1, x2, y1, y2 = (s.copy() for s in state)
    out = np.empty_like(x)
    for t in range(x.shape[-1]):
        xt = x[..., t]
        o = (b0 * xt).astype(F32) + (b1 * x1).astype(F32)
        o = o + (b2 * x2).astype(F32)
        o = o - (a1 * y1).astype(F32)
        o = o - (a2 * y2).astype(F32)
        x1, x2, y1, y2 = xt, x1, o, y1
        out[..., t] = o
    return out, (x1, x2, y1, y2)


@pytest.mark.parametrize("form", sorted(BQ_COEFFS))
@pytest.mark.parametrize("R,T", BQ_SHAPES)
def test_biquad_sequential_vs_jax(R, T, form):
    cf = tuple(F32(c) for c in BQ_COEFFS[form])
    x = _sig(100 * R + T, (R, T), 0.5)
    st = tuple(_sig(7 + i, (R,), 0.3) for i in range(4))
    got, gst = tscan._biquad_sequential(
        _t(x), *(torch.tensor(c) for c in cf), tuple(_t(s) for s in st))
    want, wst = jax.jit(jscan._biquad_sequential)(x, *cf, st)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    ny, nst = _np_biquad(x, cf, st)
    np.testing.assert_array_equal(got.numpy(), ny)
    for g, w, n in zip(gst, wst, nst):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(g.numpy(), n)
    with dt.policy("exact"):
        y, fin = tscan.biquad_df1(_t(x), *cf, tuple(_t(s) for s in st))
    np.testing.assert_array_equal(y.numpy(), np.asarray(want))
    for g, w in zip(fin, wst):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# -- ports of tests/test_nodes_oracle.py's exact tests ----------------------

def test_low_pass_exact_bitwise():
    x = _sig(0, T_NODE)
    want, _ = oracle.low_pass(x, 0.9)
    r = F32(0.9)
    with dt.policy("exact"):
        got = tscan.first_order_affine(r, _t(x * F32(1.0 - r)), 0.0)
    np.testing.assert_array_equal(got.numpy(), want)


def test_high_pass_exact_bitwise():
    """z = x*(1-r) + r*z; y = x - z (high_pass.rs:36-41)."""
    x = _sig(1, T_NODE)
    want, _ = oracle.high_pass(x, 0.3)
    r = F32(0.3)
    with dt.policy("exact"):
        z = tscan.first_order_affine(r, _t(x * F32(1.0 - r)), 0.0)
    np.testing.assert_array_equal(x - z.numpy(), want)


def test_fir_exact_bitwise():
    """The f64 accumulation of fir.rs:204-216, so exact is bitwise."""
    x = _sig(2, 512)
    taps_rev = np.random.default_rng(3).standard_normal(37)
    want, _ = oracle.fir(x, taps_rev, "Balanced")
    with dt.policy("exact"):
        got, _ = tfir.fir_apply(_t(x), taps_rev, None)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode", ["Triangle", "Constant"])
def test_signal_gen_nontranscendental_exact_bitwise(mode):
    """Triangle and Constant have no transcendental op
    (signal_gen.rs:73-108): the sequential clock gives the reference's
    bits."""
    want, _ = oracle.signal_gen(mode, 0.5, 440.0, 1024)
    with dt.policy("exact"):
        got, _ = tgen.oscillator(mode, 0.5, 440.0, 1024, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


def test_biquad_exact_bitwise():
    x = _sig(4, 512)
    want, _ = oracle.biquad_df1(x, 1.0, -0.24, 0.0, 0.758, 0.0, 0.0)
    with dt.policy("exact"):
        got, _ = tscan.biquad_df1(_t(x), F32(-0.24), F32(0.0), F32(0.758),
                                  F32(0.0), F32(0.0))
    np.testing.assert_array_equal(got.numpy(), want)


def test_envelope_policy_switch_no_stale_trace():
    """A fast call (long enough to take the chunked follower) and then an
    exact call of the same shape: the exact one is the sequential
    follower, bit for bit (the JAX package's review finding: a cache keyed
    on shapes alone)."""
    T = 2 * tenv._CHUNK + 512
    x = _sig(5, T, 0.5)
    with dt.policy("fast"):
        tenv.peak_envelope(_t(x), 50.0, 400.0)
    with dt.policy("exact"):
        got, _ = tenv.peak_envelope(_t(x), 50.0, 400.0)
    atk = tenv.gain_from_frames(50.0)
    rel = tenv.gain_from_frames(400.0)
    want, _ = tenv._seq_scan(_t(x), atk, rel, 0.0)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_array_equal(got.numpy(),
                                  oracle.envelope(x, 50.0, 400.0)[0])


# -- ports of tests/test_graph.py's exact tests ------------------------------

def _render_exact(g, ext, **kw):
    with dt.policy("exact"):
        outs, _, _ = dt.render(g, ext, device="cpu", **kw)
    return outs.numpy()


def test_fan_in_three_way_exact_bitwise():
    """Three sources into one port sum in link order, then one divide."""
    x = _sig(6, T_NODE)
    g = dt.Graph(IdSpace())
    inp = g.add("input")
    # inexact products: a fused multiply-add would show
    levels = (0.7310586, 1.3, 2.7)
    gains = [g.add("gain", level=lv) for lv in levels]
    out = g.add("output")
    for gn in gains:
        g.connect(inp, "out", gn, "in")
        g.connect(gn, "out", out, "in")
    got = _render_exact(g, x[None])
    xin = oracle.fanin_average([x])
    want = oracle.fanin_average([(xin * F32(lv)).astype(F32)
                                 for lv in levels])
    np.testing.assert_array_equal(got[0], want)


def test_chain_exact_bitwise_end_to_end():
    """input -> gain -> low_pass -> output, the fan-in divides and the
    sequential recurrence."""
    x = _sig(7, T_NODE)
    g = dt.Graph(IdSpace())
    inp, gn, lp, out = (g.add("input"), g.add("gain", level=1.7),
                        g.add("low_pass", ratio=0.6), g.add("output"))
    g.chain(inp, gn, lp, out)
    got = _render_exact(g, x[None])
    y = (oracle.fanin_average([x]) * F32(1.7)).astype(F32)
    y = oracle.low_pass(oracle.fanin_average([y]), F32(0.6))[0]
    np.testing.assert_array_equal(got[0], oracle.fanin_average([y]))


@pytest.mark.parametrize("mode,ofn,level", [
    ("HardClip", "hard_clip", 2.3),
    ("SoftClip", "soft_clip", 2.3),
    ("SoftClip", "soft_clip", 0.9),       # the inner branch only
    ("Square", "square_shape", 2.3),
    ("Chebyshev4", "chebyshev4", 2.3),
    ("RecipSoftClip", "recip_soft_clip", 2.3),
])
def test_distort_polynomial_modes_exact_bitwise(mode, ofn, level):
    x = _sig(8, T_NODE)
    g = dt.Graph(IdSpace())
    inp, ds, out = (g.add("input"), g.add("distort", mode=mode, level=level),
                    g.add("output"))
    g.chain(inp, ds, out)
    got = _render_exact(g, x[None])
    xin = oracle.fanin_average([x])
    want = oracle.fanin_average([getattr(oracle, ofn)(xin, F32(level))])
    np.testing.assert_array_equal(got[0], want)


def test_mix_exact_bitwise():
    """mix's b*r + a*(1-r), three roundings (mix.rs:45)."""
    x, y = _sig(9, T_NODE), _sig(10, T_NODE)
    g = dt.Graph(IdSpace())
    ia, ib, mx, out = (g.add("input"), g.add("input"),
                       g.add("mix", ratio=0.37), g.add("output"))
    g.connect(ia, "out", mx, "a")
    g.connect(ib, "out", mx, "b")
    g.connect(mx, "out", out, "in")
    got = _render_exact(g, {str(ia.id): x, str(ib.id): y})
    r = F32(0.37)
    mixed = (oracle.fanin_average([y]) * r
             + oracle.fanin_average([x]) * F32(F32(1.0) - r)).astype(F32)
    np.testing.assert_array_equal(got[0], oracle.fanin_average([mixed]))


def test_reverb_exact_bitwise_via_graph():
    """The feedback comb: t = delayed*decay; y = x + t (reverb.rs:87-92)."""
    x = _sig(11, T_NODE)
    g = dt.Graph(IdSpace())
    inp, rv, out = (g.add("input"), g.add("reverb", seconds=0.003,
                                           decay=0.6), g.add("output"))
    g.chain(inp, rv, out)
    got = _render_exact(g, x[None])
    want = oracle.fanin_average([oracle.reverb(oracle.fanin_average([x]),
                                               0.003, 0.6)[0]])
    np.testing.assert_array_equal(got[0], want)


# -- routing under exact ----------------------------------------------------

def _routing_graph():
    """Every biquad shortcut's shape (degenerate, pure FIR, general), a
    one-pole pair the planner would fuse, shapers and a comb it would
    take into a chain segment, and a feedback loop it would lower to a
    cycle program -- under fast."""
    g = dt.Graph(IdSpace())
    inp = g.add("input")
    chain = [g.add("gain", level=1.2),
             g.add("biquad", a0=1.0, a1=-0.24, a2=0.0, b0=0.758, b1=0.0,
                   b2=0.0),
             g.add("biquad", a0=1.0, a1=0.0, a2=0.0, b0=0.5, b1=0.3,
                   b2=-0.2),
             g.add("biquad", a0=1.0, a1=-0.3, a2=0.05, b0=0.8, b1=0.1,
                   b2=-0.05),
             g.add("low_pass", ratio=0.6), g.add("high_pass", ratio=0.2),
             g.add("distort", mode="SoftClip", level=2.0),
             g.add("reverb", seconds=0.004, decay=0.4)]
    g.chain(inp, *chain)
    mixa = g.add("add")
    lp = g.add("low_pass", ratio=0.5)
    fb = g.add("gain", level=0.4)
    out = g.add("output")
    g.connect(chain[-1], "out", mixa, "a")
    g.chain(mixa, lp, fb)
    g.connect(fb, "out", mixa, "b")
    g.connect(lp, "out", out, "in")
    return g, inp.id


FORBIDDEN = [(tscan, "_first_order_blocked"), (tscan, "_first_order_scan"),
             (tscan, "_biquad_blocked"), (tscan, "_biquad_blocked_traced"),
             (tscan, "_biquad_degenerate"), (tscan, "_biquad_pure_fir"),
             (tcasc, "linear_cascade"), (tcs, "chain_segment"),
             (tcompile, "cycle_segment")]
SEQUENTIAL = [(tscan, "_first_order_sequential"),
              (tscan, "_biquad_sequential")]


def test_exact_routes_through_the_sequential_solves():
    g, inp_id = _routing_graph()
    x = _sig(12, (2, 1, 512), 0.3)
    calls = {}
    with calls_counted(FORBIDDEN + SEQUENTIAL, calls):
        _render_exact(g, x, batch_shape=(2,))
    assert not {n: c for n, c in calls.items()
                if n not in {name for _, name in SEQUENTIAL}}, calls
    assert calls.get("_biquad_sequential") == 3, calls
    # two one-poles once, the loop's one-pole once a 128-sample block
    assert calls.get("_first_order_sequential") == 2 + 512 // 128, calls
    # the same graph under fast takes the shortcuts (the counts are live)
    fast = {}
    with calls_counted(FORBIDDEN + SEQUENTIAL, fast), dt.policy("fast"):
        dt.render(g, x, device="cpu", batch_shape=(2,))
    assert fast.get("chain_segment") and fast.get("cycle_segment"), fast
    assert "_first_order_sequential" not in fast, fast


def test_one_compiled_graph_switches_policy():
    """No plan or constant cached by graph or shape carries a fast render's
    lowering into an exact one: one CompiledGraph renders fast, then exact,
    and the exact render is a fresh exact render's, bit for bit."""
    g, inp_id = _routing_graph()
    x = _sig(15, (2, 1, 512), 0.3)
    cg = dt.compile_graph(g, device="cpu")
    with dt.policy("fast"):
        fast, _, _ = cg.render(x, batch_shape=(2,))
    with dt.policy("exact"):
        got, _, _ = cg.render(x, batch_shape=(2,))
    want = _render_exact(g, x, batch_shape=(2,))
    np.testing.assert_array_equal(got.numpy(), want)
    assert not np.array_equal(fast.numpy(), want)


# -- gradients and the wrapper -------------------------------------------------

def test_exact_gradient_on_the_cpu():
    """Under exact the plain loops' own autograd differentiates the
    recurrences: the gradient of a low pass and a biquad in their sliders
    is jax.grad's of the same expression under the JAX package's exact
    policy (lax.scan's VJP through its sequential loops), and agrees with
    parity's (the solves differ only by rounding).  The forward is bitwise
    the JAX package's; the backward sums the 600 per-sample terms of each
    slider's gradient in another order than the JAX VJP's reduction over
    the broadcast coefficient (8e-7 relative here), hence rtol 1e-5."""
    x = _sig(13, (2, 600), 0.5)
    w = _sig(14, (2, 600))

    def grads(pol):
        r = torch.tensor(0.7, requires_grad=True)
        a1 = torch.tensor(-0.4, requires_grad=True)
        with dt.policy(pol):
            y = tscan.first_order_affine(r, _t(x) * (1.0 - r), 0.0)
            y, _ = tscan.biquad_df1(y, a1, 0.1, 0.6, 0.2, 0.0)
        (y * _t(w)).sum().backward()
        return y.detach().numpy(), torch.stack([r.grad, a1.grad]).numpy()

    def jax_loss(r, a1):
        y = jscan.first_order_affine(r, x * (1.0 - r), 0.0)
        y, _ = jscan.biquad_df1(y, a1, 0.1, 0.6, 0.2, 0.0)
        return (y * w).sum(), y

    y, got = grads("exact")
    with jprec.policy("exact"):
        (_, y_jax), g_jax = jax.value_and_grad(
            jax_loss, argnums=(0, 1), has_aux=True)(F32(0.7), F32(-0.4))
    np.testing.assert_array_equal(y, np.asarray(y_jax))
    np.testing.assert_allclose(got, np.asarray(g_jax, dtype=F32), rtol=1e-5)
    np.testing.assert_allclose(got, grads("parity")[1], rtol=1e-4)


@pytest.mark.parametrize("divisor", [3.0, 0.1, 7, np.float64(1 / 3),
                                     F32(0.3), 48000.0],
                         ids=["3.0", "0.1", "int", "f64", "f32", "48000"])
def test_fences_vs_jax(divisor):
    """div_ieee / exact_div / mul_unfused / exact_mul on an f32 tensor and
    a Python or NumPy number are the JAX package's fences, bit for bit (a
    divisor rounded to f32 first, one rounding).  On the card div_ieee
    divides by a device scalar; chip_smoke.exact_phase holds that against
    this CPU result."""
    x = _sig(17, (4096,), 3.0)
    with dt.policy("exact"), jprec.policy("exact"):
        for name in ("div_ieee", "exact_div", "mul_unfused", "exact_mul"):
            got = getattr(tprec, name)(_t(x), divisor)
            assert got.dtype == torch.float32, name
            np.testing.assert_array_equal(
                got.numpy(), np.asarray(getattr(jprec, name)(x, divisor)),
                err_msg=name)
    np.testing.assert_array_equal(tprec.div_ieee(_t(x), divisor).numpy(),
                                  x / F32(divisor))


def test_kernel_wrapper_takes_only_cuda_tensors():
    """The wrapper never falls back: a CPU tensor raises (before any
    build)."""
    b = torch.zeros((2, 8))
    with pytest.raises(ValueError, match="CUDA"):
        sequential_kernel.first_order_sequential_cuda(
            torch.tensor(0.5), b, torch.zeros(2))
    with pytest.raises(ValueError, match="CUDA"):
        sequential_kernel.biquad_sequential_cuda(b, torch.zeros(5),
                                                 torch.zeros((2, 4)))
