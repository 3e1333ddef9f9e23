"""The pointwise groups' backward (compiler/pointwise.py: ``adjoint`` and
its plain version ``interpret_adjoint``; ops/pointwise_kernel.py:
``group_adjoint``, ``group_vjp`` and PointwiseGroup's backward;
ops/pointwise_reverse_kernel.py: the generated CUDA and the launch's
layout) on the CPU, where the plain version runs.  The reverse kernel
itself runs only on the card (chip_smoke.py's pointwise_phase); here:

* each form's adjoint (avg, map_mod, gain, add, mix, overdrive,
  chebyshev_asym, every Distort form but Fuzz) under fast, parity and
  exact against autograd through ``pointwise.interpret`` on inputs with
  NaN, +-inf, +-0 and subnormals, levels at 0 and at BYPASS_EPS, sliders
  as scalars, [B, T] and [T] signals and a subset of operands needing a
  gradient, drawn by hypothesis: per-element gradients <= -120 dBFS
  (max-normalized, the non-finite samples the same), reduced ones within
  rtol 1e-6; which forms are bitwise is recorded (all but the tanh
  forms: the installed PyTorch's CPU tanh_backward rounds 1 - y * y once,
  as one FMA, in f32 and in f64, where the adjoint rounds twice);
* each form's vjp against jax.vjp of the JAX package's own function
  (dsp_stuff_tpu/ops/shaping.py through its nodes, compile._avg,
  compile._map_mod), rtol 1e-3 max-normalized;
* config5's input and slider gradients through compile_graph with the
  groups' Function taking the plain adjoint as its backward, against
  jax.grad through the JAX package and against the eager route;
* a NumPy model of the reverse kernel (pass 1's walk over [rows, T] in
  row chunks, the float64 per-thread sums and the CTA's fixed tree, pass
  2's fixed-order sums and its tails, the bodies translated from the
  generated text, its constants pinned to the CUDA source by regex)
  against the plain version: bitwise on the per-element gradients, and
  on the sums against the plain version with float64 sums; the sums the
  same bits whatever order the CTAs run in;
* the generated text: no slider's value in it, one text (one build) for
  one structure, a missing cotangent adds no op, and the dispatch: the
  reverse kernel refuses a CPU tensor.
"""

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, strategies as st

from dsp_stuff_tpu.compiler import compile as jcomp
from dsp_stuff_tpu.nodes import shapers as jshapers
from dsp_stuff_tpu.nodes import simple as jsimple
from dsp_stuff_tpu.registry import ParamSpec as JParamSpec
from dsp_stuff_tpu.train import fit as jfit
from dsp_stuff_tpu.utils import precision as jprec
import dsp_stuff_tpu as dj
import dsp_stuff_tpu_torch as dt
import test_torch_pointwise as tpw
import test_torch_pointwise_divide as tpd
from test_torch_grad_fused import _card_dispatch, _graph_pair, _held
from dsp_stuff_tpu_torch.compiler import compile as tcomp
from dsp_stuff_tpu_torch.compiler import pointwise as pw
from dsp_stuff_tpu_torch.ops import pointwise_kernel as pk
from dsp_stuff_tpu_torch.ops import pointwise_reverse_kernel as prk
from dsp_stuff_tpu_torch.registry import ParamSpec
from dsp_stuff_tpu_torch.train import fit as tfit
from dsp_stuff_tpu_torch.utils import precision as tprec

POLICIES = tpw.POLICIES
B, T = 3, 384
CPU = torch.device("cpu")
F32 = np.float32
ELEMENT_DB = -120.0       # per-element gradients vs autograd (max-normalized)
REDUCED_RTOL = 1e-6       # reduced gradients vs autograd
JAX_RTOL = 1e-3           # vs jax.vjp / jax.grad (max-normalized)
#: the forms whose adjoint is not bitwise autograd's on the CPU: tanh's vjp
#: (the CPU's tanh_backward rounds 1 - y * y once, in f32 and in f64)
TANH_FORMS = ("chebyshev", "distort:Tanh")

_LEVEL = ParamSpec("level", 0.0, 30.0, 0.0, as_input=True)


@pytest.fixture(autouse=True)
def _torch_env():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    prev = tprec.get_policy()
    yield
    tprec.set_policy(prev)
    torch.set_num_threads(threads)


# -- the forms ---------------------------------------------------------------

def _avg_lower(n):
    def lower(b, xs, ps, pol):
        return pw.avg(b, xs, ps["divisor"])
    return n, {"divisor": None}, lower


#: form -> (signal inputs, {slider: its range's top, None for the fan-in
#: divisor}, lower): the node forms of test_torch_pointwise, the fan-in
#: average of 1-3 sources and the modulation map
FORMS = {name: f[:3] for name, f in tpw.FORMS.items()}
for _n in (1, 2, 3):
    FORMS[f"avg:{_n}"] = _avg_lower(_n)
FORMS["map_mod"] = (1, {}, lambda b, xs, ps, pol: pw.map_mod(
    b, xs[0], _LEVEL.lo, _LEVEL.hi))
FORM_NAMES = list(FORMS)


def _program(form, kinds, pol):
    """(program, operand kinds) of ``form``, each slider a scalar or a
    signal operand as ``kinds`` says."""
    n_x, sliders, lower = FORMS[form]
    b = pw.Builder()
    vx = [b.sig() for _ in range(n_x)]
    vp = {k: (b.sig() if kinds[k] != "scal" else b.scal()) for k in sliders}
    return b.program([lower(b, vx, vp, pol)])


@st.composite
def _case(draw, form):
    """Signals (the first [B, T] with every special planted, the others
    [T]), sliders (a level from tpw.LEVELS, a uniform draw, or a [B, T] or
    [T] signal with the levels planted; the fan-in divisor its value),
    which operands need a gradient, and a cotangent."""
    n_x, sliders, _ = FORMS[form]
    seed = draw(st.integers(0, 2**31 - 1))
    scale = draw(st.sampled_from([0.05, 0.7, 3.0, 50.0]))
    xs = [tpw._signal(seed, (B, T), scale)]
    xs += [tpw._signal(seed + i, (T,), scale) for i in range(1, n_x)]
    kinds, sig_ps, scal_ps = {}, [], []
    for i, (k, hi) in enumerate(sliders.items()):
        if hi is None:
            kinds[k] = "scal"
            scal_ps.append(tcomp._divisor_on(n_x, CPU))
            continue
        kind = draw(st.sampled_from(["level", "uniform", "signal"]))
        if kind == "signal":
            kinds[k] = "sig"
            shape = draw(st.sampled_from([(B, T), (T,)]))
            sig_ps.append(tpw._levels(seed + 100 + i, shape, hi))
        else:
            kinds[k] = "scal"
            v = (draw(st.sampled_from(tpw.LEVELS)) if kind == "level"
                 else draw(st.floats(0.0, hi, width=32)))
            scal_ps.append(torch.tensor(float(v)))
    sigs = xs + sig_ps
    need = [draw(st.booleans()) for _ in range(len(sigs) + len(scal_ps))]
    need[draw(st.integers(0, len(need) - 1))] = True
    rng = np.random.default_rng(seed)
    ct = torch.from_numpy(rng.standard_normal((B, T)).astype(F32))
    return kinds, sigs, scal_ps, need, ct


def _element_db(got, want) -> float:
    """max |got - want| / max |want| in dB over the finite samples, after
    checking that the others hold the same non-finite values."""
    bad = ~torch.isfinite(want)
    assert torch.equal(~torch.isfinite(got), bad)
    assert torch.equal(torch.nan_to_num(got[bad]), torch.nan_to_num(want[bad]))
    g, w = got[~bad].double(), want[~bad].double()
    d = float((g - w).abs().max()) if g.numel() else 0.0
    if d == 0.0:
        return -np.inf
    return 20 * np.log10(d / max(float(w.abs().max()), 1e-300))


def _reduced_err(got, want) -> float:
    """A reduced gradient's error: max-normalized over the finite
    entries, the non-finite ones the same."""
    bad = ~torch.isfinite(want)
    assert torch.equal(~torch.isfinite(got), bad)
    assert torch.equal(torch.nan_to_num(got[bad]), torch.nan_to_num(want[bad]))
    g, w = got[~bad].double(), want[~bad].double()
    if not g.numel() or torch.equal(g, w):
        return 0.0
    return float((g - w).abs().max() / max(float(w.abs().max()), 1e-30))


def held_to_autograd(prog, sigs, scals, need, cts, Tn=T):
    """The plain adjoint against autograd through interpret: each
    gradient per-element (its operand spans the launch) <= ELEMENT_DB, or
    reduced within REDUCED_RTOL; a gradient the adjoint leaves None is
    autograd's zeros.  Returns whether every one is bitwise."""
    got = pk.group_adjoint(prog, sigs, scals, cts, need, Tn, CPU)
    want = pk.group_vjp(prog, sigs, scals, cts, need, Tn, CPU)
    F = pk.layout(prog, tuple(s.shape for s in sigs),
                  tuple(s.shape for s in scals), Tn)[0]
    bit = True
    for k, (g, w, n) in enumerate(zip(got, want, need)):
        if not n:
            assert g is None and w is None
            continue
        if g is None:
            assert not bool(w.any()), k
            continue
        assert g.shape == w.shape, (k, g.shape, w.shape)
        t = (sigs + scals)[k]
        if tuple(t.shape) == tuple(F) or t.numel() == int(np.prod(F)):
            assert _element_db(g, w) <= ELEMENT_DB, k
        else:
            assert _reduced_err(g, w) <= REDUCED_RTOL, k
        bit &= tpw._same(g.contiguous(), w.contiguous())
    return bit


@pytest.mark.parametrize("pol", POLICIES)
@pytest.mark.parametrize("form", FORM_NAMES)
def test_form_adjoint_is_autograd(form, pol):
    """Each form's adjoint program, run by its plain version, against
    autograd through interpret; bitwise but for the tanh forms."""
    @tpw.SETTINGS
    @given(case=_case(form))
    def check(case):
        kinds, sigs, scals, need, ct = case
        with dt.policy(pol):
            prog = _program(form, kinds, pol)
            bit = held_to_autograd(prog, sigs, scals, need, [ct])
        if form not in TANH_FORMS:
            assert bit, (form, pol)
    check()


def test_tanh_vjp_rounds_as_recorded():
    """The installed PyTorch's CPU tanh_backward is g * fl(1 - y * y) with
    1 - y * y rounded once (an FMA), the adjoint's g * (1 - y * y) twice:
    the reason TANH_FORMS are not bitwise under fast."""
    rng = np.random.default_rng(3)
    g = rng.standard_normal(4096).astype(F32)
    y = np.tanh(rng.standard_normal(4096)).astype(F32)
    got = torch.ops.aten.tanh_backward(torch.from_numpy(g),
                                       torch.from_numpy(y)).numpy()
    once = g * (F32(1) - y.astype(np.float64) * y).astype(F32)
    twice = g * (F32(1) - y * y)
    assert np.array_equal(got, once)
    assert not np.array_equal(got, twice)


def test_missing_cotangent_adds_no_op():
    """A group of two outputs, one without a cotangent: the adjoint reads
    one cotangent and matches autograd; with none, no gradient at all."""
    b = pw.Builder()
    x, lv = b.sig(), b.scal()
    y0 = pw.tanh_clip(b, x, lv, "fast")
    y1 = pw.hard_clip(b, x, lv, "fast")
    prog = b.program([y0, y1])
    full = pw.adjoint(prog, (True, True), (True, True), ("F",))
    one = pw.adjoint(prog, (True, True), (False, True), ("F",))
    none = pw.adjoint(prog, (True, True), (False, False), ("F",))
    assert [op for op, *_ in one.ops].count("ct") == 1
    assert len(one.ops) < len(full.ops)
    assert not any(op in ("atan", "tanh") for op, *_ in one.ops)
    assert none.grads == (None, None)
    xs = tpw._signal(5, (B, T), 2.0)
    ct = torch.randn(B, T)
    for cts in ([None, ct], [ct, None], [ct, ct]):
        held_to_autograd(prog, [xs], [torch.tensor(0.7)], [True, True], cts)


def test_broadcast_sums_where_autograd_sums():
    """The adjoint of config5's first group with every operand needing a
    gradient: a sum to each scalar at the op where autograd sums, the
    [T] LFO's map chain run at [T] after its sum over the rows, and
    _safe_level's where run once on the 0-d level."""
    prog = tpw._config5_programs("fast")[0]
    n = prog.n_sig + prog.n_scal
    adj = pw.adjoint(prog, (True,) * n, (True,) * len(prog.outs),
                     ("F", "C"))
    reds = [imm for op, _, _, imm in adj.ops if op == "red"]
    assert ("C", "F") in reds and ("U", "F") in reds
    assert ("U", "C") in reds              # the map's span on the LFO
    lfo = adj.grads[1]
    assert adj.cls[lfo] == "C"
    assert all(adj.cls[g] == "U" for g in adj.grads[2:])
    # the uniform tail holds a where on the 0-d level (safe_level's)
    assert any(op == "where" and c == "U" for (op, *_), c
               in zip(adj.ops, adj.cls))
    # every forward value the adjoint uses is recomputed from the operands
    assert not any(op == "sig" and imm >= prog.n_sig
                   for op, _, _, imm in adj.ops)


# -- against the JAX package --------------------------------------------------

def _jax_node(cls, ports, **select):
    def run(xs, ps):
        return cls.process_seq({**ps, **select}, None,
                               dict(zip(ports, xs)))[0]["out"]
    return run


_JLEVEL = JParamSpec("level", 0.0, 30.0, 0.0, as_input=True)
JAX_FORMS = {
    "gain": _jax_node(jsimple.Gain, ("in",)),
    "add": _jax_node(jsimple.Add, ("a", "b")),
    "mix": _jax_node(jsimple.Mix, ("a", "b")),
    "overdrive": _jax_node(jshapers.Overdrive, ("in",), oversample="1"),
    "chebyshev": _jax_node(jshapers.Chebyshev, ("in",)),
    "map_mod": lambda xs, ps: jcomp._map_mod(xs[0], _JLEVEL),
}
for _mode in pw.DISTORT_FORMS:
    JAX_FORMS[f"distort:{_mode}"] = _jax_node(jshapers.Distort, ("in",),
                                              mode=_mode, oversample="1")
for _n in (1, 2, 3):
    JAX_FORMS[f"avg:{_n}"] = lambda xs, ps: jcomp._avg(
        list(xs), xs[0].shape[-1])[0]


@pytest.mark.parametrize("pol", POLICIES)
@pytest.mark.parametrize("form", FORM_NAMES)
def test_form_vjp_is_jax(form, pol):
    """Each form's gradients by the plain adjoint against jax.vjp of the
    JAX package's function on the same finite inputs (a slider a [B, T]
    signal, the next a [T] one, the rest scalars), every operand needing
    a gradient, rtol JAX_RTOL max-normalized."""
    n_x, sliders, _ = FORMS[form]
    rng = np.random.default_rng(len(form) + len(pol))
    xs = [(rng.standard_normal((B, T)) * 0.7).astype(F32)]
    xs += [(rng.standard_normal(T) * 0.7).astype(F32)
           for _ in range(1, n_x)]
    kinds, vals = {}, {}
    for i, (k, hi) in enumerate(sliders.items()):
        if hi is None:
            kinds[k], vals[k] = "scal", F32(float(tcomp._fanin_divisor(n_x)))
        elif i == 0:
            kinds[k] = "sig"
            vals[k] = rng.uniform(0.1 * hi, 0.6 * hi, (B, T)).astype(F32)
        elif i == 1:
            kinds[k] = "sig"
            vals[k] = rng.uniform(0.1 * hi, 0.6 * hi, T).astype(F32)
        else:
            kinds[k], vals[k] = "scal", F32(rng.uniform(0.1 * hi, 0.6 * hi))
    ct = rng.standard_normal((B, T)).astype(F32)
    names = [k for k in sliders if kinds[k] == "sig"]
    scal_names = [k for k in sliders if kinds[k] == "scal"]
    sigs = [torch.from_numpy(x) for x in xs] + [
        torch.from_numpy(vals[k]) for k in names]
    scals = [torch.tensor(float(vals[k])) for k in scal_names]
    need = [True] * (len(sigs) + len(scals))
    with dt.policy(pol):
        prog = _program(form, kinds, pol)
        got = pk.group_adjoint(prog, sigs, scals, [torch.from_numpy(ct)],
                               need, T, CPU)

    def f(*args):
        return JAX_FORMS[form](list(args[:n_x]),
                               dict(zip(names + scal_names, args[n_x:])))

    primals = [jnp.asarray(x) for x in xs] + [jnp.asarray(vals[k])
                                              for k in names + scal_names]
    with jprec.policy(pol):
        out, vjp = jax.vjp(f, *primals)
        want = vjp(jnp.asarray(ct, out.dtype))
    if form.startswith("avg"):
        # the JAX package's divisor is a constant of _avg, not an operand
        got, want = got[:n_x], want[:n_x]
    _held(f"{form} {pol}", [(g.numpy(), np.asarray(w))
                            for g, w in zip(got, want)], JAX_RTOL)


# -- config5 through compile_graph --------------------------------------------

def _function_route(monkeypatch, backward, calls):
    """Send each group through PointwiseGroup, the plain version forward
    and ``backward`` as its backward (counted into ``calls``)."""
    def fwd(prog, sigs, scals, Tn, device):
        calls["forward"] += 1
        return pw.interpret(prog, sigs, scals, Tn, device)

    def bwd(*a):
        calls["backward"] += 1
        return backward(*a)
    monkeypatch.setattr(tcomp, "group_call", lambda prog, sigs, scals, Tn,
                        d: pk.run(fwd, prog, sigs, scals, Tn, d, bwd))


@pytest.mark.parametrize("wrt", ["input", "subset"])
def test_config5_gradients_through_the_adjoint(wrt, monkeypatch):
    """config5's loss gradients (the input's, or the feedback gain's and
    the mix ratio's) with the groups' backward the plain adjoint: against
    jax.grad through the JAX package (rtol JAX_RTOL) and against the eager
    route (no groups: the same bound, and the input's per-element
    gradient <= ELEMENT_DB)."""
    gj, gt, inp, Tn, sub, _, _ = _graph_pair("config5")
    rng = np.random.default_rng(21)
    x = (rng.standard_normal((2, Tn)) * 0.25).astype(F32)
    target = (rng.standard_normal((2, 1, Tn)) * 0.1).astype(F32)
    with jprec.policy("fast"):
        cgj = dj.compile_graph(gj)
        pj = cgj.init_params()
        pj = ({n: {k: pj[n][k] for k in keys} for n, keys in sub.items()}
              if wrt == "subset" else {})
        gp, gx = jax.jit(jax.grad(jfit.make_loss_fn(cgj), argnums=(0, 2)))(
            pj, cgj.init_state(), {inp: x}, target)

    def torch_grads(route):
        with monkeypatch.context() as m:
            _card_dispatch(m)
            calls = {"forward": 0, "backward": 0}
            if route == "adjoint":
                _function_route(m, pk.group_adjoint, calls)
                m.setattr(pk, "group_vjp", None)      # never the reference
            else:
                m.setattr(tcomp, "POINTWISE_FUSION", False)
            cgt = dt.compile_graph(gt, device="cpu")
            pt = {n: {k: torch.tensor(float(np.asarray(v)),
                                      requires_grad=True)
                      for k, v in e.items()} for n, e in pj.items()}
            xt = torch.tensor(x, requires_grad=wrt == "input")
            with tprec.policy("fast"):
                loss = tfit.make_loss_fn(cgt)(pt, cgt.init_state(),
                                              {inp: xt},
                                              torch.from_numpy(target))
                loss.backward()
        grads = ([xt.grad] if wrt == "input" else
                 [pt[n][k].grad for n in sorted(pt) for k in sorted(pt[n])])
        return grads, calls

    got, calls = torch_grads("adjoint")
    eager, _ = torch_grads("eager")
    assert calls == {"forward": 3, "backward": 3}, calls
    if wrt == "input":
        _held("config5 input, adjoint vs jax", [(got[0].numpy(), gx[inp])],
              JAX_RTOL)
        assert _element_db(got[0], eager[0]) <= ELEMENT_DB
    else:
        want = [gp[n][k] for n in sorted(pj) for k in sorted(pj[n])]
        _held("config5 sliders, adjoint vs jax",
              [(g.numpy(), np.asarray(w)) for g, w in zip(got, want)],
              JAX_RTOL)
        _held("config5 sliders, adjoint vs eager",
              [(g.numpy(), w.numpy()) for g, w in zip(got, eager)],
              JAX_RTOL)


# -- the generated text -------------------------------------------------------

def _config5_adjoints(pol="fast", **values):
    """Adjoint programs of config5's groups, every operand needing a
    gradient, the first signal [B, T] and the others [T]."""
    out = []
    for prog in tpw._config5_programs(pol, **values):
        n = prog.n_sig + prog.n_scal
        out.append(pw.adjoint(prog, (True,) * n, (True,) * len(prog.outs),
                              ("F",) + ("C",) * (prog.n_sig - 1)))
    return out


def test_reverse_source_holds_no_slider_value():
    """config5's adjoints and their texts are the same whatever the
    sliders hold, and no slider's value appears in a text; every f32
    arithmetic op is its __f*_rn intrinsic (no bare operator)."""
    odd = {"gain": {"level": 1.2345678}, "overdrive": {
        "boost": 6.54321, "level": 0.7654321},
        "distort": {"level": 4.4444444}, "mix": {"ratio": 0.3141593}}
    base, moved = _config5_adjoints(), _config5_adjoints(**odd)
    assert base == moved
    text = "\n".join(prk.reverse_source(a) for a in moved)
    for params in odd.values():
        for v in params.values():
            f = np.float32(v)
            assert float(f).hex() not in text
            assert repr(float(f))[:6] not in text
    for line in text.splitlines():
        m = re.match(r"^  const (?:float|double|bool) v\d+ = (.+);$", line)
        if m:
            body = re.sub(r"-?0x[0-9a-f.]+p[+-]\d+f?", "L", m.group(1))
            body = re.sub(r"in\[\d+\]\[\w+ \* in_s[bt]\[\d+\]\]", "L", body)
            assert not re.search(r"[^<>=!]\s[+*/]\s|\s-\s", body), line


def test_reverse_programs_of_a_structure_are_one_build():
    """The build key is the adjoint program: config5 under parity and
    exact is one text a group, fast another; the same group with another
    operand needing a gradient is another program."""
    fast, parity, exact = ([prk.reverse_source(a) for a in
                            _config5_adjoints(pol)] for pol in POLICIES)
    assert parity == exact and fast != parity
    prog = tpw._config5_programs("fast")[0]
    n = prog.n_sig + prog.n_scal
    x_only = pw.adjoint(prog, (True,) + (False,) * (n - 1),
                        (True,) * len(prog.outs), ("F", "C"))
    assert prk.reverse_source(x_only) != fast[0]
    assert "#define PR_PASS2 0" in prk.reverse_source(x_only)
    assert "#define PR_PASS2 1" in fast[0]


_DIVIDES = ("__fdiv_rn(", "__ddiv_rn(", "pw_div(", "pw_div_pow2(")


def _form_adjoints(pol):
    """Adjoint programs of every form (test_torch_pointwise's, the sliders
    scalars), every operand and the input alone needing a gradient."""
    out = []
    for form, (n_x, sliders, _) in FORMS.items():
        prog = _program(form, {k: "scal" for k in sliders}, pol)
        n = prog.n_sig + prog.n_scal
        for need in ((True,) * n, (True,) + (False,) * (n - 1)):
            out.append(pw.adjoint(prog, need, (True,) * len(prog.outs),
                                  ("F",) + ("C",) * (prog.n_sig - 1)))
    return out


@pytest.mark.parametrize("pol", POLICIES)
def test_reverse_source_divides_and_hoists(pol):
    """In config5's and every form's adjoint text: a divide by a uniform
    value (a uniform divisor, the dividend not) is pw_div through that
    divisor's reciprocal, computed once in pr_uniform (pw_div_pow2, the
    product by 2^-k, where the divisor is a constant 2^k), every other
    divide __fdiv_rn / __ddiv_rn; one divide a div statement, so the
    count of divides is the program's as the worlds place it; pr_col
    holds exactly the full world's class-C statements (its sums aside),
    which read only class-C and uniform values, and pr_point reads them
    as C.v."""
    n_helper = 0
    adjs = _config5_adjoints(pol) + _form_adjoints(pol)
    prog = tpw._config5_programs(pol)[0]
    n = prog.n_sig + prog.n_scal
    adjs.append(pw.adjoint(prog, (True,) + (False,) * (n - 1),
                           (True,) * len(prog.outs), ("F", "C")))
    for adj in adjs:
        src = prk.reverse_source(adj)
        w = prk.worlds(adj)
        struct = set(w.struct)
        fns = _functions(src)
        n_div = 0
        for fn, lines in fns.items():
            for line in lines:
                m = re.match(r"^(?:const \w+ |U\.)v(\d+) = (.+);$", line)
                if not m:
                    assert not any(d in line for d in _DIVIDES), line
                    continue
                v, e = int(m.group(1)), m.group(2)
                op, dt_, args, _ = adj.ops[v]
                if op != "div":
                    assert not any(d in e for d in _DIVIDES), line
                    continue
                n_div += 1
                a, d = args
                inv = prk._pow2_inverse(*[adj.ops[d][k] for k in (0, 1, 3)])
                if d in struct and a not in struct:
                    assert adj.cls[d] == "U"
                    if inv is not None:
                        assert e.startswith("pw_div_pow2("), line
                    else:
                        assert e.startswith("pw_div(") and e.endswith(
                            f", U.r{d})"), line
                        assert f"  U.r{d} = pw_recip(U.v{d});" in src
                        n_helper += 1
                else:
                    assert e.startswith(("__fdiv_rn(", "__ddiv_rn(")), line
        assert sum(src.count(d) for d in _DIVIDES) == n_div
        col = [int(v) for v in re.findall(r"const \w+ v(\d+) = ",
                                          "\n".join(fns["pr_col"]))]
        want = [v for v in w.stmts["F"] if adj.cls[v] == "C"
                and adj.ops[v][0] != "red"]
        assert col == want == list(prk.hoisted(adj))
        for v in col:
            assert all(a in struct or a in col for a in adj.ops[v][2])
        point = "\n".join(fns["pr_point"])
        assert not any(re.search(rf"const \w+ v{v} = ", point) for v in col)
        for v in col:
            if re.search(rf"\bC\.v{v}\b", point):
                assert f"  C.v{v} = v{v};" in src
    assert n_helper > 0


def test_config5_first_group_divides():
    """config5's first group, the input's program under fast: its 12
    divides are 10 pw_div (the fan-in divisor 7 times, the safe level, 3
    twice), one pw_div_pow2 (map_mod's 2) and one __fdiv_rn (atan's vjp,
    x * x + 1); pr_col holds the map chain v21-v27 and v35, two of them
    divides."""
    prog = tpw._config5_programs("fast")[0]
    n = prog.n_sig + prog.n_scal
    adj = pw.adjoint(prog, (True,) + (False,) * (n - 1),
                     (True,) * len(prog.outs), ("F", "C"))
    src = prk.reverse_source(adj)
    fns = _functions(src)
    body = "\n".join(fns["pr_point"] + fns["pr_col"])
    assert [body.count(d) for d in _DIVIDES] == [1, 0, 10, 1]
    assert "\n".join(fns["pr_col"]).count("pw_div") == 2
    assert len(prk.hoisted(adj)) == 8
    assert sorted(re.findall(r"U\.r(\d+) = pw_recip", src)) == \
        sorted(set(re.findall(r"pw_div\(\w+, U\.r(\d+)\)", body)))


def test_sin_adjoint_uses_cos():
    """sin's vjp is g * cos(x): the IR's cos op, cosf in the text under
    fast, cos of a double under parity."""
    for pol, want in (("fast", "cosf("), ("parity", "cos((double)")):
        b = pw.Builder()
        prog = b.program([pw.sin_shape(b, b.sig(), b.scal(), pol)])
        adj = pw.adjoint(prog, (True, False), (True,), ("F",))
        assert any(op == "cos" for op, *_ in adj.ops)
        src = prk.reverse_source(adj)
        assert want in src or (pol == "parity" and "cos(v" in src), src


# -- a NumPy model of the reverse kernel --------------------------------------

def _pw_div(a, R):
    """pw_div: the model of test_torch_pointwise_divide on float32 (held
    bitwise to IEEE division there), IEEE division on float64 (its model
    is held on random pairs there)."""
    a = np.asarray(a)
    if a.dtype == np.float32:
        return tpd.div32(a, R)
    return a / R[0]


_ENV = dict(tpw._ENV, _tr_cos=tpw._torch_fn("cos"), _pw_div=_pw_div,
            _pw_div_pow2=lambda a, inv: np.multiply(a, inv),
            _pw_recip=lambda d: tpd.recip(
                d, np.float64 if np.asarray(d).dtype == np.float64
                else np.float32))


def _py(expr: str) -> str:
    """One generated C expression as Python over NumPy arrays (the forward
    model's translation, with the reverse's loads and cos)."""
    e = re.sub(r"in\[(\d+)\]\[row \* in_sb\[\d+\]\]", r"IR[\1]", expr)
    e = re.sub(r"in\[(\d+)\]\[t \* in_st\[\d+\]\]", r"IC[\1]", e)
    e = re.sub(r"\*p\[(\d+)\]", r"P[\1]", e)
    e = re.sub(r"\b(?:rr|rc)\[", "RED[", e)
    e = re.sub(r"\bU\.r(\d+)", r"U['r\1']", e)
    e = re.sub(r"\bC\.v(\d+)", r"CV['\1']", e)
    e = re.sub(r"\bpw_div(_pow2)?\(", r"_pw_div\1(", e)
    return tpw._py(re.sub(r"\bcosf?\(", "_tr_cos(", e))


_FN = re.compile(r"^__device__ __forceinline__ \w+ (pr_\w+)\(")


def _functions(src):
    """{function name: its body lines} of a generated text."""
    out, name = {}, None
    for line in src.splitlines():
        m = _FN.match(line)
        if m:
            name = m.group(1)
            out[name] = []
        elif line == "}":
            name = None
        elif name and line.startswith("  ") and not line.startswith("    "):
            out[name].append(line.strip())
    return out


def _run(lines, env, sums):
    """Evaluate a world's statements in ``env``; an accumulation
    ``a?[k] += v`` goes to ``sums`` (a name -> {k: per-lane values}) and
    a store ``g[k] = v`` / ``out[k][.] = v`` to env["STORE"]."""
    for line in lines:
        m = re.match(r"^U\.r(\d+) = pw_recip\(U\.v(\d+)\);$", line)
        if m:
            env["U"]["r" + m.group(1)] = env["_pw_recip"](env["U"][m.group(2)])
            continue
        m = re.match(r"^C\.v(\d+) = v(\d+);$", line)
        if m:
            env["CV"][m.group(1)] = env["V"][m.group(2)]
            continue
        m = re.match(r"^(?:const \w+ )?(U\.)?v(\d+) = (.+);$", line)
        if m:
            target = env["U"] if m.group(1) else env["V"]
            target[m.group(2)] = eval(_py(m.group(3)), env)
            continue
        m = re.match(r"^(a[URC])\[(\d+)\] \+= (.+);$", line)
        if m:
            sums.setdefault(m.group(1), {})[int(m.group(2))] = np.asarray(
                eval(_py(m.group(3)), env), np.float64)
            continue
        m = re.match(r"^(?:g\[(\d+)\]|out\[(\d+)\]\[\w+\]) = (.+);$", line)
        if m:
            env["STORE"][int(m.group(1) or m.group(2))] = eval(
                _py(m.group(3)), env)
            continue
        if line not in ("PrUniform U;", "return U;", "PrCol C;",
                        "return C;"):
            raise AssertionError(f"untranslated line {line!r}")


def _tree(vals):
    """pr_block_sum of a CTA's per-thread values ([..., threads]): each
    warp's shuffle tree (lane l adds lane l + o, o = 16 .. 1), then the
    warps in order from 0.0."""
    v = np.asarray(vals, np.float64)
    n = v.shape[-1]
    w = v.reshape(*v.shape[:-1], n // 32, 32).copy()
    for o in (16, 8, 4, 2, 1):
        w[..., :o] = w[..., :o] + w[..., o:2 * o]
    s = np.zeros(v.shape[:-1])
    for k in range(n // 32):
        s = s + w[..., k, 0]
    return s


def _reverse_model(prog, sigs, scals, cts, need, Tn, order_seed=None):
    """The reverse kernel on the launch plan_reverse lays out: pass 1's
    threads (CTA (bx, by), thread tid: unit bx * THREADS + tid of rows
    [by * rch, (by + 1) * rch)), their per-sample values (pr_col) from the
    chunk's first row, each thread's float64 sums in its walk's order
    (rows, then its samples), the CTA's tree; where one chunk holds every
    row, the per-sample tail in pass 1 (pr_time at the thread's samples,
    its sums to the scalars a CTA's tree); pass 2's one CTA (a thread each
    THREADS2-th partial, row, sample), its tree, the tails; the bodies
    translated from the generated text.  With ``order_seed`` the CTAs of
    pass 1 run in a random order.  Returns the gradients as the operands'
    shapes (None where none) and the launch."""
    pl = pk.plan_adjoint(prog, sigs, scals, cts, need, Tn)
    w = prk.worlds(pl.adj)
    ln = prk.plan_reverse(pl, CPU)
    fns = _functions(prk.reverse_source(pl.adj))
    rows, rch, (gx, gy) = ln.rows, ln.rch, ln.grid
    inline = prk.tail_in_pass1(w, gy)
    V_ = pk.V if ln.vec else 1
    nth, nth2 = prk.THREADS, prk.THREADS2
    P = [t.reshape(()).numpy() for t in ln.ptrs]
    U = {}
    with np.errstate(all="ignore"):
        _run(fns["pr_uniform"], dict(_ENV, P=P, U=U, V={}, STORE={}), {})
    # pass 1: every (CTA, thread, row, sample) lane, vectorized
    by, bx, tid = np.meshgrid(np.arange(gy), np.arange(gx), np.arange(nth),
                              indexing="ij")
    u = bx * nth + tid
    t0 = u * V_
    out1 = [np.full((rows, Tn), np.nan, F32) for _ in range(w.n_out1)]
    part = np.full(prk.workspace_size(w, rows, Tn, gx, gy), np.nan)
    nfu, nfr, nfc, _, ncu = (len(w.reds[k]) for k in prk.RED_KINDS)
    aU = np.zeros((nfu, gy, gx, nth))
    aC = np.zeros((nfc, V_, gy, gx, nth))
    X = [s.numpy() for s in ln.ins[:w.n_in1]]

    def lanes(row, i):
        """(live mask, row, sample) of sample i of every lane at ``row``,
        and the streams there."""
        t = t0 + i
        live = (row < rows) & (t < Tn)
        r_, t_ = np.where(live, row, 0), np.where(live, t, 0)
        return live, r_, t_, [x[np.minimum(r_, x.shape[0] - 1),
                                np.minimum(t_, x.shape[1] - 1)] for x in X]
    CV = []
    for i in range(V_):
        env = dict(_ENV, U=U, V={}, STORE={}, P=P, CV={})
        env["X"] = lanes(by * rch, i)[3]
        with np.errstate(all="ignore"):
            _run(fns["pr_col"], env, {})
        CV.append(env["CV"])
    for j in range(rch):
        row = by * rch + j
        aR = np.zeros((nfr, gy, gx, nth))
        for i in range(V_):
            live, r_, t_, xs = lanes(row, i)
            env = dict(_ENV, U=U, V={}, STORE={}, P=P, X=xs, CV=CV[i])
            sums = {}
            with np.errstate(all="ignore"):
                _run(fns["pr_point"], env, sums)
            for k, y in env["STORE"].items():
                out1[k][r_[live], t_[live]] = np.broadcast_to(
                    y, live.shape)[live]
            for name, acc in (("aU", aU), ("aR", aR)):
                for k, c in sums.get(name, {}).items():
                    acc[k] += np.where(live, c, 0.0)
            for k, c in sums.get("aC", {}).items():
                aC[k, i] += np.where(live, c, 0.0)
        for k in range(nfr):
            s = _tree(aR[k])
            for y_, x_ in np.ndindex(gy, gx):
                r = y_ * rch + j
                if r < rows:
                    part[nfu * gx * gy + (k * rows + r) * gx + x_] = s[y_, x_]
    ctas = [(y_, x_) for y_ in range(gy) for x_ in range(gx)]
    if order_seed is not None:
        np.random.default_rng(order_seed).shuffle(ctas)
    ins = [s.numpy() for s in ln.ins]
    store = {}
    fc = nfu * gx * gy + nfr * rows * gx
    if inline:
        # the per-sample tail in pass 1: pr_time at each lane's samples
        aT = np.zeros((ncu, gy, gx, nth))
        for i in range(V_):
            t = t0 + i
            live = t < Tn
            t_ = np.where(live, t, 0)
            env = dict(_ENV, U=U, V={}, STORE={}, P=P,
                       IC=[x[0, np.minimum(t_, x.shape[1] - 1)] for x in ins],
                       RED=[aC[k, i] for k in range(nfc)])
            sums = {}
            with np.errstate(all="ignore"):
                _run(fns["pr_time"], env, sums)
            for k, y in env["STORE"].items():
                store.setdefault(k, np.full(Tn, np.nan, F32))[t_[live]] = \
                    np.broadcast_to(y, live.shape)[live]
            for k, c in sums.get("aU", {}).items():
                aT[k] += np.where(live, c, 0.0)
        for k in range(ncu):
            s = _tree(aT[k])
            for y_, x_ in ctas:
                part[fc + k * gx + x_] = s[y_, x_]
    else:
        for k in range(nfc):
            for y_, x_ in ctas:
                for i in range(V_):
                    t = t0[y_, x_] + i
                    ok = t < Tn
                    part[fc + (k * gy + y_) * Tn + t[ok]] = \
                        aC[k, i, y_, x_][ok]
    for k in range(nfu):
        s = _tree(aU[k])
        for y_, x_ in ctas:
            part[k * gx * gy + y_ * gx + x_] = s[y_, x_]
    # pass 2: one CTA of THREADS2
    nc = gx * gy

    def sum2(vals):
        """pr_sum2: thread i adds every THREADS2-th term from i, then the
        tree."""
        return _tree(np.asarray([sum_seq(vals[i::nth2])
                                 for i in range(nth2)]))[()]
    ru = [sum2(part[k * nc:(k + 1) * nc]) for k in range(nfu)]
    src = prk.reverse_source(pl.adj)

    def tail(fn, n_items, red, load, n_acc):
        """pr_row / pr_time over rows or samples: thread tid takes items
        tid, tid + THREADS2, ...; each item's sums from pass 1 (``red(k,
        item)``, one add at a time); the thread's own sums to the scalars
        in its items' order, then the tree."""
        items = np.arange(n_items)
        n_red = nfr if fn == "pr_row" else nfc
        env = dict(_ENV, U=U, V={}, STORE={}, P=P, **load(items),
                   RED=[np.asarray([red(k, it) for it in items])
                        for k in range(n_red)])
        sums = {}
        with np.errstate(all="ignore"):
            _run(fns[fn], env, sums)
        for j, y in env["STORE"].items():
            store[j] = np.broadcast_to(y, items.shape)
        out = []
        for k in range(n_acc):
            c = np.broadcast_to(sums["aU"][k], items.shape)
            out.append(_tree(np.asarray([sum_seq(c[i::nth2])
                                         for i in range(nth2)]))[()])
        return out

    if "#define PR_ROWS 1" in src:
        fr = nfu * nc
        ru += tail("pr_row", rows, lambda k, r: sum_seq(
            part[fr + (k * rows + r) * gx:fr + (k * rows + r + 1) * gx]),
            lambda it: {"IR": [x[np.minimum(it, x.shape[0] - 1), 0]
                               for x in ins]}, len(w.reds[("R", "U")]))
    if "#define PR_TIMES 1" in src:
        if inline:
            ru += [sum2(part[fc + k * gx:fc + (k + 1) * gx])
                   for k in range(ncu)]
        else:
            ru += tail("pr_time", Tn, lambda k, t: sum_seq(
                part[fc + k * gy * Tn + t:fc + (k + 1) * gy * Tn:Tn]),
                lambda it: {"IC": [x[0, np.minimum(it, x.shape[1] - 1)]
                                   for x in ins]}, ncu)
    env = dict(_ENV, U=U, V={}, STORE={}, P=P,
               ru=np.asarray(ru, np.float64))
    with np.errstate(all="ignore"):
        _run(fns["pr_tail"], env, {})
    store.update(env["STORE"])
    grads = [None] * len(need)
    for j, (k, _) in enumerate(w.outs):
        shape = pw.class_shape(pl.classes[k], rows, Tn)
        g = out1[j] if j < w.n_out1 else np.asarray(store[j]).reshape(shape)
        grads[k] = torch.from_numpy(np.array(g, F32))
    return pk.shaped_grads(pl, grads), ln


def sum_seq(vals) -> float:
    """A float64 sum from 0.0 in order, one add at a time."""
    s = 0.0
    for v in np.asarray(vals, np.float64):
        s += v
    return s


def _model_cases(Tn):
    """(name, program, signals, scalars, cotangents, need, policy)."""
    rng = np.random.default_rng(Tn)
    x = torch.from_numpy((rng.standard_normal((B, Tn)) * 0.7).astype(F32))
    x.view(-1)[:len(tpw.SPECIALS)] = torch.tensor(tpw.SPECIALS)
    lfo = torch.from_numpy(np.sin(np.arange(Tn) * 0.01).astype(F32))
    ct = torch.from_numpy(rng.standard_normal((B, Tn)).astype(F32))
    out = []
    for pol in ("fast", "parity"):
        prog = tpw._config5_programs(pol)[0]
        scals = [tprec.scalar_on(v, CPU) for v in (1.2, 1.0001, 6.0, 0.8,
                                                   4.0)]
        n = prog.n_sig + prog.n_scal
        cts = [ct] * len(prog.outs)
        out.append((f"config5 group 0 {pol}, every gradient", prog,
                    [x, lfo], scals, cts, [True] * n, pol))
        out.append((f"config5 group 0 {pol}, the input's", prog, [x, lfo],
                    scals, cts, [True] + [False] * (n - 1), pol))
        out.append((f"config5 group 0 {pol}, the [T] LFO's", prog,
                    [x, lfo], scals, cts, [False, True] + [False] * (n - 2),
                    pol))
    b = pw.Builder()
    a, c, r_ = b.sig(), b.sig(), b.sig()
    prog = b.program([pw.mix(b, a, c, r_)])
    out.append(("mix, a slider a [B, 1] signal", prog,
                [x, lfo, torch.rand(B, 1)], [], [ct], [True] * 3, "fast"))
    b = pw.Builder()
    a, lv = b.sig(), b.scal()
    prog = b.program([pw.soft_clip(b, a, lv, "fast")])
    out.append(("one row, soft clip", prog, [x[:1].clone()],
                [tprec.scalar_on(4.0, CPU)], [ct[:1].clone()], [True] * 2,
                "fast"))
    return out


def _model_held(Tn) -> list:
    """Each of _model_cases through _reverse_model (twice, the second with
    pass 1's CTAs in another order) against the plain version: the
    per-element gradients bitwise, every sum bitwise the plain version's
    float64 sum, both runs the same bits.  Returns [(case name, launch)]."""
    out = []
    for name, prog, sigs, scals, cts, need, pol in _model_cases(Tn):
        with dt.policy(pol):
            got, ln = _reverse_model(prog, sigs, scals, cts, need, Tn)
            again, _ = _reverse_model(prog, sigs, scals, cts, need, Tn,
                                      order_seed=7)
            plain = pk.group_adjoint(prog, sigs, scals, cts, need, Tn, CPU)
            p64 = pk.group_adjoint(prog, sigs, scals, cts, need, Tn, CPU,
                                   sums64=True)
        F = pk.layout(prog, tuple(s.shape for s in sigs),
                      tuple(s.shape for s in scals), Tn)[0]
        for k, (g, a, p, q) in enumerate(zip(got, again, plain, p64)):
            assert (g is None) == (p is None), (name, k)
            if g is None:
                continue
            assert tpw._same(g, a), (name, k)
            t = (sigs + scals)[k]
            if tuple(t.shape) == tuple(F):
                assert tpw._same(g, p.contiguous()), (name, k)
            else:
                assert tpw._same(g, q.contiguous()), (name, k)
        assert ln.vec == (Tn % 4 == 0)
        out.append((name, ln))
    return out


@pytest.mark.parametrize("Tn", [1024, 1030])
def test_reverse_model_is_the_plain_version(Tn):
    """The kernel's two passes (float4 walk at T = 1024, one sample a
    thread at T = 1030; a [T] LFO's gradient summed over the rows in one
    chunk of every row, its per-sample tail in pass 1; a [B, 1] slider's
    per-row sums; the one-row launch): the per-element gradients bitwise
    the plain version, every sum the plain version's float64 sum (rtol
    1e-12 before its rounding, so bitwise after it but at a rounding tie),
    and the same bits when pass 1's CTAs run in another order."""
    for name, ln in _model_held(Tn):
        if "[T] LFO" in name or "every" in name:
            assert ln.rch == prk.ROW_CHUNK and ln.grid[1] == 1
            assert not ln.pass2 or "every" in name


@pytest.mark.parametrize("Tn", [1024, 1030])
def test_reverse_model_chunked_layout(Tn, monkeypatch):
    """The same with the rows chunked (two rows a chunk, so gy = 2 at B =
    3): the [T] LFO's partials one a sample and chunk, its per-sample tail
    in pass 2; the input's program walking two rows a thread from its
    hoisted per-sample values."""
    monkeypatch.setattr(prk, "ROW_CHUNK", 2)
    monkeypatch.setattr(prk, "HOIST_ROWS", 2)
    monkeypatch.setattr(prk, "HOIST_MIN_CTAS", 0)
    for name, ln in _model_held(Tn):
        if "config5" in name:
            assert ln.rch == 2 and ln.grid[1] == 2, name
            assert ln.pass2 == ("input's" not in name)


def test_min_ctas_by_accumulators():
    """The launch bound each text sets (PR_MIN_CTAS, min_ctas): by the
    registers pass 1's float64 accumulators take (a scalar's, a row's, a
    sample's for each of its V samples), 6 CTAs an SM up to 4, 5 up to 16,
    else 4: config5's first group with every gradient (8 scalars, 2 [T]
    sums over 4 samples: 32 registers) 4, the mix's (2 scalars, one [T]
    sum: 12) 5, the Output's (one scalar) and every input's program 6."""
    want = [(32, 4), (12, 5), (2, 6)]
    for adj, (acc_want, n_want) in zip(_config5_adjoints(), want):
        w = prk.worlds(adj)
        acc = 2 * (len(w.reds[("F", "U")]) + len(w.reds[("F", "R")])
                   + pk.V * len(w.reds[("F", "C")]))
        n = int(re.search(r"#define PR_MIN_CTAS (\d+)",
                          prk.reverse_source(adj)).group(1))
        assert (acc, n) == (acc_want, n_want) == (acc, prk.min_ctas(w))
    for prog in tpw._config5_programs("fast"):
        n = prog.n_sig + prog.n_scal
        x_only = pw.adjoint(prog, (True,) + (False,) * (n - 1),
                            (True,) * len(prog.outs),
                            ("F",) + ("C",) * (prog.n_sig - 1))
        assert "#define PR_MIN_CTAS 6" in prk.reverse_source(x_only)


def test_launch_geometry():
    """plan_reverse's layout as a function of the program, rows and T
    (launch_shape): config5's first group with every gradient (its [T]
    LFO's sum over the rows) takes every row in one chunk at 128 x
    480,000, so pass 1 runs the per-sample tail and the workspace holds no
    per-sample partial; at 128-sample blocks (gx = 1) the rows are chunked
    and the tail stays in pass 2.  The input's program walks HOIST_ROWS
    rows a thread where that grid keeps HOIST_MIN_CTAS CTAs (128 x
    480,000), else one row (128 x 48,000, 128 x 128); a program with no
    per-sample value one row."""
    every, _, _ = _config5_adjoints()
    prog = tpw._config5_programs("fast")[0]
    n = prog.n_sig + prog.n_scal
    x_only = pw.adjoint(prog, (True,) + (False,) * (n - 1),
                        (True,) * len(prog.outs), ("F", "C"))
    w = prk.worlds(every)
    gx = -(-480_000 // (pk.V * prk.THREADS))
    assert gx >= prk.TAIL_MIN_GX
    assert prk.launch_shape(every, 128, 480_000, True) == (128, gx, 1)
    assert prk.tail_in_pass1(w, 1)
    nfu, ncu = len(w.reds[("F", "U")]), len(w.reds[("C", "U")])
    assert prk.workspace_size(w, 128, 480_000, gx, 1) == (nfu + ncu) * gx
    rch, gx1, gy = prk.launch_shape(every, 128, 128, True)
    assert (rch, gx1, gy) == (prk.ROW_CHUNK, 1, 128 // prk.ROW_CHUNK)
    assert not prk.tail_in_pass1(w, gy)
    assert prk.workspace_size(w, 128, 128, 1, gy) == (
        nfu * gy + len(w.reds[("F", "C")]) * gy * 128)
    assert prk.hoisted(x_only)
    r = prk.HOIST_ROWS
    assert prk.launch_shape(x_only, 128, 480_000, True) == (
        r, gx, -(-128 // r))
    assert gx * -(-128 // r) >= prk.HOIST_MIN_CTAS
    gx48 = -(-48_000 // (pk.V * prk.THREADS))
    assert gx48 * -(-128 // r) < prk.HOIST_MIN_CTAS
    assert prk.launch_shape(x_only, 128, 48_000, True) == (1, gx48, 128)
    assert prk.launch_shape(x_only, 128, 128, True) == (1, 1, 128)
    b = pw.Builder()
    mix = pw.adjoint(b.program([pw.mix(b, b.sig(), b.sig(), b.scal())]),
                     (True, False, False), (True,), ("F", "F"))
    assert not prk.hoisted(mix)
    assert prk.launch_shape(mix, 128, 480_000, True) == (1, gx, 128)
    # the grid's y limit: enough rows a chunk
    assert prk.launch_shape(mix, 200_000, 128, True)[2] <= pk.MAX_GRID_Y


def test_plan_passes():
    """Which passes a launch runs (plan_reverse on the CPU at small
    shapes): the input's program pass 1 alone; every gradient both, at
    one chunk of every row (the LFO's gradient from pass 1) and chunked;
    only the [T] LFO needing one, one chunk of every row: pass 1 alone,
    no workspace."""
    prog = tpw._config5_programs("fast")[0]
    n = prog.n_sig + prog.n_scal
    x = torch.zeros(3, 64)
    lfo = torch.zeros(64)
    scals = [torch.tensor(1.0)] * prog.n_scal
    cts = [torch.zeros(3, 64)] * len(prog.outs)
    for need, want in (([True] + [False] * (n - 1), (True, False)),
                       ([True] * n, (True, True)),
                       ([False, True] + [False] * (n - 2), (True, False))):
        pl = pk.plan_adjoint(prog, [x, lfo], scals, cts, need, 64)
        ln = prk.plan_reverse(pl, CPU)
        assert (ln.pass1, ln.pass2) == want, need
        assert ln.grid[1] == (1 if need[1] else 3), need
        if need[1] and not need[0]:
            assert ln.part is None
            assert prk.tail_in_pass1(prk.worlds(pl.adj), 1)


def test_model_constants_are_the_kernels():
    """THREADS, V, THREADS2 of the model and the launch are the kernel's
    PR_THREADS, PR_V and PR2_THREADS; its tree, its partials' layout (both
    of pass 1's layouts), its walk (the per-sample values from the chunk's
    first row, then the rows in order, the per-sample tail in pass 1 where
    one chunk holds every row) and pass 2's strided sums are the
    model's."""
    src = (pathlib.Path(pk.__file__).resolve().parent.parent / "csrc"
           / "pointwise_reverse_kernel.cu").read_text()
    assert re.search(rf"#define PR_THREADS {prk.THREADS}\b", src)
    assert re.search(rf"#define PR_V {pk.V}\b", src)
    assert re.search(rf"#define PR2_THREADS {prk.THREADS2}\b", src)
    for line in (
            "for (int o = 16; o > 0; o >>= 1) v += "
            "__shfl_down_sync(0xffffffffu, v, o);",
            "for (int w = 0; w < THREADS / 32; ++w) s += sh[w];",
            "const long long r0 = (long long)blockIdx.y * rch;",
            "pr_load<VEC>(a, r0, t0, x);",
            "for (int i = 0; i < NV; ++i) cv[i] = pr_col(U, x[i]);",
            "for (long long row = r0; row < r1; ++row) {",
            "pr_point(U, cv[i], x[i], g[i], aU, aR, aC[i]);",
            "fr[(k * rows + row) * gx + blockIdx.x] = s;",
            "  if (gy == 1) {",
            "pr_time(U, a.in, a.in_sb, a.in_st, a.ptr, a.out, t0 + i, aC[i], "
            "aT);",
            "if (threadIdx.x == 0) fc[k * gx + blockIdx.x] = s;",
            "fc[(k * gy + blockIdx.y) * T + t0 + i] = aC[i][k];",
            "part[k * gx * gy + blockIdx.y * gx + blockIdx.x] = s;",
            "for (long long i = threadIdx.x; i < n; i += PR2_THREADS) "
            "s += part[i];",
            "for (int k = 0; k < PR_NFU; ++k) ru[k] = pr_sum2(part + k * nc, "
            "nc, sh);",
            "for (long long i = 0; i < gx; ++i) s += "
            "fr[(k * rows + row) * gx + i];",
            "if (PR_NFC > 0 && gy == 1) {",
            "ru[PR_NFU + PR_NRU + k] = pr_sum2(fc + k * gx, gx, sh);",
            "for (long long j = 0; j < gy; ++j) s += "
            "fc[(k * gy + j) * T + t];",
            "for (long long row = threadIdx.x; row < rows; "
            "row += PR2_THREADS) {",
            "for (long long t = threadIdx.x; t < T; t += PR2_THREADS) {"):
        assert line in src, line


# -- dispatch -----------------------------------------------------------------

def test_reverse_kernel_refuses_the_cpu():
    prog = tpw._config5_programs("fast")[0]
    with pytest.raises(ValueError, match="no kernel"):
        prk.reverse_group(prog, [torch.zeros(2, 8), torch.zeros(8)],
                          [torch.tensor(1.0)] * prog.n_scal,
                          [torch.zeros(2, 8)] * len(prog.outs),
                          [True] * (prog.n_sig + prog.n_scal), 8, CPU)


def test_function_backward_is_swappable():
    """PointwiseGroup's backward is the one ``run`` is given (the plain
    adjoint here), group_vjp where none is; both give autograd's
    gradients of the group's operands."""
    prog = tpw._config5_programs("fast")[0]
    x = (torch.randn(B, T, generator=torch.Generator().manual_seed(1))
         * 0.7).requires_grad_(True)
    lfo = torch.sin(torch.arange(T) * 0.01)
    lv = torch.tensor(0.8, requires_grad=True)
    scals = [tprec.scalar_on(v, CPU) for v in (1.2, 1.0001, 6.0)] + [
        lv, tprec.scalar_on(4.0, CPU)]
    ct = torch.randn(B, T)
    got = {}
    for name, bwd in (("adjoint", pk.group_adjoint), ("vjp", None)):
        x.grad = lv.grad = None
        ys = pk.run(pw.interpret, prog, [x, lfo], scals, T, CPU, bwd)
        torch.autograd.backward(ys, [ct] * len(ys))
        got[name] = (x.grad.clone(), lv.grad.clone())
    assert tpw._same(got["adjoint"][0], got["vjp"][0])
    assert float(got["adjoint"][1]) == pytest.approx(float(got["vjp"][1]),
                                                     rel=REDUCED_RTOL)


def test_class_rules():
    """An operand's class in the iteration shape: a [T] signal spans the
    time alone, a [B, 1] one the rows alone, a 0-d one neither, one that
    spans part of the batch is expanded to all of it, and in a one-row
    launch every signal spans the rows."""
    F = (2, 3, 8)
    assert pw.class_of((8,), F) == "C"
    assert pw.class_of((2, 3, 1), F) == "R"
    assert pw.class_of((), F) == "U"
    assert pw.class_of((2, 1, 8), F) == "F"
    assert pw.class_of((1, 3, 8), F) == "F"
    assert pw.class_of((8,), (1, 8)) == "F"
    assert pw.join("R", "C") == "F" and pw.join("U", "R") == "R"


def test_part_batch_operand_gradient_is_summed():
    """An operand spanning part of the batch ([2, 1, T] in [2, 3, T]) is
    expanded for the backward and its full gradient summed back by the
    wrapper: autograd's gradient within the reduced bound."""
    b = pw.Builder()
    a, c = b.sig(), b.sig()
    prog = b.program([pw.mix(b, a, c, b.scal())])
    rng = np.random.default_rng(4)
    sa = torch.from_numpy(rng.standard_normal((2, 1, 64)).astype(F32))
    sc = torch.from_numpy(rng.standard_normal((2, 3, 64)).astype(F32))
    ct = torch.from_numpy(rng.standard_normal((2, 3, 64)).astype(F32))
    got = pk.group_adjoint(prog, [sa, sc], [torch.tensor(0.3)], [ct],
                           [True] * 3, 64, CPU)
    want = pk.group_vjp(prog, [sa, sc], [torch.tensor(0.3)], [ct],
                        [True] * 3, 64, CPU)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert _reduced_err(g, w) <= REDUCED_RTOL

