"""The pointwise groups of the port (compiler/pointwise.py: the IR, its
lowering and its plain version; ops/pointwise_kernel.py: the generated
CUDA, the launch's layout, the autograd Function) on the CPU, where the
plain version runs.  The kernel itself runs only on the card
(chip_smoke.py's pointwise_phase); here:

* every fusable form's lowering, run by ``pointwise.interpret``, against
  the eager code it mirrors (the node's process_seq, compile._avg,
  compile._map_mod) under fast, parity and exact, on inputs with NaN,
  +-inf, +-0 and subnormals and sliders in and around the bypass region,
  levels at 0 and at BYPASS_EPS, drawn by hypothesis: bitwise, NaN at the
  same samples;
* the generated CUDA text: one statement an op in the program's order, a
  true divide as ``__fdiv_rn``, every f32 operation a rounded intrinsic,
  no slider's value in it, one text for one structure;
* a NumPy model of the kernel (its grid-stride walk over [rows, T], the
  float4 body and a row's tail, batch stride 0 for an unbatched operand,
  time stride 0 for a [..., 1] one, an unbatched output written by row 0
  alone; the body translated from the generated text) against the plain
  version, bitwise; for a program with a block max (Fuzz) the staged
  text (pw_block: the ops in loops over a thread's four samples, a
  pw_bmax between two, its butterfly of xor shuffles over the warp, each
  warp one 128-sample block of a row), its staging pinned to source();
* the dispatch: a group on the CPU runs the plain version, the kernel's
  launch refuses a CPU tensor, and a group whose operands require grad
  goes through PointwiseGroup (its forward swapped for the plain version
  here, as run_segment's seam is driven), with the eager route's
  gradients.
"""

import math
import re

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings, strategies as st

import dsp_stuff_tpu_torch as dt
from dsp_stuff_tpu_torch.compiler import compile as tcomp
from dsp_stuff_tpu_torch.compiler import pointwise as pw
from dsp_stuff_tpu_torch.models import presets
from dsp_stuff_tpu_torch.nodes.shapers import Chebyshev, Distort, Overdrive
from dsp_stuff_tpu_torch.nodes.simple import Add, Gain, Mix
from dsp_stuff_tpu_torch.ops import pointwise_kernel as pk
from dsp_stuff_tpu_torch.ops.shaping import BYPASS_EPS
from dsp_stuff_tpu_torch.registry import ParamSpec
from dsp_stuff_tpu_torch.utils import precision as tprec

POLICIES = ["fast", "parity", "exact"]
B, T = 3, 384
CPU = torch.device("cpu")
F32 = np.float32
SPECIALS = (np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-40, -1e-40, 1e-45,
            1e30, -1e30, 1.0, -1.0, 20.0, -20.0)
EPS_BELOW = float(np.nextafter(F32(BYPASS_EPS), F32(0)))
EPS_ABOVE = float(np.nextafter(F32(BYPASS_EPS), F32(1)))
#: slider values every form is drawn from, beside uniform draws: the
#: bypass region's edges, 0, -0, a level past the clip points
LEVELS = (0.0, -0.0, BYPASS_EPS, EPS_BELOW, EPS_ABOVE, 1e-4, 0.5, 1.0,
          4.0, 30.0)

SETTINGS = settings(max_examples=12, deadline=None, derandomize=True,
                    database=None,
                    suppress_health_check=list(HealthCheck))


@pytest.fixture(autouse=True)
def _torch_env():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    prev = tprec.get_policy()
    yield
    tprec.set_policy(prev)
    torch.set_num_threads(threads)


def _same(got, want) -> bool:
    """Bit for bit, NaN at the same samples (NaN payloads aside)."""
    if got.shape != want.shape or got.dtype != want.dtype:
        return False
    nan = torch.isnan(want)
    return bool(torch.equal(torch.isnan(got), nan) and torch.equal(
        got[~nan].view(torch.int32), want[~nan].view(torch.int32)))


def _signal(seed: int, shape, scale: float) -> torch.Tensor:
    """N(0, scale) with every one of SPECIALS planted."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * scale).astype(F32)
    flat = x.reshape(-1)
    at = rng.choice(flat.size, len(SPECIALS), replace=False)
    flat[at] = SPECIALS
    return torch.from_numpy(x)


def _levels(seed: int, shape, hi: float) -> torch.Tensor:
    """A modulated slider: uniform in [0, hi] with LEVELS and NaN
    planted."""
    rng = np.random.default_rng(seed)
    v = rng.uniform(0, hi, shape).astype(F32)
    flat = v.reshape(-1)
    at = rng.choice(flat.size, len(LEVELS) + 1, replace=False)
    flat[at] = (*LEVELS, np.nan)
    return torch.from_numpy(v)


def _node(cls, ports, **select):
    def run(xs, ps):
        return cls.process_seq({**ps, **select}, None,
                               dict(zip(ports, xs)))[0]["out"]
    return run


_DRIVE = ParamSpec("drive", 0.0, 1.0, 0.0, as_input=True)
_LEVEL = ParamSpec("level", 0.0, 30.0, 0.0, as_input=True)

#: form -> (signal inputs, {slider: its range's top}, lower, eager)
FORMS = {
    "gain": (1, {"level": 10.0},
             lambda b, xs, ps, pol: pw.gain(b, xs[0], ps["level"]),
             _node(Gain, ("in",))),
    "add": (2, {}, lambda b, xs, ps, pol: pw.add(b, *xs),
            _node(Add, ("a", "b"))),
    "mix": (2, {"ratio": 1.0},
            lambda b, xs, ps, pol: pw.mix(b, *xs, ps["ratio"]),
            _node(Mix, ("a", "b"))),
    "overdrive": (1, {"boost": 30.0, "drive": 1.0, "level": 1.0},
                  lambda b, xs, ps, pol: pw.overdrive(
                      b, xs[0], ps["boost"], ps["drive"], ps["level"], pol),
                  _node(Overdrive, ("in",), oversample="1")),
    "chebyshev": (1, {"level_pos": 50.0, "level_neg": 50.0},
                  lambda b, xs, ps, pol: pw.chebyshev_asym(
                      b, xs[0], ps["level_pos"], ps["level_neg"], pol),
                  _node(Chebyshev, ("in",))),
}
for _mode, _lower in pw.DISTORT_FORMS.items():
    FORMS[f"distort:{_mode}"] = (
        1, {"level": 30.0},
        lambda b, xs, ps, pol, lower=_lower: lower(b, xs[0], ps["level"],
                                                   pol),
        _node(Distort, ("in",), mode=_mode, oversample="1"))
NODE_FORMS = list(FORMS)


def _run_form(form, xs, ps, pol):
    """(plain version of the lowering, eager code) of ``form`` on the
    signals ``xs`` and sliders ``ps`` (floats or tensors)."""
    _, _, lower, eager = FORMS[form]
    b = pw.Builder()
    sigs = list(xs)
    vx = [b.sig() for _ in xs]
    vp, scals = {}, []
    for k, v in ps.items():
        if isinstance(v, torch.Tensor):
            sigs.append(v)
            vp[k] = b.sig()
        else:
            scals.append(tprec.on_device(v, CPU))
            vp[k] = b.scal()
    prog = b.program([lower(b, vx, vp, pol)])
    with dt.policy(pol):
        got = pw.interpret(prog, sigs, scals, T, CPU)[0]
        want = eager(list(xs), dict(ps))
    return got, want


@st.composite
def _case(draw, form):
    n_x, sliders, _, _ = FORMS[form]
    seed = draw(st.integers(0, 2**31 - 1))
    scale = draw(st.sampled_from([0.05, 0.7, 3.0, 50.0]))
    xs = [_signal(seed, (B, T), scale)]
    xs += [_signal(seed + i, (T,), scale) for i in range(1, n_x)]
    ps = {}
    for i, (k, hi) in enumerate(sliders.items()):
        kind = draw(st.sampled_from(["level", "uniform", "signal"]))
        if kind == "level":
            ps[k] = draw(st.sampled_from(LEVELS))
        elif kind == "uniform":
            ps[k] = draw(st.floats(0.0, hi, width=32))
        else:
            shape = draw(st.sampled_from([(B, T), (T,)]))
            ps[k] = _levels(seed + 100 + i, shape, hi)
    return xs, ps


@pytest.mark.parametrize("pol", POLICIES)
@pytest.mark.parametrize("form", NODE_FORMS)
def test_form_lowering_is_the_eager_code(form, pol):
    """Each node form's program, run op by op, is bitwise the node's eager
    process_seq: sliders as floats (read as 0-d device tensors) and as
    modulated signals, inputs with every special value."""
    @SETTINGS
    @given(case=_case(form))
    def check(case):
        xs, ps = case
        got, want = _run_form(form, xs, ps, pol)
        assert _same(got, want), form
    check()


@pytest.mark.parametrize("pol", POLICIES)
@pytest.mark.parametrize("n", [1, 2, 3])
def test_avg_form(n, pol):
    """compile._avg of n sources (a [B, T] one, then unbatched [T] ones) is
    the avg form: the f32 chain of adds, then one true divide by the
    fan-in divisor."""
    @SETTINGS
    @given(seed=st.integers(0, 2**31 - 1),
           scale=st.sampled_from([0.05, 1.0, 1e30]))
    def check(seed, scale):
        xs = [_signal(seed, (B, T), scale)]
        xs += [_signal(seed + i, (T,), scale) for i in range(1, n)]
        b = pw.Builder()
        vx = [b.sig() for _ in xs]
        prog = b.program([pw.avg(b, vx, b.scal())])
        with dt.policy(pol):
            got = pw.interpret(prog, xs, [tcomp._divisor_on(n, CPU)], T,
                               CPU)[0]
            want = tcomp._avg(xs, T)[0]
        assert _same(got, want)
    check()


@pytest.mark.parametrize("pol", POLICIES)
@pytest.mark.parametrize("spec", [_LEVEL, _DRIVE,
                                  ParamSpec("level_pos", 0.0, 50.0, 0.0)])
def test_map_mod_form(spec, pol):
    """compile._map_mod of a modulation signal is the map_mod form."""
    @SETTINGS
    @given(seed=st.integers(0, 2**31 - 1),
           scale=st.sampled_from([0.5, 1.0, 3.0]))
    def check(seed, scale):
        x = _signal(seed, (B, T), scale)
        b = pw.Builder()
        prog = b.program([pw.map_mod(b, b.sig(), spec.lo, spec.hi)])
        with dt.policy(pol):
            got = pw.interpret(prog, [x], [], T, CPU)[0]
            want = tcomp._map_mod(x, spec)
        assert _same(got, want)
    check()


def test_zero_form_is_a_signal():
    """An unconnected port's average is zeros [T] (compile._avg): a signal,
    so a form on it keeps the eager shape."""
    b = pw.Builder()
    prog = b.program([pw.gain(b, pw.avg(b, [], None), b.scal())])
    got = pw.interpret(prog, [], [tprec.scalar_on(2.0, CPU)], T, CPU)[0]
    assert got.shape == (T,) and not bool(got.any())


# -- the generated CUDA text --------------------------------------------------

def _config5_programs(pol="fast", **values):
    """The programs of config5's groups (compile._lower_group), with the
    sliders named in ``values`` ({cfg_name: {param: value}}) set first."""
    g, _ = presets.config5_feedback_16node()
    for node in g.nodes.values():
        node.params.update(values.get(node.cfg_name, {}))
    cg = dt.compile_graph(g, device="cpu")
    with dt.policy(pol):
        groups, _ = cg._pointwise_plan({}, {})
        return [cg._lower_group(m, None)[0] for m in groups]


_STMT = re.compile(r"^  (?:const (float|double|bool) v(\d+)|U\.v(\d+)) = "
                   r"(.+);$")
_ARITH = {"add": "add", "sub": "sub", "mul": "mul", "div": "div"}


def _statements(src):
    """{value: expression} of the generated text's statements."""
    out = {}
    for line in src.splitlines():
        m = _STMT.match(line)
        if m:
            v = int(m.group(2) or m.group(3))
            assert v not in out, f"v{v} assigned twice"
            out[v] = m.group(4)
    return out


@pytest.mark.parametrize("pol", POLICIES)
def test_source_one_statement_per_op(pol):
    """The generated text has one statement an op, each f32 (f64)
    arithmetic op its __f*_rn (__d*_rn) intrinsic, a true divide
    __fdiv_rn and nothing else a divide; no bare arithmetic operator;
    the same text every time."""
    from dsp_stuff_tpu_torch.ops import shaping
    progs = _config5_programs(pol) + [
        pk._shaper_program(pw.shaper_form(shaping.overdrive),
                           ("scal", "sig", "scal"), pol)] + [
        pk._shaper_program(pw.shaper_form(fn), ("scal",), pol)
        for mode, fn in shaping.DISTORT_MODES.items() if mode != "Fuzz"]
    for prog in progs:
        src = pk.source(prog)
        assert src == pk.source(pw.Program(*prog))
        stmts = _statements(src)
        assert sorted(stmts) == list(range(len(prog.ops)))
        for i, (op, dt_, _, _) in enumerate(prog.ops):
            e = stmts[i]
            if op in _ARITH:
                p = "f" if dt_ == "f32" else "d"
                assert e.startswith(f"__{p}{_ARITH[op]}_rn("), (i, e)
            if op == "div":
                assert e.startswith(("__fdiv_rn(", "__ddiv_rn(")), e
            body = re.sub(r"-?0x[0-9a-f.]+p[+-]\d+f?", "L", e)
            assert not re.search(r"[^<>=!]\s[+*/]\s|\s-\s", body), e
        n_div = sum(op == "div" for op, *_ in prog.ops)
        assert src.count("__fdiv_rn(") + src.count("__ddiv_rn(") == n_div
        assert not any("/" in e for e in stmts.values())


def test_source_holds_no_slider_value():
    """config5's groups make the same programs and texts whatever the
    sliders hold (the scalars are operands read from device memory), and
    no slider's value appears in the text, as a hex literal or a
    decimal."""
    odd = {"gain": {"level": 1.2345678}, "overdrive": {
        "boost": 6.54321, "level": 0.7654321},
           "distort": {"level": 4.4444444}, "mix": {"ratio": 0.3141593}}
    base, moved = _config5_programs(), _config5_programs(**odd)
    assert base == moved
    text = "\n".join(pk.source(p) for p in moved)
    for params in odd.values():
        for v in params.values():
            f = np.float32(v)
            assert float(f).hex() not in text
            assert repr(float(f))[:6] not in text
    assert "*s[" in text and "__fdiv_rn(" in text


def test_programs_of_a_structure_are_one_build():
    """The build key is the program: config5 under parity and exact makes
    one text (the same ops), fast another (f32 transcendentals)."""
    fast, parity, exact = (
        [pk.source(p) for p in _config5_programs(pol)] for pol in POLICIES)
    assert parity == exact and fast != parity
    assert "atanf(" in fast[0] and "atan(" in parity[0]
    assert "__double2float_rn(atan(" not in parity[0]


# -- a NumPy model of the kernel ---------------------------------------------

_F = {"__fadd_rn": "_add", "__dadd_rn": "_add", "__fsub_rn": "_sub",
      "__dsub_rn": "_sub", "__fmul_rn": "_mul", "__dmul_rn": "_mul",
      "__fdiv_rn": "_div", "__ddiv_rn": "_div", "pw_sign": "_sign",
      "pw_clamp": "_clamp", "fabsf": "np.abs", "fabs": "np.abs",
      "atanf": "_tr_atan", "tanhf": "_tr_tanh", "sinf": "_tr_sin",
      "atan": "_tr_atan", "tanh": "_tr_tanh", "sin": "_tr_sin",
      "expf": "_tr_exp", "exp": "_tr_exp",
      "__double2float_rn": "_f32", "pw_fresh": "_id"}


def _py(expr: str) -> str:
    """One generated C expression as Python over NumPy arrays."""
    e = re.sub(r"(-?0x[0-9a-f.]+p[+-]\d+)(f?)",
               lambda m: (f"np.float32(float.fromhex('{m.group(1)}'))"
                          if m.group(2) else
                          f"np.float64(float.fromhex('{m.group(1)}'))"), expr)
    e = re.sub(r"\b(\w+)\(", lambda m: _F.get(m.group(1),
                                               m.group(1)) + "(", e)
    e = re.sub(r"\(double\)(U\.v\d+|v\d+)", r"_f64(\1)", e)
    e = e.replace("*s[", "S[").replace("x[", "X[").replace("0.0f", "_ZERO")
    e = re.sub(r"U\.v(\d+)", r"U['\1']", e)
    e = re.sub(r"(?<![\w'])v(\d+)", r"V['\1']", e)
    e = re.sub(r"\((\S+) \? (\S+) : (\S+)\)", r"np.where(\1, \2, \3)", e)
    return e.replace("&&", "&").replace("||", "|")


def _torch_fn(name):
    def run(v):
        v = np.asarray(v)
        return getattr(torch, name)(torch.from_numpy(v.copy())).numpy()
    return run


_ENV = {
    "np": np, "_ZERO": np.float32(0.0), "_id": lambda v: v,
    "_add": np.add, "_sub": np.subtract, "_mul": np.multiply,
    "_div": np.divide,
    "_sign": lambda v: ((0 < v).astype(np.int32) - (v < 0).astype(np.int32)
                        ).astype(np.asarray(v).dtype),
    "_clamp": lambda v, lo, hi: np.where(v < lo, lo, np.where(v > hi, hi, v)),
    # the model's transcendentals are the plain version's (CUDA's libdevice
    # is held against torch's on the card by chip_smoke.py)
    "_tr_atan": _torch_fn("atan"), "_tr_tanh": _torch_fn("tanh"),
    "_tr_sin": _torch_fn("sin"), "_tr_exp": _torch_fn("exp"),
    "_f32": lambda v: np.asarray(v).astype(np.float32),
    "_f64": lambda v: np.asarray(v).astype(np.float64),
}


_STAGED_STMT = re.compile(r"^    v(\d+)\[i\] = (.+);$")
_STAGED_BMAX = re.compile(r"^  pw_bmax\(v(\d+), v(\d+)\);$")
_STAGED_OUT = re.compile(r"^    y\[i\]\[(\d+)\] = (.+);$")


def _unstage(expr: str) -> str:
    """A staged statement's expression as a pw_point one: sample i's
    value vN[i] as vN, its signal operand x[i][k] as x[k]."""
    return re.sub(r"\bv(\d+)\[i\]", r"v\1",
                  re.sub(r"\bx\[i\]\[(\d+)\]", r"x[\1]", expr))


def _translate(src):
    """(uniform statements, point statements, outputs) of a generated
    text, each statement (name, Python expression); a staged text's block
    maxima are statements ``_BMAX(V['k'])``."""
    uni, pt, outs = [], [], []
    for line in src.splitlines():
        m = _STMT.match(line)
        if m:
            (uni if m.group(3) else pt).append(
                (m.group(2) or m.group(3), _py(m.group(4))))
        m = _STAGED_STMT.match(line)
        if m:
            pt.append((m.group(1), _py(_unstage(m.group(2)))))
        m = _STAGED_BMAX.match(line)
        if m:
            pt.append((m.group(1), f"_BMAX(V['{m.group(2)}'])"))
        m = re.match(r"^  y\[(\d+)\] = (.+);$", line) or _STAGED_OUT.match(
            line)
        if m:
            outs.append(_py(_unstage(m.group(2))))
    return uni, pt, outs


def _maxn(a, b):
    """pointwise_ops.cuh pw_maxn: a if a > b or a is NaN, else b."""
    return np.where((a > b) | np.isnan(a), a, b)


def _warp_bmax(v, r, t, rows, Tn):
    """pw_bmax over the lanes' samples (rows r, samples t of the walk):
    each lane's max of its 4 samples in order, then the butterfly over the
    warp's 32 lanes (xor 16, 8, 4, 2, 1), spread back; lane u % 32 of the
    warp u // 32, which holds samples 128 (u // 32) .. + 127 of its row."""
    full = np.full((rows, Tn), np.nan, np.float32)
    full[r, t] = v
    four = full.reshape(rows, Tn // pk.V, pk.V)
    m = four[..., 0]
    for i in range(1, pk.V):
        m = _maxn(m, four[..., i])
    w = m.reshape(rows, Tn // 128, 32)
    lane = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        w = _maxn(w, w[..., lane ^ o])
    return np.repeat(w.reshape(rows, Tn // pk.V), pk.V, axis=1)[r, t]


def _kernel_model(prog, sigs, scals, Tn, grid=None):
    """The kernel's walk over [rows, T] (csrc/pointwise_kernel.cu, its
    THREADS and V pinned by test_model_constants_are_the_kernels) on the
    launch that plan_launch lays out, the body translated from the
    generated text (on ``grid``, where given, in place of the launch's:
    the kernel is right on any grid): returns the outputs and checks that
    every float4 access is 16-byte aligned and every output sample
    written once."""
    ln = pk.plan_launch(prog, sigs, scals, Tn, CPU)
    if grid is not None:
        ln = ln._replace(grid=grid)
    rows, vec = ln.rows, ln.vec
    upr = -(-Tn // pk.V) if vec else Tn
    gy, step = ln.grid[1], ln.grid[0] * pk.THREADS
    lanes_r, lanes_t = [], []
    # (row, unit) of every turn of every thread: y over the rows, x over
    # a row's units, each a grid-stride loop
    walk = [(row, u) for by in range(gy) for tid in range(step)
            for row in range(by, rows, gy) for u in range(tid, upr, step)]
    for row, u in walk:
        t0 = u * (pk.V if vec else 1)
        if vec and t0 + pk.V <= Tn:
            for s, sb, stt in zip(ln.sigs, ln.sb, ln.st):
                if stt:
                    assert (s.data_ptr() + 4 * (row * sb + t0)) % 16 == 0
            for y, osb in zip(ln.bufs, ln.osb):
                if osb or row == 0:
                    assert (y.data_ptr() + 4 * (row * osb + t0)) % 16 == 0
            m = pk.V
        else:
            m = Tn - t0 if vec else 1
        lanes_r += [row] * m
        lanes_t += range(t0, t0 + m)
    r, t = np.asarray(lanes_r), np.asarray(lanes_t)
    staged = pw.has_bmax(prog)
    if staged:
        # a warp is one block: every turn the float4 body, a CTA and the
        # grid stride whole warps, a row a whole number of warps
        assert vec and Tn % 128 == 0 and pk.THREADS % 32 == 0
        assert step % 32 == 0 and upr % 32 == 0
        assert len(r) == rows * Tn
    X = []
    for s, sb, stt in zip(ln.sigs, ln.sb, ln.st):
        off = r * sb + t * stt
        mem = torch.as_strided(s, (int(off.max()) + 1,), (1,)).numpy()
        X.append(mem[off])
    S = [s.reshape(()).numpy() for s in ln.scals]
    uni, pts, outs = _translate(pk.source(prog))
    U, V = {}, {}
    env = dict(_ENV, S=S, X=X, U=U, V=V,
               _BMAX=lambda v: _warp_bmax(v, r, t, rows, Tn))
    with np.errstate(all="ignore"):
        for name, e in uni:
            U[name] = eval(e, env)
        for name, e in pts:
            V[name] = eval(e, env)
        ys = [np.broadcast_to(eval(e, env), r.shape) for e in outs]
    got = []
    for y, osb, buf, view in zip(ys, ln.osb, ln.bufs, ln.outs):
        mem = np.full(buf.numel(), np.nan, np.float32)
        count = np.zeros(buf.numel(), np.int64)
        keep = (r == 0) if osb == 0 else np.ones_like(r, bool)
        idx = (r * osb + t)[keep]
        np.add.at(count, idx, 1)
        mem[idx] = np.asarray(y, np.float32)[keep]
        assert (count == 1).all(), "an output sample written other than once"
        assert view is buf
        got.append(torch.from_numpy(mem).reshape(buf.shape))
    return got, ln


def _model_case(name, Tn, pol):
    """(program, signals, scalars) of a model case at T = Tn."""
    rng = np.random.default_rng(len(name) + Tn)
    x = torch.from_numpy((rng.standard_normal((B, Tn)) * 0.7).astype(F32))
    x.view(-1)[:len(SPECIALS)] = torch.tensor(SPECIALS, dtype=torch.float32)
    lfo = torch.from_numpy(np.sin(np.arange(Tn) * 0.01).astype(F32))
    one = x[:1].clone()
    with dt.policy(pol):
        if name == "config5 pre -> overdrive -> distort":
            prog = _config5_programs(pol)[0]
            sigs = [x, lfo]
            scals = [tprec.scalar_on(v, CPU) for v in (1.2, 1.0001, 6.0,
                                                       0.8, 4.0)]
        elif name == "mix, a slider a [B, 1] signal":
            b = pw.Builder()
            a, c, r_ = b.sig(), b.sig(), b.sig()
            prog = b.program([pw.mix(b, a, c, r_)])
            sigs = [x, lfo, torch.rand(B, 1)]
            scals = []
        elif name == "an unbatched output beside a batched one":
            b = pw.Builder()
            a, c, lv = b.sig(), b.sig(), b.scal()
            prog = b.program([pw.gain(b, c, lv), pw.add(b, a, c)])
            sigs, scals = [x, lfo], [tprec.scalar_on(0.5, CPU)]
        else:                                   # one row: float4 and tail
            b = pw.Builder()
            a, lv = b.sig(), b.scal()
            prog = b.program([pw.soft_clip(b, a, lv, pol)])
            sigs, scals = [one], [tprec.scalar_on(4.0, CPU)]
    return prog, sigs, scals


def _staged_case(name, Tn, pol):
    """(program, signals, scalars) of a staged model case at T = Tn."""
    rng = np.random.default_rng(len(name) + Tn)
    x = torch.from_numpy((rng.standard_normal((B, Tn)) * 0.7).astype(F32))
    x.view(-1)[:len(SPECIALS)] = torch.tensor(SPECIALS, dtype=torch.float32)
    x[1, :128] = 0.0                               # an all-zero block: NaN
    lfo = torch.from_numpy((2.0 + np.sin(np.arange(Tn) * 0.01)).astype(F32))
    b = pw.Builder()
    if name == "fuzz, a slider":
        prog = b.program([pw.fuzz(b, b.sig(), b.scal(), pol)])
        return prog, [x], [tprec.scalar_on(3.0, CPU)]
    if name == "fuzz, its level an LFO":
        prog = b.program([pw.fuzz(b, b.sig(), b.sig(), pol)])
        return prog, [x, lfo], []
    if name == "fuzz of an unbatched signal":
        prog = b.program([pw.fuzz(b, b.sig(), b.scal(), pol)])
        return prog, [lfo - 2.0], [tprec.scalar_on(3.0, CPU)]
    # gain -> fuzz -> mix with the input: two outputs, one before a bmax
    xv, lv, r_ = b.sig(), b.scal(), b.scal()
    g = pw.gain(b, xv, lv)
    prog = b.program([pw.mix(b, pw.fuzz(b, g, lv, pol), xv, r_), g])
    return prog, [x], [tprec.scalar_on(v, CPU) for v in (1.5, 0.4)]


STAGED_CASES = ["fuzz, a slider", "fuzz, its level an LFO",
                "fuzz of an unbatched signal", "gain -> fuzz -> mix"]


@pytest.mark.parametrize("grid", [None, (2, 2)])
@pytest.mark.parametrize("Tn", [128, 1024, 4096])
@pytest.mark.parametrize("name", STAGED_CASES)
def test_staged_kernel_model_is_the_plain_version(name, Tn, grid):
    """A program with block maxima (Fuzz) through the model of the staged
    kernel (pw_block translated from the generated text, pw_bmax as the
    warp's butterfly) on the launch's grid and on 2 x 2 CTAs: bitwise the
    plain version under the three policies, NaN where a block is all zero
    or holds a NaN or an inf."""
    for pol in POLICIES:
        prog, sigs, scals = _staged_case(name, Tn, pol)
        with dt.policy(pol):
            want = pw.interpret(prog, sigs, scals, Tn, CPU)
        got, ln = _kernel_model(prog, sigs, scals, Tn, grid)
        assert ln.vec
        for g, w in zip(got, want):
            assert _same(g, w), (name, Tn, pol)


def test_source_is_staged_around_each_block_max():
    """A bmax program's text: PW_STAGED and pw_block in place of pw_point;
    one statement an op not uniform, in the program's order, each in a
    loop over the thread's 4 samples; each bmax a pw_bmax between two
    loops, its operand computed in an earlier loop; the outputs in the
    last; Fuzz: three stages around three maxima and four loops.  The
    kernel runs pw_block in its float4 body alone, and its launch refuses
    anything but that body over whole blocks."""
    import pathlib
    for pol in POLICIES:
        b = pw.Builder()
        prog = b.program([pw.fuzz(b, b.sig(), b.scal(), pol)])
        src = pk.source(prog)
        assert "#define PW_STAGED 1" in src and "pw_point" not in src
        lines = src.splitlines()
        loops = [i for i, ln in enumerate(lines)
                 if ln == f"  for (int i = 0; i < {pk.V}; ++i) {{"]
        maxima = [i for i, ln in enumerate(lines) if _STAGED_BMAX.match(ln)]
        assert len(maxima) == 3 and len(loops) == 4
        for i in maxima:
            assert lines[i - 1] == "  }" and lines[i + 2] in (
                f"  for (int i = 0; i < {pk.V}; ++i) {{",)
        stage_of, order, stage = {}, [], 0
        for i, ln in enumerate(lines):
            m = _STAGED_BMAX.match(ln)
            if m:
                assert stage_of[int(m.group(2))] == stage
                stage += 1
                stage_of[int(m.group(1))] = stage
                order.append(int(m.group(1)))
            m = _STAGED_STMT.match(ln)
            if m:
                stage_of[int(m.group(1))] = stage
                order.append(int(m.group(1)))
                for a in re.findall(r"\bv(\d+)\[i\]", m.group(2)):
                    assert stage_of[int(a)] <= stage
            if _STAGED_OUT.match(ln):
                assert stage == 3
        assert order == sorted(order)
        assert sorted(order) == [i for i, o in enumerate(prog.ops)
                                 if o[0] not in ("scal", "const")]
    cu = (pathlib.Path(pk.__file__).resolve().parent.parent / "csrc"
          / "pointwise_kernel.cu").read_text()
    assert "#ifdef PW_STAGED\n        pw_block(U, x, y);\n#else" in cu
    assert "#ifdef PW_STAGED\n  if (!vec || T % 128) return" in cu
    ops = (pathlib.Path(pk.__file__).resolve().parent.parent / "csrc"
           / "pointwise_ops.cuh").read_text()
    assert "return (a > b || a != a) ? a : b;" in ops
    assert "for (int o = 16; o > 0; o >>= 1)" in ops
    assert "r = pw_maxn(r, __shfl_xor_sync(0xffffffffu, r, o));" in ops


MODEL_CASES = ["config5 pre -> overdrive -> distort",
               "mix, a slider a [B, 1] signal",
               "an unbatched output beside a batched one",
               "one row"]


@pytest.mark.parametrize("grid", [None, (2, 2)])
@pytest.mark.parametrize("Tn", [1024, 1030, 1027, 8200, 8198])
@pytest.mark.parametrize("name", MODEL_CASES)
def test_kernel_model_is_the_plain_version(name, Tn, grid):
    """The kernel's walk (float4 body where every row start is aligned: T
    = 1024 and 8200; one sample a thread where a row start is not: T =
    1030, 1027 and 8198 over three rows; a row's tail of 1-3 samples: one
    row at T = 1027, 1030 and 8198), batch stride 0 for the [T] LFO, time
    stride 0 for a [B, 1] slider, an output of an unbatched operand
    written by row 0, on the launch's grid (a unit a thread) and on a
    grid of 2 x 2 CTAs (both grid-stride loops turn): bitwise the plain
    version, the body translated from the generated text."""
    for pol in ("fast", "parity"):
        prog, sigs, scals = _model_case(name, Tn, pol)
        with dt.policy(pol):
            want = pw.interpret(prog, sigs, scals, Tn, CPU)
        got, ln = _kernel_model(prog, sigs, scals, Tn, grid)
        if name == "one row" or Tn % 8 == 0:
            assert ln.vec
        elif name != "an unbatched output beside a batched one":
            assert not ln.vec
        if name == "an unbatched output beside a batched one":
            assert ln.osb == [0, Tn]
        if name == "mix, a slider a [B, 1] signal":
            assert ln.st == [1, 1, 0] and ln.sb[1] == 0
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.shape == w.shape
            assert _same(g, w), (name, Tn, pol)


def test_model_constants_are_the_kernels():
    """THREADS and V of the model and the launch are the kernel's
    PW_THREADS and PW_V, and its float4 path takes the unit's four samples
    as the model does."""
    import pathlib
    src = (pathlib.Path(pk.__file__).resolve().parent.parent / "csrc"
           / "pointwise_kernel.cu").read_text()
    assert re.search(rf"#define PW_THREADS {pk.THREADS}\b", src)
    assert re.search(rf"#define PW_V {pk.V}\b", src)
    assert "for (long long row = blockIdx.y; row < rows; row += gridDim.y)" \
        in src
    assert "const long long t0 = u * (VEC ? PW_V : 1);" in src
    assert "if (VEC && t0 + PW_V <= T)" in src
    assert "a.out_sb[k] != 0 || row == 0" in src
    assert re.search(rf"gy > {pk.MAX_GRID_Y}\b", src)
    prog, sigs, scals = _model_case("one row", 8200, "fast")
    assert pk.plan_launch(prog, sigs, scals, 8200, CPU).grid == (
        -(-8200 // (pk.V * pk.THREADS)), 1)


# -- dispatch ------------------------------------------------------------------

def test_group_call_on_the_cpu_is_the_plain_version():
    prog, sigs, scals = _model_case("one row", 1024, "fast")
    got = pk.group_call(prog, sigs, scals, 1024, CPU)
    want = pw.interpret(prog, sigs, scals, 1024, CPU)
    assert all(_same(g, w) for g, w in zip(got, want))
    with pytest.raises(ValueError, match="no kernel"):
        pk._kernel_group(prog, sigs, scals, 1024, CPU)
    with pytest.raises(ValueError, match="no kernel"):
        pk.group_call(prog, [s.to("meta") for s in sigs],
                      [s.to("meta") for s in scals], 1024, "meta")


def test_plan_launch_refuses_what_the_kernel_cannot_take():
    prog, sigs, scals = _model_case("one row", 1024, "fast")
    with pytest.raises(ValueError, match="float32"):
        pk.plan_launch(prog, [sigs[0].double()], scals, 1024, CPU)
    with pytest.raises(ValueError, match="scalar operand"):
        pk.plan_launch(prog, sigs, [torch.ones(2)], 1024, CPU)
    with pytest.raises(ValueError, match="signal operand"):
        pk.plan_launch(prog, [sigs[0][:, :512]], scals, 1024, CPU)


def _grads(route, monkeypatch, calls):
    """config5's loss gradients (input, every slider) on the CPU through
    ``route``: "function" sends each group through PointwiseGroup with the
    plain version as its forward and the autograd reference (group_vjp)
    as its backward; "eager" runs no group."""
    g, _ = presets.config5_feedback_16node()
    cg = dt.compile_graph(g, device="cpu")
    rng = np.random.default_rng(7)
    x = torch.from_numpy((rng.standard_normal((2, 1, 1280)) * 0.3)
                         .astype(F32)).requires_grad_(True)
    w = torch.from_numpy(rng.standard_normal((2, 1, 1280)).astype(F32))
    with monkeypatch.context() as m:
        if route == "function":
            def fwd(prog, sigs, scals, Tn, device):
                calls.append(torch.is_grad_enabled())
                return pw.interpret(prog, sigs, scals, Tn, device)
            m.setattr(tcomp, "group_call", lambda prog, sigs, scals, Tn, d: (
                pk.run(fwd, prog, sigs, scals, Tn, d, pk.group_vjp)))
            # every group member's node type: the feedback cycle's add
            # and gain are groups of its per-node scan (every slider a
            # leaf takes the cycle off its block program)
            for cls in (Overdrive, Distort, Mix, Add, Gain):
                def refuse(*a, cls=cls, **k):
                    raise AssertionError(f"{cls.__name__}'s eager code ran")
                m.setattr(cls, "process_seq", staticmethod(refuse))
        else:
            m.setattr(tcomp, "POINTWISE_FUSION", False)
        p = cg.init_params(requires_grad=True)
        with dt.policy("fast"):
            y = cg.render(x, batch_shape=(2,), params=p)[0]
        (y * w).sum().backward()
    return [x.grad] + [v.grad for _, e in sorted(p.items())
                       for _, v in sorted(e.items())]


def test_groups_function_seam(monkeypatch):
    """With every slider and the input requiring grad, config5's three
    groups and the two of its feedback cycle's per-node scan (one call a
    block, 10 blocks) go through PointwiseGroup (its forward with grad
    off, no member's eager code: Overdrive, Distort, Mix, Add and Gain
    refuse to run), and the gradients are the eager route's bit for bit:
    the Function's backward, given the autograd reference, is autograd
    through the same ops (the reverse kernel's plain version is held in
    tests/test_torch_pointwise_reverse.py)."""
    calls = []
    got = _grads("function", monkeypatch, calls)
    want = _grads("eager", monkeypatch, [])
    assert calls == [False] * (3 + 2 * 10)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if w is not None:
            assert torch.equal(g, w)


def test_function_outputs_do_not_alias_its_inputs():
    """A stand-in forward that hands an operand back (a group that passes
    a signal through) gets a copy out of the Function."""
    b = pw.Builder()
    a = b.sig()
    prog = b.program([a])
    x = torch.randn(4, requires_grad=True)
    (y,) = pk.run(pw.interpret, prog, [x], [], 4, CPU)
    assert y.data_ptr() != x.data_ptr()
    y.sum().backward()
    assert torch.equal(x.grad, torch.ones(4))


def test_shaper_call_is_the_eager_shaper():
    """ops/oversample's shaper pass at R > 1 (one-node groups) is the eager
    shaper on its operands, a modulated level upsampled beside x; Fuzz
    too, at its block of 128 (T = 384)."""
    from dsp_stuff_tpu_torch.ops import shaping
    x = _signal(3, (B, T), 2.0)
    lv = _levels(4, (B, T), 10.0)
    for pol in POLICIES:
        with dt.policy(pol):
            for fn in (shaping.overdrive,):
                assert _same(pk.shaper_call(fn, x, 6.0, lv, 0.8),
                             fn(x, 6.0, lv, 0.8))
            for mode, fn in shaping.DISTORT_MODES.items():
                assert _same(pk.shaper_call(fn, x, lv), fn(x, lv)), mode
                assert _same(pk.shaper_call(fn, x, 4.0), fn(x, 4.0)), mode


def test_nan_and_signed_zero_rules():
    """The rules the kernel keeps, as the plain version shows them: sign
    of NaN and -0 is +0, clamp propagates NaN, a comparison with NaN is
    false (where takes its second arm), soft clip's NaN takes -2/3 before
    the clip."""
    b = pw.Builder()
    xv = b.sig()
    big = b.or_(b.gt(xv, b.const(1.0)), b.lt(xv, b.const(-1.0)))
    prog = b.program([b.sign(xv), b.clamp(xv, -1.0, 1.0),
                      b.where(b.lt(xv, b.const(0.0)), b.const(1.0),
                              b.const(2.0)),
                      b.where(big, b.const(1.0), b.const(0.0))])
    x = torch.tensor([math.nan, -0.0, 0.0, 5.0, -5.0])
    s, c, w, o = pw.interpret(prog, [x], [], 5, CPU)
    assert o.tolist() == [0.0, 0.0, 0.0, 1.0, 1.0]
    assert " || " in pk.source(prog)
    assert s.tolist()[:3] == [0.0, 0.0, 0.0]
    assert not bool(torch.signbit(s[:3]).any())
    assert math.isnan(c[0]) and c.tolist()[3:] == [1.0, -1.0]
    assert w.tolist() == [2.0, 2.0, 2.0, 2.0, 1.0]
    b2 = pw.Builder()
    prog2 = b2.program([pw.soft_clip(b2, b2.sig(), b2.scal(), "fast")])
    y = pw.interpret(prog2, [torch.tensor([math.nan])],
                     [tprec.scalar_on(1.0, CPU)], 1, CPU)[0]
    assert float(y) == float(np.float32(-2.0 / 3.0))
