"""Fuzz as a pointwise-group member (compiler/pointwise.py: ``fuzz``, the
``bmax`` op and ``exp``; ops/pointwise_kernel.py: the staged program) on
the CPU, where a group runs its plain version (``pointwise.interpret``):

* the fuzz form, run by ``interpret``, bitwise the eager
  ``shaping.fuzz`` under fast, parity and exact, with an all-zero block
  (its 0 / 0: NaN), NaN, +-inf, +-0 and subnormals planted, the level a
  slider (0, -0 and a subnormal among them), a [B, T] and a [T]
  modulation, NaN compared by position; and against the JAX package's
  ``shaping.fuzz`` at tests/test_torch_ops.py's bounds;
* graphs holding a Fuzz (gain -> Fuzz -> mix, Fuzz with its level
  modulated and oversample "4", a Fuzz inside a feedback cycle) rendered,
  streamed block by block and through the cycle's per-node scan
  (CYCLE_FUSION off): bitwise the route without Fuzz in the groups (the
  parent's: its eager ``shaping.fuzz``) and the eager route, and the
  Fuzz's eager code not run on the group route;
* the plan: the Fuzz joins its neighbours' group whatever ``oversample``
  says;
* the backward: PointwiseGroup with no backward given is ``group_vjp``
  (autograd through ``interpret``, the reference); group_call gives every
  program the reverse kernel, a Fuzz group too; ``adjoint`` takes
  ``bmax`` (tests/test_torch_fuzz_reverse.py holds it in full);
* the launch: a bmax program needs T % 128 == 0 and the float4 build (an
  operand with unaligned rows is copied, never the scalar build).
"""

import numpy as np
import pytest
import torch

import dsp_stuff_tpu_torch as dt
from dsp_stuff_tpu_torch.compiler import compile as tcomp
from dsp_stuff_tpu_torch.compiler import pointwise as pw
from dsp_stuff_tpu_torch.ids import IdSpace
from dsp_stuff_tpu_torch.nodes import shapers as tshapers
from dsp_stuff_tpu_torch.ops import pointwise_kernel as pk
from dsp_stuff_tpu_torch.ops import shaping
from dsp_stuff_tpu_torch.utils import precision as tprec

POLICIES = ["fast", "parity", "exact"]
B, T = 3, 1024
CPU = torch.device("cpu")
F32 = np.float32
SPECIALS = (np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-40, -1e-40, 1e-45,
            1e30, -1e30, 1.0, -1.0)
#: tests/test_torch_ops.py's bounds against the JAX package
BOUND_DB = {"fast": -125.0, "parity": -130.0, "exact": -130.0}


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


def _x(seed, shape=(B, T), scale=0.7, planted=True):
    """N(0, scale) with an all-zero block in row 1 and SPECIALS planted in
    the other rows' blocks."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * scale).astype(F32)
    if planted:
        x[1, 128:256] = 0.0
        flat = x[0].reshape(-1)
        flat[rng.choice(flat.size, len(SPECIALS), replace=False)] = SPECIALS
        x[-1, 512:640] = np.float32(1e-40)           # a subnormal block
        x[-1, 700] = -0.0
    return torch.from_numpy(x)


def _fuzz_program(pol, level_kind):
    b = pw.Builder()
    x = b.sig()
    lv = b.scal() if level_kind == "slider" else b.sig()
    return b.program([pw.fuzz(b, x, lv, pol)])


LEVELS = {"slider 3.0": 3.0, "slider 0.0": 0.0, "slider -0.0": -0.0,
          "slider subnormal": 1e-40, "slider 30": 30.0}


@pytest.mark.parametrize("pol", POLICIES)
def test_fuzz_form_is_the_eager_fuzz(pol):
    """interpret of the fuzz form is bitwise shaping.fuzz: NaN where a
    block is all zero or holds a NaN or an inf, at the same samples."""
    for seed in range(3):
        x = _x(seed)
        cases = dict(LEVELS)
        cases["[B, T]"] = torch.from_numpy(np.random.default_rng(seed)
                                           .uniform(0, 8, (B, T))
                                           .astype(F32))
        cases["[T]"] = torch.from_numpy(np.random.default_rng(seed + 9)
                                        .uniform(0, 8, T).astype(F32))
        cases["[T]"][5] = np.nan
        for name, lv in cases.items():
            kind = "slider" if isinstance(lv, float) else "signal"
            prog = _fuzz_program(pol, kind)
            sigs = [x] + ([] if kind == "slider" else [lv])
            scals = [tprec.scalar_on(lv, CPU)] if kind == "slider" else []
            with dt.policy(pol):
                got = pw.interpret(prog, sigs, scals, T, CPU)[0]
                want = shaping.fuzz(x, lv, 128)
            assert _same(got, want), (pol, seed, name)
            assert bool(torch.isnan(got[1, 128:256]).all())


@pytest.mark.parametrize("pol", POLICIES)
def test_fuzz_form_against_jax(pol):
    """The fuzz form against the JAX package's shaping.fuzz on finite
    inputs (one all-zero block: NaN at the same samples in both), at
    tests/test_torch_ops.py's bound (exact at parity's)."""
    import jax
    from dsp_stuff_tpu.ops import shaping as jshaping
    from dsp_stuff_tpu.utils import precision as jprec
    x = _x(4, planted=False)
    x[:, 128:256] = 0.0
    for lv in (2.0, 0.5):
        with jprec.policy(pol):
            want = np.asarray(jax.jit(lambda v: jshaping.fuzz(v, lv, 128))(
                x.numpy()))
        prog = _fuzz_program(pol, "slider")
        with dt.policy(pol):
            got = pw.interpret(prog, [x], [tprec.scalar_on(lv, CPU)], T,
                               CPU)[0].numpy()
        assert (np.isnan(got) == np.isnan(want)).all()
        ok = ~np.isnan(want)
        err = np.abs(got[ok] - want[ok]).max() / np.abs(want[ok]).max()
        assert 20 * np.log10(max(err, 1e-30)) <= BOUND_DB[pol]


def _gain_fuzz_mix(oversample="1", modulated=False):
    """input -> gain -> Fuzz -> mix(a: Fuzz, b: input) -> output; with
    ``modulated`` the Fuzz's level read from an LFO."""
    g = dt.Graph(IdSpace())
    inp = g.add("input")
    gn = g.add("gain", level=1.7)
    fz = g.add("distort", mode="Fuzz", level=2.5, oversample=oversample)
    mx = g.add("mix", ratio=0.4)
    out = g.add("output")
    g.connect(inp, "out", gn, "in")
    g.connect(gn, "out", fz, "in")
    g.connect(fz, "out", mx, "a")
    g.connect(inp, "out", mx, "b")
    g.connect(mx, "out", out, "in")
    if modulated:
        lfo = g.add("signal_gen", mode="Sine", frequency=3.0, amplitude=0.9)
        g.connect(lfo, "out", fz, "level")
    return g


def _fuzz_cycle():
    """input -> add -> Fuzz -> low_pass -> gain -> back into the add; the
    low_pass into the output."""
    g = dt.Graph(IdSpace())
    inp = g.add("input")
    add = g.add("add")
    fz = g.add("distort", mode="Fuzz", level=3.0)
    lp = g.add("low_pass", ratio=0.3)
    fb = g.add("gain", level=0.4)
    out = g.add("output")
    g.connect(inp, "out", add, "a")
    g.connect(add, "out", fz, "in")
    g.connect(fz, "out", lp, "in")
    g.connect(lp, "out", fb, "in")
    g.connect(fb, "out", add, "b")
    g.connect(lp, "out", out, "in")
    return g


def _knob_graph():
    import test_torch_fanin_groups as fanin
    return fanin._knob_graph(dt, IdSpace)


GRAPHS = {"gain -> Fuzz -> mix": lambda: _gain_fuzz_mix(),
          "Fuzz oversample 4, level from an LFO": lambda: _gain_fuzz_mix(
              "4", True),
          "Fuzz in a feedback cycle": _fuzz_cycle,
          "chorus -> Fuzz, level of two sources": _knob_graph}


def _leaves(tree):
    if isinstance(tree, dict):
        return [v for k in sorted(tree, key=str) for v in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [v for t in tree for v in _leaves(t)]
    return [tree] if isinstance(tree, (torch.Tensor, np.ndarray)) else []


def _routes_run(g, pol, x):
    """(render outputs + aux + state, ten streamed blocks) of ``g``."""
    cg = dt.compile_graph(g, device="cpu")
    with dt.policy(pol):
        rendered = cg.render(x, batch_shape=(B,))
        s = dt.StreamSession(g, device="cpu")
        inp = str(min(i for i, n in g.nodes.items()
                      if n.cfg_name == "input"))
        blocks = [s.process({inp: x[0, 0, 128 * k:128 * (k + 1)].numpy()})
                  for k in range(x.shape[-1] // 128)]
    return _leaves([rendered, blocks])


@pytest.mark.parametrize("fusion", [True, False])
@pytest.mark.parametrize("pol", POLICIES)
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_fuzz_groups_are_the_other_routes(name, pol, fusion, monkeypatch):
    """Rendered and streamed, with the feedback cycle's block program
    (``fusion``) or its per-node scan: the route with Fuzz in the groups
    is bitwise the route without (each Fuzz its eager shaping.fuzz, the
    parent's) and the eager route, and runs no Fuzz node's eager code (a
    chain segment or a cycle program that claims the Fuzz runs its own
    shaper, as before)."""
    g = GRAPHS[name]()
    x = _x(17, (B, 1, 1280), planted=False)
    x[1, 0, 256:384] = 0.0                 # an all-zero block: NaN
    monkeypatch.setattr(tcomp, "CYCLE_FUSION", fusion)
    real = pw.node_form
    with monkeypatch.context() as m:
        m.setattr(pw, "node_form", lambda cfg, sel: None if (
            cfg == "distort" and sel.get("mode") == "Fuzz") else real(cfg,
                                                                     sel))
        without = _routes_run(g, pol, x)
    with monkeypatch.context() as m:
        m.setattr(tcomp, "POINTWISE_FUSION", False)
        eager = _routes_run(g, pol, x)
    calls = []
    real_seq = tshapers.Distort.process_seq

    def counted(params, state, inputs):
        if params["mode"] == "Fuzz":
            calls.append(inputs["in"].shape)
        return real_seq(params, state, inputs)
    with monkeypatch.context() as m:
        m.setattr(tshapers.Distort, "process_seq", staticmethod(counted))
        got = _routes_run(g, pol, x)
    assert not calls, calls
    assert len(got) == len(without) == len(eager) > 0
    for a, b, c in zip(got, without, eager):
        a, b, c = (torch.as_tensor(v) for v in (a, b, c))
        if a.dtype == torch.float32:
            assert _same(a, b) and _same(a, c), name
        else:
            assert torch.equal(a, b) and torch.equal(a, c), name


@pytest.mark.parametrize("oversample", ["1", "2", "4", "8"])
def test_fuzz_joins_the_group_whatever_oversample(oversample):
    """The Fuzz, its gain and the mix after it are one group at every
    ``oversample`` (Fuzz runs at the base rate); the program holds three
    bmax and an exp."""
    g = _gain_fuzz_mix(oversample)
    cg = dt.compile_graph(g, device="cpu")
    fz = next(n for n, v in g.nodes.items() if v.cfg_name == "distort")
    for pol in POLICIES:
        with dt.policy(pol):
            groups, _ = cg._pointwise_plan({}, {})
            home = next(m for m in groups if fz in m)
            assert len(home) >= 3
            prog = cg._lower_group(home, None)[0]
        assert sum(op == "bmax" for op, *_ in prog.ops) == 3
        assert sum(op == "exp" for op, *_ in prog.ops) == 1
        assert pw.has_bmax(prog)


def test_cycle_scan_groups_take_fuzz():
    """The feedback cycle's per-node scan plans the Fuzz in a group."""
    g = _fuzz_cycle()
    cg = dt.compile_graph(g, device="cpu")
    fz = next(n for n, v in g.nodes.items() if v.cfg_name == "distort")
    scc = sorted(next(c for c in cg._sccs if len(c) > 1))
    groups = tcomp._plan_cycle_groups(g, cg._nodes, scc)
    assert any(fz in grp for grp in groups)


def test_fuzz_group_gradients_are_group_vjp():
    """Through PointwiseGroup with no backward given (the reference route)
    the gradients of x and of a modulated level are bitwise
    group_vjp's."""
    rng = np.random.default_rng(2)
    w = torch.from_numpy(rng.standard_normal((B, T)).astype(F32))
    for pol in POLICIES:
        prog = _fuzz_program(pol, "signal")
        x = _x(3, planted=False).requires_grad_(True)
        lv = torch.from_numpy(rng.uniform(0.5, 4, (B, T)).astype(F32)) \
            .requires_grad_(True)
        with dt.policy(pol):
            (y,) = pk.run(pw.interpret, prog, [x, lv], [], T, CPU)
            assert type(y.grad_fn).__name__.startswith("PointwiseGroup")
            (y * w).sum().backward()
            want = pk.group_vjp(prog, [x, lv], [], [w], (True, True), T, CPU)
        assert _same(x.grad, want[0]) and _same(lv.grad, want[1])


def test_group_call_picks_the_backward(monkeypatch):
    """group_call on the card's device passes the reverse kernel as the
    backward for every program, one with bmax too."""
    from dsp_stuff_tpu_torch.ops import pointwise_reverse_kernel as prk
    seen = []
    monkeypatch.setattr(pk, "run", lambda fwd, prog, sigs, scals, Tn, d,
                        backward=None: seen.append(backward))
    x = torch.zeros(2, 256)
    for pol in POLICIES:
        fz = _fuzz_program(pol, "slider")
        b = pw.Builder()
        gain = b.program([pw.gain(b, b.sig(), b.scal())])
        pk.group_call(fz, [x], [torch.tensor(1.0)], 256, "cuda")
        pk.group_call(gain, [x], [torch.tensor(1.0)], 256, "cuda")
    assert seen == [prk.reverse_group] * 6


def test_adjoint_refuses_bmax():
    """The adjoint takes a bmax program (its gradients bitwise autograd's
    through interpret, group_vjp); bmax still refuses a value that is not
    an abs."""
    prog = _fuzz_program("fast", "slider")
    adj = pw.adjoint(prog, (True, True), (True,), ("F",))
    assert any(op == "bsum" for op, *_ in adj.ops)
    assert any(op == "bcnt" for op, *_ in adj.ops)
    x = _x(4)
    ct = torch.from_numpy(np.random.default_rng(5).standard_normal((B, T))
                          .astype(F32))
    lv = [tprec.scalar_on(3.0, CPU)]
    got = pk.group_adjoint(prog, [x], lv, [ct], (True, True), T, CPU)
    want = pk.group_vjp(prog, [x], lv, [ct], (True, True), T, CPU)
    assert all(_same(g, w) for g, w in zip(got, want))
    b = pw.Builder()
    with pytest.raises(ValueError, match="abs"):
        b.bmax(b.sig())


def test_bmax_launch_layout():
    """A bmax program's launch: T % 128 == 0 or it raises; an operand whose
    rows start off 16 bytes is copied to a fresh buffer, and the launch is
    the float4 build; interpret refuses a T off the block."""
    prog = _fuzz_program("fast", "slider")
    one = [tprec.scalar_on(2.0, CPU)]
    with pytest.raises(ValueError, match="T % 128"):
        pk.plan_launch(prog, [torch.zeros(2, 200)], one, 200, CPU)
    with pytest.raises(ValueError, match="bmax"):
        pw.interpret(prog, [torch.zeros(2, 200)], one, 200, CPU)
    flat = torch.randn(2 * 512 + 1)
    xu = flat[1:].view(2, 512)                     # 4 bytes off
    ln = pk.plan_launch(prog, [xu], one, 512, CPU)
    assert ln.vec and ln.sigs[0].data_ptr() % 16 == 0
    assert torch.equal(ln.sigs[0], xu)
    aligned = torch.randn(2, 512)
    ln = pk.plan_launch(prog, [aligned], one, 512, CPU)
    assert ln.vec and ln.sigs[0].data_ptr() == aligned.data_ptr()
