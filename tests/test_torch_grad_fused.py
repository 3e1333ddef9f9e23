"""Gradients through the port's fused paths, held against jax.grad of the
JAX package's custom_vjp's: the chain segment (ops/chain_segment.py,
``ChainSegment``) and the feedback cycle's block program
(ops/cycle_segment.py, ``CycleSegment``), alone and through
``compile_graph``.

On the card the Functions run the chain and cycle kernels forward and
their reverse kernels backward.  Here the forward is the plain version
under no_grad (``run_segment`` / ``run_cycle`` with ``segment_fallback``
/ ``interpret`` standing in for the kernel), or the JAX Pallas kernel in
interpret mode behind the kernel path's raw-output rebuild; the chain's
backward is ``run_segment``'s default, ``segment_vjp`` (the vjp of the
plain composition, the reverse chain kernel's reference; its plain
version ``segment_adjoint`` is held in tests/test_torch_chain_reverse.py),
the cycle's the reverse kernel's plain version ``interpret_adjoint``.  Through
``compile_graph`` the chain_segment and cycle_segment calls are routed the
way the card routes them (``_card_dispatch``), so the planner's fused
paths, its split of a mega run at an overridden member included, take
the Functions.

Bound: every gradient, max-normalized (max |got - want| / max |want|
over the array), <= 1e-3 (PERF.md section 2's gradient bound; the worst
measured on the CPU is printed by each test, about 1e-6).  The chain
Function's gradients against autograd straight through the plain
composition: bitwise (the backward re-runs that composition).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dsp_stuff_tpu as dj
from chip_smoke import cycle_programs_of
from dsp_stuff_tpu.ids import IdSpace as JIdSpace
from dsp_stuff_tpu.models import presets as jpresets
from dsp_stuff_tpu.ops import chain_segment as jcs
from dsp_stuff_tpu.ops import cycle_segment as jcyc
from dsp_stuff_tpu.ops import modfx as jm
from dsp_stuff_tpu.ops import pallas_chain as jpc
from dsp_stuff_tpu.train import fit as jfit
from dsp_stuff_tpu.utils import precision as jprec
import dsp_stuff_tpu_torch as dt
import test_torch_fuzz_gen as gen
from dsp_stuff_tpu_torch.compiler import compile as tcomp
from dsp_stuff_tpu_torch.ids import IdSpace as TIdSpace
from dsp_stuff_tpu_torch.ops import chain_kernel as tck
from dsp_stuff_tpu_torch.ops import chain_segment as tcs
from dsp_stuff_tpu_torch.ops import cycle_segment as tcyc
from dsp_stuff_tpu_torch.ops import modfx as tm
from dsp_stuff_tpu_torch.ops.cascade import _embed_dim, composite_dim
from dsp_stuff_tpu_torch.train import fit as tfit
from dsp_stuff_tpu_torch.utils import precision as tprec

GRAD_RTOL = 1e-3

H = float(np.float32(np.float32(1.0) / np.float32(1.0001)))
BENCH_STAGES = (
    ("cascade", (("gain", H), ("gain", 1.2), ("gain", H),
                 ("bq", (-0.24, 0.0, 0.758, 0.0, 0.0)))),
    ("scale", H), ("ew", "overdrive", (4.0, 0.6, 0.9)),
    ("cascade", (("gain", H), ("lp", 0.6), ("gain", H), ("hp", 0.2))),
    ("scale", H), ("ew", "distort:Tanh", (3.0,)),
    ("scale", H), ("ew", "chebyshev", (2.0, 4.0)),
    ("scale", H), ("comb", 0.4, 2400), ("scale", H))
TAP_STAGES = (
    ("cascade", (("gain", 1.1), ("lp", 0.55))), ("tap", 0),
    ("ew", "distort:SoftClip", (2.5,)),
    ("cascade", (("bq", (-0.3, 0.05, 0.8, 0.1, 0.0)),)),
    ("comb", 0.45, 192), ("tap", 1),
    ("cascade", (("hp", 0.12),)))
COMB_STAGES = (
    ("comb", 0.6, 300), ("scale", 0.8), ("ew", "distort:SoftClip", (2.0,)),
    ("comb", 0.3, 130), ("ew", "distort:Atan", (1.5,)))
#: (rate Hz, depth s, base s) of config2's and config5's choruses
LFOS = {"config2": (0.8, 0.004, 0.012), "config5": (1.2, 0.003, 0.008)}


def _mtap_stages(name):
    """config2's or config5's list with its chorus, and the chorus's LFO."""
    rate, depth, base = LFOS[name]
    L = tm.max_delay_samples(base, depth)
    NH, EV, RS = tm.mtap_static(rate, depth, base, L)
    if name == "config2":          # reverb -> chorus -> gain, folded scales
        return (("comb", 0.45, 12000), ("mtap", 0.5, L, NH, EV, RS),
                ("scale", 0.9)), LFOS[name]
    return (("cascade", (("hp", 0.05),)), ("tap", 0),     # high_pass -> chorus
            ("mtap", 0.4, L, NH, EV, RS)), LFOS[name]


#: name -> (stages, the chorus LFO of an mtap list)
STAGE_LISTS = {"bench": (BENCH_STAGES, None), "taps": (TAP_STAGES, None),
               "comb": (COMB_STAGES, None),
               "mtap_config2": _mtap_stages("config2"),
               "mtap_config5": _mtap_stages("config5")}


@pytest.fixture(autouse=True)
def _torch_env():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    prev = tprec.get_policy()
    yield
    tprec.set_policy(prev)
    torch.set_num_threads(threads)


def _err(got, want) -> float:
    """max |got - want| / max |want| in float64."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _held(name, pairs, rtol=GRAD_RTOL) -> float:
    """Each (got, want) pair within rtol, max-normalized; prints and
    returns the worst."""
    worst = max(_err(g, w) for g, w in pairs)
    print(f"{name}: worst max-normalized gradient error {worst:.2e}")
    assert worst <= rtol, (name, worst)
    return worst


# -- the chain segment ------------------------------------------------------

def _segment_inputs(stages, lfo, B, T, seed, t0=256):
    """x [B, T] and the state entries (per-stream [B, n]; the mtap
    trajectory operands from the JAX package's mtap_shared)."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, T)) * 0.3).astype(np.float32)
    st = []
    for s in stages:
        if s[0] == "cascade":
            n = _embed_dim(composite_dim(s[1]))
            st.append((rng.standard_normal((B, n)) * 0.1).astype(np.float32))
        elif s[0] == "comb":
            st.append((rng.standard_normal((B, s[2])) * 0.1
                       ).astype(np.float32))
        elif s[0] == "mtap":
            st.append((rng.standard_normal((B, s[2])) * 0.3
                       ).astype(np.float32))
            with jprec.policy("parity"):
                st.extend(jax.tree.map(np.array, jax.jit(
                    lambda: jm.mtap_shared(*lfo, s[2], T, t0))()))
    return x, tuple(st)


def _shared(stages):
    return tcs._shared_slots(stages)


def _weights(flat, seed):
    """Seeded normal cotangents of the flat outputs' shapes."""
    rng = np.random.default_rng(seed)
    ws = [(rng.standard_normal(tuple(o.shape)) * 0.5).astype(np.float32)
          for o in flat]
    return ws


def _pick(stages, which):
    """Indices of the flat outputs that carry a cotangent."""
    n_c = sum(1 for st in stages if st[0] == "cascade")
    n_h = sum(1 for st in stages if st[0] in ("comb", "mtap"))
    n_t = sum(1 for st in stages if st[0] == "tap")
    n = 1 + 4 * n_c + n_h + n_t
    return {"all": list(range(n)), "y": [0],
            "states": list(range(1, 1 + 4 * n_c + n_h)),
            "taps": list(range(1 + 4 * n_c + n_h, n))}[which]


def _jax_segment_grads(stages, x, st, ws, idx):
    """jax.grad of sum <w_i, out_i> over the picked outputs of the JAX
    chain_segment, with respect to x and every state entry but the mtap
    trajectory operands."""
    shared = _shared(stages)
    diff = [i for i in range(len(st)) if i not in shared]

    def loss(xx, ds):
        full = list(st)
        for i, v in zip(diff, ds):
            full[i] = v
        flat = tcs.flatten_outputs(jcs.chain_segment(xx, stages,
                                                     tuple(full)))
        return sum(jnp.sum(flat[i] * ws[i]) for i in idx)

    with jprec.policy("fast"):
        gx, gs = jax.jit(jax.grad(loss, argnums=(0, 1)))(
            x, tuple(st[i] for i in diff))
    return np.asarray(gx), [np.asarray(g) for g in gs], diff


def _port_segment_grads(forward, stages, x, st, ws, idx, batch=None,
                        shared_grad=True):
    """The port's gradients through ``run_segment(forward, ...)``: x and
    every float state entry as leaves that require grad (the shared mtap
    frac too, unless ``shared_grad`` is False)."""
    shared = _shared(stages)
    xt = torch.tensor(x if batch is None else x.reshape(*batch, -1),
                      requires_grad=True)
    sts = tuple(torch.tensor(s, requires_grad=s.dtype == np.float32 and (
        shared_grad or i not in shared)) for i, s in enumerate(st))
    with tprec.policy("fast"):
        out = tcs.run_segment(forward, xt, stages, sts)
        flat = tcs.flatten_outputs(out)
        loss = sum((flat[i].reshape(ws[i].shape)
                    * torch.from_numpy(ws[i])).sum() for i in idx)
        loss.backward()
    return xt, sts, flat


def _plain_forward(calls):
    def forward(x, stages, state_in):
        calls.append(torch.is_grad_enabled())
        return tcs.segment_fallback(x, stages, state_in)
    return forward


@pytest.mark.parametrize("which", ["all", "y"])
@pytest.mark.parametrize("name", sorted(STAGE_LISTS))
def test_chain_segment_grad_matches_jax(name, which):
    """ChainSegment with segment_fallback standing in for the kernel:
    the gradients of x and every state entry (the mtap trajectory
    operands get none) against jax.grad of the JAX chain_segment, whose
    custom_vjp is the vjp of its segment_fallback."""
    stages, lfo = STAGE_LISTS[name]
    x, st = _segment_inputs(stages, lfo, 2, 1024, 3)
    with tprec.policy("fast"):
        flat0 = tcs.flatten_outputs(tcs.segment_fallback(
            torch.from_numpy(x), stages, tuple(map(torch.from_numpy, st))))
    ws = _weights(flat0, 4)
    idx = _pick(stages, which)
    gx, gs, diff = _jax_segment_grads(stages, x, st, ws, idx)
    calls = []
    xt, sts, _ = _port_segment_grads(_plain_forward(calls), stages, x, st,
                                     ws, idx)
    assert calls == [False]           # one forward, inside the Function
    pairs = [(xt.grad.numpy(), gx)]
    pairs += [(sts[i].grad.numpy(), g) for i, g in zip(diff, gs)
              if np.abs(g).max() > 0]
    for i in _shared(stages):
        assert sts[i].grad is None      # frac requires grad, gets none
    _held(f"chain segment {name}, cotangents on {which}", pairs)


@pytest.mark.parametrize("which", ["taps", "states"])
@pytest.mark.parametrize("name", ["taps", "mtap_config5"])
def test_chain_segment_grad_equals_plain_autograd(name, which):
    """The Function's gradients are bitwise autograd's straight through
    segment_fallback, whichever outputs carry a cotangent (the others get
    none): one flattening serves forward and backward."""
    stages, lfo = STAGE_LISTS[name]
    x, st = _segment_inputs(stages, lfo, 3, 512, 5)
    with tprec.policy("fast"):
        flat0 = tcs.flatten_outputs(tcs.segment_fallback(
            torch.from_numpy(x), stages, tuple(map(torch.from_numpy, st))))
    ws = _weights(flat0, 6)
    idx = _pick(stages, which)
    xa, sa, _ = _port_segment_grads(_plain_forward([]), stages, x, st, ws,
                                    idx, shared_grad=False)
    shared = _shared(stages)
    xb = torch.tensor(x, requires_grad=True)
    sb = tuple(torch.tensor(s, requires_grad=i not in shared
                            and s.dtype == np.float32)
               for i, s in enumerate(st))
    with tprec.policy("fast"):
        flat = tcs.flatten_outputs(tcs.segment_fallback(xb, stages, sb))
        sum((flat[i] * torch.from_numpy(ws[i])).sum() for i in idx
            ).backward()
    assert torch.equal(xa.grad, xb.grad)
    for a, b in zip(sa, sb):
        if b.grad is None:            # no path from the picked outputs
            assert a.grad is None or not a.grad.abs().max()
        else:
            assert torch.equal(a.grad, b.grad)


@pytest.mark.parametrize("name", ["bench", "mtap_config5"])
def test_chain_segment_kernel_path_grad(name, monkeypatch):
    """The kernel path itself under ChainSegment, the JAX Pallas chain
    kernel in interpret mode standing in for the CUDA kernel: leading
    dimensions flatten into rows and unbatched per-stream states broadcast
    (their gradients sum back over the rows); one kernel call forward,
    gradients against jax.grad of the JAX chain_segment."""
    stages, lfo = STAGE_LISTS[name]
    T = 512
    x, st = _segment_inputs(stages, lfo, 6, T, 7)
    shared = _shared(stages)
    st1 = tuple(s if i in shared else s[:1] for i, s in enumerate(st))
    launches = []

    def stand_in(xk, stg, sts):
        launches.append(tuple(xk.shape))
        with jprec.policy("fast"):
            out = jax.tree.map(np.array, jpc.chain_kernel_call(
                xk.numpy(), stg, tuple(s.numpy() for s in sts),
                interpret=True))
        return jax.tree.map(torch.from_numpy, out)

    monkeypatch.setattr(tck, "chain_kernel_call", stand_in)
    with tprec.policy("fast"):
        flat0 = tcs.flatten_outputs(tcs.segment_fallback(
            torch.from_numpy(x), stages, tuple(map(torch.from_numpy, st1))))
    ws = _weights(flat0, 8)
    idx = _pick(stages, "all")
    xt, sts, flat = _port_segment_grads(tcs._kernel_segment, stages, x, st1,
                                        ws, idx, batch=(2, 3))
    assert launches == [(6, T)]
    assert flat[0].shape == (2, 3, T)
    gx, gs, diff = _jax_segment_grads(
        stages, x, tuple(np.broadcast_to(s, (6, *s.shape[1:])).copy()
                         if i not in shared else s
                         for i, s in enumerate(st1)), ws, idx)
    pairs = [(xt.grad.numpy().reshape(6, T), gx)]
    pairs += [(sts[i].grad.numpy(), g.sum(0, keepdims=True))
              for i, g in zip(diff, gs)]
    _held(f"kernel path {name}", pairs)


# -- the cycle program ------------------------------------------------------

def _cycle_cases():
    g5 = dt.loads_graph(dj.dumps_graph(jpresets.config5_feedback_16node()[0]),
                        ids=TIdSpace())
    return {"config5": g5,
            "mega_cycle_2": gen._random_mega_cycle_graph(2)[0],
            "mega_cycle_10": gen._random_mega_cycle_graph(10)[0]}


def _program(name):
    g = _cycle_cases()[name]
    cg = dt.compile_graph(g, device="cpu")
    comp = next(c for c in cg._sccs if tcomp._is_cycle(g, c))
    with dt.policy("fast"):
        program, _, _, taps, _ = cg._cycle_program(comp, None)
    assert (program,) == tuple(cycle_programs_of(g))[:1]
    return program, len(taps)


def _program_inputs(program, B, T, seed):
    rng = np.random.default_rng(seed)
    _, _, n_r, _, n_e = tcyc._program_counts(program)
    exts = tuple((rng.standard_normal((B, T)) * 0.3).astype(np.float32)
                 for _ in range(n_e))
    regs = tuple((rng.standard_normal((B, 128)) * 0.1).astype(np.float32)
                 for _ in range(n_r))
    states = []
    for ins in program:
        if ins[0] == "cascade":
            n = _embed_dim(composite_dim(ins[1]))
            states.append((rng.standard_normal((B, n)) * 0.1
                           ).astype(np.float32))
        elif ins[0] == "comb":
            states.append((rng.standard_normal((B, ins[2])) * 0.1
                           ).astype(np.float32))
    return exts, regs, tuple(states)


@pytest.mark.parametrize("which", ["all", "taps"])
@pytest.mark.parametrize("name", ["config5", "mega_cycle_2",
                                  "mega_cycle_10"])
def test_cycle_segment_grad_matches_jax(name, which):
    """CycleSegment with the plain versions standing in for the kernels
    (interpret forward, interpret_adjoint backward): the
    gradients of every feed, register and state against jax.grad of the
    JAX cycle_segment (its custom_vjp: the vjp of its interpret), with
    cotangents on every output or on the taps alone."""
    program, n_taps = _program(name)
    exts, regs, states = _program_inputs(program, 2, 1024, 11)
    with tprec.policy("fast"):
        flat0 = tcyc.flatten_outputs(tcyc.interpret(
            tuple(map(torch.from_numpy, exts)),
            tuple(map(torch.from_numpy, regs)),
            tuple(map(torch.from_numpy, states)), program, n_taps))
    ws = _weights(flat0, 12)
    idx = (list(range(len(flat0))) if which == "all"
           else list(range(n_taps)))

    def loss(e, r, s):
        flat = tcyc.flatten_outputs(jcyc.cycle_segment(e, r, s, program,
                                                       n_taps))
        return sum(jnp.sum(flat[i] * ws[i]) for i in idx)

    with jprec.policy("fast"):
        want = jax.tree.map(np.asarray, jax.jit(jax.grad(
            loss, argnums=(0, 1, 2)))(exts, regs, states))
    calls = []

    def forward(e, r, s, prog, nt, **kw):
        calls.append(torch.is_grad_enabled())
        return tcyc.interpret(e, r, s, prog, nt, **kw)

    ins = [tuple(torch.tensor(a, requires_grad=True) for a in group)
           for group in (exts, regs, states)]
    with tprec.policy("fast"):
        out = tcyc.run_cycle(forward, tcyc.interpret_adjoint, *ins, program,
                             n_taps)
        flat = tcyc.flatten_outputs(out)
        sum((flat[i] * torch.from_numpy(ws[i])).sum() for i in idx
            ).backward()
    assert calls == [False]
    pairs = [(t.grad.numpy(), w) for group, wg in zip(ins, want)
             for t, w in zip(group, wg) if np.abs(w).max() > 0]
    assert pairs
    _held(f"cycle {name}, cotangents on {which}", pairs)


# -- through compile_graph ----------------------------------------------------

def _card_dispatch(monkeypatch):
    """Route the compiler's chain_segment and cycle_segment calls as the
    card routes them (through the Functions when autograd must see them),
    with the plain versions standing in for the kernels; returns the
    forward calls, each recorded with whether grad mode was on in it (off
    inside a Function)."""
    calls = {"chain": [], "cycle": []}

    def chain_fwd(x, stages, state_in):
        calls["chain"].append(torch.is_grad_enabled())
        return tcs.segment_fallback(x, stages, state_in)

    def cycle_fwd(e, r, s, program, n_taps, **kw):
        calls["cycle"].append(torch.is_grad_enabled())
        return tcyc.interpret(e, r, s, program, n_taps, **kw)

    monkeypatch.setattr(tcs, "chain_segment", lambda x, stages, st: (
        tcs.run_segment(chain_fwd, x, tuple(stages), tuple(st))))
    monkeypatch.setattr(tcomp, "cycle_segment", lambda e, r, s, p, n: (
        tcyc.run_cycle(cycle_fwd, tcyc.interpret_adjoint, tuple(e), tuple(r),
                       tuple(s), tuple(p), n)))
    return calls


def _bench_jax():
    g = dj.Graph(JIdSpace())
    inp = g.add("input")
    gn = g.add("gain", level=1.2)
    bq = g.add("biquad", a0=1.0, a1=-0.24, a2=0.0, b0=0.758, b1=0.0, b2=0.0)
    od = g.add("overdrive", boost=4.0, drive=0.6, level=0.9)
    lp = g.add("low_pass", ratio=0.6)
    hp = g.add("high_pass", ratio=0.2)
    ds = g.add("distort", mode="Tanh", level=3.0)
    ch = g.add("chebyshev", level_pos=2.0, level_neg=4.0)
    rv = g.add("reverb", seconds=0.003, decay=0.4)
    out = g.add("output")
    g.chain(inp, gn, bq, od, lp, hp, ds, ch, rv, out)
    return g, {"input": inp.id}


#: graph builder, T, the sliders of the subset ({cfg_name: [param]}, the
#: first node of that type), the fused calls a render makes, and whether
#: the subset feeds them (config2's gain is the tail of its run: the rest,
#: reverb and chorus, fuses without a gradient to carry)
GRAPH_CASES = {
    "bench": (_bench_jax, 2048, {"gain": ["level"]}, {"chain": 1}, True),
    "config2": (jpresets.config2_delay_chorus, 2048, {"gain": ["level"]},
                {"chain": 1}, False),
    "config5": (jpresets.config5_feedback_16node, 1024,
                {"gain": ["level"], "mix": ["ratio"]},
                {"chain": 1, "cycle": 1}, True),
}


def _graph_pair(name):
    build, T, subset, fused, feeds = GRAPH_CASES[name]
    gj, meta = build()
    gt = dt.loads_graph(dj.dumps_graph(gj), ids=TIdSpace())
    sub = {}
    for cfg, keys in subset.items():
        nid = min(n.id for n in gj.nodes.values() if n.cfg_name == cfg)
        sub[str(nid)] = keys
    return gj, gt, str(meta["input"]), T, sub, fused, feeds


@pytest.mark.parametrize("wrt", ["input", "subset"])
@pytest.mark.parametrize("name", sorted(GRAPH_CASES))
def test_graph_gradients_match_jax(name, wrt, monkeypatch):
    """Loss gradients through compile_graph under fast, with respect to the
    input signal or to a subset of the sliders (the rest stay concrete and
    fuse), against jax.grad of the JAX package's make_loss_fn.  The fused
    paths take the Functions where the gradient passes them: one forward
    of each, inside them, and the bench chain's and config2's runs still
    fuse around the fitted gain (the planner splits the run at it)."""
    gj, gt, inp, T, sub, fused, feeds = _graph_pair(name)
    rng = np.random.default_rng(21)
    x = (rng.standard_normal((2, T)) * 0.25).astype(np.float32)
    target = (rng.standard_normal((2, 1, T)) * 0.1).astype(np.float32)
    with jprec.policy("fast"):
        cgj = dj.compile_graph(gj)
        pj = cgj.init_params()
        pj = ({n: {k: pj[n][k] for k in keys} for n, keys in sub.items()}
              if wrt == "subset" else {})
        gp, gx = jax.jit(jax.grad(jfit.make_loss_fn(cgj), argnums=(0, 2)))(
            pj, cgj.init_state(), {inp: x}, target)
    calls = _card_dispatch(monkeypatch)
    cgt = dt.compile_graph(gt, device="cpu")
    pt = {n: {k: torch.tensor(float(np.asarray(v)), requires_grad=True)
              for k, v in e.items()} for n, e in pj.items()}
    xt = torch.tensor(x, requires_grad=wrt == "input")
    with tprec.policy("fast"):
        loss = tfit.make_loss_fn(cgt)(pt, cgt.init_state(), {inp: xt},
                                      torch.from_numpy(target))
        loss.backward()
    in_fn = wrt == "input" or feeds
    assert {k: v for k, v in calls.items() if v} == {
        k: [not in_fn] * n for k, n in fused.items()}, calls
    if wrt == "input":
        _held(f"{name}: input gradient", [(xt.grad.numpy(), gx[inp])])
    else:
        pairs = [(pt[n][k].grad.numpy(), gp[n][k]) for n in pt
                 for k in pt[n]]
        assert len(pairs) == sum(len(v) for v in sub.values())
        _held(f"{name}: gradients of {sub}", pairs)


@pytest.mark.parametrize("name", sorted(GRAPH_CASES))
def test_no_grad_render_bypasses_the_functions(name, monkeypatch):
    """A render that needs no gradient calls the fused paths' forwards
    directly (grad mode on, no Function), with the same outputs as one
    through the Functions."""
    gj, gt, inp, T, sub, fused, _ = _graph_pair(name)
    x = (np.random.default_rng(22).standard_normal((2, 1, T)) * 0.25
         ).astype(np.float32)
    calls = _card_dispatch(monkeypatch)
    cgt = dt.compile_graph(gt, device="cpu")
    with tprec.policy("fast"):
        y0, _, _ = cgt.render(x, batch_shape=(2,))
        assert {k: v for k, v in calls.items() if v} == {
            k: [True] * n for k, n in fused.items()}
        xt = torch.tensor(x, requires_grad=True)
        y1, _, _ = cgt.render(xt, batch_shape=(2,))
    assert y1.requires_grad
    assert torch.equal(y0, y1.detach())
