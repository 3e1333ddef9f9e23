"""The fan-ins outside the pointwise groups (compiler/compile.py
``_plan_fanins``, ``CompiledGraph._fanin_plan``, ``_CycleScan.fanins``)
and the knob writeback's one sample, on the CPU.

* The plan is pinned for config2 to config5, muff, the bench chain and
  five fuzz graphs under the three policies: which fan-ins each group
  writes (and for which ports), which sites take an Output member's
  average, which are one-form groups, and how many full-length fan-ins
  stay eager; config5's envelope takes the [mix] group's average (the
  mix's own output no longer written), its spectrogram the [output]
  group's; a fan-in of several sources outside one group, or a
  modulation port's, is one group call; the operand cap holds.
* Renders, ``StreamSession`` blocks and config5's per-node scan (the
  Python loop and the loop over buffers) are bitwise the eager route
  (``POINTWISE_FUSION = False``) and the route without the fan-ins
  (``FANIN_GROUPS = False``): output, aux and state, three policies.
* The presets and fuzz graphs against the JAX package's render at
  tests/test_torch_presets.py's and tests/test_torch_fuzz_graphs.py's
  bounds; a graph with a chorus under parity only, as that file holds
  them (the JAX package computes the chorus's fast trajectory otherwise,
  ROADMAP Queue 3 item 6).
* ``aux["__knobs__"]`` bitwise the full-length route (every source
  averaged over all T and mapped, then one sample), computed here, with a
  batched source, a source from a group and an LFO; against the JAX
  package's knobs.
* config5's input gradient (the groups' backward the reverse kernel's
  plain version, ``group_adjoint``) against the eager ops' autograd
  (PERF.md row 41's CPU bound) and ``jax.grad``; the per-node loop's
  slider gradients with the scan's fan-ins against the eager ops (row
  50's bounds) and ``jax.grad`` (rtol 1e-3).
"""

import jax
import numpy as np
import pytest
import torch

import chip_smoke
import dsp_stuff_tpu as dj
import dsp_stuff_tpu_torch as dt
import test_fuzz_graphs as jfuzz
import test_torch_cycle_groups as tcg
import test_torch_fuzz_gen as tfuzz
from dsp_stuff_tpu.compiler import compile as jcompile
from dsp_stuff_tpu.ids import IdSpace as JIdSpace
from dsp_stuff_tpu.models import presets as jp
from dsp_stuff_tpu.train import fit as jfit
from dsp_stuff_tpu.utils import precision as jprec
from dsp_stuff_tpu_torch import convert
from dsp_stuff_tpu_torch.compiler import compile as tcomp
from dsp_stuff_tpu_torch.ids import IdSpace
from dsp_stuff_tpu_torch.models import presets
from dsp_stuff_tpu_torch.ops import pointwise_kernel as pk
from dsp_stuff_tpu_torch.runtime.stream import StreamSession
from dsp_stuff_tpu_torch.train import fit as tfit
from dsp_stuff_tpu_torch.utils import precision as tprec
from test_torch_presets import VS_JAX_DB

B, T = 2, 2560
POLICIES = ("fast", "parity", "exact")
FUZZ_VS_JAX_DB = -100.0     # tests/test_torch_fuzz_graphs.py's VS_JAX_DB
ELEMENT_DB = -120.0         # a per-element gradient (PERF.md row 41, CPU)
SLIDER_RTOL = 1e-5          # a slider's gradient (PERF.md row 50)
SLIDER_ATOL = 1e-7          # ... one this near 0
INPUT_RTOL = 1e-5           # the input's gradient, max-normalized (row 50)
JAX_RTOL = 1e-3             # vs jax.grad, arrays max-normalized
FUZZ_SEEDS = (1, 8, 15, 24, 27)


@pytest.fixture(autouse=True)
def _torch_env():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    prev = tprec.get_policy()
    yield
    tprec.set_policy(prev)
    torch.set_num_threads(threads)


def _knob_graph(pkg, ids):
    """input -> gain -> chorus -> Fuzz distort -> output: the chorus's mix
    read from the gain (a group) and its rate from an LFO, the Fuzz's
    level from the input (batched) and the gain together."""
    g = pkg.Graph(ids())
    inp = g.add("input")
    pre = g.add("gain", level=1.5)
    lfo = g.add("signal_gen", mode="Sine", frequency=3.0, amplitude=0.7)
    ch = g.add("chorus", rate=1.2, depth=0.003, base=0.008, mix=0.4)
    fz = g.add("distort", mode="Fuzz", level=2.0)
    out = g.add("output")
    g.connect(inp, "out", pre, "in")
    g.connect(pre, "out", ch, "in")
    g.connect(pre, "out", ch, "mix")
    g.connect(lfo, "out", ch, "rate")
    g.connect(ch, "out", fz, "in")
    g.connect(inp, "out", fz, "level")
    g.connect(pre, "out", fz, "level")
    g.connect(fz, "out", out, "in")
    return g


def _graphs():
    out = {name: presets.PRESETS[name]()[0]
           for name in ("config2", "config3", "config4", "config5")}
    out["muff"] = chip_smoke.muff_graph()
    out["bench"] = chip_smoke.bench_graph()
    out["knobs"] = _knob_graph(dt, IdSpace)
    for s in FUZZ_SEEDS:
        out[f"_random_graph({s})"] = tfuzz._random_graph(s)[0]
    return out


def _fanin_plan(cg, pol, pdict=None):
    with dt.policy(pol):
        mh, _ = cg._active_mega(pdict)
        fh, _ = cg._active_fusion(pdict)
        return cg._fanin_plan(mh, fh)


def _census(g, pol, fanins=True, T_=256):
    """(full-length eager fan-in averages, group calls) of one render at
    [1, T_] under ``pol``, with or without the groups' fan-ins."""
    calls = []
    real = tcomp._avg

    def spy(srcs, Tn, device=None):
        calls.append(Tn)
        return real(srcs, Tn, device)
    counts = {}
    was = tcomp.FANIN_GROUPS
    tcomp.FANIN_GROUPS = fanins
    tcomp._avg = spy
    try:
        cg = dt.compile_graph(g, device="cpu")
        n = len(cg.input_ids)
        with dt.policy(pol), chip_smoke.calls_counted(
                [(tcomp, "group_call")], counts):
            cg.render(torch.zeros((1, n, T_)) if n else None, T=T_,
                      batch_shape=(1,))
    finally:
        tcomp._avg = real
        tcomp.FANIN_GROUPS = was
    return sum(1 for t in calls if t == T_), counts.get("group_call", 0)


# -- the plan ------------------------------------------------------------------

_A = "avg"
_C5 = ({(11,): (((_A, ((11, "out"),)), ((12, "in"),)),)},
       {(12, "in"): (_A, ((11, "out"),)), (14, "in"): (_A, ((13, "out"),))},
       set())
_BENCH = ({(1,): (((_A, ((1, "out"),)), ((2, "in"),)),),
           (3,): (((_A, ((3, "out"),)), ((4, "in"),)),),
           (6, 7): (((_A, ((7, "out"),)), ((8, "in"),)),)},
          {(2, "in"): (_A, ((1, "out"),)), (4, "in"): (_A, ((3, "out"),)),
           (8, "in"): (_A, ((7, "out"),))}, set())
_NONE = ({}, {}, set())
_RG1_SOLO = (_A, ((0, "out"), (4, "out")))
_RG8_SOLO = {(_A, ((0, "out"), (1, "out"))), (_A, ((0, "out"), (3, "out")))}
_RG24_SOLO = (_A, ((3, "out"), (3, "out"), (1, "out")))
_RG27_SOLO = {(_A, ((0, "out"), (2, "b"), (2, "b"))),
              ("mod", (((5, "out"),), 0.0, 1.0))}
_KNOB_MOD = ("mod", (((1, "out"),), 0.0, 1.0))
_KNOB_RATE = ("mod", (((2, "out"),), 0.05, 10.0))
#: (graph, policy) -> ((group members -> its fan-in outputs and their
#: ports, site -> key, one-form keys), the full-length fan-ins left eager
#: with and without the groups' fan-ins)
PLANS = {
    # mix -> envelope: the [mix] group writes the average in place of its
    # output; the spectrogram takes the [output] group's average of the
    # biquad; the biquad's fan-in (the envelope kernel's) stays a divide;
    # under parity and exact the high pass and the chorus too (a cycle's
    # output and a node's)
    **{("config5", p): (_C5, (1, 3) if p == "fast" else (3, 5))
       for p in POLICIES},
    # config2 under fast: a mega run and no eager fan-in; parity: its
    # gain + Output group reads the delay (a node), two single-source
    # divides stay eager
    ("config2", "fast"): (_NONE, (0, 0)),
    **{("config2", p): (_NONE, (2, 2)) for p in ("parity", "exact")},
    **{("config3", p): (_NONE, (2, 2)) for p in POLICIES},
    # config4: two consumers of the input, one divide
    **{("config4", p): (_NONE, (1, 2)) for p in POLICIES},
    **{("muff", p): (_NONE, (1, 1)) for p in POLICIES},
    # the bench chain under parity: each gain or shaper group averages
    # for the filter after it; under fast one mega run
    ("bench", "fast"): (_NONE, (0, 0)),
    **{("bench", p): (_BENCH, (1, 4)) for p in ("parity", "exact")},
    # the LFO into the chorus's rate: a one-form group; the gain's
    # average and mapped average for the chorus: outputs of its group; the
    # input and the gain into the Fuzz's level: the Fuzz's own group (Fuzz
    # and the Output) averages and maps them inside
    **{("knobs", p): (({(1,): (((_A, ((1, "out"),)), ((3, "in"),)),
                                (_KNOB_MOD, ((3, "mix"),)))},
                        {(3, "in"): (_A, ((1, "out"),)),
                         (3, "mix"): _KNOB_MOD,
                         (3, "rate"): _KNOB_RATE},
                        {_KNOB_RATE}), (0, 3)) for p in POLICIES},
    # two sources (the input and a shaper) into a node outside the groups
    ("_random_graph(1)", "fast"): (({}, {(1, "in"): _RG1_SOLO},
                                    {_RG1_SOLO}), (2, 3)),
    **{("_random_graph(1)", p): (
        ({(2,): (((_A, ((2, "out"),)), ((5, "in"),)),)},
         {(1, "in"): _RG1_SOLO, (5, "in"): (_A, ((2, "out"),))},
         {_RG1_SOLO}), (1, 3)) for p in ("parity", "exact")},
    **{("_random_graph(8)", p): (
        ({(1,): (((_A, ((1, "out"),)), ((4, "in"),)),)},
         {(5, "in"): (_A, ((0, "out"), (1, "out"))),
          (4, "in"): (_A, ((1, "out"),)),
          (6, "in"): (_A, ((0, "out"), (3, "out")))}, _RG8_SOLO), (0, 3))
       for p in POLICIES},
    # two members of one group (two chebyshevs and the Output) into a
    # node outside it
    **{("_random_graph(15)", p): (
        ({(2, 7, 8): (((_A, ((2, "out"), (7, "out"))), ((6, "in"),)),)},
         {(6, "in"): (_A, ((2, "out"), (7, "out")))}, set()), (2, 4))
       for p in POLICIES},
    # one source twice and another: one group call
    **{("_random_graph(24)", p): (({}, {(4, "in"): _RG24_SOLO},
                                   {_RG24_SOLO}), (1, 2)) for p in POLICIES},
    # three sources into a chorus, and its mix modulated by one node
    **{("_random_graph(27)", p): (
        ({}, {(1, "in"): (_A, ((0, "out"), (2, "b"), (2, "b"))),
              (1, "mix"): ("mod", (((5, "out"),), 0.0, 1.0))}, _RG27_SOLO),
        (2, 4)) for p in POLICIES},
}


@pytest.mark.parametrize("name, pol", sorted(PLANS))
def test_fanin_plan_is_pinned(name, pol):
    g = _graphs()[name]
    cg = dt.compile_graph(g, device="cpu")
    plan = _fanin_plan(cg, pol)
    (writes, taken, solo), (eager, eager_off) = PLANS[(name, pol)]
    assert {m: w for m, w in plan.writes.items() if w} == writes
    assert plan.taken == taken
    assert set(plan.solo) == solo
    with_fanins = _census(g, pol)
    without = _census(g, pol, fanins=False)
    assert with_fanins[0] == eager and without[0] == eager_off
    # a one-form group is one more group call; the groups' fan-in
    # outputs are none
    assert with_fanins[1] == without[1] + len(solo)


def test_config5_envelope_and_spectrogram_take_group_averages():
    """config5: the [mix] group writes the envelope's input average and
    not the mix's output; the spectrogram's input is the [output] group's
    average, the very tensor of the rendered channel; the knob of the
    overdrive's drive is the LFO's one sample."""
    g, meta = presets.config5_feedback_16node()
    cg = dt.compile_graph(g, device="cpu")
    plan = _fanin_plan(cg, "fast")
    _, _, _, written = cg._lower_group((11,), None, plan.writes[(11,)])
    assert written == [("avg", ((11, "out"),))]
    seen = {}
    real = cg._group_eval

    def spy(members, values, outs, pdict, Tn, fanins=(), fan=None):
        real(members, values, outs, pdict, Tn, fanins, fan)
        seen[members] = (dict(values), dict(outs), dict(fan or {}))
    spec = cg._nodes[meta["spectrogram"]].spec.impl
    analyze = spec.analyze
    read = {}

    def spy_analyze(params, inputs):
        read.update(inputs)
        return analyze(params, inputs)
    cg._group_eval = spy
    spec.analyze = spy_analyze
    try:
        with dt.policy("fast"):
            cg.render(torch.from_numpy(_x(2, 256)), batch_shape=(B,))
    finally:
        spec.analyze = analyze
    values, _, fan = seen[(11,)]
    assert (11, "out") not in values and set(fan) == {("avg", ((11, "out"),))}
    assert read["in"] is seen[(15,)][1][15]


def test_one_form_group_program():
    """rg24's fan-in of three sources (one twice) is one program: two
    signal operands, one divisor, one output; rg27's modulation port
    read from one node is its average mapped."""
    g = tfuzz._random_graph(24)[0]
    cg = dt.compile_graph(g, device="cpu")
    key = _RG24_SOLO
    prog, sigs, scals, written = cg._lower((), None, fanins=((key, ()),))
    assert sigs == [(3, "out"), (1, "out")]
    assert [type(d).__name__ for d in scals] == ["_Divisor"]
    assert scals[0].n == 3 and written == [key] and len(prog.outs) == 1
    assert [op for op, *_ in prog.ops].count("add") == 2
    mod = ("mod", (((5, "out"),), 0.0, 1.0))
    cg27 = dt.compile_graph(tfuzz._random_graph(27)[0], device="cpu")
    prog, sigs, scals, written = cg27._lower((), None, fanins=((mod, ()),))
    assert sigs == [(5, "out")] and written == [mod]
    assert [op for op, *_ in prog.ops].count("clamp") == 1


def test_fanins_respect_the_operand_cap(monkeypatch):
    """With GROUP_OPERANDS at the [mix] group's own cost, the group takes
    no fan-in: the envelope's average stays a divide, and the render is
    the same bit for bit."""
    g = presets.config5_feedback_16node()[0]
    cg = dt.compile_graph(g, device="cpu")
    cost = tcomp._group_cost(g, cg._nodes, (11,))
    assert tcomp._group_cost(g, cg._nodes, (11,), ("k",)) == cost + 2
    x = torch.from_numpy(_x(7, 1280))
    with dt.policy("parity"):
        want = cg.render(x, batch_shape=(B,))
    monkeypatch.setattr(tcomp, "GROUP_OPERANDS", cost + 1)
    cg = dt.compile_graph(g, device="cpu")
    plan = _fanin_plan(cg, "parity")
    assert not plan.writes[(11,)] and (12, "in") not in plan.taken
    with dt.policy("parity"):
        got = cg.render(x, batch_shape=(B,))
    _bitwise(got, want)


# -- bitwise the eager route ---------------------------------------------------

def _x(seed, length=T, n=1):
    return (np.random.default_rng(seed).standard_normal((B, n, length))
            * 0.3).astype(np.float32)


def _routes(g, pol, x, params=None, scan_route=None):
    """{route: (output, aux, state)} of one render through the groups with
    their fan-ins ("fanins"), without them ("groups") and the eager ops
    ("eager")."""
    out = {}
    for route, fusion, fanins in (("fanins", True, True),
                                  ("groups", True, False),
                                  ("eager", False, True)):
        was = tcomp.POINTWISE_FUSION, tcomp.FANIN_GROUPS
        tcomp.POINTWISE_FUSION, tcomp.FANIN_GROUPS = fusion, fanins
        try:
            cg = dt.compile_graph(g, device="cpu")
            if scan_route:
                cg.cycle_loops.route = scan_route
            n = len(cg.input_ids)
            with dt.policy(pol):
                out[route] = cg.render(
                    torch.from_numpy(x[:, :n]) if n else None,
                    T=x.shape[-1], batch_shape=(B,), params=params)
        finally:
            tcomp.POINTWISE_FUSION, tcomp.FANIN_GROUPS = was
    return out


def _bitwise(got, want):
    a, b = chip_smoke.route_leaves(got), chip_smoke.route_leaves(want)
    assert len(a) == len(b)
    for u, v in zip(a, b):
        assert u.shape == v.shape and torch.equal(u, v)


RENDERED = ["config2", "config3", "config5", "muff", "bench", "knobs",
            *(f"_random_graph({s})" for s in FUZZ_SEEDS)]


@pytest.mark.parametrize("pol", POLICIES)
@pytest.mark.parametrize("name", RENDERED)
def test_render_is_the_eager_route(name, pol):
    g = _graphs()[name]
    res = _routes(g, pol, _x(RENDERED.index(name), 1280))
    _bitwise(res["fanins"], res["eager"])
    _bitwise(res["fanins"], res["groups"])


STREAMED = ["config5", "knobs", "_random_graph(8)", "_random_graph(27)"]


@pytest.mark.parametrize("pol", POLICIES)
@pytest.mark.parametrize("name", STREAMED)
def test_stream_blocks_are_the_eager_route(name, pol):
    """Four StreamSession blocks (the block step over fixed buffers):
    outputs and final state bitwise on the three routes."""
    g = _graphs()[name]
    res = {}
    for route, fusion, fanins in (("fanins", True, True),
                                  ("groups", True, False),
                                  ("eager", False, True)):
        was = tcomp.POINTWISE_FUSION, tcomp.FANIN_GROUPS
        tcomp.POINTWISE_FUSION, tcomp.FANIN_GROUPS = fusion, fanins
        try:
            with dt.policy(pol):
                sess = StreamSession(g, device="cpu")
                n = len(sess.cg.input_ids)
                x = _x(11, 512, n)[0]
                ys = [sess.process(x[:, i * 128:(i + 1) * 128])
                      for i in range(4)]
                res[route] = (np.stack(ys), sess.state)
        finally:
            tcomp.POINTWISE_FUSION, tcomp.FANIN_GROUPS = was
    for route in ("groups", "eager"):
        np.testing.assert_array_equal(res["fanins"][0], res[route][0])
        _bitwise((res["fanins"][1],), (res[route][1],))


@pytest.mark.parametrize("scan_route", ["eager", "buffers"])
@pytest.mark.parametrize("route", tcg.ROUTES)
def test_config5_scan_fanins_are_the_eager_route(route, scan_route):
    """config5's per-node scan: the reverb reads the [add] group's
    average, the low pass (a node's output) keeps its divide; a block
    makes one eager fan-in, not two; output, aux and state bitwise the
    eager route and the route without the fan-ins, on the Python loop and
    the loop over buffers."""
    g = presets.config5_feedback_16node()[0]
    cg = dt.compile_graph(g, device="cpu")
    pol, params = tcg._route(cg, route)
    scan = tcg._scan(cg, pol, params)
    assert scan.fanins == {(6, "in"): ("avg", ((5, "out"),))}
    assert scan.group_fanins == {(5,): ((("avg", ((5, "out"),)),
                                         ((6, "in"),)),)}
    with dt.policy(pol):
        _, _, _, written = cg._lower((5,), None, every=True,
                                     fanins=scan.group_fanins[(5,)])
    assert written == [("value", (5, "out")), ("avg", ((5, "out"),))]
    res = _routes(g, pol, _x(5, T), params, scan_route)
    _bitwise(res["fanins"], res["eager"])
    _bitwise(res["fanins"], res["groups"])
    blocks = {}
    for fanins in (True, False):
        calls = []
        real = tcomp._avg
        was = tcomp.FANIN_GROUPS
        tcomp._avg = lambda s, n, d=None: calls.append(n) or real(s, n, d)
        tcomp.FANIN_GROUPS = fanins
        try:
            cg1 = dt.compile_graph(g, device="cpu")
            cg1.cycle_loops.route = "eager"
            with dt.policy(pol):
                cg1.render(torch.zeros((1, 1, 256)), batch_shape=(1,),
                           params=params)
        finally:
            tcomp._avg, tcomp.FANIN_GROUPS = real, was
        blocks[fanins] = calls.count(128) / 2
    assert blocks == {True: 1, False: 2}


# -- against the JAX package ---------------------------------------------------

def _dbfs(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    return 20 * np.log10(max(err, 1e-30) / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("pol", ["fast", "parity"])
@pytest.mark.parametrize("name", ["config2", "config3", "config5"])
def test_preset_matches_jax(name, pol):
    x = _x(20, 2048)
    with dt.policy(pol):
        y = dt.compile_graph(presets.PRESETS[name]()[0], device="cpu"
                             ).render(x, batch_shape=(B,))[0]
    with dj.policy(pol):
        want = dj.compile_graph(jp.PRESETS[name]()[0]).render(
            x, batch_shape=(B,))[0]
    assert _dbfs(y.numpy(), np.asarray(want)) <= VS_JAX_DB[(name, pol)]


def _has_chorus(g) -> bool:
    return any(n.cfg_name == "chorus" for n in g.nodes.values())


@pytest.mark.parametrize("seed", FUZZ_SEEDS)
def test_fuzz_matches_jax(seed):
    g, inp, _ = tfuzz._random_graph(seed)
    gj, _, _ = jfuzz._random_graph(seed)
    x = (np.random.default_rng(2000 + seed).standard_normal(1536) * 0.25
         ).astype(np.float32)
    for pol in ("parity",) if _has_chorus(g) else ("fast", "parity"):
        with dt.policy(pol):
            got, _, _ = dt.render(g, {str(inp): x}, device="cpu")
        with dj.policy(pol):
            want, _, _ = dj.render(gj, {str(inp): x})
        assert _dbfs(got.numpy(), np.asarray(want)) <= FUZZ_VS_JAX_DB


# -- the knob writeback --------------------------------------------------------

def _full_length_knobs(g, x, pol, block):
    """The knobs as the full-length route computes them, the graph
    compiled at ``block``: every node's output recorded (NODE_HOOK: node
    by node, a cycle member's block by block), each modulation port's
    sources averaged over all T in link order, mapped, then the last
    block's first sample, broadcast over the streams."""
    seen: dict = {}
    tcomp.NODE_HOOK = lambda nid, cfg, outs: [
        seen.setdefault((nid, k), []).append(v) for k, v in outs.items()]
    try:
        cg = dt.compile_graph(g, block_size=block, device="cpu")
        with dt.policy(pol):
            cg.render(torch.from_numpy(x), batch_shape=(B,))
    finally:
        tcomp.NODE_HOOK = None
    Tn = x.shape[-1]
    knobs = {}
    for nid, node in cg._nodes.items():
        for p in tcomp._mod_params(node):
            ls = g.in_links(nid, p.name)
            if ls:
                srcs = [torch.cat(torch.broadcast_tensors(
                    *seen[(l.src, l.src_port)]), dim=-1) for l in ls]
                sig, _ = tcomp._avg(srcs, Tn)
                knobs[f"{nid}:{p.name}"] = tcomp._map_mod(
                    sig, p)[..., Tn - block].expand(B)
    return knobs


@pytest.mark.parametrize("pol", POLICIES)
@pytest.mark.parametrize("name", ["knobs", "config5", "_random_graph(27)"])
def test_knobs_are_the_full_length_route(name, pol):
    """The knobs, on every route and at a 256-sample block too, bitwise
    the full-length average's sample."""
    g = _graphs()[name]
    x = _x(9, 1280)
    want = _full_length_knobs(g, x, pol, 128)
    assert want
    for route, res in _routes(g, pol, x).items():
        got = res[1]["__knobs__"]
        assert got.keys() == want.keys(), route
        for k, w in want.items():
            assert got[k].shape == w.shape and torch.equal(got[k], w), \
                (route, k)
    cg = dt.compile_graph(g, block_size=256, device="cpu")
    with dt.policy(pol):
        got = cg.render(torch.from_numpy(x), batch_shape=(B,))[1]
    want = _full_length_knobs(g, x, pol, 256)
    for k, w in want.items():
        assert torch.equal(got["__knobs__"][k], w), k


@pytest.mark.parametrize("pol", ["fast", "parity", "exact"])
def test_knobs_match_jax(pol):
    """The knob graph's knobs and output against the JAX package's
    render: the knobs bitwise under exact, else rtol 1e-6; the output
    (a chorus's) at FUZZ_VS_JAX_DB under parity and exact."""
    x = _x(12, 1280)
    with dt.policy(pol):
        y, aux, _ = dt.compile_graph(_knob_graph(dt, IdSpace), device="cpu"
                                     ).render(x, batch_shape=(B,))
    with dj.policy(pol):
        yj, auxj, _ = dj.compile_graph(_knob_graph(dj, JIdSpace)).render(
            x, batch_shape=(B,))
    kj = auxj["__knobs__"]
    assert sorted(aux["__knobs__"]) == sorted(kj)
    for k, v in aux["__knobs__"].items():
        w = np.asarray(kj[k])
        if pol == "exact":
            np.testing.assert_array_equal(v.numpy(), w)
        else:
            np.testing.assert_allclose(v.numpy(), w, rtol=1e-6, atol=1e-7)
    if pol != "fast":
        assert _dbfs(y.numpy(), np.asarray(yj)) <= FUZZ_VS_JAX_DB


# -- gradients -----------------------------------------------------------------

def _function_route(m, calls):
    """Every group through PointwiseGroup, the plain version forward and
    ``group_adjoint`` (the reverse kernel's plain version) backward."""
    def bwd(*a):
        calls["backward"] += 1
        return pk.group_adjoint(*a)
    m.setattr(tcomp, "group_call", lambda prog, sigs, scals, Tn, d: pk.run(
        tcomp.pointwise.interpret, prog, sigs, scals, Tn, d, bwd))
    m.setattr(pk, "group_vjp", None)


def _input_grad(g, inp, x, tgt, route, monkeypatch):
    calls = {"backward": 0}
    with monkeypatch.context() as m:
        if route == "eager":
            m.setattr(tcomp, "POINTWISE_FUSION", False)
        else:
            _function_route(m, calls)
            m.setattr(tcomp, "FANIN_GROUPS", route == "fanins")
        cg = dt.compile_graph(g, device="cpu")
        xt = torch.from_numpy(x).requires_grad_()
        with dt.policy("fast"):
            loss = tfit.make_loss_fn(cg)({}, cg.init_state(), {str(inp): xt},
                                         torch.from_numpy(tgt))
            loss.backward()
    return loss.detach(), xt.grad, calls["backward"]


def test_config5_input_gradient(monkeypatch):
    """config5's input gradient under fast with the groups' fan-ins (the
    [mix] group's backward takes the divide's vjp) against the eager ops'
    autograd (per element ELEMENT_DB), the route without the fan-ins, and
    jax.grad (JAX_RTOL)."""
    g, meta = presets.config5_feedback_16node()
    inp = meta["input"]
    rng = np.random.default_rng(31)
    x = (rng.standard_normal((B, 2048)) * 0.25).astype(np.float32)
    tgt = (rng.standard_normal((B, 1, 2048)) * 0.1).astype(np.float32)
    got = _input_grad(g, inp, x, tgt, "fanins", monkeypatch)
    groups = _input_grad(g, inp, x, tgt, "groups", monkeypatch)
    eager = _input_grad(g, inp, x, tgt, "eager", monkeypatch)
    assert got[2] == groups[2] == 3
    assert torch.equal(got[0], eager[0])
    assert tcg._element_db(got[1], eager[1]) <= ELEMENT_DB
    assert tcg._element_db(got[1], groups[1]) <= ELEMENT_DB
    with jprec.policy("fast"):
        cgj = dj.compile_graph(jp.config5_feedback_16node()[0])
        gx = jax.jit(jax.grad(jfit.make_loss_fn(cgj), argnums=2))(
            {}, cgj.init_state(), {str(inp): x}, tgt)[str(inp)]
    gx = np.asarray(gx)
    assert np.abs(got[1].numpy() - gx).max() / np.abs(gx).max() <= JAX_RTOL


@pytest.mark.parametrize("scan_route", ["eager", "buffers"])
@pytest.mark.parametrize("pol", ["parity", "exact"])
def test_loop_slider_gradients_vs_eager(pol, scan_route, monkeypatch):
    """The per-node loop's gradients, every slider a leaf, with the
    reverb's fan-in an output of the [add] group: against the eager ops'
    autograd at PERF.md row 50's bounds (the loss bitwise)."""
    g, inp = tcg._graph("config5")
    x, tgt = tcg._inputs(4)
    got = tcg._grads(g, inp, pol, scan_route, x, tgt, True, monkeypatch)
    want = tcg._grads(g, inp, pol, scan_route, x, tgt, False, monkeypatch)
    assert got[3]["backward"] > 0
    assert torch.equal(got[0], want[0])
    gx, wx = got[2], want[2]
    assert float((gx - wx).abs().max()) <= INPUT_RTOL * float(wx.abs().max())
    assert got[1].keys() == want[1].keys()
    for k, w in want[1].items():
        v = got[1][k]
        assert (v is None) == (w is None), k
        if w is not None:
            assert abs(float(v) - float(w)) <= max(
                SLIDER_RTOL * abs(float(w)), SLIDER_ATOL), (k, v, w)


@pytest.mark.parametrize("pol", ["fast", "parity"])
def test_loop_slider_gradients_vs_jax(pol, monkeypatch):
    """CYCLE_FUSION off in both packages: every slider's and the input's
    gradient through the loop over buffers, with the scan's fan-ins,
    against jax.grad through the JAX package's per-node lax.scan."""
    monkeypatch.setattr(jcompile, "CYCLE_FUSION", False)
    monkeypatch.setattr(tcomp, "CYCLE_FUSION", False)
    g, inp = tcg._graph("config5")
    x, tgt = tcg._inputs(6, 1024)
    with jprec.policy(pol):
        cgj = dj.compile_graph(jp.config5_feedback_16node()[0])
        pj = cgj.init_params()
        _, (gpj, gxj) = jax.jit(jax.value_and_grad(
            jfit.make_loss_fn(cgj), argnums=(0, 2)))(
            pj, cgj.init_state(), {str(inp): x}, tgt)
    calls = {"backward": 0}
    _function_route(monkeypatch, calls)
    cg = dt.compile_graph(g, device="cpu")
    with dt.policy(pol):
        assert tcg._scan(cg, pol, cg.init_params()).fanins
        cg.cycle_loops.route = "buffers"
        params = convert.params_from_jax(jax.tree.map(np.asarray, pj), "cpu",
                                         requires_grad=True)
        xt = torch.from_numpy(x).requires_grad_()
        loss = tfit.make_loss_fn(cg)(params, cg.init_state(),
                                     {str(inp): xt}, torch.from_numpy(tgt))
        loss.backward()
    assert calls["backward"] > 0
    for n in sorted(params):
        for k, v in params[n].items():
            got = 0.0 if v.grad is None else float(v.grad)
            w = float(gpj[n][k])
            assert abs(got - w) <= max(JAX_RTOL * abs(w), 1e-9), (n, k, got,
                                                                  w)
    gx = np.asarray(gxj[str(inp)])
    assert np.abs(xt.grad.numpy() - gx).max() / np.abs(gx).max() <= JAX_RTOL
