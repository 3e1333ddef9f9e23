"""The pointwise groups inside the per-node feedback-cycle scan
(compiler/compile.py ``_plan_cycle_groups``, ``_CycleScan.step``) on the
CPU, where a group runs its plain version (``pointwise.interpret``) and,
routed as the card routes it, its backward the reverse kernel's plain
version (``pointwise_kernel.group_adjoint``).

* The plan: groups stand next to each other in the block's order (a fused
  run's interior left out), each member after the first reading an
  earlier one, so no edge changes between the current and the previous
  block; in-cycle fused runs' members are left out; none under
  ``NODE_HOOK`` or with ``POINTWISE_FUSION`` off.  The groups of config5,
  ``chip_smoke.loop_graph`` and two mega-cycle seeds are pinned under
  parity, exact and fast with the feedback gain overridden; a group is
  lowered once a scan, not once a block.
* The scan with groups is bitwise the eager route (``POINTWISE_FUSION =
  False``) on output, aux and final state, on the Python loop and on the
  loop over buffers, for config5, the loop graph and the smoke's four
  mega-cycle seeds under the three routes.
* With ``CYCLE_FUSION`` off in both packages, the loop graph and the
  mega-cycle seeds against the JAX package's per-node ``lax.scan`` at
  VS_JAX_DB (tests/test_torch_fuzz_graphs.py, -100 dBFS; config5 is
  tests/test_torch_cycle_loop.py's ``test_config5_per_node_scan_vs_jax``,
  which runs the groups too).
* The backward with the groups through PointwiseGroup and ``group_adjoint``
  against the eager ops' autograd on the same route: per element
  ELEMENT_DB (-120 dBFS max-normalized), a slider's sum SUM_RTOL (1e-6),
  PERF.md row 41's CPU bounds; and against ``jax.grad`` (JAX_RTOL, 1e-3).
* The stream step of config5 under parity and with its feedback gain
  moved (a stream slider, ``sliders.Data``) runs the cycle's groups and
  dispatches no host-data tensor and no host read.
"""

import jax
import numpy as np
import pytest
import torch

import chip_smoke
import dsp_stuff_tpu as dj
import dsp_stuff_tpu_torch as dt
import test_fuzz_graphs as jfuzz
import test_torch_fuzz_gen as tfuzz
from dsp_stuff_tpu.compiler import compile as jcompile
from dsp_stuff_tpu.ids import IdSpace as JIdSpace
from dsp_stuff_tpu.models import presets as jp
from dsp_stuff_tpu.train import fit as jfit
from dsp_stuff_tpu.utils import precision as jprec
from dsp_stuff_tpu_torch import convert
from dsp_stuff_tpu_torch.compiler import compile as tcomp
from dsp_stuff_tpu_torch.compiler import pointwise as pw
from dsp_stuff_tpu_torch.models import presets
from dsp_stuff_tpu_torch.ops import pointwise_kernel as pk
from dsp_stuff_tpu_torch.runtime.stream import StreamSession
from dsp_stuff_tpu_torch.train import fit as tfit
from dsp_stuff_tpu_torch.utils import precision as tprec
from dsp_stuff_tpu_torch.utils.sliders import Data, Scope
from test_torch_fuzz_graphs import VS_JAX_DB
from test_torch_stream_graph import _HostOps

B, NB = 2, 21              # 21 blocks: a head of 2, then 19 in the loop
T = NB * 128
ELEMENT_DB = -120.0        # a per-element gradient, max-normalized (CPU)
SUM_RTOL = 1e-6            # a slider's gradient, a sum (CPU)
SUM_ATOL = 1e-9            # ... one this near 0
JAX_RTOL = 1e-3            # vs jax.grad (PERF.md section 2)
STATE_ATOL = 2e-5          # states vs the JAX package's per-node scan
MEGA_SEEDS = chip_smoke.FUZZ_MEGA_SEEDS
GRAPHS = ["config5", "loop"] + [f"mega {s}" for s in MEGA_SEEDS]
ROUTES = ("parity", "exact", "fast-override")


@pytest.fixture(autouse=True)
def _torch_env():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    prev = tprec.get_policy()
    yield
    tprec.set_policy(prev)
    torch.set_num_threads(threads)


def _graph(name):
    """(graph, input id) of a case of GRAPHS."""
    if name == "config5":
        g, meta = presets.config5_feedback_16node()
        return g, meta["input"]
    if name == "loop":
        g = chip_smoke.loop_graph()
        return g, min(i for i, n in g.nodes.items() if n.cfg_name == "input")
    g, inp, _ = tfuzz._random_mega_cycle_graph(int(name.split()[1]))
    return g, inp


def _scc(cg):
    return next(c for c in cg._sccs if len(c) > 1)


def _feedback_gain(cg) -> str:
    """The loop's feedback gain (the SCC's last gain) as a params key."""
    return str(max(n for n in _scc(cg) if cg._nodes[n].cfg_name == "gain"))


def _route(cg, route, value=0.4):
    """(policy, params) of a route of ROUTES: fast overrides the feedback
    gain, which takes the SCC off the fused block program."""
    if route == "fast-override":
        return "fast", {_feedback_gain(cg): {"level": value}}
    return route, None


def _x(seed, length=T):
    return torch.from_numpy(
        (np.random.default_rng(seed).standard_normal((B, 1, length))
         * 0.3).astype(np.float32))


def _scan(cg, pol, params=None):
    """The per-node scan of ``cg``'s feedback SCC as a render under
    ``pol`` and ``params`` plans it."""
    with dt.policy(pol):
        heads, interior = cg._active_fusion(params)
        return tcomp._CycleScan(cg, _scc(cg), heads, interior)


def _types(cg, groups):
    return tuple(tuple(cg._nodes[n].cfg_name for n in g) for g in groups)


# -- the plan ------------------------------------------------------------------

#: (graph, route) -> the groups of its scan, as member ids and node types
PLANS = {
    # add; the feedback gain after reverb and low pass, its own group
    # (a linear run takes it only under fast with nothing overridden,
    # where the block program takes the whole SCC)
    "config5": (((5,), (8,)), (("add",), ("gain",))),
    # add -> SoftClip distort reads the add: one group of two
    "loop": (((1, 2), (5,)), (("add", "distort"), ("gain",))),
    # add, high pass, SoftClip distort, low pass, gain: three groups
    "mega 10": (((9,), (11,), (13,)), (("add",), ("distort",), ("gain",))),
    # add, low pass, chebyshev, biquad, gain
    "mega 67": (((8,), (10,), (12,)), (("add",), ("chebyshev",),
                                       ("gain",))),
}


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("name", list(PLANS))
def test_pinned_groups(name, route):
    cg = dt.compile_graph(_graph(name)[0], device="cpu")
    scan = _scan(cg, *_route(cg, route))
    assert (scan.groups, _types(cg, scan.groups)) == PLANS[name]


def _check_rules(cg, scan):
    """Every group stands next to itself in the block's order (no member
    that runs on its own between its first and last), each member after
    the first reads an earlier one, and none is a fused run's."""
    units = [n for n in scan.order if n not in scan.fused_interior]
    claimed = {n for run, *_ in scan.fused_heads.values() for n in run}
    for g in scan.groups:
        at = [units.index(n) for n in g]
        assert at == list(range(at[0], at[0] + len(g))), g
        assert not set(g) & claimed, g
        for i, n in enumerate(g[1:], 1):
            assert any(l.dst == n and l.src in g[:i]
                       for l in cg.graph.links), g
        assert all(tcomp._pointwise_ok(cg._nodes[n]) for n in g)
    # every candidate that no fused run claims is in a group
    assert {n for n in units if n not in claimed
            and tcomp._pointwise_ok(cg._nodes[n])} == scan.grouped


@pytest.mark.parametrize("seed", range(0, 80, 4))
def test_plan_rules_over_mega_cycles(seed):
    """The rules over twenty mega-cycle graphs, under parity and under
    fast with the feedback gain overridden (where a linear run may claim
    members)."""
    cg = dt.compile_graph(tfuzz._random_mega_cycle_graph(seed)[0],
                          device="cpu")
    for route in ("parity", "fast-override"):
        _check_rules(cg, _scan(cg, *_route(cg, route)))


def test_fused_run_members_are_left_out():
    """config5 under fast with the reverb's decay overridden: the low
    pass -> gain linear run is fused at its head, so the gain leaves the
    groups; mega seed 2 under fast keeps its high pass -> biquad run."""
    cg = dt.compile_graph(presets.config5_feedback_16node()[0], device="cpu")
    scan = _scan(cg, "fast", {"6": {"decay": 0.5}})
    assert [r for r, *_ in scan.fused_heads.values() if r[0] in
            scan.comp_set] == [[7, 8]]
    assert scan.groups == ((5,),)
    _check_rules(cg, scan)
    cg2 = dt.compile_graph(tfuzz._random_mega_cycle_graph(2)[0],
                           device="cpu")
    scan2 = _scan(cg2, *_route(cg2, "fast-override"))
    assert scan2.fused_interior & scan2.comp_set == {12}
    assert scan2.groups == ((10,), (14,))
    _check_rules(cg2, scan2)


def test_no_groups_under_node_hook_or_switch_off(monkeypatch):
    cg = dt.compile_graph(chip_smoke.loop_graph(), device="cpu")
    assert _scan(cg, "parity").groups
    monkeypatch.setattr(tcomp, "POINTWISE_FUSION", False)
    assert _scan(cg, "parity").groups == ()
    monkeypatch.setattr(tcomp, "POINTWISE_FUSION", True)
    monkeypatch.setattr(tcomp, "NODE_HOOK", lambda *a: None)
    assert _scan(cg, "parity").groups == ()


def test_group_reads_the_previous_block_of_a_later_member():
    """The loop graph's first group (add -> distort): the add reads the
    input's block and the feedback gain's previous block (a later
    member) as value operands; the distort reads the add inside the
    program; every member output is written for the carry."""
    g = chip_smoke.loop_graph()
    cg = dt.compile_graph(g, device="cpu")
    with dt.policy("parity"):
        prog, sigs, scals, written = cg._lower((1, 2), None, every=True)
    assert sigs == [(0, "out"), (5, "out")]
    assert written == [("value", (1, "out")), ("value", (2, "out"))]
    assert len(prog.outs) == 2
    assert [type(d).__name__ for d in scals] == ["_Divisor", "_Slider"]


def test_lowered_once_a_scan(monkeypatch):
    """A render of 21 blocks lowers each group once (per policy and
    structure of the overrides), on both routes of the scan."""
    cg = dt.compile_graph(chip_smoke.loop_graph(), device="cpu")
    calls = []
    real = cg._lower

    def counted(members, pdict, every=False, **kw):
        calls.append((tuple(members), every))
        return real(members, pdict, every, **kw)
    monkeypatch.setattr(cg, "_lower", counted)
    for route in ("eager", "buffers"):
        calls.clear()
        with dt.policy("parity"):
            cg.cycle_loops.route = route
            cg.render(_x(1), batch_shape=(B,))
        assert sorted(c for c in calls if c[1]) == [((1, 2), True),
                                                   ((5,), True)], route


# -- bitwise the eager route ---------------------------------------------------

def _leaves(res):
    return chip_smoke.route_leaves(res)


def _render(g, inp, pol, params, route, x, fusion=True):
    """(output, aux, state) of one render, and the group calls it made."""
    counts = {}
    was = tcomp.POINTWISE_FUSION
    tcomp.POINTWISE_FUSION = fusion
    try:
        cg = dt.compile_graph(g, device="cpu")
        cg.cycle_loops.route = route
        with dt.policy(pol), chip_smoke.calls_counted(
                [(tcomp, "group_call")], counts):
            res = cg.render({str(inp): x}, batch_shape=(B,), params=params)
    finally:
        tcomp.POINTWISE_FUSION = was
    return res, counts.get("group_call", 0), cg


@pytest.mark.parametrize("scan_route", ["eager", "buffers"])
@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("name", GRAPHS)
def test_scan_with_groups_is_the_eager_route(name, route, scan_route):
    g, inp = _graph(name)
    cg0 = dt.compile_graph(g, device="cpu")
    pol, params = _route(cg0, route)
    n_groups = len(_scan(cg0, pol, params).groups)
    x = _x(GRAPHS.index(name))[:, 0]
    got, calls, cg = _render(g, inp, pol, params, scan_route, x)
    want, calls0, _ = _render(g, inp, pol, params, scan_route, x, False)
    assert calls0 == 0
    assert (cg.cycle_loops.plan is not None) == (scan_route == "buffers")
    # the render's own groups, then one call a scan group and block
    assert calls - n_groups * NB == _outside_calls(g, pol, params)
    a, b = _leaves(got), _leaves(want)
    assert len(a) == len(b)
    for u, v in zip(a, b):
        assert u.shape == v.shape and torch.equal(u, v)


def _outside_calls(g, pol, params) -> int:
    """The group calls of a render outside the cycle: a one-block render
    runs the cycle's groups once each."""
    cg = dt.compile_graph(g, device="cpu")
    with dt.policy(pol):
        n = len(_scan(cg, pol, params).groups)
    return chip_smoke.cpu_group_calls(
        g, pol, (lambda c: params) if params else None, T=128) - n


def test_override_tensor_and_data_stay_in_their_group():
    """config5 under fast with its feedback gain overridden by a float, a
    tensor and a stream slider (Data): the same groups, the slider a
    scalar operand, bitwise the eager route each time."""
    g, inp = _graph("config5")
    x = _x(5)[:, 0]
    outs = []
    for v in (0.4, torch.tensor(0.4), Scope().root(("8", "level"), 0.4)):
        got, calls, _ = _render(g, inp, "fast", {"8": {"level": v}},
                                "eager", x)
        want, _, _ = _render(g, inp, "fast", {"8": {"level": v}}, "eager",
                             x, False)
        assert calls == 3 + 2 * NB
        for u, w in zip(_leaves(got), _leaves(want)):
            assert torch.equal(u, w)
        outs.append(got[0])
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])


# -- against the JAX package's per-node scan -----------------------------------

def _jax_loop_graph():
    """chip_smoke.loop_graph in the JAX package."""
    g = dj.Graph(JIdSpace())
    inp = g.add("input")
    mixa = g.add("add")
    ds = g.add("distort", mode="SoftClip", level=2.0)
    rv = g.add("reverb", seconds=0.004, decay=0.5)
    lp = g.add("low_pass", ratio=0.4)
    fbg = g.add("gain", level=0.45)
    out = g.add("output")
    g.connect(inp, "out", mixa, "a")
    g.chain(mixa, ds, rv, lp, fbg)
    g.connect(fbg, "out", mixa, "b")
    g.connect(rv, "out", out, "in")
    return g


def _dbfs(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    return 20 * np.log10(max(err, 1e-30) / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("pol", ["fast", "parity", "exact"])
@pytest.mark.parametrize("name", ["loop"] + [f"mega {s}" for s in
                                             MEGA_SEEDS])
def test_per_node_scan_vs_jax(name, pol, monkeypatch):
    """CYCLE_FUSION off in both packages: the port's loop over buffers with
    its cycle's groups against the JAX package's per-node lax.scan."""
    monkeypatch.setattr(jcompile, "CYCLE_FUSION", False)
    monkeypatch.setattr(tcomp, "CYCLE_FUSION", False)
    g, inp = _graph(name)
    gj = (_jax_loop_graph() if name == "loop"
          else jfuzz._random_mega_cycle_graph(int(name.split()[1]))[0])
    x = _x(11)[:, 0].numpy()
    with dj.policy(pol):
        yj, _, sj = dj.compile_graph(gj).render({str(inp): x},
                                                batch_shape=(B,))
    (yt, _, st), calls, cg = _render(g, inp, pol, None, "buffers",
                                     torch.from_numpy(x))
    assert cg.cycle_loops.plan is not None
    assert calls >= NB * len(_scan(cg, pol).groups) > 0
    assert _dbfs(yt.numpy(), np.asarray(yj)) <= VS_JAX_DB
    for nid in map(str, _scc(cg)):
        for kk, w in (sj[nid] or {}).items():
            np.testing.assert_allclose(np.asarray(st[nid][kk], np.float64),
                                       np.asarray(w, np.float64), rtol=0,
                                       atol=STATE_ATOL)


# -- the backward --------------------------------------------------------------

def _function_route(monkeypatch, calls):
    """Every group through PointwiseGroup, as on the card: the plain
    version forward and the reverse kernel's plain version
    (group_adjoint) backward, counted into ``calls``; autograd through
    the plain version (group_vjp) never runs."""
    def bwd(*a):
        calls["backward"] += 1
        return pk.group_adjoint(*a)
    monkeypatch.setattr(tcomp, "group_call", lambda prog, sigs, scals, Tn,
                        d: pk.run(pw.interpret, prog, sigs, scals, Tn, d,
                                  bwd))
    monkeypatch.setattr(pk, "group_vjp", None)


def _grads(g, inp, pol, route, x_np, tgt_np, groups, monkeypatch):
    """The loss, each slider's and the input's gradient of one
    differentiated render of ``g`` on the scan's ``route``, every slider
    a leaf: through the groups (the card's Function route) or the eager
    ops (``POINTWISE_FUSION`` off)."""
    calls = {"backward": 0}
    with monkeypatch.context() as m:
        if groups:
            _function_route(m, calls)
        else:
            m.setattr(tcomp, "POINTWISE_FUSION", False)
        cg = dt.compile_graph(g, device="cpu")
        cg.cycle_loops.route = route
        with dt.policy(pol):
            params = cg.init_params(requires_grad=True)
            x = torch.from_numpy(x_np).requires_grad_()
            loss = tfit.make_loss_fn(cg)(params, cg.init_state(),
                                         {str(inp): x},
                                         torch.from_numpy(tgt_np))
            loss.backward()
    assert (cg.cycle_loops.plan is not None) == (route == "buffers")
    return (loss.detach(), {(n, k): v.grad for n, e in params.items()
                            for k, v in e.items()}, x.grad, calls)


def _element_db(got, want) -> float:
    d = float((got.double() - want.double()).abs().max())
    if d == 0.0:
        return -np.inf
    return 20 * np.log10(d / max(float(want.double().abs().max()), 1e-300))


def _inputs(seed, length=T):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, length)) * 0.3).astype(np.float32)
    tgt = (rng.standard_normal((B, 1, length)) * 0.1).astype(np.float32)
    return x, tgt


@pytest.mark.parametrize("scan_route", ["eager", "buffers"])
@pytest.mark.parametrize("pol", ["fast", "parity", "exact"])
@pytest.mark.parametrize("name", ["config5", "loop"])
def test_backward_vs_eager_ops(name, pol, scan_route, monkeypatch):
    """Every slider a leaf (the fit through a feedback cycle): the
    cycle's groups through the Function with group_adjoint against the
    eager ops' autograd on the same route of the scan: the loss bitwise,
    the input's gradient within ELEMENT_DB, each slider's within
    SUM_RTOL (SUM_ATOL near 0)."""
    g, inp = _graph(name)
    x, tgt = _inputs(3)
    got = _grads(g, inp, pol, scan_route, x, tgt, True, monkeypatch)
    want = _grads(g, inp, pol, scan_route, x, tgt, False, monkeypatch)
    cg = dt.compile_graph(g, device="cpu")
    n_groups = len(_scan(cg, pol, cg.init_params()).groups)
    assert got[3]["backward"] >= n_groups * NB > 0
    assert torch.equal(got[0], want[0])
    assert _element_db(got[2], want[2]) <= ELEMENT_DB
    assert got[1].keys() == want[1].keys()
    for k, w in want[1].items():
        v = got[1][k]
        assert (v is None) == (w is None), k
        if w is not None:
            assert abs(float(v) - float(w)) <= max(
                SUM_RTOL * abs(float(w)), SUM_ATOL), (k, v, w)


@pytest.mark.parametrize("pol", ["fast", "parity"])
@pytest.mark.parametrize("name", ["config5", "loop"])
def test_backward_vs_jax_grad(name, pol, monkeypatch):
    """CYCLE_FUSION off in both packages: every slider's and the input's
    gradient through the loop over buffers, its groups on the card's
    Function route, against jax.grad through the JAX package's per-node
    lax.scan."""
    monkeypatch.setattr(jcompile, "CYCLE_FUSION", False)
    monkeypatch.setattr(tcomp, "CYCLE_FUSION", False)
    g, inp = _graph(name)
    gj = (_jax_loop_graph() if name == "loop"
          else jp.config5_feedback_16node()[0])
    x, tgt = _inputs(2, 1024)
    with jprec.policy(pol):
        cgj = dj.compile_graph(gj)
        pj = cgj.init_params()
        lj, (gpj, gxj) = jax.jit(jax.value_and_grad(
            jfit.make_loss_fn(cgj), argnums=(0, 2)))(
            pj, cgj.init_state(), {str(inp): x}, tgt)
    calls = {"backward": 0}
    _function_route(monkeypatch, calls)
    cg = dt.compile_graph(g, device="cpu")
    with dt.policy(pol):
        cg.cycle_loops.route = "buffers"
        params = convert.params_from_jax(jax.tree.map(np.asarray, pj), "cpu",
                                         requires_grad=True)
        xt = torch.from_numpy(x).requires_grad_()
        loss = tfit.make_loss_fn(cg)(params, cg.init_state(),
                                     {str(inp): xt}, torch.from_numpy(tgt))
        loss.backward()
    assert cg.cycle_loops.plan is not None and calls["backward"] > 0
    assert abs(float(loss.detach()) - float(lj)) <= JAX_RTOL * abs(float(lj))
    for n in sorted(params):
        for k, v in params[n].items():
            got = 0.0 if v.grad is None else float(v.grad)
            w = float(gpj[n][k])
            assert np.isfinite(got)
            assert abs(got - w) <= max(JAX_RTOL * abs(w), 1e-9), (n, k, got,
                                                                  w)
    gx = np.asarray(gxj[str(inp)])
    assert np.abs(xt.grad.numpy() - gx).max() / np.abs(gx).max() <= JAX_RTOL


# -- the stream step -----------------------------------------------------------

@pytest.mark.parametrize("case", ["parity", "exact", "fast, gain moved"])
def test_stream_step_with_cycle_groups_is_capturable(case):
    """config5's stream step under parity and exact, and under fast with
    its feedback gain moved (a stream slider, Data, which takes the cycle
    off its block program): the three render groups and the cycle's two
    a block, and after one block no host-data tensor and no host read."""
    g = presets.config5_feedback_16node()[0]
    pol = case.split(",")[0]
    with dt.policy(pol):
        sess = StreamSession(g, device="cpu")
        if case.endswith("moved"):
            sess.params = {"8": {"level": 0.4}}
        x = (np.random.default_rng(5).standard_normal((3, 128)) * 0.3
             ).astype(np.float32)
        key = str(sess.cg.input_ids[0])
        sess.process({key: x[0]})
        if case.endswith("moved"):
            sess.params["8"]["level"] = 0.35
            sess.process({key: x[1]})
            assert isinstance(sess.step._binding.params["8"]["level"], Data)
        sess.step.inputs.copy_(torch.from_numpy(x[2:]))
        counts = {}
        mode = _HostOps()
        with chip_smoke.calls_counted([(tcomp, "group_call")], counts), mode:
            sess.step.run(sess.params)
    assert counts.get("group_call") == 5
    assert mode.ops > 10
    assert not mode.host, sorted(set(mode.host))
