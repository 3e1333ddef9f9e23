"""The port's slice as a whole: compile_graph + render of the bench chain
against the JAX package and the NumPy oracle, the planner's stage tuples,
the state handoff between renders and between packages, the paths the
port refuses, and the node types ported later (mux, demux, muff, the
oversampled shapers).

Bounds (dBFS = 20 log10(max|err| / max|reference|)), each with the worst
the CPU measured:
  port vs JAX render          fast <= -118 (-122.6), parity <= -115 (-119.5)
  port parity vs the oracle   <= -113 (-118.0); the README's hard bound is -90
  chained vs one long render  <= -135 (-140.5)
  states                      atol 1e-6 (6e-7); mapped knobs rtol 1e-6
  muff, oversampled shapers   the vs-JAX bounds above (muff -130.5 under
                              both; oversampled fast -129.2, parity -130.3)
  mux / demux                 bitwise, against the oracle's fan-in hops and
                              the JAX package's parity render; the muxed
                              graph within the bounds above (vs JAX fast
                              -127.9, parity -128.7; vs the oracle -130.9)
"""

import jax
import numpy as np
import pytest
import torch

import dsp_stuff_tpu as dj
import dsp_stuff_tpu_torch as dt
from dsp_stuff_tpu.ids import IdSpace as JIdSpace
from dsp_stuff_tpu_torch import convert
from dsp_stuff_tpu_torch.ids import IdSpace as TIdSpace
from dsp_stuff_tpu_torch.utils import precision as tprec

VS_JAX_DB = {"fast": -118.0, "parity": -115.0}
ORACLE_DB = -113.0
HANDOFF_DB = -135.0
STATE_ATOL = 1e-6
POLICIES = ["fast", "parity"]
B, T = 4, 4096


@pytest.fixture(autouse=True)
def _torch_env():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    prev = tprec.get_policy()
    yield
    tprec.set_policy(prev)
    torch.set_num_threads(threads)


def _dbfs(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    return 20 * np.log10(max(err, 1e-30) / max(np.abs(want).max(), 1e-30))


def _close(got, want, atol=STATE_ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=0,
                               atol=atol)


def _compare_states(port_state, jax_state):
    jax_state = jax.tree.map(np.asarray, jax_state)
    assert port_state.keys() == jax_state.keys()
    for k, entry in jax_state.items():
        for kk, w in (entry or {}).items():
            g = port_state[k][kk]
            _close(g.numpy() if isinstance(g, torch.Tensor) else g, w)


def _bench_chain(g):
    inp = g.add("input")
    gn = g.add("gain", level=1.2)
    bq = g.add("biquad", a0=1.0, a1=-0.24, a2=0.0, b0=0.758, b1=0.0, b2=0.0)
    od = g.add("overdrive", boost=4.0, drive=0.6, level=0.9)
    lp = g.add("low_pass", ratio=0.6)
    hp = g.add("high_pass", ratio=0.2)
    ds = g.add("distort", mode="Tanh", level=3.0)
    ch = g.add("chebyshev", level_pos=2.0, level_neg=4.0)
    rv = g.add("reverb", seconds=0.05, decay=0.4)
    out = g.add("output")
    g.chain(inp, gn, bq, od, lp, hp, ds, ch, rv, out)


def _mixed_chain(g):
    """gain, one-pole, shaper, biquad, short comb (D=192), high-pass."""
    inp = g.add("input")
    gn = g.add("gain", level=1.1)
    lp = g.add("low_pass", ratio=0.55)
    ds = g.add("distort", mode="SoftClip", level=2.5)
    bq = g.add("biquad", a0=1.0, a1=-0.3, a2=0.05, b0=0.8, b1=0.1, b2=0.0)
    rv = g.add("reverb", seconds=0.004, decay=0.45)
    hp = g.add("high_pass", ratio=0.12)
    out = g.add("output")
    g.chain(inp, gn, lp, ds, bq, rv, hp, out)


def _tapped_fanin(g):
    """Two inputs fan into the head (no head fold), a mid-chain member
    feeds a second output (a tap stage), and a pure linear run beside."""
    a = g.add("input")
    b = g.add("input")
    lp = g.add("low_pass", ratio=0.4)
    od = g.add("overdrive", boost=3.0, drive=0.5, level=0.8)
    hp = g.add("high_pass", ratio=0.3)
    ch = g.add("chebyshev", level_pos=1.5, level_neg=2.5)
    rv = g.add("reverb", seconds=0.01, decay=0.3)
    o1 = g.add("output")
    o2 = g.add("output")
    gn = g.add("gain", level=0.7)
    bq = g.add("biquad", a0=1.0, a1=-0.5, a2=0.1, b0=0.3, b1=0.2, b2=0.1)
    o3 = g.add("output")
    g.connect(a, "out", lp, "in")
    g.connect(b, "out", lp, "in")
    g.chain(lp, od, hp, ch, rv, o1)
    g.connect(od, "out", o2, "in")
    g.chain(b, gn, bq, o3)


def _modulated(g):
    """A second input modulates the distort level (no fusion for it)."""
    a = g.add("input")
    m = g.add("input")
    gn = g.add("gain", level=0.9)
    ds = g.add("distort", mode="Atan", level=2.0)
    lp = g.add("low_pass", ratio=0.5)
    out = g.add("output")
    g.chain(a, gn, ds, lp, out)
    g.connect(m, "out", ds, "level")


def _muxed(g):
    """mux and demux beside fusable nodes: a linear pair into the mux's
    selected port, and a feedback loop mux -> overdrive -> high_pass ->
    demux -> reverb -> back into the mux's other port."""
    inp = g.add("input")
    gn = g.add("gain", level=1.1)
    lp = g.add("low_pass", ratio=0.4)
    mx = g.add("mux", in_port="B")
    od = g.add("overdrive", boost=3.0, drive=0.5, level=0.8)
    hp = g.add("high_pass", ratio=0.2)
    dmx = g.add("demux", out_port="A")
    rv = g.add("reverb", seconds=0.004, decay=0.4)
    out = g.add("output")
    g.chain(inp, gn, lp)
    g.connect(lp, "out", mx, "b")
    g.chain(mx, od, hp, dmx)
    g.connect(dmx, "a", rv, "in")
    g.connect(rv, "out", mx, "a")
    g.connect(rv, "out", out, "in")


GRAPHS = {"bench": _bench_chain, "mixed": _mixed_chain,
          "tapped_fanin": _tapped_fanin, "modulated": _modulated,
          "muxed": _muxed}


def _pair(name):
    gj = dj.Graph(JIdSpace())
    GRAPHS[name](gj)
    gt = dt.loads_graph(dj.dumps_graph(gj), ids=TIdSpace())
    return gj, gt


def _x(n_in, seed=0, batch=B, length=T):
    return (np.random.default_rng(seed).standard_normal((batch, n_in, length))
            * 0.3).astype(np.float32)


def _render_jax(gj, x, pol, **kw):
    with dj.policy(pol):
        y, aux, st = dj.compile_graph(gj).render(x, batch_shape=(x.shape[0],),
                                                 **kw)
    return np.asarray(y), aux, st


def _render_port(gt, x, pol, **kw):
    with dt.policy(pol):
        return dt.compile_graph(gt, device="cpu").render(x, batch_shape=(x.shape[0],), **kw)


@pytest.mark.parametrize("pol", POLICIES)
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_render_matches_jax(name, pol):
    gj, gt = _pair(name)
    x = _x(len(dt.compile_graph(gt, device="cpu").input_ids))
    yj, auxj, sj = _render_jax(gj, x, pol)
    yt, auxt, st = _render_port(gt, x, pol)
    assert yt.shape == yj.shape
    assert _dbfs(yt.numpy(), yj) <= VS_JAX_DB[pol]
    _compare_states(st, sj)
    assert auxt.keys() == auxj.keys()
    for k, v in auxj.get("__knobs__", {}).items():
        np.testing.assert_allclose(auxt["__knobs__"][k].numpy(),
                                   np.asarray(v), rtol=1e-6, atol=0)


def _record(monkeypatch, mod_cs, mod_casc):
    seen = []
    real_seg, real_lin = mod_cs.chain_segment, mod_casc.linear_cascade

    def seg(x, stages, state_in):
        seen.append(("segment", tuple(stages)))
        return real_seg(x, stages, state_in)

    def lin(x, sections, s_init, emits=()):
        seen.append(("cascade", tuple(sections), tuple(emits)))
        return real_lin(x, sections, s_init, emits)

    monkeypatch.setattr(mod_cs, "chain_segment", seg)
    monkeypatch.setattr(mod_casc, "linear_cascade", lin)
    return seen


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_planner_stage_tuples_match_jax(name, monkeypatch):
    """Under fast both compilers hand the same stage tuples to
    chain_segment and the same sections and emit points to their fused
    linear_cascade runs, in the same order."""
    from dsp_stuff_tpu.ops import cascade as jcasc
    from dsp_stuff_tpu.ops import chain_segment as jcs
    from dsp_stuff_tpu_torch.ops import cascade as tcasc
    from dsp_stuff_tpu_torch.ops import chain_segment as tcs
    gj, gt = _pair(name)
    x = _x(len(dt.compile_graph(gt, device="cpu").input_ids), length=1024)
    seen_j = _record(monkeypatch, jcs, jcasc)
    _render_jax(gj, x, "fast")
    seen_t = _record(monkeypatch, tcs, tcasc)
    _render_port(gt, x, "fast")
    assert seen_t == seen_j
    if name == "bench":
        assert seen_t == [("segment", seen_t[0][1])]
        assert len(seen_t[0][1]) == 11


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_parity_render_matches_oracle(name):
    """The port's parity render against the NumPy oracle of the
    reference's per-sample semantics: bench.oracle_chain for the bench
    chain, the block-wise tests/oracle/graph.py evaluator elsewhere."""
    import bench
    from oracle.graph import evaluate
    gj, gt = _pair(name)
    cg = dt.compile_graph(gt, device="cpu")
    x = _x(len(cg.input_ids), seed=5)
    y, _, _ = _render_port(gt, x, "parity")
    for i in range(B):
        if name == "bench":
            wants = [bench.oracle_chain(x[i, 0])]
        else:
            outs = evaluate(gj, {nid: x[i, k]
                                 for k, nid in enumerate(cg.input_ids)}, T)
            wants = [outs[nid] for nid in cg.output_ids]
        for j, want in enumerate(wants):
            assert _dbfs(y[i, j].numpy(), want) <= ORACLE_DB


@pytest.mark.parametrize("pol", POLICIES)
@pytest.mark.parametrize("name", ["bench", "mixed"])
def test_chained_renders_equal_one(name, pol):
    _, gt = _pair(name)
    x = _x(1, seed=6)
    with dt.policy(pol):
        cg = dt.compile_graph(gt, device="cpu")
        full, _, _ = cg.render(x, batch_shape=(B,))
        a, _, st = cg.render(x[..., :1536], batch_shape=(B,))
        b, _, _ = cg.render(x[..., 1536:], state=st, batch_shape=(B,))
    assert _dbfs(torch.cat([a, b], dim=-1).numpy(), full.numpy()) <= HANDOFF_DB


@pytest.mark.parametrize("pol", POLICIES)
def test_state_carried_from_jax(pol):
    """JAX renders the first half, convert.state_from_jax carries its state
    across, the port renders the second half: together the JAX full
    render."""
    gj, gt = _pair("bench")
    x = _x(1, seed=7)
    half = T // 2
    yj, _, _ = _render_jax(gj, x, pol)
    _, _, sj = _render_jax(gj, x[..., :half], pol)
    st = convert.state_from_jax(jax.tree.map(np.asarray, sj), "cpu")
    y2, _, _ = _render_port(gt, x[..., half:], pol, state=st)
    assert _dbfs(y2.numpy(), yj[..., half:]) <= VS_JAX_DB[pol]


@pytest.mark.parametrize("pol", POLICIES)
def test_state_carried_to_jax(pol):
    """The port renders the first half, convert.state_to_numpy hands its
    state to the JAX package for the second half."""
    gj, gt = _pair("mixed")
    x = _x(1, seed=8)
    half = T // 2
    yj, _, _ = _render_jax(gj, x, pol)
    _, _, st = _render_port(gt, x[..., :half], pol)
    y2, _, _ = _render_jax(gj, x[..., half:], pol,
                           state=convert.state_to_numpy(st))
    assert _dbfs(y2, yj[..., half:]) <= VS_JAX_DB[pol]


def test_params_from_jax_override():
    """JAX init_params carried across and changed: the port renders the
    changed value like the JAX package does (overridden nodes leave the
    fused path in both)."""
    gj, gt = _pair("bench")
    x = _x(1, seed=9)
    with dj.policy("fast"):
        cg = dj.compile_graph(gj)
        pj = jax.tree.map(np.asarray, cg.init_params())
    lp_id = next(str(n.id) for n in gj.nodes.values()
                 if n.cfg_name == "low_pass")
    pj[lp_id]["ratio"] = np.float32(0.3)
    yj, _, _ = _render_jax(gj, x, "fast", params=pj)
    pt = convert.params_from_jax(pj, "cpu")
    assert pt.keys() == dt.compile_graph(gt, device="cpu").init_params().keys()
    yt, _, _ = _render_port(gt, x, "fast", params=pt)
    assert _dbfs(yt.numpy(), yj) <= VS_JAX_DB["fast"]


def test_session_render_pads_and_trims():
    _, gt = _pair("bench")
    x = _x(1, seed=10, batch=1, length=1000)[0]
    with dt.policy("fast"):
        y, _, _ = dt.render(gt, x, device="cpu")
        padded = np.pad(x, ((0, 0), (0, 24)))
        want, _, _ = dt.compile_graph(gt, device="cpu").render(padded)
    assert y.shape == (1, 1000)
    np.testing.assert_array_equal(y.numpy(), want[..., :1000].numpy())


def _oversampled_cycle(g):
    """input -> gain -> distort(Tanh, 4x) -> reverb -> output, the reverb
    back into the gain."""
    inp = g.add("input")
    gn = g.add("gain", level=0.5)
    ds = g.add("distort", mode="Tanh", level=2.0, oversample="4")
    rv = g.add("reverb", seconds=0.01, decay=0.3)
    out = g.add("output")
    g.chain(inp, gn, ds, rv, out)
    g.connect(rv, "out", gn, "in")


def _oversampled_chain(g):
    inp = g.add("input")
    ds = g.add("distort", mode="Tanh", level=2.0, oversample="4")
    out = g.add("output")
    g.chain(inp, ds, out)


@pytest.mark.parametrize("pol", POLICIES)
@pytest.mark.parametrize("name", ["feedback", "chain"])
def test_oversampled_shaper_matches_jax(name, pol):
    """An oversampled shaper renders, alone and as a member of a feedback
    cycle (no cycle program takes it: the per-node block scan, whose
    converters see one 128-sample block a call), against the JAX package
    under both policies."""
    gj = dj.Graph(JIdSpace())
    {"feedback": _oversampled_cycle, "chain": _oversampled_chain}[name](gj)
    gt = dt.loads_graph(dj.dumps_graph(gj), ids=TIdSpace())
    x = _x(1, seed=14, length=1024)
    yj, _, _ = _render_jax(gj, x, pol)
    yt, _, _ = _render_port(gt, x, pol)
    assert _dbfs(yt.numpy(), yj) <= VS_JAX_DB[pol]


def test_mux_demux():
    """demux (out B) -> both ports of mux (in B), as tests/test_graph.py
    holds the JAX package: three fan-in hops of the input; the unselected
    outputs are zeros on the input's device."""
    import oracle
    g = dt.Graph(TIdSpace())
    inp = g.add("input")
    dmx = g.add("demux", out_port="B")
    mx = g.add("mux", in_port="B")
    out = g.add("output")
    g.connect(inp, "out", dmx, "in")
    g.connect(dmx, "b", mx, "b")
    g.connect(dmx, "a", mx, "a")
    g.connect(mx, "out", out, "in")
    x = _x(1, seed=15, batch=1, length=512)[0, 0]
    for pol in POLICIES:
        with dt.policy(pol):
            y, _, _ = dt.render(g, x[None], device="cpu")
        h = oracle.fanin_average
        np.testing.assert_array_equal(y[0].numpy(), h([h([h([x])])]))
    # (the JAX package's fast fan-in multiplies by the reciprocal)
    yj, _, _ = _render_jax(dj.loads_graph(dt.dumps_graph(g)),
                           x[None, None], "parity")
    np.testing.assert_array_equal(y[0].numpy(), yj[0, 0])
    from dsp_stuff_tpu_torch.nodes.simple import Demux
    outs, _ = Demux.process_seq({"out_port": "A"}, None,
                                {"in": torch.ones(3)})
    assert torch.equal(outs["b"], torch.zeros(3))
    assert outs["b"].device == outs["a"].device


def _muff_graph(pkg, ids, **params):
    g = pkg.Graph(ids)
    inp = g.add("input")
    mf = g.add("muff", **params)
    out = g.add("output")
    g.chain(inp, mf, out)
    return g


MUFF_KNOBS = [dict(toan=0.5, level=0.5, sustain=0.5),
              dict(toan=0.0, level=1.0, sustain=0.2),
              dict(toan=0.9, level=0.3, sustain=1.0)]


@pytest.mark.parametrize("pol", POLICIES)
@pytest.mark.parametrize("knobs", range(len(MUFF_KNOBS)))
def test_muff_matches_jax(knobs, pol):
    """Muff (the JAX package's license-clean model; no reference parity is
    claimed) against the JAX package, chained across two renders, its
    one-pole state carried."""
    kw = MUFF_KNOBS[knobs]
    gj = _muff_graph(dj, JIdSpace(), **kw)
    gt = _muff_graph(dt, TIdSpace(), **kw)
    assert dt.dumps_graph(gt) == dj.dumps_graph(gj)
    x = _x(1, seed=16 + knobs, length=1024)
    yj, _, sj = _render_jax(gj, x, pol)
    yt, _, st = _render_port(gt, x, pol)
    assert _dbfs(yt.numpy(), yj) <= VS_JAX_DB[pol]
    _compare_states(st, sj)
    a, _, st = _render_port(gt, x[..., :512], pol)
    b, _, _ = _render_port(gt, x[..., 512:], pol, state=st)
    assert _dbfs(torch.cat([a, b], -1).numpy(), yt.numpy()) <= HANDOFF_DB


def test_mux_demux_stay_per_node():
    """As in the JAX planner, neither mux nor demux joins a chain segment,
    a linear run or a cycle program: the loop through them takes the
    per-node block scan under fast."""
    _, gt = _pair("muxed")
    cg = dt.compile_graph(gt, device="cpu")
    kinds = {n.id: n.cfg_name for n in gt.nodes.values()}
    planned = [n for run in cg._mega_plan + cg._fusion_plan for n in run]
    assert [kinds[n] for n in planned] == ["gain", "low_pass"]
    (comp,) = [c for c in cg._sccs if len(c) > 1]
    assert {kinds[n] for n in comp} == {"mux", "overdrive", "high_pass",
                                         "demux", "reverb"}
    with dt.policy("fast"):
        assert cg._cycle_program(comp, None) is None


def test_muff_level_is_linear():
    """As tests/test_graph.py holds the JAX package: the knobs change the
    output, and level 1.0 doubles level 0.5's output exactly."""
    x = _x(1, seed=19, batch=1, length=1024)[0]

    def run(**kw):
        with dt.policy("fast"):
            y, _, _ = dt.render(_muff_graph(dt, TIdSpace(), **kw), x,
                                device="cpu")
        return y[0].numpy()
    base = run(toan=0.5, level=0.5, sustain=0.5)
    assert np.isfinite(base).all() and np.abs(base).max() > 1e-4
    for other in (run(toan=0.0, level=0.5, sustain=0.5),
                  run(toan=0.5, level=0.5, sustain=1.0)):
        assert not np.allclose(base, other)
    np.testing.assert_allclose(run(toan=0.5, level=1.0, sustain=0.5),
                               base * 2.0, rtol=1e-5, atol=1e-7)


def test_inputs_on_another_device_raise():
    _, gt = _pair("bench")
    cg = dt.compile_graph(gt, device="cpu")
    assert cg.device == torch.device("cpu")
    with pytest.raises(ValueError, match="compiled for cpu"):
        cg.render(torch.zeros((1, 256), device="meta"))
    st = cg.init_state()
    rv = next(k for k, v in st.items() if v and "ring" in v)
    st[rv]["ring"] = torch.zeros_like(st[rv]["ring"], device="meta")
    with pytest.raises(ValueError, match="compiled for cpu"):
        cg.render(np.zeros((1, 256), np.float32), state=st)


def test_broadcast_state_tiles_streams():
    _, gt = _pair("bench")
    cg = dt.compile_graph(gt, device="cpu")
    st = cg.broadcast_state(cg.init_state(), (3,))
    for entry in st.values():
        for k, v in (entry or {}).items():
            if isinstance(v, torch.Tensor):
                assert v.shape[0] == 3
            else:
                assert k == "pos" and v == 0
    x = _x(1, seed=11, batch=3, length=512)
    with dt.policy("fast"):
        a, _, _ = cg.render(x, batch_shape=(3,), state=st)
        b, _, _ = cg.render(x, batch_shape=(3,))
    np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("entry", ["compile_graph", "render",
                                   "compile_graph cuda:0"])
def test_card_is_the_default_and_raises_without_one(entry, monkeypatch):
    """The entry points run on the card unless the caller asks for the
    CPU: with no CUDA device (forced here, whatever the machine has) a
    call without ``device`` raises a RuntimeError that names
    device="cpu", before anything renders."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, gt = _pair("bench")
    x = _x(1, seed=12, batch=1, length=256)[0]
    with pytest.raises(RuntimeError, match='device="cpu"'):
        if entry == "compile_graph":
            dt.compile_graph(gt)
        elif entry == "render":
            dt.render(gt, x)
        else:
            dt.compile_graph(gt, device="cuda:0")


@pytest.mark.parametrize("entry", ["compile_graph", "render"])
def test_cpu_on_request_still_renders(entry, monkeypatch):
    """device="cpu" renders with no CUDA device present, through both
    entry points, to the same samples."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, gt = _pair("bench")
    x = _x(1, seed=13, batch=1, length=512)[0]
    with dt.policy("fast"):
        want, _, _ = dt.compile_graph(gt, device="cpu").render(x)
        if entry == "compile_graph":
            y, _, _ = dt.compile_graph(gt, device="cpu").render(x)
        else:
            y, _, _ = dt.render(gt, x, device="cpu")
    assert y.device == torch.device("cpu") and y.shape == (1, 512)
    assert bool(torch.isfinite(y).all())
    np.testing.assert_array_equal(y.numpy(), want.numpy())
