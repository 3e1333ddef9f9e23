"""The port's presets (dsp_stuff_tpu_torch/models/presets.py) and the
slice as a whole: config5, the 16-node feedback graph, config2, the echo
+ chorus chain, config3, the 4x-oversampled overdrive and distortion, and
config4, the stereo convolution reverb (a 6 ms IR here: 288 taps, the FFT
path), rendered through compile_graph + render against the JAX package and
the NumPy oracle.

Bounds (dBFS = 20 log10(max|err| / max|reference|)), each with the worst
the CPU measured:
  config5 vs JAX        <= -100 (-104.5): the JAX render computes the
                        envelope's release gain with an in-graph exp one ulp
                        off the host gain both the port and the oracle use
  config2 vs JAX        fast <= -80 (-83.3): the JAX fast chorus trajectory
                        takes an f32 sin and an FMA; parity <= -130 (-141.4)
  config5 vs oracle/graph.evaluate   fast <= -115 (-124.1),
                        parity <= -120 (-126.3); the README's bound is -90
  config2 vs the composed oracle     <= -130 (fast -136.6, parity exact);
                        oracle/graph.evaluate runs the chorus with f32
                        params, whose history length comes out one sample
                        longer than its state, so it is not the reference
                        for config2 (as in tests/test_presets.py)
  config3 vs JAX        <= -100 (fast -127.7, parity -129.7)
  config4 vs JAX        fast <= -100 (-131.7; continued from a JAX half
                        render -132.2), parity <= -120 (bitwise)
  config3 vs the composed oracle (tests/oracle oversampled: the converters
                        in f64)  parity <= -90 (-127.4), fast <= -90 (-127.4)
  config4 vs the composed oracle (oracle.fir)  parity <= -90 (bitwise),
                        fast <= -90 (-131.9)
  chained vs one render <= -135 (config4 parity bitwise); config4 fast
                        <= -120 (-131.9): the halves take FFTs of other
                        sizes, in f32; the (2, 2) batch equals the flat one
  config3 chained: the oversampler keeps no state, so two renders differ
                        from one near the boundary in both packages; the
                        port's chained render vs JAX's chained render
                        <= -100 (-129.5)
  spectrogram columns vs JAX         <= -100; knobs rtol 1e-6
"""

import jax
import numpy as np
import pytest
import torch

import dsp_stuff_tpu as dj
import dsp_stuff_tpu_torch as dt
from dsp_stuff_tpu.models import presets as jp
from dsp_stuff_tpu_torch import convert
from dsp_stuff_tpu_torch.models import presets as tp
from dsp_stuff_tpu_torch.utils import precision as tprec

VS_JAX_DB = {("config5", "fast"): -100.0, ("config5", "parity"): -100.0,
             ("config2", "fast"): -80.0, ("config2", "parity"): -130.0,
             ("config3", "fast"): -100.0, ("config3", "parity"): -100.0,
             ("config4", "fast"): -100.0, ("config4", "parity"): -120.0}
ORACLE_DB = {("config5", "fast"): -115.0, ("config5", "parity"): -120.0,
             ("config2", "fast"): -130.0, ("config2", "parity"): -130.0,
             ("config3", "fast"): -90.0, ("config3", "parity"): -90.0,
             ("config4", "fast"): -90.0, ("config4", "parity"): -90.0}
HANDOFF_DB = -135.0
HANDOFF_FFT_DB = -120.0
SPEC_DB = -100.0
B, T = 2, 4096
POLICIES = ["fast", "parity"]
RENDERED = ["config2", "config3", "config4", "config5"]
#: preset arguments of the renders: config4 with a short IR, so that the
#: per-sample oracle stays quick
KWARGS = {"config4": {"ir_seconds": 0.006}}


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


def _x(seed=0, batch=(B,), length=T):
    return (np.random.default_rng(seed).standard_normal((*batch, 1, length))
            * 0.3).astype(np.float32)


@pytest.fixture(scope="module")
def jax_renders():
    """The JAX package's renders, one compile per preset and policy:
    {(name, policy): (y, aux, state, state after the first half)}."""
    out = {}
    x = _x()
    for name in RENDERED:
        g, _ = jp.PRESETS[name](**KWARGS.get(name, {}))
        for pol in POLICIES:
            with dj.policy(pol):
                cg = dj.compile_graph(g)
                y, aux, st = cg.render(x, batch_shape=(B,))
                _, _, st_half = cg.render(x[..., :T // 2], batch_shape=(B,))
            out[(name, pol)] = jax.tree.map(np.asarray, (y, aux, st,
                                                         st_half))
    return out


def _render_port_graph(g, x, pol, **kw):
    with dt.policy(pol):
        return dt.compile_graph(g, device="cpu").render(x, batch_shape=x.shape[:-2], **kw)


def _render_port(name, x, pol, **kw):
    return _render_port_graph(tp.PRESETS[name](**KWARGS.get(name, {}))[0],
                              x, pol, **kw)


@pytest.mark.parametrize("name", sorted(tp.PRESETS))
def test_preset_json_matches_jax(name):
    """Every preset builds the JAX package's JSON byte for byte, config4
    with its default 1 s stereo IR (48,000 taps a channel)."""
    gt, mt = tp.PRESETS[name]()
    gj, mj = jp.PRESETS[name]()
    assert dt.dumps_graph(gt) == dj.dumps_graph(gj)
    assert mt == mj


@pytest.mark.parametrize("pol", POLICIES)
@pytest.mark.parametrize("name", RENDERED)
def test_render_matches_jax(name, pol, jax_renders):
    yj, auxj, sj, _ = jax_renders[(name, pol)]
    yt, auxt, st = _render_port(name, _x(), pol)
    assert yt.shape == yj.shape
    assert _dbfs(yt.numpy(), yj) <= VS_JAX_DB[(name, pol)]
    assert st.keys() == sj.keys()
    for k, entry in sj.items():
        for kk, w in (entry or {}).items():
            g = st[k][kk]
            g = g.numpy() if isinstance(g, torch.Tensor) else g
            assert np.shape(g) == np.shape(w), (k, kk)
            np.testing.assert_allclose(np.asarray(g, np.float64),
                                       np.asarray(w, np.float64), rtol=0,
                                       atol=2e-5)
    assert auxt.keys() == auxj.keys()


@pytest.mark.parametrize("pol", POLICIES)
def test_config5_aux_matches_jax(pol, jax_renders):
    """The spectrogram sink's columns and the LFO -> drive knob
    writeback."""
    _, auxj, _, _ = jax_renders[("config5", pol)]
    _, auxt, _ = _render_port("config5", _x(), pol)
    _, meta = tp.config5_feedback_16node()
    key = f"spectrogram:{meta['spectrogram']}"
    cols = auxt[key]["columns"]
    assert cols.shape == auxj[key]["columns"].shape
    assert _dbfs(cols.numpy(), auxj[key]["columns"]) <= SPEC_DB
    assert auxt["__knobs__"].keys() == auxj["__knobs__"].keys()
    for k, v in auxj["__knobs__"].items():
        np.testing.assert_allclose(auxt["__knobs__"][k].numpy(), v,
                                   rtol=1e-6, atol=0)


def _config2_oracle(x):
    import oracle
    F32 = np.float32
    h = oracle.fanin_average
    v, _ = oracle.reverb(h([x]), 0.25, 0.45, None)
    v, _, _ = oracle.chorus(h([v]), 0.8, 0.004, 0.012, 0.5)
    return h([(h([v]) * F32(0.9)).astype(F32)])


def _hop(v):
    """One fan-in hop of a single-source port (node.rs:166,190-192)."""
    import oracle
    return oracle.fanin_average([np.asarray(v, np.float32)])


def _config3_oracle(x):
    """The reference shapers (overdrive.rs:31-43, distort.rs Tanh) inside
    the f64 NumPy mirror of the polyphase converters, as
    tests/test_presets.py composes it."""
    import oracle
    v = oracle.oversampled(lambda u: oracle.overdrive(u, 8.0, 0.8, 0.9),
                           _hop(x), 4)
    v = oracle.oversampled(lambda u: oracle.tanh_clip(u, 6.0), _hop(v), 4)
    return [_hop(v)]


def _config4_oracle(x, g, meta):
    """Each channel: the per-sample f64-accumulating VecDeque FIR
    (fir.rs:179-225) between two fan-in hops."""
    import oracle
    return [_hop(oracle.fir(_hop(x), g.nodes[f].params["taps"],
                            mode="Balanced")[0]) for f in meta["firs"]]


@pytest.mark.parametrize("pol", POLICIES)
@pytest.mark.parametrize("name", RENDERED)
def test_render_matches_oracle(name, pol):
    from oracle.graph import evaluate
    x = _x(seed=3)
    y, _, _ = _render_port(name, x, pol)
    gj, mj = jp.PRESETS[name](**KWARGS.get(name, {}))
    for i in range(B):
        if name == "config5":
            wants = [evaluate(gj, {mj["input"]: x[i, 0]}, T)[mj["output"]]]
        elif name == "config3":
            wants = _config3_oracle(x[i, 0])
        elif name == "config4":
            wants = _config4_oracle(x[i, 0], gj, mj)
        else:
            wants = [_config2_oracle(x[i, 0])]
        for j, want in enumerate(wants):
            assert _dbfs(y[i, j].numpy(), want) <= ORACLE_DB[(name, pol)]


@pytest.mark.parametrize("name,pol", [("config5", "fast"),
                                      ("config5", "parity"),
                                      ("config2", "fast"),
                                      ("config4", "fast"),
                                      ("config4", "parity")])
def test_chained_renders_equal_one(name, pol):
    g, _ = tp.PRESETS[name](**KWARGS.get(name, {}))
    x = _x(seed=4)
    with dt.policy(pol):
        cg = dt.compile_graph(g, device="cpu")
        full, _, _ = cg.render(x, batch_shape=(B,))
        a, _, st = cg.render(x[..., :1664], batch_shape=(B,))
        b, _, _ = cg.render(x[..., 1664:], state=st, batch_shape=(B,))
    bound = HANDOFF_FFT_DB if (name, pol) == ("config4", "fast") \
        else HANDOFF_DB
    assert _dbfs(torch.cat([a, b], dim=-1).numpy(), full.numpy()) <= bound


def test_config5_stereo_pair_batching():
    """batch_shape=(2, 2) (stereo pairs of streams) matches the flat
    batch of 4."""
    x = _x(seed=5, batch=(2, 2), length=1024)
    pair, _, st = _render_port("config5", x, "fast")
    flat, _, _ = _render_port("config5", x.reshape(4, 1, 1024), "fast")
    assert pair.shape == (2, 2, 1, 1024)
    np.testing.assert_array_equal(pair.reshape(4, 1, 1024).numpy(),
                                  flat.numpy())
    cyc = next(v for k, v in st.items() if k.startswith("__cycle__"))
    assert all(v.shape == (2, 2, 128) for v in cyc.values())


@pytest.mark.parametrize("pol", POLICIES)
def test_config5_state_from_jax(pol, jax_renders):
    """The JAX package renders the first half of config5, its state
    (cycle registers, reverb ring, chorus hist and clock, envelope, the
    LFO clock) crosses with convert.state_from_jax, and the port renders
    the second half: together the JAX full render."""
    yj, _, _, sj_half = jax_renders[("config5", pol)]
    st = convert.state_from_jax(sj_half, "cpu")
    _, meta = tp.config5_feedback_16node()
    assert isinstance(st[str(meta["input"] + 10)]["t0"], int)   # chorus
    y2, _, st2 = _render_port("config5", _x()[..., T // 2:], pol, state=st)
    assert _dbfs(y2.numpy(), yj[..., T // 2:]) <= VS_JAX_DB[("config5", pol)]
    back = convert.state_to_numpy(st2)
    assert back.keys() == sj_half.keys()


@pytest.mark.parametrize("pol", POLICIES)
def test_config4_state_from_jax(pol, jax_renders):
    """The JAX package renders the first half of config4; its FIR states
    (hist, first: f64 arrays holding f32 values; n_seen an int32 scalar)
    cross with convert.state_from_jax and the port renders the second
    half: together the JAX full render."""
    yj, _, _, sj_half = jax_renders[("config4", pol)]
    st = convert.state_from_jax(sj_half, "cpu")
    _, meta = tp.config4_convolution_reverb(**KWARGS["config4"])
    for f in meta["firs"]:
        assert st[str(f)]["n_seen"] == T // 2
        assert tuple(st[str(f)]["hist"].shape) == (B, 287)
    y2, _, st2 = _render_port("config4", _x()[..., T // 2:], pol, state=st)
    assert _dbfs(y2.numpy(), yj[..., T // 2:]) <= VS_JAX_DB[("config4", pol)]
    assert convert.state_to_numpy(st2).keys() == sj_half.keys()


@pytest.mark.parametrize("pol", POLICIES)
def test_config3_chained_matches_jax_chained(pol):
    """The oversampler is stateless across renders (each call pads its
    windows with zeros; the shaper nodes return no state), in the JAX
    package as in the port: two chained renders differ from one near the
    boundary. The port's chained render is pinned to the JAX package's."""
    x = _x(seed=7)
    half = 1664
    parts = {}
    for pkg, presets in (("jax", jp), ("port", tp)):
        g, _ = presets.config3_oversampled_distortion()
        if pkg == "jax":
            with dj.policy(pol):
                cg = dj.compile_graph(g)
                a, _, st = cg.render(x[..., :half], batch_shape=(B,))
                b, _, _ = cg.render(x[..., half:], state=st,
                                    batch_shape=(B,))
                full, _, _ = cg.render(x, batch_shape=(B,))
            parts[pkg] = [np.asarray(v) for v in (a, b, full)]
        else:
            with dt.policy(pol):
                cg = dt.compile_graph(g, device="cpu")
                a, _, st = cg.render(x[..., :half], batch_shape=(B,))
                b, _, _ = cg.render(x[..., half:], state=st,
                                    batch_shape=(B,))
                full, _, _ = cg.render(x, batch_shape=(B,))
            parts[pkg] = [v.numpy() for v in (a, b, full)]
    chained = {k: np.concatenate(v[:2], axis=-1) for k, v in parts.items()}
    assert _dbfs(chained["port"], chained["jax"]) <= VS_JAX_DB[("config3",
                                                                 pol)]
    # both differ from their one render near the boundary; elsewhere only
    # by the matrix products' rounding at another length
    for k, (a, b, full) in parts.items():
        d = np.abs(chained[k] - full).max(axis=(0, 1))
        assert d[half - 64:half + 64].max() > 1e-4, k
        assert max(d[:half - 64].max(), d[half + 64:].max()) <= 1e-6, k


@pytest.mark.parametrize("pol", POLICIES)
@pytest.mark.parametrize("mode", ["Sine", "Triangle", "Square", "Constant"])
def test_oscillator_matches_jax_and_oracle(mode, pol):
    """signal_gen's block-wrapped phase clock and square-wave quirk
    (ops/gen.py), from a carried clock and with a modulated frequency.
    Under parity the port equals the oracle's per-sample loop bit for bit;
    under fast the clock is an f64 cumulative sum (<= -110 dBFS, measured
    -114.4).  Against JAX <= -115 (measured -117.0): XLA turns the step
    f / 48000 into a multiply by the reciprocal."""
    import oracle
    from dsp_stuff_tpu.ops.gen import oscillator as josc
    from dsp_stuff_tpu_torch.ops.gen import oscillator as tosc
    n = 2048
    freq = (300.0 + 200.0 * np.sin(np.arange(n) / 300.0)).astype(np.float32)
    with dj.policy(pol):
        yj, _ = jax.jit(lambda f: josc(mode, 0.7, f, n, 0.25))(freq)
    with dt.policy(pol):
        yt, ct = tosc(mode, 0.7, torch.from_numpy(freq), n,
                      torch.tensor(0.25))
    assert _dbfs(yt.numpy(), np.asarray(yj)) <= -115.0
    want, wclock = oracle.signal_gen(mode, 0.7, freq, n, np.float32(0.25))
    if pol == "parity":
        np.testing.assert_array_equal(yt.numpy(), want)
    else:
        assert _dbfs(yt.numpy(), want) <= -110.0
    if mode != "Constant":      # a constant leaves the clock where it was
        assert abs(float(ct) - float(wclock)) <= (0.0 if pol == "parity"
                                                  else 2e-7)


def test_wave_view_sink_matches_jax():
    """A wave_view sink on a mid-graph signal returns that signal under
    aux["wave_view:<id>"], as the JAX package's does."""
    from dsp_stuff_tpu.ids import IdSpace as JIdSpace
    from dsp_stuff_tpu_torch.ids import IdSpace as TIdSpace
    gj = dj.Graph(JIdSpace())
    inp = gj.add("input")
    lp = gj.add("low_pass", ratio=0.3)
    wv = gj.add("wave_view")
    out = gj.add("output")
    gj.chain(inp, lp, out)
    gj.connect(lp, "out", wv, "in")
    gt = dt.loads_graph(dj.dumps_graph(gj), ids=TIdSpace())
    x = _x(seed=6, length=1024)
    with dj.policy("parity"):
        _, auxj, _ = dj.compile_graph(gj).render(x, batch_shape=(B,))
    _, auxt, _ = _render_port_graph(gt, x, "parity")
    key = f"wave_view:{wv.id}"
    assert auxt.keys() == auxj.keys() == {key}
    np.testing.assert_allclose(auxt[key]["samples"].numpy(),
                               np.asarray(auxj[key]["samples"]), rtol=0,
                               atol=1e-6)
