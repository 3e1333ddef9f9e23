"""The JAX package's public names that the port carries too, each held
against the JAX package on the same seeded inputs: the root exports
(``GraphNode``, ``register_node``, ``NodeSpec``) with a node type
registered from the root, ``compile.apply_knob_writeback`` and
``compile.CYCLE_FUSION``, ``WaveView.sweeps``, ``Spectrogram.frequencies``
and ``Spectrogram.window``, and ``cascade.one_pole_pair``.

Bounds: one_pole_pair against the NumPy oracle <= -100 dBFS and its
carried states within 1e-6 (tests/test_cascade.py's CPU bounds), against
the JAX package <= -100 dBFS, a split at a block boundary against the
one-shot solve <= -120 dBFS; the knob writeback, the sweeps, the
frequency grid and the deque view are equal to the JAX package's.
"""

import numpy as np
import pytest
import torch

import dsp_stuff_tpu as dj
import dsp_stuff_tpu_torch as dt
from dsp_stuff_tpu.compiler import compile as jcompile
from dsp_stuff_tpu.ids import IdSpace as JIdSpace
from dsp_stuff_tpu.nodes import analysis as janalysis
from dsp_stuff_tpu.ops import cascade as jcascade
from dsp_stuff_tpu.utils import precision as jprec
from dsp_stuff_tpu_torch.compiler import compile as tcompile
from dsp_stuff_tpu_torch.ids import IdSpace as TIdSpace
from dsp_stuff_tpu_torch.nodes import analysis as tanalysis
from dsp_stuff_tpu_torch.ops import cascade as tcascade
from dsp_stuff_tpu_torch.utils import precision as tprec

import oracle

ORACLE_DB = -100.0
VS_JAX_DB = -100.0
SPLIT_DB = -120.0
STATE_ATOL = 1e-6
T = 19968      # 156 blocks, as tests/test_cascade.py


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


def _sig(n, seed=0):
    return (np.random.default_rng(seed).standard_normal(n) * 0.3
            ).astype(np.float32)


# -- the root exports --------------------------------------------------------

def test_root_exports_cover_the_jax_package():
    """Every name of the JAX package's ``__all__`` is in the port's, and
    the three the port once left out are its own classes."""
    from dsp_stuff_tpu_torch import graph, registry
    assert set(dj.__all__) <= set(dt.__all__)
    assert dt.GraphNode is graph.GraphNode
    assert dt.register_node is registry.register_node
    assert dt.NodeSpec is registry.NodeSpec
    assert all(hasattr(dt, name) for name in dt.__all__)


def _halver(pkg):
    """A node type ``test_halver`` (y = level * x / 2) registered through
    ``pkg``'s root."""
    @pkg.register_node(title="Test halver", cfg_name="test_halver",
                       inputs=("in",), outputs=("out",),
                       params=(pkg.registry.ParamSpec("level", 0.0, 4.0,
                                                      1.0),))
    class Halver:
        @staticmethod
        def process_seq(params, state, inputs):
            return {"out": inputs["in"] * (0.5 * params["level"])}, state
    return Halver


def test_register_node_from_the_root(monkeypatch):
    """A node type registered from either package's root renders, saves
    and loads; both packages give the same JSON and the same samples."""
    for pkg in (dj, dt):
        reg = pkg.REGISTRY
        monkeypatch.setattr(reg, "_by_cfg", dict(reg._by_cfg))
        monkeypatch.setattr(reg, "_by_title", dict(reg._by_title))
    _halver(dj)
    _halver(dt)
    assert isinstance(dt.REGISTRY.by_cfg_name("test_halver"), dt.NodeSpec)
    x = _sig(1024, seed=7)
    outs = {}
    for pkg, ids, kw in ((dj, JIdSpace(), {}), (dt, TIdSpace(),
                                               {"device": "cpu"})):
        g = pkg.Graph(ids)
        inp, hv, out = (g.add("input"), g.add("test_halver", level=1.5),
                        g.add("output"))
        g.chain(inp, hv, out)
        assert isinstance(g.nodes[hv.id], pkg.GraphNode)
        text = pkg.dumps_graph(g)
        g2 = pkg.loads_graph(text, ids=type(ids)())
        y, _, _ = pkg.render(g2, {str(inp.id): x}, **kw)
        outs[pkg.__name__] = (text, np.asarray(y))
    (tj, yj), (tt, yt) = outs["dsp_stuff_tpu"], outs["dsp_stuff_tpu_torch"]
    assert tt == tj
    np.testing.assert_array_equal(yt, yj)
    # two fan-in averages (/ 1.0001 each) on the way
    np.testing.assert_allclose(yt[0], x * np.float32(0.75), rtol=3e-4)


# -- compile.apply_knob_writeback and CYCLE_FUSION ---------------------------

def _knob_graph(pkg, ids):
    """tests/test_graph.py:373's graph: a constant 0.5 modulates a gain's
    level, mapped over [0, 10]."""
    g = pkg.Graph(ids)
    sg = g.add("signal_gen", mode="Constant", amplitude=0.5)
    gn = g.add("gain", level=1.0)
    inp = g.add("input")
    out = g.add("output")
    g.connect(inp, "out", gn, "in")
    g.connect(sg, "out", gn, "level")
    g.connect(gn, "out", out, "in")
    return g, gn, inp


@pytest.mark.parametrize("pol", ["fast", "parity"])
def test_knob_writeback_matches_jax(pol, tmp_path):
    """Quirk 2.4 #9: after a render the knob holds the mapped value of the
    last block's first sample, ((0.49995 + 1) / 2) * 10 = 7.49975; the
    writeback puts it into the graph as a float, as the JAX package's
    does, and a save / load keeps it."""
    x = np.ones(256, np.float32)
    gj, gnj, inpj = _knob_graph(dj, JIdSpace())
    gt, gnt, inpt = _knob_graph(dt, TIdSpace())
    with jprec.policy(pol):
        _, auxj, _ = dj.render(gj, {str(inpj.id): x})
    with dt.policy(pol):
        _, auxt, _ = dt.render(gt, {str(inpt.id): x}, device="cpu")
    key = f"{gnt.id}:level"
    knob = float(np.asarray(auxj["__knobs__"][key]))
    assert abs(float(auxt["__knobs__"][key]) - 7.49975) < 1e-3
    assert float(auxt["__knobs__"][key]) == knob
    assert tcompile.apply_knob_writeback(gt, auxt) is gt
    jcompile.apply_knob_writeback(gj, auxj)
    level = gt.nodes[gnt.id].params["level"]
    assert type(level) is float and level == gj.nodes[gnj.id].params["level"]
    assert dt.dumps_graph(gt) == dj.dumps_graph(gj)
    path = tmp_path / "knob.json"
    dt.save_graph(gt, str(path))
    back = dt.load_graph(str(path), ids=TIdSpace())
    assert back.nodes[gnt.id].params["level"] == level


def test_knob_writeback_batched_takes_the_last_stream():
    """A batched render's knob is one value a stream; the writeback keeps
    the last, as the JAX package's ``ravel()[-1]`` does."""
    x = np.stack([np.ones(256, np.float32)] * 3)
    gj, gnj, inpj = _knob_graph(dj, JIdSpace())
    gt, gnt, inpt = _knob_graph(dt, TIdSpace())
    _, auxj, _ = dj.compile_graph(gj).render({str(inpj.id): x},
                                             batch_shape=(3,))
    _, auxt, _ = dt.compile_graph(gt, device="cpu").render(
        {str(inpt.id): torch.from_numpy(x)}, batch_shape=(3,))
    assert tuple(auxt["__knobs__"][f"{gnt.id}:level"].shape) == (3,)
    jcompile.apply_knob_writeback(gj, auxj)
    tcompile.apply_knob_writeback(gt, auxt)
    assert (gt.nodes[gnt.id].params["level"]
            == gj.nodes[gnj.id].params["level"])


def test_cycle_fusion_switch():
    """``CYCLE_FUSION`` defaults on in both packages."""
    assert tcompile.CYCLE_FUSION is True
    assert jcompile.CYCLE_FUSION is True


# -- the analysis sinks' host views ------------------------------------------

@pytest.mark.parametrize("fps", [60.0, 10.0, 144.0])
def test_wave_view_sweeps_match_jax(fps):
    """tests/test_analysis.py:152: the decimated oscilloscope settles to
    the production a frame, draws samples in order and, at a frame rate
    too slow for the 4096 ring, drops whole blocks; the port's sweeps are
    the JAX package's, frame for frame."""
    x = np.arange(48_000, dtype=np.float32)
    got = tanalysis.WaveView.sweeps(torch.from_numpy(x), fps=fps)
    want = janalysis.WaveView.sweeps(x, fps=fps)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    drawn = np.concatenate([s for s in got if len(s)])
    assert np.all(np.diff(drawn) > 0)
    if fps == 60.0:
        assert all(700 <= len(s) <= 900 for s in got[40:50])
        assert drawn.size > 0.95 * x.size
    if fps == 10.0:
        assert drawn.size < 0.95 * x.size


@pytest.mark.parametrize("fft_size,lo,hi", [(512, 20, 20_000),
                                            (1024, 50, 8_000),
                                            (256, 20, 24_000)])
def test_spectrogram_frequencies_match_jax(fft_size, lo, hi):
    params = {"fft_size": fft_size, "buffer_size": 250, "lower_bound": lo,
              "upper_bound": hi}
    got = tanalysis.Spectrogram.frequencies(params)
    want = janalysis.Spectrogram.frequencies(params)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, np.asarray(want))
    assert np.all(np.diff(got) > 0)


@pytest.mark.parametrize("as_tensor", [False, True])
def test_spectrogram_window_deque_semantics(as_tensor):
    """tests/test_analysis.py:84: after tick e the UI sees columns
    [max(0, e - n):e]; the port's view is the JAX package's, on an array
    or a tensor."""
    cols = np.arange(20, dtype=np.float32)[:, None] * np.ones(5, np.float32)
    src = torch.from_numpy(cols) if as_tensor else cols
    view = tanalysis.Spectrogram.window
    w = np.asarray(view(src, {"buffer_size": 8}, 12))
    np.testing.assert_array_equal(w[:, 0], np.arange(4, 12, dtype=np.float32))
    w = np.asarray(view(src, {"buffer_size": 8}, 3))
    np.testing.assert_array_equal(w[:, 0], np.arange(3, dtype=np.float32))
    assert view(src, {"buffer_size": 0}, 12).shape[0] == 0
    for n, end in ((8, 12), (8, 3), (0, 12), (30, 25), (5, -1)):
        np.testing.assert_array_equal(
            np.asarray(view(src, {"buffer_size": n}, end)),
            np.asarray(janalysis.Spectrogram.window(cols, {"buffer_size": n},
                                                    end)))


# -- cascade.one_pole_pair ---------------------------------------------------

COMBOS = [("lp", "hp", 0.6, 0.2), ("hp", "lp", 0.3, 0.9),
          ("lp", "lp", 0.5, 0.5), ("hp", "hp", 0.97, 0.97)]


def _oracle_section(kind, r, v, z=np.float32(0.0)):
    if kind == "lp":
        return oracle.low_pass(v, r, z)
    return oracle.high_pass(v, r, z)


@pytest.mark.parametrize("k1,k2,r1,r2", COMBOS)
def test_one_pole_pair_vs_oracle_and_jax(k1, k2, r1, r2):
    """tests/test_cascade.py:45: the fused pair against the two oracle
    sections in series, and against the JAX package's pair."""
    x = _sig(T)
    with tprec.policy("fast"):
        y, z1, z2 = tcascade.one_pole_pair(torch.from_numpy(x), k1, r1, k2,
                                           r2, 1.0, 0.0, 0.0)
    with jprec.policy("fast"):
        yj, z1j, z2j = jcascade.one_pole_pair(x, k1, r1, k2, r2, 1.0, 0.0,
                                              0.0)
    o1, zw1 = _oracle_section(k1, r1, x)
    want, zw2 = _oracle_section(k2, r2, o1)
    assert _dbfs(y.numpy(), want) <= ORACLE_DB
    assert abs(float(z1) - float(zw1)) < STATE_ATOL
    assert abs(float(z2) - float(zw2)) < STATE_ATOL
    assert _dbfs(y.numpy(), np.asarray(yj)) <= VS_JAX_DB
    assert abs(float(z1) - float(z1j)) < STATE_ATOL
    assert abs(float(z2) - float(z2j)) < STATE_ATOL


@pytest.mark.parametrize("k1,k2,r1,r2", COMBOS[:2])
def test_one_pole_pair_state_carry(k1, k2, r1, r2):
    """tests/test_cascade.py:56: two chained solves (split mid-chunk)
    equal the one-shot solve: the carried (z1, z2) are the nodes' true
    one-pole states; a batch of two streams carries its own states."""
    x = np.stack([_sig(T, seed=3), _sig(T, seed=4)])
    cut = 7 * 128 + 37
    xt = torch.from_numpy(x)
    with tprec.policy("fast"):
        y_full, _, _ = tcascade.one_pole_pair(xt, k1, r1, k2, r2, 1.0,
                                              0.0, 0.0)
        y1, z1, z2 = tcascade.one_pole_pair(xt[:, :cut], k1, r1, k2, r2,
                                            1.0, 0.0, 0.0)
        y2, _, _ = tcascade.one_pole_pair(xt[:, cut:], k1, r1, k2, r2, 1.0,
                                          z1, z2)
    assert tuple(z1.shape) == tuple(z2.shape) == (2,)
    got = torch.cat([y1, y2], dim=-1).numpy()
    assert _dbfs(got, y_full.numpy()) <= SPLIT_DB


def test_one_pole_pair_state_carry_block_boundary_split():
    """tests/test_cascade.py:486: a segment of K * 128 + 1 samples (the
    composite state's i_last == 0 branch)."""
    x = torch.from_numpy(_sig(1024, seed=41))
    cut = 2 * 128 + 1
    with tprec.policy("fast"):
        y_full, _, _ = tcascade.one_pole_pair(x, "lp", 0.6, "hp", 0.2, 1.0,
                                              0.0, 0.0)
        y1, z1, z2 = tcascade.one_pole_pair(x[:cut], "lp", 0.6, "hp", 0.2,
                                            1.0, 0.0, 0.0)
        y2, _, _ = tcascade.one_pole_pair(x[cut:], "lp", 0.6, "hp", 0.2,
                                          1.0, z1, z2)
    got = torch.cat([y1, y2]).numpy()
    assert _dbfs(got, y_full.numpy()) <= SPLIT_DB
