"""The port's chain segment (dsp_stuff_tpu_torch/ops/chain_segment.py) and
the CPU-side half of its CUDA kernel (ops/chain_kernel.py).

The CUDA kernel itself runs only on a GPU (chip_smoke.py holds it against
``segment_fallback`` there).  Here:

(a) the port's ``segment_fallback`` against the JAX package's composition;
(b) the JAX package's Pallas kernel in interpret mode, run as its own
    tests run it, against the port's CPU chain segment, through both
    compilers;
(c) the JAX kernel's raw outputs fed into the port's ``rebuild_states``:
    the CUDA kernel writes the same raw layout, so this pins the layout
    the port rebuilds node states from;
plus the wrapper's constants, shaper codes and refusals.

Bounds (dBFS = 20 log10(max|err| / max|reference|)): y and taps <= -125,
states atol 1e-6, all f32 rounding noise between lowerings (measured on
the CPU: -132 dBFS and 2.4e-7 at worst)."""

import functools
import pathlib
import re

import jax
import numpy as np
import pytest
import torch

import dsp_stuff_tpu as dj
import dsp_stuff_tpu_torch as dt
from dsp_stuff_tpu.ids import IdSpace as JIdSpace
from dsp_stuff_tpu.ops import chain_segment as jcs
from dsp_stuff_tpu.ops import pallas_chain as jpc
from dsp_stuff_tpu.utils import precision as jprec
from dsp_stuff_tpu_torch.ids import IdSpace as TIdSpace
from dsp_stuff_tpu_torch.ops import chain_kernel as tck
from dsp_stuff_tpu_torch.ops import chain_segment as tcs
from dsp_stuff_tpu_torch.ops import shaping as tshaping
from dsp_stuff_tpu_torch.ops.cascade import _embed_dim, composite_dim
from dsp_stuff_tpu_torch.utils import precision as tprec

Y_DB = -125.0
STATE_ATOL = 1e-6

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
STAGE_LISTS = {"bench": BENCH_STAGES, "taps_d192": TAP_STAGES}


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


def _inputs(stages, B, T, seed):
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
    return x, tuple(st)


def _port_fallback(stages, x, st):
    with tprec.policy("fast"):
        return tcs.segment_fallback(torch.from_numpy(x), stages,
                                    tuple(torch.from_numpy(s) for s in st))


def _compare_segment(got, want):
    """(y, cinfos, hists, taps) of the port against a reference's."""
    y, cinfos, hists, taps = got
    assert _dbfs(y.numpy(), want[0]) <= Y_DB
    assert len(cinfos) == len(want[1]) and len(hists) == len(want[2])
    for gi, wi in zip(cinfos, want[1]):
        for g, w in zip(gi, wi):
            _close(g.numpy(), w)
    for g, w in zip(hists, want[2]):
        _close(g.numpy(), w)
    assert len(taps) == len(want[3])
    for g, w in zip(taps, want[3]):
        assert _dbfs(g.numpy(), w) <= Y_DB


@pytest.mark.parametrize("name", sorted(STAGE_LISTS))
def test_fallback_matches_jax_composition(name):
    """(a): segment_fallback against the JAX chain_segment's CPU
    composition on the same inputs."""
    stages = STAGE_LISTS[name]
    x, st = _inputs(stages, 4, 4096, 1)
    with jprec.policy("fast"):
        want = jax.tree.map(np.asarray, jax.jit(
            lambda xx, ss: jcs.chain_segment(xx, stages, ss))(x, st))
    _compare_segment(_port_fallback(stages, x, st), want)


def _bench_graph(pkg, ids):
    g = pkg.Graph(ids)
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
    return g


def test_jax_interpret_kernel_render_matches_port(monkeypatch):
    """(b): the JAX render through its Pallas kernel in interpret mode
    (dispatch forced as tests/test_chain_segment.py does) against the
    port's render on the CPU, B = 64, T = 2560, states included."""
    B, T = 64, 2560
    gj = _bench_graph(dj, JIdSpace())
    gt = dt.loads_graph(dj.dumps_graph(gj), ids=TIdSpace())
    x = (np.random.default_rng(2).standard_normal((B, 1, T)) * 0.3
         ).astype(np.float32)

    calls = []
    real_call = functools.partial(jpc.chain_kernel_call, interpret=True)

    def counted(*a, **k):
        calls.append(1)
        return real_call(*a, **k)

    monkeypatch.setattr(jcs, "_use_kernel", lambda B, T, stages: True)
    monkeypatch.setattr(jpc, "chain_kernel_call", counted)
    jcs._segment_core.cache_clear()
    jcs._segment_vjp.cache_clear()
    try:
        with jprec.policy("fast"):
            cg = dj.compile_graph(gj)
            yj, _, sj = cg.render(x, batch_shape=(B,))
            yj = np.asarray(yj)
            sj = jax.tree.map(np.asarray, sj)
    finally:
        jcs._segment_core.cache_clear()
        jcs._segment_vjp.cache_clear()
    assert calls, "the JAX render did not reach the Pallas kernel"

    with tprec.policy("fast"):
        yt, _, st = dt.compile_graph(gt, device="cpu").render(x, batch_shape=(B,))
    assert _dbfs(yt.numpy(), yj) <= Y_DB
    assert sj.keys() == st.keys()
    for k in sj:
        for kk, w in (sj[k] or {}).items():
            g = st[k][kk]
            _close(g.numpy() if isinstance(g, torch.Tensor) else g, w)


@pytest.mark.parametrize("name", sorted(STAGE_LISTS))
def test_rebuild_states_from_jax_kernel_raw_outputs(name):
    """(c): the JAX interpret kernel's raw outputs (per cascade the carry
    entering the last block and that block's input; per comb the [B, NR,
    128] ring) rebuilt by the port equal the port's fallback states."""
    stages = STAGE_LISTS[name]
    B, T = 64, 2560
    x, st = _inputs(stages, B, T, 3)
    with jprec.policy("fast"):
        y, casc_raw, ring_raw, taps = jax.tree.map(
            np.array, jpc.chain_kernel_call(x, stages, st, interpret=True))
    cinfos, hists = tcs.rebuild_states(
        stages, T,
        tuple((torch.from_numpy(c), torch.from_numpy(xl))
              for c, xl in casc_raw),
        tuple(torch.from_numpy(r) for r in ring_raw))
    ref = _port_fallback(stages, x, st)
    assert _dbfs(y, ref[0].numpy()) <= Y_DB
    for g, w in zip(taps, ref[3]):
        assert _dbfs(g, w.numpy()) <= Y_DB
    assert len(cinfos) == len(ref[1]) and len(hists) == len(ref[2])
    for gi, wi in zip(cinfos, ref[1]):
        for g, w in zip(gi, wi):
            _close(g.numpy(), w.numpy())
    for g, w in zip(hists, ref[2]):
        _close(g.numpy(), w.numpy())


@pytest.mark.parametrize("sections", [BENCH_STAGES[0][1], BENCH_STAGES[3][1],
                                      TAP_STAGES[3][1]])
def test_kernel_constants_match_jax(sections):
    """The port's kernel constants are the JAX kernel's, bit for bit."""
    got = tck._casc_consts(sections)
    want = jpc._casc_consts(sections)
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(g, w)
    assert got[4] == want[4]


def test_shaper_codes_match_cuda_source():
    """EW_CODES covers every elementwise kind and follows the EW_* codes
    of csrc/stages.cuh, the shaper code the chain and cycle kernels
    share."""
    kinds = {"overdrive", "chebyshev"} | {f"distort:{m}"
                                         for m in tshaping.DISTORT_MODES}
    assert set(tck.EW_CODES) == kinds
    src = (pathlib.Path(tck.__file__).parent.parent / "csrc"
           / "stages.cuh").read_text()
    defs = dict((int(n), name) for name, n in
                re.findall(r"#define EW_(\w+) (\d+)", src))
    assert len(defs) == len(tck.EW_CODES)
    for code, kind in enumerate(tck.EW_CODES):
        assert defs[code] == kind.split(":")[-1].upper(), (code, kind)


def test_kernel_wrapper_refuses_cpu_tensors():
    """No fallback inside the wrapper: a CPU tensor is refused, and the
    launch count does not move."""
    x, st = _inputs(BENCH_STAGES, 2, 256, 4)
    before = tck.LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        tck.chain_kernel_call(torch.from_numpy(x), BENCH_STAGES,
                              tuple(torch.from_numpy(s) for s in st))
    assert tck.LAUNCHES == before


def test_mtap_stage_not_ported():
    """The mtap stage is ported: the plain composition runs it, and the
    kernel wrapper takes the stage kind but refuses a CPU tensor (and an
    unknown stage kind) before anything launches."""
    stages = (("mtap", 0.5, 700, 6, 3, 200),)
    x = torch.zeros((2, 256))
    before = tck.LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        tck.chain_kernel_call(x, stages, ())
    with pytest.raises(ValueError, match="unknown stage"):
        tck.chain_kernel_call(x, (("ntap",),), ())
    assert tck.LAUNCHES == before
    q = torch.full((2,), 40, dtype=torch.int32)
    r = torch.zeros((256,), dtype=torch.int32)
    y, _, hists, _ = tcs.segment_fallback(
        x + 1.0, stages, (torch.zeros(700), q, r, torch.zeros(256)))
    assert y.shape == (2, 256) and hists[0].shape == (2, 700)


@pytest.mark.parametrize("batch", [(), (2, 3)])
def test_kernel_path_batch_layout(batch, monkeypatch):
    """The kernel path's glue: leading dimensions flatten into kernel rows,
    unbatched states broadcast to them, and every output gets its
    dimensions back.  The JAX interpret kernel (same raw layout) stands in
    for the CUDA kernel."""
    stages = TAP_STAGES
    T = 512
    x, st = _inputs(stages, 1, T, 6)
    rows = int(np.prod(batch, dtype=np.int64))
    xb = (x[0] * np.linspace(0.5, 1.5, rows, dtype=np.float32)[:, None]
          ).reshape(*batch, T)
    states = tuple(torch.from_numpy(s[0]) for s in st)      # unbatched

    def stand_in(xk, stg, sts):
        assert xk.shape == (rows, T) and all(s.shape[0] == rows for s in sts)
        with jprec.policy("fast"):
            out = jax.tree.map(np.array, jpc.chain_kernel_call(
                xk.numpy(), stg, tuple(s.numpy() for s in sts),
                interpret=True))
        return jax.tree.map(torch.from_numpy, out)

    monkeypatch.setattr(tck, "chain_kernel_call", stand_in)
    got = tcs._kernel_segment(torch.from_numpy(xb), stages, states)
    with tprec.policy("fast"):
        want = tcs.segment_fallback(torch.from_numpy(xb), stages, states)
    assert got[0].shape == (*batch, T)
    for g, w in zip(got[1], want[1]):
        for a, b in zip(g, w):
            assert a.shape == b.shape
    for a, b in zip(got[2], want[2]):
        assert a.shape == b.shape == (*batch, 192)
    assert [t.shape for t in got[3]] == [(*batch, T)] * 2
    _compare_segment(got, jax.tree.map(lambda t: t.numpy(), want))


def test_chain_segment_dispatches_cpu_to_fallback():
    """A CPU tensor takes segment_fallback; leading batch dimensions and
    unbatched states broadcast."""
    x, st = _inputs(BENCH_STAGES, 3, 1024, 5)
    before = tck.LAUNCHES
    xb = torch.from_numpy(x).reshape(3, 1, 1024)
    sb = tuple(torch.from_numpy(s[0]) for s in st)       # unbatched states
    with tprec.policy("fast"):
        got = tcs.chain_segment(xb, BENCH_STAGES, sb)
        want = tcs.segment_fallback(xb, BENCH_STAGES, sb)
    assert tck.LAUNCHES == before
    assert got[0].shape == (3, 1, 1024)
    np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())
