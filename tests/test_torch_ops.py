"""The port's ops (dsp_stuff_tpu_torch/ops) against the JAX package's on the
same seeded NumPy inputs, under both ported precision policies.

The JAX ops run inside ``jax.jit`` with their coefficients closed over as
Python floats -- the way the compiler calls them -- so they take their
trace-time-constant lowerings.  Error bounds (dBFS = 20 log10(max|err| /
max|JAX|)): fast <= -125, parity <= -130; states atol 1e-6.  The two
packages run the same algorithms in float32 (fast) or float64 (parity)
with other summation orders, so the gap is rounding noise: measured on
the CPU at worst -132 dBFS (fast), -137 dBFS (parity) and 1.2e-7 for
states, which these bounds keep with ~7 dB of margin."""

import jax
import numpy as np
import pytest
import torch

from dsp_stuff_tpu.ops import cascade as jcasc
from dsp_stuff_tpu.ops import delay_line as jdelay
from dsp_stuff_tpu.ops import scan as jscan
from dsp_stuff_tpu.ops import shaping as jshaping
from dsp_stuff_tpu.utils import precision as jprec
from dsp_stuff_tpu_torch.ops import cascade as tcasc
from dsp_stuff_tpu_torch.ops import delay_line as tdelay
from dsp_stuff_tpu_torch.ops import scan as tscan
from dsp_stuff_tpu_torch.ops import shaping as tshaping
from dsp_stuff_tpu_torch.utils import precision as tprec

BOUND_DB = {"fast": -125.0, "parity": -130.0}
STATE_ATOL = 1e-6
POLICIES = ["fast", "parity"]


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


def _assert_db(got, want, pol):
    d = _dbfs(got, want)
    assert d <= BOUND_DB[pol], d


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _assert_state(got, want):
    np.testing.assert_allclose(np.asarray(_np(got), np.float64),
                               np.asarray(want, np.float64),
                               rtol=0, atol=STATE_ATOL)


def _run_both(pol, jfn, tfn, *args):
    """jfn under jax.jit and tfn on torch tensors, both under ``pol``."""
    with jprec.policy(pol):
        want = jax.jit(jfn)(*args)
        want = jax.tree.map(np.asarray, want)
    with tprec.policy(pol):
        got = tfn(*(torch.from_numpy(np.asarray(a)) for a in args))
    return got, want


def _signal(seed, shape=(3, 1024), scale=0.5):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


SHAPERS = {
    **{f"distort:{m}": (lambda mod, m=m: lambda v: mod.DISTORT_MODES[m](
        v, 2.5)) for m in jshaping.DISTORT_MODES},
    "overdrive": lambda mod: lambda v: mod.overdrive(v, 4.0, 0.6, 0.9),
    "chebyshev": lambda mod: lambda v: mod.chebyshev_asym(v, 2.0, 4.0),
}


@pytest.mark.parametrize("pol", POLICIES)
@pytest.mark.parametrize("kind", sorted(SHAPERS))
def test_shaper(kind, pol):
    x = _signal(1)
    got, want = _run_both(pol, SHAPERS[kind](jshaping),
                          SHAPERS[kind](tshaping), x)
    _assert_db(_np(got), want, pol)


@pytest.mark.parametrize("pol", POLICIES)
def test_shaper_bypass_and_modulated_level(pol):
    """level < 0.001 returns the input; a per-sample level tensor selects
    per sample."""
    x = _signal(2)
    level = np.where(np.arange(x.shape[-1]) % 3 == 0, 0.0, 3.0
                     ).astype(np.float32) * np.ones_like(x)
    for name in ("SoftClip", "Tanh", "Atan", "HardClip"):
        got, want = _run_both(
            pol, lambda v, l, n=name: jshaping.DISTORT_MODES[n](v, l),
            lambda v, l, n=name: tshaping.DISTORT_MODES[n](v, l), x, level)
        _assert_db(_np(got), want, pol)
        np.testing.assert_array_equal(_np(got)[..., ::3], x[..., ::3])


@pytest.mark.parametrize("pol", POLICIES)
def test_fuzz_nan_on_silent_block(pol):
    """An all-zero 128-block normalizes 0/0: NaN in both packages (the
    reference's quirk), finite elsewhere."""
    x = _signal(3, (2, 512))
    x[:, 128:256] = 0.0
    got, want = _run_both(pol, lambda v: jshaping.fuzz(v, 2.0, 128),
                          lambda v: tshaping.fuzz(v, 2.0, 128), x)
    got = _np(got)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[:, 128:256]).all()
    ok = ~np.isnan(want)
    _assert_db(got[ok], want[ok], pol)


@pytest.mark.parametrize("pol", POLICIES)
@pytest.mark.parametrize("a", [0.6, -0.5, 0.97, 0.2])
def test_first_order_affine(a, pol):
    b = _signal(4, (3, 4096), 0.3)
    y0 = np.array([0.1, -0.2, 0.3], np.float32)
    got, want = _run_both(pol, lambda bb, yy: jscan.first_order_affine(a, bb, yy),
                          lambda bb, yy: tscan.first_order_affine(a, bb, yy),
                          b, y0)
    _assert_db(_np(got), want, pol)


BIQUADS = {
    "general": (-0.3, 0.05, 0.8, 0.1, -0.05),
    "resonant": (-1.6, 0.8, 0.05, 0.1, 0.05),
    "degenerate": (-0.24, 0.0, 0.758, 0.0, 0.0),
    "pure_fir": (0.0, 0.0, 0.5, 0.3, -0.2),
    "pure_gain": (0.0, 0.0, 0.7, 0.0, 0.0),
}


@pytest.mark.parametrize("pol", POLICIES)
@pytest.mark.parametrize("form", sorted(BIQUADS))
def test_biquad_df1(form, pol):
    cf = BIQUADS[form]
    x = _signal(5, (3, 2048), 0.3)
    st = tuple(_signal(6 + i, (3,), 0.2) for i in range(4))
    got, want = _run_both(
        pol, lambda xx, *s: jscan.biquad_df1(xx, *cf, s),
        lambda xx, *s: tscan.biquad_df1(xx, *cf, s), x, *st)
    _assert_db(_np(got[0]), want[0], pol)
    for g, w in zip(got[1], want[1]):
        _assert_state(g, w)


@pytest.mark.parametrize("pol", POLICIES)
@pytest.mark.parametrize("D,T", [(300, 2048), (128, 2048), (100, 1024),
                                 (5000, 1024), (512, 2048)])
def test_feedback_comb(D, T, pol):
    x = _signal(7, (3, T), 0.3)
    hist = _signal(8, (3, D), 0.2)
    got, want = _run_both(
        pol, lambda xx, hh: jdelay.feedback_comb(xx, 0.45, D, hh),
        lambda xx, hh: tdelay.feedback_comb(xx, 0.45, D, hh), x, hist)
    _assert_db(_np(got[0]), want[0], pol)
    _assert_state(got[1], want[1])


H = float(np.float32(np.float32(1.0) / np.float32(1.0001)))
CASCADES = {
    "bench_head": (("gain", H), ("gain", 1.2), ("gain", H),
                   ("bq", (-0.24, 0.0, 0.758, 0.0, 0.0))),
    "bench_mid": (("gain", H), ("lp", 0.6), ("gain", H), ("hp", 0.2)),
    "eq4": (("bq", (-0.3, 0.05, 0.8, 0.1, 0.0)), ("gain", H),
            ("bq", (-1.2, 0.5, 0.3, 0.2, 0.1))),
    "one_pole3": (("lp", 0.3), ("gain", 0.9), ("hp", 0.1), ("lp", 0.8)),
}


def _node_states(sections, seed):
    rng = np.random.default_rng(seed)
    out = []
    for kind, _ in sections:
        if kind in ("lp", "hp"):
            out.append({"z": (rng.standard_normal(3) * 0.2).astype(np.float32)})
        elif kind == "bq":
            out.append({k: (rng.standard_normal(3) * 0.2).astype(np.float32)
                        for k in ("x1", "x2", "y1", "y2")})
    return out


@pytest.mark.parametrize("pol", POLICIES)
@pytest.mark.parametrize("name", sorted(CASCADES))
def test_linear_cascade_with_states(name, pol):
    """cascade_state_in -> linear_cascade -> cascade_state_out, and
    cascade_tail_states from the last chunk."""
    secs = CASCADES[name]
    x = _signal(9, (3, 2048), 0.3)
    ns = _node_states(secs, 10)
    with jprec.policy(pol):
        s_in = np.asarray(jcasc.cascade_state_in(secs, ns))
        y, s1, s2 = jax.jit(lambda xx, ss: jcasc.linear_cascade(
            xx, secs, ss))(x, s_in)
        outs = jcasc.cascade_state_out(secs, s1, s2, x[..., -1], x[..., -2])
        carry = np.asarray(s1) * 0.5 + 0.01
        t1, t2 = jcasc.cascade_tail_states(secs, x[..., -128:], carry)
    with tprec.policy(pol):
        tns = [{k: torch.from_numpy(v) for k, v in d.items()} for d in ns]
        ts_in = tcasc.cascade_state_in(secs, tns)
        _assert_state(ts_in, s_in)
        tx = torch.from_numpy(x)
        ty, ts1, ts2 = tcasc.linear_cascade(tx, secs, ts_in)
        touts = tcasc.cascade_state_out(secs, ts1, ts2, tx[..., -1],
                                        tx[..., -2])
        tt1, tt2 = tcasc.cascade_tail_states(
            secs, tx[..., -128:], torch.from_numpy(carry))
    _assert_db(_np(ty), y, pol)
    _assert_state(ts1, s1)
    _assert_state(ts2, s2)
    _assert_state(tt1, t1)
    _assert_state(tt2, t2)
    assert len(touts) == len(outs)
    for g, w in zip(touts, outs):
        assert g.keys() == w.keys()
        for k in g:
            _assert_state(g[k], w[k])


@pytest.mark.parametrize("pol", POLICIES)
def test_linear_cascade_emits(pol):
    """Prefix readouts of a fused run (tapped intermediates)."""
    secs = CASCADES["one_pole3"]
    x = _signal(11, (3, 1000), 0.3)           # T not a multiple of 128
    s_in = _signal(12, (3, 4), 0.1)
    s_in[:, 3] = 0.0
    with jprec.policy(pol):
        want = jax.tree.map(np.asarray, jax.jit(
            lambda xx, ss: jcasc.linear_cascade(xx, secs, ss, (0, 2)))(
                x, s_in))
    with tprec.policy(pol):
        got = tcasc.linear_cascade(torch.from_numpy(x), secs,
                                   torch.from_numpy(s_in), (0, 2))
    _assert_db(_np(got[0]), want[0], pol)
    _assert_state(got[1], want[1])
    _assert_state(got[2], want[2])
    for g, w in zip(got[3], want[3]):
        _assert_db(_np(g), w, pol)
