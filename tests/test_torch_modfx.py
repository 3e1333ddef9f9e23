"""The port's chorus (dsp_stuff_tpu_torch/ops/modfx.py, nodes Chorus) and
the chain segment's mtap stage (ops/chain_segment.py, the CPU-side half
of the chain kernel's mtap stage) against the JAX package.

The CUDA kernel itself runs only on a GPU (chip_smoke.py holds it against
``segment_fallback`` there); here the JAX Pallas kernel's raw outputs in
interpret mode pin the ring layout that ``rebuild_states`` reads.

Bounds (dBFS = 20 log10(max|err| / max|reference|)):
  trajectory vs JAX parity    q, r bitwise; frac within 6.2e-5 (one f32 ulp
                              of a 384..1024-sample delay) and bitwise on
                              >= 99.9% of samples (f64 sins of the two
                              libraries differ in rare last bits)
  mtap_apply vs JAX           <= -140 (the same f32 operations)
  modulated_delay vs JAX      <= -110 under parity
  segment with mtap vs JAX    <= -125, states atol 1e-6
"""

import jax
import numpy as np
import pytest
import torch

from dsp_stuff_tpu.ops import chain_segment as jcs
from dsp_stuff_tpu.ops import modfx as jm
from dsp_stuff_tpu.ops import pallas_chain as jpc
from dsp_stuff_tpu.utils import precision as jprec
from dsp_stuff_tpu_torch.ops import chain_kernel as tck
from dsp_stuff_tpu_torch.ops import chain_segment as tcs
from dsp_stuff_tpu_torch.ops import modfx as tm
from dsp_stuff_tpu_torch.utils import precision as tprec

Y_DB = -125.0
STATE_ATOL = 1e-6
FRAC_ATOL = 6.2e-5

#: (rate Hz, depth s, base s) of config2's and config5's choruses
LFOS = {"config2": (0.8, 0.004, 0.012), "config5": (1.2, 0.003, 0.008)}


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


def _jax_shared(lfo, L, T, t0):
    with jprec.policy("parity"):
        return jax.tree.map(np.array, jax.jit(
            lambda: jm.mtap_shared(*lfo, L, T, t0))())


@pytest.mark.parametrize("t0", [0, 4096, 12345 * 128])
@pytest.mark.parametrize("name", sorted(LFOS))
def test_mtap_shared_matches_jax(name, t0):
    """The shared trajectory operands against the JAX package's (its
    parity form: the port takes the f64-rounded LFO sin under every
    policy), under both of the port's policies."""
    lfo = LFOS[name]
    L = tm.max_delay_samples(lfo[2], lfo[1])
    assert L == jm.max_delay_samples(lfo[2], lfo[1])
    T = 16384
    qj, rj, fj = _jax_shared(lfo, L, T, t0)
    for pol in ("fast", "parity"):
        with tprec.policy(pol):
            q, r, f = tm.mtap_shared(*lfo, L, T, t0)
        assert q.dtype == r.dtype == torch.int32 and f.dtype == torch.float32
        np.testing.assert_array_equal(q.numpy(), qj)
        np.testing.assert_array_equal(r.numpy(), rj)
        _close(f.numpy(), fj, FRAC_ATOL)
        assert np.mean(f.numpy() == fj) >= 0.999


@pytest.mark.parametrize("name", sorted(LFOS))
def test_mtap_static_matches_jax(name):
    lfo = LFOS[name]
    L = tm.max_delay_samples(lfo[2], lfo[1])
    assert tm.mtap_static(*lfo, L) == jm.mtap_static(*lfo, L)
    # a too-fast, too-deep LFO and a too-short delay refuse in both
    for bad in ((9.0, 0.02, 0.03, 2500), (1.0, 0.001, 0.0001, 60)):
        assert tm.mtap_static(*bad) is None and jm.mtap_static(*bad) is None


@pytest.mark.parametrize("name", sorted(LFOS))
def test_mtap_apply_matches_jax(name):
    """The gather form of the mtap stage on the same operands."""
    lfo = LFOS[name]
    L = tm.max_delay_samples(lfo[2], lfo[1])
    B, T = 3, 2048
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((B, T)) * 0.3).astype(np.float32)
    hist = (rng.standard_normal((B, L)) * 0.3).astype(np.float32)
    q, r, f = _jax_shared(lfo, L, T, 640)
    yj, hj = jax.tree.map(np.asarray, jm.mtap_apply(x, hist, q, r, f, 0.4))
    y, h = tm.mtap_apply(torch.from_numpy(x), torch.from_numpy(hist),
                         torch.from_numpy(q), torch.from_numpy(r),
                         torch.from_numpy(f), 0.4)
    assert _dbfs(y.numpy(), yj) <= -140.0
    np.testing.assert_array_equal(h.numpy(), hj)


@pytest.mark.parametrize("modulated", [False, True])
def test_modulated_delay_matches_jax(modulated):
    """The per-node chorus under parity: a shared trajectory, and a
    per-stream one (a modulated rate), from a non-zero clock."""
    rate, depth, base = LFOS["config5"]
    L = tm.max_delay_samples(base, depth)
    B, T = 2, 1024
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((B, T)) * 0.3).astype(np.float32)
    hist = (rng.standard_normal((B, L)) * 0.3).astype(np.float32)
    if modulated:
        rate = (1.0 + 0.5 * np.sin(np.arange(T) / 50.0)[None]
                * np.array([[1.0], [0.5]])).astype(np.float32)
    with jprec.policy("parity"):
        yj, hj, tj = jax.vmap(
            lambda xx, hh, rr: jm.modulated_delay(xx, rr, depth, base, 0.4,
                                                  hh, 384),
            in_axes=(0, 0, 0 if modulated else None))(x, hist, rate)
    with tprec.policy("parity"):
        y, h, t = tm.modulated_delay(
            torch.from_numpy(x), torch.from_numpy(rate) if modulated
            else rate, depth, base, 0.4, torch.from_numpy(hist), 384)
    assert _dbfs(y.numpy(), np.asarray(yj)) <= -110.0
    np.testing.assert_array_equal(h.numpy(), np.asarray(hj))
    assert t == 384 + T == int(np.asarray(tj)[0])


def _mtap_stages(name):
    rate, depth, base = LFOS[name]
    L = tm.max_delay_samples(base, depth)
    NH, EV, RS = tm.mtap_static(rate, depth, base, L)
    if name == "config2":          # reverb -> chorus -> gain, folded scales
        return (("comb", 0.45, 12000), ("mtap", 0.5, L, NH, EV, RS),
                ("scale", 0.9)), (rate, depth, base)
    return (("cascade", (("hp", 0.05),)), ("tap", 0),     # high_pass -> chorus
            ("mtap", 0.4, L, NH, EV, RS)), (rate, depth, base)


def _segment_inputs(stages, lfo, B, T, seed, t0=256):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, T)) * 0.3).astype(np.float32)
    st = []
    for s in stages:
        if s[0] == "cascade":
            st.append((rng.standard_normal((B, 2)) * 0.1).astype(np.float32))
        elif s[0] == "comb":
            st.append((rng.standard_normal((B, s[2])) * 0.1
                       ).astype(np.float32))
        elif s[0] == "mtap":
            st.append((rng.standard_normal((B, s[2])) * 0.3
                       ).astype(np.float32))
            st.extend(_jax_shared(lfo, s[2], T, t0))
    return x, tuple(st)


def _port_fallback(stages, x, st):
    with tprec.policy("fast"):
        return tcs.segment_fallback(torch.from_numpy(x), stages,
                                    tuple(torch.from_numpy(s) for s in st))


@pytest.mark.parametrize("name", sorted(LFOS))
def test_segment_with_mtap_matches_jax(name):
    """segment_fallback with an mtap stage against the JAX chain_segment
    composition on the same inputs, states included."""
    stages, lfo = _mtap_stages(name)
    x, st = _segment_inputs(stages, lfo, 4, 2048, 3)
    with jprec.policy("fast"):
        want = jax.tree.map(np.asarray, jax.jit(
            lambda xx, ss: jcs.segment_fallback(xx, stages, ss))(x, st))
    y, cinfos, hists, taps = _port_fallback(stages, x, st)
    assert _dbfs(y.numpy(), want[0]) <= Y_DB
    assert len(hists) == len(want[2])
    for g, w in zip(hists, want[2]):
        _close(g.numpy(), w)
    for gi, wi in zip(cinfos, want[1]):
        for g, w in zip(gi, wi):
            _close(g.numpy(), w)
    for g, w in zip(taps, want[3]):
        assert _dbfs(g.numpy(), w) <= Y_DB


@pytest.mark.parametrize("T", [1024, 2688])
@pytest.mark.parametrize("name", sorted(LFOS))
def test_rebuild_states_with_mtap_from_jax_kernel(name, T):
    """The JAX interpret kernel's raw outputs, mtap ring included (slot =
    block mod NH+1, comb and mtap rings in stage order), rebuilt by the
    port equal the port's fallback: the layout the CUDA kernel writes."""
    stages, lfo = _mtap_stages(name)
    B = 8
    x, st = _segment_inputs(stages, lfo, B, T, 4)
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
    assert len(hists) == len(ref[2])
    for g, w in zip(hists, ref[2]):
        _close(g.numpy(), w.numpy())
    for gi, wi in zip(cinfos, ref[1]):
        for g, w in zip(gi, wi):
            _close(g.numpy(), w.numpy())


def test_kernel_path_shares_mtap_operands(monkeypatch):
    """The kernel path broadcasts per-stream states to the rows but hands
    the trajectory operands over as they are; the JAX interpret kernel
    stands in for the CUDA kernel."""
    stages, lfo = _mtap_stages("config5")
    T = 512
    x, st = _segment_inputs(stages, lfo, 1, T, 5)
    batch = (2, 3)
    xb = np.broadcast_to(x[0], (*batch, T)) * np.linspace(
        0.5, 1.5, 6, dtype=np.float32).reshape(*batch, 1)
    states = (torch.from_numpy(st[0][0]), torch.from_numpy(st[1][0]),
              *(torch.from_numpy(s) for s in st[2:]))

    def stand_in(xk, stg, sts):
        assert xk.shape == (6, T)
        assert [tuple(s.shape) for s in sts] == [
            (6, 2), (6, stg[2][2]), (T // 128,), (T,), (T,)]
        with jprec.policy("fast"):
            out = jax.tree.map(np.array, jpc.chain_kernel_call(
                xk.numpy(), stg, tuple(s.numpy() for s in sts),
                interpret=True))
        return jax.tree.map(torch.from_numpy, out)

    monkeypatch.setattr(tck, "chain_kernel_call", stand_in)
    got = tcs._kernel_segment(torch.from_numpy(np.ascontiguousarray(xb)),
                              stages, states)
    with tprec.policy("fast"):
        want = tcs.segment_fallback(torch.from_numpy(xb), stages, states)
    assert got[0].shape == (*batch, T)
    assert _dbfs(got[0].numpy(), want[0].numpy()) <= Y_DB
    assert got[2][0].shape == (*batch, stages[2][2])
    _close(got[2][0].numpy(), want[2][0].numpy())


def test_chorus_segmented_equals_whole():
    """Chorus node state (hist, lockstep t0) chains renders exactly."""
    from dsp_stuff_tpu_torch.nodes.delay import Chorus
    params = {"rate": 1.2, "depth": 0.003, "base": 0.008, "mix": 0.4}
    x = torch.from_numpy((np.random.default_rng(6).standard_normal(
        (2, 3072)) * 0.3).astype(np.float32))
    st0 = Chorus.init_state(params, 128)
    with tprec.policy("fast"):
        full, _ = Chorus.process_seq(params, st0, {"in": x})
        a, st = Chorus.process_seq(params, st0, {"in": x[:, :1280]})
        b, st = Chorus.process_seq(params, st, {"in": x[:, 1280:]})
    assert st["t0"] == 3072
    np.testing.assert_array_equal(torch.cat([a["out"], b["out"]], -1).numpy(),
                                  full["out"].numpy())
