"""The chain segment's backward in the port: ``segment_adjoint`` (the plain
version of the reverse chain kernel, csrc/chain_reverse_kernel.cu), the
record mode that feeds it, and the card's route on the CPU.

The kernel runs only on a GPU (chip_smoke.py holds it against
``segment_adjoint`` there, and tests/test_torch_chain_reverse_tiles.py
holds a model of its walk against ``segment_adjoint`` here).  Here:

* ``segment_adjoint`` against autograd through ``segment_fallback``, on
  every list of tests/test_torch_grad_fused.py with the cotangent on
  every output, on y alone, on the cascade infos, the histories and the
  taps alone; and on each shaper alone, Fuzz with tied block maxima and
  inputs at the clip edges included;
* ``segment_adjoint`` against ``jax.vjp`` of the JAX package's
  segment_fallback (its custom_vjp's bwd);
* ``segment_fallback(record=True)``: the records are bitwise the stage
  inputs, the outputs bitwise those without records;
* the card's route through ``compile_graph`` with the plain versions
  standing in for the kernels (``segment_fallback(record=True)``
  forward, ``segment_adjoint`` backward): the bench chain's input and
  its gain level with the rest fused, config5's input, config2's input
  and its chorus's and reverb's histories, against ``jax.grad``.

Bounds, max-normalized (max |got - want| / max |want| over the array):
against autograd <= 1e-5 (the same float32 operations in another
order: the carry walks block by block, the comb chunk by chunk); against
JAX <= 1e-3 (PERF.md section 2's gradient bound)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dsp_stuff_tpu as dj
from dsp_stuff_tpu.ops import chain_segment as jcs
from dsp_stuff_tpu.train import fit as jfit
from dsp_stuff_tpu.utils import precision as jprec
import dsp_stuff_tpu_torch as dt
from dsp_stuff_tpu_torch.ids import IdSpace as TIdSpace
from dsp_stuff_tpu_torch.ops import chain_kernel as tck
from dsp_stuff_tpu_torch.ops import chain_segment as tcs
from dsp_stuff_tpu_torch.train import fit as tfit
from dsp_stuff_tpu_torch.utils import precision as tprec
from test_torch_grad_fused import (GRAPH_CASES, STAGE_LISTS, _graph_pair,
                                   _segment_inputs)

AUTOGRAD_RTOL = 1e-5
JAX_RTOL = 1e-3
C = 128


@pytest.fixture(autouse=True)
def _torch_env():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    prev = tprec.get_policy()
    tprec.set_policy("fast")
    yield
    tprec.set_policy(prev)
    torch.set_num_threads(threads)


def _err(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _held(name, pairs, rtol):
    worst = max(_err(g, w) for g, w in pairs)
    print(f"{name}: worst max-normalized gradient error {worst:.2e}")
    assert worst <= rtol, (name, worst)


def _picks(stages):
    """The output groups a list has: name -> flat output indices."""
    n_c = sum(1 for st in stages if st[0] == "cascade")
    n_h = sum(1 for st in stages if st[0] in ("comb", "mtap"))
    n_t = sum(1 for st in stages if st[0] == "tap")
    n = 1 + 4 * n_c + n_h + n_t
    out = {"all": list(range(n)), "y": [0],
           "infos": list(range(1, 1 + 4 * n_c)),
           "hists": list(range(1 + 4 * n_c, 1 + 4 * n_c + n_h)),
           "taps": list(range(1 + 4 * n_c + n_h, n))}
    return {k: v for k, v in out.items() if v}


def _autograd_case(stages, x, st, which, seed):
    """(segment_adjoint's gradients, autograd's) of x and every per-stream
    state entry, the cotangents on the outputs ``which`` names."""
    shared = tcs._shared_slots(stages)
    xl = torch.from_numpy(x).requires_grad_(True)
    sl = [torch.from_numpy(s).requires_grad_(i not in shared)
          for i, s in enumerate(st)]
    outs, recs = tcs.segment_fallback(xl, stages, tuple(sl), record=True)
    flat = tcs.flatten_outputs(outs)
    rng = np.random.default_rng(seed)
    idx = _picks(stages)[which]
    cts = tuple(torch.from_numpy((rng.standard_normal(tuple(o.shape)) * 0.5)
                                 .astype(np.float32)) if i in idx else None
                for i, o in enumerate(flat))
    loss = sum((flat[i] * cts[i]).sum() for i in idx)
    leaves = [xl] + [s for i, s in enumerate(sl) if i not in shared]
    want = torch.autograd.grad(loss, leaves, allow_unused=True)
    gx, gs = tcs.segment_adjoint(
        cts, tuple(t.shape for t in (xl, *sl)), stages,
        tuple(r.detach() for r in recs), tuple(s.detach() for s in sl))
    got = [gx] + [g for i, g in enumerate(gs) if i not in shared]
    assert all(gs[i] is None for i in shared)
    return [(g.numpy(), np.zeros(g.shape, np.float32) if w is None
             else w.numpy()) for g, w in zip(got, want)]


_AUTOGRAD_CASES = [(name, which) for name in sorted(STAGE_LISTS)
                   for which in _picks(STAGE_LISTS[name][0])]


@pytest.mark.parametrize("name,which", _AUTOGRAD_CASES)
def test_adjoint_matches_autograd(name, which):
    """segment_adjoint against autograd through segment_fallback, the
    cotangent on every output, on y alone, on the infos, the histories
    or the taps alone."""
    stages, lfo = STAGE_LISTS[name]
    x, st = _segment_inputs(stages, lfo, 2, 1024, 31)
    pairs = _autograd_case(stages, x, st, which, 32)
    assert any(np.abs(w).max() > 0 for _, w in pairs)
    _held(f"{name}, cotangents on {which}", pairs, AUTOGRAD_RTOL)


def _shaper_input(kind, B, T, rng):
    """Inputs that reach a shaper's edges: its clip bounds after the level
    (exactly, and a hair either side), 0, and for Fuzz a block whose
    maximum is tied, positive and negative."""
    x = (rng.standard_normal((B, T)) * 0.3).astype(np.float32)
    x[0, :8] = [0.0, 0.4, -0.4, 0.4 + 1e-6, -0.4 - 1e-6, 2.0, -2.0, 0.39]
    if kind == "distort:Fuzz":
        x[1, C:2 * C] = np.clip(x[1, C:2 * C], -0.5, 0.5)
        x[1, C + 3] = x[1, C + 40] = 0.9           # a tied maximum
        x[1, C + 77] = -0.9
        x[0, 2 * C:3 * C] *= 0.1
        x[0, 2 * C + 5] = x[0, 2 * C + 6] = -0.7   # ties at the minimum
    return x


_SHAPERS = {kind: {"overdrive": (4.0, 0.6, 0.9),
                   "chebyshev": (2.0, 4.0)}.get(kind, (2.5,))
            for kind in tck.EW_CODES}


@pytest.mark.parametrize("kind", sorted(_SHAPERS))
def test_adjoint_each_shaper(kind):
    """Each shaper between two cascades, at its clip edges (HardClip's
    and Fuzz's bounds hit exactly at level 2.5), 0 (sign, abs) and, for
    Fuzz, tied block maxima (their gradient split evenly, as torch.amax's
    backward)."""
    stages = (("cascade", (("gain", 1.0),)), ("ew", kind, _SHAPERS[kind]),
              ("cascade", (("lp", 0.3),)))
    rng = np.random.default_rng(len(kind))
    x = _shaper_input(kind, 2, 3 * C, rng)
    st = tuple((rng.standard_normal((2, 2)) * 0.0).astype(np.float32)
               for _ in range(2))
    pairs = _autograd_case(stages, x, st, "all", 33)
    _held(f"shaper {kind}", pairs, AUTOGRAD_RTOL)


def test_adjoint_fuzz_all_zero_block():
    """Fuzz on an all-zero block: NaN there in both (its 0/0, a reference
    quirk), the same elsewhere."""
    stages = (("ew", "distort:Fuzz", (2.0,)),)
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((1, 3 * C)) * 0.3).astype(np.float32)
    x[0, C:2 * C] = 0.0
    pairs = _autograd_case(stages, x, (), "y", 34)
    g, w = pairs[0]
    assert np.array_equal(np.isnan(g), np.isnan(w))
    assert np.isnan(g[0, C:2 * C]).all() and not np.isnan(g[0, :C]).any()
    _held("Fuzz, a zero block", [(np.nan_to_num(g), np.nan_to_num(w))],
          AUTOGRAD_RTOL)


@pytest.mark.parametrize("name", sorted(STAGE_LISTS))
def test_adjoint_matches_jax_vjp(name):
    """segment_adjoint against jax.vjp of the JAX package's
    segment_fallback (what its custom_vjp's bwd takes), every output with
    a cotangent, on the same inputs."""
    stages, lfo = STAGE_LISTS[name]
    x, st = _segment_inputs(stages, lfo, 2, 1024, 35)
    shared = tcs._shared_slots(stages)
    outs, recs = tcs.segment_fallback(torch.from_numpy(x), stages,
                                      tuple(map(torch.from_numpy, st)),
                                      record=True)
    flat = tcs.flatten_outputs(outs)
    rng = np.random.default_rng(36)
    cts = [(rng.standard_normal(tuple(o.shape)) * 0.5).astype(np.float32)
           for o in flat]
    diff = [i for i in range(len(st)) if i not in shared]

    def f(xx, ds):
        full = list(st)
        for i, v in zip(diff, ds):
            full[i] = v
        return tcs.flatten_outputs(jcs.segment_fallback(xx, stages,
                                                        tuple(full)))

    with jprec.policy("fast"):
        _, pull = jax.vjp(f, jnp.asarray(x), tuple(jnp.asarray(st[i])
                                                   for i in diff))
        gx, gs = pull(tuple(jnp.asarray(c) for c in cts))
    got_x, got_s = tcs.segment_adjoint(
        tuple(map(torch.from_numpy, cts)),
        tuple(np.shape(t) for t in (x, *st)), stages, recs,
        tuple(map(torch.from_numpy, st)))
    pairs = [(got_x.numpy(), np.asarray(gx))]
    pairs += [(got_s[i].numpy(), np.asarray(g)) for i, g in zip(diff, gs)
              if np.abs(np.asarray(g)).max() > 0]
    _held(f"{name} vs jax.vjp", pairs, JAX_RTOL)


@pytest.mark.parametrize("name", ["bench", "taps", "comb"])
def test_records_are_the_stage_inputs(name):
    """segment_fallback(record=True) returns each ew stage's input,
    bitwise what the composition up to that stage gives, and outputs
    bitwise those of a call without records."""
    stages, lfo = STAGE_LISTS[name]
    x, st = _segment_inputs(stages, lfo, 2, 1024, 37)
    xt, stt = torch.from_numpy(x), tuple(map(torch.from_numpy, st))
    outs, recs = tcs.segment_fallback(xt, stages, stt, record=True)
    plain = tcs.segment_fallback(xt, stages, stt)
    for a, b in zip(tcs.flatten_outputs(outs), tcs.flatten_outputs(plain)):
        assert torch.equal(a, b)
    ews = [i for i, s in enumerate(stages) if s[0] == "ew"]
    assert len(recs) == len(ews) > 0
    n_state = {"cascade": 1, "comb": 1, "mtap": 4}
    for rec, i in zip(recs, ews):
        k = sum(n_state.get(s[0], 0) for s in stages[:i])
        assert torch.equal(rec, tcs.segment_fallback(xt, stages[:i],
                                                     stt[:k])[0])


# -- the card's route through compile_graph ----------------------------------

def _adjoint_dispatch(monkeypatch):
    """Route the compiler's chain_segment calls as the card routes them,
    the plain versions standing in for the kernels: the forward (with its
    records) and segment_adjoint backward; returns the forward calls,
    each with whether it recorded."""
    calls = []

    def forward(x, stages, state_in, record=False):
        calls.append(record)
        return tcs.segment_fallback(x, stages, state_in, record=record)

    monkeypatch.setattr(tcs, "chain_segment", lambda x, stages, st: (
        tcs.run_segment(forward, x, tuple(stages), tuple(st),
                        tcs.segment_adjoint)))
    return calls


def _backward_counted(monkeypatch):
    """Count the backward's calls of segment_adjoint and of the eager
    vjp (which the card's route must not take)."""
    counts = {"adjoint": 0, "vjp": 0}
    adj, vjp = tcs.segment_adjoint, tcs.segment_vjp

    def counted_adj(*a):
        counts["adjoint"] += 1
        return adj(*a)

    def counted_vjp(*a):
        counts["vjp"] += 1
        return vjp(*a)

    monkeypatch.setattr(tcs, "segment_adjoint", counted_adj)
    monkeypatch.setattr(tcs, "segment_vjp", counted_vjp)
    return counts


@pytest.mark.parametrize("name,wrt", [("bench", "input"), ("bench", "subset"),
                                      ("config5", "input")])
def test_card_route_graph_gradients(name, wrt, monkeypatch):
    """Loss gradients through compile_graph under fast with the card's
    route (the forward once, recording where the list has a shaper;
    segment_adjoint backward, no eager vjp) against jax.grad of the JAX
    package's make_loss_fn: the input's, or the gain level's with the rest
    of the chain fused."""
    gj, gt, inp, T, sub, fused, feeds = _graph_pair(name)
    counts = _backward_counted(monkeypatch)
    calls = _adjoint_dispatch(monkeypatch)
    rng = np.random.default_rng(41)
    x = (rng.standard_normal((2, T)) * 0.25).astype(np.float32)
    target = (rng.standard_normal((2, 1, T)) * 0.1).astype(np.float32)
    with jprec.policy("fast"):
        cgj = dj.compile_graph(gj)
        pj = cgj.init_params()
        pj = ({n: {k: pj[n][k] for k in keys} for n, keys in sub.items()}
              if wrt == "subset" else {})
        gp, gx = jax.jit(jax.grad(jfit.make_loss_fn(cgj), argnums=(0, 2)))(
            pj, cgj.init_state(), {inp: x}, target)
    cgt = dt.compile_graph(gt, device="cpu")
    pt = {n: {k: torch.tensor(float(np.asarray(v)), requires_grad=True)
              for k, v in e.items()} for n, e in pj.items()}
    xt = torch.tensor(x, requires_grad=wrt == "input")
    loss = tfit.make_loss_fn(cgt)(pt, cgt.init_state(), {inp: xt},
                                  torch.from_numpy(target))
    loss.backward()
    shaper = name == "bench"
    assert calls == [shaper]                      # one forward, recording
    assert counts == {"adjoint": 1, "vjp": 0}
    if wrt == "input":
        _held(f"{name}: input gradient", [(xt.grad.numpy(), gx[inp])],
              JAX_RTOL)
    else:
        pairs = [(pt[n][k].grad.numpy(), gp[n][k]) for n in pt
                 for k in pt[n]]
        _held(f"{name}: gradients of {sub}", pairs, JAX_RTOL)


def _state_key(state, entry):
    return next(k for k, v in state.items()
                if isinstance(v, dict) and entry in v)


def test_card_route_config2_input_and_histories(monkeypatch):
    """config2 (reverb -> chorus -> gain, one fused chain with a comb and
    an mtap) with the card's route: the input's gradient and those of the
    chorus's input history and the reverb's ring, against jax.grad."""
    build, T = GRAPH_CASES["config2"][:2]
    gj, meta = build()
    gt = dt.loads_graph(dj.dumps_graph(gj), ids=TIdSpace())
    inp = str(meta["input"])
    counts = _backward_counted(monkeypatch)
    calls = _adjoint_dispatch(monkeypatch)
    rng = np.random.default_rng(43)
    x = (rng.standard_normal((2, T)) * 0.25).astype(np.float32)
    target = (rng.standard_normal((2, 1, T)) * 0.1).astype(np.float32)
    with jprec.policy("fast"):
        cgj = dj.compile_graph(gj)
        s0 = cgj.init_state()
        kh, kr = _state_key(s0, "hist"), _state_key(s0, "ring")
        h0 = (rng.standard_normal(np.shape(s0[kh]["hist"])) * 0.2
              ).astype(np.float32)
        r0 = (rng.standard_normal(np.shape(s0[kr]["ring"])) * 0.2
              ).astype(np.float32)

        def jloss(hh, rr, xx):
            st = dict(s0)
            st[kh] = dict(s0[kh], hist=hh)
            st[kr] = dict(s0[kr], ring=rr)
            return jfit.make_loss_fn(cgj)({}, st, {inp: xx}, target)

        jh, jr, jx = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(h0, r0, x)
    cgt = dt.compile_graph(gt, device="cpu")
    st = cgt.init_state()
    th = torch.tensor(h0, requires_grad=True)
    tr = torch.tensor(r0, requires_grad=True)
    st[_state_key(st, "hist")] = dict(st[_state_key(st, "hist")], hist=th)
    st[_state_key(st, "ring")] = dict(st[_state_key(st, "ring")], ring=tr)
    xt = torch.tensor(x, requires_grad=True)
    tfit.make_loss_fn(cgt)({}, st, {inp: xt},
                           torch.from_numpy(target)).backward()
    assert calls == [False]                 # no shaper: no record
    assert counts == {"adjoint": 1, "vjp": 0}
    _held("config2: input, chorus history, reverb ring",
          [(xt.grad.numpy(), jx), (th.grad.numpy(), jh),
           (tr.grad.numpy(), jr)], JAX_RTOL)
    assert np.abs(jh).max() > 0 and np.abs(jr).max() > 0
