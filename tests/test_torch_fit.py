"""The port's gradient fitting (dsp_stuff_tpu_torch/train/fit.py) against
the JAX package's (dsp_stuff_tpu/train/fit.py): the ports of
tests/test_fit.py (the sharded step's is in test_torch_parallel.py), the
bench chain's loss gradients and ten Adam steps against jax.grad and
optax, every slider of config2 (through the chorus) and config5 (through
its feedback cycle, by the per-node block scan) against jax.grad, three
Adam steps of config2 against optax, and the envelope's analytic backward
against jax.grad through the JAX follower.

Everything runs on the CPU under ``fast``, where the port takes the plain
versions of its kernels (the CUDA kernels are held against them on the
card by chip_smoke.py).  Tolerances, each with the worst the CPU measured:
  bench chain loss gradients vs jax.grad, all 16 sliders  rtol 1e-3 (5.2e-6)
  config2 and config5, every slider, vs jax.grad          rtol 1e-3
  ten Adam steps vs optax.adam, every slider and loss     rtol 1e-3 (5.2e-7)
  envelope gradients vs jax.grad (x, attack, release, env0),
    max-normalized                                        1e-3 (2.9e-7)
  comb with a tensor decay vs JAX: output, max-normalized 1e-6 (9.9e-8);
    gradients (x, decay, history), max-normalized         1e-3 (5.2e-7)
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import __graft_entry__
import dsp_stuff_tpu as dj
from dsp_stuff_tpu.ops import delay_line as jdl
from dsp_stuff_tpu.ops import envelope as je
from dsp_stuff_tpu.train import fit as jfit
from dsp_stuff_tpu.utils import precision as jprec
import dsp_stuff_tpu_torch as dt
from dsp_stuff_tpu_torch import convert
from dsp_stuff_tpu_torch.ids import IdSpace
from dsp_stuff_tpu_torch.compiler import compile as tcompile
from dsp_stuff_tpu_torch.ops import delay_line as tdl
from dsp_stuff_tpu_torch.ops import envelope as te
from dsp_stuff_tpu_torch.train import fit as tfit
from dsp_stuff_tpu_torch.utils import precision as tprec

GRAD_RTOL = 1e-3
ADAM_RTOL = 1e-3
ENV_RTOL = 1e-3
COMB_RTOL = 1e-6
B, T = 2, 2048


@pytest.fixture(autouse=True)
def _torch_env():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    prev = tprec.get_policy()
    yield
    tprec.set_policy(prev)
    torch.set_num_threads(threads)


def _chain_graph():
    g = dt.Graph(IdSpace())
    inp = g.add("input")
    gn = g.add("gain", level=1.0)
    lp = g.add("low_pass", ratio=0.3)
    out = g.add("output")
    g.chain(inp, gn, lp, out)
    return g, inp, gn, lp


def test_init_params_pytree():
    g, inp, gn, lp = _chain_graph()
    cg = dt.compile_graph(g, device="cpu")
    p = cg.init_params()
    assert float(p[str(gn.id)]["level"]) == 1.0
    assert float(p[str(lp.id)]["ratio"]) == pytest.approx(0.3)
    # static / field params excluded
    assert str(inp.id) not in p
    leaves = [v for e in p.values() for v in e.values()]
    assert all(v.is_leaf and not v.requires_grad and v.shape == ()
               and v.dtype == torch.float32 for v in leaves)
    pg = cg.init_params(requires_grad=True)
    assert all(v.is_leaf and v.requires_grad
               for e in pg.values() for v in e.values())


def test_params_override_render():
    g, inp, gn, lp = _chain_graph()
    cg = dt.compile_graph(g, device="cpu")
    x = np.random.default_rng(0).standard_normal(512).astype(np.float32) * 0.3
    ext = {str(inp.id): x}
    base, _, _ = cg.render(ext)
    p = cg.init_params()
    p[str(gn.id)]["level"] = torch.tensor(2.0)
    doubled, _, _ = cg.render(ext, params=p)
    # low_pass(2x) == 2*low_pass(x) only up to f32 rounding
    np.testing.assert_allclose(doubled.numpy(), base.numpy() * 2.0,
                               rtol=1e-5, atol=1e-7)


def test_reverb_seconds_is_static():
    g = dt.Graph(IdSpace())
    inp = g.add("input")
    rv = g.add("reverb", seconds=0.01, decay=0.5)
    out = g.add("output")
    g.chain(inp, rv, out)
    cg = dt.compile_graph(g, device="cpu")
    p = cg.init_params()
    assert "seconds" not in p[str(rv.id)]
    assert "decay" in p[str(rv.id)]


def test_fit_recovers_gain():
    """Render a target with level=2.5, fit starting from level=1.0."""
    with tprec.policy("fast"):
        g, inp, gn, lp = _chain_graph()
        cg = dt.compile_graph(g, device="cpu")
        rng = np.random.default_rng(1)
        x = rng.standard_normal((4, 512)).astype(np.float32) * 0.3
        ext = {str(inp.id): torch.from_numpy(x)}
        true = cg.init_params()
        true[str(gn.id)]["level"] = torch.tensor(2.5)
        _, outs, _ = cg.fn(cg.init_state(), ext, true)
        target = torch.stack([outs[i] for i in cg.output_ids], dim=-2)
        params, losses = tfit.fit(cg, ext, target, steps=250,
                                  optimizer=tfit.adam(0.05))
    assert losses[-1] < 1e-6, losses[-1]
    assert float(params[str(gn.id)]["level"]) == pytest.approx(2.5, abs=0.02)


def test_grad_finite_at_bypass_levels():
    """Distortion sliders at/below the bypass epsilon must yield finite
    gradients (the where-NaN-grad pitfall in clip(x*l)/l at l=0)."""
    g = dt.Graph(IdSpace())
    inp = g.add("input")
    ds = g.add("distort", mode="HardClip", level=0.0)
    ch = g.add("chebyshev", level_pos=0.0, level_neg=0.0)
    out = g.add("output")
    g.chain(inp, ds, ch, out)
    with tprec.policy("fast"):
        cg = dt.compile_graph(g, device="cpu")
        loss = tfit.make_loss_fn(cg)
        x = np.random.default_rng(0).standard_normal((2, 256)).astype(
            np.float32) * 0.3
        ext = {str(inp.id): torch.from_numpy(x)}
        params = cg.init_params(requires_grad=True)
        loss(params, cg.init_state(), ext, torch.zeros((2, 1, 256))).backward()
    leaves = [v for e in params.values() for v in e.values()]
    assert leaves and all(v.grad is not None and torch.isfinite(v.grad)
                          for v in leaves)


def test_fit_through_envelope():
    """Gradients flow THROUGH an envelope node (EnvCore's analytic
    backward) and recover an upstream gain."""
    g = dt.Graph(IdSpace())
    inp = g.add("input")
    gn = g.add("gain", level=0.5)
    en = g.add("envelope", attack=10.0, release=60.0)
    out = g.add("output")
    g.chain(inp, gn, en, out)
    cg = dt.compile_graph(g, device="cpu")
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(1024) * 0.5).astype(np.float32)
    ext = {str(inp.id): x}
    with tprec.policy("fast"):
        target_p = cg.init_params()
        target_p[str(gn.id)]["level"] = torch.tensor(1.7)
        target, _, _ = cg.render(ext, params=target_p)
        fitted, losses = tfit.fit(cg, ext, target, steps=250,
                                  optimizer=tfit.adam(0.05))
    assert losses[-1] < 1e-4, losses[-1]
    assert abs(float(fitted[str(gn.id)]["level"]) - 1.7) < 0.08
    # the envelope's own sliders picked up finite (possibly zero) grads
    assert np.isfinite(float(fitted[str(en.id)]["attack"]))


def test_clamp_params_projects_in_place():
    g, inp, gn, lp = _chain_graph()
    cg = dt.compile_graph(g, device="cpu")
    p = cg.init_params(requires_grad=True)
    with torch.no_grad():
        p[str(gn.id)]["level"].fill_(12.0)
        p[str(lp.id)]["ratio"].fill_(-0.5)
    leaf = p[str(lp.id)]["ratio"]
    assert tfit.clamp_params(cg, p) is p
    assert float(p[str(gn.id)]["level"].detach()) == 10.0
    assert float(leaf.detach()) == 0.0 and p[str(lp.id)]["ratio"] is leaf


def test_distances_match_jax():
    """mse_loss and spectral_loss of one stream equal the JAX package's."""
    rng = np.random.default_rng(3)
    y, tg = (rng.standard_normal((2, 1, 4096)).astype(np.float32)
             for _ in range(2))
    for tf, jf in ((tfit.mse_loss, jfit.mse_loss),
                   (tfit.spectral_loss, jfit.spectral_loss)):
        got = tf(torch.from_numpy(y), torch.from_numpy(tg)).numpy()
        want = [float(jf(jnp.asarray(y[i]), jnp.asarray(tg[i])))
                for i in range(2)]
        np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.fixture(scope="module")
def bench():
    """The bench chain (__graft_entry__._build, reverb seconds=0.003 as in
    dryrun_multichip) in both packages, its inputs, and the JAX package's
    jitted value_and_grad of make_loss_fn."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((B, T)) * 0.25).astype(np.float32)
    target = (rng.standard_normal((B, 1, T)) * 0.1).astype(np.float32)
    with jprec.policy("fast"):
        cgj, inp = __graft_entry__._build(T, seconds=0.003)
        vg = jax.jit(jax.value_and_grad(jfit.make_loss_fn(cgj)))
        vg(cgj.init_params(), cgj.init_state(), {str(inp): x}, target)
    gt = dt.loads_graph(dj.dumps_graph(cgj.graph), ids=IdSpace())
    return cgj, vg, dt.compile_graph(gt, device="cpu"), str(inp), x, target


def _port_params(pj, requires_grad=True):
    return convert.params_from_jax(jax.tree.map(np.asarray, pj), "cpu",
                                   requires_grad=requires_grad)


def _rel(got, want):
    return abs(float(got) - float(want)) / max(abs(float(want)), 1e-30)


def test_bench_chain_gradients_match_jax(bench):
    """All 16 non-static sliders of the bench chain: the port's loss
    gradients against jax.grad(make_loss_fn(cg)), B = 2, T = 2048."""
    cgj, vg, cgt, inp, x, target = bench
    pj = cgj.init_params()
    with jprec.policy("fast"):
        lj, gj = vg(pj, cgj.init_state(), {inp: x}, target)
    pt = _port_params(pj)
    with tprec.policy("fast"):
        lt = tfit.make_loss_fn(cgt)(pt, cgt.init_state(),
                                    {inp: torch.from_numpy(x)},
                                    torch.from_numpy(target))
        lt.backward()
    assert _rel(lt.detach(), lj) <= GRAD_RTOL
    leaves = [(n, k) for n in sorted(pt) for k in sorted(pt[n])]
    assert len(leaves) == 16
    for n, k in leaves:
        assert _rel(pt[n][k].grad, gj[n][k]) <= GRAD_RTOL, (n, k)


def test_adam_steps_match_optax(bench):
    """Ten steps of the port's make_train_step (torch Adam) against ten
    optax.adam steps of the JAX package, both from the same
    params_from_jax start and clamped after every step."""
    cgj, vg, cgt, inp, x, target = bench
    pj = cgj.init_params()
    opt = optax.adam(1e-2)
    ost = opt.init(pj)
    jl = []
    with jprec.policy("fast"):
        for _ in range(10):
            loss, g = vg(pj, cgj.init_state(), {inp: x}, target)
            upd, ost = opt.update(g, ost, pj)
            pj = jfit.clamp_params(cgj, optax.apply_updates(pj, upd))
            jl.append(float(loss))
    pt = _port_params(cgj.init_params(), requires_grad=True)
    step, init_opt = tfit.make_train_step(cgt, tfit.adam(1e-2))
    opt_t = init_opt(pt)
    ext = {inp: torch.from_numpy(x)}
    tl = []
    with tprec.policy("fast"):
        for _ in range(10):
            pt, opt_t, loss = step(pt, opt_t, cgt.init_state(), ext,
                                   torch.from_numpy(target))
            tl.append(float(loss))
    np.testing.assert_allclose(tl, jl, rtol=ADAM_RTOL)
    for n in pj:
        for k in pj[n]:
            np.testing.assert_allclose(float(pt[n][k].detach()),
                                       float(pj[n][k]),
                                       rtol=ADAM_RTOL, atol=1e-6,
                                       err_msg=f"{n}/{k}")


def _all_slider_grads(build, T, seed):
    """Loss gradients of every slider of a JAX preset, fast, B = 2: the
    port's (through make_loss_fn) and jax.grad's, and the port's
    cycle_segment calls (a graph whose sliders are all tensors runs node by
    node: none)."""
    gj, meta = build()
    gt = dt.loads_graph(dj.dumps_graph(gj), ids=IdSpace())
    inp = str(meta["input"])
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((2, T)) * 0.3).astype(np.float32)
    target = (rng.standard_normal((2, 1, T)) * 0.1).astype(np.float32)
    with jprec.policy("fast"):
        cgj = dj.compile_graph(gj)
        pj = cgj.init_params()
        lj, gj_ = jax.jit(jax.value_and_grad(jfit.make_loss_fn(cgj)))(
            pj, cgj.init_state(), {inp: x}, target)
    cgt = dt.compile_graph(gt, device="cpu")
    pt = _port_params(pj)
    calls = []
    real = tcompile.cycle_segment
    tcompile.cycle_segment = lambda *a: calls.append(a) or real(*a)
    try:
        with tprec.policy("fast"):
            lt = tfit.make_loss_fn(cgt)(pt, cgt.init_state(),
                                        {inp: torch.from_numpy(x)},
                                        torch.from_numpy(target))
            lt.backward()
    finally:
        tcompile.cycle_segment = real
    return lt.detach(), lj, pt, gj_, calls


def _held_grads(pt, gj, n_expect):
    """Each slider's gradient within GRAD_RTOL of jax.grad's (1e-9 abs for
    one that is 0 in both; a slider with no path to the loss, such as a
    knob its modulation input overrides, gets no gradient in the port and
    0 in JAX); returns the worst relative error."""
    leaves = [(n, k) for n in sorted(pt) for k in sorted(pt[n])]
    assert len(leaves) == n_expect
    worst = 0.0
    for n, k in leaves:
        grad = pt[n][k].grad
        g, w = (0.0 if grad is None else float(grad)), float(gj[n][k])
        assert np.isfinite(g)
        assert abs(g - w) <= max(GRAD_RTOL * abs(w), 1e-9), (n, k, g, w)
        worst = max(worst, _rel(g, w) if w else 0.0)
    return worst


def test_fit_differentiable_through_chorus():
    """The port of tests/test_fit.py:112: every slider of config2 (echo ->
    chorus -> gain) under fast, its gradients finite and held against
    jax.grad; the chorus runs its modulated delay unfused (ops/modfx.py)."""
    from dsp_stuff_tpu.models import config2_delay_chorus
    lt, lj, pt, gj, _ = _all_slider_grads(config2_delay_chorus, 2048, 3)
    assert _rel(lt, lj) <= GRAD_RTOL
    worst = _held_grads(pt, gj, 4)
    print(f"config2, 4 sliders: worst relative gradient error {worst:.2e}")


def test_fit_through_feedback_cycle():
    """Every slider of config5 under fast: its feedback cycle runs the
    per-node block scan (no cycle program), held against jax.grad."""
    from dsp_stuff_tpu.models import config5_feedback_16node
    lt, lj, pt, gj, calls = _all_slider_grads(config5_feedback_16node, 1024,
                                              4)
    assert calls == []
    assert _rel(lt, lj) <= GRAD_RTOL
    worst = _held_grads(pt, gj, sum(len(e) for e in gj.values()))
    print(f"config5, every slider: worst relative gradient error "
          f"{worst:.2e}")


def test_chorus_fit_steps_match_optax():
    """Three Adam steps of config2's sliders against optax.adam's in the
    JAX package, both clamped after every step."""
    from dsp_stuff_tpu.models import config2_delay_chorus
    gj, meta = config2_delay_chorus()
    gt = dt.loads_graph(dj.dumps_graph(gj), ids=IdSpace())
    inp = str(meta["input"])
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((2, 1024)) * 0.3).astype(np.float32)
    target = (rng.standard_normal((2, 1, 1024)) * 0.1).astype(np.float32)
    with jprec.policy("fast"):
        cgj = dj.compile_graph(gj)
        vg = jax.jit(jax.value_and_grad(jfit.make_loss_fn(cgj)))
        pj = cgj.init_params()
        opt = optax.adam(1e-2)
        ost = opt.init(pj)
        jl = []
        for _ in range(3):
            loss, g = vg(pj, cgj.init_state(), {inp: x}, target)
            upd, ost = opt.update(g, ost, pj)
            pj = jfit.clamp_params(cgj, optax.apply_updates(pj, upd))
            jl.append(float(loss))
    cgt = dt.compile_graph(gt, device="cpu")
    pt = cgt.init_params(requires_grad=True)
    step, init_opt = tfit.make_train_step(cgt, tfit.adam(1e-2))
    opt_t = init_opt(pt)
    tl = []
    with tprec.policy("fast"):
        for _ in range(3):
            pt, opt_t, loss = step(pt, opt_t, cgt.init_state(),
                                   {inp: torch.from_numpy(x)},
                                   torch.from_numpy(target))
            tl.append(float(loss))
    np.testing.assert_allclose(tl, jl, rtol=ADAM_RTOL)
    for n in pj:
        for k in pj[n]:
            np.testing.assert_allclose(float(pt[n][k].detach()),
                                       float(pj[n][k]), rtol=ADAM_RTOL,
                                       atol=1e-6, err_msg=f"{n}/{k}")


@pytest.mark.parametrize("D,T_comb", [(144, 2048), (128, 128 * 300)])
def test_comb_tensor_decay_matches_jax(D, T_comb):
    """feedback_comb with a tensor decay (the fitting path's Toeplitz
    route over the chunks: one product for 15 chunks, super-chunks for
    300) against the JAX package's traced-decay route: the output, and the
    gradients of x, the decay and the history."""
    rng = np.random.default_rng(12)
    x = (rng.standard_normal((2, T_comb)) * 0.3).astype(np.float32)
    hist = (rng.standard_normal((2, D)) * 0.1).astype(np.float32)
    ybar = rng.standard_normal((2, T_comb)).astype(np.float32)
    decay = np.float32(0.6)

    def f(xx, dd, hh):
        return jnp.sum(jdl.feedback_comb(xx, dd, D, hh)[0] * ybar)
    with jprec.policy("fast"):
        yj = jax.jit(lambda xx, dd, hh: jdl.feedback_comb(
            xx, dd, D, hh)[0])(x, decay, hist)
        want = jax.jit(jax.grad(f, argnums=(0, 1, 2)))(x, decay, hist)
    ins = [torch.tensor(v, requires_grad=True) for v in (x, decay, hist)]
    with tprec.policy("fast"):
        y, _ = tdl.feedback_comb(ins[0], ins[1], D, ins[2])
        torch.sum(y * torch.from_numpy(ybar)).backward()
    yj = np.asarray(yj, np.float64)
    assert np.abs(y.detach().numpy() - yj).max() <= COMB_RTOL * np.abs(
        yj).max()
    for name, t, w in zip(("x", "decay", "history"), ins, want):
        w = np.asarray(w, np.float64)
        err = np.abs(t.grad.numpy() - w).max() / max(np.abs(w).max(), 1e-30)
        assert err <= GRAD_RTOL, (name, err)


@pytest.mark.parametrize("T_env", [2048, 70_016])
def test_envelope_backward_matches_jax_grad(T_env):
    """EnvCore's backward against jax.grad through the JAX package's
    peak_envelope (its analytic custom_vjp), with traced frame counts: the
    sequential branch, and the chunked one (T > 2 x 32768)."""
    rng = np.random.default_rng(11)
    x = (rng.standard_normal((2, T_env)) * 0.5).astype(np.float32)
    e0 = np.float32([0.2, 0.0])
    ybar = rng.standard_normal((2, T_env)).astype(np.float32)
    fbar = rng.standard_normal(2).astype(np.float32)
    atk, rel = np.float32(10.0), np.float32(60.0)

    def f(xx, aa, rr, ee):
        env, fin = je.peak_envelope(xx, aa, rr, ee)
        return jnp.sum(env * ybar) + jnp.sum(fin * fbar)
    with jprec.policy("fast"):
        want = jax.jit(jax.grad(f, argnums=(0, 1, 2, 3)))(x, atk, rel, e0)
    ins = [torch.tensor(v, requires_grad=True) for v in (x, atk, rel, e0)]
    with tprec.policy("fast"):
        env, fin = te.peak_envelope(*ins)
        (torch.sum(env * torch.from_numpy(ybar))
         + torch.sum(fin * torch.from_numpy(fbar))).backward()
    for name, t, w in zip(("x", "attack", "release", "env0"), ins, want):
        w = np.asarray(w, np.float64)
        err = np.abs(t.grad.numpy() - w).max() / max(np.abs(w).max(), 1e-30)
        assert err <= ENV_RTOL, (name, err)
