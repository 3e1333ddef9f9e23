"""The port's data parallelism over streams (dsp_stuff_tpu_torch/parallel/
mesh.py and train/fit.make_sharded_train_step) against the unsharded
render and step and against the JAX package's (dsp_stuff_tpu/parallel/
mesh.py on the conftest's 8 virtual CPU devices, tests/test_parallel.py).

Meshes here are lists of CPU devices (``make_mesh(["cpu"] * n)``): one
process renders each shard with the graph compiled for its device, so on
the CPU every shard runs the same plain versions.  Bounds:
  render_sharded vs the unsharded render       bitwise; the lockstep
      leaves (reverb pos, chorus t0) come back once, as ints.  config5
      over 2 and 8 shards within -130 dBFS instead: its cycle program's
      [rows, 128] x [128, 128] block products take another blocking on the
      CPU at one row than at several (a shard of 8 streams over 8 devices
      is one row), so a stream's sums round differently (measured -132.1
      dBFS at 8 shards, -585 at 2)
  a sharded segment's state continued unsharded vs one long render
      atol 1e-6 (as tests/test_parallel.py:80: T = 512 and 1024 fuse
      differently under fast)
  vs the JAX package's render_sharded          <= -110 dBFS
  sharded train step vs the unsharded step     loss and sliders rtol 1e-5,
      atol 1e-6 (the shard losses weighted and summed, the gradients
      summed in shard order: rounding only)
  vs the JAX package's make_sharded_train_step rtol 1e-3
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import dsp_stuff_tpu as dj
from dsp_stuff_tpu.ids import IdSpace as JIdSpace
from dsp_stuff_tpu.models import presets as jpresets
from dsp_stuff_tpu.parallel import mesh as jmesh
from dsp_stuff_tpu.train import fit as jfit
from dsp_stuff_tpu.utils import precision as jprec
import dsp_stuff_tpu_torch as dt
from dsp_stuff_tpu_torch import convert
from dsp_stuff_tpu_torch.ids import IdSpace as TIdSpace
from dsp_stuff_tpu_torch.parallel import mesh as tmesh
from dsp_stuff_tpu_torch.train import fit as tfit
from dsp_stuff_tpu_torch.utils import precision as tprec

VS_JAX_DB = -110.0
STEP_RTOL = 1e-5
STEP_ATOL = 1e-6
JAX_STEP_RTOL = 1e-3


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


def _lockstep(g):
    """Chain with reverb (shared 'pos' write clock) and chorus (shared 't0'
    sample clock): tests/test_parallel.py's lockstep graph."""
    inp = g.add("input")
    gn = g.add("gain", level=1.3)
    rv = g.add("reverb", seconds=0.003, decay=0.5)
    ch = g.add("chorus", rate=1.5, depth=0.002, mix=0.4)
    out = g.add("output")
    g.chain(inp, gn, rv, ch, out)
    return g


def _bench(g):
    inp = g.add("input")
    gn = g.add("gain", level=1.2)
    bq = g.add("biquad", a0=1.0, a1=-0.24, a2=0.0, b0=0.758, b1=0.0, b2=0.0)
    od = g.add("overdrive", boost=4.0, drive=0.6, level=0.9)
    lp = g.add("low_pass", ratio=0.6)
    hp = g.add("high_pass", ratio=0.2)
    ds = g.add("distort", mode="Tanh", level=3.0)
    ch = g.add("chebyshev", level_pos=2.0, level_neg=4.0)
    rv = g.add("reverb", seconds=0.003, decay=0.4)
    out = g.add("output")
    g.chain(inp, gn, bq, od, lp, hp, ds, ch, rv, out)
    return g


def _config5(g):
    return jpresets.config5_feedback_16node()[0]


GRAPHS = {"lockstep": _lockstep, "bench": _bench, "config5": _config5}


def _pair(name):
    gj = GRAPHS[name](dj.Graph(JIdSpace()))
    return gj, dt.loads_graph(dj.dumps_graph(gj), ids=TIdSpace())


def _x(S, T, seed):
    return (np.random.default_rng(seed).standard_normal((S, 1, T))
            * 0.25).astype(np.float32)


def _cpu_mesh(n):
    return tmesh.make_mesh(["cpu"] * n)


def _lockstep_leaves(st):
    return [v[k] for v in st.values() if isinstance(v, dict)
            for k in ("pos", "t0") if k in v]


# -- the mesh ---------------------------------------------------------------

def test_make_mesh(monkeypatch):
    """Devices as given (repeats allowed); without a card the default mesh
    raises, naming the CPU remedy."""
    m = tmesh.make_mesh(["cpu"] * 8)
    assert m.size == 8
    assert set(m.devices) == {torch.device("cpu")}
    with pytest.raises(ValueError, match="at least one"):
        tmesh.make_mesh([])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cpu"):
        tmesh.make_mesh()


def test_shard_streams_splits_the_stream_axis():
    x = torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3)
    parts = tmesh.shard_streams(x, _cpu_mesh(4))
    assert [tuple(p.shape) for p in parts] == [(2, 3)] * 4
    assert torch.equal(torch.cat(parts), x)
    with pytest.raises(ValueError, match="divide"):
        tmesh.shard_streams(x[:7], _cpu_mesh(4))


# -- render_sharded -------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 8])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_render_sharded_matches_unsharded(name, n):
    """Bitwise the unsharded batched render, outputs, aux and state (the
    JAX package holds its sharded render bitwise too,
    tests/test_parallel.py:51); lockstep leaves come back once.  config5
    on several shards within -130 dBFS (the module docstring says why)."""
    _, gt = _pair(name)
    S, T = 8, 512 if name != "config5" else 1024
    x = _x(S, T, 1)
    with tprec.policy("fast"):
        cg = dt.compile_graph(gt, device="cpu")
        y_sh, aux_sh, st_sh = tmesh.render_sharded(cg, x, _cpu_mesh(n))
        y, aux, st = cg.render(torch.from_numpy(x), batch_shape=(S,))
    if name == "config5" and n > 1:
        assert _dbfs(y_sh.numpy(), y.numpy()) <= -130.0
        assert y_sh.shape == y.shape
        return
    assert torch.equal(y_sh, y)
    assert st_sh.keys() == st.keys()
    for k in st:
        if isinstance(st[k], dict):
            for kk, v in st[k].items():
                if isinstance(v, torch.Tensor):
                    assert torch.equal(st_sh[k][kk], v), (k, kk)
                else:
                    assert st_sh[k][kk] == v, (k, kk)
    flat = jax.tree.leaves(jax.tree.map(np.asarray, (aux_sh, aux)))
    half = len(flat) // 2
    for a, b in zip(flat[:half], flat[half:]):
        np.testing.assert_array_equal(a, b)
    if name == "lockstep":
        leaves = _lockstep_leaves(st_sh)
        assert leaves and all(isinstance(v, int) for v in leaves)


def test_render_sharded_continuation_state():
    """A second segment fed the sharded first segment's state equals one
    long unsharded render (tests/test_parallel.py:62): the state comes
    back batched over every stream, on the graph's device."""
    _, gt = _pair("lockstep")
    mesh = _cpu_mesh(8)
    x = _x(8, 1024, 2)
    with tprec.policy("fast"):
        cg = dt.compile_graph(gt, device="cpu")
        long, _, _ = cg.render(torch.from_numpy(x), batch_shape=(8,))
        a, _, st = tmesh.render_sharded(cg, x[..., :512], mesh)
        b, _, _ = cg.render(torch.from_numpy(x[..., 512:]), state=st,
                            batch_shape=(8,))
    np.testing.assert_allclose(torch.cat([a, b], dim=-1).numpy(),
                               long.numpy(), atol=1e-6, rtol=0)


def test_render_sharded_matches_jax():
    """Against the JAX package's render_sharded over its 8-device mesh."""
    gj, gt = _pair("lockstep")
    x = _x(16, 512, 3)
    with jprec.policy("fast"):
        want, _, st_j = jmesh.render_sharded(dj.compile_graph(gj), x,
                                             jmesh.make_mesh())
    with tprec.policy("fast"):
        got, _, st_t = tmesh.render_sharded(
            dt.compile_graph(gt, device="cpu"), x, _cpu_mesh(8))
    assert _dbfs(got.numpy(), np.asarray(want)) <= VS_JAX_DB
    assert [int(np.asarray(v)) for v in _lockstep_leaves(st_j)] == \
        _lockstep_leaves(st_t)


def _lfo_sinks(g):
    """The bench chain plus sinks fed only by an unbatched LFO: a
    spectrogram keeping one column (an aux leaf [1, F], whose first dim
    is a one-stream shard's size) and a gain level modulated by it (an
    aux knob)."""
    _bench(g)
    lfo = g.add("signal_gen", mode="Sine", frequency=3.0, amplitude=0.5)
    spec = g.add("spectrogram", fft_size=128, buffer_size=1)
    gn = g.add("gain", level=1.0)
    g.connect(lfo, "out", spec, "in")
    g.connect(lfo, "out", gn, "level")
    return g


@pytest.mark.parametrize("n", [2, 8])
def test_render_sharded_batches_aux_of_unbatched_signals(n):
    """Aux leaves computed from signals no stream feeds come back batched
    over all S streams, as the JAX package's vmap returns them, also when
    their first dim equals a shard's stream count (S = 8 over 8 shards,
    a spectrogram of one column)."""
    gj = _lfo_sinks(dj.Graph(JIdSpace()))
    gt = dt.loads_graph(dj.dumps_graph(gj), ids=TIdSpace())
    S, T = 8, 512
    x = _x(S, T, 6)
    with tprec.policy("fast"):
        cg = dt.compile_graph(gt, device="cpu")
        _, aux_sh, _ = tmesh.render_sharded(cg, x, _cpu_mesh(n))
        _, aux, _ = cg.render(torch.from_numpy(x), batch_shape=(S,))
    with jprec.policy("fast"):
        _, aux_j, _ = jmesh.render_sharded(dj.compile_graph(gj), x,
                                           jmesh.make_mesh(n))
    got, want, jx = (jax.tree.leaves(jax.tree.map(np.asarray, a))
                     for a in (aux_sh, aux, aux_j))
    assert len(got) == len(want) == len(jx) == 2
    for a, b, c in zip(got, want, jx):
        assert a.shape == b.shape == c.shape and a.shape[0] == S
        np.testing.assert_array_equal(a, b)
    assert sorted(a.shape[1:] for a in got)[0] == ()        # the knob
    assert sorted(a.shape[1:] for a in got)[1][0] == 1      # one column


def test_render_sharded_takes_an_input_dict():
    _, gt = _pair("bench")
    x = _x(4, 512, 4)
    with tprec.policy("fast"):
        cg = dt.compile_graph(gt, device="cpu")
        key = str(cg.input_ids[0])
        y_d, _, _ = tmesh.render_sharded(cg, {key: x[:, 0]}, _cpu_mesh(2))
        y, _, _ = cg.render(torch.from_numpy(x), batch_shape=(4,))
    assert torch.equal(y_d, y)


# -- the sharded train step -----------------------------------------------------

def _step_inputs(name, S=8, T=512):
    gj, gt = _pair(name)
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((S, T)) * 0.25).astype(np.float32)
    target = (rng.standard_normal((S, 1, T)) * 0.1).astype(np.float32)
    return gj, gt, x, target


def _port_steps(cg, step, init, x, target, n=3):
    params = cg.init_params(requires_grad=True)
    opt = init(params)
    key = str(cg.input_ids[0])
    losses = []
    with tprec.policy("fast"):
        for _ in range(n):
            params, opt, loss = step(params, opt, cg.init_state(),
                                     {key: torch.from_numpy(x)},
                                     torch.from_numpy(target))
            losses.append(float(loss))
    return losses, params


@pytest.mark.parametrize("n", [1, 2, 8])
def test_sharded_train_step_matches_unsharded(n):
    """Three Adam steps of the bench chain's 16 sliders over 8 streams:
    sharded over n CPU devices against make_train_step on the whole
    batch."""
    _, gt, x, target = _step_inputs("bench")
    cg = dt.compile_graph(gt, device="cpu")
    want_l, want_p = _port_steps(cg, *tfit.make_train_step(
        cg, tfit.adam(1e-2)), x, target)
    got_l, got_p = _port_steps(cg, *tfit.make_sharded_train_step(
        cg, _cpu_mesh(n), tfit.adam(1e-2)), x, target)
    np.testing.assert_allclose(got_l, want_l, rtol=STEP_RTOL, atol=STEP_ATOL)
    for nid in want_p:
        for k in want_p[nid]:
            np.testing.assert_allclose(
                float(got_p[nid][k].detach()), float(want_p[nid][k].detach()),
                rtol=STEP_RTOL, atol=STEP_ATOL, err_msg=f"{nid}/{k}")


@pytest.mark.parametrize("how", ["edited in place", "a new dict"])
def test_sharded_train_step_takes_the_params_it_is_given(how):
    """A second step given other parameter values than the first step
    returned (sliders edited in place, or a freshly initialised dict with
    its own optimizer) renders every shard with those values: it matches
    the unsharded step given the same."""
    _, gt, x, target = _step_inputs("bench", S=4, T=256)
    cg = dt.compile_graph(gt, device="cpu")
    key = str(cg.input_ids[0])
    ext, tgt = {key: torch.from_numpy(x)}, torch.from_numpy(target)
    runs = []
    for step, init in (tfit.make_train_step(cg, tfit.adam(1e-2)),
                       tfit.make_sharded_train_step(cg, _cpu_mesh(4),
                                                    tfit.adam(1e-2))):
        params = cg.init_params(requires_grad=True)
        opt = init(params)
        with tprec.policy("fast"):
            params, opt, _ = step(params, opt, cg.init_state(), ext, tgt)
            if how == "edited in place":
                with torch.no_grad():
                    for e in params.values():
                        for v in e.values():
                            v.mul_(0.9)
            else:
                params = {n: {k: (v * 0.9).requires_grad_(True)
                              for k, v in e.items()}
                          for n, e in cg.init_params().items()}
                opt = init(params)
            params, opt, loss = step(params, opt, cg.init_state(), ext, tgt)
        runs.append((float(loss), params))
    (want_l, want_p), (got_l, got_p) = runs
    np.testing.assert_allclose(got_l, want_l, rtol=STEP_RTOL, atol=STEP_ATOL)
    for nid in want_p:
        for k in want_p[nid]:
            np.testing.assert_allclose(
                float(got_p[nid][k].detach()), float(want_p[nid][k].detach()),
                rtol=STEP_RTOL, atol=STEP_ATOL, err_msg=f"{nid}/{k}")


def test_sharded_train_step_is_deterministic():
    """Two runs of the same sharded steps agree bit for bit (the gradient
    sum runs in shard order)."""
    _, gt, x, target = _step_inputs("bench", S=4, T=256)
    cg = dt.compile_graph(gt, device="cpu")
    runs = [_port_steps(cg, *tfit.make_sharded_train_step(
        cg, _cpu_mesh(4), tfit.adam(1e-2)), x, target, n=2)
        for _ in range(2)]
    assert runs[0][0] == runs[1][0]
    for nid in runs[0][1]:
        for k in runs[0][1][nid]:
            assert torch.equal(runs[0][1][nid][k], runs[1][1][nid][k])


def test_sharded_train_step_matches_jax():
    """One step against the JAX package's make_sharded_train_step on its
    8-device mesh (optax.adam(1e-2)): the loss and every slider."""
    gj, gt, x, target = _step_inputs("bench")
    with jprec.policy("fast"):
        cgj = dj.compile_graph(gj)
        key = str(cgj.input_ids[0])
        step, init = jfit.make_sharded_train_step(cgj, jmesh.make_mesh(),
                                                  optax.adam(1e-2))
        pj = cgj.init_params()
        pj1, _, lj = step(pj, init(pj), cgj.init_state(),
                          {key: jnp.asarray(x)}, jnp.asarray(target))
    cg = dt.compile_graph(gt, device="cpu")
    got_l, got_p = _port_steps(cg, *tfit.make_sharded_train_step(
        cg, _cpu_mesh(8), tfit.adam(1e-2)), x, target, n=1)
    np.testing.assert_allclose(got_l[0], float(lj), rtol=JAX_STEP_RTOL)
    want = convert.params_from_jax(jax.tree.map(np.asarray, pj1), "cpu")
    for nid in want:
        for k in want[nid]:
            np.testing.assert_allclose(
                float(got_p[nid][k].detach()), float(want[nid][k]),
                rtol=JAX_STEP_RTOL, atol=1e-6, err_msg=f"{nid}/{k}")


def test_sharded_train_step_refuses_params_elsewhere():
    _, gt, x, target = _step_inputs("bench", S=2, T=256)
    cg = dt.compile_graph(gt, device="cpu")
    step, init = tfit.make_sharded_train_step(cg, _cpu_mesh(2))
    params = {n: {k: v.to("meta").requires_grad_(True) for k, v in e.items()}
              for n, e in cg.init_params().items()}
    with pytest.raises(ValueError, match="first device"):
        step(params, init(params), cg.init_state(),
             {str(cg.input_ids[0]): torch.from_numpy(x)},
             torch.from_numpy(target))
