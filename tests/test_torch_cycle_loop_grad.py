"""The backward of the per-node feedback-cycle scan over static buffers
(dsp_stuff_tpu_torch/compiler/cycle_loop.py, ``_ScanGrad``) on the CPU,
where ``cg.cycle_loops.route = "buffers"`` runs its forward, checkpoints,
record and reverse bodies eagerly: everything the card's replayed
backward runs but the captures.

* config5 with every slider a leaf under fast, parity and exact, from a
  seeded reverb ring that requires grad: the loss (bitwise: the forward
  is the Python loop's), each slider's gradient (rtol 1e-5, or 1e-7 abs
  near 0), the input's and the ring's gradients (1e-5 max-normalized)
  and the final states (bitwise) against the Python loop's autograd
  (``route = "eager"``); also with the final states in the loss, so the
  states' own cotangents enter the backward.
* With ``CYCLE_FUSION`` off in both packages, against ``jax.grad`` of the
  JAX package's ``make_loss_fn`` under fast and parity: rtol 1e-3,
  arrays max-normalized (PERF.md's gradient row).
* Checkpoint segments (``SEGMENT`` patched): a loop of blocks a multiple
  of S, not a multiple, fewer than S, and S = 1, each bitwise the
  default S (checkpoints change no arithmetic) and held to the Python
  loop.
* Four fuzz graphs whose cycles hold a chorus, a FIR, an envelope, mux
  and demux, every slider a leaf.
* A second train step with moved slider values runs the same loop, its
  binding and gradient buffers; a no-grad render takes the forward alone;
  a second-order gradient raises, naming the cycle; two forwards before
  one backward each get their own loop; a backward after its loop ran
  again raises.
* After a differentiated render, the save, restore, record and reverse
  bodies make no tensor from host data and read nothing back
  (tests/test_torch_cycle_loop.py's capturability check), so the card
  can capture them.
"""

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import dsp_stuff_tpu as dj
from dsp_stuff_tpu.compiler import compile as jcompile
from dsp_stuff_tpu.models import presets as jp
from dsp_stuff_tpu.train import fit as jfit
from dsp_stuff_tpu.utils import precision as jprec
import dsp_stuff_tpu_torch as dt
from dsp_stuff_tpu_torch import convert
from dsp_stuff_tpu_torch.compiler import compile as tcompile
from dsp_stuff_tpu_torch.compiler import cycle_loop
from dsp_stuff_tpu_torch.compiler import pointwise as pw
from dsp_stuff_tpu_torch.models import presets as tp
from dsp_stuff_tpu_torch.ops import pointwise_kernel as pk
from dsp_stuff_tpu_torch.train import fit as tfit
from dsp_stuff_tpu_torch.utils import precision as tprec

import chip_smoke
import test_torch_fuzz_gen as tfuzz

ARRAY_TOL = 1e-5          # replayed backward vs the Python loop, max-normalized
SLIDER_RTOL, SLIDER_ATOL = 1e-5, 1e-7
JAX_RTOL = 1e-3           # vs jax.grad (PERF.md section 2)
B, NB = 2, 21             # 21 blocks: a head of 2, then 19 in the loop
T = NB * 128
REVERB = "6"              # config5's reverb, in the loop with 7, 8, 5
FBG = "8"                 # config5's feedback gain
#: fuzz seeds whose feedback cycles hold a chorus (6), a FIR (15), an
#: envelope (22), a chorus and a FIR (41) (tests/test_torch_cycle_loop.py)
FUZZ_SEEDS = (6, 15, 22, 41)
#: the host ops a capture refuses (tests/test_torch_stream_graph.py)
HOST_OPS = {"aten.lift_fresh.default", "aten._local_scalar_dense.default",
            "aten.item.default", "aten.nonzero.default", "aten.equal.default",
            "aten.is_nonzero.default"}


@pytest.fixture(autouse=True)
def _torch_env():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    prev = tprec.get_policy()
    yield
    tprec.set_policy(prev)
    torch.set_num_threads(threads)


def _inputs(seed, length=T):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, length)) * 0.3).astype(np.float32)
    tgt = (rng.standard_normal((B, 1, length)) * 0.1).astype(np.float32)
    return x, tgt


def _config5(pol, **kw):
    with dt.policy(pol):
        return dt.compile_graph(tp.config5_feedback_16node()[0], device="cpu",
                                **kw)


def _seeded_state(cg, seed):
    """config5's initial state with its reverb ring seeded (so the ring's
    echo, the decay slider and the ring's own gradient all count inside
    21 blocks), the ring a leaf that requires grad."""
    st = cg.init_state()
    ring = st[REVERB]["ring"]
    st[REVERB] = dict(st[REVERB], ring=torch.from_numpy(
        (np.random.default_rng(seed).standard_normal(ring.shape) * 0.2)
        .astype(np.float32)).requires_grad_())
    return st


def _grads(cg, pol, route, x_np, tgt_np, state=None, state_loss=False,
           inp=None, params=None):
    """The loss, its gradients (each slider, the input, the seeded ring)
    and the final state of one differentiated render on ``route``, every
    slider a leaf unless ``params`` says otherwise."""
    inp = inp or str(min(cg.input_ids))
    with dt.policy(pol):
        cg.cycle_loops.route = route
        if params is None:
            params = cg.init_params(requires_grad=True)
        x = torch.from_numpy(x_np).requires_grad_()
        state = cg.init_state() if state is None else state
        st, outs, _ = cg.fn(state, {inp: x}, params)
        y = torch.stack([outs[i] for i in cg.output_ids], dim=-2)
        loss = torch.mean(tfit.mse_loss(y, torch.from_numpy(tgt_np)))
        if state_loss:
            loss = loss + sum(torch.mean(v * v) for nid in (REVERB, "7")
                              for v in st[nid].values()
                              if isinstance(v, torch.Tensor)
                              and v.is_floating_point())
        loss.backward()
    ring = state.get(REVERB, {}).get("ring") if isinstance(
        state.get(REVERB), dict) else None
    return {"loss": loss.detach(), "x": x.grad,
            "ring": None if ring is None else ring.grad,
            "sliders": {(n, k): v.grad for n, e in params.items()
                        for k, v in e.items()},
            "state": st, "plan": cg.cycle_loops.plan}


def _rel_err(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def _held(got, want, arrays=ARRAY_TOL, rtol=SLIDER_RTOL, atol=SLIDER_ATOL):
    """``got`` (the buffers' backward) against ``want``: loss bitwise,
    sliders within rtol or atol (a slider no block reads has no gradient
    in either), arrays max-normalized."""
    torch.testing.assert_close(got["loss"], want["loss"], rtol=0, atol=0)
    assert got["sliders"].keys() == want["sliders"].keys()
    for k, w in want["sliders"].items():
        g = got["sliders"][k]
        assert (g is None) == (w is None), k
        if w is not None:
            assert abs(float(g) - float(w)) <= max(rtol * abs(float(w)),
                                                   atol), (k, g, w)
    for name in ("x", "ring"):
        if want[name] is not None:
            assert _rel_err(got[name], want[name]) <= arrays, name


def _same_state(a, b, path="state"):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _same_state(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a.detach(), b.detach()), path
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


# -- against the Python loop's autograd ----------------------------------------

@pytest.mark.parametrize("state_loss", [False, True])
@pytest.mark.parametrize("pol", ["fast", "parity", "exact"])
def test_config5_backward_vs_python_loop(pol, state_loss):
    x, tgt = _inputs(0)
    cg = _config5(pol)
    want = _grads(cg, pol, "eager", x, tgt, _seeded_state(cg, 1), state_loss)
    assert want["plan"] is None
    got = _grads(cg, pol, "buffers", x, tgt, _seeded_state(cg, 1),
                 state_loss)
    head, full, rest = got["plan"]
    assert head == 2 and full + rest == NB - head
    loop = cg.cycle_loops.last
    assert loop.grad is not None and not loop.pending()
    assert cg.cycle_loops.captures == 0                 # the CPU
    _held(got, want)
    _same_state(got["state"], want["state"])
    assert float(got["sliders"][(REVERB, "decay")]) != 0.0


# -- against jax.grad ----------------------------------------------------------

@pytest.mark.parametrize("pol", ["fast", "parity"])
def test_config5_vs_jax_grad(pol, monkeypatch):
    """CYCLE_FUSION off in both packages: every slider's and the input's
    gradient through the buffers' backward against jax.grad of the JAX
    package's loss through its per-node lax.scan."""
    monkeypatch.setattr(jcompile, "CYCLE_FUSION", False)
    monkeypatch.setattr(tcompile, "CYCLE_FUSION", False)
    gj, meta = jp.config5_feedback_16node()
    inp = str(meta["input"])
    x, tgt = _inputs(2, 1024)
    with jprec.policy(pol):
        cgj = dj.compile_graph(gj)
        pj = cgj.init_params()
        lj, (gpj, gxj) = jax.jit(jax.value_and_grad(
            jfit.make_loss_fn(cgj), argnums=(0, 2)))(
            pj, cgj.init_state(), {inp: x}, tgt)
    cg = _config5(pol)
    with dt.policy(pol):
        cg.cycle_loops.route = "buffers"
        params = convert.params_from_jax(jax.tree.map(np.asarray, pj), "cpu",
                                         requires_grad=True)
        xt = torch.from_numpy(x).requires_grad_()
        loss = tfit.make_loss_fn(cg)(params, cg.init_state(), {inp: xt},
                                     torch.from_numpy(tgt))
        loss.backward()
    assert cg.cycle_loops.plan is not None
    assert abs(float(loss.detach()) - float(lj)) <= JAX_RTOL * abs(float(lj))
    for n in sorted(params):
        for k, v in params[n].items():
            g = 0.0 if v.grad is None else float(v.grad)
            w = float(gpj[n][k])
            assert np.isfinite(g)
            assert abs(g - w) <= max(JAX_RTOL * abs(w), 1e-9), (n, k, g, w)
    gx = np.asarray(gxj[inp])
    err = np.abs(xt.grad.numpy() - gx).max() / np.abs(gx).max()
    assert err <= JAX_RTOL, err


# -- checkpoint segments -------------------------------------------------------

@pytest.mark.parametrize("segment", [19, 5, 64, 1])
def test_checkpoint_segments(segment, monkeypatch):
    """19 blocks in the loop: S = 19 (one segment), 5 (three and a ragged
    one), 64 (fewer blocks than S) and 1: every gradient bitwise the
    default S's, and within the bounds of the Python loop's."""
    x, tgt = _inputs(3)
    cg = _config5("parity")
    base = _grads(cg, "parity", "buffers", x, tgt, _seeded_state(cg, 4))
    want = _grads(cg, "parity", "eager", x, tgt, _seeded_state(cg, 4))
    monkeypatch.setattr(cycle_loop, "SEGMENT", segment)
    cg = _config5("parity")
    got = _grads(cg, "parity", "buffers", x, tgt, _seeded_state(cg, 4))
    loop = cg.cycle_loops.last
    n = NB - got["plan"][0]
    assert loop.grad.ck_counter.shape[0] == -(-(NB - 1) // segment)
    assert [s for s, _ in loop.segments(2, NB)] == list(range(2, NB, segment))
    assert int(loop.grad.slot) == 0 and n == 19
    _held(got, base, arrays=0.0, rtol=0.0, atol=0.0)
    _held(got, want)


# -- fuzz cycles ---------------------------------------------------------------

@pytest.mark.parametrize("seed", FUZZ_SEEDS)
def test_fuzz_cycles_backward(seed):
    g, inp_id, _ = tfuzz._random_graph(seed)
    x, tgt = _inputs(seed, 128 * 12)
    with dt.policy("fast"):
        cg = dt.compile_graph(g, device="cpu")
    tgt = np.repeat(tgt, len(cg.output_ids), axis=1)
    want = _grads(cg, "fast", "eager", x, tgt, inp=str(inp_id))
    got = _grads(cg, "fast", "buffers", x, tgt, inp=str(inp_id))
    assert got["plan"] is not None and cg.cycle_loops.last.grad is not None
    _held(got, want)
    _same_state(got["state"], want["state"])


# -- the loop's lifetime -------------------------------------------------------

def test_second_step_rebinds_nothing():
    """Two make_train_step steps: the second moves the sliders' values into
    the same loop's binding and runs the same gradient buffers; each
    step's loss is the Python loop's at its values."""
    x, tgt = _inputs(5)
    cg = _config5("fast")
    inp = str(min(cg.input_ids))
    ext, target = {inp: torch.from_numpy(x)}, torch.from_numpy(tgt)
    losses = {}
    for route in ("buffers", "eager"):
        with dt.policy("fast"):
            cg.cycle_loops.route = route
            params = cg.init_params(requires_grad=True)
            step, init = tfit.make_train_step(cg, tfit.adam(0.05))
            opt = init(params)
            seen = []
            for _ in range(2):
                _, _, loss = step(params, opt, cg.init_state(), ext, target)
                seen.append(loss)
                if route == "buffers":
                    loop = cg.cycle_loops.last
                    seen.append((loop, loop.binding, loop.grad))
        losses[route] = seen
    b = losses["buffers"]
    assert b[1][0] is b[3][0] and b[1][1] is b[3][1] and b[1][2] is b[3][2]
    assert len(cg.cycle_loops._loops) == 1
    torch.testing.assert_close(b[0], losses["eager"][0], rtol=0, atol=0)
    torch.testing.assert_close(b[2], losses["eager"][1], rtol=1e-6, atol=0)


def test_no_grad_render_takes_the_forward():
    """A render under no_grad (or with nothing that requires grad) runs
    the forward's loop over buffers: no Function, no gradient buffers."""
    x, _ = _inputs(6)
    cg = _config5("parity")
    with dt.policy("parity"):
        cg.cycle_loops.route = "buffers"
        params = cg.init_params(requires_grad=True)
        with torch.no_grad():
            y, _, _ = cg.render(torch.from_numpy(x)[:, None],
                                batch_shape=(B,), params=params)
        loop = cg.cycle_loops.last
        assert cg.cycle_loops.plan is not None and loop.grad is None
        assert y.grad_fn is None
        fixed = {n: {k: v.detach() for k, v in e.items()}
                 for n, e in params.items()}
        y2, _, _ = cg.render(torch.from_numpy(x)[:, None], batch_shape=(B,),
                             params=fixed)
        assert cg.cycle_loops.last is loop and loop.grad is None
        assert y2.grad_fn is None
        cg.cycle_loops.route = "eager"
        y3, _, _ = cg.render(torch.from_numpy(x)[:, None], batch_shape=(B,),
                             params=fixed)
    torch.testing.assert_close(y, y2, rtol=0, atol=0)
    torch.testing.assert_close(y, y3, rtol=0, atol=0)


def test_second_order_raises():
    x, tgt = _inputs(7)
    cg = _config5("fast")
    with dt.policy("fast"):
        cg.cycle_loops.route = "buffers"
        params = cg.init_params(requires_grad=True)
        loss = tfit.make_loss_fn(cg)(params, cg.init_state(),
                                     {"0": torch.from_numpy(x)},
                                     torch.from_numpy(tgt))
        leaves = [v for e in params.values() for v in e.values()]
        with pytest.raises(RuntimeError, match=r"feedback cycle \[5, 6, 7, "
                                               r"8\].*second-order"):
            torch.autograd.grad(loss, leaves, create_graph=True,
                                allow_unused=True)


def test_two_forwards_before_one_backward():
    """A second differentiated render while the first's backward is due
    runs on a loop of its own; both backwards match the Python loop's."""
    x1, tgt = _inputs(8)
    x2, _ = _inputs(9)
    grads = {}
    for route in ("buffers", "eager"):
        cg = _config5("fast")
        with dt.policy("fast"):
            cg.cycle_loops.route = route
            params = cg.init_params(requires_grad=True)
            fn = tfit.make_loss_fn(cg)
            loss = sum(fn(params, cg.init_state(), {"0": torch.from_numpy(x)},
                          torch.from_numpy(tgt)) for x in (x1, x2))
            if route == "buffers":
                first = cg.cycle_loops.last
                assert len(cg.cycle_loops._loops) == 1 and first.pending()
            loss.backward()
        grads[route] = [v.grad for e in params.values() for v in e.values()]
    assert not first.pending()
    for g, w in zip(grads["buffers"], grads["eager"]):
        assert (g is None) == (w is None)
        if w is not None:
            assert abs(float(g) - float(w)) <= max(
                SLIDER_RTOL * abs(float(w)), SLIDER_ATOL)


def test_backward_after_the_loop_ran_again_raises():
    x, tgt = _inputs(10)
    cg = _config5("fast")
    with dt.policy("fast"):
        cg.cycle_loops.route = "buffers"
        params = cg.init_params(requires_grad=True)
        fn = tfit.make_loss_fn(cg)
        loss = fn(params, cg.init_state(), {"0": torch.from_numpy(x)},
                  torch.from_numpy(tgt))
        loss.backward(retain_graph=True)
        with torch.no_grad():
            fn(params, cg.init_state(), {"0": torch.from_numpy(x)},
               torch.from_numpy(tgt))
        with pytest.raises(RuntimeError, match="ran again"):
            loss.backward()


# -- what a capture refuses ----------------------------------------------------

class _HostOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.host, self.ops = [], 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops += 1
        if str(func) in HOST_OPS:
            self.host.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("graph", ["config5", "loop"])
@pytest.mark.parametrize("kind", ["save", "restore", "record", "reverse"])
@pytest.mark.parametrize("pol", ["fast", "parity", "exact"])
def test_backward_bodies_are_capturable(pol, kind, graph, monkeypatch):
    """After a differentiated render, each body of the backward (the
    reverse with autograd's own backward ops inside it) makes no tensor
    from host data and reads nothing back.  Every slider is a leaf under
    parity and exact; under fast the feedback gain alone, as on the
    fast-override route (the plain version of the first-order kernel,
    which a tensor ratio takes on the CPU, reads its coefficient on the
    host; the kernel takes it on the device).  config5's cycle holds two
    pointwise groups, chip_smoke.loop_graph's a group of two members,
    which go through PointwiseGroup as on the card (its backward the
    reverse kernel's plain version, group_adjoint)."""
    x, tgt = _inputs(11)
    if graph == "config5":
        cg, fbg = _config5(pol), FBG
        state = _seeded_state(cg, 12)
    else:
        with dt.policy(pol):
            cg = dt.compile_graph(chip_smoke.loop_graph(), device="cpu")
        fbg, state = "5", None
        monkeypatch.setattr(tcompile, "group_call", lambda prog, sigs,
                            scals, Tn, d: pk.run(pw.interpret, prog, sigs,
                                                 scals, Tn, d,
                                                 pk.group_adjoint))
    params = ({fbg: {"level": torch.tensor(0.45, requires_grad=True)}}
              if pol == "fast" else None)
    _grads(cg, pol, "buffers", x, tgt, state, params=params)
    loop = cg.cycle_loops.last
    g = loop.grad
    g.slot.fill_(0 if kind == "save" else 1)
    if kind in ("record", "reverse"):
        loop.run("restore")
    if kind == "reverse":
        loop.run("record")
    key = ("reverse", (True,)) if kind == "reverse" else kind
    before = int(loop.counter)
    mode = _HostOps()
    with dt.policy(pol), mode:
        loop.run(key)
    assert mode.ops > 5
    assert not mode.host, f"{pol} {kind}: {sorted(set(mode.host))}"
    step = {"save": 0, "restore": 0, "record": 1, "reverse": -1}[kind]
    if kind != "restore":
        assert int(loop.counter) == before + step
    if kind == "reverse":
        assert int(loop.counter) == int(g.seg)
