"""The per-node feedback-cycle scan as a loop over static buffers
(dsp_stuff_tpu_torch/compiler/cycle_loop.py) on the CPU, where the
buffers run eagerly (``cg.cycle_loops.route = "buffers"``): everything
the card's captured loop runs but the capture itself.

* The buffered loop is bitwise the Python loop (``route = "eager"``):
  outputs, aux and states (counters as Python ints), with K = 1 and K = 8
  and a block count K does not divide, for config5 under fast with its
  feedback gain overridden (the per-node route with the first-order
  solve), parity and exact, a float and a tensor override, a re-render
  at another slider value (the same loop, its binding moved), a block
  size of 256, and fuzz graphs whose cycles hold a chorus, a FIR, an
  envelope, mux and demux.
* With ``CYCLE_FUSION`` off in both packages, config5 against the JAX
  package's per-node ``lax.scan`` at tests/test_torch_presets.py's
  VS_JAX_DB (-100 dBFS) under fast, parity and exact; exact-pool fuzz
  graphs with cycles under exact bitwise the JAX package; the port's
  fused cycle against its per-node loop at -120 dBFS
  (tests/test_cycle_segment.py:30, the CPU bound).
* Two chained renders against one: bitwise under parity and exact (and
  the buffered chain bitwise the Python loop's under fast, where the
  chain segment's blocked solves round differently at another length:
  <= -135 dBFS, tests/test_torch_presets.py's HANDOFF_DB).
* After one warm-up chunk a chunk dispatches no host-data tensor and no
  host read (tests/test_torch_stream_graph.py's capturability check).
* The route's rule: the Python loop on the CPU by default, with
  ``NODE_HOOK`` set and for one block; under autograd "buffers" runs the
  differentiated loop (tests/test_torch_cycle_loop_grad.py); on the card
  "auto" replays from ``MIN_BLOCKS`` blocks; ``eager()`` pins the Python
  loop for a block of code, as a stream step does, and puts the route
  back.
"""

import types

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import dsp_stuff_tpu as dj
import dsp_stuff_tpu_torch as dt
from dsp_stuff_tpu.compiler import compile as jcompile
from dsp_stuff_tpu.models import presets as jp
from dsp_stuff_tpu_torch.compiler import compile as tcompile
from dsp_stuff_tpu_torch.compiler import cycle_loop
from dsp_stuff_tpu_torch.models import presets as tp
from dsp_stuff_tpu_torch.runtime.block_graph import BlockStep
from dsp_stuff_tpu_torch.utils import precision as tprec

import chip_smoke
import test_torch_fuzz_gen as tfuzz

VS_JAX_DB = -100.0
FUSED_VS_SCAN_DB = -120.0
HANDOFF_DB = -135.0
B, NB = 2, 21              # 21 blocks: a head of 2, then 19 = 2 x 8 + 3
T = NB * 128
FBG = "8"                  # config5's feedback gain
#: (policy, params) of the per-node routes of config5
ROUTES = {"fast-override": ("fast", {FBG: {"level": 0.6}}),
          "parity": ("parity", None), "exact": ("exact", None)}
#: fuzz seeds whose feedback cycles hold a chorus (6, 23, 41), a FIR (15,
#: 41), an envelope (22, 46), mux and demux (46)
FUZZ_SEEDS = (6, 15, 22, 23, 41, 46)
#: exact-pool fuzz seeds whose cycles hold a reverb (8, 12, 45), a FIR
#: (38), mux (12)
EXACT_SEEDS = (8, 12, 38, 45)
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


def _dbfs(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    return 20 * np.log10(max(err, 1e-30) / max(np.abs(want).max(), 1e-30))


def _x(seed=0, batch=(B,), length=T):
    return torch.from_numpy(
        (np.random.default_rng(seed).standard_normal((*batch, 1, length))
         * 0.3).astype(np.float32))


def _same(a, b, path="state"):
    """Equal trees: tensors bitwise with their shapes and dtypes, the rest
    of the same type and value."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor), path
        assert a.shape == b.shape and a.dtype == b.dtype, path
        assert torch.equal(a, b), path
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


def _render(cg, x, route, params=None, state=None):
    cg.cycle_loops.route = route
    return cg.render(x, batch_shape=x.shape[:-2], params=params, state=state)


def _config5(pol, **kw):
    with dt.policy(pol):
        return dt.compile_graph(tp.config5_feedback_16node()[0], device="cpu",
                                **kw)


# -- bitwise the Python loop ---------------------------------------------------

@pytest.mark.parametrize("chunk", [1, 8])
@pytest.mark.parametrize("route", list(ROUTES))
def test_buffers_bitwise_python_loop(route, chunk, monkeypatch):
    monkeypatch.setattr(cycle_loop, "CHUNK", chunk)
    pol, params = ROUTES[route]
    cg = _config5(pol)
    x = _x()
    with dt.policy(pol):
        want = _render(cg, x, "eager", params)
        got = _render(cg, x, "buffers", params)
    loops = cg.cycle_loops
    head, full, rest = loops.plan
    assert head == 2 and head + full * chunk + rest == NB
    assert (full, rest) == divmod(NB - head, chunk)
    assert loops.captures == loops.replays == 0          # the CPU
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
    _same(got[1], want[1], "aux")
    _same(got[2], want[2])
    assert type(got[2]["6"]["pos"]) is int               # the reverb's


@pytest.mark.parametrize("value", [0.6, torch.tensor(0.6)])
def test_moved_override_reuses_the_loop(value):
    """A re-render with another value of the overridden slider (a float
    or a tensor) runs the same loop, its binding moved, bitwise the
    Python loop at that value."""
    cg = _config5("fast")
    x = _x(1)
    with dt.policy("fast"):
        _render(cg, x, "buffers", {FBG: {"level": value}})
        loop = cg.cycle_loops.last
        moved = (0.3 if isinstance(value, float)
                 else torch.tensor(0.3))
        got = _render(cg, x, "buffers", {FBG: {"level": moved}})
        assert cg.cycle_loops.last is loop
        assert len(cg.cycle_loops._loops) == 1
        want = _render(cg, x, "eager", {FBG: {"level": 0.3}})
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
    _same(got[2], want[2])


def test_block_size_256_bitwise(monkeypatch):
    """A block size the block program does not take: the per-node scan
    under fast, its buffers bitwise the Python loop."""
    monkeypatch.setattr(cycle_loop, "CHUNK", 4)
    cg = _config5("fast", block_size=256)
    x = _x(2, length=256 * 11)
    with dt.policy("fast"):
        want = _render(cg, x, "eager")
        got = _render(cg, x, "buffers")
    assert cg.cycle_loops.plan[0] >= 1
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
    _same(got[2], want[2])


@pytest.mark.parametrize("pol", ["fast", "parity"])
@pytest.mark.parametrize("seed", FUZZ_SEEDS)
def test_fuzz_cycles_bitwise_python_loop(seed, pol, monkeypatch):
    monkeypatch.setattr(cycle_loop, "CHUNK", 4)
    g, inp_id, _ = tfuzz._random_graph(seed)
    with dt.policy(pol):
        cg = dt.compile_graph(g, device="cpu")
        x = {str(inp_id): _x(seed, length=128 * 12)[:, 0]}
        want = cg.render(x, batch_shape=(B,))
        cg.cycle_loops.route = "buffers"
        got = cg.render(x, batch_shape=(B,))
    ran = cg.cycle_loops.plan is not None
    # under fast a cycle the block program takes runs no per-node scan
    assert ran or pol == "fast"
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
    _same(got[1], want[1], "aux")
    _same(got[2], want[2])


# -- against the JAX package's per-node scan -----------------------------------

@pytest.mark.parametrize("pol", ["fast", "parity", "exact"])
def test_config5_per_node_scan_vs_jax(pol, monkeypatch):
    """CYCLE_FUSION off in both packages: the port's buffered loop
    against the JAX package's per-node ``lax.scan``, exact bitwise."""
    monkeypatch.setattr(jcompile, "CYCLE_FUSION", False)
    monkeypatch.setattr(tcompile, "CYCLE_FUSION", False)
    x = _x(3)
    with dj.policy(pol):
        yj, _, sj = dj.compile_graph(jp.config5_feedback_16node()[0]).render(
            x.numpy(), batch_shape=(B,))
    cg = _config5(pol)
    with dt.policy(pol):
        yt, _, st = _render(cg, x, "buffers")
    assert cg.cycle_loops.plan[0] == 2
    # config5 is not an exact-pool graph: its LFO, overdrive and envelope
    # keep it off the JAX package's bits under exact too (ROADMAP Queue 3)
    assert _dbfs(yt.numpy(), np.asarray(yj)) <= VS_JAX_DB
    for nid in ("5", "6", "7", "8"):                    # the cycle's members
        for kk, w in (sj[nid] or {}).items():
            np.testing.assert_allclose(np.asarray(st[nid][kk], np.float64),
                                       np.asarray(w, np.float64), rtol=0,
                                       atol=2e-5)


@pytest.mark.parametrize("seed", EXACT_SEEDS)
def test_exact_pool_cycles_bitwise_jax(seed):
    """Exact-pool fuzz graphs with feedback cycles under exact: the port's
    buffered loop is the JAX package's per-node scan, bit for bit, and
    the Python loop's."""
    from dsp_stuff_tpu.utils import precision as jprec
    import test_fuzz_graphs as jfuzz
    g, inp_id, _ = tfuzz._random_graph(seed, exact=True)
    gj, _, _ = jfuzz._random_graph(seed, exact=True)
    x = _x(seed, length=128 * 12)[:, 0].numpy()
    with jprec.policy("exact"):
        yj, _, _ = dj.compile_graph(gj).render({str(inp_id): x},
                                               batch_shape=(B,))
    with dt.policy("exact"):
        cg = dt.compile_graph(g, device="cpu")
        ext = {str(inp_id): torch.from_numpy(x)}
        want = cg.render(ext, batch_shape=(B,))
        cg.cycle_loops.route = "buffers"
        got = cg.render(ext, batch_shape=(B,))
    assert cg.cycle_loops.plan is not None
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(yj))
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
    _same(got[2], want[2])


def test_fused_cycle_vs_per_node_loop(monkeypatch):
    """tests/test_cycle_segment.py:30: the fused cycle against the
    per-node scan, now the port's buffered loop."""
    x = _x(4)
    cg = _config5("fast")
    with dt.policy("fast"):
        yf, _, sf = cg.render(x, batch_shape=(B,))
        monkeypatch.setattr(tcompile, "CYCLE_FUSION", False)
        yu, _, su = _render(cg, x, "buffers")
    assert cg.cycle_loops.plan is not None
    assert _dbfs(yf.numpy(), yu.numpy()) <= FUSED_VS_SCAN_DB
    assert sf.keys() == su.keys()


# -- chained renders -----------------------------------------------------------

@pytest.mark.parametrize("route", list(ROUTES))
def test_chained_renders_equal_one(route):
    pol, params = ROUTES[route]
    cg = _config5(pol)
    x = _x(5)
    cut = 9 * 128
    with dt.policy(pol):
        one, _, _ = _render(cg, x, "buffers", params)
        y1, _, s1 = _render(cg, x[..., :cut], "buffers", params)
        y2, _, s2 = _render(cg, x[..., cut:], "buffers", params, s1)
        assert cg.cycle_loops.plan[0] == 1       # the state came in batched
        e1, _, t1 = _render(cg, x[..., :cut], "eager", params)
        e2, _, t2 = _render(cg, x[..., cut:], "eager", params, t1)
    both = torch.cat([y1, y2], dim=-1)
    torch.testing.assert_close(both, torch.cat([e1, e2], dim=-1), rtol=0,
                               atol=0)
    _same(s2, t2)
    if pol == "fast":
        assert _dbfs(both.numpy(), one.numpy()) <= HANDOFF_DB
    else:
        torch.testing.assert_close(both, one, rtol=0, atol=0)


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


def _capturable_case(case):
    """(compiled graph, input, policy, params) of a capturability case:
    config5 on a route of ROUTES, chip_smoke.loop_graph (whose cycle holds
    a pointwise group of two members) on one, or a fuzz seed whose cycle
    the block program does not take, under fast."""
    if case in ROUTES:
        pol, params = ROUTES[case]
        return _config5(pol), _x(6), pol, params
    if case.startswith("loop "):
        pol, params = ROUTES[case.split()[1]]
        params = params and {"5": params[FBG]}     # the loop's gain
        return (dt.compile_graph(chip_smoke.loop_graph(), device="cpu"),
                {"0": _x(6)[:, 0]}, pol, params)
    g, inp_id, _ = tfuzz._random_graph(int(case.split()[1]))
    x = {str(inp_id): _x(6, length=128 * 12)[:, 0]}
    return dt.compile_graph(g, device="cpu"), x, "fast", None


@pytest.mark.parametrize("case", list(ROUTES) + [
    f"loop {r}" for r in ROUTES] + [
    f"fuzz {seed}" for seed in (6, 15, 22, 41, 46)])
def test_chunk_is_capturable(case):
    """After a render (its first chunk the warm-up), a chunk of K bodies
    makes no tensor from host data and reads nothing back: the block
    index, the reverb's position, the chorus's clock and the FIR's count
    are counters on the device, the overridden slider a buffer, a
    pointwise group's operands from the device caches."""
    cg, x, pol, params = _capturable_case(case)
    with dt.policy(pol):
        cg.cycle_loops.route = "buffers"
        cg.render(x, batch_shape=(B,), params=params)
        loop = cg.cycle_loops.last
        assert loop is not None
        loop.counter.fill_(3)
        mode = _HostOps()
        with mode:
            loop.run(cycle_loop.CHUNK)
    assert mode.ops > 20
    assert not mode.host, f"{case}: {sorted(set(mode.host))}"
    assert int(loop.counter) == 3 + cycle_loop.CHUNK


def test_capture_keeps_the_collector_off():
    """A capture runs with Python's cyclic collector off (a collection
    inside it could finalize a dropped graph's CUDA graphs, which
    invalidates the capture underway); the collector's state is put
    back after it, an error included."""
    import gc
    from dsp_stuff_tpu_torch.utils.capture import no_collection
    assert gc.isenabled()
    with no_collection():
        assert not gc.isenabled()
    assert gc.isenabled()
    with pytest.raises(RuntimeError), no_collection():
        raise RuntimeError("a failed capture")
    assert gc.isenabled()
    gc.disable()
    try:
        with no_collection():
            pass
        assert not gc.isenabled()
    finally:
        gc.enable()


# -- the route's rule ----------------------------------------------------------

def test_route_rule_on_the_cpu():
    """On the CPU, "auto" keeps the Python loop; "buffers" takes a
    gradient too (the differentiated loop) and leaves a NODE_HOOK and a
    one-block render to the Python loop."""
    cg = _config5("parity")
    x = _x(7)
    with dt.policy("parity"):
        _render(cg, x, "auto")
        assert cg.cycle_loops.plan is None
        lvl = torch.tensor(0.45, requires_grad=True)
        y, _, _ = _render(cg, x, "buffers", {FBG: {"level": lvl}})
        assert cg.cycle_loops.plan is not None and y.requires_grad
        assert cg.cycle_loops.last.grad is not None
        cg.cycle_loops.plan = None
        with torch.no_grad():
            _render(cg, x, "buffers", {FBG: {"level": lvl}})
        assert cg.cycle_loops.plan is not None
        cg.cycle_loops.plan = None
        seen = []
        tcompile.NODE_HOOK = lambda nid, name, outs: seen.append(nid)
        try:
            _render(cg, x, "buffers")
        finally:
            tcompile.NODE_HOOK = None
        assert cg.cycle_loops.plan is None and seen
        _render(cg, x[..., :128], "buffers")
        assert cg.cycle_loops.plan is None


def test_auto_route_by_length(monkeypatch):
    """On the card (a CUDA device, no capture underway), "auto" replays a
    loop of MIN_BLOCKS blocks or more and leaves a shorter one to the
    Python loop; "buffers" takes any length past one block; inside
    ``eager()`` neither does, and the route is put back after it."""
    cg = _config5("parity")
    loops = cg.cycle_loops
    monkeypatch.setattr(cg, "device", torch.device("cuda", 0))
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    scan = types.SimpleNamespace(order=[], feeds=[])

    def takes(nb):
        return loops.takes(scan, {}, None, {}, {}, nb)
    n = cycle_loop.MIN_BLOCKS
    assert takes(n) and takes(10 * n) and not takes(n - 1)
    loops.route = "buffers"
    assert takes(2) and takes(n) and not takes(1)
    with loops.eager():
        assert loops.route == "eager" and not takes(n)
    assert loops.route == "buffers"


def test_stream_step_runs_the_python_loop():
    """A stream step of several blocks runs its cycle's blocks through the
    Python loop (the step is captured whole on the card), whatever the
    graph's route, and leaves the route as it was."""
    cg = _config5("parity")
    with dt.policy("parity"):
        cg.cycle_loops.route = "buffers"
        step = BlockStep(cg, 8 * 128)
        step.inputs.copy_(_x(9, batch=(1,), length=8 * 128)[0])
        step.run(None)
        assert cg.cycle_loops.plan is None
        assert cg.cycle_loops.route == "buffers"
        assert torch.isfinite(step.outputs).all()
        assert step.outputs.abs().max() > 0
