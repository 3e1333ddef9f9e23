"""A stream's sliders as data (dsp_stuff_tpu_torch/runtime/block_graph.py,
utils/sliders.py) on the CPU.

The JAX package passes a stream's params to its jitted step as
arguments: a moved slider runs the same compiled step.  The port's step
binds them: a float override is a root of utils/sliders (the nodes derive
what their float path derives from it on the host and read it from
device buffers), a tensor override a device buffer; a move copies the
values in, and the capture is keyed on the params' structure.  The CPU
runs the same binding and buffers as the card, with plain calls in place
of the graph's replays.  Held here:

  every non-static slider kind, moved every block (new dicts and edits
  in place), under fast, parity and exact: bitwise the eager loop that
  takes the values as Python floats, one binding for the stream, and
  within VS_JAX_DB[pol] of the JAX package's StreamSession.process fed
  the same params (exact: parity's bound; the chorus and the envelope at
  the bounds tests/test_torch_presets.py holds config2 and config5 to,
  which the unmoved stream needs as well)
  larger blocks (the blocked solves' longer carries), tensor overrides
  of every kind, process_many after a move                   bitwise
  the blocked first-order solve with a 0-d tensor coefficient (parity
  on the card): no host read, the host-built powers' numbers
  BlockStep.key: unmoved by value moves; moved by a slider added or
  removed, a float become a tensor, a shape or dtype, the policy
  a biquad's form (gain, FIR, first order, full) under fast: a move
  inside a form keeps the binding, a move across forms binds anew
  the steady step with float overrides of every kind makes no tensor
  from host data and no host read
  the envelope's device-gain route (one [2] gains tensor, as the
  kernel takes it) from host floats, a slider's buffer and tensors:
  bitwise _seq_scan and _chunked_batched with host gains
  pitch's thresholds: an override raises, as the JAX package's
  process() does
  a reverb's decay, float or tensor: a stream block stays inside the
  delay line (no blocked comb), bitwise the eager loop
"""

import numpy as np
import pytest
import torch

import dsp_stuff_tpu as dj
import dsp_stuff_tpu_torch as dt
from dsp_stuff_tpu.ids import IdSpace as JIdSpace
from dsp_stuff_tpu.runtime.stream import StreamSession as JStreamSession
from dsp_stuff_tpu_torch.ids import IdSpace
from dsp_stuff_tpu_torch.ops import envelope as te
from dsp_stuff_tpu_torch.runtime.stream import StreamSession
from dsp_stuff_tpu_torch.utils import precision as tprec
from dsp_stuff_tpu_torch.utils import sliders
from test_torch_presets import VS_JAX_DB as PRESET_VS_JAX_DB
from test_torch_render import VS_JAX_DB, _dbfs
from test_torch_stream_graph import _HostOps

B = 128
N_BLOCKS = 5
POLICIES = ("fast", "parity", "exact")


@pytest.fixture(autouse=True)
def _torch_env():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    prev = tprec.get_policy()
    yield
    tprec.set_policy(prev)
    torch.set_num_threads(threads)


#: node kind -> (graph values, {slider: a value a block})
KINDS = {
    "gain": ({"level": 1.2}, {"level": [1.2, 0.5, 2.0, 0.8, 3.0]}),
    "mix": ({"ratio": 0.3}, {"ratio": [0.3, 0.7, 0.1, 0.9, 0.5]}),
    "biquad": ({"a0": 1.0, "a1": -0.5, "a2": 0.2, "b0": 0.6, "b1": 0.2,
                "b2": 0.1},
               {"a0": [1.0, 1.1, 0.9, 1.2, 0.95],
                "a1": [-0.5, -0.3, -0.7, -0.45, -0.6],
                "a2": [0.2, 0.1, 0.3, 0.25, 0.05],
                "b0": [0.6, 0.9, 0.3, 1.1, 0.7],
                "b1": [0.2, 0.4, -0.1, 0.3, 0.15],
                "b2": [0.1, 0.3, -0.2, 0.05, 0.2]}),
    "low_pass": ({"ratio": 0.6}, {"ratio": [0.6, 0.3, 0.9, 0.5, 0.75]}),
    "high_pass": ({"ratio": 0.2}, {"ratio": [0.2, 0.6, 0.05, 0.4, 0.9]}),
    "envelope": ({"attack": 50.0, "release": 400.0},
                 {"attack": [50.0, 5.0, 200.0, 0.0, 20.0],
                  "release": [400.0, 100.0, 900.0, 40.0, 0.0]}),
    "reverb": ({"seconds": 0.003, "decay": 0.4},
               {"decay": [0.4, 0.1, 0.9, 0.3, 0.6]}),
    "chorus": ({"rate": 1.0, "depth": 0.003, "base": 0.01, "mix": 0.5},
               {"rate": [1.0, 2.5, 0.3, 4.0, 1.7],
                "mix": [0.5, 0.2, 0.8, 0.4, 0.6]}),
    "signal_gen": ({"amplitude": 0.5, "frequency": 440.0, "mode": "Sine"},
                   {"amplitude": [0.5, 0.8, -0.3, 0.6, 0.1],
                    "frequency": [440.0, 880.5, 97.0, 1234.0, 3000.0]}),
    "distort": ({"level": 3.0, "mode": "Tanh"},
                {"level": [3.0, 1.0, 10.0, 0.0005, 5.0]}),
    "overdrive": ({"boost": 4.0, "drive": 0.6, "level": 0.9},
                  {"boost": [4.0, 8.0, 1.0, 20.0, 2.0],
                   "drive": [0.6, 0.1, 0.9, 0.3, 1.0],
                   "level": [0.9, 0.5, 1.0, 0.2, 0.7]}),
    "chebyshev": ({"level_pos": 2.0, "level_neg": 4.0},
                  {"level_pos": [2.0, 4.0, 0.5, 10.0, 1.0],
                   "level_neg": [4.0, 1.0, 8.0, 0.0005, 3.0]}),
    "muff": ({"toan": 0.3, "level": 0.8, "sustain": 0.6},
             {"toan": [0.3, 0.7, 0.1, 0.9, 0.5],
              "level": [0.8, 0.4, 1.0, 0.6, 0.2],
              "sustain": [0.6, 0.2, 0.9, 0.4, 1.0]}),
}

CASES = [(kind, name) for kind, (_, moves) in KINDS.items()
         for name in moves]

#: nodes the repo already holds wider against the JAX package, with the
#: preset whose bound in tests/test_torch_presets.py does: the JAX fast
#: chorus takes an f32 sin where the port takes the f64-rounded one
#: (dsp_stuff_tpu_torch/ops/modfx.py), and the JAX Envelope node computes
#: its gains in the graph (dsp_stuff_tpu/nodes/filters.py:141-145), an
#: ulp off the port's host gains; with no params at all these streams
#: already sit at about -106 dBFS from the JAX package's after 5 blocks
WIDER_VS_JAX = {"chorus": "config2", "envelope": "config5"}


def _vs_jax_db(kind, pol):
    pol = "parity" if pol == "exact" else pol
    if kind in WIDER_VS_JAX:
        return max(VS_JAX_DB[pol], PRESET_VS_JAX_DB[(WIDER_VS_JAX[kind],
                                                     pol)])
    return VS_JAX_DB[pol]


def _graph(kind, values=None):
    """input -> the node -> output (a mix takes the input and its low-pass;
    a generator has no input).  Returns (graph, the node's id)."""
    g = dt.Graph(IdSpace())
    vals = dict(KINDS[kind][0] if values is None else values)
    if kind == "signal_gen":
        node, out = g.add(kind, **vals), g.add("output")
        g.connect(node, "out", out, "in")
        return g, str(node.id)
    inp = g.add("input")
    node, out = g.add(kind, **vals), g.add("output")
    if kind == "mix":
        lp = g.add("low_pass", ratio=0.9)
        g.connect(inp, "out", lp, "in")
        g.connect(inp, "out", node, "a")
        g.connect(lp, "out", node, "b")
    else:
        g.connect(inp, "out", node, "in")
    g.connect(node, "out", out, "in")
    return g, str(node.id)


def _all_kinds_graph():
    """Every slider kind in one chain (a generator into a mix)."""
    g = dt.Graph(IdSpace())
    prev = g.add("input")
    ids = {}
    for kind in KINDS:
        if kind in ("mix", "signal_gen"):
            continue
        node = g.add(kind, **KINDS[kind][0])
        g.connect(prev, "out", node, "in")
        ids[kind] = str(node.id)
        prev = node
    gen = g.add("signal_gen", **KINDS["signal_gen"][0])
    mix = g.add("mix", **KINDS["mix"][0])
    out = g.add("output")
    g.connect(prev, "out", mix, "a")
    g.connect(gen, "out", mix, "b")
    g.connect(mix, "out", out, "in")
    ids["signal_gen"], ids["mix"] = str(gen.id), str(mix.id)
    return g, ids


def _blocks(cg, k, seed, block=B):
    """[k, rows, block] seeded noise in the step's input rows (zeros for
    the length carrier of a graph without inputs)."""
    rows = max(len(cg.input_ids), 1)
    x = (np.random.default_rng(seed).standard_normal((k, rows, block))
         * 0.3).astype(np.float32)
    return x if cg.input_ids else np.zeros_like(x)


def _ext(cg, xj):
    if not cg.input_ids:
        return None
    return {str(i): xj[r] for r, i in enumerate(cg.input_ids)}


def _turns(node, names, k):
    """The params of each block: the named sliders at their j-th value."""
    return [{node: {n: float(v[j % len(v)]) for n, v in names.items()}}
            for j in range(k)]


def _stream(g, turns, x, block=B):
    """The port's session over x, the params set before each block: a new
    dict on even blocks, the values edited in place on odd ones."""
    sess = StreamSession(g, block_size=block, device="cpu")
    outs = []
    for j, p in enumerate(turns):
        if j % 2 == 0 or sess.params is None:
            sess.params = {k: dict(v) for k, v in p.items()}
        else:
            for k, v in p.items():
                sess.params[k].update(v)
        outs.append(sess.process(_ext(sess.cg, x[j])))
    return np.concatenate(outs, axis=-1), sess


def _eager(cg, turns, x):
    """The eager one-block loop taking the same values as Python floats."""
    state = cg.init_state()
    keys = [str(i) for i in cg.input_ids] or ["__len__"]
    outs = []
    for j, p in enumerate(turns):
        ext = {key: torch.from_numpy(x[j, i].copy())
               for i, key in enumerate(keys)}
        state, o, _ = cg.fn(state, ext, p)
        outs.append(np.stack([o[n].expand(x.shape[-1]).numpy()
                              for n in cg.output_ids]))
    return np.concatenate(outs, axis=-1)


def _jax(g, turns, x):
    js = JStreamSession(dj.loads_graph(dt.dumps_graph(g), ids=JIdSpace()))
    cg_inputs = [str(i) for i in js.cg.input_ids]
    outs = []
    for j, p in enumerate(turns):
        js.params = p
        ext = ({key: x[j, i] for i, key in enumerate(cg_inputs)}
               if cg_inputs else None)
        outs.append(np.asarray(js.process(ext)))
    return np.concatenate(outs, axis=-1)


@pytest.mark.parametrize("pol", POLICIES)
@pytest.mark.parametrize("kind,name", CASES)
def test_moved_every_block(kind, name, pol):
    """One slider moved every block: bitwise the eager loop taking the
    values as Python floats, one binding for the whole stream, and the
    JAX package's session fed the same params within ``_vs_jax_db``."""
    g, node = _graph(kind)
    turns = _turns(node, {name: KINDS[kind][1][name]}, N_BLOCKS)
    with dt.policy(pol), dj.policy(pol):
        x = _blocks(dt.compile_graph(g, device="cpu"), N_BLOCKS, seed=7)
        got, sess = _stream(g, turns, x)
        want = _eager(sess.cg, turns, x)
        jax_out = _jax(g, turns, x)
    assert np.isfinite(want).all() and np.abs(want).max() > 0
    np.testing.assert_array_equal(got, want)
    assert sess.step.bindings == 1
    assert sess.step.captures == 0            # the CPU: plain calls
    assert _dbfs(got, jax_out) <= _vs_jax_db(kind, pol)


@pytest.mark.parametrize("pol", POLICIES)
@pytest.mark.parametrize("kind", ["low_pass", "biquad"])
def test_moved_at_a_long_block(kind, pol):
    """At a 2,048-sample block the blocked solves' carries take their
    longer forms (16 chunks: the first-order Toeplitz of the carries, the
    biquad's boundary power tensor): still bitwise the eager loop."""
    g, node = _graph(kind)
    moves = {n: v for n, v in KINDS[kind][1].items() if n in ("ratio", "a1",
                                                             "b2")}
    turns = _turns(node, moves, 4)
    with dt.policy(pol):
        x = _blocks(dt.compile_graph(g, device="cpu"), 4, seed=8, block=2048)
        got, sess = _stream(g, turns, x, block=2048)
        want = _eager(sess.cg, turns, x)
    np.testing.assert_array_equal(got, want)
    assert sess.step.bindings == 1


@pytest.mark.parametrize("pol", POLICIES)
def test_every_kind_at_once(pol):
    """Every slider of every kind overridden and moved every block in one
    graph, through process and process_many: bitwise the eager loop, one
    binding."""
    g, ids = _all_kinds_graph()
    names = {}
    for kind, nid in ids.items():
        names[nid] = KINDS[kind][1]
    turns = [{nid: {n: float(v[j % len(v)]) for n, v in mv.items()}
              for nid, mv in names.items()} for j in range(6)]
    with dt.policy(pol):
        sess = StreamSession(g, device="cpu")
        x = _blocks(sess.cg, 6, seed=9)
        got = []
        for j in range(4):
            sess.params = turns[j]
            got.append(sess.process(_ext(sess.cg, x[j])))
        sess.params = turns[4]
        got.append(sess.process_many(
            {str(sess.cg.input_ids[0]): x[4:6, 0].reshape(-1)}))
        want = _eager(sess.cg, turns[:5] + [turns[4]], x)
    np.testing.assert_array_equal(np.concatenate(got, axis=-1), want)
    assert sess.step.bindings == 1


@pytest.mark.parametrize("pol", POLICIES)
def test_tensor_overrides_move_by_copy(pol):
    """Tensor sliders of every kind are copied into device buffers of
    their shape and dtype: new tensors, then in-place edits, each block,
    bitwise the eager loop taking the same tensors, one binding."""
    g, ids = _all_kinds_graph()
    turns = [{nid: {n: torch.tensor(v[j % len(v)])
                    for n, v in KINDS[kind][1].items()}
              for kind, nid in ids.items()} for j in range(N_BLOCKS)]
    with dt.policy(pol):
        sess = StreamSession(g, device="cpu")
        x = _blocks(sess.cg, N_BLOCKS, seed=10)
        got = []
        for j, p in enumerate(turns):
            if j < 2:
                sess.params = {nid: {n: t.clone() for n, t in e.items()}
                               for nid, e in p.items()}
            else:
                for nid, e in p.items():
                    for n, t in e.items():
                        sess.params[nid][n].copy_(t)
            got.append(sess.process(_ext(sess.cg, x[j])))
        want = _eager(sess.cg, turns, x)
    np.testing.assert_array_equal(np.concatenate(got, axis=-1), want)
    assert sess.step.bindings == 1


@pytest.mark.parametrize("pol", POLICIES)
def test_steady_step_with_tensor_overrides_is_capturable(pol):
    """Tensor sliders of every kind, moved once, then a steady step: no
    tensor made from host data and no host read.  Under fast the low- and
    high-pass ratios stay floats here: their tensor route on the CPU is
    the first-order kernel's plain version, which reads the coefficient
    on the host, where the card runs the kernel, which reads it from
    device memory (chip_smoke.tensor_slider_check)."""
    g, ids = _all_kinds_graph()
    host_read = ("low_pass", "high_pass") if pol == "fast" else ()

    def params(j):
        return {nid: {n: (float(v[j]) if kind in host_read
                          else torch.tensor(v[j]))
                      for n, v in KINDS[kind][1].items()}
                for kind, nid in ids.items()}
    with dt.policy(pol):
        sess = StreamSession(g, device="cpu", params=params(1))
        x = _blocks(sess.cg, 3, seed=17)
        sess.process(_ext(sess.cg, x[0]))
        sess.params = params(2)
        sess.process(_ext(sess.cg, x[1]))
        sess.step.inputs.copy_(torch.from_numpy(x[2]))
        mode = _HostOps()
        with mode:
            sess.step.key(sess.params)
            sess.step.run(sess.params)
        got = sess.step.outputs.numpy().copy()
        want = _eager(sess.cg, [params(1), params(2), params(2)], x)[:, -B:]
    assert mode.ops > 50
    assert not mode.host, f"{pol}: {sorted(set(mode.host))}"
    np.testing.assert_array_equal(got, want)
    assert sess.step.bindings == 1


@pytest.mark.parametrize("T", [1000, 128 * 20, 128 * 160])
def test_blocked_solve_takes_a_tensor_coefficient(T):
    """Under parity on the card a 0-d tensor coefficient takes the blocked
    first-order solve with its powers built on the device
    (scan._power_consts), so a captured stream step can take a tensor
    slider: no host read, and the same float64 numbers as the host-built
    powers (one chunk of carries, a Toeplitz of 20, a recursion over
    160)."""
    from dsp_stuff_tpu_torch.ops import scan
    rng = np.random.default_rng(16)
    b = torch.from_numpy(rng.standard_normal((3, T)))
    y0 = torch.from_numpy(rng.standard_normal(3))
    a = float(np.float32(0.93))
    want = scan._first_order_blocked(a, b, y0, dtype=torch.float64)
    at = torch.tensor(a, dtype=torch.float64)
    scan._first_order_blocked(at, b, y0, dtype=torch.float64)
    mode = _HostOps()
    with mode:
        got = scan._first_order_blocked(at, b, y0, dtype=torch.float64)
    assert not mode.host, sorted(set(mode.host))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-12 * float(want.abs().max()))


def _key_turns():
    """(what is done to the params, whether BlockStep.key moves)."""
    def edit_float(p):
        p["1"]["level"] = 0.25

    def new_dict(p):
        return {"1": {"level": 0.75, "drive": torch.tensor(0.3)}}

    def edit_tensor(p):
        p["1"]["drive"].add_(0.1)

    def add_slider(p):
        p["1"]["boost"] = 2.0

    def remove_slider(p):
        del p["1"]["level"]

    def float_to_tensor(p):
        p["1"]["level"] = torch.tensor(0.5)

    def shape(p):
        p["1"]["drive"] = torch.tensor([0.3])

    def dtype(p):
        p["1"]["drive"] = torch.tensor(0.3, dtype=torch.float64)

    def policy(p):
        tprec.set_policy("parity")
    return {"edit_float": (edit_float, False), "new_dict": (new_dict, False),
            "edit_tensor": (edit_tensor, False),
            "add_slider": (add_slider, True),
            "remove_slider": (remove_slider, True),
            "float_to_tensor": (float_to_tensor, True),
            "shape": (shape, True), "dtype": (dtype, True),
            "policy": (policy, True)}


@pytest.mark.parametrize("turn", list(_key_turns()))
def test_key_follows_structure(turn):
    """BlockStep.key: the same over value moves (a float edited, a new
    dict of the same structure, a tensor edited in place); another for a
    slider added or removed, a float become a tensor, a tensor's shape or
    dtype, or the policy."""
    g, node = _graph("overdrive")
    assert node == "1"
    sess = StreamSession(g, device="cpu")
    tprec.set_policy("fast")
    p = {"1": {"level": 0.5, "drive": torch.tensor(0.3)}}
    k0 = sess.step.key(p)
    act, moves = _key_turns()[turn]
    p = act(p) or p
    k1 = sess.step.key(p)
    assert (k1 != k0) == moves
    assert sess.step.bindings == 1 + moves


BIQUAD_FORMS = {
    # form: (graph values, a move inside the form, a move out of it)
    "gain": ({"a1": 0.0, "a2": 0.0, "b0": 0.7, "b1": 0.0, "b2": 0.0},
             {"b0": 0.4}, {"b1": 0.2}),
    "fir": ({"a1": 0.0, "a2": 0.0, "b0": 0.5, "b1": 0.3, "b2": 0.1},
            {"b1": -0.2}, {"a1": -0.3}),
    "first_order": ({"a1": -0.24, "a2": 0.0, "b0": 0.758, "b1": 0.0,
                     "b2": 0.0}, {"a1": -0.6}, {"a2": 0.1}),
    "full": ({"a1": -0.5, "a2": 0.2, "b0": 0.6, "b1": 0.2, "b2": 0.1},
             {"a2": 0.3}, {"a1": 0.0, "a2": 0.0}),
}


@pytest.mark.parametrize("form", list(BIQUAD_FORMS))
def test_biquad_form_binds_anew(form):
    """Under fast a biquad's concrete coefficients pick a route by their
    values (scan._biquad_form): a move inside the route is a copy, a move
    across routes is a slider that cannot be data there, so the step
    binds anew (on the card: captures again).  Every block stays bitwise
    the eager loop."""
    base, inside, across = BIQUAD_FORMS[form]
    g, node = _graph("biquad", {"a0": 1.0, **base})
    full = {k: float(v) for k, v in base.items()}
    turns = [{node: dict(full)}, {node: {**full, **inside}},
             {node: {**full, **across}}, {node: {**full, **across,
                                                 "b0": 0.2}}]
    with dt.policy("fast"):
        sess = StreamSession(g, device="cpu")
        x = _blocks(sess.cg, 4, seed=11)
        got, keys = [], []
        for j, p in enumerate(turns):
            sess.params = p
            got.append(sess.process(_ext(sess.cg, x[j])))
            keys.append(sess.step.key(sess.params))
        want = _eager(sess.cg, turns, x)
    np.testing.assert_array_equal(np.concatenate(got, axis=-1), want)
    assert keys[0] == keys[1] != keys[2] == keys[3]
    assert sess.step.bindings == 2


@pytest.mark.parametrize("pol", POLICIES)
def test_steady_step_with_float_overrides_is_capturable(pol):
    """Float overrides of every kind, moved once, then a steady step: it
    dispatches no tensor made from host data and no host read (what a CUDA
    graph capture refuses), and the step reads the moved values."""
    g, ids = _all_kinds_graph()
    over = {nid: {n: float(v[1]) for n, v in KINDS[kind][1].items()}
            for kind, nid in ids.items()}
    moved = {nid: {n: float(v[2]) for n, v in KINDS[kind][1].items()}
             for kind, nid in ids.items()}
    with dt.policy(pol):
        sess = StreamSession(g, device="cpu", params=over)
        x = _blocks(sess.cg, 3, seed=12)
        sess.process(_ext(sess.cg, x[0]))
        sess.params = moved
        sess.process(_ext(sess.cg, x[1]))
        sess.step.inputs.copy_(torch.from_numpy(x[2]))
        mode = _HostOps()
        with mode:
            sess.step.key(sess.params)
            sess.step.run(sess.params)
        got = sess.step.outputs.numpy().copy()
        want = _eager(sess.cg, [over, moved, moved], x)[:, -B:]
    assert mode.ops > 50
    assert not mode.host, f"{pol}: {sorted(set(mode.host))}"
    np.testing.assert_array_equal(got, want)
    assert sess.step.bindings == 1


def _gain_sources():
    """Each way a [2] gains tensor reaches the follower, with the host
    gains it must equal."""
    scope = sliders.Scope()

    def host(a, r):
        return te._gains(te.gain_from_frames(a), te.gain_from_frames(r),
                         torch.device("cpu"))

    def data(a, r):
        return te._gains(te.gain_from_frames(scope.root("a", a)),
                         te.gain_from_frames(scope.root("r", r)),
                         torch.device("cpu"))

    def tensor(a, r):
        return te._gains(te.gain_from_frames(torch.tensor(a)),
                         te.gain_from_frames(torch.tensor(r)),
                         torch.device("cpu"))
    return {"host": host, "data": data, "tensor": tensor}


@pytest.mark.parametrize("source", list(_gain_sources()))
@pytest.mark.parametrize("chunked", [False, True])
def test_envelope_device_gains(chunked, source, monkeypatch):
    """The follower's route with its gains as one [2] tensor on the device
    (the envelope kernel's interface), driven on the CPU through
    ``envelope._forward`` (the card's seam, the plain versions standing
    in): bitwise _seq_scan / _chunked_batched with the same gains as host
    floats, at frame counts 50 / 400 and 0 (gain 0)."""
    monkeypatch.setattr(te, "_CHUNK", 512)
    x = torch.from_numpy((np.random.default_rng(13).standard_normal(
        (3, 1500)) * 0.7).astype(np.float32))
    e0 = torch.from_numpy(np.float32([0.2, 0.0, 1.3]))
    for a, r in ((50.0, 400.0), (0.0, 7.0)):
        gains = _gain_sources()[source](a, r)
        assert gains.shape == (2,) and gains.dtype == torch.float32
        if source == "tensor":         # the device's gains (torch.exp)
            ha, hr = float(gains[0]), float(gains[1])
        else:
            ha, hr = te.gain_from_frames(a), te.gain_from_frames(r)
        np.testing.assert_array_equal(gains.numpy(), np.float32([ha, hr]))
        got, fin = te._forward(x, gains, e0, chunked)
        want, wfin = (te._chunked_batched(x, ha, hr, e0, 512) if chunked
                      else te._seq_scan(x, ha, hr, e0))
        np.testing.assert_array_equal(got.numpy(), want.numpy())
        np.testing.assert_array_equal(fin.numpy(), wfin.numpy())


def test_envelope_route_is_structural(monkeypatch):
    """The chunked route is chosen without a device read: a tensor frame
    count is in range (the node clamps it), a stream's slider by its host
    value, recorded as a form; the stream's route is bitwise the float
    frames' route past two chunks."""
    monkeypatch.setattr(te, "_CHUNK", 256)
    x = torch.from_numpy((np.random.default_rng(14).standard_normal(
        (2, 1200)) * 0.5).astype(np.float32))
    scope = sliders.Scope()
    a, r = scope.root("a", 30.0), scope.root("r", 300.0)
    assert te._frames_in_range(torch.tensor(5000.0))
    assert te._frames_in_range(a) and not te._frames_in_range(5000.0)
    assert len(scope.forms) == 1
    with dt.policy("fast"):
        got, gfin = te.peak_envelope(x, a, r, 0.1)
        want, wfin = te.peak_envelope(x, 30.0, 300.0, 0.1)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_array_equal(gfin.numpy(), wfin.numpy())
    assert scope.move({"a": 40.0, "r": 200.0})
    assert not scope.move({"a": 4000.0, "r": 200.0})


@pytest.mark.parametrize("name", ["power_thresh", "clarity_thresh",
                                  "pick_thresh"])
def test_pitch_thresholds_raise_as_in_jax(name):
    """Pitch reads its thresholds on the host, so neither package's stream
    takes one as data: the JAX package's process() raises on the traced
    value, the port's session refuses the override (a float or a tensor)
    before it runs anything."""
    g = dt.Graph(IdSpace())
    inp, pitch, out = g.add("input"), g.add("pitch"), g.add("output")
    g.connect(inp, "out", pitch, "in")
    g.connect(inp, "out", out, "in")
    p = {str(pitch.id): {name: 0.3}}
    x = np.zeros(B, np.float32)
    js = JStreamSession(dj.loads_graph(dt.dumps_graph(g), ids=JIdSpace()))
    js.process(x)
    js.params = p
    with pytest.raises(Exception, match="[Cc]oncrete|[Tt]racer"):
        js.process(x)
    sess = StreamSession(g, device="cpu")
    sess.process(x)
    for v in (0.3, torch.tensor(0.3)):
        sess.params = {str(pitch.id): {name: v}}
        with pytest.raises(ValueError, match="host"):
            sess.process(x)
    sess.params = None
    assert sess.process(x).shape == (1, B)


def test_a_slider_is_not_a_number():
    """A slider of a stream step refuses to be read as a number, so code
    that would bake its value in raises instead."""
    d = sliders.Scope().root("a", 0.5)
    for read in (float, bool, lambda v: v == 0.5, lambda v: v * 2.0,
                 lambda v: 1.0 - v, lambda v: np.float32(v)):
        with pytest.raises(TypeError, match="data on the device"):
            read(d)
    assert sliders.lift(np.float32, 0.5) == np.float32(0.5)
    assert sliders.lift(float, d).value == 0.5
    with pytest.raises(TypeError, match="closes over"):
        sliders.lift(lambda v: v + d.value, d)


@pytest.mark.parametrize("decay", ["float", "tensor"])
def test_reverb_block_is_inside_its_delay(decay, monkeypatch):
    """A tensor decay under fast takes the blocked comb when T > D
    (ops/delay_line._comb_chunks_blocked).  A stream block never does: D
    is at least 128 samples (reverb.rs:57), so a 128-sample block reads
    only the history, and the moved decay is bitwise the eager loop
    taking it as a float.  A render longer than the line does take it."""
    from dsp_stuff_tpu_torch.ops import delay_line
    calls = []
    blocked = delay_line._comb_chunks_blocked
    monkeypatch.setattr(delay_line, "_comb_chunks_blocked",
                        lambda *a, **k: calls.append(1) or blocked(*a, **k))
    g, node = _graph("reverb")
    vals = KINDS["reverb"][1]["decay"]
    cast = torch.tensor if decay == "tensor" else float
    assert delay_line.delay_samples(KINDS["reverb"][0]["seconds"]) >= B
    with dt.policy("fast"):
        sess = StreamSession(g, device="cpu")
        x = _blocks(sess.cg, N_BLOCKS, seed=15)
        got = []
        for j in range(N_BLOCKS):
            sess.params = {node: {"decay": cast(vals[j])}}
            got.append(sess.process(_ext(sess.cg, x[j])))
        want = _eager(sess.cg, _turns(node, {"decay": vals}, N_BLOCKS), x)
        assert not calls
        sess.cg.render(x[:, 0].reshape(1, -1), params={
            node: {"decay": torch.tensor(0.5)}})
    np.testing.assert_array_equal(np.concatenate(got, axis=-1), want)
    assert calls
