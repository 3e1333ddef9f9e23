"""The stream session's block step over static buffers
(dsp_stuff_tpu_torch/runtime/block_graph.py) on the CPU.

On the card the step is captured once in a CUDA graph and replayed a
block; on the CPU it runs as plain calls over the same buffers, with the
lockstep counters (a reverb's position, a chorus's clock, a FIR's sample
count) held as 0-d int64 tensors.  Held here:

  the step (process, pump, process_many in chunks of 1, 3 and 7) vs the
  eager one-block loop (``cg.fn`` on a rebound state with Python-int
  counters), over the bench chain, config5, a chorus, a generator, muff
  and a two-output FIR graph, under fast, parity and exact   bitwise
  a params change, a policy change, reset() and a checkpoint mid-stream
  vs the eager loop taking the same turns                      bitwise
  the steady step makes no tensor from host data and reads no device
  value on the host (what a CUDA graph capture refuses), by the ops it
  dispatches
  the port's stream vs the JAX package's StreamSession: fast and parity
  VS_JAX_DB of tests/test_torch_render (test_stream_vs_jax's bounds),
  exact bitwise (a transcendental-free graph: the exact policy's CPU
  contract, bitwise the JAX package's exact render)
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import dsp_stuff_tpu as dj
import dsp_stuff_tpu_torch as dt
from dsp_stuff_tpu.ids import IdSpace as JIdSpace
from dsp_stuff_tpu.runtime.stream import StreamSession as JStreamSession
from dsp_stuff_tpu_torch.compiler import compile as tcompile
from dsp_stuff_tpu_torch.ids import IdSpace
from dsp_stuff_tpu_torch.models import presets
from dsp_stuff_tpu_torch.runtime import block_graph
from dsp_stuff_tpu_torch.runtime import checkpoint as ckpt
from dsp_stuff_tpu_torch.runtime.stream import StreamSession
from dsp_stuff_tpu_torch.utils import precision as tprec
from test_torch_render import VS_JAX_DB, _dbfs

B = 128
N_BLOCKS = 21                     # 1 + 3 + 3 + 7 + 7: every chunk size ends
CHUNKS = (1, 3, 7)
POLICIES = ("fast", "parity", "exact")


@pytest.fixture(autouse=True)
def _torch_env():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    prev = tprec.get_policy()
    yield
    tprec.set_policy(prev)
    torch.set_num_threads(threads)


def _bench_chain():
    """bench.py:100-114's 10-node chain."""
    g = dt.Graph(IdSpace())
    nodes = [g.add("input"), g.add("gain", level=1.2),
             g.add("biquad", a0=1.0, a1=-0.24, a2=0.0, b0=0.758, b1=0.0,
                   b2=0.0),
             g.add("overdrive", boost=4.0, drive=0.6, level=0.9),
             g.add("low_pass", ratio=0.6), g.add("high_pass", ratio=0.2),
             g.add("distort", mode="Tanh", level=3.0),
             g.add("chebyshev", level_pos=2.0, level_neg=4.0),
             g.add("reverb", seconds=0.05, decay=0.4), g.add("output")]
    g.chain(*nodes)
    return g


def _generator():
    """No Input node: the session's silent length carrier sets T."""
    g = dt.Graph(IdSpace())
    sg = g.add("signal_gen", frequency=997.0, amplitude=0.7, mode="Sine")
    sq = g.add("signal_gen", frequency=61.0, amplitude=0.3, mode="Square")
    out = g.add("output")
    g.connect(sg, "out", out, "in")
    g.connect(sq, "out", out, "in")
    return g


def _muff():
    g = dt.Graph(IdSpace())
    inp, mf, out = (g.add("input"), g.add("muff", toan=0.3, level=0.8,
                                          sustain=0.6), g.add("output"))
    g.chain(inp, mf, out)
    return g


GRAPHS = {
    "bench": _bench_chain,
    "config5": lambda: presets.config5_feedback_16node()[0],
    "chorus": lambda: presets.config2_delay_chorus()[0],
    "generator": _generator,
    "muff": _muff,
    # two outputs, each a FIR whose warm-up (287 samples) spans 3 blocks
    "two outputs": lambda: presets.config4_convolution_reverb(
        ir_seconds=0.006)[0],
}


def _blocks(sess, k, seed):
    """[k, rows, B] seeded noise in the step's input rows (zeros for the
    length carrier of a graph without inputs)."""
    x = (np.random.default_rng(seed).standard_normal(
        (k, len(sess.step.keys), B)) * 0.3).astype(np.float32)
    return x if sess.cg.input_ids else np.zeros_like(x)


def _ext(sess, x):
    """One block [rows, B] as process()'s dict, or None without inputs."""
    if not sess.cg.input_ids:
        return None
    return {key: x[i] for i, key in enumerate(sess.step.keys)}


def _eager(cg, x, params=None, state=None):
    """The eager one-block loop (the session's step before the block
    graph): ``cg.fn`` on a rebound state whose counters are Python ints.
    x [k, rows, B] -> ([n_out, k*B], final state)."""
    state = cg.init_state() if state is None else state
    keys = [str(i) for i in cg.input_ids] or ["__len__"]
    outs = []
    for j in range(x.shape[0]):
        ext = {key: torch.from_numpy(x[j, i].copy())
               for i, key in enumerate(keys)}
        state, o, _ = cg.fn(state, ext, params)
        outs.append(np.stack([o[n].expand(B).numpy()
                              for n in cg.output_ids]))
    return np.concatenate(outs, axis=-1), state


def _assert_states_equal(got, want):
    assert set(got) == set(want)
    for k, st in want.items():
        if not isinstance(st, dict):
            assert got[k] is None and st is None
            continue
        for kk, v in st.items():
            g = got[k][kk]
            if isinstance(v, torch.Tensor):
                np.testing.assert_array_equal(g.numpy(), v.numpy(),
                                              err_msg=f"state {k} {kk}")
            else:
                assert isinstance(g, int) and g == int(v), (k, kk, g, v)


def _via_process(sess, x):
    return np.concatenate([sess.process(_ext(sess, x[j]))
                           for j in range(x.shape[0])], axis=-1)


def _via_pump(sess, x):
    for i, nid in enumerate(sess.cg.input_ids):
        assert sess.feed(nid, x[:, i].reshape(-1)) == x.shape[0] * B
    n = 0
    while n < x.shape[0] and sess.pump():
        n += 1
    assert n == x.shape[0]
    return np.stack([sess.out_rings[nid].read(n * B)
                     for nid in sess.cg.output_ids])


def _via_many(sess, x, chunk):
    outs = []
    for j in range(0, x.shape[0], chunk):
        part = x[j:j + chunk]
        if sess.cg.input_ids:
            got = sess.process_many({key: part[:, i].reshape(-1)
                                     for i, key in enumerate(sess.step.keys)})
        else:
            got = sess.process_many(n_blocks=part.shape[0])
        outs.append(got)
    return np.concatenate(outs, axis=-1)


@pytest.mark.parametrize("pol", POLICIES)
@pytest.mark.parametrize("name", list(GRAPHS))
def test_step_is_the_eager_loop(name, pol):
    """process, pump and process_many in chunks of 1, 3 and 7 over 21
    blocks are bitwise the eager one-block loop, final state included."""
    g = GRAPHS[name]()
    with dt.policy(pol):
        sess = StreamSession(g, device="cpu")
        x = _blocks(sess, N_BLOCKS, seed=len(name))
        want, want_state = _eager(sess.cg, x)
        assert np.isfinite(want).all() and np.abs(want).max() > 0
        got = _via_process(sess, x)
        np.testing.assert_array_equal(got, want)
        _assert_states_equal(sess.state, want_state)
        np.testing.assert_array_equal(
            _via_pump(StreamSession(g, device="cpu"), x), want)
        for c in CHUNKS:
            s = StreamSession(g, device="cpu")
            np.testing.assert_array_equal(_via_many(s, x, c), want,
                                          err_msg=f"chunks of {c}")
            _assert_states_equal(s.state, want_state)
        assert sess.step.captures == sess.step.replays == 0   # the CPU


# -- what a capture refuses --------------------------------------------------

#: ops that make a tensor from host data or read a device value on the
#: host: a copy from pageable memory or a synchronization, which a CUDA
#: graph capture refuses
HOST_OPS = {"aten.lift_fresh.default", "aten._local_scalar_dense.default",
            "aten.item.default", "aten.nonzero.default", "aten.equal.default",
            "aten.is_nonzero.default"}


class _HostOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.host, self.ops = [], 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops += 1
        if str(func) in HOST_OPS:
            self.host.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("pol", POLICIES)
@pytest.mark.parametrize("name", list(GRAPHS))
def test_steady_step_is_capturable(name, pol):
    """After one block (the warm-up fills the constant caches) a step
    dispatches no host-data tensor and no host read: the counters stay on
    the device, the constants come from the caches.  The CPU runs the
    plain versions, so this rehearses the shared code of a capture (the
    card's kernel wrappers are held by chip_smoke.py)."""
    g = GRAPHS[name]()
    with dt.policy(pol):
        sess = StreamSession(g, device="cpu")
        x = _blocks(sess, 2, seed=3)
        sess.process(_ext(sess, x[0]))
        sess.step.inputs.copy_(torch.from_numpy(x[1]))
        mode = _HostOps()
        with mode:
            sess.step.run(sess.params)
    assert mode.ops > 10
    assert not mode.host, f"{name} under {pol}: {sorted(set(mode.host))}"


def test_steady_step_is_capturable_at_512():
    """At a 512-sample block config5's spectrogram sink makes a column a
    block: its window, bin indices, tilt and resampling matrix come from
    the device caches too."""
    g = presets.config5_feedback_16node()[0]
    with dt.policy("fast"):
        sess = StreamSession(g, block_size=512, device="cpu")
        x = (np.random.default_rng(4).standard_normal((2, 512)) * 0.3
             ).astype(np.float32)
        sess.process(x[:1])
        sess.step.inputs.copy_(torch.from_numpy(x[1:]))
        mode = _HostOps()
        with mode:
            sess.step.run(sess.params)
        _, _, aux = sess.cg.fn(sess.step._state,
                               {sess.step.keys[0]: sess.step.inputs[0]})
    assert any(k.startswith("spectrogram:") and v["columns"].shape[-2] == 1
               for k, v in aux.items() if isinstance(v, dict)
               and "columns" in v)
    assert not mode.host, sorted(set(mode.host))


@pytest.mark.parametrize("name", ["bench", "config2", "config5"])
def test_steady_step_with_tensor_params(name):
    """A steady step whose sliders are tensors (a fitted or automated
    params tree) dispatches no host-data tensor and no host read either:
    the tensor sliders run as tensors, and the key of the capture comes
    from the params' stamp without reading them."""
    g = {"bench": _bench_chain,
         "config2": lambda: presets.config2_delay_chorus()[0],
         "config5": lambda: presets.config5_feedback_16node()[0]}[name]()
    gains = [str(i) for i, nd in sorted(g.nodes.items())
             if nd.cfg_name == "gain"]
    params = {k: {"level": torch.tensor(0.7 + 0.1 * j)}
              for j, k in enumerate(gains)}
    assert params
    with dt.policy("fast"):
        sess = StreamSession(g, device="cpu")
        sess.params = params
        x = _blocks(sess, 2, seed=21)
        sess.process(_ext(sess, x[0]))
        sess.step.key(sess.params)
        sess.step.inputs.copy_(torch.from_numpy(x[1]))
        mode = _HostOps()
        with mode:
            sess.step.key(sess.params)
            sess.step.run(sess.params)
    assert mode.ops > 10
    assert not mode.host, f"{name}: {sorted(set(mode.host))}"


def test_counters_live_on_the_device():
    """The lockstep counters are 0-d int64 buffers; ``state`` gives them
    back as Python ints, advanced as the eager loop advances them."""
    g = presets.config2_delay_chorus()[0]
    g4 = presets.config4_convolution_reverb(ir_seconds=0.006)[0]
    for graph, key in ((g, "t0"), (g4, "n_seen")):
        sess = StreamSession(graph, device="cpu")
        bufs = [st[key] for st in sess.step._state.values()
                if isinstance(st, dict) and key in st]
        assert bufs and all(b.dtype == torch.int64 and b.dim() == 0
                            for b in bufs)
        sess.process_many(_ext_many(sess, 5))
        vals = [st[key] for st in sess.state.values()
                if isinstance(st, dict) and key in st]
        assert vals and all(isinstance(v, int) and v == 5 * B for v in vals)


def _ext_many(sess, k, seed=0):
    x = _blocks(sess, k, seed)
    return {key: x[:, i].reshape(-1) for i, key in enumerate(sess.step.keys)}


# -- params, state and policy mid-stream -------------------------------------

def test_params_change_mid_stream():
    """A ``sess.params`` change between calls reaches the next block, as
    an eager loop run on with the new params."""
    g = _bench_chain()
    gain = str(sorted(g.nodes)[1])
    with dt.policy("fast"):
        sess = StreamSession(g, device="cpu")
        x = _blocks(sess, 10, seed=5)
        a = _via_many(sess, x[:4], 2)
        sess.params = {gain: {"level": 2.0}}
        b = _via_process(sess, x[4:7])
        sess.params[gain]["level"] = 0.5          # edited in place
        c = _via_many(sess, x[7:], 3)
        want_a, st = _eager(sess.cg, x[:4])
        want_b, st = _eager(sess.cg, x[4:7], {gain: {"level": 2.0}}, st)
        want_c, st = _eager(sess.cg, x[7:], {gain: {"level": 0.5}}, st)
    np.testing.assert_array_equal(a, want_a)
    np.testing.assert_array_equal(b, want_b)
    np.testing.assert_array_equal(c, want_c)
    _assert_states_equal(sess.state, st)
    assert np.abs(b).max() > np.abs(want_a).max() * 0.5


def test_policy_change_mid_stream():
    """A policy change between calls runs the next block under the new
    policy (on the card: a capture under the new key), as the eager loop
    switching at the same block."""
    g = presets.config5_feedback_16node()[0]
    sess = StreamSession(g, device="cpu")
    x = _blocks(sess, 6, seed=7)
    with dt.policy("fast"):
        a = _via_process(sess, x[:3])
        want_a, st = _eager(sess.cg, x[:3])
        key_fast = block_graph.capture_key(sess.params)
    with dt.policy("parity"):
        b = _via_many(sess, x[3:], 3)
        want_b, st = _eager(sess.cg, x[3:], None, st)
        assert block_graph.capture_key(sess.params) != key_fast
    np.testing.assert_array_equal(a, want_a)
    np.testing.assert_array_equal(b, want_b)
    _assert_states_equal(sess.state, st)


def test_capture_key_follows_content():
    """The key of a capture follows the params' structure, whatever the
    object and the values: equal for equal content and for edited values;
    another for a slider added, a float become a tensor, another shape,
    content where the step cannot take data, or another policy."""
    p = {"3": {"level": 2.0, "ratio": np.float32(0.5)}}
    with dt.policy("fast"):
        k = block_graph.capture_key(p)
        assert block_graph.capture_key({"3": {"ratio": np.float32(0.5),
                                              "level": 2.0}}) == k
        assert block_graph.capture_key(
            {"3": {"level": torch.tensor(2.0)}}) == block_graph.capture_key(
            {"3": {"level": torch.tensor(2.5)}})
        assert block_graph.capture_key(
            {"3": {"level": torch.tensor(2.0)}}) != block_graph.capture_key(
            {"3": {"level": torch.tensor([2.0])}})
        p["3"]["level"] = 2.5
        assert block_graph.capture_key(p) == k
        p["3"]["level"] = torch.tensor(2.5)
        assert block_graph.capture_key(p) != k
        assert block_graph.capture_key({"3": {"level": 2.0}}) != k
        assert block_graph.capture_key(None) != k
        static = block_graph.capture_key(p, lambda nid, name: False)
        p["3"]["ratio"] = 0.25
        assert block_graph.capture_key(p, lambda nid, name: False) != static
    with dt.policy("parity"):
        assert block_graph.capture_key(None) != (None, "fast")


def _stamp_turns():
    """(what is done to the params, whether the key is worked out again):
    a device tensor (here on the meta device, which has no data to read)
    is stamped by identity and version."""
    def edit_tensor(p):
        p["3"]["level"].add_(1.0)

    def new_dict_same_tensor(p):
        return {"3": dict(p["3"])}

    def new_tensor(p):
        return {"3": {**p["3"], "level": torch.ones((), device="meta")}}

    def edit_scalar(p):
        p["3"]["ratio"] = 0.7

    def other_policy(p):
        tprec.set_policy("parity")
    return {"nothing": (lambda p: None, False),
            "edit_tensor": (edit_tensor, True),
            "new_dict_same_tensor": (new_dict_same_tensor, False),
            "new_tensor": (new_tensor, True),
            "edit_scalar": (edit_scalar, True),
            "other_policy": (other_policy, True)}


@pytest.mark.parametrize("turn", list(_stamp_turns()))
def test_capture_key_follows_the_stamp(turn, monkeypatch):
    """The step works the key of its capture out again (freezing the
    params, a host read of each tensor) only when the params' stamp or
    the policy moved: never for a steady stream."""
    calls = []

    def counted(params, data=None):
        calls.append(1)
        return object(), tprec.get_policy().name
    monkeypatch.setattr(block_graph, "capture_key", counted)
    sess = StreamSession(_muff(), device="cpu")
    p = {"3": {"level": torch.zeros((), device="meta"), "ratio": 0.5}}
    tprec.set_policy("fast")
    k0 = sess.step.key(p)
    for _ in range(3):
        assert sess.step.key(p) is k0
    assert len(calls) == 1
    act, moves = _stamp_turns()[turn]
    p = act(p) or p
    k1 = sess.step.key(p)
    assert len(calls) == 1 + moves
    assert (k1 is not k0) == moves
    assert sess.step.key(p) is k1 and len(calls) == 1 + moves


def test_capture_key_reads_cpu_tensors_by_content():
    """A CPU tensor is stamped by its content: an in-place edit, a
    ``.data`` edit included, moves the stamp, and the step copies the new
    value into the buffer its nodes read; the key stays."""
    sess = StreamSession(_muff(), device="cpu")
    muff = next(str(i) for i, nd in sess.cg.graph.nodes.items()
                if nd.cfg_name == "muff")
    t = torch.tensor(0.5)
    p = {muff: {"level": t}}
    with dt.policy("fast"):
        k0 = sess.step.key(p)
        buf = sess.step._binding.params[muff]["level"]
        assert buf is not t and float(buf) == 0.5
        t.data.add_(1.0)
        assert sess.step.key(p) == k0 and float(buf) == 1.5
        t.sub_(1.0)
        assert sess.step.key(p) == k0 and float(buf) == 0.5


@pytest.mark.parametrize("call", ["process", "process_many"])
@pytest.mark.parametrize("bad", ["unknown_key", "short_array"])
def test_malformed_inputs_raise(call, bad):
    """A dict key that names no Input node, or an array with fewer rows
    than the graph has inputs, raises ValueError; nothing runs."""
    g = dt.Graph(IdSpace())
    a, b, m, o = (g.add("input"), g.add("input"), g.add("mix"),
                  g.add("output"))
    g.connect(a, "out", m, "a")
    g.connect(b, "out", m, "b")
    g.connect(m, "out", o, "in")
    sess = StreamSession(g, device="cpu")
    k = 3 if call == "process_many" else 1
    x = np.zeros(k * B, np.float32)
    inputs = ({str(a.id): x, "999": x} if bad == "unknown_key"
              else x[None])
    with pytest.raises(ValueError, match="names no Input|rows"):
        getattr(sess, call)(inputs)
    np.testing.assert_array_equal(
        getattr(sess, call)({str(a.id): x + 1.0, str(b.id): x}),
        getattr(StreamSession(g, device="cpu"), call)(
            np.stack([x + 1.0, x])))


def test_reset_mid_stream():
    """reset() copies a fresh state into the buffers: the blocks after it
    are a fresh eager loop's."""
    g = presets.config2_delay_chorus()[0]
    with dt.policy("fast"):
        sess = StreamSession(g, device="cpu")
        x = _blocks(sess, 8, seed=9)
        _via_many(sess, x[:5], 5)
        bufs = {k: st["hist"] for k, st in sess.step._state.items()
                if isinstance(st, dict) and "hist" in st}
        sess.reset()
        got = _via_process(sess, x[5:])
        want, st = _eager(sess.cg, x[5:])
    np.testing.assert_array_equal(got, want)
    _assert_states_equal(sess.state, st)
    assert all(sess.step._state[k]["hist"] is b for k, b in bufs.items())


def test_checkpoint_mid_stream(tmp_path):
    """A stream saved to a checkpoint after 6 blocks and resumed in a new
    session is one uninterrupted stream (reverb and chorus counters
    included)."""
    g = presets.config2_delay_chorus()[0]
    path = str(tmp_path / "mid.npz")
    with dt.policy("fast"):
        whole = StreamSession(g, device="cpu")
        x = _blocks(whole, 12, seed=11)
        want = _via_process(whole, x)
        first = StreamSession(g, device="cpu")
        a = _via_many(first, x[:6], 3)
        ckpt.save_checkpoint(path, g, state=first.state, meta={"blocks": 6})
        g2, st, _, meta = ckpt.load_checkpoint(path, device="cpu")
        second = StreamSession(g2, device="cpu")
        second.state = st
        b = _via_process(second, x[6:])
    assert meta == {"blocks": 6}
    np.testing.assert_array_equal(np.concatenate([a, b], axis=-1), want)
    _assert_states_equal(second.state, whole.state)


def test_state_assignment_copies_into_the_buffers():
    """Assigning ``sess.state`` copies into the buffers (a captured graph
    reads them by address); reading it gives a copy, the counters as
    Python ints; a state of another shape or device raises."""
    g = presets.config2_delay_chorus()[0]
    sess = StreamSession(g, device="cpu")
    ptrs = {(k, kk): b.data_ptr() for k, st in sess.step._state.items()
            if isinstance(st, dict) for kk, b in st.items()}
    other = StreamSession(g, device="cpu")
    other.process_many(_ext_many(other, 4, seed=13))
    want = other.state
    sess.state = want
    assert ptrs == {(k, kk): b.data_ptr()
                    for k, st in sess.step._state.items()
                    if isinstance(st, dict) for kk, b in st.items()}
    got = sess.state
    _assert_states_equal(got, want)
    for st in got.values():                 # a copy, not the buffers
        for v in (st or {}).values():
            if isinstance(v, torch.Tensor):
                v.add_(1.0)
    _assert_states_equal(sess.state, want)
    x = _ext_many(sess, 3, seed=14)
    np.testing.assert_array_equal(sess.process_many(x),
                                  other.process_many(x))
    bad = sess.state
    k = next(k for k, st in bad.items() if isinstance(st, dict)
             and "hist" in st)
    bad[k]["hist"] = torch.zeros(3)
    with pytest.raises(ValueError, match="shape"):
        sess.state = bad
    bad = sess.state
    bad.pop(k)
    with pytest.raises(ValueError, match="keys"):
        sess.state = bad


def test_node_hook_refuses_a_card_session():
    """A session on the card cannot fire a per-node host callback inside
    a replay: asked for while NODE_HOOK is set it raises before any CUDA
    call; a CPU session runs the hook every block as before."""
    g = _muff()
    seen = []
    tcompile.NODE_HOOK = lambda nid, cfg, outs: seen.append(cfg)
    try:
        with pytest.raises(RuntimeError, match="NODE_HOOK"):
            StreamSession(g, device="cuda")
        sess = StreamSession(g, device="cpu")
        sess.process(np.zeros((1, B), np.float32))
        sess.process(np.zeros((1, B), np.float32))
    finally:
        tcompile.NODE_HOOK = None
    assert seen.count("muff") == 2


# -- against the JAX package -------------------------------------------------

def _jax_stream_graph():
    """A feedback loop with a reverb on the per-node scan (its position
    counter), a FIR in warm-up over three blocks (its sample counter), no
    transcendental: input -> add -> reverb -> low_pass -> add (back edge);
    reverb -> fir -> output."""
    g = dt.Graph(IdSpace())
    inp, ad = g.add("input"), g.add("add")
    rv = g.add("reverb", seconds=0.004, decay=0.5)
    lp = g.add("low_pass", ratio=0.7)
    taps = np.random.default_rng(3).standard_normal(300) * np.exp(
        -np.arange(300) / 80.0) * 0.1
    fir = g.add("fir", mode="Balanced", taps=[float(v) for v in taps])
    out = g.add("output")
    g.connect(inp, "out", ad, "a")
    g.connect(ad, "out", rv, "in")
    g.connect(rv, "out", lp, "in")
    g.connect(lp, "out", ad, "b")
    g.connect(rv, "out", fir, "in")
    g.connect(fir, "out", out, "in")
    return g


@pytest.mark.parametrize("pol", POLICIES)
def test_stream_vs_jax(pol):
    """The port's session over the static-buffer step against the JAX
    package's StreamSession on the same seeded blocks."""
    g = _jax_stream_graph()
    gj = dj.loads_graph(dt.dumps_graph(g), ids=JIdSpace())
    with dt.policy(pol), dj.policy(pol):
        sess = StreamSession(g, device="cpu")
        x = _blocks(sess, 8, seed=17)
        got = _via_process(sess, x)
        js = JStreamSession(gj)
        want = np.concatenate([np.asarray(js.process(_ext(sess, x[j])))
                               for j in range(x.shape[0])], axis=-1)
    assert np.abs(want).max() > 0
    if pol == "exact":
        np.testing.assert_array_equal(got, want)
    else:
        assert _dbfs(got, want) <= VS_JAX_DB[pol]
