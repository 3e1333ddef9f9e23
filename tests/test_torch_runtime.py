"""The port's runtime on the CPU: the streaming session, checkpoints and the
debug tools, as tests/test_runtime.py holds the JAX package's, plus the
port against the JAX package on the same seeded NumPy blocks.

Bounds (dBFS = 20 log10(max|err| / max|reference|)):
  streamed vs one offline render      atol 1e-6 (2e-6 with a chorus), the
                                      JAX file's
  process_many vs k process() calls   bitwise, under fast and parity (the
                                      port runs the same one-block step k
                                      times: nothing reassociates)
  checkpoint resume vs one render     HANDOFF_DB of tests/test_torch_render
  port vs JAX (stream, checkpoints)   VS_JAX_DB of tests/test_torch_render
"""

import jax
import numpy as np
import pytest
import torch

import dsp_stuff_tpu as dj
import dsp_stuff_tpu_torch as dt
from dsp_stuff_tpu.ids import IdSpace as JIdSpace
from dsp_stuff_tpu.runtime import checkpoint as jckpt
from dsp_stuff_tpu.runtime.stream import StreamSession as JStreamSession
from dsp_stuff_tpu_torch.ids import IdSpace
from dsp_stuff_tpu_torch.runtime import checkpoint as ckpt
from dsp_stuff_tpu_torch.runtime.stream import StreamSession, _PyRing, \
    make_ring
from dsp_stuff_tpu_torch.utils import obs
from dsp_stuff_tpu_torch.utils import precision as tprec
from test_torch_render import HANDOFF_DB, VS_JAX_DB, _dbfs

RNG = np.random.default_rng(0)
POLICIES = ["fast", "parity"]


@pytest.fixture(autouse=True)
def _torch_env():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    prev = tprec.get_policy()
    yield
    tprec.set_policy(prev)
    torch.set_num_threads(threads)


def _chain():
    g = dt.Graph(IdSpace())
    inp = g.add("input")
    lp = g.add("low_pass", ratio=0.8)
    rv = g.add("reverb", seconds=0.01, decay=0.6)
    out = g.add("output")
    g.chain(inp, lp, rv, out)
    return g, inp.id


def _session(g, **kw):
    return StreamSession(g, device="cpu", **kw)


def _render(g, x, **kw):
    outs, aux, state = dt.render(g, x, device="cpu", **kw)
    return outs.numpy(), aux, state


def _blocks(sess, inp_id, x, block=128):
    return np.concatenate([sess.process({str(inp_id): x[i:i + block]})[0]
                           for i in range(0, len(x), block)])


def _jax_graph(g):
    return dj.loads_graph(dt.dumps_graph(g), ids=JIdSpace())


def test_stream_matches_offline():
    """Block-by-block streaming equals the one-shot offline render."""
    g, inp_id = _chain()
    T = 1024
    x = (RNG.standard_normal(T) * 0.3).astype(np.float32)
    offline, _, _ = _render(g, {str(inp_id): x})
    streamed = _blocks(_session(g, block_size=128), inp_id, x)
    np.testing.assert_allclose(streamed, offline[0], atol=1e-6)


@pytest.mark.parametrize("pol", POLICIES)
def test_process_many_matches_process(pol):
    """k blocks in one call are bitwise k process() calls, the state
    carried identically."""
    g, inp_id = _chain()
    T = 128 * 12
    x = (np.random.default_rng(21).standard_normal(T) * 0.3
         ).astype(np.float32)
    with dt.policy(pol):
        s1 = _session(g)
        want = _blocks(s1, inp_id, x)
        s2 = _session(g)
        got1 = s2.process_many({str(inp_id): x[:128 * 5]})       # k = 5
        got2 = s2.process_many({str(inp_id): x[128 * 5:]})       # k = 7
        np.testing.assert_array_equal(np.concatenate([got1[0], got2[0]]),
                                      want)
        nxt = (np.random.default_rng(22).standard_normal(128) * 0.3
               ).astype(np.float32)
        np.testing.assert_array_equal(s1.process({str(inp_id): nxt}),
                                      s2.process({str(inp_id): nxt}))
        with pytest.raises(ValueError, match="multiple"):
            s2.process_many({str(inp_id): x[:100]})


def test_process_many_generator_graph():
    """No-input graphs pipeline via n_blocks."""
    g = dt.Graph(IdSpace())
    sg = g.add("signal_gen", frequency=440.0, amplitude=0.8, mode="Sine")
    out = g.add("output")
    g.chain(sg, out)
    s1 = _session(g)
    want = np.concatenate([s1.process()[0] for _ in range(6)])
    got = _session(g).process_many(n_blocks=6)[0]
    np.testing.assert_array_equal(got, want)


def test_stream_ring_pump():
    g, inp_id = _chain()
    sess = _session(g, block_size=128)
    assert not sess.pump()                      # no input buffered yet
    x = (RNG.standard_normal(300) * 0.3).astype(np.float32)
    sess.feed(inp_id, x)                        # 300 samples = 2 full blocks
    assert sess.pump()
    assert sess.pump()
    assert not sess.pump()                      # only 44 left
    out_id = sess.cg.output_ids[0]
    got = sess.drain_output(out_id, 256)
    assert got.shape == (256,)
    more = sess.drain_output(out_id, 100)       # underrun zero-fills
    assert np.all(more == 0.0)
    sess.feed(inp_id, x)                        # resync drains the rings
    sess.resync()
    assert not sess.pump()


def test_stream_block_multiple_of_128():
    g, inp_id = _chain()
    with pytest.raises(ValueError):
        _session(g, block_size=100)
    sess = _session(g, block_size=256)
    x = (RNG.standard_normal(256) * 0.3).astype(np.float32)
    assert sess.process({str(inp_id): x}).shape == (1, 256)


@pytest.mark.parametrize("pol", [*POLICIES, "exact"])
def test_checkpoint_resume(tmp_path, pol):
    """Resume mid-render against an uninterrupted render: under fast and
    parity at HANDOFF_DB, under exact bit for bit (the JAX test's bitwise
    half: the sequential solves do not depend on how the render is
    cut)."""
    g, inp_id = _chain()
    T = 1024
    x = (np.random.default_rng(31).standard_normal(T) * 0.3
         ).astype(np.float32)
    with dt.policy(pol):
        cg = dt.compile_graph(g, device="cpu")
        full, _, _ = cg.render({str(inp_id): torch.from_numpy(x)})
        half1, _, st = cg.render({str(inp_id): torch.from_numpy(x[:512])})
        p = str(tmp_path / f"ck_{pol}.npz")
        ckpt.save_checkpoint(p, g, state=st, meta={"t": 512})
        g2, st2, params2, meta = ckpt.load_checkpoint(p, device="cpu")
        assert meta == {"t": 512} and params2 is None
        cg2 = dt.compile_graph(g2, device="cpu")
        half2, _, _ = cg2.render(
            {str(cg2.input_ids[0]): torch.from_numpy(x[512:])}, state=st2)
    got = torch.cat([half1[0], half2[0]]).numpy()
    if pol == "exact":
        np.testing.assert_array_equal(got, full[0].numpy())
    assert _dbfs(got, full[0].numpy()) <= HANDOFF_DB


def test_debug_render_reports_all_nodes():
    g, inp_id = _chain()
    x = (RNG.standard_normal(512) * 0.3).astype(np.float32)
    outs, report = obs.debug_render(g, {str(inp_id): x}, device="cpu")
    cfgs = {r["cfg"] for r in report}
    assert {"input", "low_pass", "reverb"} <= cfgs
    assert all(r["nan"] == 0 for r in report)
    assert outs.shape == (1, 512)


def test_debug_render_flags_nan():
    g = dt.Graph(IdSpace())
    inp = g.add("input")
    ds = g.add("distort", mode="Fuzz", level=4.0)   # NaN on silent blocks
    out = g.add("output")
    g.chain(inp, ds, out)
    x = np.zeros(256, np.float32)
    outs, report = obs.debug_render(g, {str(inp.id): x}, device="cpu")
    fuzz_recs = [r for r in report if r["cfg"] == "distort"]
    assert fuzz_recs and fuzz_recs[0]["nan"] > 0


def test_nan_guard():
    fn = obs.nan_guard(lambda x: x / 0.0, "div")
    with pytest.raises(FloatingPointError):
        fn(torch.tensor(1.0))
    with pytest.raises(FloatingPointError), np.errstate(divide="ignore"):
        fn(np.float32(1.0))
    assert obs.nan_guard(lambda x: {"y": [x * 2.0]})(torch.ones(3))


def test_make_ring_fallback_semantics():
    for ring in (make_ring(64), _PyRing(64)):
        assert ring.write(np.arange(50, dtype=np.float32)) == 50
        assert ring.write(np.arange(50, dtype=np.float32)) == 14
        assert ring.read(100).size == 64
        ring.drain()
        assert ring.readable == 0


def _passthrough_session():
    """input -> output, so the output ring carries the input (scaled by
    the output port's fan-in 1/1.0001)."""
    g = dt.Graph(IdSpace())
    inp = g.add("input")
    out = g.add("output")
    g.chain(inp, out)
    return _session(g, block_size=128), inp.id


def test_catchup_skips_backlog_after_resync():
    """devices.rs:459-483: with the counter armed and >= 2 blocks of
    backlog, the read drops the backlog and plays the newest block."""
    sess, inp_id = _passthrough_session()
    out_id = sess.cg.output_ids[0]
    x = np.arange(1, 128 * 4 + 1, dtype=np.float32)
    sess.feed(inp_id, x)
    for _ in range(4):
        assert sess.pump()
    assert sess.out_rings[out_id].readable == 512
    sess.resync()                                      # counter := 5
    got = sess.drain_output(out_id, 128)
    want = (x[384:] / np.float32(1.0001)).astype(np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert sess.out_rings[out_id].readable == 0        # backlog dropped
    assert sess._catchup[out_id] == 4                  # decremented once


def test_catchup_counter_decrements_and_expires():
    """The counter saturating-decrements on every successful read; once
    it expires, later backlog is not skipped; underruns never decrement
    it (devices.rs:410-418)."""
    sess, inp_id = _passthrough_session()
    out_id = sess.cg.output_ids[0]
    sess.resync()
    assert sess._catchup[out_id] == 5
    for i in range(5):
        sess.feed(inp_id, np.ones(128, np.float32))
        assert sess.pump()
        got = sess.drain_output(out_id, 128)
        assert got.size == 128 and got[0] != 0.0
        assert sess._catchup[out_id] == 4 - i
    sess.feed(inp_id, np.ones(512, np.float32))
    for _ in range(4):
        assert sess.pump()
    sess.drain_output(out_id, 128)
    assert sess.out_rings[out_id].readable == 384      # backlog kept
    sess.resync()
    before = sess._catchup[out_id]
    sess.out_rings[out_id].drain()
    assert np.all(sess.drain_output(out_id, 128) == 0.0)
    assert sess._catchup[out_id] == before


def test_underrun_returns_silence_without_consuming():
    """try_grant(n) failing leaves the ring untouched and emits a full
    block of zeros (devices.rs:436-440,495-499)."""
    sess, inp_id = _passthrough_session()
    out_id = sess.cg.output_ids[0]
    sess.feed(inp_id, np.ones(128, np.float32))
    assert sess.pump()
    assert np.all(sess.drain_output(out_id, 256) == 0.0)
    assert sess.out_rings[out_id].readable == 128
    assert sess.drain_output(out_id, 128)[0] != 0.0


def test_pyring_wraparound():
    ring = _PyRing(8)
    assert ring.write(np.arange(6, dtype=np.float32)) == 6
    np.testing.assert_array_equal(ring.read(4), np.arange(4, dtype=np.float32))
    assert ring.write(np.arange(10, 15, dtype=np.float32)) == 5   # wraps
    np.testing.assert_array_equal(
        ring.read(7), np.array([4, 5, 10, 11, 12, 13, 14], np.float32))
    assert ring.readable == 0


def test_compile_rejects_non_128_block():
    g, _ = _chain()
    with pytest.raises(ValueError, match="multiple of 128"):
        dt.compile_graph(g, block_size=100, device="cpu")


def test_mismatched_input_lengths_raise():
    g = dt.Graph(IdSpace())
    i1 = g.add("input")
    i2 = g.add("input")
    add = g.add("add")
    out = g.add("output")
    g.connect(i1, "out", add, "a")
    g.connect(i2, "out", add, "b")
    g.connect(add, "out", out, "in")
    cg = dt.compile_graph(g, device="cpu")
    with pytest.raises(ValueError, match="disagree on render length"):
        cg.fn(cg.init_state(), {str(i1.id): torch.zeros(256),
                                str(i2.id): torch.zeros(512)})


def test_batched_dict_input_without_batch_shape_raises():
    g, inp_id = _chain()
    x = torch.zeros((4, 256))
    cg = dt.compile_graph(g, device="cpu")
    with pytest.raises(ValueError, match="batch_shape"):
        cg.render({str(inp_id): x})
    outs, _, _ = cg.render({str(inp_id): x}, batch_shape=(4,))
    assert tuple(outs.shape) == (4, 1, 256)


def test_chorus_lfo_phase_bounded_for_long_streams():
    """A sample clock past 2^24 behaves like the equivalent early clock:
    the LFO phase is reduced in f64 before the f32 sin."""
    from dsp_stuff_tpu_torch.ops.modfx import modulated_delay
    rng = np.random.default_rng(5)
    x = torch.from_numpy((rng.standard_normal(512) * 0.3).astype(np.float32))
    hist = torch.from_numpy((rng.standard_normal(200) * 0.1)
                            .astype(np.float32))
    kw = dict(rate_hz=np.float32(1.5), depth_s=np.float32(0.002),
              base_s=np.float32(0.003), mix=np.float32(0.6))
    y0, _, _ = modulated_delay(x, hist=hist, t0=0, **kw)
    y1, _, _ = modulated_delay(x, hist=hist, t0=32000 * 2400, **kw)
    np.testing.assert_allclose(y0.numpy(), y1.numpy(), atol=1e-6)


def test_stream_matches_offline_with_chorus():
    """Streaming chains the chorus sample clock (a Python int) like one
    render."""
    g = dt.Graph(IdSpace())
    inp = g.add("input")
    ch = g.add("chorus", rate=2.0, depth=0.002, base=0.006, mix=0.6)
    rv = g.add("reverb", seconds=0.005, decay=0.5)
    out = g.add("output")
    g.chain(inp, ch, rv, out)
    T = 1024
    x = (RNG.standard_normal(T) * 0.3).astype(np.float32)
    offline, _, _ = _render(g, {str(inp.id): x})
    streamed = _blocks(_session(g), inp.id, x)
    np.testing.assert_allclose(streamed, offline[0], atol=2e-6)


def _feedback_graph(ids=None):
    g = dt.Graph(ids or IdSpace())
    inp = g.add("input")
    ad = g.add("add")
    rv = g.add("reverb", seconds=0.005, decay=0.5)
    gn = g.add("gain", level=0.4)
    out = g.add("output")
    g.connect(inp, "out", ad, "a")
    g.connect(ad, "out", rv, "in")
    g.connect(rv, "out", gn, "in")
    g.connect(gn, "out", ad, "b")          # back edge
    g.connect(rv, "out", out, "in")
    return g, inp.id


def test_stream_feedback_graph_matches_offline():
    """The cycle's previous-block context rides the carried state across
    process() calls."""
    g, inp_id = _feedback_graph()
    T = 1536
    x = (RNG.standard_normal(T) * 0.3).astype(np.float32)
    offline, _, _ = _render(g, {str(inp_id): x})
    streamed = _blocks(_session(g), inp_id, x)
    np.testing.assert_allclose(streamed, offline[0], rtol=0, atol=1e-6)


def test_process_many_honors_params_change():
    """A ``sess.params`` update reaches process_many() as it reaches
    process()."""
    g = dt.Graph(IdSpace())
    inp = g.add("input")
    gn = g.add("gain", level=1.0)
    out = g.add("output")
    g.chain(inp, gn, out)
    x = np.ones(128 * 2, np.float32) * 0.5
    s = _session(g)
    base = s.process_many({str(inp.id): x})[0]
    s.params = {str(gn.id): {"level": 2.0}}
    via_many = s.process_many({str(inp.id): x})[0]
    s2 = _session(g, params={str(gn.id): {"level": 2.0}})
    via_proc = np.concatenate(
        [s2.process({str(inp.id): x[i:i + 128]})[0] for i in (0, 128)])
    np.testing.assert_array_equal(via_many, via_proc)
    assert np.max(np.abs(via_many)) > 1.5 * np.max(np.abs(base))


def test_process_many_empty_dict():
    """process_many({}) is zeros for every input, and needs n_blocks."""
    g, inp_id = _chain()
    s = _session(g)
    with pytest.raises(ValueError, match="n_blocks"):
        s.process_many({})
    got = s.process_many({}, n_blocks=3)
    s2 = _session(g)
    want = np.concatenate([s2.process({})[0] for _ in range(3)])
    np.testing.assert_array_equal(got[0], want)


# -- the port's own checks ---------------------------------------------------

def test_entry_points_default_to_the_card(tmp_path):
    """Without a CUDA device, StreamSession, load_checkpoint and
    debug_render raise the compiler's message naming device="cpu"."""
    g, inp_id = _chain()
    if torch.cuda.is_available():
        assert StreamSession(g).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match='device="cpu"'):
        StreamSession(g)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        obs.debug_render(g, T=256)
    p = str(tmp_path / "ck.npz")
    ckpt.save_checkpoint(p, g)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ckpt.load_checkpoint(p)


def test_keystr_is_jax_keystr():
    tree = {"3": {"z": 1.0, "pos": 2}, "__cycle__4": {"4:out": 0.0},
            "7": None}
    want = {jax.tree_util.keystr(p)
            for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]}
    got = {k[len("state"):] for k in ckpt._flatten(tree, "state")}
    assert got == want


def test_checkpoint_keeps_counters_and_params(tmp_path):
    """Lockstep counters come back as Python ints and params as tensors;
    the file holds 0-d int32 counters, as the JAX package writes them."""
    g = dt.Graph(IdSpace())
    inp = g.add("input")
    gn = g.add("gain", level=0.5)
    ch = g.add("chorus", rate=2.0, depth=0.002, base=0.006, mix=0.6)
    rv = g.add("reverb", seconds=0.005, decay=0.5)
    out = g.add("output")
    g.chain(inp, gn, ch, rv, out)
    cg = dt.compile_graph(g, device="cpu")
    x = torch.from_numpy((RNG.standard_normal(640) * 0.3).astype(np.float32))
    _, _, st = cg.render({str(inp.id): x})
    params = cg.init_params()
    params[str(gn.id)]["level"] = torch.tensor(0.75)
    p = str(tmp_path / "ck.npz")
    ckpt.save_checkpoint(p, g, state=st, params=params)
    with np.load(p) as data:
        pos = data[f"state['{rv.id}']['pos']"]
        assert pos.dtype == np.int32 and pos.shape == ()
    _, st2, params2, _ = ckpt.load_checkpoint(p, device="cpu")
    assert st2[str(rv.id)]["pos"] == st[str(rv.id)]["pos"]
    assert isinstance(st2[str(ch.id)]["t0"], int)
    assert st2[str(ch.id)]["t0"] == 640
    assert float(params2[str(gn.id)]["level"]) == 0.75
    for k, entry in st.items():
        for kk, v in (entry or {}).items():
            if isinstance(v, torch.Tensor):
                torch.testing.assert_close(st2[k][kk], v, rtol=0, atol=0)


@pytest.mark.parametrize("pol", POLICIES)
def test_stream_vs_jax(pol):
    """The port's StreamSession against the JAX package's on the same
    blocks: the feedback graph and the chain."""
    for g, inp_id in (_feedback_graph(), _chain()):
        x = (np.random.default_rng(41).standard_normal(128 * 8) * 0.3
             ).astype(np.float32)
        with dt.policy(pol), dj.policy(pol):
            got = _blocks(_session(g), inp_id, x)
            js = JStreamSession(_jax_graph(g))
            want = np.concatenate([
                np.asarray(js.process({str(inp_id): x[i:i + 128]}))[0]
                for i in range(0, len(x), 128)])
        assert _dbfs(got, want) <= VS_JAX_DB[pol]


@pytest.mark.parametrize("pol", POLICIES)
def test_checkpoint_across_packages(tmp_path, pol):
    """A checkpoint the JAX package writes resumes in the port, and the
    reverse, each against the other package's uninterrupted render."""
    g, inp_id = _feedback_graph()
    gj = _jax_graph(g)
    x = (np.random.default_rng(43).standard_normal(1024) * 0.3
         ).astype(np.float32)
    ext = {str(inp_id): x}
    with dt.policy(pol), dj.policy(pol):
        # JAX writes, the port resumes
        cgj = dj.compile_graph(gj)
        full_j, _, _ = cgj.render(ext)
        a_j, _, st_j = cgj.render({str(inp_id): x[:512]})
        pj = str(tmp_path / "from_jax.npz")
        jckpt.save_checkpoint(pj, gj, state=st_j, meta={"t": 512})
        g2, st2, _, meta = ckpt.load_checkpoint(pj, device="cpu")
        assert meta == {"t": 512}
        b_t, _, _ = dt.compile_graph(g2, device="cpu").render(
            {str(inp_id): torch.from_numpy(x[512:])}, state=st2)
        got = np.concatenate([np.asarray(a_j)[0], b_t[0].numpy()])
        assert _dbfs(got, np.asarray(full_j)[0]) <= VS_JAX_DB[pol]

        # the port writes, JAX resumes
        cgt = dt.compile_graph(g, device="cpu")
        full_t, _, _ = cgt.render({str(inp_id): torch.from_numpy(x)})
        a_t, _, st_t = cgt.render({str(inp_id): torch.from_numpy(x[:512])})
        pt = str(tmp_path / "from_port.npz")
        ckpt.save_checkpoint(pt, g, state=st_t)
        g3, st3, _, _ = jckpt.load_checkpoint(pt)
        b_j, _, _ = dj.compile_graph(g3).render({str(inp_id): x[512:]},
                                                state=st3)
        got = np.concatenate([a_t[0].numpy(), np.asarray(b_j)[0]])
        assert _dbfs(got, full_t[0].numpy()) <= VS_JAX_DB[pol]


def test_package_exports_the_runtime():
    from dsp_stuff_tpu_torch.runtime import session
    assert dt.render_file is session.render_file
    assert dt.StreamSession is StreamSession
    assert (dt.save_checkpoint, dt.load_checkpoint) == (
        ckpt.save_checkpoint, ckpt.load_checkpoint)


def test_trace_writes_a_chrome_trace(tmp_path):
    with obs.trace(tmp_path) as prof:
        dt.render(_chain()[0], T=256, device="cpu")
    assert prof is not None
    assert (tmp_path / "trace.json").stat().st_size > 0
