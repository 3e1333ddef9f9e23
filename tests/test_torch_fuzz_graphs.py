"""The port's graph fuzz, first part: arbitrary topologies (fan-in,
fan-out, feedback cycles, modulation wiring; mux, demux, fir and the
other node types of the JAX fuzz's pool) from tests/test_fuzz_graphs.py's
``_random_graph``, rendered by the port on the CPU against the
independent block-wise NumPy oracle interpreter (tests/oracle/graph.py),
as tests/test_fuzz_graphs.py holds the JAX package; a few seeds also
against the JAX package's render.  The generators live in
tests/test_torch_fuzz_gen.py; each builds the JAX generator's JSON.

Bounds (oracle.max_err_dbfs, absolute: 20 log10 max|err|), the JAX file's,
each with the worst the CPU measured:
  parity vs oracle      <= -84 (-84.6, seed 3, a chorus into chebyshev
                        shapers; the JAX package's figure too)
  fast vs oracle        <= -80 (-86.8, seed 3)
  two half renders vs one render, fast   <= -100 (-144.5)
  stream 0 of a batch of 4 vs its solo render, fast   atol 2e-6
  vs the JAX package's render (relative dBFS)   <= -100 (-105.9 under both,
                        seed 13: the JAX envelope's in-graph gains, ROADMAP
                        Queue 3 item 5)
  StreamSession (128-sample process() blocks, process_many chunks) vs one
  offline render, fast  <= -90 (the JAX file's: blocked solves reassociate
                        at another T); process_many vs process() bitwise
  exact-pool graphs under exact (tests/test_fuzz_graphs.py:215, :232):
  vs oracle, two half renders vs one, vs the JAX package's exact render,
  and streamed (process() blocks, process_many) vs one render   bitwise
"""

import numpy as np
import pytest
import torch

import chip_smoke
import dsp_stuff_tpu as dj
import dsp_stuff_tpu_torch as dt
import oracle
import test_fuzz_graphs as jfuzz
import test_torch_fuzz_gen as tfuzz
from dsp_stuff_tpu.ids import IdSpace as JIdSpace
from dsp_stuff_tpu_torch.models import presets
from dsp_stuff_tpu_torch.utils import precision as tprec
from oracle import graph as oracle_graph

T = 1536
PARITY_DB = -84.0
FAST_DB = -80.0
STREAM_DB = -90.0
HANDOFF_DB = -100.0
BATCH_ATOL = 2e-6
VS_JAX_DB = -100.0

PARITY_SEEDS = [1, 2, 3, 5, 8, 13, 21, 34, 55, 89, 144, 233, 377, 610, 987,
                1597]
FAST_SEEDS = [3, 11, 42, 77, 123]
BATCH_SEEDS = [2, 8, 21]
SEGMENT_SEEDS = [1, 5, 13]
STREAM_SEEDS = [2, 7, 21]
STREAM_CHAIN_SEEDS = [2, 7]
EXACT_SEEDS = [4, 9, 16, 25, 36, 49, 64, 81, 100, 121, 169, 196]
EXACT_SEGMENT_SEEDS = [9, 25, 49]
EXACT_VS_JAX_SEEDS = [9, 100, 169]
EXACT_STREAM_SEEDS = [16, 64, 100]
#: the exact-pool seeds of each generator that takes ``exact``, here and in
#: tests/test_torch_fuzz_fused.py
EXACT_SEEDS_USED = {"_random_graph": EXACT_SEEDS,
                    "_random_feedback_linear_graph": [0, 3, 7, 10]}
GENERATORS = ["_random_graph", "_random_linear_chain_graph",
              "_random_feedback_linear_graph", "_random_mega_cycle_graph"]
#: the seeds each generator is rendered at, here and in
#: tests/test_torch_fuzz_fused.py
SEEDS_USED = {
    "_random_graph": sorted(set(PARITY_SEEDS + FAST_SEEDS + BATCH_SEEDS
                                + SEGMENT_SEEDS + STREAM_SEEDS)),
    "_random_linear_chain_graph": list(range(20)),
    "_random_feedback_linear_graph": list(range(12)),
    "_random_mega_cycle_graph": list(range(10)),
}


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


def _x(seed, shape=(T,)):
    return (np.random.default_rng(seed).standard_normal(shape) * 0.25
            ).astype(np.float32)


def _render(g, inp_id, x, pol, **kw):
    with dt.policy(pol):
        outs, _, _ = dt.render(g, {str(inp_id): x}, device="cpu", **kw)
    return outs.numpy()


def _oracle(g, inp_id, out_id, x):
    """tests/oracle/graph.py's evaluate of the port's graph (read by the
    JAX package's Graph, whose ParamSpec the interpreter reads)."""
    gj = dj.loads_graph(dt.dumps_graph(g), ids=JIdSpace())
    want = oracle_graph.evaluate(gj, {inp_id: x}, len(x))[out_id]
    assert np.isfinite(want).all(), "oracle blew up -- bad generator params"
    return want


@pytest.mark.parametrize("name", GENERATORS)
def test_generators_build_the_jax_json(name):
    for seed in SEEDS_USED[name]:
        gt, it, ot = getattr(tfuzz, name)(seed)
        gj, ij, oj = getattr(jfuzz, name)(seed)
        assert dt.dumps_graph(gt) == dj.dumps_graph(gj), (name, seed)
        assert (it, ot) == (ij, oj)


@pytest.mark.parametrize("name", sorted(EXACT_SEEDS_USED))
def test_exact_generators_build_the_jax_json(name):
    """The exact pool's draws are the JAX file's too."""
    for seed in EXACT_SEEDS_USED[name]:
        gt, it, ot = getattr(tfuzz, name)(seed, exact=True)
        gj, ij, oj = getattr(jfuzz, name)(seed, exact=True)
        assert dt.dumps_graph(gt) == dj.dumps_graph(gj), (name, seed)
        assert (it, ot) == (ij, oj)


def test_random_graph_seeds_hold_every_ported_type():
    """The seeds reach mux, demux and fir (which did not load before
    they were ported) and the envelope."""
    kinds = set()
    for seed in SEEDS_USED["_random_graph"]:
        g, _, _ = tfuzz._random_graph(seed)
        kinds |= {n.cfg_name for n in g.nodes.values()}
    assert {"mux", "demux", "fir", "envelope"} <= kinds


@pytest.mark.parametrize("seed", PARITY_SEEDS)
def test_random_graph_parity_vs_oracle(seed):
    # -84, not -90, as in tests/test_fuzz_graphs.py: fuzzed topologies can
    # stack a 1-ulp-class op (chorus tap interpolation, transcendental
    # shapers) into a downstream high-gain shaper whose slope amplifies it
    g, inp_id, out_id = tfuzz._random_graph(seed)
    x = _x(1000 + seed)
    got = _render(g, inp_id, x, "parity")[0]
    db = oracle.max_err_dbfs(got, _oracle(g, inp_id, out_id, x))
    assert db <= PARITY_DB, f"seed {seed}: {db:.1f} dBFS"


@pytest.mark.parametrize("seed", BATCH_SEEDS)
def test_random_graph_batch_invariance(seed):
    """Stream 0 of a batched render equals the solo render (lockstep
    shared state: the FIR's n_seen, ring positions, clocks), fast."""
    g, inp_id, _ = tfuzz._random_graph(seed)
    x = _x(2000 + seed, (4, T))
    outs = _render(g, inp_id, x, "fast", batch_shape=(4,))
    solo = _render(g, inp_id, x[0], "fast")
    np.testing.assert_allclose(outs[0], solo, rtol=0, atol=BATCH_ATOL)


@pytest.mark.parametrize("seed", SEGMENT_SEEDS)
def test_random_graph_segmented_state_chaining(seed):
    """Two chained half-renders match the one-shot render: every node
    type's state carry at once (filters, rings, FIR warm-up, oscillator
    clocks, chorus history, envelope carry)."""
    g, inp_id, _ = tfuzz._random_graph(seed)
    x = _x(3000 + seed)
    half = T // 2
    with dt.policy("fast"):
        cg = dt.compile_graph(g, device="cpu")
        full, _, _ = cg.render({str(inp_id): x})
        a, _, st = cg.render({str(inp_id): x[:half]})
        b, _, _ = cg.render({str(inp_id): x[half:]}, state=st)
    got = torch.cat([a[0], b[0]]).numpy()
    db = oracle.max_err_dbfs(got, full[0].numpy())
    assert db <= HANDOFF_DB, f"seed {seed}: {db:.1f} dBFS"


@pytest.mark.parametrize("seed", FAST_SEEDS)
def test_random_graph_fast_policy_vs_oracle(seed):
    """Fast-policy renders through whatever the planner fuses against the
    oracle interpreter."""
    g, inp_id, out_id = tfuzz._random_graph(seed)
    x = _x(7000 + seed)
    got = _render(g, inp_id, x, "fast")[0]
    db = oracle.max_err_dbfs(got, _oracle(g, inp_id, out_id, x))
    assert db <= FAST_DB, f"seed {seed}: {db:.1f} dBFS"


@pytest.mark.parametrize("pol", ["fast", "parity"])
@pytest.mark.parametrize("seed", [5, 13, 987])
def test_random_graph_vs_jax(seed, pol):
    """A few seeds (fir, mux, demux and the envelope among them; none with
    a chorus, whose fast trajectory the JAX package computes otherwise,
    ROADMAP Queue 3 item 6) against the JAX package's own render of its
    generator's graph."""
    g, inp_id, _ = tfuzz._random_graph(seed)
    gj, _, _ = jfuzz._random_graph(seed)
    x = _x(1000 + seed)
    got = _render(g, inp_id, x, pol)
    with dj.policy(pol):
        want, _, _ = dj.render(gj, {str(inp_id): x})
    assert _dbfs(got, np.asarray(want)) <= VS_JAX_DB


def _streamed(g, inp_id, x, chunks):
    """(process() blocks, process_many over ``chunks`` samples each) of x
    through two fresh StreamSessions on the CPU, fast."""
    with dt.policy("fast"):
        sess = dt.StreamSession(g, device="cpu")
        blocks = np.concatenate([sess.process({str(inp_id): x[i:i + 128]})[0]
                                 for i in range(0, len(x), 128)])
        sess2 = dt.StreamSession(g, device="cpu")
        edges = [0, *np.cumsum(chunks)]
        many = np.concatenate([
            sess2.process_many({str(inp_id): x[a:b]})[0]
            for a, b in zip(edges[:-1], edges[1:])])
    return blocks, many


@pytest.mark.parametrize("seed", STREAM_SEEDS)
def test_random_graph_streaming_matches_offline(seed):
    """StreamSession on random topologies: 128-sample process() blocks and
    mixed-k process_many() chunks carry every node type's state (cycle
    context, chorus history, FIR warm-up, oscillator clocks) like one
    offline render; the two forms run the same one-block step, so they
    agree bit for bit."""
    g, inp_id, _ = tfuzz._random_graph(seed)
    x = _x(6000 + seed)
    offline = _render(g, inp_id, x, "fast")[0]
    blocks, many = _streamed(g, inp_id, x, (5 * 128, T - 5 * 128))
    for got in (blocks, many):
        db = oracle.max_err_dbfs(got, offline)
        assert db <= STREAM_DB, f"seed {seed}: {db:.1f} dBFS"
    np.testing.assert_array_equal(many, blocks)


@pytest.mark.parametrize("seed", STREAM_CHAIN_SEEDS)
def test_random_linear_chain_streaming_matches_offline(seed):
    """Fused linear runs and chain segments at the stream's 128-sample
    shape against the offline render."""
    g, inp_id, _ = tfuzz._random_linear_chain_graph(seed)
    x = _x(10_000 + seed)
    offline = _render(g, inp_id, x, "fast")[0]
    blocks, many = _streamed(g, inp_id, x, (T // 2, T // 2))
    db = oracle.max_err_dbfs(many, offline)
    assert db <= STREAM_DB, f"seed {seed}: {db:.1f} dBFS"
    np.testing.assert_array_equal(many, blocks)


@pytest.mark.parametrize("seed", EXACT_SEEDS)
def test_random_graph_exact_bitwise(seed):
    """The exact policy's bitwise claim, fuzzed: random topologies over the
    reassociation-free pool reproduce the oracle interpreter bit for bit
    (fan-in order, true divides, sequential recurrences, cycle latency)."""
    g, inp_id, out_id = tfuzz._random_graph(seed, exact=True)
    x = _x(4000 + seed)
    got = _render(g, inp_id, x, "exact")[0]
    np.testing.assert_array_equal(got, _oracle(g, inp_id, out_id, x),
                                  err_msg=f"seed {seed}")


@pytest.mark.parametrize("seed", EXACT_SEGMENT_SEEDS)
def test_random_graph_exact_segmented_bitwise(seed):
    """Under exact two half renders are one render, bit for bit."""
    g, inp_id, _ = tfuzz._random_graph(seed, exact=True)
    x = _x(5000 + seed)
    half = T // 2
    with dt.policy("exact"):
        cg = dt.compile_graph(g, device="cpu")
        full, _, _ = cg.render({str(inp_id): x})
        a, _, st = cg.render({str(inp_id): x[:half]})
        b, _, _ = cg.render({str(inp_id): x[half:]}, state=st)
    np.testing.assert_array_equal(torch.cat([a[0], b[0]]).numpy(),
                                  full[0].numpy(), err_msg=f"seed {seed}")


@pytest.mark.parametrize("seed", EXACT_VS_JAX_SEEDS)
def test_random_graph_exact_vs_jax(seed):
    """The port's exact render is the JAX package's, bit for bit."""
    g, inp_id, _ = tfuzz._random_graph(seed, exact=True)
    gj, _, _ = jfuzz._random_graph(seed, exact=True)
    x = _x(4000 + seed)
    got = _render(g, inp_id, x, "exact")
    with dj.policy("exact"):
        want, _, _ = dj.render(gj, {str(inp_id): x})
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("seed", EXACT_STREAM_SEEDS)
def test_random_graph_exact_streaming_bitwise(seed):
    """StreamSession under exact: 128-sample process() blocks and
    process_many chunks are the exact render, bit for bit (every op of
    the path is elementwise or order-pinned)."""
    g, inp_id, _ = tfuzz._random_graph(seed, exact=True)
    x = _x(6000 + seed)
    offline = _render(g, inp_id, x, "exact")[0]
    with dt.policy("exact"):
        sess = dt.StreamSession(g, device="cpu")
        blocks = np.concatenate([sess.process({str(inp_id): x[i:i + 128]})[0]
                                 for i in range(0, T, 128)])
        sess2 = dt.StreamSession(g, device="cpu")
        many = np.concatenate([
            sess2.process_many({str(inp_id): x[a:b]})[0]
            for a, b in ((0, 5 * 128), (5 * 128, T))])
    np.testing.assert_array_equal(blocks, offline, err_msg=f"seed {seed}")
    np.testing.assert_array_equal(many, offline, err_msg=f"seed {seed}")


@pytest.mark.parametrize("seed", EXACT_SEEDS + ["config5"])
def test_smoke_oracle_is_the_oracle(seed):
    """chip_smoke.oracle_evaluate (the oracle interpreter's loop over the
    port's graph, planned by the port's SCC order and node pruning, so that
    the card's run imports nothing of the JAX package) is
    tests/oracle/graph.evaluate over the JAX package's graph, bit for bit,
    on the exact-pool graphs the smoke run holds the card to, and on
    config5."""
    assert chip_smoke.EXACT_FUZZ_SEEDS == tuple(EXACT_SEEDS)
    if seed == "config5":
        g, meta = presets.config5_feedback_16node()
        inp_id = meta["input"]
    else:
        g, inp_id, _ = tfuzz._random_graph(seed, exact=True)
    x = _x(7000 + (seed if isinstance(seed, int) else 0))
    got = chip_smoke.oracle_evaluate(g, {inp_id: x}, T)
    gj = dj.loads_graph(dt.dumps_graph(g), ids=JIdSpace())
    want = oracle_graph.evaluate(gj, {inp_id: x}, T)
    assert sorted(got) == sorted(want)
    for out_id in want:
        np.testing.assert_array_equal(got[out_id], want[out_id],
                                      err_msg=f"{seed} output {out_id}")
