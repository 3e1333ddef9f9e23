"""The port's graph fuzz, second part: the generators that aim at the fast
policy's fused paths (tests/test_fuzz_graphs.py:315-785) -- linear chains
for the cascade planner, feedback loops with in-cycle linear runs, and
joint graphs where chain segments, cycle programs and linear runs all
fire -- rendered by the port on the CPU against the block-wise NumPy
oracle interpreter (tests/oracle/graph.py), with the planner's rules and
spies on the port's ``chain_segment`` and ``cycle_segment`` proving that
the fused paths engage; a few seeds of each generator also against the
JAX package's render.  The generators live in tests/test_torch_fuzz_gen.py.

Bounds (oracle.max_err_dbfs, absolute: 20 log10 max|err|), the JAX file's
CPU bounds, each with the worst the CPU measured:
  linear chain, fast vs oracle            <= -80 (-133.9)
  linear chain, two halves vs one render  <= -100 (-150.5)
  feedback linear, fast vs oracle         <= -80 (-144.5)
  feedback linear, two halves vs one      <= -100 (bitwise)
  mega cycle, fast vs oracle              <= -80 (-123.7)
  mega cycle, two halves vs one           <= -100 (-168.6)
  the two planner-rule graphs vs oracle   <= -80 (-141.0)
  vs the JAX package's render (relative dBFS), fast   <= -100 (-129.8)
  feedback linear, exact vs oracle        bitwise (the JAX file's
                                          tests/test_fuzz_graphs.py:505)

The streaming fuzz (tests/test_fuzz_graphs.py:253) is ported in
tests/test_torch_fuzz_graphs.py.
"""

import numpy as np
import pytest
import torch

import dsp_stuff_tpu as dj
import dsp_stuff_tpu_torch as dt
import oracle
import test_fuzz_graphs as jfuzz
import test_torch_fuzz_gen as tfuzz
from dsp_stuff_tpu.ids import IdSpace as JIdSpace
from dsp_stuff_tpu_torch.compiler import compile as tcompile
from dsp_stuff_tpu_torch.ids import IdSpace
from dsp_stuff_tpu_torch.ops import chain_segment as tcs
from dsp_stuff_tpu_torch.utils import precision as tprec
from oracle import graph as oracle_graph

T = 1536
FAST_DB = -80.0
HANDOFF_DB = -100.0
VS_JAX_DB = -100.0
MEGA_CYCLE_SEEDS = list(range(10))
FEEDBACK_EXACT_SEEDS = [0, 3, 7, 10]


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


def _x(seed):
    return (np.random.default_rng(seed).standard_normal(T) * 0.25
            ).astype(np.float32)


def _render_fast(g, inp_id, x):
    with dt.policy("fast"):
        outs, _, _ = dt.render(g, {str(inp_id): x}, device="cpu")
    return outs[0].numpy()


def _oracle(g, inp_id, out_id, x):
    gj = dj.loads_graph(dt.dumps_graph(g), ids=JIdSpace())
    want = oracle_graph.evaluate(gj, {inp_id: x}, len(x))[out_id]
    assert np.isfinite(want).all(), "oracle blew up -- bad generator params"
    return want


def _fast_vs_oracle(gen, seed, x_seed):
    g, inp_id, out_id = gen(seed)
    x = _x(x_seed)
    db = oracle.max_err_dbfs(_render_fast(g, inp_id, x),
                             _oracle(g, inp_id, out_id, x))
    assert db <= FAST_DB, f"seed {seed}: {db:.1f} dBFS"


def _halves_vs_one(gen, seed, x_seed):
    """Two chained half-renders against the one-shot render, fast."""
    g, inp_id, _ = gen(seed)
    x = _x(x_seed)
    half = T // 2
    with dt.policy("fast"):
        cg = dt.compile_graph(g, device="cpu")
        full, _, _ = cg.render({str(inp_id): x})
        a, _, st = cg.render({str(inp_id): x[:half]})
        b, _, _ = cg.render({str(inp_id): x[half:]}, state=st)
    db = oracle.max_err_dbfs(torch.cat([a[0], b[0]]).numpy(),
                             full[0].numpy())
    assert db <= HANDOFF_DB, f"seed {seed}: {db:.1f} dBFS"


def _plan_for(g):
    """The port's linear-fusion plan for a graph (active nodes and SCCs
    computed as compile_graph does)."""
    from dsp_stuff_tpu_torch.compiler.scc import condensation_topo_order
    active = tcompile._active_nodes(g)
    nodes = {nid: n for nid, n in g.nodes.items() if nid in active}
    edges = {nid: set() for nid in nodes}
    for l in g.links:
        if l.src in nodes and l.dst in nodes:
            edges[l.src].add(l.dst)
    sccs = condensation_topo_order(sorted(nodes), edges)
    return tcompile._plan_linear_fusion(g, nodes, sccs), sccs


def _in_cycle_runs(g):
    plan, sccs = _plan_for(g)
    cyc = {n for comp in sccs if len(comp) > 1 for n in comp}
    return [r for r in plan if r[0] in cyc]


# -- linear chains (the cascade planner) -------------------------------------

@pytest.mark.parametrize("seed", list(range(20)))
def test_random_linear_chain_fast_vs_oracle(seed):
    """Random run shapes (gain folds, one-pole pairs, biquads with stable
    random poles), dim-cap splits and tap / nonlinearity boundaries."""
    _fast_vs_oracle(tfuzz._random_linear_chain_graph, seed, 8000 + seed)


@pytest.mark.parametrize("seed", [0, 3, 5, 9, 14])
def test_random_linear_chain_segmented_state_carry(seed):
    """Every run shape's composite-state handoff (one-pole components, the
    biquad DirectForm1 rebuild from run histories) at once."""
    _halves_vs_one(tfuzz._random_linear_chain_graph, seed, 9000 + seed)


# -- feedback loops with in-cycle linear runs --------------------------------

@pytest.mark.parametrize("seed", list(range(12)))
def test_random_feedback_linear_fast_vs_oracle(seed):
    """config5's shape randomized: run head fan-in inside the loop,
    interior-tap splits, tail back edges, per-block composite state."""
    _fast_vs_oracle(tfuzz._random_feedback_linear_graph, seed,
                    11_000 + seed)


def test_feedback_linear_fusion_fuzz_not_vacuous():
    """The generator produces in-cycle runs for the fuzz above to
    exercise."""
    hits = sum(bool(_in_cycle_runs(tfuzz._random_feedback_linear_graph(s)[0]))
               for s in range(12))
    assert hits >= 6, f"only {hits}/12 seeds formed an in-cycle run"


@pytest.mark.parametrize("seed", [1, 4, 8])
def test_random_feedback_linear_segmented_state_carry(seed):
    _halves_vs_one(tfuzz._random_feedback_linear_graph, seed, 13_000 + seed)


@pytest.mark.parametrize("seed", FEEDBACK_EXACT_SEEDS)
def test_random_feedback_linear_exact_bitwise(seed):
    """The same cycle shapes under the exact policy (nothing fuses; the
    per-node block scan with the sequential solves) stay bitwise the
    oracle interpreter."""
    g, inp_id, out_id = tfuzz._random_feedback_linear_graph(seed, exact=True)
    x = _x(12_000 + seed)
    with dt.policy("exact"):
        outs, _, _ = dt.render(g, {str(inp_id): x}, device="cpu")
    np.testing.assert_array_equal(outs[0].numpy(),
                                  _oracle(g, inp_id, out_id, x),
                                  err_msg=f"seed {seed}")


def test_in_cycle_fusion_contiguity_rules():
    """The planner's in-cycle preconditions: a linear pair whose ids are
    not consecutive in the cycle's execution order does not fuse (a
    non-member evaluates between them), nor does a signal-order-descending
    pair (its joint is a back edge carrying one block of delay)."""
    g = dt.Graph(IdSpace())
    inp = g.add("input")
    mixa = g.add("add")
    fbg = g.add("gain", level=0.4)       # id 2
    lp = g.add("low_pass", ratio=0.5)    # id 3
    out = g.add("output")
    g.connect(inp, "out", mixa, "a")
    g.connect(mixa, "out", lp, "in")
    g.connect(lp, "out", fbg, "in")      # pos[fbg] < pos[lp]: back edge
    g.connect(fbg, "out", mixa, "b")
    g.connect(lp, "out", out, "in")
    assert _plan_for(g)[0] == []

    g2 = dt.Graph(IdSpace())
    inp2 = g2.add("input")
    mixa2 = g2.add("add")
    lp2 = g2.add("low_pass", ratio=0.5)            # id 2
    dist2 = g2.add("distort", mode="SoftClip", level=1.5)   # id 3
    fbg2 = g2.add("gain", level=0.4)               # id 4
    out2 = g2.add("output")
    g2.connect(inp2, "out", mixa2, "a")
    g2.connect(mixa2, "out", lp2, "in")
    g2.connect(lp2, "out", fbg2, "in")             # pos gap: dist2 between
    g2.connect(fbg2, "out", dist2, "in")
    g2.connect(dist2, "out", mixa2, "b")
    g2.connect(fbg2, "out", out2, "in")
    assert _plan_for(g2)[0] == []

    # both graphs still render correctly
    x = (np.random.default_rng(42).standard_normal(T) * 0.25
         ).astype(np.float32)
    for gg, iid, oid in ((g, inp.id, out.id), (g2, inp2.id, out2.id)):
        db = oracle.max_err_dbfs(_render_fast(gg, iid, x),
                                 _oracle(gg, iid, oid, x))
        assert db <= FAST_DB, db


def test_config5_in_cycle_pair_fuses():
    """config5's lp -> fbg pair inside the feedback SCC plans as an
    in-cycle run."""
    from dsp_stuff_tpu_torch.models import presets
    g, _ = presets.config5_feedback_16node()
    in_cycle = _in_cycle_runs(g)
    assert in_cycle, "lp -> fbg did not plan"
    assert any(len(r) == 2 for r in in_cycle), in_cycle


# -- joint graphs: chain segments, cycle programs and linear runs ------------

class _Spy:
    """Wrap a fused entry point, recording its call arguments."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.calls = []

    def __enter__(self):
        self._orig = getattr(self.module, self.name)

        def wrapper(*a, **k):
            self.calls.append(a)
            return self._orig(*a, **k)

        setattr(self.module, self.name, wrapper)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self._orig)


def _render_fast_with_spies(g, inp_id, x):
    """The fast render with spies on the port's chain_segment (which the
    evaluator calls through its module) and cycle_segment (bound in the
    compiler's namespace)."""
    with _Spy(tcs, "chain_segment") as s_chain, \
            _Spy(tcompile, "cycle_segment") as s_cyc:
        got = _render_fast(g, inp_id, x)
    return got, s_chain.calls, s_cyc.calls


@pytest.mark.parametrize("seed", MEGA_CYCLE_SEEDS)
def test_random_mega_cycle_fast_vs_oracle(seed):
    g, inp_id, out_id = tfuzz._random_mega_cycle_graph(seed)
    x = _x(20_000 + seed)
    got, _, _ = _render_fast_with_spies(g, inp_id, x)
    db = oracle.max_err_dbfs(got, _oracle(g, inp_id, out_id, x))
    assert db <= FAST_DB, f"seed {seed}: {db:.1f} dBFS"


def test_mega_cycle_fuzz_not_vacuous():
    """Across the seeds both fused entry points engage, segments include
    shaper + comb members, and tap stages occur (by the spies' calls, not
    by plan metadata)."""
    chain_hits = cyc_hits = tap_hits = rich_hits = 0
    for seed in MEGA_CYCLE_SEEDS:
        g, inp_id, _ = tfuzz._random_mega_cycle_graph(seed)
        _, chain_calls, cyc_calls = _render_fast_with_spies(
            g, inp_id, np.zeros(T, np.float32))
        chain_hits += bool(chain_calls)
        cyc_hits += bool(cyc_calls)
        for call in chain_calls:
            kinds = {st[0] for st in call[1]}
            tap_hits += "tap" in kinds
            rich_hits += ("ew" in kinds and "comb" in kinds)
    assert chain_hits >= 5, f"chain segments engaged on {chain_hits}/10"
    assert cyc_hits >= 5, f"cycle programs engaged on {cyc_hits}/10"
    assert tap_hits >= 2, f"tap stages occurred {tap_hits} times"
    assert rich_hits >= 2, f"shaper+comb segments occurred {rich_hits} times"


@pytest.mark.parametrize("seed", [1, 4, 7])
def test_random_mega_cycle_segmented_state_carry(seed):
    """Tap-split cascades, comb rings and cycle registers across the
    segment boundary."""
    _halves_vs_one(tfuzz._random_mega_cycle_graph, seed, 21_000 + seed)


@pytest.mark.parametrize("name,seed", [
    ("_random_linear_chain_graph", 3), ("_random_linear_chain_graph", 11),
    ("_random_feedback_linear_graph", 0), ("_random_feedback_linear_graph", 7),
    ("_random_mega_cycle_graph", 2), ("_random_mega_cycle_graph", 5)])
def test_fused_generators_vs_jax(name, seed):
    """A few seeds of each generator against the JAX package's fast
    render of its own generator's graph (the same planner decisions in
    both: chain segments, cascades, cycle programs)."""
    g, inp_id, _ = getattr(tfuzz, name)(seed)
    gj, _, _ = getattr(jfuzz, name)(seed)
    x = _x(30_000 + seed)
    got = _render_fast(g, inp_id, x)
    with dj.policy("fast"):
        want, _, _ = dj.render(gj, {str(inp_id): x})
    assert _dbfs(got, np.asarray(want)[0]) <= VS_JAX_DB
