"""The planner's pointwise groups (compiler/compile.py ``_plan_pointwise``,
``_unit_order``, ``_lower_group``) on the CPU, and the slice as a whole
through the groups' plain version against the JAX package.

* The groups are pinned for config5, config3, the bench chain (whose mega
  run under fast leaves no group: its Output folds into the chain), config2
  and fuzz graphs: members, the signals each reads, what it writes (which
  Output's fan-in average folds in) and its scalar operands; and the
  rules: no cycle member, nothing a mega or linear run claims, convex
  groups, GROUP_OPERANDS, NODE_HOOK and POINTWISE_FUSION, an overridden
  slider staying in its group.
* Through the groups (on the CPU: ``pointwise.interpret``, each group
  counted), config5 and config3 against the JAX package's render at the
  bounds of tests/test_torch_presets.py (VS_JAX_DB), three fuzz graphs at
  tests/test_torch_fuzz_graphs.py's VS_JAX_DB, and the exact policy
  bitwise against the JAX package's exact render (exact-pool fuzz graphs
  with groups) and the eager route.
* A stream step with groups dispatches no host-data tensor and no host
  read (the rehearsal of a capture, as tests/test_torch_stream_graph.py).
"""

import numpy as np
import pytest
import torch

import chip_smoke
import dsp_stuff_tpu as dj
import dsp_stuff_tpu_torch as dt
import test_fuzz_graphs as jfuzz
import test_torch_fuzz_gen as tfuzz
from dsp_stuff_tpu.models import presets as jp
from dsp_stuff_tpu_torch.compiler import compile as tcomp
from dsp_stuff_tpu_torch.models import presets
from dsp_stuff_tpu_torch.ops import pointwise_kernel as pk
from dsp_stuff_tpu_torch.runtime.stream import StreamSession
from dsp_stuff_tpu_torch.utils import precision as tprec
from test_torch_presets import VS_JAX_DB
from test_torch_stream_graph import _HostOps

B, T = 2, 4096
FUZZ_VS_JAX_DB = -100.0


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


def _graphs():
    return {
        "config5": presets.config5_feedback_16node()[0],
        "config3": presets.config3_oversampled_distortion()[0],
        "config2": presets.config2_delay_chorus()[0],
        "bench": chip_smoke.bench_graph(),
        "_random_graph(13)": tfuzz._random_graph(13)[0],
        "_random_graph(15)": tfuzz._random_graph(15)[0],
        "_random_graph(36, exact)": tfuzz._random_graph(36, exact=True)[0],
        "_random_mega_cycle_graph(10)": tfuzz._random_mega_cycle_graph(10)[0],
    }


def _plan(g, pol, pdict=None):
    """[(members with their types, signals read, written, scalars)] of
    the groups one render of ``g`` runs under ``pol``."""
    cg = dt.compile_graph(g, device="cpu")
    with dt.policy(pol):
        mh, _ = cg._active_mega(pdict)
        fh, _ = cg._active_fusion(pdict)
        groups, _ = cg._pointwise_plan(mh, fh)
        out = []
        for m in groups:
            _, sigs, scals, written = cg._lower_group(m, pdict)
            out.append((tuple((n, cg._nodes[n].cfg_name) for n in m),
                        [s for s in sigs if isinstance(s, tuple)], written,
                        len(scals)))
    return out


_C5 = [(((1, "gain"), (3, "overdrive"), (4, "distort")),
        [(0, "out"), (2, "out")], [("value", (1, "out")),
                                   ("value", (4, "out"))], 5),
       (((11, "mix"),), [(1, "out"), (10, "out")],
        [("value", (11, "out"))], 2),
       (((15, "output"),), [(13, "out")], [("out", 15)], 1)]
_BENCH_PARITY = [
    (((1, "gain"),), [(0, "out")], [("value", (1, "out"))], 2),
    (((3, "overdrive"),), [(2, "out")], [("value", (3, "out"))], 4),
    (((6, "distort"), (7, "chebyshev")), [(5, "out")],
     [("value", (7, "out"))], 4),
    (((9, "output"),), [(8, "out")], [("out", 9)], 1)]
_RG13 = [(((1, "overdrive"), (2, "add")), [(9, "out"), (0, "out")],
          [("value", (1, "out")), ("value", (2, "out"))], 3),
         (((6, "mix"),), [(0, "out"), (5, "b"), (2, "out")], [], 3),
         (((8, "output"),), [(7, "out")], [("out", 8)], 1)]
PLANS = {
    # pre -> overdrive (its drive the LFO's, mapped) -> distort writes pre
    # (the dry mix reads it) and distort (the cycle's feed); the mix waits
    # for the chorus; the Output's fan-in folds in
    ("config5", "fast"): _C5, ("config5", "parity"): _C5,
    ("config5", "exact"): _C5,
    # the oversampled shapers are not members (their shaper passes are
    # one-node groups of ops/oversample.py); the Output's fan-in is one
    ("config3", "fast"): [(((3, "output"),), [(2, "out")], [("out", 3)],
                           1)],
    # under fast the mega run takes gain .. reverb and folds the Output
    ("bench", "fast"): [], ("bench", "parity"): _BENCH_PARITY,
    ("bench", "exact"): _BENCH_PARITY,
    ("config2", "fast"): [],
    ("config2", "parity"): [(((3, "gain"), (4, "output")), [(2, "out")],
                             [("out", 4)], 2)],
    # a group whose node nothing reads (the mix) writes nothing and runs
    # no launch (_group_eval)
    ("_random_graph(13)", "fast"): _RG13,
    ("_random_graph(15)", "fast"): [
        (((2, "chebyshev"), (7, "chebyshev"), (8, "output")),
         [(1, "out"), (0, "out")],
         [("value", (2, "out")), ("value", (7, "out")), ("out", 8)], 6)],
    ("_random_graph(36, exact)", "exact"): [
        (((1, "distort"), (4, "gain"), (5, "output"), (2, "distort"),
          (3, "mix")), [(0, "out")], [("out", 5)], 6)],
    ("_random_mega_cycle_graph(10)", "fast"): [
        (((14, "output"),), [(12, "out")], [("out", 14)], 1)],
    # under parity the mega cycle's shapers run node by node: a group of
    # the two chebyshevs and the gain the cycle is fed from
    ("_random_mega_cycle_graph(10)", "parity"): [
        (((4, "chebyshev"), (5, "chebyshev"), (6, "gain")), [(3, "out")],
         [("value", (6, "out"))], 6),
        (((14, "output"),), [(12, "out")], [("out", 14)], 1)],
}


@pytest.mark.parametrize("name, pol", sorted(PLANS))
def test_groups_are_pinned(name, pol):
    assert _plan(_graphs()[name], pol) == PLANS[(name, pol)]


@pytest.mark.parametrize("name", sorted(set(n for n, _ in PLANS)))
def test_group_rules(name):
    """No group holds a cycle member or a node this render's mega runs or
    linear runs take; every group is convex (no node outside it on a path
    between two members) and within GROUP_OPERANDS; the unit order runs
    each unit after every unit it reads."""
    g = _graphs()[name]
    cg = dt.compile_graph(g, device="cpu")
    cyclic = tcomp._cyclic(g, cg._sccs)
    for pol in ("fast", "parity"):
        with dt.policy(pol):
            mh, _ = cg._active_mega(None)
            fh, _ = cg._active_fusion(None)
            groups, order = cg._pointwise_plan(mh, fh)
        claimed = {n for r, *_ in (*mh.values(), *fh.values()) for n in r}
        succ = {n: set() for n in cg._nodes}
        for l in g.links:
            succ[l.src].add(l.dst)

        def reach(start):
            seen, stack = set(), [m for s in start for m in succ[s]]
            while stack:
                m = stack.pop()
                if m not in seen:
                    seen.add(m)
                    stack.extend(succ[m])
            return seen
        for grp in groups:
            s = set(grp)
            assert not s & cyclic and not s & claimed
            for outside in set(cg._nodes) - s:
                assert not (outside in reach(s) and s & reach({outside}))
            assert tcomp._group_cost(g, cg._nodes, s) <= tcomp.GROUP_OPERANDS
        done = set()
        for _, unit in order:
            for n in unit:
                for l in g.links:
                    if l.dst == n and l.src not in unit:
                        assert l.src in done or l.src in cyclic
            done.update(unit)
        assert done == set(cg._nodes)


def test_a_long_chain_splits_at_the_operand_cap():
    """Forty gains in a row: groups of at most GROUP_OPERANDS operands
    each, one after the other, and the render is the eager one's."""
    g = dt.Graph()
    nodes = [g.add("input")] + [g.add("gain", level=1.0 + 0.01 * i)
                                for i in range(40)] + [g.add("output")]
    g.chain(*nodes)
    cg = dt.compile_graph(g, device="cpu")
    groups, _ = cg._pointwise_plan({}, {})
    assert len(groups) > 1 and sum(len(m) for m in groups) == 41
    for m in groups:
        assert tcomp._group_cost(g, cg._nodes, m) <= tcomp.GROUP_OPERANDS
    x = np.random.default_rng(0).standard_normal((1, 1, 256)).astype(
        np.float32)
    y = cg.render(x, batch_shape=(1,))[0]
    tcomp.POINTWISE_FUSION = False
    try:
        want = cg.render(x, batch_shape=(1,))[0]
    finally:
        tcomp.POINTWISE_FUSION = True
    assert torch.equal(y, want)


def test_no_groups_under_node_hook_or_switched_off():
    g = presets.config5_feedback_16node()[0]
    cg = dt.compile_graph(g, device="cpu")
    seen = []
    tcomp.NODE_HOOK = lambda nid, cfg, outs: seen.append(cfg)
    try:
        assert cg._pointwise_plan({}, {})[0] == ()
        cg.render(np.zeros((1, 1, 256), np.float32), batch_shape=(1,))
    finally:
        tcomp.NODE_HOOK = None
    assert {"gain", "overdrive", "distort", "mix"} <= set(seen)
    tcomp.POINTWISE_FUSION = False
    try:
        assert cg._pointwise_plan({}, {})[0] == ()
    finally:
        tcomp.POINTWISE_FUSION = True


def test_an_overridden_slider_stays_in_its_group():
    """A fitted slider (a tensor) or a stream's (data) is an operand: the
    groups are the same, the slider one more scalar operand read by
    pointer, not a member that leaves."""
    g = presets.config5_feedback_16node()[0]
    pdict = {"1": {"level": torch.tensor(1.5)},
             "3": {"boost": torch.tensor(5.0, requires_grad=True)}}
    assert _plan(g, "fast", pdict) == PLANS[("config5", "fast")]
    cg = dt.compile_graph(g, device="cpu")
    prog, _, scals, _ = cg._lower_group((1, 3, 4), pdict)
    assert prog == cg._lower_group((1, 3, 4), None)[0]
    assert scals[0] is pdict["1"]["level"]


def _counted_render(g, x, pol, batch):
    """(outputs, group calls) of a render on the CPU through the groups."""
    counts = {}
    with chip_smoke.calls_counted([(tcomp, "group_call"),
                                   (pk, "group_call")], counts), \
            dt.policy(pol):
        y = dt.compile_graph(g, device="cpu").render(
            x, batch_shape=batch)[0]
    return y, counts.get("group_call", 0)


def _x(seed=0):
    return (np.random.default_rng(seed).standard_normal((B, 1, T))
            * 0.3).astype(np.float32)


@pytest.mark.parametrize("pol", ["fast", "parity"])
@pytest.mark.parametrize("name", ["config5", "config3"])
def test_preset_through_groups_matches_jax(name, pol):
    """config5 (three groups; under parity also its feedback cycle's two,
    a call each a block of its per-node scan) and config3 (the Output's
    group and the two oversampled shaper passes) through the groups'
    plain version against the JAX package's render, at the presets'
    bounds."""
    x = _x()
    y, calls = _counted_render(presets.PRESETS[name]()[0], x, pol, (B,))
    cycle = 2 * (T // 128) if (name, pol) == ("config5", "parity") else 0
    assert calls == 3 + cycle
    with dj.policy(pol):
        want, _, _ = dj.compile_graph(jp.PRESETS[name]()[0]).render(
            x, batch_shape=(B,))
    assert _dbfs(y.numpy(), np.asarray(want)) <= VS_JAX_DB[(name, pol)]


@pytest.mark.parametrize("seed", [5, 13, 15])
def test_fuzz_through_groups_matches_jax(seed):
    """Three fuzz graphs with groups (an overdrive -> add group, a mix
    that writes nothing, two chebyshevs and an Output in one group)
    against the JAX package's render, fast and parity."""
    g, inp, _ = tfuzz._random_graph(seed)
    gj, _, _ = jfuzz._random_graph(seed)
    x = (np.random.default_rng(1000 + seed).standard_normal(1536) * 0.25
         ).astype(np.float32)
    for pol in ("fast", "parity"):
        counts = {}
        with chip_smoke.calls_counted([(tcomp, "group_call")], counts), \
                dt.policy(pol):
            got, _, _ = dt.render(g, {str(inp): x}, device="cpu")
        assert counts.get("group_call", 0) >= 1
        with dj.policy(pol):
            want, _, _ = dj.render(gj, {str(inp): x})
        assert _dbfs(got.numpy(), np.asarray(want)) <= FUZZ_VS_JAX_DB


@pytest.mark.parametrize("seed", [9, 36, 100, 169])
def test_exact_through_groups_is_jax_exact(seed):
    """Under exact, exact-pool fuzz graphs with groups (an Output's fan-in,
    a mix, a group of five) are the JAX package's exact render bit for
    bit, and the eager route's."""
    g, inp, _ = tfuzz._random_graph(seed, exact=True)
    gj, _, _ = jfuzz._random_graph(seed, exact=True)
    x = (np.random.default_rng(4000 + seed).standard_normal(1536) * 0.25
         ).astype(np.float32)
    counts = {}
    with chip_smoke.calls_counted([(tcomp, "group_call")], counts), \
            dt.policy("exact"):
        got, _, _ = dt.render(g, {str(inp): x}, device="cpu")
    assert counts.get("group_call", 0) >= 1
    with dj.policy("exact"):
        want, _, _ = dj.render(gj, {str(inp): x})
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    tcomp.POINTWISE_FUSION = False
    try:
        with dt.policy("exact"):
            eager, _, _ = dt.render(g, {str(inp): x}, device="cpu")
    finally:
        tcomp.POINTWISE_FUSION = True
    assert torch.equal(got, eager)


def test_config5_exact_through_groups_is_the_eager_route():
    """config5 under exact through its three groups: output, aux and state
    bitwise the eager route's."""
    g = presets.config5_feedback_16node()[0]
    x = _x(3)[..., :1280]
    with dt.policy("exact"):
        cg = dt.compile_graph(g, device="cpu")
        got = cg.render(x, batch_shape=(B,))
        tcomp.POINTWISE_FUSION = False
        try:
            want = cg.render(x, batch_shape=(B,))
        finally:
            tcomp.POINTWISE_FUSION = True
    leaves = [chip_smoke.route_leaves(r) for r in (got, want)]
    assert len(leaves[0]) == len(leaves[1])
    for a, b in zip(*leaves):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name, pol", [
    *(pytest.param("config5", p, id=p) for p in ("fast", "parity", "exact")),
    *(pytest.param("_random_graph(8)", p, id=f"one-form-{p}")
      for p in ("fast", "parity", "exact"))])
def test_stream_step_with_groups_is_capturable(name, pol):
    """config5's stream step runs its three groups (under parity and
    exact also its feedback cycle's two, the per-node scan's one block)
    and, after one block, dispatches no host-data tensor and no host
    read; so does a fuzz graph's whose two fan-ins of two sources outside
    the groups are one-form groups (five group calls a block)."""
    g = (presets.config5_feedback_16node()[0] if name == "config5"
         else tfuzz._random_graph(8)[0])
    with dt.policy(pol):
        sess = StreamSession(g, device="cpu")
        x = (np.random.default_rng(5).standard_normal((2, 128)) * 0.3
             ).astype(np.float32)
        key = str(sess.cg.input_ids[0])
        sess.process({key: x[0]})
        sess.step.inputs.copy_(torch.from_numpy(x[1:]))
        counts = {}
        mode = _HostOps()
        with chip_smoke.calls_counted([(tcomp, "group_call")], counts), mode:
            sess.step.run(sess.params)
    want = 5 if name != "config5" else (3 if pol == "fast" else 5)
    assert counts.get("group_call") == want
    assert mode.ops > 10
    assert not mode.host, sorted(set(mode.host))
