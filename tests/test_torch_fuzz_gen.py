"""Random graph generators of the port's graph fuzz, on the port's Graph.

These are the generators of tests/test_fuzz_graphs.py, line for line
(the same draws in the same order, so each seed builds the same graph
JSON: tests/test_torch_fuzz_graphs.py holds them equal), the exact
policy's node pool included.  Nothing here imports JAX, so chip_smoke.py
builds its card-phase graphs from this module.  The module defines no
tests.
"""

import numpy as np

import dsp_stuff_tpu_torch as dst
from dsp_stuff_tpu_torch.ids import IdSpace


# reassociation-free, transcendental-free types: the exact policy's
# BITWISE claim holds for these (PARITY.md scope)
def _exact_pool(rng):
    return [
        ("gain", {"level": float(rng.uniform(0.3, 1.8))}),
        ("add", {}),
        ("mix", {"ratio": float(rng.uniform(0.1, 0.9))}),
        ("distort", {"mode": str(rng.choice(
            ["HardClip", "SoftClip", "Square", "Chebyshev4",
             "RecipSoftClip"])),
            "level": float(rng.uniform(0.5, 6.0))}),
        ("biquad", {"a0": 1.0, "a1": float(rng.uniform(-0.6, 0.0)),
                    "a2": float(rng.uniform(0.0, 0.2)),
                    "b0": float(rng.uniform(0.4, 1.0)),
                    "b1": float(rng.uniform(-0.2, 0.2)), "b2": 0.0}),
        ("low_pass", {"ratio": float(rng.uniform(0.1, 0.9))}),
        ("high_pass", {"ratio": float(rng.uniform(0.05, 0.6))}),
        ("reverb", {"seconds": float(rng.uniform(0.003, 0.012)),
                    "decay": float(rng.uniform(0.2, 0.6))}),
        ("fir", {"mode": "Balanced",
                 "taps": [float(v) for v in
                          rng.standard_normal(int(rng.integers(2, 24)))
                          * 0.3]}),
        ("mux", {"in_port": str(rng.choice(["A", "B"]))}),
        ("demux", {"out_port": str(rng.choice(["A", "B"]))}),
    ]


# (type, params) factories with stable, non-degenerate settings
def _mid_pool(rng):
    return [
        ("gain", {"level": float(rng.uniform(0.3, 1.8))}),
        ("add", {}),
        ("mix", {"ratio": float(rng.uniform(0.1, 0.9))}),
        ("distort", {"mode": str(rng.choice(
            ["HardClip", "SoftClip", "Tanh", "RecipSoftClip", "Sin",
             "Atan", "Square", "Chebyshev4"])),
            "level": float(rng.uniform(0.5, 6.0))}),
        ("overdrive", {"boost": float(rng.uniform(1.0, 8.0)),
                       "drive": float(rng.uniform(0.2, 0.9)),
                       "level": float(rng.uniform(0.3, 1.0))}),
        ("chebyshev", {"level_pos": float(rng.uniform(0.5, 5.0)),
                       "level_neg": float(rng.uniform(0.5, 5.0))}),
        ("biquad", {"a0": 1.0, "a1": float(rng.uniform(-0.6, 0.0)),
                    "a2": float(rng.uniform(0.0, 0.2)),
                    "b0": float(rng.uniform(0.4, 1.0)),
                    "b1": float(rng.uniform(-0.2, 0.2)), "b2": 0.0}),
        ("low_pass", {"ratio": float(rng.uniform(0.1, 0.9))}),
        ("high_pass", {"ratio": float(rng.uniform(0.05, 0.6))}),
        ("envelope", {"attack": float(rng.uniform(1.0, 200.0)),
                      "release": float(rng.uniform(5.0, 400.0))}),
        ("reverb", {"seconds": float(rng.uniform(0.003, 0.012)),
                    "decay": float(rng.uniform(0.2, 0.6))}),
        ("fir", {"mode": "Balanced",
                 "taps": [float(v) for v in
                          rng.standard_normal(int(rng.integers(2, 24)))
                          * 0.3]}),
        ("chorus", {"rate": float(rng.uniform(0.3, 4.0)),
                    "depth": float(rng.uniform(0.001, 0.004)),
                    "base": float(rng.uniform(0.004, 0.012)),
                    "mix": float(rng.uniform(0.2, 0.8))}),
        ("mux", {"in_port": str(rng.choice(["A", "B"]))}),
        ("demux", {"out_port": str(rng.choice(["A", "B"]))}),
    ]


def _random_graph(seed, exact=False):
    rng = np.random.default_rng(seed)
    g = dst.Graph(IdSpace())
    inp = g.add("input")
    nodes = [inp]
    n_mid = int(rng.integers(3, 8))
    pool = _exact_pool(rng) if exact else _mid_pool(rng)
    for _ in range(n_mid):
        t, params = pool[int(rng.integers(0, len(pool)))]
        nodes.append(g.add(t, **params))
    out = g.add("output")

    # wire every middle node's audio inputs from random earlier outputs
    for i, node in enumerate(nodes[1:], start=1):
        for port in node.spec.inputs:
            src = nodes[int(rng.integers(0, i))]
            src_port = str(rng.choice(list(src.spec.outputs)))
            g.connect(src, src_port, node, port)
    last = nodes[-1]
    g.connect(last, str(rng.choice(list(last.spec.outputs))), out, "in")

    # occasional extra fan-in / fan-out
    for _ in range(int(rng.integers(0, 3))):
        a = nodes[int(rng.integers(1, len(nodes)))]
        b = nodes[int(rng.integers(1, len(nodes)))]
        if a is b or not a.spec.outputs or not b.spec.inputs:
            continue
        g.connect(a, str(rng.choice(list(a.spec.outputs))),
                  b, str(rng.choice(list(b.spec.inputs))))

    # occasionally close feedback edges (later -> earlier); always legal —
    # the compiler defines one-block latency for any back edge.  A second
    # edge can create nested or multiple independent SCCs.
    n_back = int(rng.random() < 0.6) + int(rng.random() < 0.25)
    for _ in range(n_back):
        if len(nodes) < 3:
            break
        si = int(rng.integers(2, len(nodes)))
        src = nodes[si]
        dst_n = nodes[int(rng.integers(1, si))]
        if src.spec.outputs and dst_n.spec.inputs:
            g.connect(src, str(rng.choice(list(src.spec.outputs))),
                      dst_n, str(rng.choice(list(dst_n.spec.inputs))))

    # occasionally modulate an as_input port from a slow sine (the sine
    # LFO is transcendental -> skipped in exact-pool graphs)
    mod_targets = [] if exact else [
        (n, ps.name) for n in nodes[1:]
        for ps in n.spec.params if getattr(ps, "as_input", False)]
    if mod_targets and rng.random() < 0.5:
        lfo = g.add("signal_gen", mode="Sine",
                    frequency=float(rng.uniform(0.3, 5.0)),
                    amplitude=float(rng.uniform(0.2, 0.8)))
        n, pname = mod_targets[int(rng.integers(0, len(mod_targets)))]
        g.connect(lfo, "out", n, pname)
    return g, inp.id, out.id


def _random_linear_chain_graph(seed):
    """Chain-shaped generator that actually exercises the linear-run
    fusion planner: a straight chain of linear nodes (gain / low_pass /
    high_pass / biquad with stable random poles) with occasional
    nonlinear separators (run boundaries) and occasional analysis taps
    (extra-consumer exclusions)."""
    rng = np.random.default_rng(seed)
    g = dst.Graph(IdSpace())
    prev = g.add("input")
    inp_id = prev.id
    for _ in range(int(rng.integers(4, 10))):
        r = rng.random()
        if r < 0.22:
            n = g.add("gain", level=float(rng.uniform(0.2, 1.8)))
        elif r < 0.44:
            n = g.add("low_pass", ratio=float(rng.uniform(0.05, 0.95)))
        elif r < 0.62:
            n = g.add("high_pass", ratio=float(rng.uniform(0.05, 0.95)))
        elif r < 0.84:
            p1, p2 = rng.uniform(-0.9, 0.9, 2)        # stable real poles
            n = g.add("biquad", a0=1.0, a1=float(-(p1 + p2)),
                      a2=float(p1 * p2),
                      b0=float(rng.uniform(0.2, 1.0)),
                      b1=float(rng.uniform(-0.5, 0.5)),
                      b2=float(rng.uniform(-0.5, 0.5)))
        else:
            n = g.add("distort", mode="SoftClip",
                      level=float(rng.uniform(0.5, 4.0)))
        g.connect(prev, "out", n, "in")
        if rng.random() < 0.15:                        # tap blocks a run
            wv = g.add("wave_view")
            g.connect(n, "out", wv, "in")
        prev = n
    out = g.add("output")
    g.connect(prev, "out", out, "in")
    return g, inp_id, out.id


def _random_feedback_linear_graph(seed, exact=False):
    """Feedback graphs whose cycle bodies contain fusable linear runs —
    the config5 shape, randomized: input -> add -> [linear run] -> ...
    with a gain-scaled back edge re-entering the add.  Sometimes the
    back edge taps a run INTERIOR instead of the tail (the planner must
    split the run there), and sometimes a nonlinear node sits inside
    the loop (a run boundary)."""
    rng = np.random.default_rng(seed)
    g = dst.Graph(IdSpace())
    inp = g.add("input")
    mixa = g.add("add")
    g.connect(inp, "out", mixa, "a")
    prev = mixa
    chain = []
    for _ in range(int(rng.integers(2, 5))):
        r = rng.random()
        if r < 0.3:
            n = g.add("gain", level=float(rng.uniform(0.2, 0.9)))
        elif r < 0.6:
            n = g.add("low_pass", ratio=float(rng.uniform(0.1, 0.9)))
        elif r < 0.8:
            n = g.add("high_pass", ratio=float(rng.uniform(0.05, 0.6)))
        else:
            p1, p2 = rng.uniform(-0.5, 0.5, 2)          # stable real poles
            n = g.add("biquad", a0=1.0, a1=float(-(p1 + p2)),
                      a2=float(p1 * p2),
                      b0=float(rng.uniform(0.3, 0.9)),
                      b1=float(rng.uniform(-0.3, 0.3)), b2=0.0)
        g.connect(prev, "out", n, "in")
        chain.append(n)
        prev = n
    if not exact and rng.random() < 0.4:        # nonlinear loop member
        n = g.add("distort", mode="SoftClip",
                  level=float(rng.uniform(0.5, 2.0)))
        g.connect(prev, "out", n, "in")
        prev = n
    fb = g.add("gain", level=float(rng.uniform(0.2, 0.5)))
    # back edge source: tail usually, an interior sometimes (splits runs)
    src = prev if rng.random() < 0.7 else \
        chain[int(rng.integers(0, len(chain)))]
    g.connect(src, "out", fb, "in")
    g.connect(fb, "out", mixa, "b")              # closes the SCC
    out = g.add("output")
    g.connect(prev, "out", out, "in")
    return g, inp.id, out.id


def _random_mega_cycle_graph(seed):
    """input -> mega-fusable chain (linear + shaper + comb pool, with
    occasional taps into analysis sinks / second outputs) -> feedback
    loop of cycle-program-capable members -> output."""
    rng = np.random.default_rng(seed)
    g = dst.Graph(IdSpace())
    inp = g.add("input")

    def draw_member():
        r = rng.random()
        if r < 0.15:
            return g.add("gain", level=float(rng.uniform(0.3, 1.5)))
        if r < 0.3:
            return g.add("low_pass", ratio=float(rng.uniform(0.1, 0.9)))
        if r < 0.45:
            return g.add("high_pass", ratio=float(rng.uniform(0.05, 0.6)))
        if r < 0.6:
            p1, p2 = rng.uniform(-0.5, 0.5, 2)
            return g.add("biquad", a0=1.0, a1=float(-(p1 + p2)),
                         a2=float(p1 * p2),
                         b0=float(rng.uniform(0.3, 0.9)),
                         b1=float(rng.uniform(-0.3, 0.3)), b2=0.0)
        if r < 0.72:
            return g.add("distort", mode=str(rng.choice(
                ["SoftClip", "Tanh", "HardClip", "RecipSoftClip"])),
                level=float(rng.uniform(0.5, 4.0)))
        if r < 0.84:
            return g.add("chebyshev",
                         level_pos=float(rng.uniform(0.5, 4.0)),
                         level_neg=float(rng.uniform(0.5, 4.0)))
        return g.add("reverb", seconds=float(rng.uniform(0.003, 0.012)),
                     decay=float(rng.uniform(0.2, 0.6)))

    prev = inp
    taps = []
    for _ in range(int(rng.integers(3, 7))):
        n = draw_member()
        g.connect(prev, "out", n, "in")
        if rng.random() < 0.3:               # mid-chain tap
            wv = g.add("wave_view")
            g.connect(n, "out", wv, "in")
            taps.append(n.id)
        prev = n

    # feedback loop: add -> 1..3 members -> gain -> back into add
    mixa = g.add("add")
    g.connect(prev, "out", mixa, "a")
    loop_prev = mixa
    for _ in range(int(rng.integers(1, 4))):
        n = draw_member()
        g.connect(loop_prev, "out", n, "in")
        loop_prev = n
    fbg = g.add("gain", level=float(rng.uniform(0.2, 0.45)))
    g.connect(loop_prev, "out", fbg, "in")
    g.connect(fbg, "out", mixa, "b")

    out = g.add("output")
    g.connect(loop_prev, "out", out, "in")
    return g, inp.id, out.id
