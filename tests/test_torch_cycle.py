"""The port's feedback-cycle path: the planners that know SCCs, the block
program (dsp_stuff_tpu_torch/ops/cycle_segment.py), the CPU-side half of
its CUDA kernel (ops/cycle_kernel.py) and the compiler's two cycle
branches, against the JAX package and the NumPy oracle.

The CUDA kernel itself runs only on a GPU (chip_smoke.py holds it against
``interpret`` there); here the JAX Pallas cycle kernel's raw outputs in
interpret mode, called as tests/test_cycle_segment.py calls it, pin the
layout that ``rebuild`` reads.

Bounds (dBFS = 20 log10(max|err| / max|reference|)):
  interpret vs JAX interpret       taps <= -120, registers/states atol 2e-6
  render vs JAX, fast and parity   <= -120; <= -110 with an LFO under fast
                                   (XLA's and PyTorch's f32 sins differ in
                                   the last bit; measured -117.5)
  parity render vs the oracle      <= -110 (the README's bound is -90)
  chained vs one long render       <= -135
"""

import re

import jax
import numpy as np
import pytest
import torch

import dsp_stuff_tpu as dj
from dsp_stuff_tpu.compiler import compile as jcomp
from dsp_stuff_tpu.ids import IdSpace as JIdSpace
from dsp_stuff_tpu.ops import cycle_segment as jcyc
from dsp_stuff_tpu.ops import pallas_cycle as jpcy
from dsp_stuff_tpu.utils import precision as jprec
from dsp_stuff_tpu_torch import convert
from dsp_stuff_tpu_torch.compiler import compile as tcomp
from dsp_stuff_tpu_torch.ids import IdSpace as TIdSpace
from dsp_stuff_tpu_torch.ops import cycle_kernel as tck
from dsp_stuff_tpu_torch.ops import cycle_segment as tcyc
from dsp_stuff_tpu_torch.utils import precision as tprec
import dsp_stuff_tpu_torch as dt

TAP_DB = -120.0
STATE_ATOL = 2e-6
VS_JAX_DB = -120.0
LFO_DB = -110.0
ORACLE_DB = -110.0
HANDOFF_DB = -135.0


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


def _close(got, want, atol=STATE_ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=0,
                               atol=atol)


def _loop(g, seconds=0.004, shaper=True):
    """input -> add -> [distort] -> reverb -> lp -> gain -> add (back edge);
    reverb also tapped to the output (tests/test_cycle_segment.py)."""
    inp = g.add("input")
    mixa = g.add("add")
    rv = g.add("reverb", seconds=seconds, decay=0.5)
    lp = g.add("low_pass", ratio=0.4)
    fbg = g.add("gain", level=0.45)
    out = g.add("output")
    g.connect(inp, "out", mixa, "a")
    if shaper:
        ds = g.add("distort", mode="SoftClip", level=2.0)
        g.connect(mixa, "out", ds, "in")
        g.connect(ds, "out", rv, "in")
    else:
        g.connect(mixa, "out", rv, "in")
    g.connect(rv, "out", lp, "in")
    g.connect(lp, "out", fbg, "in")
    g.connect(fbg, "out", mixa, "b")
    g.connect(rv, "out", out, "in")


def _add_reverb_gain(g):
    """An add -> reverb -> gain loop, with a mix after it."""
    inp = g.add("input")
    mixa = g.add("add")
    rv = g.add("reverb", seconds=0.003, decay=0.6)
    fbg = g.add("gain", level=0.5)
    mx = g.add("mix", ratio=0.3)
    out = g.add("output")
    g.connect(inp, "out", mixa, "a")
    g.chain(mixa, rv, fbg)
    g.connect(fbg, "out", mixa, "b")
    g.connect(inp, "out", mx, "a")
    g.connect(rv, "out", mx, "b")
    g.connect(mx, "out", out, "in")


def _self_loop(g):
    """A single add with a self back edge: the smallest SCC."""
    inp = g.add("input")
    mixa = g.add("add")
    out = g.add("output")
    g.connect(inp, "out", mixa, "a")
    g.connect(mixa, "out", mixa, "b")
    g.connect(mixa, "out", out, "in")


def _mix_loop_biquad(g):
    """A mix in the loop with a biquad + high_pass run (one cascade unit)
    and a shaper; two taps leave the cycle."""
    inp = g.add("input")
    mx = g.add("mix", ratio=0.35)
    bq = g.add("biquad", a0=1.0, a1=-0.5, a2=0.1, b0=0.3, b1=0.2, b2=0.1)
    hp = g.add("high_pass", ratio=0.2)
    od = g.add("overdrive", boost=2.0, drive=0.5, level=0.8)
    rv = g.add("reverb", seconds=0.005, decay=0.4)
    o1 = g.add("output")
    o2 = g.add("output")
    g.connect(inp, "out", mx, "a")
    g.chain(mx, bq, hp, od, rv)
    g.connect(rv, "out", mx, "b")
    g.connect(hp, "out", o1, "in")
    g.connect(rv, "out", o2, "in")


def _config5(g):
    from dsp_stuff_tpu.models.presets import config5_feedback_16node
    return config5_feedback_16node()[0]


GRAPHS = {"loop": _loop, "add_reverb_gain": _add_reverb_gain,
          "self_loop": _self_loop, "mix_loop_biquad": _mix_loop_biquad,
          "config5": _config5}


def _pair(name):
    gj = dj.Graph(JIdSpace())
    gj = GRAPHS[name](gj) or gj
    return gj, dt.loads_graph(dj.dumps_graph(gj), ids=TIdSpace())


def _record_programs(monkeypatch):
    """(program, n_taps) of every cycle_segment call, in both packages."""
    seen = {"jax": [], "port": []}
    real_j, real_t = jcyc.cycle_segment, tcomp.cycle_segment

    def rec_j(exts, regs0, states, program, n_taps):
        seen["jax"].append((tuple(program), n_taps))
        return real_j(exts, regs0, states, program, n_taps)

    def rec_t(exts, regs0, states, program, n_taps):
        seen["port"].append((tuple(program), n_taps))
        return real_t(exts, regs0, states, program, n_taps)

    monkeypatch.setattr(jcyc, "cycle_segment", rec_j)
    monkeypatch.setattr(tcomp, "cycle_segment", rec_t)
    return seen


def _x(B, T, seed):
    return (np.random.default_rng(seed).standard_normal((B, 1, T)) * 0.3
            ).astype(np.float32)


def _render(pkg, g, x, pol, **kw):
    with pkg.policy(pol):
        cg = (pkg.compile_graph(g, device="cpu") if pkg is dt
              else pkg.compile_graph(g))
        return cg.render(x, batch_shape=(x.shape[0],), **kw)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_planners_match_jax(name):
    """Mega runs keep cyclic members out and linear runs inside a cycle
    are planned as the JAX package plans them."""
    gj, gt = _pair(name)
    act = jcomp._active_nodes(gj)
    nodes_j = {i: n for i, n in gj.nodes.items() if i in act}
    nodes_t = {i: n for i, n in gt.nodes.items() if i in act}
    edges = {i: set() for i in nodes_j}
    for l in gj.links:
        edges[l.src].add(l.dst)
    from dsp_stuff_tpu.compiler.scc import condensation_topo_order
    sccs = condensation_topo_order(sorted(nodes_j), edges)
    mega_j = jcomp._plan_mega_fusion(gj, nodes_j, sccs)
    mega_t = tcomp._plan_mega_fusion(gt, nodes_t, sccs)
    assert mega_t == mega_j
    members = frozenset(n for r in mega_j for n in r)
    assert tcomp._plan_linear_fusion(gt, nodes_t, sccs, members) == \
        jcomp._plan_linear_fusion(gj, nodes_j, sccs, members)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_cycle_programs_match_jax(name, monkeypatch):
    """Under fast both compilers hand the same block program to
    cycle_segment, one call per SCC."""
    gj, gt = _pair(name)
    seen = _record_programs(monkeypatch)
    x = _x(2, 512, 1)
    _render(dj, gj, x, "fast")
    _render(dt, gt, x, "fast")
    assert seen["port"] == seen["jax"]
    assert len(seen["port"]) == 1


def _program_inputs(program, n_e, n_r, B, T, seed):
    rng = np.random.default_rng(seed)
    exts = tuple((rng.standard_normal((B, T)) * 0.3).astype(np.float32)
                 for _ in range(n_e))
    regs = tuple((rng.standard_normal((B, 128)) * 0.1).astype(np.float32)
                 for _ in range(n_r))
    states = []
    for ins in program:
        if ins[0] == "cascade":
            from dsp_stuff_tpu_torch.ops.cascade import (_embed_dim,
                                                         composite_dim)
            n = _embed_dim(composite_dim(ins[1]))
            states.append((rng.standard_normal((B, n)) * 0.1
                           ).astype(np.float32))
        elif ins[0] == "comb":
            states.append((rng.standard_normal((B, ins[2])) * 0.1
                           ).astype(np.float32))
    return exts, regs, tuple(states)


def _program_of(name, monkeypatch):
    gj, gt = _pair(name)
    seen = _record_programs(monkeypatch)
    _render(dt, gt, _x(1, 256, 0), "fast")
    return seen["port"][0]


def _t(arrs):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrs)


def _compare_cycle(got, want):
    taps, regs, cinfos, hists = got
    assert len(taps) == len(want[0]) and len(regs) == len(want[1])
    for g, w in zip(taps, want[0]):
        assert _dbfs(g.numpy(), w) <= TAP_DB
    for g, w in zip(regs, want[1]):
        _close(g.numpy(), w)
    assert len(cinfos) == len(want[2]) and len(hists) == len(want[3])
    for gi, wi in zip(cinfos, want[2]):
        for g, w in zip(gi, wi):
            _close(g.numpy(), w)
    for g, w in zip(hists, want[3]):
        _close(g.numpy(), w)


@pytest.mark.parametrize("name", ["config5", "add_reverb_gain", "self_loop",
                                  "mix_loop_biquad"])
def test_interpret_matches_jax_interpret(name, monkeypatch):
    program, n_taps = _program_of(name, monkeypatch)
    n_c, n_b, n_r, n_t, n_e = tcyc._program_counts(program)
    assert (n_c, n_b, n_r, n_t, n_e) == jcyc._program_counts(program)
    exts, regs, states = _program_inputs(program, n_e, n_r, 3, 1536, 2)
    with jprec.policy("fast"):
        want = jax.tree.map(np.asarray, jax.jit(
            lambda e, r, s: jcyc.interpret(e, r, s, program, n_taps))(
                exts, regs, states))
    with tprec.policy("fast"):
        got = tcyc.interpret(_t(exts), _t(regs), _t(states), program, n_taps)
    _compare_cycle(got, want)


@pytest.mark.parametrize("T", [1024, 2688])
@pytest.mark.parametrize("name", ["config5", "mix_loop_biquad"])
def test_rebuild_from_jax_kernel_raw_outputs(name, T, monkeypatch):
    """The JAX interpret cycle kernel's raw outputs (per cascade the carry
    entering the last block and that block's input, per comb the ring,
    the final registers) rebuilt by the port equal the port's
    interpreter: the layout the CUDA kernel writes."""
    program, n_taps = _program_of(name, monkeypatch)
    _, _, n_r, _, n_e = tcyc._program_counts(program)
    exts, regs, states = _program_inputs(program, n_e, n_r, 8, T, 3)
    with jprec.policy("fast"):
        taps, regs_f, casc_raw, ring_raw = jax.tree.map(
            np.array, jpcy.cycle_kernel_call(exts, regs, states, program,
                                             n_taps, interpret=True))
    cinfos, hists = tcyc.rebuild(
        program, T, tuple(_t(c) for c in casc_raw), _t(ring_raw))
    with tprec.policy("fast"):
        ref = tcyc.interpret(_t(exts), _t(regs), _t(states), program, n_taps)
    _compare_cycle((_t(taps), _t(regs_f), cinfos, hists),
                   jax.tree.map(lambda t: t.numpy(), ref))


def test_kernel_path_batch_layout(monkeypatch):
    """The kernel path's glue: leading dimensions flatten into kernel rows,
    unbatched registers and states broadcast to them, and every output
    gets its dimensions back.  The JAX interpret kernel stands in for the
    CUDA kernel."""
    program, n_taps = _program_of("config5", monkeypatch)
    _, _, n_r, _, n_e = tcyc._program_counts(program)
    T = 512
    exts, regs, states = _program_inputs(program, n_e, n_r, 1, T, 4)
    batch = (2, 3)
    scale = np.linspace(0.5, 1.5, 6, dtype=np.float32).reshape(*batch, 1)
    exts_b = tuple(e[0] * scale for e in exts)

    def stand_in(ek, rk, sk, prog, nt):
        assert all(e.shape == (6, T) for e in ek)
        assert all(r.shape == (6, 128) for r in rk)
        with jprec.policy("fast"):
            out = jax.tree.map(np.array, jpcy.cycle_kernel_call(
                tuple(e.numpy() for e in ek), tuple(r.numpy() for r in rk),
                tuple(s.numpy() for s in sk), prog, nt, interpret=True))
        return jax.tree.map(torch.from_numpy, out)

    monkeypatch.setattr(tck, "cycle_kernel_call", stand_in)
    regs1 = tuple(torch.from_numpy(r[0]) for r in regs)
    states1 = tuple(torch.from_numpy(s[0]) for s in states)
    got = tcyc._kernel_cycle(_t(exts_b), regs1, states1, program, n_taps)
    with tprec.policy("fast"):
        want = tcyc.interpret(_t(exts_b), regs1, states1, program, n_taps)
    assert got[0][0].shape == (*batch, T)
    assert got[1][0].shape == (*batch, 128)
    _compare_cycle(got, jax.tree.map(lambda t: t.numpy(), want))


def test_dispatch_and_kernel_refusals():
    """CPU feeds take the interpreter and never the kernel; the kernel
    wrapper refuses CPU tensors without launching."""
    prog = (("join", (("ext", 0), ("reg", 0)), 0.5), ("setreg", 0),
            ("tap", 0))
    x = torch.zeros((2, 256))
    before = tck.LAUNCHES
    taps, regs, _, _ = tcyc.cycle_segment((x,), (torch.zeros(128),), (),
                                          prog, 1)
    assert taps[0].shape == (2, 256) and regs[0].shape == (2, 128)
    with pytest.raises(ValueError, match="CUDA"):
        tck.cycle_kernel_call((x,), (torch.zeros((2, 128)),), (), prog, 1)
    assert tck.LAUNCHES == before


_J0 = ("join", (("ext", 0),), 1.0)
# one past each limit the kernel once had: 32 instructions, 32 join terms,
# 8 registers, 8 taps
OVERSIZED = {
    "instructions": (_J0, *(("scale", 1.0),) * 32, ("setreg", 0),
                     ("tap", 0)),
    "join terms": (("join", (("ext", 0),) * 33, 1.0), ("tap", 0)),
    "registers": (("join", tuple(("reg", i) for i in range(9)), 1.0),
                  *(("setreg", i) for i in range(9)), ("tap", 0)),
    "taps": (_J0, *(("tap", i) for i in range(9))),
}


@pytest.mark.parametrize("what", sorted(OVERSIZED))
def test_kernel_refuses_oversized_program(what):
    """A program past the capacity the CUDA kernel once had runs in the
    interpreter, and the kernel wrapper now generates its block code (one
    statement group per instruction) and packs its tables (sized from it)
    and refuses only the CPU tensors, before anything launches."""
    prog = OVERSIZED[what]
    _, _, n_r, n_t, _ = tcyc._program_counts(prog)
    x = torch.zeros((2, 256))
    regs = tuple(torch.zeros((2, 128)) for _ in range(n_r))
    taps, _, _, _ = tcyc.cycle_segment((x,), regs, (), prog, n_t)
    assert len(taps) == n_t and taps[0].shape == (2, 256)
    counts = tck.plan(prog)
    assert counts[2:4] == (n_r, n_t)
    src = tck.source_for(prog, 227_000)
    assert [ln.strip()[3:] for ln in src.splitlines()
            if ln.strip().startswith("// ")] == [i[0] for i in prog]
    tables = {k: [] for k in tck._TABLES}
    tables.update(ext=[1], tap=[2] * n_t, reg0=[3] * n_r, reg_out=[4] * n_r)
    (sec, _, _, _, total), prog_bytes = tck.placement(prog, 1, 227_000)
    buf = tck.pack_program(n_r, tables, (sec, total))
    assert buf.size == prog_bytes
    hdr = np.frombuffer(buf[:tck.HEADER.itemsize].tobytes(), tck.HEADER)[0]
    assert (hdr["n_regs"], hdr["n_tap"], hdr["n_ext"]) == (n_r, n_t, 1)
    off = int(hdr["off_tap"])
    np.testing.assert_array_equal(np.frombuffer(
        buf[off:off + 8 * n_t].tobytes(), np.uint64), [2] * n_t)
    before = tck.LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        tck.cycle_kernel_call((x,), regs, (), prog, n_t)
    assert tck.LAUNCHES == before


@pytest.mark.parametrize("pol", ["fast", "parity"])
@pytest.mark.parametrize("name", ["loop", "add_reverb_gain", "self_loop",
                                  "mix_loop_biquad"])
def test_render_matches_jax(name, pol):
    gj, gt = _pair(name)
    x = _x(3, 2048, 5)
    yj, _, sj = _render(dj, gj, x, pol)
    yt, _, st = _render(dt, gt, x, pol)
    assert _dbfs(yt.numpy(), np.asarray(yj)) <= VS_JAX_DB
    sj = jax.tree.map(np.asarray, sj)
    assert sj.keys() == st.keys()
    for k in sj:
        for kk, w in (sj[k] or {}).items():
            g = st[k][kk]
            _close(g.numpy() if isinstance(g, torch.Tensor) else g, w)


@pytest.mark.parametrize("name", ["loop", "add_reverb_gain", "self_loop",
                                  "mix_loop_biquad"])
def test_parity_render_matches_oracle(name):
    from oracle.graph import evaluate
    gj, gt = _pair(name)
    x = _x(2, 2048, 6)
    y, _, _ = _render(dt, gt, x, "parity")
    cg = dt.compile_graph(gt, device="cpu")
    for i in range(2):
        outs = evaluate(gj, {cg.input_ids[0]: x[i, 0]}, 2048)
        for j, nid in enumerate(cg.output_ids):
            assert _dbfs(y[i, j].numpy(), outs[nid]) <= ORACLE_DB


@pytest.mark.parametrize("pol", ["fast", "parity"])
def test_chained_renders_equal_one(pol):
    _, gt = _pair("mix_loop_biquad")
    x = _x(2, 3072, 7)
    with dt.policy(pol):
        cg = dt.compile_graph(gt, device="cpu")
        full, _, _ = cg.render(x, batch_shape=(2,))
        a, _, st = cg.render(x[..., :1280], batch_shape=(2,))
        b, _, _ = cg.render(x[..., 1280:], state=st, batch_shape=(2,))
    assert _dbfs(torch.cat([a, b], dim=-1).numpy(), full.numpy()) <= \
        HANDOFF_DB


def test_scan_state_continues_fused():
    """A state from the per-node scan (parity, reverb ring with pos != 0)
    continues through the fused block program, and the other way round:
    the two branches share one state layout."""
    _, gt = _pair("loop")
    x = _x(2, 2048, 8)
    cg = dt.compile_graph(gt, device="cpu")
    with dt.policy("fast"):
        full, _, _ = cg.render(x, batch_shape=(2,))
    with dt.policy("parity"):
        _, _, st_scan = cg.render(x[..., :1024], batch_shape=(2,))
    assert any(v and v.get("pos", 0) for v in st_scan.values())
    with dt.policy("fast"):
        b, _, st_fused = cg.render(x[..., 1024:], state=st_scan,
                                   batch_shape=(2,))
    assert _dbfs(b.numpy(), full[..., 1024:].numpy()) <= -110.0
    assert st_fused.keys() == st_scan.keys()


def test_modulated_member_takes_the_scan(monkeypatch):
    """An LFO on a member's mod port refuses the program: no cycle_segment
    call, the per-node scan runs, and the render matches JAX's."""
    gj, _ = _pair("loop")
    lfo = gj.add("signal_gen", mode="Sine", frequency=1.0, amplitude=0.5)
    fbg = [n for n in gj.nodes.values() if n.cfg_name == "gain"][0]
    gj.connect(lfo, "out", fbg, "level")
    gt = dt.loads_graph(dj.dumps_graph(gj), ids=TIdSpace())
    seen = _record_programs(monkeypatch)
    x = _x(2, 1024, 9)
    yj, auxj, _ = _render(dj, gj, x, "fast")
    yt, auxt, _ = _render(dt, gt, x, "fast")
    assert seen == {"jax": [], "port": []}
    assert _dbfs(yt.numpy(), np.asarray(yj)) <= LFO_DB
    for k, v in auxj["__knobs__"].items():
        np.testing.assert_allclose(auxt["__knobs__"][k].numpy(),
                                   np.asarray(v), rtol=1e-6, atol=0)


def test_parity_takes_the_scan(monkeypatch):
    _, gt = _pair("config5")
    seen = _record_programs(monkeypatch)
    _render(dt, gt, _x(1, 512, 10), "parity")
    assert seen["port"] == []


def test_cycle_state_from_jax(monkeypatch):
    """A JAX render's state (cycle registers, reverb ring) carried across
    by convert.state_from_jax continues in the port as in JAX."""
    gj, gt = _pair("mix_loop_biquad")
    x = _x(2, 2048, 11)
    yj, _, _ = _render(dj, gj, x, "fast")
    _, _, sj = _render(dj, gj, x[..., :1024], "fast")
    st = convert.state_from_jax(jax.tree.map(np.asarray, sj), "cpu")
    assert any(k.startswith("__cycle__") for k in st)
    y2, _, _ = _render(dt, gt, x[..., 1024:], "fast", state=st)
    assert _dbfs(y2.numpy(), np.asarray(yj)[..., 1024:]) <= VS_JAX_DB


# -- the kernel's layout and schedule, modelled on the CPU -------------------
#
# The CUDA kernel keeps each comb's ring in a working ring of NR + 1 blocks
# (NR = ceil(D/128)), seeded from the raw ring and written back to it, and
# reads a cascade's constants through the packed layout of
# cycle_kernel.cycle_casc_consts.  The models below follow the kernel's
# index arithmetic (csrc/cycle_kernel.cu) in NumPy and are held against
# ``interpret``.

def _ring_model(hist, x, D, decay):
    """The kernel's comb on one block program join(ext 0) -> comb -> tap
    over the working ring: (taps [B, T], raw ring [B, NR*128])."""
    B, T = x.shape
    rl = -(-D // 128) * 128
    rl2 = rl + 128
    raw = np.zeros((B, rl), np.float32)
    raw[:, rl - D:] = hist                  # chain_kernel._seeded_ring
    ring = np.zeros((B, rl2), np.float32)
    for t in range(-rl, 0):                 # the seed: t at t + rl2
        ring[:, t + rl2] = raw[:, t + rl]
    c = np.arange(128)
    out = np.empty_like(x)
    for b in range(T // 128):
        wb = (b % (rl2 // 128)) * 128
        rd = wb + c - D
        rd = np.where(rd < 0, rd + rl2, rd)
        # no slot is both read and written within the block
        assert not set(rd) & set(wb + c)
        y = x[:, b * 128:(b + 1) * 128] + ring[:, rd] * np.float32(decay)
        ring[:, wb + c] = y
        out[:, b * 128:(b + 1) * 128] = y
    for t in range(T - rl, T):              # the write-back
        raw[:, t % rl if t >= 0 else t + rl] = \
            ring[:, t % rl2 if t >= 0 else t + rl2]
    return out, raw


@pytest.mark.parametrize("D,T", [(128, 1024), (200, 1280), (1000, 5248),
                                 (7200, 3 * 7424 + 640), (384, 256)])
def test_working_ring_model_matches_interpret(D, T):
    """The working ring of NR + 1 blocks, over several wraps (and over
    fewer blocks than the ring holds), gives interpret's taps and, written
    back, the raw ring that ``rebuild`` turns into interpret's history."""
    rng = np.random.default_rng(D)
    x = (rng.standard_normal((3, T)) * 0.3).astype(np.float32)
    hist = (rng.standard_normal((3, D)) * 0.3).astype(np.float32)
    prog = (("join", (("ext", 0),), 1.0), ("comb", 0.45, D, 0), ("tap", 0))
    with tprec.policy("fast"):
        taps, _, _, hists = tcyc.interpret((torch.from_numpy(x),), (),
                                           (torch.from_numpy(hist),), prog, 1)
    got, raw = _ring_model(hist, x, D, 0.45)
    np.testing.assert_array_equal(got, taps[0].numpy())
    _, rebuilt = tcyc.rebuild(prog, T, (), (torch.from_numpy(
        raw).view(3, -1, 128),))
    np.testing.assert_array_equal(rebuilt[0].numpy(), hists[0].numpy())


def test_packed_records_pin_the_kernel_layout():
    """The records' sizes and field offsets as csrc/cycle_kernel.cu lays
    them out (CyHeader, CyCasc, CyComb; cycle_kernel_abi packs the three
    sizes), and the constants' layout (cycle_kernel_shape)."""
    assert (tck.HEADER.itemsize, tck.CASC.itemsize, tck.COMB.itemsize) == \
        (96, 48, 32)
    offs = {n: tck.HEADER.fields[n][1] for n in tck.HEADER.names}
    assert offs["off_ext"] == 0 and offs["off_comb"] == 40
    assert offs["n_regs"] == 48 and offs["sm_feeds"] == 76
    assert offs["sm_xs"] == 80
    assert {n: tck.CASC.fields[n][1] for n in tck.CASC.names} == {
        "consts": 0, "s0": 8, "carry_out": 16, "xlast_out": 24,
        "sm_consts": 32, "sm_cbuf": 36, "n": 40, "pad": 44}
    assert {n: tck.COMB.fields[n][1] for n in tck.COMB.names} == {
        "raw": 0, "scratch": 8, "sm_ring": 16, "rl": 20, "rl2": 24,
        "pad": 28}
    assert (tck.NCONST, tck.FB, tck.RS, tck.WS) == (2816, 8, 168, 132)
    assert tck.NCONST % 4 == 0 and tck.OFF_W % 4 == 0 and tck.OFF_E % 4 == 0


def _model_consts(sections):
    """(Ltg, W, Ecb, ACt) read back from cycle_casc_consts through the
    kernel's indexing: column c of the product sums, over the steps m <=
    c >> 2, X[4m + e] * R[c & 3, 128 + (c & 3) - c + 4m + e]; lane j of the
    carry reads W^T row j."""
    k = tck.cycle_casc_consts(sections)
    R = k[tck.OFF_R:tck.OFF_W].reshape(4, tck.RS)
    L = np.zeros((128, 128), np.float32)
    for c in range(128):
        q = c & 3
        for m in range((c >> 2) + 1):
            for e in range(4):
                L[4 * m + e, c] = R[q, 128 + q - c + 4 * m + e]
    Wt = k[tck.OFF_W:tck.OFF_E].reshape(8, tck.WS)
    return (L, Wt[:, :128].T, k[tck.OFF_E:tck.OFF_A].reshape(8, 128),
            k[tck.OFF_A:].reshape(8, 8))


@pytest.mark.parametrize("sections", [
    (("lp", 0.4),), (("gain", 0.45), ("lp", 0.4)),
    (("bq", (-0.5, 0.1, 0.3, 0.2, 0.1)), ("hp", 0.2)),
    (("lp", 0.2), ("hp", 0.1), ("gain", 1.3), ("lp", 0.3))])
def test_cascade_constants_layout_reads_back(sections):
    """The reversed, phase-shifted copies of the Toeplitz row give Ltg
    exactly (zeros below the diagonal, the float4 reads aligned), W^T and
    Ecb and ACt give the chain kernel's constants."""
    from dsp_stuff_tpu_torch.ops.chain_kernel import _casc_consts
    Ltg, Wp, Ecb, ACt, _ = _casc_consts(sections)
    L, W, E, A = _model_consts(sections)
    np.testing.assert_array_equal(L, Ltg)
    np.testing.assert_array_equal(W, Wp)
    np.testing.assert_array_equal(E, Ecb)
    np.testing.assert_array_equal(A, ACt)
    k = tck.cycle_casc_consts(sections)
    R = k[tck.OFF_R:tck.OFF_W].reshape(4, tck.RS)
    for c in range(128):
        q = c & 3                           # 16-byte aligned R reads
        assert (tck.OFF_R + q * tck.RS + 128 + q - c) % 4 == 0
        # the warp's steps past this lane's diagonal read zeros
        last = 128 + q - c + 4 * 8 * ((c >> 5) + 1) - 1
        assert last < tck.RS and not R[q, 128 + q - c + c + 1:last + 1].any()


def _block_of_source(src):
    """The generated cy_block (ops/cycle_kernel.program_source) as a
    Python function of (helpers, r): its statements translated one for
    one, the literals read back as float32, the helpers' template
    arguments passed first."""
    body = []
    for line in src.splitlines():
        st = line.strip()
        if not st or st.startswith(("#", "//", "__device__", "{", "}",
                                    "float ", "CY_USE")):
            continue
        # a held cascade (the constants in registers) computes the same
        st = re.sub(r"cy_cascade_held<(\d+)>\((.*), hold\)",
                    r"cy_cascade<\1, true>(\2)", st)
        st = re.sub(r"(-?0x[0-9a-f.]+p[+-]\d+)f",
                    lambda m: f"F({float.fromhex(m.group(1))!r})", st)
        st = re.sub(r"__int_as_float\((-?\d+)\)", r"I(\1)", st)
        st = re.sub(r"(cy_\w+)<([^>]*)>\(", lambda m: "{}({}, ".format(
            m.group(1), m.group(2).replace("true", "True").replace(
                "false", "False")), st)
        body.append(st.rstrip(";"))
    code = "def cy_block(x, r):\n    f = F(0.0)\n" + "".join(
        f"    {b}\n" for b in body)
    env = {"F": np.float32,
           "I": lambda i: np.array(i, np.int32).view(np.float32)[()]}
    exec(code, env)
    return env["cy_block"]


def _kernel_model(exts, regs0, states, program, budget=227_000):
    """The kernel's block walk in NumPy: the generated block code (run
    through _block_of_source) over helpers that follow the kernel's
    layouts: the constants through _model_consts, the double-buffered
    carry computed from each block's input for the next block, the
    working rings.  Returns what cycle_kernel_call returns (taps, regs,
    per cascade (carry entering the last block, its input), raw rings)."""
    B, T = exts[0].shape
    K = T // 128
    block = _block_of_source(tck.source_for(program, budget))
    regs = [np.array(r) for r in regs0] or [np.zeros((B, 128), np.float32)]
    si, casc, combs = 0, [], []
    for ins in program:
        if ins[0] == "cascade":
            s0 = np.zeros((B, 8), np.float32)
            s0[:, :states[si].shape[1]] = states[si]
            casc.append([_model_consts(ins[1]), s0, None, None])
        elif ins[0] == "comb":
            D = ins[2]
            rl = -(-D // 128) * 128
            ring = np.zeros((B, rl + 128), np.float32)
            ring[:, rl + 128 - D:] = states[si]
            combs.append(ring)
        si += ins[0] in ("cascade", "comb")
    n_t = tcyc._program_counts(program)[3]
    taps = [np.empty((B, T), np.float32) for _ in range(n_t)]
    c = np.arange(128)

    class X:
        b = 0

    def cy_feed(x, e):
        return exts[e][:, x.b * 128:(x.b + 1) * 128]

    def cy_tap(x, t, v):
        taps[t][:, x.b * 128:(x.b + 1) * 128] = v

    def cy_ew(op, x, v, *p):
        from dsp_stuff_tpu_torch.ops.chain_kernel import EW_CODES
        kind = EW_CODES[op]
        n = {"overdrive": 3, "chebyshev": 2}.get(kind, 1)
        return tcyc.apply_ew(kind, torch.from_numpy(np.ascontiguousarray(
            v)), tuple(float(q) for q in p[:n])).numpy()

    def cy_comb(D, sm, x, k, v, decay):
        ring = combs[k]
        rl2 = ring.shape[1]
        wb = (x.b % (rl2 // 128)) * 128
        rd = (wb + c - D) % rl2
        y = (v + ring[:, rd] * decay).astype(np.float32)
        ring[:, wb + c] = y
        return y

    def cy_cascade(N, sm, x, k, v):
        cs = casc[k]
        (L, W, E, A), cur = cs[0], cs[1]
        if x.b == K - 1:
            cs[2], cs[3] = cur.copy(), v.copy()
        cs[1] = (v @ W + cur @ A).astype(np.float32)
        return (v @ L + cur @ E).astype(np.float32)

    helpers = {"cy_feed": cy_feed, "cy_tap": cy_tap, "cy_ew": cy_ew,
               "cy_comb": cy_comb, "cy_cascade": cy_cascade}
    block.__globals__.update(helpers)
    x = X()
    for b in range(K):
        x.b = b
        block(x, regs)
    raws = []
    for ring in combs:
        rl2 = ring.shape[1]
        rl = rl2 - 128
        raw = np.empty((B, rl), np.float32)
        for t in range(T - rl, T):
            raw[:, t % rl] = ring[:, t % rl2]
        raws.append(raw.reshape(B, -1, 128))
    return (taps, regs[:len(regs0)], [(cs[2], cs[3]) for cs in casc], raws)


@pytest.mark.parametrize("name,T", [("config5", 3 * 7424 + 640),
                                    ("mix_loop_biquad", 2688),
                                    ("add_reverb_gain", 1024),
                                    ("loop", 1536), ("self_loop", 512)])
def test_kernel_schedule_model_matches_interpret(name, T, monkeypatch):
    """The kernel's generated block code and layouts, run block by block
    and rebuilt by ``rebuild`` as the kernel path does, equal
    ``interpret`` (config5's ring wraps three times with a ragged end)."""
    program, n_taps = _program_of(name, monkeypatch)
    _, _, n_r, _, n_e = tcyc._program_counts(program)
    exts, regs, states = _program_inputs(program, n_e, n_r, 2, T, 12)
    taps, regs_f, casc_raw, ring_raw = _kernel_model(exts, regs, states,
                                                     program)
    cinfos, hists = tcyc.rebuild(program, T, tuple(_t(c) for c in casc_raw),
                                 _t(ring_raw))
    with tprec.policy("fast"):
        ref = tcyc.interpret(_t(exts), _t(regs), _t(states), program, n_taps)
    _compare_cycle((_t(taps), _t(regs_f), cinfos, hists),
                   jax.tree.map(lambda t: t.numpy(), ref))


@pytest.mark.parametrize("budget,want", [
    (227_000, "all on chip"), (30_000, "ring in device memory"),
    (15_000, "constants and ring in device memory")])
def test_smem_plan_places_what_fits(budget, want):
    """config5's plan: its constants and ring stay in shared memory while
    they fit, in program order; what does not fit goes to device memory
    (-1); the fixed sections never exceed the budget."""
    sec, cbuf, consts, rings, total = tck.smem_plan(1024, 1, 1, (7424,),
                                                    budget)
    assert sec == {"feeds": 1024, "xs": 1024 + 8 * 512}
    assert cbuf == [sec["xs"] + 1024]
    placed = (consts[0] >= 0, rings[0] >= 0)
    assert placed == {"all on chip": (True, True),
                      "ring in device memory": (True, False),
                      "constants and ring in device memory": (False, False)
                      }[want]
    assert total <= budget
    with pytest.raises(ValueError, match="shared memory"):
        tck.smem_plan(1024, 1, 1, (7424,), 2000)
