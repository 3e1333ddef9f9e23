"""The feedback cycle's backward in the port: ``interpret_adjoint``
(ops/cycle_segment.py), the plain version of the reverse cycle kernel
(csrc/cycle_reverse_kernel.cu, generated per block program by
ops/cycle_reverse_kernel.py), the forward's record build that gives it
the shapers' inputs, and ``CycleSegment`` along the card's route.

The CUDA kernels run only on a GPU (chip_smoke.py holds the reverse
kernel against ``interpret_adjoint`` there); here the generated block
adjoint, translated to Python line by line, runs over NumPy helpers that
follow the kernel's layouts (the forward's packed constants read
transposed, the double-buffered carry adjoints, the rings of future
adjoints) behind the kernel path's glue.

Bounds (every gradient array max-normalized, max |got - want| / max
|want|):
  interpret_adjoint vs jax.grad of the JAX cycle_segment   <= 1e-3
      (PERF.md section 2's gradient bound)
  interpret_adjoint vs autograd through the port's interpret  <= 1e-5
  the kernel's model vs interpret_adjoint                  <= 1e-5
      (the same rules; the cascade's and the Fuzz shaper's sums in
      another order)
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dsp_stuff_tpu as dj
from chip_smoke import (big_ring_cycle_program, cycle_programs_of,
                        oversized_cycle_program, shaper_cycle_program)
from dsp_stuff_tpu.models import presets as jpresets
from dsp_stuff_tpu.ops import cycle_segment as jcyc
from dsp_stuff_tpu.train import fit as jfit
from dsp_stuff_tpu.utils import precision as jprec
import dsp_stuff_tpu_torch as dt
import test_torch_cycle_reverse_tiles as tiles
import test_torch_fuzz_gen as gen
from dsp_stuff_tpu_torch.compiler import compile as tcomp
from dsp_stuff_tpu_torch.ids import IdSpace as TIdSpace
from dsp_stuff_tpu_torch.ops import cycle_kernel as tck
from dsp_stuff_tpu_torch.ops import cycle_reverse_kernel as tcr
from dsp_stuff_tpu_torch.ops import cycle_segment as tcyc
from dsp_stuff_tpu_torch.ops.cascade import _embed_dim, composite_dim
from dsp_stuff_tpu_torch.ops.chain_kernel import EW_CODES
from dsp_stuff_tpu_torch.train import fit as tfit
from dsp_stuff_tpu_torch.utils import precision as tprec

JAX_RTOL = 1e-3
AUTOGRAD_RTOL = 1e-5
MODEL_RTOL = 1e-5

def _programs():
    g5 = dt.loads_graph(dj.dumps_graph(jpresets.config5_feedback_16node()[0]),
                        ids=TIdSpace())
    out = {"config5": cycle_programs_of(g5)[0],
           "mega_cycle_2": cycle_programs_of(
               gen._random_mega_cycle_graph(2)[0])[0],
           "mega_cycle_10": cycle_programs_of(
               gen._random_mega_cycle_graph(10)[0])[0]}
    out.update({kind: shaper_cycle_program(kind)[0] for kind in EW_CODES})
    # a bypassed shaper, and chebyshev with its negative branch bypassed
    out["bypass"] = shaper_cycle_program("distort:Tanh", (0.0005,))[0]
    out["chebyshev half"] = shaper_cycle_program("chebyshev",
                                                 (2.0, 0.0005))[0]
    return out


PROGRAMS = _programs()
#: the per-kind programs, the bypasses, and the graphs' programs
NAMES = sorted(PROGRAMS)


@pytest.fixture(autouse=True)
def _torch_env():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    prev = tprec.get_policy()
    tprec.set_policy("fast")
    yield
    tprec.set_policy(prev)
    torch.set_num_threads(threads)


def _err(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _held(name, pairs, rtol):
    worst = max(_err(g, w) for g, w in pairs)
    print(f"{name}: worst max-normalized error {worst:.2e}")
    assert worst <= rtol, (name, worst)
    return worst


def _n_taps(program):
    return tcyc._program_counts(program)[3]


def _inputs(program, B, T, seed):
    """NumPy feeds [B, T], registers [B, 128] and states (a cascade's at
    its embedded width, a comb's history [B, D])."""
    rng = np.random.default_rng(seed)
    _, _, n_r, _, n_e = tcyc._program_counts(program)

    def sig(*shape, scale):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    states = []
    for ins in program:
        if ins[0] == "cascade":
            states.append(sig(B, _embed_dim(composite_dim(ins[1])),
                              scale=0.1))
        elif ins[0] == "comb":
            states.append(sig(B, ins[2], scale=0.1))
    return (tuple(sig(B, T, scale=0.3) for _ in range(n_e)),
            tuple(sig(B, 128, scale=0.1) for _ in range(n_r)), tuple(states))


def _weights(flat, seed, which, n_taps):
    """Seeded cotangents of the flat outputs; None off the taps when
    ``which`` is "taps"."""
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(tuple(o.shape)) * 0.5).astype(np.float32)
            if which == "all" or i < n_taps else None
            for i, o in enumerate(flat)]


def _t(arrs):
    return tuple(torch.from_numpy(np.array(a, np.float32)) for a in arrs)


def _shapes(*groups):
    return tuple(tuple(t.shape for t in g) for g in groups)


def _forward(program, ins):
    """interpret's flat outputs and recorded shaper inputs."""
    n_t = _n_taps(program)
    if tck.has_shaper(program):
        outs, recs = tcyc.interpret(*ins, program, n_t, record=True)
    else:
        outs, recs = tcyc.interpret(*ins, program, n_t), ()
    return tcyc.flatten_outputs(outs), recs


def _adjoint(program, ins, ws):
    flat, recs = _forward(program, ins)
    cts = tuple(None if w is None else torch.from_numpy(w) for w in ws)
    return tcyc.interpret_adjoint(cts, _shapes(*ins), program,
                                  _n_taps(program), recs)


# -- interpret_adjoint against jax.grad and autograd --------------------------

@pytest.mark.parametrize("which", ["all", "taps"])
@pytest.mark.parametrize("name", NAMES)
def test_adjoint_matches_jax_grad(name, which):
    """interpret_adjoint against jax.grad of the JAX cycle_segment (its
    custom_vjp: the vjp of its lax.scan interpret), with cotangents on
    every output or on the taps alone."""
    program = PROGRAMS[name]
    n_t = _n_taps(program)
    exts, regs, states = _inputs(program, 2, 512, 31)
    ins = (_t(exts), _t(regs), _t(states))
    flat, _ = _forward(program, ins)
    ws = _weights(flat, 32, which, n_t)
    idx = [i for i, w in enumerate(ws) if w is not None]

    def loss(e, r, s):
        out = tcyc.flatten_outputs(jcyc.cycle_segment(e, r, s, program, n_t))
        return sum(jnp.sum(out[i] * ws[i]) for i in idx)

    with jprec.policy("fast"):
        want = jax.tree.map(np.asarray, jax.jit(jax.grad(
            loss, argnums=(0, 1, 2)))(exts, regs, states))
    got = _adjoint(program, ins, ws)
    pairs = [(g.numpy(), w) for gg, wg in zip(got, want)
             for g, w in zip(gg, wg) if np.abs(w).max() > 0]
    assert pairs
    _held(f"{name}, cotangents on {which}, vs jax.grad", pairs, JAX_RTOL)


@pytest.mark.parametrize("which", ["all", "taps"])
@pytest.mark.parametrize("name", NAMES)
def test_adjoint_matches_autograd(name, which):
    """interpret_adjoint against autograd through the port's interpret on
    the same inputs (T = 640: config5's comb history longer than the
    render)."""
    program = PROGRAMS[name]
    exts, regs, states = _inputs(program, 3, 640, 33)
    ins = tuple(tuple(torch.tensor(a, requires_grad=True) for a in g)
                for g in (exts, regs, states))
    flat, _ = _forward(program, ins)
    ws = _weights(flat, 34, which, _n_taps(program))
    loss = sum((o * torch.from_numpy(w)).sum()
               for o, w in zip(flat, ws) if w is not None)
    leaves = [t for g in ins for t in g]
    want = torch.autograd.grad(loss, leaves, allow_unused=True)
    got = _adjoint(program, tuple(tuple(t.detach() for t in g) for g in ins),
                   ws)
    pairs = [(g.numpy(), (torch.zeros_like(g) if w is None else w).numpy())
             for g, w in zip((g for gg in got for g in gg), want)]
    assert all(g.shape == t.shape for (g, _), t in zip(pairs, leaves))
    _held(f"{name}, cotangents on {which}, vs autograd", pairs,
          AUTOGRAD_RTOL)


def test_record_returns_each_shapers_input():
    """interpret(record=True): the same outputs, and per shaper its input
    over the render (the flow the shaper was applied to, block by block)."""
    program = PROGRAMS["mega_cycle_10"]
    ins = tuple(_t(g) for g in _inputs(program, 2, 512, 35))
    outs, recs = tcyc.interpret(*ins, program, _n_taps(program), record=True)
    plain = tcyc.interpret(*ins, program, _n_taps(program))
    for a, b in zip(tcyc.flatten_outputs(outs), tcyc.flatten_outputs(plain)):
        assert torch.equal(a, b)
    assert len(recs) == sum(1 for i in program if i[0] == "ew") >= 1
    assert all(r.shape == (2, 512) for r in recs)
    # the first shaper's output, re-derived from its record, is what the
    # program carries on: the record is that shaper's input
    k = next(i for i, ins_ in enumerate(program) if ins_[0] == "ew")
    y = tcyc.apply_ew(program[k][1], recs[0], program[k][2])
    assert torch.isfinite(y).all() and not torch.equal(y, recs[0])


# -- CycleSegment along the card's route --------------------------------------

@pytest.mark.parametrize("name", ["config5", "mega_cycle_10", "distort:Fuzz",
                                  "overdrive"])
def test_cycle_segment_card_route(name):
    """CycleSegment with interpret (its record form for a program with a
    shaper) and interpret_adjoint standing in for the kernels, on a batch
    of (2, 2) streams with unbatched registers and states (their
    gradients summed over the batch): one forward under no_grad, the
    gradients of autograd through interpret."""
    program = PROGRAMS[name]
    n_t = _n_taps(program)
    exts, regs, states = _inputs(program, 4, 384, 36)
    exts = tuple(e.reshape(2, 2, -1) for e in exts)
    regs = tuple(r[0] for r in regs)
    states = tuple(s[0] for s in states)
    calls = []

    def forward(e, r, s, prog, nt, **kw):
        calls.append((torch.is_grad_enabled(), kw))
        return tcyc.interpret(e, r, s, prog, nt, **kw)

    def leaves():
        return tuple(tuple(torch.tensor(a, requires_grad=True) for a in g)
                     for g in (exts, regs, states))

    ws = None
    grads = []
    for route in ("card", "autograd"):
        ins = leaves()
        out = (tcyc.run_cycle(forward, tcyc.interpret_adjoint, *ins, program,
                              n_t) if route == "card"
               else tcyc.interpret(*ins, program, n_t))
        flat = tcyc.flatten_outputs(out)
        ws = ws or _weights(flat, 37, "all", n_t)
        sum((o * torch.from_numpy(w)).sum() for o, w in zip(flat, ws)
            ).backward()
        grads.append([t.grad for g in ins for t in g])
    assert calls == [(False, {"record": True} if tck.has_shaper(program)
                      else {})]
    grads[1] = [torch.zeros_like(g) if w is None else w
                for g, w in zip(*grads)]          # an operand never read
    for g, w in zip(*grads):
        assert g.shape == w.shape
    _held(f"{name} along the card's route", [
        (g.numpy(), w.numpy()) for g, w in zip(*grads)], AUTOGRAD_RTOL)


def test_cycle_segment_card_route_partial_cotangents():
    """Only a cascade's info and a register carry cotangents (the taps and
    histories none): the missing ones are zero seeds, and operands that
    need no gradient get none.  One block, so that the info's seeds reach
    the cascade's initial state undecayed."""
    program = PROGRAMS["mega_cycle_2"]
    n_t = _n_taps(program)
    exts, regs, states = _inputs(program, 2, 128, 38)
    outs = []
    for route in ("card", "autograd"):
        e = tuple(torch.tensor(a, requires_grad=True) for a in exts)
        r = _t(regs)
        s = tuple(torch.tensor(a, requires_grad=True) for a in states)
        out = (tcyc.run_cycle(tcyc.interpret, tcyc.interpret_adjoint, e, r,
                              s, program, n_t) if route == "card"
               else tcyc.interpret(e, r, s, program, n_t))
        taps, regs_f, cinfos, hists = out
        (regs_f[0].sum() + cinfos[0][0].sum() * 3.0
         + cinfos[0][2].sum()).backward()
        assert all(t.grad is None for t in r)
        outs.append([torch.zeros_like(t) if t.grad is None else t.grad
                     for t in (*e, *s)])          # an operand never read
    _held("partial cotangents", [(g.numpy(), w.numpy())
                                 for g, w in zip(*outs)], AUTOGRAD_RTOL)


def test_kernel_path_record_layout(monkeypatch):
    """The kernel path's record form: rows in, the recorded inputs [n_ew,
    B, T] back at the batch shape beside the outputs.  The JAX Pallas
    kernel in interpret mode stands in for the raw outputs, interpret's
    record for the recorded inputs."""
    from dsp_stuff_tpu.ops import pallas_cycle as jpcy
    program = PROGRAMS["mega_cycle_10"]
    n_t = _n_taps(program)
    exts, regs, states = _inputs(program, 6, 512, 42)
    exts = tuple(e.reshape(2, 3, 512) for e in exts)
    regs1, states1 = _t(r[0] for r in regs), _t(s[0] for s in states)

    def stand_in(ek, rk, sk, prog, nt, record=False):
        assert record and all(e.shape == (6, 512) for e in ek)
        with jprec.policy("fast"):
            raw = jax.tree.map(torch.from_numpy, jax.tree.map(
                np.array, jpcy.cycle_kernel_call(
                    tuple(e.numpy() for e in ek),
                    tuple(r.numpy() for r in rk),
                    tuple(s.numpy() for s in sk), prog, nt, interpret=True)))
        recs = tcyc.interpret(ek, rk, sk, prog, nt, record=True)[1]
        return raw, tuple(torch.stack(recs).unbind(0))

    monkeypatch.setattr(tck, "cycle_kernel_call", stand_in)
    got, recs = tcyc._kernel_cycle(_t(exts), regs1, states1, program, n_t,
                                   record=True)
    want, want_recs = tcyc.interpret(_t(exts), regs1, states1, program, n_t,
                                     record=True)
    assert [r.shape for r in recs] == [(2, 3, 512)] * len(want_recs)
    for a, b in zip(recs, want_recs):
        assert torch.equal(a, b)
    _held("record path outputs", [
        (a.numpy(), b.numpy()) for a, b in zip(tcyc.flatten_outputs(got),
                                               tcyc.flatten_outputs(want))],
          AUTOGRAD_RTOL)


def _card_dispatch(monkeypatch):
    """The compiler's cycle_segment calls routed as the card routes them,
    the plain versions standing in for the two kernels; returns the
    forward calls (with grad mode, off inside the Function)."""
    calls = []

    def forward(e, r, s, program, n_taps, **kw):
        calls.append(torch.is_grad_enabled())
        return tcyc.interpret(e, r, s, program, n_taps, **kw)

    monkeypatch.setattr(tcomp, "cycle_segment", lambda e, r, s, p, n: (
        tcyc.run_cycle(forward, tcyc.interpret_adjoint, tuple(e), tuple(r),
                       tuple(s), tuple(p), n)))
    return calls


@pytest.mark.parametrize("T", [1024, 1280])
def test_config5_input_gradient_through_compile_graph(T, monkeypatch):
    """config5's loss gradient with respect to its input through
    compile_graph, the cycle taking CycleSegment with interpret_adjoint
    backward, against jax.grad of the JAX package's make_loss_fn."""
    gj, meta = jpresets.config5_feedback_16node()
    gt = dt.loads_graph(dj.dumps_graph(gj), ids=TIdSpace())
    inp = str(meta["input"])
    rng = np.random.default_rng(39)
    x = (rng.standard_normal((2, T)) * 0.25).astype(np.float32)
    target = (rng.standard_normal((2, 1, T)) * 0.1).astype(np.float32)
    with jprec.policy("fast"):
        cgj = dj.compile_graph(gj)
        gx = jax.jit(jax.grad(jfit.make_loss_fn(cgj), argnums=2))(
            {}, cgj.init_state(), {inp: x}, target)[inp]
    calls = _card_dispatch(monkeypatch)
    cgt = dt.compile_graph(gt, device="cpu")
    xt = torch.tensor(x, requires_grad=True)
    tfit.make_loss_fn(cgt)({}, cgt.init_state(), {inp: xt},
                           torch.from_numpy(target)).backward()
    assert calls == [False]
    _held(f"config5 input gradient, T={T}", [(xt.grad.numpy(), gx)],
          JAX_RTOL)


# -- the generated sources ----------------------------------------------------

def _instruction_lines(src):
    """(index, op) of each instruction line of a generated block adjoint."""
    return [(int(m.group(1)), m.group(2)) for m in
            (re.search(r"//\s+(\d+)\s+(\w+)$", ln) for ln in src.splitlines())
            if m]


@pytest.mark.parametrize("name", ["config5", "mega_cycle_10", "chebyshev",
                                  "distort:Fuzz", "big ring", "oversized"])
def test_reverse_source_one_statement_per_instruction(name):
    """The block adjoint has one line per instruction, in reverse order,
    and the same text every time it is generated (the build is keyed by
    it); a cascade's constants and a ring placed out of shared memory are
    named so."""
    program = {"big ring": big_ring_cycle_program()[0],
               "oversized": oversized_cycle_program()[0]}.get(
                   name, PROGRAMS.get(name))
    src = tcr.source_for(program, 227_000)
    assert src == tcr.source_for(tuple(program), 227_000)
    assert _instruction_lines(src) == [
        (i, program[i][0]) for i in reversed(range(len(program)))]
    if name == "big ring":
        assert "cr_comb<64000, false>" in src and "cr_comb<7200, true>" in src
    if name == "config5":       # its constants and ring in device memory
        small = tcr.source_for(program, 12_000)
        assert "#define CR_HOLD_N 2\n#define CR_HOLD_SM false\n" in small
        assert "cr_cascade_held<2>(x, 0, f, hold)" in small
        assert "cr_comb<7200, false>" in small
    if name == "mega_cycle_10":     # two cascades: loaded every block
        assert "CR_HOLD" not in src
        assert "cr_cascade<2, true>(x, 1, f)" in src


@pytest.mark.parametrize("name, budget, ctas", [
    ("config5", 227_000, 4), ("config5", 12_000, 4),
    ("mega_cycle_10", 227_000, 4), ("oversized", 227_000, 1),
    ("oversized", 100_000, 2)])
def test_reverse_launch_bound_follows_shared_memory(name, budget, ctas):
    """CR_CTAS, the launch bound's CTAs an SM, is what an SM's shared
    memory holds at the program's plan, at most four: the 56-instruction
    program's plan fills an SM (its build keeps the registers its nine
    cascades need), config5's and mega_cycle_10's leave room for four."""
    program = {"oversized": oversized_cycle_program()[0]}.get(
        name, PROGRAMS.get(name))
    (_, _, _, _, total), _ = tcr.placement(program, budget)
    assert tcr.ctas_an_sm(total) == ctas
    assert tcr.SM_SMEM // (total + tcr.CTA_SMEM) >= ctas
    src = tcr.source_for(program, budget)
    assert f"\n#define CR_CTAS {ctas}\n" in src
    assert src.count("#define CR_CTAS") == 1


@pytest.mark.parametrize("what", ["unknown op", "bad term", "comb delay",
                                  "cascade order", "shaper"])
def test_reverse_source_refuses_what_plan_refuses(what):
    """The reverse generator raises on every program the forward's plan
    refuses."""
    j0 = ("join", (("ext", 0),), 1.0)
    program = {
        "unknown op": (j0, ("wobble", 1.0), ("tap", 0)),
        "bad term": (("join", (("reg", 3),), 1.0), ("setreg", 0),
                     ("tap", 0)),
        "comb delay": (j0, ("comb", 0.5, 64, 0), ("tap", 0)),
        "cascade order": (j0, ("cascade", (("lp", 0.3),), 1), ("tap", 0)),
        "shaper": (j0, ("ew", "distort:Wobble", (1.0,)), ("tap", 0)),
    }[what]
    with pytest.raises(ValueError, match="cycle kernel"):
        tcr.source_for(program, 227_000)
    with pytest.raises(ValueError, match="cycle kernel"):
        tcr.reverse_source(program, (True,), (True,))


@pytest.mark.parametrize("name", ["mega_cycle_10", "oversized"])
def test_record_source_adds_only_record_lines(name):
    """The record build's generated text is the render build's with one
    cy_record(x, k, f) line before the k-th shaper; without ``record``
    the text does not name it (the render build is unchanged)."""
    program = (oversized_cycle_program()[0] if name == "oversized"
               else PROGRAMS[name])
    render = tck.source_for(program, 227_000)
    rec = tck.source_for(program, 227_000, record=True)
    assert "cy_record" not in render
    lines = rec.splitlines()
    idx = [i for i, ln in enumerate(lines) if "cy_record" in ln]
    n_ew = sum(1 for i in program if i[0] == "ew")
    assert [lines[i].strip() for i in idx] == [
        f"cy_record(x, {k}, f);" for k in range(n_ew)]
    assert all(lines[i - 1].strip() == "// ew"
               and lines[i + 1].strip().startswith("f = cy_ew<")
               for i in idx)
    assert "\n".join(ln for ln in lines if "cy_record" not in ln) + "\n" == \
        render
    with pytest.raises(ValueError, match="no shaper"):
        tck.cycle_kernel_call((torch.zeros(2, 256),), (), (),
                              (("join", (("ext", 0),), 1.0), ("tap", 0)), 1,
                              record=True)


def test_packed_records_pin_the_reverse_layout():
    """The records' sizes and field offsets as csrc/cycle_reverse_kernel.cu
    lays them out (CrHeader, CrCasc, CrComb), and a packed table."""
    assert (tcr.HEADER.itemsize, tcr.CASC.itemsize, tcr.COMB.itemsize) == \
        (96, 48, 40)
    assert {n: tcr.CASC.fields[n][1] for n in tcr.CASC.names} == {
        "consts": 0, "seed_x": 8, "seed_c": 16, "g_s0": 24, "sm_consts": 32,
        "sm_cbuf": 36, "n": 40, "pad": 44}
    assert {n: tcr.COMB.fields[n][1] for n in tcr.COMB.names} == {
        "ct_hist": 0, "g_hist": 8, "scratch": 16, "sm_ring": 24, "d": 28,
        "rl2": 32, "decay": 36}
    offs = {n: tcr.HEADER.fields[n][1] for n in tcr.HEADER.names}
    assert offs["n_regs"] == 48 and offs["sm_src"] == 76
    assert offs["sm_gy"] == 80
    program = PROGRAMS["config5"]
    (sec, cbuf, consts, rings, total), sizes = tcr.placement(program,
                                                             227_000)
    tables = {k: [7] * n for k, n in sizes.items()
              if k not in ("casc", "comb")}
    tables["casc"] = [(1, 2, 3, 4, consts[0], cbuf[0], 4)]
    tables["comb"] = [(5, 6, 0, rings[0], 7200, 7424, 0.5)]
    buf = tcr.pack_tables(sizes["greg_in"], tables, sec, total)
    hdr = np.frombuffer(buf[:96].tobytes(), tcr.HEADER)[0]
    assert hdr["prog_bytes"] == buf.size and buf.size % 16 == 0
    assert (hdr["sm_src"], hdr["sm_gy"]) == (sec["feeds"], sec["xs"])
    comb = np.frombuffer(buf[int(hdr["off_comb"]):][:40].tobytes(),
                         tcr.COMB)[0]
    assert (comb["d"], comb["rl2"], comb["decay"]) == (7200, 7424, 0.5)


def test_reverse_call_refusals():
    """The wrapper raises before anything launches: a CPU device, counts
    that do not match the program, a missing recorded input."""
    program = PROGRAMS["mega_cycle_10"]
    n_c, n_b, n_r, n_t, n_e, n_ew = tcr.counts(program)
    args = ((None,) * n_t, (None,) * n_r, ((None, None),) * n_c,
            (None,) * n_b, (torch.zeros(2, 256),) * n_ew, program, n_e, 2,
            256)
    before = tcr.LAUNCHES
    with pytest.raises(ValueError, match="CUDA device"):
        tcr.cycle_reverse_call(*args, torch.device("cpu"))
    with pytest.raises(ValueError, match="recorded inputs"):
        tcr.cycle_reverse_call(*args[:4], (), *args[5:],
                               torch.device("cuda", 0))
    with pytest.raises(ValueError, match="multiple of 128"):
        tcr.cycle_reverse_call(*args[:8], 200, torch.device("cuda", 0))
    assert tcr.LAUNCHES == before


# -- the kernel's walk, modelled ----------------------------------------------
#
# The reverse kernel reads the forward's packed constants transposed: thread
# t = 4q + e sums its quad's four columns over the steps m = 8w + e + 4s
# (s < 8 - 2w), h[4(m - q) - 3 .. 4(m - q) + 4] from two aligned float4s of
# the first reversed copy read backwards (tests/test_torch_cycle_reverse_
# tiles.py models the walk itself); warp 3's lane j reads Ecb's and ACt's
# row j; thread c reads W^T's column c.  The model below follows that
# indexing, the double-buffered carry adjoints and the rings of NR + 1
# blocks, and runs the generated block adjoint, its cascade step either as
# matrix products of the weights the walk reads or as the walk itself.

def _model_consts(sections):
    """(LT [128, 128], Wt [8, 128], Ecb [8, 128], ACt [8, 8]) read from
    cycle_casc_consts as the reverse kernel reads them: LT[c, i] is the
    weight of gy[i] in column c's sum over the walk."""
    hv, _, Wt, Ecb, ACt, _ = tiles.hold(tuple(sections))
    LT = np.zeros((128, 128), np.float32)
    for t in range(128):
        w, e, q = t >> 5, t & 3, t >> 2
        for s in range(8 - 2 * w):
            m = 8 * w + e + 4 * s
            for d in range(4):
                for f in range(4):
                    if 4 * (m - q) + f - d >= 0:
                        LT[4 * q + d, 4 * m + f] += hv[t, s, 3 + f - d]
    return LT, Wt, Ecb, ACt


@pytest.mark.parametrize("sections", tiles.SECTIONS)
def test_transposed_constants_read_back(sections):
    """The forward's first reversed Toeplitz copy, read backwards from 16-
    byte aligned float4s along the quad walk, gives the weights of gX = gy
    Ltg^T exactly (LT = Ltg: column c weighs gy[i] by h[i - c], zeros
    where i < c; every read inside the copy)."""
    from dsp_stuff_tpu_torch.ops.chain_kernel import _casc_consts
    Ltg, Wp, Ecb, ACt, _ = _casc_consts(sections)
    LT, Wt, E, A = _model_consts(sections)
    np.testing.assert_array_equal(LT, Ltg)
    np.testing.assert_array_equal(Wt, Wp.T)
    np.testing.assert_array_equal(E, Ecb)
    np.testing.assert_array_equal(A, ACt)
    reads = tiles.hold(tuple(sections))[1]
    on = reads >= 0
    assert tck.OFF_R % 4 == 0 and (reads[on] % 4 == 0).all()
    assert reads[on].min() == 0 and reads[on].max() + 3 == 159 < tck.RS


def _adjoint_of_source(src):
    """The generated cy_block_adjoint as a Python function of (x, g): its
    statements translated one for one, the literals read back as
    float32, the helpers' template arguments passed first."""
    n_ext = int(re.search(r"#define CY_NEXT (\d+)", src).group(1))
    body = []
    for line in src.splitlines():
        st = line.split("//")[0].strip()
        if not st or st.startswith(("#", "__device__", "}", "float ")):
            continue
        st = re.sub(r"(-?0x[0-9a-f.]+p[+-]\d+)f",
                    lambda m: f"F({float.fromhex(m.group(1))!r})", st)
        st = re.sub(r"__int_as_float\((-?\d+)\)", r"I(\1)", st)
        st = st.replace("0.0f", "F(0.0)")
        st = re.sub(r"(cr_\w+)<([^>]*)>\(", lambda m: "{}({}, ".format(
            m.group(1), m.group(2).replace("true", "True").replace(
                "false", "False")), st)
        body += [p.strip() for p in st.split(";") if p.strip()]
    code = ("def cy_block_adjoint(x, g):\n    f = s = sa = sb = F(0.0)\n"
            f"    e = [F(0.0)] * {n_ext}\n"
            + "".join(f"    {b}\n" for b in body))
    env = {"F": np.float32,
           "I": lambda i: np.array(i, np.int32).view(np.float32)[()]}
    exec(code, env)
    return env["cy_block_adjoint"]


def _reverse_model(budget, walk=False):
    """A stand-in for cycle_reverse_call: the kernel's walk in NumPy, the
    generated block adjoint (run through _adjoint_of_source) over helpers
    that follow the kernel's layouts; ``walk``: the cascade step as the
    quad walk (tests/test_torch_cycle_reverse_tiles.walk_step), else as
    matrix products of the weights it reads."""
    def call(ct_taps, ct_regs, seeds, ct_hists, recs, program, n_ext, B, T,
             dev):
        n_c, n_b, n_r, n_t, n_e, n_ew = tcr.counts(program)
        assert n_ext == n_e and dev.type == "cpu"
        block = _adjoint_of_source(tcr.source_for(program, budget))
        K = T // 128
        z = np.zeros((B, T), np.float32)
        src = [z if t is None else t.numpy() for t in ct_taps]
        src += [r.numpy() for r in recs]
        g = [np.zeros((B, 128), np.float32) if t is None else t.numpy().copy()
             for t in ct_regs] or [np.zeros((B, 128), np.float32)]
        g_ext = [np.zeros((B, T), np.float32) for _ in range(n_e)]
        casc, combs = [], []
        for ins in program:
            if ins[0] == "cascade":
                sx, sc = seeds[len(casc)]
                sc8 = np.zeros((B, 8), np.float32)
                if sc is not None:
                    sc8[:, :sc.shape[1]] = sc.numpy()
                casc.append(dict(k=_model_consts(ins[1]), sections=ins[1],
                                 cb=np.zeros((2, B, 8), np.float32),
                                 sx=None if sx is None else sx.numpy(),
                                 sc=sc8, gs0=None))
            elif ins[0] == "comb":
                D = int(ins[2])
                rl2 = (-(-D // 128) + 1) * 128
                cth = ct_hists[len(combs)]
                combs.append(dict(D=D, d=np.float32(ins[1]),
                                  ring=np.zeros((B, rl2), np.float32),
                                  cth=None if cth is None else cth.numpy()))
        c = np.arange(128)

        class X:
            b = 0

        def blk(a, b):
            return a[:, b * 128:(b + 1) * 128]

        def cr_in(x, i):
            return blk(src[i], x.b)

        def cr_feeds(x, e):
            for j in range(n_e):
                blk(g_ext[j], x.b)[:] = e[j]

        def cr_ew(op, x, f, v, p0, p1, p2, p3):
            kind = EW_CODES[op]
            n = {"overdrive": 3, "chebyshev": 2}.get(kind, 1)
            if kind == "chebyshev":
                assert (p2, p3) == (np.float32(tcyc._tanh20(float(p0))),
                                    np.float32(tcyc._tanh20(float(p1))))
            return tcyc.ew_adjoint(kind, torch.from_numpy(np.broadcast_to(
                f, (B, 128)).copy()), torch.from_numpy(v),
                (p0, p1, p2)[:n]).numpy()

        def cr_comb(D, sm, x, k, f, decay):
            cb = combs[k]
            ring = cb["ring"]
            rl2 = ring.shape[1]
            wb = (x.b % (rl2 // 128)) * 128
            rd = wb + c + D
            rd = np.where(rd >= rl2, rd - rl2, rd)
            n = x.b * 128 + c
            v = np.broadcast_to(f, (B, 128)).astype(np.float32)
            if cb["cth"] is not None:
                hit = n >= T - D
                v = np.where(hit, v + cb["cth"][:, np.clip(n - (T - D), 0,
                                                           D - 1)], v)
            v = (v + ring[:, rd] * decay).astype(np.float32)
            assert not set(rd) & set(wb + c)
            ring[:, wb + c] = v
            return v

        def cr_cascade(N, sm, x, k, f):
            return cr_cascade_held(N, x, k, f, None)

        def cr_cascade_held(N, x, k, f, hold):
            cs = casc[k]
            LT, Wt, Ecb, ACt = cs["k"]
            gy = np.broadcast_to(f, (B, 128)).astype(np.float32)
            gn = cs["cb"][(x.b + 1) & 1]
            if walk:
                gx, gc = tiles.walk_step(cs["sections"], gy, gn)
            else:
                gx = (gy @ LT.T + gn @ Wt).astype(np.float32)
                gc = (gy @ Ecb.T + gn @ ACt.T).astype(np.float32)
            if x.b == K - 1:
                if cs["sx"] is not None:
                    gx = gx + cs["sx"]
                gc = gc + cs["sc"]
            cs["cb"][x.b & 1] = gc
            if x.b == 0:
                cs["gs0"] = gc
            return gx

        block.__globals__.update(cr_in=cr_in, cr_feeds=cr_feeds, cr_ew=cr_ew,
                                 cr_comb=cr_comb, cr_cascade=cr_cascade,
                                 cr_cascade_held=cr_cascade_held, hold=None)
        x = X()
        for b in reversed(range(K)):
            x.b = b
            block(x, g)
        g_states = []
        ci = bi = 0
        for ins in program:
            if ins[0] == "cascade":
                g_states.append(casc[ci]["gs0"])
                ci += 1
            elif ins[0] == "comb":
                cb = combs[bi]
                bi += 1
                D, rl2 = cb["D"], cb["ring"].shape[1]
                j = np.arange(D)
                gh = np.where(j < T, cb["ring"][:, j % rl2] * cb["d"],
                              np.float32(0.0)).astype(np.float32)
                if cb["cth"] is not None and T < D:
                    gh[:, T:] = gh[:, T:] + cb["cth"][:, :D - T]
                g_states.append(gh)
        return (_t(g_ext), _t(np.broadcast_to(v, (B, 128)) for v in g[:n_r]),
                _t(g_states))
    return call


@pytest.mark.parametrize("name,T,budget", [
    ("config5", 3 * 7424 + 640, 227_000), ("config5", 640, 227_000),
    ("mega_cycle_10", 1024, 227_000), ("mega_cycle_2", 1024, 20_000),
    ("distort:Fuzz", 768, 227_000), ("chebyshev half", 512, 227_000),
    ("big ring", 2 * 64_128 + 256, 227_000),
    ("oversized", 640, 227_000)])
def test_kernel_model_matches_adjoint(name, T, budget, monkeypatch):
    """The kernel path's glue (``_kernel_cycle_adjoint``: rows, the cascade
    infos' seeds, the gradients back at the batch shape) around the model
    of the kernel's walk, on a (2, 2) batch with unbatched registers and
    states, against interpret_adjoint: config5's ring wrapped three
    times and longer than the render, a ring and constants in device
    memory, every shaper kind."""
    program = {"big ring": big_ring_cycle_program()[0],
               "oversized": oversized_cycle_program()[0]}.get(
                   name, PROGRAMS.get(name))
    exts, regs, states = _inputs(program, 4, T, 40)
    ins = (_t(e.reshape(2, 2, T) for e in exts), _t(r[0] for r in regs),
           _t(s[0] for s in states))
    flat, recs = _forward(program, ins)
    ws = _weights(flat, 41, "all", _n_taps(program))
    cts = tuple(torch.from_numpy(w) for w in ws)
    monkeypatch.setattr(tcr, "cycle_reverse_call", _reverse_model(budget))
    got = tcyc._kernel_cycle_adjoint(cts, _shapes(*ins), program,
                                     _n_taps(program), recs)
    want = tcyc.interpret_adjoint(cts, _shapes(*ins), program,
                                  _n_taps(program), recs)
    pairs = []
    for gg, wg in zip(got, want):
        for g, w in zip(gg, wg):
            assert g.shape == w.shape
            pairs.append((g.numpy(), w.numpy()))
    _held(f"{name} T={T}: the kernel's model", pairs, MODEL_RTOL)


@pytest.mark.parametrize("name,T,budget", [
    ("config5", 3 * 7424 + 640, 227_000), ("config5", 640, 12_000),
    ("mega_cycle_10", 1024, 227_000), ("mega_cycle_2", 1024, 20_000),
    ("distort:Fuzz", 768, 227_000), ("overdrive", 512, 227_000),
    ("big ring", 2 * 64_128 + 256, 227_000), ("oversized", 640, 227_000)])
def test_kernel_walk_model_matches_adjoint(name, T, budget, monkeypatch):
    """test_kernel_model_matches_adjoint with the cascade step as the
    kernel's quad walk (its per-thread index arithmetic and float32 order,
    the shuffles and warp 3's carry lanes) in place of the matrix
    products: config5's ring wrapped three times, its constants and ring
    in device memory, two cascades, a Fuzz loop, the big ring, nine
    cascades."""
    program = {"big ring": big_ring_cycle_program()[0],
               "oversized": oversized_cycle_program()[0]}.get(
                   name, PROGRAMS.get(name))
    exts, regs, states = _inputs(program, 4, T, 43)
    ins = (_t(e.reshape(2, 2, T) for e in exts), _t(r[0] for r in regs),
           _t(s[0] for s in states))
    flat, recs = _forward(program, ins)
    ws = _weights(flat, 44, "all", _n_taps(program))
    cts = tuple(torch.from_numpy(w) for w in ws)
    monkeypatch.setattr(tcr, "cycle_reverse_call",
                        _reverse_model(budget, walk=True))
    got = tcyc._kernel_cycle_adjoint(cts, _shapes(*ins), program,
                                     _n_taps(program), recs)
    want = tcyc.interpret_adjoint(cts, _shapes(*ins), program,
                                  _n_taps(program), recs)
    pairs = []
    for gg, wg in zip(got, want):
        for g, w in zip(gg, wg):
            assert g.shape == w.shape
            pairs.append((g.numpy(), w.numpy()))
    _held(f"{name} T={T}: the kernel's walk", pairs, MODEL_RTOL)
