"""A Fuzz group's backward (compiler/pointwise.py: ``bmax``'s vjp, the
``bsum`` and ``bcnt`` ops; ops/pointwise_reverse_kernel.py and
csrc/pointwise_reverse_kernel.cu: the staged reverse build) on the CPU,
where the kernel itself cannot run (chip_smoke.py's fuzz_reverse_checks
run it):

* ``pointwise.adjoint`` of the fuzz form through ``group_adjoint``
  against autograd through ``interpret`` (``group_vjp``): bitwise with
  autograd's f32 sums (a [T] level, expanded over the rows and summed back
  in float64: within 1e-6), and with the kernel's float64 sums within 1e-6
  (per element, max-normalized) and 1e-6 for the level slider; NaN, inf,
  all-zero and tied blocks planted, the NaN pattern exactly autograd's;
  the level a slider, a [B, T] and a [T] modulation, three policies;
  amax's tie split on a hand-made block;
* the same adjoint against ``jax.vjp`` of the JAX package's
  ``shaping.fuzz`` (rtol 1e-3, max-normalized; NaN where it is NaN);
* a NumPy model of the staged reverse build (pass 1: the full world's
  statements translated from the generated text in stages around the
  block ops, a warp one 128-sample block of a row; each thread's float64
  sums, the CTA's tree; pass 2's sums and the uniform tail) against
  ``group_adjoint(sums64=True)``: bitwise per element, the slider's sum
  within 1e-12 of the plain version's float64 sum;
* the launch: the float4 build alone, T % 128 == 0, a stream with
  unaligned rows copied; the staged text's block ops pinned to
  csrc/pointwise_ops.cuh;
* PointwiseGroup's backward swapped for the plain adjoint on a Fuzz
  program: the gradients of a gain -> Fuzz -> mix graph (the input and
  the Fuzz level) through compile_graph against the eager route's.
"""

import pathlib
import re

import jax
import numpy as np
import pytest
import torch

import dsp_stuff_tpu_torch as dt
import test_torch_pointwise_reverse as tpr
from dsp_stuff_tpu.ops import shaping as jshaping
from dsp_stuff_tpu.utils import precision as jprec
from dsp_stuff_tpu_torch.compiler import compile as tcomp
from dsp_stuff_tpu_torch.compiler import pointwise as pw
from dsp_stuff_tpu_torch.ids import IdSpace
from dsp_stuff_tpu_torch.ops import pointwise_kernel as pk
from dsp_stuff_tpu_torch.ops import pointwise_reverse_kernel as prk
from dsp_stuff_tpu_torch.utils import precision as tprec

POLICIES = ["fast", "parity", "exact"]
B, T = 3, 1024
CPU = torch.device("cpu")
F32, F64 = np.float32, np.float64
ELEMENT_RTOL = 1e-6       # per element, max-normalized, float64 block sums
SUM_RTOL = 1e-6           # the level slider's gradient, float64 sums
JAX_RTOL = 1e-3
_CSRC = pathlib.Path(prk.__file__).resolve().parent.parent / "csrc"
OPS_SRC = (_CSRC / "pointwise_ops.cuh").read_text()
REV_SRC = (_CSRC / "pointwise_reverse_kernel.cu").read_text()


@pytest.fixture(autouse=True)
def _torch_env():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    prev = tprec.get_policy()
    yield
    tprec.set_policy(prev)
    torch.set_num_threads(threads)


def _same(got, want) -> bool:
    """Bit for bit, NaN at the same places."""
    got, want = torch.as_tensor(got), torch.as_tensor(want)
    if got.shape != want.shape or got.dtype != want.dtype:
        return False
    nan = torch.isnan(want)
    return bool(torch.equal(torch.isnan(got), nan) and torch.equal(
        got[~nan].view(torch.int32), want[~nan].view(torch.int32)))


def _close(got, want, rtol) -> bool:
    """NaN at the same places, the rest within rtol, max-normalized."""
    got, want = (torch.as_tensor(t).double() for t in (got, want))
    nan = torch.isnan(want)
    if not torch.equal(torch.isnan(got), nan):
        return False
    if bool(nan.all()):
        return True
    d = (got[~nan] - want[~nan]).abs().max()
    return bool(d <= rtol * want[~nan].abs().max().clamp_min(1e-30))


def _x(seed, planted=True, shape=(B, T)):
    """N(0, 0.7); planted: an all-zero block, a NaN, an inf, a -inf, a
    block of ties (its max at three samples) and a block whose max is 0
    but for a signed zero."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 0.7).astype(F32)
    if planted:
        x[1, 128:256] = 0.0
        x[0, 300] = np.nan
        x[2, 700] = np.inf
        x[0, 900] = -np.inf
        x[2, 10], x[2, 40], x[2, 77] = 3.0, -3.0, 3.0
        x[1, 512:640] = 0.0
        x[1, 600] = -0.0
    return torch.from_numpy(x)


def _levels(seed):
    rng = np.random.default_rng(seed)
    return {"slider": 2.5,
            "[B, T]": torch.from_numpy(rng.uniform(0.5, 4.0, (B, T))
                                       .astype(F32)),
            "[T]": torch.from_numpy(rng.uniform(0.5, 4.0, T).astype(F32))}


def _group(pol, level):
    """(program, signals, scalars) of a one-node Fuzz group."""
    b = pw.Builder()
    x = b.sig()
    slider = isinstance(level, float)
    lv = b.scal() if slider else b.sig()
    return b.program([pw.fuzz(b, x, lv, pol)]), slider


def _operands(x, level, slider):
    return ([x] + ([] if slider else [level]),
            [tprec.scalar_on(level, CPU)] if slider else [])


@pytest.mark.parametrize("pol", POLICIES)
def test_fuzz_adjoint_is_autograd(pol):
    """group_adjoint of a Fuzz group (its adjoint program) against
    group_vjp: bitwise with autograd's f32 sums (NaN where autograd's is,
    specials and ties planted), and with the kernel's float64 sums within
    ELEMENT_RTOL per element and SUM_RTOL for the slider, the NaN pattern
    the same."""
    rng = np.random.default_rng(4)
    for planted in (True, False):
        x = _x(1, planted)
        ct = torch.from_numpy(rng.standard_normal((B, T)).astype(F32))
        for name, level in _levels(2).items():
            prog, slider = _group(pol, level)
            sigs, scals = _operands(x, level, slider)
            need = (True,) * (len(sigs) + len(scals))
            with dt.policy(pol):
                want = pk.group_vjp(prog, sigs, scals, [ct], need, T, CPU)
                got = pk.group_adjoint(prog, sigs, scals, [ct], need, T, CPU)
                g64 = pk.group_adjoint(prog, sigs, scals, [ct], need, T, CPU,
                                       sums64=True)
            for k, (g, h, w) in enumerate(zip(got, g64, want)):
                what = (pol, name, planted, k)
                assert g.shape == w.shape, what
                if name == "[T]" and k == 1:
                    # expanded over the rows, summed back in float64
                    assert _close(g, w, ELEMENT_RTOL), what
                else:
                    assert _same(g, w), what
                assert _close(h, w, ELEMENT_RTOL if h.dim() else SUM_RTOL), \
                    what
            if planted:
                # the all-zero block and the blocks with NaN or inf: NaN
                assert bool(torch.isnan(got[0][1, 128:256]).all())
                assert bool(torch.isnan(got[0][0, 256:384]).all())


def test_amax_splits_ties():
    """bmax's vjp is autograd's amax backward: the block's cotangent sum
    S split evenly among its ties, a multiply by the mask ([1, 2, 2, .5]
    with cotangents [1, 2, 0, 0] gives [0, 1.5, 1.5, 0]); a NaN in S or
    in the block makes every sample NaN."""
    b = pw.Builder()
    v = b.abs(b.sig())
    prog = b.program([b.bmax(v)])
    x = torch.zeros(1, 128)
    x[0, :4] = torch.tensor([1.0, 2.0, -2.0, 0.5])
    ct = torch.zeros(1, 128)
    ct[0, :2] = torch.tensor([1.0, 2.0])
    for s64 in (False, True):
        (g,) = pk.group_adjoint(prog, [x], [], [ct], (True,), 128, CPU, s64)
        assert g[0, :4].tolist() == [0.0, 1.5, -1.5, 0.0]
        assert bool((g[0, 4:] == 0).all())
    ct[0, 50] = float("nan")
    (g,) = pk.group_adjoint(prog, [x], [], [ct], (True,), 128, CPU, True)
    assert bool(torch.isnan(g).all())
    x[0, 7] = float("nan")
    (g,) = pk.group_adjoint(prog, [x], [], [torch.ones(1, 128)], (True,),
                            128, CPU, True)
    (w,) = pk.group_vjp(prog, [x], [], [torch.ones(1, 128)], (True,), 128,
                        CPU)
    assert bool(torch.isnan(g).all()) and _same(g, w)


@pytest.mark.parametrize("pol", POLICIES)
def test_fuzz_adjoint_against_jax(pol):
    """The Fuzz group's gradients (x and its level: a slider and a [B, T]
    modulation) against jax.vjp of the JAX package's shaping.fuzz, ties
    and an all-zero block planted: NaN where JAX's is NaN, the rest
    within JAX_RTOL, max-normalized."""
    rng = np.random.default_rng(8)
    x = _x(5, planted=False)
    x[1, 128:256] = 0.0
    x[2, 10], x[2, 40] = 3.0, -3.0
    ct = rng.standard_normal((B, T)).astype(F32)
    for name, level in list(_levels(6).items())[:2]:
        prog, slider = _group(pol, level)
        sigs, scals = _operands(x, level, slider)
        need = (True,) * (len(sigs) + len(scals))
        with dt.policy(pol):
            got = pk.group_adjoint(prog, sigs, scals, [torch.from_numpy(ct)],
                                   need, T, CPU, sums64=True)
        lv = np.float32(level) if slider else level.numpy()
        with jprec.policy(pol):
            _, vjp = jax.vjp(lambda a, l_: jshaping.fuzz(a, l_, 128),
                             x.numpy(), lv)
            want = vjp(ct)
        for k, (g, w) in enumerate(zip(got, want)):
            w = np.asarray(w)
            assert g.shape == w.shape, (pol, name, k)
            nan = np.isnan(w)
            assert (np.isnan(g.numpy()) == nan).all(), (pol, name, k)
            if not nan.all():
                d = np.abs(g.numpy()[~nan].astype(F64) - w[~nan]).max()
                assert d <= JAX_RTOL * np.abs(w[~nan]).max(), (pol, name, k)


# -- a model of the staged reverse build -------------------------------------

_STAGE = re.compile(r"^    v(\d+)\[i\] = (.+);$")
_BLOCK = re.compile(r"^  pw_(bmax|bsum|bcnt)\(v(\d+), v(\d+)(?:, v(\d+))?\);$")
_RED = re.compile(r"^    (a[UR])\[(\d+)\] \+= (.+);$")
_GOUT = re.compile(r"^    g\[i\]\[(\d+)\] = (.+);$")


def _unstage(expr):
    return re.sub(r"\bv(\d+)\[i\]", r"v\1",
                  re.sub(r"\bx\[i\]\[(\d+)\]", r"x[\1]", expr))


def _lanes(v, rows, Tn):
    """[rows * T] as [rows, T / 128, 32 lanes, 4 samples]."""
    return np.asarray(v).reshape(rows, Tn // 128, 32, 4)


def _xor_tree(w):
    """The warp's xor tree over the lanes (last axis), lane i adding lane
    i ^ o, o = 16 .. 1; every lane ends with lane 0's value."""
    lane = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        w = w + w[..., lane ^ o]
    return w


def _block_op(op, args, rows, Tn):
    """pw_bmax, pw_bsum, pw_bcnt over the flattened [rows * T] values."""
    if op == "bmax":
        m = _lanes(args[0], rows, Tn)
        r = m[..., 0]
        for i in range(1, 4):
            r = tpr.tpw._maxn(r, m[..., i])
        lane = np.arange(32)
        for o in (16, 8, 4, 2, 1):
            r = tpr.tpw._maxn(r, r[..., lane ^ o])
        out = r
    elif op == "bsum":
        v = _lanes(args[0], rows, Tn).astype(F64)
        acc = np.zeros(v.shape[:-1])
        for i in range(4):
            acc = acc + v[..., i]
        out = _xor_tree(acc).astype(F32)
    else:
        eq = (_lanes(args[0], rows, Tn) == _lanes(args[1], rows, Tn))
        out = _xor_tree(eq.sum(-1)).astype(F32)
    return np.repeat(out[..., None], 4, axis=-1).reshape(-1)


def _staged_model(prog, sigs, scals, cts, need, Tn):
    """The staged reverse build on plan_reverse's launch, in NumPy: pass 1
    over every row and sample (pr_block's stages translated from the
    generated text, its block ops a warp's; each thread's float64 sums in
    its samples' order, the CTA's tree), pass 2 (each thread every
    THREADS2-th partial, the tree, pr_tail).  Returns the gradients as the
    operands' shapes and the launch."""
    pl = pk.plan_adjoint(prog, sigs, scals, cts, need, Tn)
    w = prk.worlds(pl.adj)
    ln = prk.plan_reverse(pl, CPU)
    src = prk.reverse_source(pl.adj)
    fns = tpr._functions(src)
    rows, (gx, gy) = ln.rows, ln.grid
    assert ln.vec and ln.rch == 1 and gy == rows and Tn % 128 == 0
    assert "#define PR_STAGED 1" in src
    P = [t.reshape(()).numpy() for t in ln.ptrs]
    U = {}
    with np.errstate(all="ignore"):
        tpr._run(fns["pr_uniform"], dict(tpr._ENV, P=P, U=U, V={},
                                         STORE={}), {})
    X = [np.broadcast_to(t.numpy(), (rows, Tn)).reshape(-1)
         for t in ln.ins[:w.n_in1]]
    V, reds, gs = {}, {}, {}
    env = dict(tpr._ENV, U=U, V=V, P=P, X=X)
    with np.errstate(all="ignore"):
        for line in src.splitlines():
            m = _STAGE.match(line)
            if m:
                V[m.group(1)] = np.broadcast_to(
                    eval(tpr._py(_unstage(m.group(2))), env), (rows * Tn,))
                continue
            m = _BLOCK.match(line)
            if m:
                args = [V[a] for a in m.groups()[2:] if a is not None]
                V[m.group(2)] = _block_op(m.group(1), args, rows, Tn)
                continue
            m = _RED.match(line)
            if m:
                assert m.group(1) == "aU"
                reds[int(m.group(2))] = np.broadcast_to(
                    eval(tpr._py(_unstage(m.group(3))), env),
                    (rows * Tn,)).astype(F64)
                continue
            m = _GOUT.match(line)
            if m:
                gs[int(m.group(1))] = np.broadcast_to(
                    eval(tpr._py(_unstage(m.group(2))), env), (rows * Tn,))
    # each thread's sums (its four samples in order from 0.0), the CTA's
    # tree, one partial a CTA: CTA (bx, by) takes row by, units bx * THREADS
    # + tid
    part = []
    nth = prk.THREADS
    for k in range(len(w.reds[("F", "U")])):
        v = reds[k].reshape(rows, Tn // 4, 4)
        th = np.zeros((rows, gx * nth))
        for i in range(4):
            th[:, :Tn // 4] = th[:, :Tn // 4] + v[..., i]
        part.append(tpr._tree(th.reshape(rows, gx, nth)).reshape(-1))
    ru = [tpr._tree(np.asarray([tpr.sum_seq(p[i::prk.THREADS2])
                                for i in range(prk.THREADS2)]))[()]
          for p in part]
    store = {}
    if ln.pass2:
        env2 = dict(tpr._ENV, U=U, V={}, STORE={}, P=P,
                    ru=np.asarray(ru, F64))
        with np.errstate(all="ignore"):
            tpr._run(fns["pr_tail"], env2, {})
        store = env2["STORE"]
    grads = [None] * len(need)
    for j, (k, _) in enumerate(w.outs):
        shape = pw.class_shape(pl.adj.classes[k], rows, Tn)
        g = (gs[j].reshape(shape) if j < w.n_out1
             else np.asarray(store[j]).reshape(shape))
        grads[k] = torch.from_numpy(np.array(g, F32))
    return pk.shaped_grads(pl, grads), ln


@pytest.mark.parametrize("pol", POLICIES)
def test_staged_reverse_model_is_the_plain_version(pol):
    """The model of the staged build against group_adjoint(sums64=True):
    every per-element gradient bitwise (the block sums in the kernel's
    order in both), the slider's sum within 1e-12 of the plain version's
    float64 sum before its rounding (NaN where it is NaN); a [T] level is
    expanded over the rows and its gradient summed back in float64."""
    rng = np.random.default_rng(12)
    for planted in (True, False):
        x = _x(3, planted)
        ct = torch.from_numpy(rng.standard_normal((B, T)).astype(F32))
        for name, level in _levels(9).items():
            prog, slider = _group(pol, level)
            sigs, scals = _operands(x, level, slider)
            for need in ((True,) * (len(sigs) + len(scals)),
                         (True,) + (False,) * (len(sigs) + len(scals) - 1)):
                with dt.policy(pol):
                    got, ln = _staged_model(prog, sigs, scals, [ct], need, T)
                    want = pk.group_adjoint(prog, sigs, scals, [ct], need, T,
                                            CPU, sums64=True)
                for k, (g, h) in enumerate(zip(got, want)):
                    what = (pol, name, planted, need, k)
                    assert (g is None) == (h is None), what
                    if h is None:
                        continue
                    if h.dim() == 0:
                        assert _close(g, h, 1e-12 + 2.0**-24), what
                    else:
                        assert _same(g, h.contiguous()), what
                assert ln.pass2 == (slider and need[-1])


def test_staged_source_and_launch():
    """A Fuzz group's reverse text is the staged build (its block ops
    between stages, its sums only to uniform values, no per-sample value
    hoisted), bitwise the same for two programs of one structure; the
    launch refuses T % 128 and copies a stream with unaligned rows into
    the float4 build."""
    prog, _ = _group("fast", 2.0)
    ct = torch.randn(2, 512)
    pl = pk.plan_adjoint(prog, [torch.randn(2, 512)],
                         [tprec.scalar_on(2.0, CPU)], [ct], (True, True), 512)
    src = prk.reverse_source(pl.adj)
    assert "#define PR_STAGED 1" in src and "#define PR_NFC 0" in src
    assert src.count("  pw_bmax(") == 3 and src.count("  pw_bsum(") == 3
    assert src.count("  pw_bcnt(") == 3
    assert prk.staged(pl.adj) and prk.hoisted(pl.adj) == ()
    pl2 = pk.plan_adjoint(prog, [torch.randn(2, 512)],
                          [tprec.scalar_on(7.0, CPU)], [ct], (True, True),
                          512)
    assert prk.reverse_source(pl2.adj) == src
    with pytest.raises(ValueError, match="T % 128"):
        prk.plan_reverse(pk.plan_adjoint(
            prog, [torch.randn(2, 200)], [tprec.scalar_on(2.0, CPU)],
            [torch.randn(2, 200)], (True, True), 200), CPU)
    flat = torch.randn(2 * 512 + 1)
    xu = flat[1:].view(2, 512)
    ln = prk.plan_reverse(pk.plan_adjoint(
        prog, [xu], [tprec.scalar_on(2.0, CPU)], [ct], (True, True), 512),
        CPU)
    assert ln.vec and all(t.data_ptr() % 16 == 0 for t in ln.ins)
    assert any(torch.equal(t, xu) for t in ln.ins)


def test_block_ops_are_the_kernels():
    """The model's block ops and the staged launch are the CUDA sources'."""
    for stmt in (
            "for (int i = 0; i < N; ++i) r = __dadd_rn(r, (double)v[i]);",
            "r = __dadd_rn(r, __shfl_xor_sync(0xffffffffu, r, o));",
            "const float f = __double2float_rn(r);",
            "for (int i = 0; i < N; ++i) n += a[i] == b[i];",
            "for (int o = 16; o > 0; o >>= 1) n += __shfl_xor_sync("
            "0xffffffffu, n, o);",
            "for (int i = 0; i < N; ++i) c[i] = (float)n;",
            "r = pw_maxn(r, __shfl_xor_sync(0xffffffffu, r, o));"):
        assert stmt in OPS_SRC, stmt
    for stmt in ("pr_block(U, x, g, aU, aR);",
                 "if (!vec || T % 128) return (int)cudaErrorInvalidValue;",
                 'static_assert(VEC, "a staged build runs only the float4 '
                 'build");'):
        assert stmt in REV_SRC, stmt


def _gain_fuzz_mix():
    g = dt.Graph(IdSpace())
    inp = g.add("input")
    gn = g.add("gain", level=1.7)
    fz = g.add("distort", mode="Fuzz", level=2.5)
    mx = g.add("mix", ratio=0.4)
    o = g.add("output")
    g.chain(inp, gn, fz)
    g.connect(fz, "out", mx, "a")
    g.connect(inp, "out", mx, "b")
    g.connect(mx, "out", o, "in")
    return g, str(fz.id)


@pytest.mark.parametrize("pol", POLICIES)
def test_graph_gradients_through_the_adjoint(pol, monkeypatch):
    """gain -> Fuzz -> mix through compile_graph, the groups on the card's
    route (PointwiseGroup, the plain version forward, group_adjoint with
    float64 sums as the backward, group_vjp never run): the gradients of
    the input and of the Fuzz level against the eager route's (Fuzz's
    eager shaping.fuzz under autograd), within ELEMENT_RTOL and SUM_RTOL;
    one group, one backward."""
    g, fz = _gain_fuzz_mix()
    rng = np.random.default_rng(14)
    x = (rng.standard_normal((2, 1, T)) * 0.4).astype(F32)
    w = torch.from_numpy(rng.standard_normal((2, 1, T)).astype(F32))
    calls = {"backward": 0}

    def backward(*a):
        calls["backward"] += 1
        return pk.group_adjoint(*a, sums64=True)

    def grads(route):
        with monkeypatch.context() as m:
            if route == "groups":
                m.setattr(tcomp, "group_call", lambda prog, sigs, scals, Tn,
                          d: pk.run(pw.interpret, prog, sigs, scals, Tn, d,
                                    backward))
                m.setattr(pk, "group_vjp", None)
            else:
                m.setattr(tcomp, "POINTWISE_FUSION", False)
            cg = dt.compile_graph(g, device="cpu")
            xt = torch.tensor(x, requires_grad=True)
            lv = torch.tensor(2.5, requires_grad=True)
            with dt.policy(pol):
                y = cg.render(xt, batch_shape=(2,),
                              params={fz: {"level": lv}})[0]
                (y * w).sum().backward()
        return xt.grad, lv.grad

    got, want = grads("groups"), grads("eager")
    assert calls["backward"] == 1
    assert _close(got[0], want[0], ELEMENT_RTOL)
    assert _close(got[1], want[1], SUM_RTOL)
