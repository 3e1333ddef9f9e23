"""The signal generator's backward (ops/gen.py oscillator_adjoint, the
reverse oscillator kernel csrc/oscillator_reverse_kernel.cu and its
wrapper ops/oscillator_reverse_kernel.py) on the CPU, where the kernel
itself cannot run (chip_smoke.py's oscillator_reverse_phase runs it):

* ``oscillator_adjoint`` against autograd through ``oscillator_plain``
  (rtol 1e-5, max-normalized; None where autograd gives None) for the
  four modes under the three policies: a frequency slider at 0.5 and 997
  Hz, a [T] and a [B, T] modulation, the amplitude a slider and a [B, T]
  modulation, clock0 at 0.25, one block and several, the final clock's
  cotangent present and absent;
* ``oscillator_adjoint`` against ``jax.vjp`` of the JAX package's
  oscillator (rtol 1e-3, max-normalized);
* a NumPy model of the kernel's three passes on the launch
  ``plan_reverse`` lays out, its statements pinned to the CUDA source:
  bitwise ``oscillator_adjoint`` where the operands' shapes are the
  kernel's own (every float64 sum in the order the plain adjoint fixes),
  within rtol 1e-6 where the wrapper sums a broadcast back;
* ``gen.Oscillator`` with a swappable backward driven along the card's
  route (a model of the forward kernel, the plain adjoint as the
  backward): its gradients against the plain adjoint and against
  autograd through the plain version, and the recompute it replaced kept
  as the reference;
* config5's LFO sliders' gradients through that route against
  ``jax.grad`` of the JAX package's loss.
"""

import pathlib
import re

import jax
import numpy as np
import pytest
import torch

import dsp_stuff_tpu as dj
import dsp_stuff_tpu_torch as dt
from dsp_stuff_tpu.models import presets as jpresets
from dsp_stuff_tpu.ops.gen import oscillator as josc
from dsp_stuff_tpu.train import fit as jfit
from dsp_stuff_tpu.utils import precision as jprec
from dsp_stuff_tpu_torch.ids import IdSpace as TIdSpace
from dsp_stuff_tpu_torch.ops import gen
from dsp_stuff_tpu_torch.ops import oscillator_kernel as ok
from dsp_stuff_tpu_torch.ops import oscillator_reverse_kernel as ork
from dsp_stuff_tpu_torch.train import fit as tfit
from dsp_stuff_tpu_torch.utils import precision as tprec

POLICIES = ["fast", "parity", "exact"]
MODES = ["Sine", "Triangle", "Square", "Constant"]
B = 3
CPU = torch.device("cpu")
F32, F64 = np.float32, np.float64
SR = 48_000.0
AUTOGRAD_RTOL = 1e-5      # the plain adjoint vs autograd (max-normalized)
JAX_RTOL = 1e-3           # vs jax.vjp / jax.grad (max-normalized)
SUM_RTOL = 1e-6           # the model where the wrapper sums a broadcast
_CSRC = pathlib.Path(ork.__file__).resolve().parent.parent / "csrc"
SRC = (_CSRC / "oscillator_reverse_kernel.cu").read_text()
OPS_SRC = (_CSRC / "oscillator_ops.cuh").read_text()


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


def _err(got, want) -> float:
    """max |got - want| / max |want| (0 where both are 0)."""
    got, want = (np.asarray(t, F64) for t in (got, want))
    scale = np.abs(want).max() if want.size else 0.0
    d = np.abs(got - want).max() if want.size else 0.0
    return 0.0 if d == 0 else d / max(scale, 1e-30)


def _freqs(T, seed):
    rng = np.random.default_rng(seed)
    one = (300.0 + 250.0 * np.sin(np.arange(T) / 37.0)).astype(F32)
    many = (500.0 + 300.0 * rng.standard_normal((B, T))).astype(F32)
    return {"0.5 Hz": torch.tensor(0.5), "997 Hz": torch.tensor(997.0),
            "[T]": torch.from_numpy(one), "[B, T]": torch.from_numpy(many)}


def _amps(T, seed):
    rng = np.random.default_rng(seed + 1)
    return {"slider": torch.tensor(0.6), "[B, T]": torch.from_numpy(
        rng.uniform(-1.0, 1.0, (B, T)).astype(F32))}


def _cases(T, seed):
    """(label, amp, freq, clock0) of the listed operand forms."""
    out = []
    for fk, f in _freqs(T, seed).items():
        for ak, a in _amps(T, seed).items():
            out.append((f"frequency {fk}, amplitude {ak}", a, f,
                        torch.tensor(0.25)))
    return out


def _cotangents(mode, a, f, T, c0, seed):
    """(ct_y of the wave's shape, ct_clock of the final clock's)."""
    y, c = gen.oscillator_plain(mode, a, f, T, c0)
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.standard_normal(y.shape).astype(F32)),
            torch.from_numpy(np.asarray(rng.standard_normal(c.shape),
                                        F32)))


def _autograd(mode, a, f, T, c0, ct_y, ct_clock, need=(True,) * 3):
    """Autograd through oscillator_plain: the route the kernel replaced."""
    ops = [t.detach().clone().requires_grad_(n)
           for t, n in zip((a, f, c0), need)]
    y, c = gen.oscillator_plain(mode, *ops[:2], T, ops[2])
    pairs = [(o, ct) for o, ct in zip((y, c), (ct_y, ct_clock))
             if ct is not None and o.requires_grad]
    want = [t for t, n in zip(ops, need) if n]
    if not pairs:
        return [None] * 3
    got = iter(torch.autograd.grad([o for o, _ in pairs], want,
                                   [ct for _, ct in pairs],
                                   allow_unused=True))
    return [next(got) if n else None for n in need]


def _sum_to(x, shape):
    """NumPy ``x`` summed (float64) to the broadcast source ``shape``."""
    shape = tuple(shape)
    lead = (1,) * (x.ndim - len(shape)) + shape
    axes = tuple(i for i, (a, b) in enumerate(zip(x.shape, lead))
                 if b == 1 and a != 1)
    return x.sum(axis=axes, keepdims=True).reshape(shape)


def _ref64(mode, a, f, T, c0, ct_y, ct_clock):
    """The adjoint in float64 at the f32 forward's phases: every product,
    sum and chain of the backward in float64 (the remainder's derivative
    1), the reference where autograd's f32 sum cancels."""
    a64 = a.numpy().astype(F64)
    f_shape, c_shape = tuple(f.shape), tuple(c0.shape)
    totals, clocks, _ = gen._block_totals(f, T, 128, int(SR), c0, CPU)
    phase = (clocks + totals).numpy()
    batch, nb = phase.shape[:-1], T // 128
    arg = (phase * TAU).astype(F32).astype(F64)
    w = {"Sine": np.sin(arg), "Triangle": 2.0 * _rem1(phase) - 1.0,
         "Square": np.where(totals.numpy() > 0.5, 1.0, -1.0)}[mode]
    ct = ct_y.numpy().astype(F64)
    g_amp = _sum_to(ct * w, a64.shape)
    g_w = _sum_to(ct * a64, w.shape)
    g_phase = (g_w * np.cos(arg) * F64(TAU) if mode == "Sine"
               else 2.0 * g_w if mode == "Triangle" else 0.0 * g_w)
    gp = g_phase.reshape(*batch, nb, 128)
    g = (np.zeros(batch) if ct_clock is None
         else ct_clock.numpy().astype(F64).reshape(batch))
    g_bs = np.empty((*batch, nb))
    for k in range(nb - 1, -1, -1):
        g_bs[..., k] = g
        g = g + gp[..., k, :].sum(-1)
    g_step = np.flip(np.cumsum(np.flip(gp, -1), -1), -1) + g_bs[..., None]
    g_freq = _sum_to(g_step.reshape(*batch, T), f_shape) / SR
    return g_amp, g_freq, _sum_to(g, c_shape)


def _held_to_autograd(got, want, ref, what):
    """Each gradient within AUTOGRAD_RTOL of autograd's, or, for one value
    whose f32 sum in autograd cancels past that, no farther than
    autograd's from the float64 reference (with 1e-6 of it to spare)."""
    for g, w, r in zip(got, want, ref):
        assert (g is None) == (w is None), what
        if w is None:
            continue
        assert g.shape == w.shape, what
        if _err(g, w) <= AUTOGRAD_RTOL:
            continue
        assert g.dim() == 0 and r is not None, (what, _err(g, w))
        d, dw = abs(float(g) - float(r)), abs(float(w) - float(r))
        assert d <= max(dw, 1e-6 * abs(float(r))), (what, d, dw)


# -- the plain adjoint --------------------------------------------------------

@pytest.mark.parametrize("pol", POLICIES)
@pytest.mark.parametrize("mode", MODES)
def test_adjoint_is_autograd(mode, pol):
    """oscillator_adjoint against autograd through oscillator_plain: every
    gradient within AUTOGRAD_RTOL (max-normalized), of its operand's
    shape, None exactly where autograd's is (Square's wave and Constant
    reach no frequency; a missing cotangent reaches nothing)."""
    for T in (128, 1024):
        for label, a, f, c0 in _cases(T, T):
            ct_y, ct_c = _cotangents(mode, a, f, T, c0, 7)
            for cts in ((ct_y, None), (ct_y, ct_c), (None, ct_c)):
                with dt.policy(pol):
                    want = _autograd(mode, a, f, T, c0, *cts)
                    got = gen.oscillator_adjoint(mode, a, f, T, c0, *cts)
                    ref = (_ref64(mode, a, f, T, c0, *cts)
                           if mode != "Constant" and cts[0] is not None
                           else (None,) * 3)
                _held_to_autograd(got, want, ref, (mode, pol, T, label,
                                                   [c is None for c in cts]))


def test_adjoint_need_and_shapes():
    """``need`` drops a gradient; a clock0 of the batch's shape and a [B, 1]
    frequency (its gradient summed over T) take autograd's shapes."""
    T = 512
    rng = np.random.default_rng(3)
    a = torch.tensor(0.5)
    f = torch.from_numpy((200 + 50 * rng.standard_normal((B, 1)))
                         .astype(F32))
    c0 = torch.full((B,), 0.3)
    ct_y, ct_c = _cotangents("Sine", a, f, T, c0, 1)
    for need in ((True, False, True), (False, True, False)):
        got = gen.oscillator_adjoint("Sine", a, f, T, c0, ct_y, ct_c, need)
        want = _autograd("Sine", a, f, T, c0, ct_y, ct_c, need)
        for g, w in zip(got, want):
            assert (g is None) == (w is None)
            if w is not None:
                assert g.shape == w.shape and _err(g, w) <= AUTOGRAD_RTOL


@pytest.mark.parametrize("pol", POLICIES)
@pytest.mark.parametrize("mode", MODES)
def test_adjoint_against_jax(mode, pol):
    """oscillator_adjoint against jax.vjp of the JAX package's oscillator
    (rtol JAX_RTOL, max-normalized; the port's None as zeros), both
    cotangents given."""
    T = 1024
    for label, a, f, c0 in _cases(T, 11):
        ct_y, ct_c = _cotangents(mode, a, f, T, c0, 5)
        with jprec.policy(pol):
            _, vjp = jax.vjp(lambda a_, f_, c_: josc(mode, a_, f_, T, c_),
                             a.numpy(), f.numpy(), c0.numpy())
            want = vjp((ct_y.numpy(), ct_c.numpy()))
        with dt.policy(pol):
            got = gen.oscillator_adjoint(mode, a, f, T, c0, ct_y, ct_c)
        for k, (g, w) in enumerate(zip(got, want)):
            w = np.asarray(w)
            g = np.zeros_like(w) if g is None else g.numpy()
            assert g.shape == w.shape, (mode, pol, label, k)
            assert _err(g, w) <= JAX_RTOL, (mode, pol, label, k,
                                            _err(g, w))


# -- a model of the kernel's walk ---------------------------------------------

def _hex(src, name):
    m = re.search(rf"#define {name} (0x[0-9a-f.]+p[+-]\d+)f?\b", src)
    assert m, name
    return float.fromhex(m.group(1))


TAU = F32(_hex(OPS_SRC, "OSC_TAU"))
TWO_PI = F64(_hex(OPS_SRC, "OSC_TWO_PI"))
INV_TWO_PI = F64(_hex(OPS_SRC, "OSC_INV_TWO_PI"))


def _rem1(x):
    one = x.dtype.type(1.0)
    with np.errstate(invalid="ignore"):
        m = np.copysign(np.subtract(x, np.trunc(x)), x)
        return np.where(m < 0, m + one, m).astype(x.dtype)


def _tree(v):
    """orv_tree: the warp's xor tree over the last axis (32 lanes)."""
    v = np.asarray(v, F64)
    for o in (16, 8, 4, 2, 1):
        v = v[..., :o] + v[..., o:2 * o]
    return v[..., 0]


def _cta_sum(items):
    """orv_cta_sum over the summing CTA of items [n, m] (each item's values
    in order): thread t's items t, t + SUM_THREADS, ..., then the warps'
    trees, then the warps in order from 0.0."""
    n, m = items.shape
    tp = np.zeros(ork.SUM_THREADS)
    for b0 in range(0, n, ork.SUM_THREADS):
        chunk = items[b0:b0 + ork.SUM_THREADS]
        for i in range(m):
            tp[:len(chunk)] = tp[:len(chunk)] + chunk[:, i]
    w = _tree(tp.reshape(-1, 32))
    s = F64(0.0)
    for v in w:
        s = s + v
    return s


def _forward_clocks(mode, amp, freq, T, c0, crows):
    """The forward's block clocks [crows, nb] (the clock pass's; on the CPU
    the plain version's, bitwise: tests/test_torch_oscillator.py)."""
    lo = ok.layout(mode, amp, freq, T, c0)
    if mode == "Constant" or lo.nb == 1:
        return None
    _, cl, _ = gen._block_totals(freq, T, 128, int(SR), c0, CPU)
    cl = cl[..., ::128]
    if lo.one:
        return cl.reshape(1, lo.nb)
    lead = (1,) * (len(lo.batch) - len(lo.cbatch)) + tuple(lo.cbatch)
    return cl.reshape(*lead, lo.nb).expand(*lo.batch, lo.nb).reshape(
        crows, lo.nb).contiguous()


def _reverse_model(mode, amp, freq, T, c0, ct_y, ct_clock, need, pol):
    """The kernel's passes on plan_reverse's launch, in NumPy: A (a warp a
    (clock row, block): totals by the forward's sequential sum, the wave
    and its derivative, the rows' amplitude gradients and g_w, g_phase,
    each block's sum by lanes and the xor tree), B (the carry a clock row,
    chunked as the kernel takes it but in order; the fixed-order sums) and
    C (each lane's chain from the block's end).  Returns the gradients as
    the operands' shapes and the launch."""
    lo = ok.layout(mode, amp, freq, T, c0)
    crows = lo.rows if mode == "Constant" else lo.crows
    clocks = _forward_clocks(mode, amp, freq, T, c0, crows)
    ln = ork.plan_reverse(mode, amp, freq, T, c0, ct_y, ct_clock, need,
                          clocks)
    exact = pol != "fast"
    rows, nb, bl = ln.rows, ln.nb, 128
    one = crows == rows
    sr = F32(SR)

    def over(t, sb, st, n):
        a = t.numpy()
        r = np.arange(n)[:, None] * (1 if sb else 0)
        c = np.arange(T)[None, :] * st
        return a[np.minimum(r, a.shape[0] - 1), np.minimum(c, a.shape[1] - 1)]

    gp = np.zeros((crows, nb, bl), F32)
    if ln.passes & 1:
        amp2 = over(ln.amp, ln.a_sb, ln.a_st, rows).reshape(rows, nb, bl)
        ct = ln.ct.numpy().reshape(rows, nb, bl)
        if mode == "Constant":
            wv = np.ones((crows, nb, bl), F32)
        else:
            steps = np.divide(over(ln.freq, ln.f_sb, ln.f_st, crows),
                              sr).reshape(crows, nb, bl)
            tot = np.empty((crows, nb, bl), F32)
            for lane in range(32):             # osc_totals
                acc = np.zeros((crows, nb), F32)
                for q in range(lane):
                    for j in range(4):
                        acc = acc + steps[:, :, 4 * q + j]
                for j in range(4):
                    acc = acc + steps[:, :, 4 * lane + j]
                    tot[:, :, 4 * lane + j] = acc
            if ln.clocks is not None:
                clock = ln.clocks.numpy()
            else:
                c0r = ln.c0.numpy()
                clock = (c0r if exact else _rem1(c0r.astype(F64) + F64(0.0))
                         .astype(F32))[:, None]
            phase = (clock[:, :, None] + tot).astype(F32)
            if mode == "Sine":
                arg = (phase * TAU).astype(F32)
                if exact:
                    red = arg.astype(F64)
                    red = red - TWO_PI * np.rint(red * INV_TWO_PI)
                    wv = torch.sin(torch.from_numpy(red)).numpy().astype(F32)
                else:
                    wv = torch.sin(torch.from_numpy(arg)).numpy()
            elif mode == "Triangle":
                wv = (F32(2.0) * _rem1(phase) - F32(1.0)).astype(F32)
            else:
                wv = np.where(tot > F32(0.5), F32(1.0), F32(-1.0))
        crow = np.arange(rows) if one else np.zeros(rows, np.int64)
        ge = (ct * wv[crow]).astype(F32)                 # [rows, nb, 128]
        if ln.ga == ork.ELEM:
            ln.g_amp.numpy()[:] = ge.reshape(rows, T)
        elif ln.ga == ork.SUM:
            lanes = np.zeros((crows, nb, 32))
            for r in range(rows):                       # rows, then samples
                lg = ge[r].astype(F64).reshape(nb, 32, 4)
                for j in range(4):
                    lanes[crow[r]] = lanes[crow[r]] + lg[..., j]
            ln.pamp.numpy()[:] = _tree(lanes).reshape(-1)
        if ln.gclk is not None:
            p = (ct * amp2).astype(F32)
            if one:
                gw = p
            else:
                s = np.zeros((nb, bl))
                for r in range(rows):
                    s = s + p[r].astype(F64)
                gw = s.astype(F32)[None]
            if mode == "Triangle":
                gp = (gw * F32(2.0)).astype(F32)
            elif exact:
                gp = ((gw.astype(F64) * np.cos(red) + 0.0).astype(F32)
                      * TAU).astype(F32)
            else:
                cos = torch.cos(torch.from_numpy(arg)).numpy()
                gp = ((gw * cos).astype(F32) * TAU).astype(F32)
            if ln.gph is not None:
                ln.gph.numpy()[:] = gp.reshape(crows, T)
            lanes = np.zeros((crows, nb, 32))
            g4 = gp.astype(F64).reshape(crows, nb, 32, 4)
            for j in range(4):
                lanes = lanes + g4[..., j]
            ln.gclk.numpy()[:] = _tree(lanes).astype(F32).reshape(-1)
    if ln.passes & 2:
        gclk = (ln.gclk.numpy().reshape(crows, nb) if ln.gclk is not None
                else np.zeros((crows, nb), F32))
        ctc = (ln.ct_clock.numpy() if ln.ct_clock is not None
               else np.zeros(crows, F32))
        gbs = np.empty((crows, nb), F32)
        g0 = np.empty(crows, F32)
        if ln.gf != ork.NONE or ln.gc:
            for cr in range(crows):                   # orv_carry
                g, r = F32(ctc[cr]), F64(0.0) + F64(ctc[cr])
                for k in range(nb - 1, -1, -1):
                    if exact:
                        gbs[cr, k] = g
                        g = F32(gclk[cr, k] + g)
                    else:
                        gbs[cr, k] = F32(r)
                        r = r + F64(gclk[cr, k])
                g0[cr] = g if exact else F32(r)
            if ln.gbs is not None:
                ln.gbs.numpy()[:] = gbs.reshape(-1)
        if ln.gc:
            if ln.c0_shared:
                s = F64(0.0)
                for cr in range(crows):
                    s = s + F64(g0[cr])
                ln.g_c0.numpy()[:] = F32(s)
            else:
                ln.g_c0.numpy()[:] = g0
        if ln.ga == ork.SUM:
            ln.g_amp.numpy()[:] = F32(_cta_sum(ln.pamp.numpy()[:, None]))
        if ln.gf == ork.SUM:
            chains = np.empty((crows * nb, bl), F64)
            acc = gbs.reshape(-1)
            gpf = gp.reshape(crows * nb, bl)
            for i in range(bl - 1, -1, -1):
                acc = (gpf[:, i] + acc).astype(F32)
                chains[:, bl - 1 - i] = acc
            ln.g_freq.numpy()[:] = np.divide(F32(_cta_sum(chains)), sr)
    if ln.passes & 4:
        acc = gbs.reshape(crows, nb)
        g_step = np.empty((crows, nb, bl), F32)
        for i in range(bl - 1, -1, -1):            # lane L from the end
            acc = (gp[:, :, i] + acc).astype(F32)
            g_step[:, :, i] = acc
        ln.g_freq.numpy()[:] = np.divide(g_step, sr).reshape(crows, T)
    return ork.shaped_grads(ln, mode, ct_clock, need), ln


def _native(a, f, c0, T) -> bool:
    """Whether the kernel takes the operands as they are (no expansion
    summed back by the wrapper)."""
    lo = ok.layout("Sine", a, f, T, c0)
    return ((a.numel() == 1 or (lo.a_st and (lo.a_sb or lo.rows == 1)))
            and (f.numel() == 1 or (lo.f_st and (lo.f_sb or lo.crows == 1))))


@pytest.mark.parametrize("pol", POLICIES)
@pytest.mark.parametrize("mode", MODES)
def test_reverse_model_is_the_plain_adjoint(mode, pol):
    """The model of the kernel's walk against oscillator_adjoint: bitwise
    for the operand forms the kernel takes as they are (the listed
    shapes, and a [B] and a shared clock0 over [B, T] rows), rtol
    SUM_RTOL where the wrapper expands a [T] frequency over the clock
    rows and sums its gradient back; the passes each call launches."""
    for T in (128, 1024):
        cases = _cases(T, T + 1) + [
            ("frequency [B, T], clock0 [B]", torch.tensor(0.4),
             _freqs(T, 2)["[B, T]"], torch.linspace(0.0, 0.9, B)),
            ("frequency [T], clock0 [B]", torch.tensor(0.4),
             _freqs(T, 2)["[T]"], torch.linspace(0.0, 0.9, B))]
        for label, a, f, c0 in cases:
            ct_y, ct_c = _cotangents(mode, a, f, T, c0, 3)
            for cts in ((ct_y, None), (ct_y, ct_c), (None, ct_c)):
                need = (True, True, True)
                with dt.policy(pol):
                    got, ln = _reverse_model(mode, a, f, T, c0, *cts, need,
                                             pol)
                    want = gen.oscillator_adjoint(mode, a, f, T, c0, *cts,
                                                  need)
                what = (mode, pol, T, label, [c is None for c in cts])
                for g, w in zip(got, want):
                    assert (g is None) == (w is None), what
                    if w is None:
                        continue
                    assert g.shape == w.shape, what
                    if _native(a, f, c0, T):
                        assert _same(g, w), what
                    else:
                        assert _err(g, w) <= SUM_RTOL, what
                wave = mode in ("Sine", "Triangle") and cts[0] is not None
                assert bool(ln.passes & 4) == (
                    ln.gf == ork.ELEM and mode != "Constant"
                    and (wave or cts[1] is not None)), what


def test_model_statements_are_the_kernels():
    """The model's geometry and statements are the CUDA source's."""
    assert re.search(rf"#define ORV_WARPS {ork.WARPS}\b", SRC)
    assert re.search(rf"#define ORV_SUM_THREADS {ork.SUM_THREADS}\b", SRC)
    assert re.search(r"#define ORV_NONE 0\b", SRC)
    assert re.search(rf"#define ORV_ELEM {ork.ELEM}\b", SRC)
    assert re.search(rf"#define ORV_SUM {ork.SUM}\b", SRC)
    assert ork.SUM_THREADS == gen.SUM_THREADS
    for stmt in (
            # pass A
            "osc_totals(sm, lane, s, tot);",
            "clock = a.clocks[cr * nb + k];",
            "clock = a.exact ? c0",
            ": __double2float_rn(osc_rem1(__dadd_rn((double)c0, 0.0)));",
            "arg[j] = __fmul_rn(ph, OSC_TAU);",
            "wv[j] = __double2float_rn(sin(r));",
            "wv[j] = sinf(arg[j]);",
            "wv[j] = __fsub_rn(__fmul_rn(2.0f, osc_rem1(ph)), 1.0f);",
            "wv[j] = tot[j] > 0.5f ? 1.0f : -1.0f;",
            "for (int j = 0; j < 4; ++j) wv[j] = 1.0f;",
            "const long long r0 = one ? cr : 0, r1 = one ? cr + 1 : a.rows;",
            "for (int j = 0; j < 4; ++j) ge[j] = __fmul_rn(ct[j], wv[j]);",
            "for (int j = 0; j < 4; ++j) pa = __dadd_rn(pa, (double)ge[j]);",
            "gw64[j] = __dadd_rn(gw64[j], (double)p);",
            "if (!one) gw[j] = __double2float_rn(gw64[j]);",
            "gp[j] = __fmul_rn(gw[j], 2.0f);",
            "__dmul_rn((double)gw[j], cos(red[j])), 0.0)), OSC_TAU);",
            "gp[j] = __fmul_rn(__fmul_rn(gw[j], cosf(arg[j])), OSC_TAU);",
            "bsum = __dadd_rn(bsum, (double)gp[j]);",
            "if (lane == 0) a.gclk[w] = __double2float_rn(bsum);",
            "v = __dadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));",
            # pass B
            "double r = __dadd_rn(0.0, (double)ctc);",
            "slot[j] = g;",
            "g = __fadd_rn(x, g);",
            "slot[j] = __double2float_rn(r);",
            "r = __dadd_rn(r, (double)x);",
            "return EXACT ? g : __double2float_rn(r);",
            "s = __dadd_rn(s, (double)a.gc0r[cr]);",
            "for (int w = 0; w < ORV_SUM_THREADS / 32; ++w) "
            "s = __dadd_rn(s, sh[w]);",
            "for (long long i = threadIdx.x; i < n; i += ORV_SUM_THREADS)",
            "for (int q = OSC_BLOCK / 4 - 1; q >= 0; --q) {",
            "acc = __fadd_rn(g[j], acc);",
            "v = __dadd_rn(v, (double)acc);",
            "a.g_freq[0] = __fdiv_rn(__double2float_rn(v), a.sr);",
            # pass C
            "for (int q = 31; q > lane; --q) {",
            "acc = __fadd_rn(v.w, acc);",
            "acc = __fadd_rn(gp[j], acc);",
            "gs[j] = __fdiv_rn(acc, a.sr);"):
        assert stmt in SRC, stmt


def test_plan_refuses_what_the_kernel_cannot_take():
    a, f, c0 = torch.tensor(0.5), torch.tensor(440.0), torch.tensor(0.0)
    ct = torch.zeros(512)
    with pytest.raises(ValueError, match="block clocks"):
        ork.plan_reverse("Sine", a, f, 512, c0, ct, None, (True,) * 3, None)
    with pytest.raises(ValueError, match="multiple of 128"):
        ork.plan_reverse("Sine", a, f, 200, c0, torch.zeros(200), None,
                         (True,) * 3, None)
    with pytest.raises(ValueError, match="CUDA"):
        ork.oscillator_reverse_cuda("Sine", a, f, 512, c0, ct, None,
                                    (True,) * 3, torch.zeros(1, 4))
    # nothing reaches the frequency: no launch but the amplitude's
    ln = ork.plan_reverse("Square", a, f, 512, c0, ct, None, (True,) * 3,
                          torch.zeros(1, 4))
    assert ln.gf == ork.NONE and not ln.gc and ln.passes == 3
    assert ork.passes_of(ln.passes) == 2


# -- the card's route ---------------------------------------------------------

def _model_forward(mode, amp, freq, T, clock0):
    """The forward kernel's stand-in on the CPU (its plain version, bitwise
    it: tests/test_torch_oscillator.py), with its block clocks."""
    y, c = gen.oscillator_plain(mode, amp, freq, T, clock0)
    return y, c, None


def _model_backward(mode, amp, freq, T, clock0, ct_y, ct_clock, need, kept,
                    sample_rate):
    """The reverse kernel's stand-in: the model of its walk."""
    return _reverse_model(mode, amp, freq, T, clock0, ct_y, ct_clock, need,
                          tprec.get_policy().name)[0]


@pytest.mark.parametrize("pol", POLICIES)
@pytest.mark.parametrize("mode", MODES)
def test_function_route(mode, pol):
    """gen.run along the card's route (the forward's stand-in, the model of
    the reverse kernel as the backward, and the plain adjoint as the
    backward): a loss through a downstream node and the final clock; the
    model's gradients bitwise the plain adjoint's, both within
    AUTOGRAD_RTOL of autograd through the plain version, and the
    Function's own recompute (no backward given) bitwise that autograd."""
    T = 512
    rng = np.random.default_rng(31)
    x0 = torch.from_numpy(rng.standard_normal((B, T)).astype(F32))
    w = torch.from_numpy(rng.standard_normal((B, T)).astype(F32))
    wc = torch.tensor(0.7)
    got = {}
    for route in ("model", "adjoint", "recompute", "plain"):
        a = torch.tensor(0.6, requires_grad=True)
        f = torch.tensor(331.0, requires_grad=True)
        c0 = torch.tensor(0.25, requires_grad=True)
        x = x0.clone().requires_grad_(True)
        with dt.policy(pol):
            if route == "plain":
                y, c = gen.oscillator_plain(mode, a, f, T, c0)
            else:
                back = {"model": _model_backward,
                        "adjoint": gen.adjoint_backward}.get(route)
                y, c = gen.run(_model_forward, mode, a, f, T, c0,
                               backward=back)
                assert type(y.grad_fn).__name__.startswith("Oscillator")
            loss = ((y * x) * w).sum() + c.sum() * wc
            loss.backward()
        got[route] = [t.grad for t in (a, f, c0, x)]
    for g, h in zip(got["model"], got["adjoint"]):
        assert (g is None) == (h is None) and (g is None or _same(g, h))
    for g, h in zip(got["recompute"], got["plain"]):
        assert (g is None) == (h is None) and (g is None or _same(g, h))
    for g, h in zip(got["adjoint"], got["plain"]):
        assert (g is None) == (h is None), mode
        if h is not None:
            assert _err(g, h) <= AUTOGRAD_RTOL, (mode, pol)


def test_oscillator_on_the_card_device_takes_the_reverse_kernel(monkeypatch):
    """gen.oscillator on a CUDA device hands gen.run the kernel forward
    with its block clocks and the reverse kernel as the backward."""
    seen = {}

    def run(forward, mode, amp, freq, T, clock0, sample_rate=48_000,
            backward=None):
        seen["backward"] = backward
        return None, None
    monkeypatch.setattr(gen, "run", run)
    monkeypatch.setattr(gen, "on_device", lambda v, d, dtype=None: v)
    gen.oscillator("Sine", torch.tensor(0.5), torch.tensor(440.0), 256,
                   torch.tensor(0.0), device="cuda")
    assert seen["backward"] is ork.oscillator_reverse_cuda


def test_config5_lfo_gradients_through_the_route(monkeypatch):
    """config5's loss gradients with respect to its LFO's amplitude and
    frequency sliders (and the input), the signal generator through
    gen.run with the plain adjoint as its backward, the recompute never
    run: against jax.grad of the JAX package's make_loss_fn (rtol
    JAX_RTOL), parity."""
    gj, meta = jpresets.config5_feedback_16node()
    gt = dt.loads_graph(dj.dumps_graph(gj), ids=TIdSpace())
    inp = str(meta["input"])
    lfo = str(min(n.id for n in gj.nodes.values()
                  if n.cfg_name == "signal_gen"))
    T = 1024
    rng = np.random.default_rng(23)
    x = (rng.standard_normal((2, T)) * 0.25).astype(F32)
    target = (rng.standard_normal((2, 1, T)) * 0.1).astype(F32)
    with jprec.policy("parity"):
        cgj = dj.compile_graph(gj)
        pj = {lfo: {k: cgj.init_params()[lfo][k]
                    for k in ("amplitude", "frequency")}}
        gp, gx = jax.jit(jax.grad(jfit.make_loss_fn(cgj), argnums=(0, 2)))(
            pj, cgj.init_state(), {inp: x}, target)
    calls = {"backward": 0}

    def backward(*a):
        calls["backward"] += 1
        return gen.adjoint_backward(*a)

    def osc(mode, amplitude, frequency, T_, clock0=0.0, block_size=128,
            sample_rate=48_000, device=None):
        device = gen._device_of(device, amplitude, frequency, clock0)
        amp, freq, c0 = (tprec.on_device(v, device)
                         for v in (amplitude, frequency, clock0))
        return gen.run(_model_forward, mode, amp, freq, T_, c0, sample_rate,
                       backward)
    monkeypatch.setattr("dsp_stuff_tpu_torch.nodes.gen.oscillator", osc)
    monkeypatch.setattr(gen, "oscillator_plain", _no_recompute(
        gen.oscillator_plain))
    cgt = dt.compile_graph(gt, device="cpu")
    pt = {lfo: {k: torch.tensor(float(np.asarray(v)), requires_grad=True)
                for k, v in pj[lfo].items()}}
    xt = torch.tensor(x, requires_grad=True)
    with tprec.policy("parity"):
        loss = tfit.make_loss_fn(cgt)(pt, cgt.init_state(), {inp: xt},
                                      torch.from_numpy(target))
        loss.backward()
    assert calls["backward"] == 1
    for k in ("amplitude", "frequency"):
        g = pt[lfo][k].grad
        assert g is not None and _err(g, gp[lfo][k]) <= JAX_RTOL, k
    assert _err(xt.grad, gx[inp]) <= JAX_RTOL


def _no_recompute(plain):
    """oscillator_plain that refuses to run under grad mode (the recompute
    the reverse kernel replaced)."""
    def call(*a, **k):
        assert not torch.is_grad_enabled() or not any(
            isinstance(t, torch.Tensor) and t.requires_grad
            for t in (*a, *k.values())), "the plain version recomputed"
        return plain(*a, **k)
    return call
