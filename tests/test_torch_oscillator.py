"""The signal generator's oscillator kernel (csrc/oscillator_kernel.cu,
ops/oscillator_kernel.py) on the CPU, where its plain version runs.  The
kernel itself runs only on the card (chip_smoke.py's oscillator_phase);
here:

* a NumPy model of the kernel's walk on the launch that
  ``oscillator_kernel.plan`` lays out: the clock pass (each block's
  128-step sum from 0, then the carry over the blocks: the f32 add and
  remainder under parity and exact, the f64 running sum under fast) and
  the wave pass (a warp a (row, block), each lane's totals recomputed by
  the sequential sum from the block start, then the wave), its constants
  and statements pinned to the CUDA source: bitwise
  ``gen.oscillator_plain`` for the four modes under the three policies, a
  slider, a [T] and a [B, T] frequency, amplitude 0-d and [B, T], clock0
  0 and 0.25, T = 128, 256 and 2,048, and two chained calls;
* the range reduction's multiply by 1 / (2 pi) (CUDA's divide by a Python
  float) against the CPU's divide, for every f32 argument below 2^20;
* the kernel's remainder (x - trunc(x), its zero's sign, + 1 below 0)
  against torch.remainder;
* the autograd Function driven along the card's route with the model as
  its forward: outputs and gradients (amplitude, frequency, a downstream
  node's input) bitwise autograd through the plain version;
* config5 rendered, streamed and through its feedback cycle's per-node
  loop with the signal generator on the card's route (the model through
  the Function's dispatch), bitwise the plain route under the three
  policies;
* the plain version against the JAX package's oscillator, and the LFO
  rendered from a clock carried over from the JAX package's state.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

import dsp_stuff_tpu_torch as dt
from dsp_stuff_tpu_torch.ops import gen
from dsp_stuff_tpu_torch.ops import oscillator_kernel as ok
from dsp_stuff_tpu_torch.utils import precision as tprec

POLICIES = ["fast", "parity", "exact"]
MODES = ["Sine", "Triangle", "Square", "Constant"]
B = 3
CPU = torch.device("cpu")
F32, F64 = np.float32, np.float64
CSRC = pathlib.Path(ok.__file__).resolve().parent.parent / "csrc"
SRC = ((CSRC / "oscillator_kernel.cu").read_text()
       + (CSRC / "oscillator_ops.cuh").read_text())


@pytest.fixture(autouse=True)
def _torch_env():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    prev = tprec.get_policy()
    yield
    tprec.set_policy(prev)
    torch.set_num_threads(threads)


def _same(got, want) -> bool:
    """Bit for bit, NaN at the same samples."""
    got, want = torch.as_tensor(got), torch.as_tensor(want)
    if got.shape != want.shape or got.dtype != want.dtype:
        return False
    nan = torch.isnan(want)
    return bool(torch.equal(torch.isnan(got), nan) and torch.equal(
        got[~nan].view(torch.int32), want[~nan].view(torch.int32)))


def _hex(name):
    """The value of a hex-float ``#define`` of the CUDA source."""
    m = re.search(rf"#define {name} (0x[0-9a-f.]+p[+-]\d+)f?\b", SRC)
    assert m, name
    return float.fromhex(m.group(1))


TAU = F32(_hex("OSC_TAU"))
TWO_PI = F64(_hex("OSC_TWO_PI"))
INV_TWO_PI = F64(_hex("OSC_INV_TWO_PI"))


def _rem1(x):
    """The kernel's osc_rem1: copysign(x - trunc(x), x), + 1 below 0."""
    one = x.dtype.type(1.0)
    with np.errstate(invalid="ignore"):
        m = np.copysign(np.subtract(x, np.trunc(x)), x)
        return np.where(m < 0, m + one, m).astype(x.dtype)


def _carry_rem1(x):
    """The parity carry's short remainder (osc_carry_chunk): x, or x - 1
    for x in [1, 2); the kernel takes it where x lies in [0, 2)."""
    x = np.asarray(x, F32)
    return x - F32(1.0) if x >= 1.0 else x


def _exact_carry(c0, bsum):
    """osc_carry<true> over one row's block sums: chunks of 32 blocks,
    each the short chain, run again through osc_rem1 from the chunk's
    start where an x left [0, 2).  Returns (clocks, final clock)."""
    clocks = np.empty(len(bsum), F32)
    c = F32(c0)
    for base in range(0, len(bsum), 32):
        start, ok = c, True
        for k in range(base, min(base + 32, len(bsum))):
            x = np.asarray(c + bsum[k], F32)
            clocks[k] = c
            ok &= bool(0.0 <= x < 2.0)
            c = _carry_rem1(x)
        if not ok:
            c = start
            for k in range(base, min(base + 32, len(bsum))):
                clocks[k] = c
                c = _rem1(np.asarray(c + bsum[k], F32))
    return clocks, c


def _kernel_model(mode, amp, freq, T, clock0, pol, sr=48_000.0):
    """The kernel's two passes (or its one, ``fused``) on ``plan``'s
    launch, in NumPy: returns (wave, final clock) shaped as the plan's
    outputs."""
    ln = ok.plan(mode, amp, freq, T, clock0)
    exact = pol != "fast"
    nb, rows, crows = ln.nb, ln.rows, ln.crows
    bl = ok.BLOCK

    def rows_of(t, sb, st, n):
        """[n, T] of a [rows or 1, T or 1] operand by its strides."""
        a = t.numpy()
        r = np.arange(n)[:, None] * (1 if sb else 0)
        c = np.arange(T)[None, :] * st
        return a[np.minimum(r, a.shape[0] - 1), c]

    amp2 = rows_of(ln.amp, ln.a_sb, ln.a_st, rows)
    y = np.empty((rows, T), F32)
    if mode == "Constant":
        y[:] = amp2 * F32(1.0)
        return torch.from_numpy(y).reshape(ln.out.shape), clock0
    steps = np.divide(rows_of(ln.freq, ln.f_sb, ln.f_st, crows), F32(sr))
    sb = steps.reshape(crows, nb, bl)
    c0 = ln.c0.numpy()
    final = np.empty(crows, F32)
    if ln.fused:
        clocks = None
    else:
        # the clock pass: a thread a block, 128 sequential adds from 0
        bsum = np.zeros((crows, nb), F32)
        for i in range(bl):
            bsum = bsum + sb[:, :, i]
        clocks = np.empty((crows, nb), F32)
        for r in range(crows):                   # warp 0's carry
            if exact:
                clocks[r], final[r] = _exact_carry(c0[r], bsum[r])
            else:
                c0d, s = F64(c0[r]), F64(0.0)
                for k in range(nb):
                    clocks[r, k] = F32(_rem1(np.asarray(c0d + s)))
                    s = s + F64(bsum[r, k])
                final[r] = F32(_rem1(np.asarray(c0d + s)))
    # the wave pass: lane L of the warp of (row, block k) takes samples
    # 4L .. 4L + 3, its total the steps of lanes 0 .. L - 1 then its own
    crow = np.zeros(rows, np.int64) if crows == 1 else np.arange(rows)
    st = sb[crow]                                      # [rows, nb, 128]
    tot = np.empty((rows, nb, bl), F32)
    for lane in range(32):
        acc = np.zeros((rows, nb), F32)
        for q in range(lane):
            for j in range(4):
                acc = acc + st[:, :, 4 * q + j]
        for j in range(4):
            acc = acc + st[:, :, 4 * lane + j]
            tot[:, :, 4 * lane + j] = acc
    if ln.fused:
        c0r = c0[crow]
        clock = (c0r if exact else
                 _rem1(c0r.astype(F64) + F64(0.0)).astype(F32))
        bs = tot[:, 0, -1]
        fin = (_rem1((c0r + bs).astype(F32)) if exact else
               _rem1(c0r.astype(F64) + (F64(0.0) + bs.astype(F64)))
               .astype(F32))
        keep = np.arange(rows) if crows != 1 else np.array([0])
        final[:] = fin[keep][:crows]
        ck = np.broadcast_to(clock[:, None, None], tot.shape)
    else:
        ck = np.broadcast_to(clocks[crow][:, :, None], tot.shape)
    phase = (ck + tot).astype(F32)
    a = amp2.reshape(rows, nb, bl)
    if mode == "Sine":
        arg = (phase * TAU).astype(F32)
        if exact:
            r = arg.astype(F64)
            r = r - TWO_PI * np.rint(r * INV_TWO_PI)
            s = torch.sin(torch.from_numpy(r)).numpy().astype(F32)
        else:
            s = torch.sin(torch.from_numpy(arg)).numpy()
        w = (s * a).astype(F32)
    elif mode == "Triangle":
        w = ((F32(2.0) * _rem1(phase) - F32(1.0)) * a).astype(F32)
    else:
        w = (np.where(tot > F32(0.5), F32(1.0), F32(-1.0)) * a).astype(F32)
    y[:] = w.reshape(rows, T)
    out = torch.from_numpy(y).reshape(ln.out.shape)
    fin_t = torch.from_numpy(final)
    if crows == 1:
        return out, fin_t.reshape(ln.out_clock.shape)
    lead = ln.out.shape[:-1]
    cb = ln.out_clock.shape
    full = fin_t.reshape(lead)
    idx = tuple(slice(0, 1) if c == 1 and b != 1 else slice(None)
                for c, b in zip((1,) * (len(lead) - len(cb)) + tuple(cb),
                                lead))
    return out, full[idx].reshape(cb)


def _freqs(T, seed):
    rng = np.random.default_rng(seed)
    one = (300.0 + 250.0 * np.sin(np.arange(T) / 37.0)).astype(F32)
    many = (300.0 + 400.0 * rng.standard_normal((B, T))).astype(F32)
    return {"slider 0.5 Hz": 0.5, "slider 997 Hz": 997.0,
            "[T]": torch.from_numpy(one), "[B, T]": torch.from_numpy(many)}


def _amps(T, seed):
    rng = np.random.default_rng(seed + 1)
    return {"0-d": 0.7, "[B, T]": torch.from_numpy(
        rng.uniform(-1.0, 1.0, (B, T)).astype(F32))}


def _t(v):
    return tprec.on_device(v, CPU)


@pytest.mark.parametrize("T", [128, 256, 2048])
@pytest.mark.parametrize("pol", POLICIES)
@pytest.mark.parametrize("mode", MODES)
def test_kernel_model_is_the_plain_version(mode, pol, T):
    """The model of the kernel's walk is bitwise oscillator_plain, wave and
    final clock, for every frequency and amplitude form and both clocks
    (a fresh clock and one carried mid-cycle), its launch count the
    kernel's."""
    for fk, f in _freqs(T, T).items():
        for ak, a in _amps(T, T).items():
            for c in (0.0, 0.25):
                with dt.policy(pol):
                    want = gen.oscillator_plain(mode, a, f, T,
                                                torch.tensor(c))
                    got = _kernel_model(mode, _t(a), _t(f), T,
                                        torch.tensor(c), pol)
                what = (mode, pol, T, fk, ak, c)
                assert _same(got[0], want[0]), what
                assert _same(got[1], want[1]), what
    assert ok.launches_for(mode, T) == (1 if mode == "Constant" or T == 128
                                        else 2)


@pytest.mark.parametrize("pol", POLICIES)
@pytest.mark.parametrize("mode", MODES[:3])
def test_two_chained_calls(mode, pol):
    """Two calls of 1,024 and 896 samples, the second from the first's
    final clock (a stream's blocks, a render's handoff), against one of
    1,920: the model bitwise the plain version on each call, and under
    parity and exact the chain bitwise the one call (the f32 clock carries
    over exactly); under fast the second call starts from the rounded
    f32 clock, within 2 f32 ulps of the one call's f64 sum."""
    n1, n2 = 1024, 896
    f = _freqs(n1 + n2, 5)["[B, T]"]
    c0 = torch.full((B,), 0.25)
    with dt.policy(pol):
        one = gen.oscillator_plain(mode, 0.6, f, n1 + n2, c0)
        a = _kernel_model(mode, _t(0.6), f[:, :n1], n1, c0, pol)
        b = _kernel_model(mode, _t(0.6), f[:, n1:], n2, a[1], pol)
        pa = gen.oscillator_plain(mode, 0.6, f[:, :n1], n1, c0)
        pb = gen.oscillator_plain(mode, 0.6, f[:, n1:], n2, pa[1])
    for g, w in zip((*a, *b), (*pa, *pb)):
        assert _same(g, w)
    if pol != "fast":
        assert _same(torch.cat([a[0], b[0]], -1), one[0])
        assert _same(b[1], one[1])
    else:
        ulp = np.spacing(np.abs(one[1].numpy()).astype(F32))
        assert (np.abs(b[1].numpy() - one[1].numpy()) <= 2 * ulp).all()


def test_kernel_model_batches():
    """Batches the plan lays out otherwise: a [B] clock beside a slider
    frequency (the clock rows the output's), a [B, 1, T] frequency beside
    a [1, 2, T] amplitude (the clock batch spans part of the output's:
    expanded, its final clock taken back), a [B, 1] frequency (time
    stride 0)."""
    T = 384
    rng = np.random.default_rng(3)
    f3 = torch.from_numpy((300 + 100 * rng.standard_normal((B, 1, T)))
                          .astype(F32))
    a2 = torch.from_numpy(rng.uniform(-1, 1, (1, 2, T)).astype(F32))
    fb1 = torch.from_numpy((200 + 50 * rng.standard_normal((B, 1)))
                           .astype(F32))
    cases = [(0.5, _t(440.0), torch.full((B,), 0.3)),
             (a2, f3, torch.tensor(0.1)),
             (0.5, fb1, torch.tensor(0.0))]
    for pol in POLICIES:
        for mode in MODES:
            for a, f, c in cases:
                with dt.policy(pol):
                    want = gen.oscillator_plain(mode, a, f, T, c)
                    got = _kernel_model(mode, _t(a), _t(f), T, c, pol)
                assert _same(got[0], want[0]), (mode, pol)
                assert _same(got[1], want[1]), (mode, pol)


def test_plan_refuses_what_the_kernel_cannot_take():
    a, f, c = _t(0.5), _t(440.0), torch.tensor(0.0)
    with pytest.raises(ValueError, match="multiple of 128"):
        ok.plan("Sine", a, f, 200, c)
    with pytest.raises(ValueError, match="float32"):
        ok.plan("Sine", a, f.double(), 256, c)
    with pytest.raises(ValueError, match="frequency of shape"):
        ok.plan("Sine", a, torch.ones(3, 100), 256, c)
    with pytest.raises(ValueError):
        ok.plan("Saw", a, f, 256, c)
    with pytest.raises(ValueError, match="CUDA"):
        ok.oscillator_cuda("Sine", a, f, 256, c, False)
    with pytest.raises(ValueError, match="no kernel"):
        gen.oscillator("Sine", 0.5, 440.0, 256, device="meta")


def test_model_constants_are_the_kernels():
    """The model's geometry, constants and statements are the CUDA
    source's."""
    assert re.search(rf"#define OSC_BLOCK {ok.BLOCK}\b", SRC)
    assert re.search(rf"#define OSC_CLOCK_THREADS {ok.CLOCK_THREADS}\b", SRC)
    assert re.search(rf"#define OSC_WAVE_WARPS {ok.WAVE_WARPS}\b", SRC)
    for mode, code in ok.MODES.items():
        assert re.search(rf"#define OSC_{mode.upper()} {code}\b", SRC)
    assert TAU == F32(float(np.float32(2.0 * np.pi))) == F32(gen.TAU)
    assert TWO_PI == F64(2.0 * np.pi)
    assert INV_TWO_PI == F64(1.0) / F64(2.0 * np.pi)
    for stmt in (
            # the remainder, the step, the sums and the carries
            "float m = copysignf(__fsub_rn(x, truncf(x)), x);",
            "return m < 0.0f ? __fadd_rn(m, 1.0f) : m;",
            "return __fdiv_rn(a.freq[cr * a.f_sb + t * a.f_st], a.sr);",
            "for (int i = 0; i < OSC_BLOCK; ++i) acc = __fadd_rn(acc, s);",
            "const float x = __fadd_rn(c, __shfl_sync(0xffffffffu, mine, j));",
            "in_range &= x >= 0.0f && x < 2.0f;",
            "c = x >= 1.0f ? __fsub_rn(x, 1.0f) : x;",
            "c = osc_rem1(__fadd_rn(c, __shfl_sync(0xffffffffu, mine, j)));",
            ": __double2float_rn(osc_rem1(__dadd_rn(c0d, carry_s[lane])));",
            "carry_s[j] = s;",
            "carry_c[j] = c;",
            "cl[base + lane] = EXACT ? carry_c[lane]",
            "const float bs = __shfl_sync(0xffffffffu, mine, j);",
            "s = __dadd_rn(s, (double)bs);",
            "for (int q = 0; q < lane; ++q) {",
            "for (int j = 0; j < 4; ++j) tot[j] = acc = __fadd_rn(acc, s[j]);",
            "const long long t0 = k * OSC_BLOCK + 4 * lane;",
            # the waves
            "const float arg = __fmul_rn(phase, OSC_TAU);",
            "if (!a.exact) return __fmul_rn(sinf(arg), amp);",
            "rint(__dmul_rn(r, OSC_INV_TWO_PI))));",
            "return __fmul_rn(__double2float_rn(sin(r)), amp);",
            "return __fmul_rn(__fsub_rn(__fmul_rn(2.0f, osc_rem1(phase)), "
            "1.0f), amp);",
            "return __fmul_rn(total > 0.5f ? 1.0f : -1.0f, amp);",
            "y[j] = __fmul_rn(amp[j], 1.0f);"):
        assert stmt in SRC, stmt


def test_range_reduction_multiply_is_the_divide():
    """The parity sine's ``round(a / (2 pi))``: the card (the eager op and
    the kernel) multiplies by the reciprocal of 2 pi, the CPU divides.
    Both quotients are monotone in a, so they round alike for every f32
    a unless one lies at a threshold where a / (2 pi) crosses a
    half-integer; the f32 values nearest every threshold below 2^20
    (phases up to about 166,000 cycles) round alike."""
    h = np.arange(0, 2.0**20 / (2 * np.pi) + 1) + 0.5
    x0 = (h * (2 * np.pi)).astype(F32)
    near = [x0]
    for _ in range(2):
        near += [np.nextafter(near[-2 if len(near) > 1 else 0],
                              F32(np.inf))]
    lo = np.nextafter(x0, F32(0))
    xs = np.concatenate([lo, np.nextafter(lo, F32(0)), *near])
    xs = np.concatenate([xs, -xs]).astype(F64)
    div = torch.round(torch.from_numpy(xs) / (2.0 * np.pi)).numpy()
    mul = np.rint(xs * INV_TWO_PI)
    assert (div == mul).all()


def test_remainder_is_torch_remainder():
    """osc_rem1 (as the model takes it) against torch.remainder(x, 1):
    around 0, 1 and past a wrap, tiny negatives (which round to 1.0),
    integers (the zero's sign), +-inf and NaN, in f32 and f64."""
    rng = np.random.default_rng(11)
    for dt_ in (F32, F64):
        tiny = np.finfo(dt_).tiny
        x = np.array([0.0, -0.0, 1e-9, -1e-9, 0.5, 1.0, -1.0, 2.0, -3.0,
                      2.0**23, -(2.0**23), 2.0**24 + 2, -(2.0**30), 2.0**60,
                      np.inf, -np.inf, np.nan, tiny, -tiny, 123.456,
                      -123.456], dt_)
        near1 = np.nextafter(np.array([1.0, -1.0, 0.0, 0.0], dt_),
                             np.array([0.0, 0.0, 1.0, -1.0], dt_))
        x = np.concatenate([x, near1, (rng.standard_normal(20000) * 40)
                            .astype(dt_)])
        want = torch.remainder(torch.from_numpy(x), 1.0).numpy()
        got = _rem1(x)
        if dt_ is F32:
            # the carry's short remainder where it takes it, [0, 2)
            inr = (x >= 0) & (x < 2)
            assert _same(torch.from_numpy(np.array(
                [_carry_rem1(v) for v in x[inr]], F32)),
                torch.from_numpy(want[inr]))
        nan = np.isnan(want)
        assert (np.isnan(got) == nan).all()
        assert (got[~nan].view(np.int32 if dt_ is F32 else np.int64)
                == want[~nan].view(np.int32 if dt_ is F32 else np.int64)
                ).all()


def _model_forward(pol):
    def fwd(mode, amp, freq, T, clock0):
        return _kernel_model(mode, amp, freq, T, clock0, pol)
    return fwd


@pytest.mark.parametrize("pol", POLICIES)
@pytest.mark.parametrize("mode", MODES)
def test_function_gradients_are_the_plain_versions(mode, pol):
    """gen.run with the model as the forward (the card's route): the
    Function's outputs are the plain version's, and the gradients of a
    loss through a downstream node (the LFO times a signal) with respect
    to the amplitude (a slider leaf and a [B, T] modulation), the
    frequency (a slider leaf) and the downstream input are bitwise
    autograd through oscillator_plain."""
    T = 512
    rng = np.random.default_rng(21)
    x0 = torch.from_numpy(rng.standard_normal((B, T)).astype(F32))
    w = torch.from_numpy(rng.standard_normal((B, T)).astype(F32))
    am0 = torch.from_numpy(rng.uniform(-1, 1, (B, T)).astype(F32))
    for amp_kind in ("slider", "[B, T]"):
        def leaves():
            a = (torch.tensor(0.6) if amp_kind == "slider"
                 else am0.clone()).requires_grad_(True)
            return (a, torch.tensor(331.0).requires_grad_(True),
                    x0.clone().requires_grad_(True))
        got_l, want_l = leaves(), leaves()
        c0 = torch.tensor(0.25)
        with dt.policy(pol):
            yg, cg = gen.run(_model_forward(pol), mode, got_l[0], got_l[1],
                             T, c0)
            yw, cw = gen.oscillator_plain(mode, want_l[0], want_l[1], T, c0)
            assert _same(yg, yw) and _same(cg, cw)
            assert yg.grad_fn is not None and type(yg.grad_fn).__name__ \
                .startswith("Oscillator")
            for y, (a, f, x) in ((yg, got_l), (yw, want_l)):
                ((y * x) * w).sum().backward()
        for g, wnt in zip(got_l, want_l):
            if wnt.grad is None:       # no path (Square, Constant: freq)
                assert g.grad is None, (mode, pol, amp_kind)
            else:
                assert _same(g.grad, wnt.grad), (mode, pol, amp_kind)


def test_function_outputs_do_not_alias_its_inputs():
    """Constant hands clock0 back; out of the Function it is a copy."""
    c0 = torch.tensor(0.4)
    a = torch.tensor(0.5, requires_grad=True)
    y, c = gen.run(_model_forward("fast"), "Constant", a, _t(1.0), 256, c0)
    assert c.data_ptr() != c0.data_ptr() and torch.equal(c.detach(), c0)
    y.sum().backward()
    assert float(a.grad) == 256.0


def _card_route(monkeypatch, pol):
    """gen.oscillator dispatched as on the card: every call through
    gen.run with the kernel model as its forward, counted."""
    calls = []

    def osc(mode, amplitude, frequency, T, clock0=0.0, block_size=128,
            sample_rate=48_000, device=None):
        device = gen._device_of(device, amplitude, frequency, clock0)
        amp, freq, c0 = (tprec.on_device(v, device)
                         for v in (amplitude, frequency, clock0))
        calls.append(T)
        return gen.run(_model_forward(tprec.get_policy().name), mode, amp,
                       freq, T, c0)
    monkeypatch.setattr("dsp_stuff_tpu_torch.nodes.gen.oscillator", osc)
    return calls


@pytest.mark.parametrize("pol", POLICIES)
def test_config5_on_the_card_route_is_the_plain_route(pol, monkeypatch):
    """config5 (its LFO into the overdrive's drive) rendered at [2, 1280],
    streamed in ten 128-sample blocks and through its feedback cycle's
    per-node scan (CYCLE_FUSION off: the LFO outside the cycle, once),
    with the signal generator on the card's route: bitwise the plain
    route (the parent's ops) in outputs, aux and state."""
    from dsp_stuff_tpu_torch.compiler import compile as tcomp
    from dsp_stuff_tpu_torch.models import presets
    g, meta = presets.config5_feedback_16node()
    rng = np.random.default_rng(9)
    x = torch.from_numpy((rng.standard_normal((2, 1, 1280)) * 0.3)
                         .astype(F32))

    def renders():
        cg = dt.compile_graph(g, device="cpu")
        with dt.policy(pol):
            y, aux, st = cg.render(x, batch_shape=(2,))
            s = dt.StreamSession(g, device="cpu")
            blocks = [s.process({str(meta["input"]): x[0, 0, 128 * k:
                                                       128 * (k + 1)]
                                 .numpy()}) for k in range(10)]
        return y, aux, st, blocks

    def leaves(tree):
        if isinstance(tree, dict):
            return [v for k in sorted(tree, key=str)
                    for v in leaves(tree[k])]
        if isinstance(tree, (list, tuple)):
            return [v for t in tree for v in leaves(t)]
        return [tree] if isinstance(tree, (torch.Tensor, np.ndarray)) \
            else []

    for fusion in (True, False):
        monkeypatch.setattr(tcomp, "CYCLE_FUSION", fusion)
        want = renders()
        with monkeypatch.context() as m:
            calls = _card_route(m, pol)
            got = renders()
        assert calls and 1280 in calls and calls.count(128) == 10
        lg, lw = leaves(got), leaves(want)
        assert len(lg) == len(lw) > 0
        for a, b in zip(lg, lw):
            a, b = torch.as_tensor(a), torch.as_tensor(b)
            if a.dtype == torch.float32:
                assert _same(a, b)
            else:
                assert torch.equal(a, b)


@pytest.mark.parametrize("pol", POLICIES)
@pytest.mark.parametrize("mode", MODES)
def test_plain_version_against_jax(mode, pol):
    """oscillator_plain against the JAX package's oscillator from a
    carried clock with a modulated frequency, at the bound
    tests/test_torch_presets.py states (<= -115 dBFS: XLA turns the step
    f / 48000 into a multiply by the reciprocal), and the final clocks
    within 2e-7 (equal where no step rounds otherwise)."""
    import jax
    from dsp_stuff_tpu.ops.gen import oscillator as josc
    from dsp_stuff_tpu.utils import precision as jprec
    n = 2048
    freq = (300.0 + 200.0 * np.sin(np.arange(n) / 300.0)).astype(F32)
    with jprec.policy(pol):
        yj, cj = jax.jit(lambda f: josc(mode, 0.7, f, n, 0.25))(freq)
    with dt.policy(pol):
        yt, ct = gen.oscillator_plain(mode, 0.7, torch.from_numpy(freq), n,
                                      torch.tensor(0.25))
    yj = np.asarray(yj)
    err = np.abs(yt.numpy() - yj).max()
    peak = max(np.abs(yj).max(), 1e-30)
    assert 20 * np.log10(max(err / peak, 1e-30)) <= -115.0
    assert abs(float(ct) - float(np.asarray(cj))) <= 2e-7


def test_lfo_from_a_carried_jax_clock():
    """config5's LFO (a 0.5 Hz sine into an Output) rendered by the JAX
    package for 4,096 samples, its clock carried over to the port through
    convert.state_from_jax: the port renders the next 4,096 as the JAX
    package does (parity, <= -115 dBFS) and ends on its clock."""
    import dsp_stuff_tpu as dj
    from dsp_stuff_tpu.ids import IdSpace as JIdSpace
    from dsp_stuff_tpu_torch import convert
    from dsp_stuff_tpu_torch.ids import IdSpace as TIdSpace
    gj = dj.Graph(JIdSpace())
    lfo = gj.add("signal_gen", mode="Sine", frequency=0.5, amplitude=0.6)
    out = gj.add("output")
    gj.chain(lfo, out)
    gt = dt.loads_graph(dj.dumps_graph(gj), ids=TIdSpace())
    n = 4096
    with dj.policy("parity"):
        cgj = dj.compile_graph(gj)
        _, _, sj = cgj.render(None, T=n, batch_shape=(1,))
        yj, _, sj2 = cgj.render(None, T=n, batch_shape=(1,), state=sj)
    st = convert.state_from_jax(sj, "cpu")
    key = str(lfo.id)
    jclock = float(np.asarray(sj[key]["clock"]).reshape(-1)[0])
    assert float(st[key]["clock"].reshape(-1)[0]) == jclock
    assert jclock != 0.0
    cgt = dt.compile_graph(gt, device="cpu")
    with dt.policy("parity"):
        yt, _, st2 = cgt.render(None, T=n, batch_shape=(1,), state=st)
    yj = np.asarray(yj)
    err = np.abs(yt.numpy() - yj).max() / np.abs(yj).max()
    assert 20 * np.log10(max(err, 1e-30)) <= -115.0
    assert abs(float(st2[key]["clock"].reshape(-1)[0]) - float(
        np.asarray(sj2[key]["clock"]).reshape(-1)[0])) <= 2e-7
