"""A CPU model of the sequential kernel's tile schedule
(dsp_stuff_tpu_torch/csrc/sequential_kernel.cu), held bitwise against the
plain versions (ops/scan.py: _first_order_sequential, _biquad_sequential,
_first_order_adjoint_sequential, _biquad_adjoint_sequential) and, for the
forward, the JAX package's _first_order_sequential / _biquad_sequential.

The kernel runs only on a GPU.  This model repeats its float32 and
float64 operations in its order, over its layouts: a CTA of 32 rows and
one warp a job, a ring of NST stages of [32 x LD] tiles an array in
shared memory (LD = RUN + 4 floats a row), the memory warp's copies lane
by lane (16-byte pieces, or single floats for rows not 16-byte aligned)
and its stores, the forward biquad's prep warp (p = (b0 x + b1 x1) +
b2 x2 in place), the chain warp (in place), and the reverse mode's
epilogue warps (the first order's abar with y[t-1] taken from the next
tile of the walk at a tile's first sample; the biquad's five float64 sums
over three warps, xbar into a ring array of its own).  Each warp is a
generator that waits on mbarriers as the kernel does (a phase parity a
tile); the copies land at random later steps, as cp.async does, and a
random schedule picks which runnable warp moves next.  Unloaded shared
memory holds NaN, so a read before its copy landed shows in the result.
The model's constants are pinned to the CUDA source by regex.
"""

import functools
import pathlib
import re

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from dsp_stuff_tpu.ops import scan as jscan
from dsp_stuff_tpu_torch.ops import scan as tscan

SRC = (pathlib.Path(__file__).resolve().parents[1] / "dsp_stuff_tpu_torch"
       / "csrc" / "sequential_kernel.cu")
ROWS, RUN, NST = 32, 64, 6
LD = RUN + 4
TILE = ROWS * LD
BAR_BYTES = 256
MAX_WARPS = 5
SMEM_LIMIT = 232448                       # 227 KB, a CTA's on the H100
NP = RUN // 4                             # 16-byte pieces of a tile's row
RPI = 32 // NP                            # rows a copy instruction moves
NJ = ROWS // RPI                          # copy instructions a tile
FO, PS, BQ = 0, 1, 2
FWD_ARRAYS = {FO: 1, PS: 2, BQ: 1}
FWD_WARPS = {FO: 2, PS: 2, BQ: 3}
REV_LOADS = {FO: 2, PS: 3, BQ: 3}
REV_ARRAYS = {FO: 2, PS: 3, BQ: 4}
REV_EPILOGUES = {FO: 1, PS: 1, BQ: 3}
# the biquad's epilogue warps: (first coefficient, sums, writes xbar)
BQ_EPILOGUES = ((0, 2, False), (2, 2, False), (4, 1, True))
F32, F64 = torch.float32, torch.float64
A = np.float32(0.9173)
COEFFS = (-1.8, 0.81, 0.1, 0.2, 0.1)      # a1, a2, b0, b1, b2

MODES = ["first_order", "first_order:per-sample", "biquad",
         "first_order_reverse", "first_order_reverse_per_sample",
         "biquad_reverse"]
KIND = {"first_order": FO, "first_order:per-sample": PS, "biquad": BQ,
        "first_order_reverse": FO, "first_order_reverse_per_sample": PS,
        "biquad_reverse": BQ}


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def smem_bytes(arrays: int) -> int:
    return BAR_BYTES + arrays * NST * TILE * 4


def kof(j: int) -> int:
    """The biquad coefficient j's sum is over g[t + kof(j)] z[t]."""
    return 0 if j == 2 else 2 if j in (1, 4) else 1


# -- the mbarrier and the schedule -------------------------------------------

class Bar:
    """An mbarrier: `count` arrivals complete a phase; a wait for parity
    P passes once the phase of that parity has completed."""

    def __init__(self, count):
        self.count, self.left, self.phase = count, count, 0

    def arrive(self, n=32):
        self.left -= n
        assert self.left >= 0, "more arrivals than the phase expects"
        if self.left == 0:
            self.phase += 1
            self.left = self.count

    def passed(self, parity):
        return (self.phase & 1) != parity


class Ring:
    """A CTA's shared memory: per stage the full, ready and done barriers,
    the tiles [array][stage] as [ROWS, LD] (NaN until a copy lands), and
    which tile of the walk each array's stage holds."""

    def __init__(self, arrays, n_done):
        self.full = [Bar(ROWS) for _ in range(NST)]
        self.ready = [Bar(ROWS) for _ in range(NST)]
        self.done = [Bar(n_done) for _ in range(NST)]
        self.tiles = torch.full((arrays, NST, ROWS, LD), float("nan"),
                                dtype=F32)
        self.holds = [[None] * NST for _ in range(arrays)]

    def run(self, a, s):
        """Each lane's row of the tile: [ROWS, RUN] (a view)."""
        return self.tiles[a, s, :, :RUN]


def stage(i):
    return i % NST


def parity(i):
    return (i // NST) & 1


def schedule(warps, pending, rng):
    """Run the warps (generators yielding (barrier, parity) to wait on)
    and the copy engine (`pending`, copies landing in order) until all
    end, the next mover drawn from `rng` among the runnable ones."""
    live = {i: None for i in range(len(warps))}
    while live or pending:
        movers = [i for i, w in live.items() if w is None or w[0].passed(w[1])]
        if pending:
            movers.append(-1)
        assert movers, "deadlock: every warp waits and no copy is in flight"
        pick = movers[rng.integers(len(movers))]
        if pick < 0:
            pending.pop(0)()
            continue
        try:
            live[pick] = next(warps[pick])
        except StopIteration:
            del live[pick]


# -- the memory warp's layouts -----------------------------------------------

@functools.lru_cache(maxsize=None)
def pieces(vec: bool, rows: int, ln: int):
    """The (tile index, source offset) of every float the memory warp
    moves for a tile of `rows` rows and `ln` samples, lane by lane as the
    kernel's loops go: where vec, lane l the 16-byte piece at sample
    4 (l % NP) of rows l // NP, + RPI, ...; else samples l, l + 32, ... of
    each row.  The source offset is relative to the tile's first sample
    of the CTA's first row, in rows of T (returned as (row, sample))."""
    dst, src = [], []
    for lane in range(32):
        if vec:
            e0, h0 = 4 * (lane % NP), lane // NP
            for j in range(NJ):
                h = h0 + j * RPI
                if h < rows and e0 < ln:
                    for k in range(4):
                        dst.append(h * LD + e0 + k)
                        src.append((h, e0 + k))
        else:
            for h in range(rows):
                e = 0
                while lane + e < ln:
                    dst.append(h * LD + lane + e)
                    src.append((h, lane + e))
                    e += 32
    return torch.tensor(dst), torch.tensor([h for h, _ in src]), \
        torch.tensor([e for _, e in src])


def memory_warp(g, ins, outs, r0, rows, T, n, rev, vec, pending):
    """The memory warp of one CTA: ins[a] / outs[o] = (array, ring array)
    are [R, T] float32 tensors (outs written in place)."""
    def span(i):
        s0 = (n - 1 - i if rev else i) * RUN
        return s0, min(T - s0, RUN)

    def load(i):
        s = stage(i)
        s0, ln = span(i)
        dst, h, e = pieces(vec, rows, ln)

        def land():
            for a, src in enumerate(ins):
                g.tiles[a, s].view(-1)[dst] = src[r0 + h, s0 + e]
                g.holds[a][s] = i
            g.full[s].arrive(32)
        pending.append(land)

    for i in range(min(n, NST)):
        load(i)
    for i in range(n):
        s = stage(i)
        yield g.done[s], parity(i)
        s0, ln = span(i)
        dst, h, e = pieces(vec, rows, ln)
        for out, a in outs:
            out[r0 + h, s0 + e] = g.tiles[a, s].view(-1)[dst]
        if i + NST < n:
            load(i + NST)


# -- the forward ---------------------------------------------------------------

def forward_cta(kind, x, a, c, s_in, y, s_out, r0, R, T, vec, pending):
    """The forward kernel's warps for the CTA of rows r0 .. r0 + 31:
    memory, chain, and for the biquad the prep warp."""
    rows = min(R - r0, ROWS)
    n = -(-T // RUN)
    g = Ring(FWD_ARRAYS[kind], ROWS)
    lanes = torch.arange(ROWS)
    ok = r0 + lanes < R
    rr = torch.clamp(r0 + lanes, max=R - 1)

    def chain():
        zero = torch.zeros(ROWS, dtype=F32)
        if kind == BQ:
            y1 = torch.where(ok, s_in[rr, 2], zero)
            y2 = torch.where(ok, s_in[rr, 3], zero)
        else:
            y1, y2 = torch.where(ok, s_in[rr], zero), zero
        for i in range(n):
            s = stage(i)
            yield (g.ready if kind == BQ else g.full)[s], parity(i)
            assert g.holds[0][s] == i
            v = g.run(0, s).clone()
            av = g.run(1, s) if kind == PS else None
            for u in range(min(T - i * RUN, RUN)):
                if kind == BQ:
                    out = (v[:, u] - c[0] * y1) - c[1] * y2
                    y2, y1 = y1, out
                else:
                    y1 = (av[:, u] if kind == PS else a) * y1 + v[:, u]
                v[:, u] = y1
            g.run(0, s)[:] = v
            g.done[s].arrive(32)
        if kind == BQ:
            s_out[r0:r0 + rows, 2] = y1[:rows]
            s_out[r0:r0 + rows, 3] = y2[:rows]
        else:
            s_out[r0:r0 + rows] = y1[:rows]

    def prep():
        zero = torch.zeros(ROWS, dtype=F32)
        x1 = torch.where(ok, s_in[rr, 0], zero)
        x2 = torch.where(ok, s_in[rr, 1], zero)
        for i in range(n):
            s = stage(i)
            yield g.full[s], parity(i)
            v = g.run(0, s).clone()
            for u in range(min(T - i * RUN, RUN)):
                xt = v[:, u].clone()
                v[:, u] = (c[2] * xt + c[3] * x1) + c[4] * x2
                x2, x1 = x1, xt
            g.run(0, s)[:] = v
            g.ready[s].arrive(32)
        s_out[r0:r0 + rows, 0] = x1[:rows]
        s_out[r0:r0 + rows, 1] = x2[:rows]

    ins = [x] + ([a] if kind == PS else [])
    warps = [memory_warp(g, ins, [(y, 0)], r0, rows, T, n, False, vec,
                         pending), chain()]
    if kind == BQ:
        warps.append(prep())
    return warps


def model_forward(kind, x, a, c, s_in, vec, seed=0):
    """(y, the final state) of the forward kernel, CTA by CTA."""
    R, T = x.shape
    y = torch.full((R, T), float("nan"), dtype=F32)
    s_out = torch.full((R, 4) if kind == BQ else (R,), float("nan"),
                       dtype=F32)
    rng = np.random.default_rng(seed)
    for r0 in range(0, R, ROWS):
        pending = []
        schedule(forward_cta(kind, x, a, c, s_in, y, s_out, r0, R, T, vec,
                             pending), pending, rng)
    return y, s_out


# -- the reverse mode ------------------------------------------------------------

def reverse_cta(kind, ybar, a, y, x, c, s_in, gx, ga, s_out, acc, r0, R, T,
                vec, pending):
    """The reverse kernel's warps for the CTA of rows r0 .. r0 + 31:
    memory, chain, epilogues."""
    rows = min(R - r0, ROWS)
    n = -(-T // RUN)
    g = Ring(REV_ARRAYS[kind], ROWS * REV_EPILOGUES[kind])
    lanes = torch.arange(ROWS)
    ok = r0 + lanes < R
    rr = torch.clamp(r0 + lanes, max=R - 1)
    zero = torch.zeros(ROWS, dtype=F32)
    walk_left = [T - (n - 1 - i) * RUN for i in range(n)]

    def chain():
        lam, a_next = zero, (a if kind == FO else zero)
        g1 = g2 = zero
        for i in range(n):
            s = stage(i)
            yield g.full[s], parity(i)
            assert g.holds[0][s] == i
            v = g.run(0, s).clone()
            u = g.run(2, s) if kind == PS else None
            for e in range(min(walk_left[i], RUN) - 1, -1, -1):
                if kind == BQ:
                    gt = (v[:, e] - c[0] * g1) - c[1] * g2
                    g2, g1 = g1, gt
                    v[:, e] = gt
                else:
                    lam = v[:, e] + a_next * lam
                    v[:, e] = lam
                    if kind == PS:
                        a_next = u[:, e].clone()
            g.run(0, s)[:] = v
            g.ready[s].arrive(32)
        if kind != BQ:
            s_out[r0:r0 + rows] = (a_next * lam)[:rows]

    def first_order_epilogue():
        d = torch.zeros(ROWS, dtype=F64)
        y0 = torch.where(ok, s_in[rr], zero)
        for i in range(n):
            s = stage(i)
            k = n - 1 - i
            yield g.ready[s], parity(i)
            v = g.run(0, s).clone()
            # y[t-1]: this tile's y, at its first sample the last y of tile
            # k - 1, the walk's next
            y_edge = y0
            if k > 0:
                yield g.full[stage(i + 1)], parity(i + 1)
                assert g.holds[1][stage(i + 1)] == i + 1
                y_edge = g.run(1, stage(i + 1))[:, RUN - 1].clone()
            w = g.run(1, s)
            for e in range(min(walk_left[i], RUN) - 1, -1, -1):
                v[:, e] = v[:, e] * (w[:, e - 1] if e else y_edge)
                if kind == FO:
                    d = d + v[:, e].double()
            if kind == PS:
                g.run(2, s)[:] = v
            g.done[s].arrive(32)
        if kind == FO:
            acc[r0:r0 + rows] = d[:rows]

    def biquad_epilogue(j0, ns, xbar):
        z = 2 if j0 < 2 else 1              # ring array of y or x
        d = [torch.zeros(ROWS, dtype=F64) for _ in range(ns)]
        g1 = g2 = zero
        for i in range(n):
            s = stage(i)
            yield g.ready[s], parity(i)
            v = g.run(0, s).clone()
            w = g.run(z, s)
            for e in range(min(walk_left[i], RUN) - 1, -1, -1):
                gt = v[:, e].clone()
                hist = {0: gt, 1: g1, 2: g2}
                for j in range(ns):
                    d[j] = d[j] + (hist[kof(j0 + j)] * w[:, e]).double()
                if xbar:
                    v[:, e] = (c[2] * gt + c[3] * g1) + c[4] * g2
                g2, g1 = g1, gt
            if xbar:
                g.run(3, s)[:] = v
            g.done[s].arrive(32)
        z1 = torch.where(ok, s_in[rr, 2 if z == 2 else 0], zero)
        z2 = torch.where(ok, s_in[rr, 3 if z == 2 else 1], zero)
        for j in range(ns):
            if kof(j0 + j) == 1:
                d[j] = d[j] + (g1 * z1).double()
            elif kof(j0 + j) == 2:
                d[j] = d[j] + (g2 * z1).double()
                d[j] = d[j] + (g1 * z2).double()
            acc[r0:r0 + rows, j0 + j] = (-d[j] if j0 + j < 2 else d[j])[:rows]
        if xbar:
            sb = torch.stack([c[3] * g1 + c[4] * g2, c[4] * g1,
                              -(c[0] * g1) - c[1] * g2, -(c[1] * g1)], -1)
            s_out[r0:r0 + rows] = sb[:rows]

    if kind == BQ:
        ins, outs = [ybar, x, y], [(gx, 3)]
        epilogues = [biquad_epilogue(*e) for e in BQ_EPILOGUES]
    else:
        ins = [ybar, y] + ([a] if kind == PS else [])
        outs = [(gx, 0)] + ([(ga, 2)] if kind == PS else [])
        epilogues = [first_order_epilogue()]
    return [memory_warp(g, ins, outs, r0, rows, T, n, True, vec, pending),
            chain(), *epilogues]


def model_reverse(kind, ybar, a, y, x, c, s_in, vec, seed=0):
    """The reverse kernel's outputs, as the wrappers return them."""
    R, T = ybar.shape
    nan = float("nan")
    gx = torch.full((R, T), nan, dtype=F32)
    ga = torch.full((R, T), nan, dtype=F32) if kind == PS else None
    s_out = torch.full((R, 4) if kind == BQ else (R,), nan, dtype=F32)
    acc = (torch.full((R, 5) if kind == BQ else (R,), nan, dtype=F64)
           if kind != PS else None)
    rng = np.random.default_rng(seed)
    for r0 in range(0, R, ROWS):
        pending = []
        schedule(reverse_cta(kind, ybar, a, y, x, c, s_in, gx, ga, s_out, acc,
                             r0, R, T, vec, pending), pending, rng)
    if kind == BQ:
        return gx, s_out, acc
    return gx, (ga if kind == PS else acc), s_out


# -- inputs and the plain versions ---------------------------------------------

def inputs(mode, R, T, seed):
    """(a, x, c, s_in, ybar) from numpy: the first order's a (0-d or per
    sample) and b (as x), or the biquad's x, coefficients and state."""
    rng = np.random.default_rng(seed)
    kind = KIND[mode]
    x = torch.from_numpy((rng.standard_normal((R, T)) * 0.5)
                         .astype(np.float32))
    c = torch.tensor(COEFFS, dtype=F32)
    if kind == BQ:
        a = None
        s_in = torch.from_numpy((rng.standard_normal((R, 4)) * 0.3)
                                .astype(np.float32))
    else:
        a = (torch.from_numpy(rng.uniform(-0.99, 0.99, (R, T))
                              .astype(np.float32)) if kind == PS
             else torch.tensor(A))
        s_in = torch.from_numpy((rng.standard_normal(R) * 0.3)
                                .astype(np.float32))
    ybar = torch.from_numpy(rng.standard_normal((R, T)).astype(np.float32))
    return a, x, c, s_in, ybar


def plain_forward(kind, a, x, c, s_in):
    if kind == BQ:
        y, fin = tscan._biquad_sequential(x, *c.unbind(0),
                                          tuple(s_in.unbind(1)))
        return y, torch.stack(fin, dim=1)
    y = tscan._first_order_sequential(a, x, s_in)
    return y, y[:, -1]


def plain_reverse(kind, a, x, y, c, s_in, ybar):
    if kind == BQ:
        return tscan._biquad_adjoint_sequential(x, y, c, s_in, ybar)
    return tscan._first_order_adjoint_sequential(a, y, s_in, ybar)


def run_model(mode, R, T, vec, seed=0, schedule_seed=0):
    """(the model's outputs, the plain version's) of ``mode`` at [R, T]."""
    kind = KIND[mode]
    a, x, c, s_in, ybar = inputs(mode, R, T, seed)
    if "reverse" not in mode:
        return (model_forward(kind, x, a, c, s_in, vec, schedule_seed),
                plain_forward(kind, a, x, c, s_in))
    y = plain_forward(kind, a, x, c, s_in)[0]
    return (model_reverse(kind, ybar, a, y, x, c, s_in, vec, schedule_seed),
            plain_reverse(kind, a, x, y, c, s_in, ybar))


def assert_bitwise(got, want):
    assert len(got) == len(want)
    for gt, wt in zip(got, want):
        assert gt.dtype == wt.dtype and gt.shape == wt.shape
        np.testing.assert_array_equal(gt.numpy(), wt.numpy())


# -- the tests -------------------------------------------------------------------

# T = 1 and 2, T < RUN, a tile and one sample either side, two tiles + 1,
# and past the ring (NST tiles) with a tail
T_CASES = [1, 2, RUN - 1, RUN, RUN + 1, 2 * RUN + 1, (NST + 1) * RUN + 3]


@pytest.mark.parametrize("T", T_CASES)
@pytest.mark.parametrize("mode", MODES)
def test_model_is_bitwise_the_plain_version(mode, T):
    """Every mode at R = 5 (a CTA not full), the copies of the aligned
    route where T % 4 == 0, else the single-float route."""
    got, want = run_model(mode, 5, T, vec=T % 4 == 0)
    assert_bitwise(got, want)


@pytest.mark.parametrize("mode", MODES)
def test_two_ctas_and_the_single_float_route(mode):
    """R = 37 (a full CTA and a partial one) over the single-float copies
    at T = 2 RUN, where the 16-byte route could have been taken."""
    got, want = run_model(mode, 37, 2 * RUN, vec=False, seed=1)
    assert_bitwise(got, want)


@pytest.mark.parametrize("mode", ["first_order", "first_order:per-sample",
                                  "biquad"])
def test_forward_model_is_the_jax_packages_loop(mode):
    """The forward against the JAX package's lax.scan loops (run on the
    CPU, as tests/test_torch_exact.py runs them)."""
    kind = KIND[mode]
    a, x, c, s_in, _ = inputs(mode, 8, 2 * RUN + 1, 7)
    y, fin = model_forward(kind, x, a, c, s_in, vec=False)
    if kind == BQ:
        want, wst = jax.jit(jscan._biquad_sequential)(
            x.numpy(), *(np.float32(v) for v in COEFFS),
            tuple(s_in.numpy().T))
        np.testing.assert_array_equal(fin.numpy(), np.stack(wst, 1))
    else:
        want = jax.jit(jscan._first_order_sequential)(
            a.numpy(), x.numpy(), s_in.numpy())
    np.testing.assert_array_equal(y.numpy(), np.asarray(want))


@pytest.mark.parametrize("mode", ["first_order_reverse", "biquad",
                                  "biquad_reverse"])
def test_completion_order_does_not_change_a_bit(mode):
    """Three random schedules of the warps and the copies' landings: no
    deadlock, and the same bits each time."""
    outs = [run_model(mode, 6, NST * RUN + 5, vec=False, schedule_seed=k)[0]
            for k in (1, 2, 3)]
    for other in outs[1:]:
        assert_bitwise(other, outs[0])


@pytest.mark.parametrize("rows,ln,vec", [
    (32, RUN, True), (5, RUN, True), (32, 20, True), (1, 4, True),
    (32, RUN, False), (5, RUN, False), (32, 17, False), (1, 1, False)])
def test_copies_cover_each_sample_once(rows, ln, vec):
    """The memory warp's lanes move every (row, sample) of a tile exactly
    once, and nothing outside it (the 16-byte route takes whole pieces:
    T % 4 == 0)."""
    dst, h, e = pieces(vec, rows, ln)
    want = sorted(r * LD + s for r in range(rows) for s in range(ln))
    assert sorted(dst.tolist()) == want
    assert ((h * LD + e) == dst).all()


def _src_int(pattern: str) -> int:
    m = re.search(pattern, SRC.read_text())
    assert m, pattern
    return int(m.group(1))


def test_tile_constants_match_the_cuda_source():
    """RUN, the stages, the rows, the row pitch, the warps of each
    instance and the shared-memory bytes (each within 227 KB) are the
    model's; chip_smoke's tile edges use the same RUN."""
    src = SRC.read_text()
    assert _src_int(r"#define SQ_ROWS (\d+)") == ROWS
    assert _src_int(r"#define SQ_RUN (\d+)") == RUN
    assert _src_int(r"#define SQ_NST (\d+)") == NST
    assert re.search(r"#define SQ_LD \(SQ_RUN \+ 4\)", src)
    assert _src_int(r"#define SQ_BAR_BYTES (\d+)") == BAR_BYTES
    assert _src_int(r"#define SQ_MAX_WARPS (\d+)") == MAX_WARPS
    assert re.search(r"SQ_BAR_BYTES \+ arrays \* SQ_NST \* SQ_TILE \* "
                     r"\(int\)sizeof\(float\)", src)
    assert re.search(r"fwd_arrays\(int mode\) \{\s*return mode == "
                     r"SQ_FIRST_ORDER_PS \? 2 : 1;", src)
    assert re.search(r"fwd_warps\(int mode\) \{\s*return mode == SQ_BIQUAD "
                     r"\? 3 : 2;", src)
    assert re.search(r"rev_loads\(int mode\) \{\s*return mode == "
                     r"SQ_FIRST_ORDER \? 2 : 3;", src)
    assert re.search(r"rev_arrays\(int mode\) \{\s*return rev_loads\(mode\) "
                     r"\+ \(mode == SQ_BIQUAD \? 1 : 0\);", src)
    assert re.search(r"rev_epilogues\(int mode\) \{\s*return mode == "
                     r"SQ_BIQUAD \? 3 : 1;", src)
    assert re.search(r"__launch_bounds__\(32 \* 3\)\s*sequential_kernel\(",
                     src)
    assert re.search(r"__launch_bounds__\(32 \* SQ_MAX_WARPS\)\s*"
                     r"sequential_reverse_kernel\(", src)
    assert max(FWD_WARPS.values()) <= 3
    assert 2 + max(REV_EPILOGUES.values()) <= MAX_WARPS
    for k in (FO, PS, BQ):
        assert smem_bytes(FWD_ARRAYS[k]) <= SMEM_LIMIT
        assert smem_bytes(REV_ARRAYS[k]) <= SMEM_LIMIT
        assert REV_LOADS[k] <= REV_ARRAYS[k]
    assert max(smem_bytes(n) for n in REV_ARRAYS.values()) == 209152
    assert LD % 4 == 0 and (LD // 4) % 2 == 1    # 16-byte reads: no conflict
    # the biquad's epilogues: the source's three calls, the model's split
    calls = re.findall(r"biquad_epilogue<(\d), (\d), (true|false)>\(", src)
    assert [(int(j), int(n), x == "true") for j, n, x in calls] == \
        list(BQ_EPILOGUES)
    assert sorted(j0 + j for j0, ns, _ in BQ_EPILOGUES
                  for j in range(ns)) == [0, 1, 2, 3, 4]
    assert chip_smoke.SEQ_RUN == RUN
