"""A CPU model of the first-order kernel's one-pass schedule
(dsp_stuff_tpu_torch/csrc/first_order_kernel.cu), held against the plain
versions (ops/scan.first_order_plain) and a float64 solve.

The kernel runs only on a GPU.  This model repeats its float32 operations
in the kernel's order: each row laid on its virtual axis (the 16-byte
alignment shift), tiles of THREADS x SPAN samples, each thread's span walk
from a zero state, the warp-shuffle block scan (Hillis-Steele over the
lanes, then over the warps' totals), the carry chained from tile to tile
(carry_k = P_k carry_{k-1} + E_k) and the rescan of each span from its
exclusive carry.  The chain runs under a model of the kernel's schedule:
persistent CTAs, each holding a ring of NSTAGE tickets taken from one
column-major counter, claim their next ticket while their current tile
waits for its predecessor's carry and finish their tiles in the order
they took them; which CTA moves next is drawn at random.

Bounds (chip_smoke.py's, PERF.md section 2):
  model vs the float64 solve                    <= -90 dBFS
  ... and vs plain f32's own error              at most 6 dB worse
      (a in {0.2, 0.6, 0.99}; a = 0 and 1 the float64 bound only)
  two random completion orders                  bitwise equal
"""

import pathlib
import re

import numpy as np
import pytest
import torch

from dsp_stuff_tpu_torch.ops import first_order_kernel as tfk
from dsp_stuff_tpu_torch.ops import scan as tscan

SRC = (pathlib.Path(__file__).resolve().parents[1] / "dsp_stuff_tpu_torch"
       / "csrc" / "first_order_kernel.cu")
THREADS, SPAN, NSTAGE = 512, 16, 2
TILE = THREADS * SPAN
F64_DB = -90.0
VS_PLAIN_DB = 6.0
F32 = torch.float32


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def compose(m1, m2):
    """m1 first, then m2, as the kernel's compose: (p, e) pairs."""
    return m2[0] * m1[0], m2[0] * m1[1] + m2[1]


def row_shift(r: int, T: int, reverse: bool) -> int:
    """The virtual-axis shift of row r: every v = s + shift with v % 4 == 0
    is 16-byte aligned in the row's direction of travel."""
    return (4 - (r * T + T) % 4) % 4 if reverse else (r * T) % 4


def tickets(R: int, ntiles: int):
    """(row, tile) by ticket: column-major, tile k of every row first."""
    return [(t % R, t // R) for t in range(R * ntiles)]


def _warp_scan(p, e, width):
    """Inclusive Hillis-Steele scan over the last axis (lanes), only
    lanes < width taking part: each step reads the lane off below from
    before the step, as __shfl_up_sync does."""
    for off in (1, 2, 4, 8, 16):
        if off >= width:
            break
        sp, se = p[..., :-off], e[..., :-off]
        np_, ne = compose((sp, se), (p[..., off:], e[..., off:]))
        p = torch.cat([p[..., :off], np_], dim=-1)
        e = torch.cat([e[..., :off], ne], dim=-1)
    return p, e


def tile_local(av, bv, valid):
    """Every tile's local phase: av, bv, valid [ntiles, THREADS, SPAN].
    Returns (exclusive maps [ntiles, THREADS] x 2, tile maps [ntiles] x
    2)."""
    ntiles = bv.shape[0]
    p = torch.ones((ntiles, THREADS), dtype=F32)
    e = torch.zeros((ntiles, THREADS), dtype=F32)
    for j in range(SPAN):
        v = valid[..., j]
        e = torch.where(v, av[..., j] * e + bv[..., j], e)
        p = torch.where(v, p * av[..., j], p)
    nw = THREADS // 32
    ip, ie = _warp_scan(p.reshape(ntiles, nw, 32), e.reshape(ntiles, nw, 32),
                        32)
    wp, we = _warp_scan(ip[..., 31], ie[..., 31], nw)   # inclusive, warps
    one = torch.ones((ntiles, nw, 1), dtype=F32)
    zero = torch.zeros((ntiles, nw, 1), dtype=F32)
    xp = torch.cat([one, ip[..., :-1]], dim=-1)
    xe = torch.cat([zero, ie[..., :-1]], dim=-1)
    # warp w > 0 composes the warps before it first
    pre_p = torch.cat([torch.ones((ntiles, 1), dtype=F32), wp[:, :-1]], -1)
    pre_e = torch.cat([torch.zeros((ntiles, 1), dtype=F32), we[:, :-1]], -1)
    cp, ce = compose((pre_p[..., None], pre_e[..., None]), (xp, xe))
    xp = torch.cat([xp[:, :1], cp[:, 1:]], dim=1)
    xe = torch.cat([xe[:, :1], ce[:, 1:]], dim=1)
    return ((xp.reshape(ntiles, THREADS), xe.reshape(ntiles, THREADS)),
            (wp[:, -1], we[:, -1]))


def tile_finish(av, bv, valid, ex, cin):
    """Each thread's rescan from its exclusive carry ex.p cin + ex.e."""
    c = ex[0] * cin[:, None] + ex[1]
    out = torch.zeros_like(bv)
    for j in range(SPAN):
        v = valid[..., j]
        c = torch.where(v, av[..., j] * c + bv[..., j], c)
        out[..., j] = c
    return out


def _row_tiles(a, b, r, reverse):
    """(av, bv, valid, shift, ntiles) of row r on its virtual axis."""
    T = b.shape[-1]
    shift = row_shift(r, T, reverse)
    nt = -(-(T + shift) // TILE)
    brow = b[r].flip(0) if reverse else b[r]
    arow = (a[r].flip(0) if reverse else a[r]) if a.dim() else a.expand(T)
    n = nt * TILE

    def lay(x, fill):
        out = torch.full((n,), fill, dtype=F32)
        out[shift:shift + T] = x
        return out.reshape(nt, THREADS, SPAN)

    valid = lay(torch.ones(T, dtype=torch.bool), False).bool()
    return lay(arow, 1.0), lay(brow, 0.0), valid, shift, nt


def run_schedule(n_tickets, ready, ctas, stages=NSTAGE, seed=None):
    """The order in which ``ctas`` persistent CTAs finish tickets
    0..n_tickets-1.  Each CTA first takes ``stages`` tickets (the
    prologues' atomics interleaved at random), then repeats: take one more
    ticket, wait until its oldest ticket is ``ready(ticket, finished)``,
    finish it.  ``seed`` None moves the CTAs in turn.  Asserts on a
    deadlock (no CTA can move)."""
    rng = np.random.default_rng(seed)
    claims = [c for c in range(ctas) for _ in range(stages)]
    if seed is not None:
        rng.shuffle(claims)
    counter = 0
    queues = [[] for _ in range(ctas)]
    for c in claims:
        queues[c].append(counter)
        counter += 1
    claimed = [False] * ctas        # took its next ticket for this head
    finished, order = set(), []
    turn = 0
    while True:
        live = [c for c in range(ctas) if queues[c][0] < n_tickets]
        if not live:
            return order
        movable = [c for c in live
                   if not claimed[c] or ready(queues[c][0], finished)]
        assert movable, f"deadlock: heads {[queues[c][0] for c in live]}"
        if seed is None:
            c = movable[turn % len(movable)]
            turn += 1
        else:
            c = movable[rng.integers(len(movable))]
        if not claimed[c]:
            queues[c].append(counter)
            counter += 1
            claimed[c] = True
        else:
            t = queues[c].pop(0)
            finished.add(t)
            order.append(t)
            claimed[c] = False


def chained_solve(a, b, y0, reverse=False, ctas=4, seed=None):
    """The kernel's y for a 0-d or per-sample a, b [R, T], y0 [R] (float32
    CPU tensors), its tiles finished as run_schedule orders them."""
    R, T = b.shape
    rows = [_row_tiles(a, b, r, reverse) for r in range(R)]
    local = [tile_local(av, bv, valid) for av, bv, valid, _, _ in rows]
    ntiles = max(row[4] for row in rows)
    order = tickets(R, ntiles)

    def ready(t, finished):
        r, k = order[t]
        return k == 0 or k >= rows[r][4] or t - R in finished

    cin = {}                          # (r, k) -> carry into the tile
    published = {}                    # (r, k) -> inclusive carry, f32
    for t in run_schedule(len(order), ready, ctas, seed=seed):
        r, k = order[t]
        if k >= rows[r][4]:
            continue                  # past the row's end: no tile
        c = y0[r] if k == 0 else published[(r, k - 1)]
        (_, _), (tp, te) = local[r]
        cin[(r, k)] = c
        published[(r, k)] = tp[k] * c + te[k]
    y = torch.empty_like(b)
    for r, (av, bv, valid, shift, nt) in enumerate(rows):
        c = torch.stack([cin[(r, k)] for k in range(nt)])
        out = tile_finish(av, bv, valid, local[r][0], c).reshape(-1)
        out = out[shift:shift + T]
        y[r] = out.flip(0) if reverse else out
    return y


def _inputs(a_val, R, T, seed, per_sample):
    """chip_smoke.fo_inputs' distributions, from a NumPy generator."""
    rng = np.random.default_rng(seed)
    b = torch.from_numpy((rng.standard_normal((R, T)) * 0.3)
                         .astype(np.float32))
    y0 = torch.from_numpy(rng.standard_normal(R).astype(np.float32))
    if per_sample:
        a = torch.from_numpy((a_val * (0.9 + 0.1 * rng.random((R, T))))
                             .astype(np.float32))
    else:
        a = torch.tensor(np.float32(a_val))
    return a, b, y0


def _dbfs(got, want):
    err = float((got.double() - want.double()).abs().max())
    ref = float(want.double().abs().max())
    return 20.0 * np.log10(max(err, 1e-30) / max(ref, 1e-30))


FORMS = ("forward", "reverse", "per-sample forward", "per-sample reverse")
T_CASES = (1, TILE - 1, TILE, TILE + 1, 3 * TILE + 5, 12_345)


@pytest.mark.parametrize("T", T_CASES)
@pytest.mark.parametrize("form", FORMS)
def test_model_matches_plain_and_float64(form, T):
    """The modelled kernel against the float64 solve at the smoke's
    bounds, for a in {0, 0.2, 0.6, 0.99, 1} and R in {1, 3}."""
    per_sample, reverse = "per-sample" in form, "reverse" in form
    seed = 0
    for R in (1, 3):
        for a_val in (0.0, 0.2, 0.6, 0.99, 1.0):
            seed += 1
            a, b, y0 = _inputs(a_val, R, T, seed, per_sample)
            got = chained_solve(a, b, y0, reverse)
            plain = tscan.first_order_plain(a, b, y0, reverse)
            ref = tscan.first_order_plain(a.double(), b.double(),
                                          y0.double(), reverse)
            assert got.dtype == F32 and got.shape == b.shape
            assert bool(torch.isfinite(got).all())
            dk, dp = _dbfs(got, ref), _dbfs(plain, ref)
            what = f"{form} R={R} T={T} a={a_val}: model {dk:.1f} dBFS, " \
                   f"plain {dp:.1f}"
            assert dk <= F64_DB, what
            if a_val not in (0.0, 1.0):
                assert dk <= dp + VS_PLAIN_DB, what


@pytest.mark.parametrize("form", FORMS)
def test_completion_order_does_not_change_a_bit(form):
    """Random completion orders of 1 to 13 persistent CTAs give the same y
    bit for bit: each carry's operands do not depend on timing.  T = 3
    tiles + 5 at R = 3 with unaligned rows."""
    per_sample, reverse = "per-sample" in form, "reverse" in form
    a, b, y0 = _inputs(0.99, 3, 3 * TILE + 5, 7, per_sample)
    want = chained_solve(a, b, y0, reverse)
    for ctas, seed in ((1, 0), (2, 1), (5, 2), (7, 3), (13, 4)):
        got = chained_solve(a, b, y0, reverse, ctas=ctas, seed=seed)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), \
            (ctas, seed)


@pytest.mark.parametrize("form", FORMS)
def test_nan_propagates_as_in_the_sequential_recurrence(form):
    """NaN in b makes y NaN from that sample to the row's end in the
    direction of travel, as y = a y + b does (0 * NaN is NaN, so a = 0
    does not stop it); the samples before it and the other row stay
    finite."""
    per_sample, reverse = "per-sample" in form, "reverse" in form
    T = 2 * TILE + 9
    a, b, y0 = _inputs(0.6, 2, T, 11, per_sample)
    b[0, 100] = float("nan")
    if per_sample:
        a[0, 5000] = 0.0
    y = chained_solve(a, b, y0, reverse)
    t = torch.arange(T)
    assert torch.equal(torch.isnan(y[0]), t <= 100 if reverse else t >= 100)
    assert bool(torch.isfinite(y[1]).all())


@pytest.mark.parametrize("R", [1, 3, 7])
@pytest.mark.parametrize("ctas", [1, 2, 5])
def test_tickets_never_wait_on_a_later_ticket(R, ctas):
    """Column-major tickets: every tile's predecessor holds an earlier
    ticket, so persistent CTAs that finish their tickets in the order they
    took them never deadlock, with rings of 2 to 4 tickets (the
    scheduler asserts on a deadlock) and every ticket is finished once."""
    order = tickets(R, 4)
    index = {rk: t for t, rk in enumerate(order)}
    assert all(index[(r, k - 1)] < index[(r, k)] for r, k in order if k)
    assert [k for _, k in order[:R]] == [0] * R

    def ready(t, finished):
        return t < R or t - R in finished

    for stages in (2, 3, 4):
        for seed in range(5):
            done = run_schedule(len(order), ready, ctas, stages, seed)
            assert sorted(done) == list(range(len(order)))


@pytest.mark.parametrize("T", [4, 5, 6, 7, 100_003])
@pytest.mark.parametrize("reverse", [False, True])
def test_row_shift_aligns_every_full_span(T, reverse):
    """For every row, the memory index of each span start (forward) or
    span end (reverse) at v % 4 == 0 is a multiple of 4, and the wrapper's
    n_tiles covers the row."""
    for r in range(8):
        shift = row_shift(r, T, reverse)
        assert 0 <= shift <= 3
        for v0 in (4, 8, 4 * 1000):
            s = v0 - shift
            if reverse:
                first = r * T + T - 1 - (s + SPAN - 1)   # lowest address
            else:
                first = r * T + s
            assert first % 4 == 0, (r, v0)
        assert -(-(T + shift) // TILE) <= tfk.n_tiles(T, TILE)
    if T % 4 == 0:
        assert all(row_shift(r, T, reverse) == 0 for r in range(8))


def test_tile_constants_match_the_cuda_source():
    """THREADS, SPAN and NSTAGE of this model are the kernel's defaults,
    and the kernel sizes its tiles as the wrapper's n_tiles does."""
    src = SRC.read_text()
    defs = dict(re.findall(r"#define FO_(THREADS|SPAN|NSTAGE) (\d+)", src))
    assert int(defs["THREADS"]) == THREADS
    assert int(defs["SPAN"]) == SPAN
    assert int(defs["NSTAGE"]) == NSTAGE
    assert re.search(r"constexpr int TILE = THREADS \* SPAN;", src)
    assert "(T + (T % 4 ? 3 : 0) + TILE - 1) / TILE" in src
    assert tfk.n_tiles(TILE, TILE) == 1
    assert tfk.n_tiles(TILE + 1, TILE) == 2
    assert tfk.n_tiles(TILE - 3, TILE) == 1
    assert tfk.n_tiles(TILE - 2, TILE) == 2
