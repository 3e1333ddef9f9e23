"""The reverse chain kernel's tile walk (csrc/chain_reverse_kernel.cu), on
the CPU.

The CUDA kernel runs only on a GPU (chip_smoke.py holds it against
``segment_adjoint`` there).  Here:

(a) ``reverse_walk``, a PyTorch model of the kernel's walk written for
    this test: a row a CTA, its tiles of 64 blocks from the last to the
    first, the stages of each tile in reverse: the cascade's 3xTF32
    products with the transposed Toeplitz fragments as the kernel indexes
    them and the carry adjoint's walk from the tile's end (running between
    tiles, the info seeds on the render's last block); the comb's chains
    backwards over the ring of later adjoints; the mtap's gather over each
    input's runs of outputs (their first output by input, as the kernel's
    shared memory holds it) with the two-buffer ring of pending input
    adjoints; the shapers' derivatives from the records, the taps'
    cotangents; the histories' gradients after the walk.  It is held
    against ``segment_adjoint`` on every list the smoke run checks and at
    the edges: T = 128, a ragged last tile, combs of D < 128, 128 and past
    a tile, mtap taps that cross a tile and reach into the history;
(b) the model's fragment indices, tile walk, ring buffers and run starts
    pinned to the CUDA source by regex (a new walk gets its model first);
(c) the reverse's packed records against the CUDA structs, the chebyshev
    denominators in its stage records, and the wrapper's refusals before
    any launch.

Bounds: x's gradient <= -110 dBFS and the states' within 1e-5 against
the plain version: the model rounds in float32 like the kernel, in
another order, and its TF32 parts keep 22 of float32's 24 bits per
product."""

import functools
import pathlib
import re

import numpy as np
import pytest
import torch

import chip_smoke
from dsp_stuff_tpu_torch.ops import chain_kernel as tck
from dsp_stuff_tpu_torch.ops import chain_reverse_kernel as tcr
from dsp_stuff_tpu_torch.ops import chain_segment as tcs
from dsp_stuff_tpu_torch.ops import cycle_segment as tcyc
from dsp_stuff_tpu_torch.utils import precision as tprec

C = 128
NS = 8
X_DB = -110.0
STATE_ATOL = 1e-5
KT = tck.M_TILE
SRC = (pathlib.Path(tck.__file__).resolve().parent.parent / "csrc"
       / "chain_reverse_kernel.cu")


@pytest.fixture(autouse=True)
def _torch_env():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    prev = tprec.get_policy()
    tprec.set_policy("fast")
    yield
    tprec.set_policy(prev)
    torch.set_num_threads(threads)


def _dbfs(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    return 20 * np.log10(max(err, 1e-30) / max(np.abs(want).max(), 1e-30))


# -- (a) the walk ------------------------------------------------------------

def _split(a: torch.Tensor):
    hi, lo = tck.tf32_split(a.numpy())
    return torch.from_numpy(hi), torch.from_numpy(lo)


def _mm3(a, bh, bl):
    """A B in 3xTF32 as mma3 sums it: lo·hi, then hi·lo, then hi·hi."""
    ah, al = _split(a)
    return al @ bh + ah @ bl + ah @ bh


def fragments(sections):
    """(Ltg^T hi, lo [128, 128], Ecb^T hi, lo [128, 8], W^T hi, lo [8,
    128], ACt [8, 8]) from the forward's packed constants, each matrix
    filled fragment by fragment with the kernel's indices: ltgT_product's
    b[d] = hs[8d + tig - gid + 8] (+4, + CK_HP for lo) at B[k = 8kk + tig
    (+4)][n = 8nn + gid], d = kk - nn >= 0; Ecb^T's ecb[gid*128 + 8kk +
    tig (+4)]; W^T's w[(8nn + gid)*8 + tig (+4)]."""
    arr, offs, _ = tck.casc_tile_consts(tuple(sections))
    hp = arr[offs[0]:offs[1]]
    w = arr[offs[1]:offs[2]]
    ecb = arr[offs[2]:offs[3]]
    act = arr[offs[3]:].reshape(NS, NS)
    out = []
    for part in range(2):
        L = np.zeros((C, C), np.float32)
        E = np.zeros((C, NS), np.float32)
        WT = np.zeros((NS, C), np.float32)
        for gid in range(8):
            for tig in range(4):
                for kk in range(16):
                    for nn in range(kk + 1):
                        d = kk - nn
                        hb = part * (C + 8)
                        L[8 * kk + tig, 8 * nn + gid] = hp[
                            hb + 8 * d + tig - gid + 8]
                        L[8 * kk + tig + 4, 8 * nn + gid] = hp[
                            hb + 8 * d + tig - gid + 8 + 4]
                    eb = part * NS * C + gid * C + 8 * kk + tig
                    E[8 * kk + tig, gid] = ecb[eb]
                    E[8 * kk + tig + 4, gid] = ecb[eb + 4]
                for nn in range(16):
                    wb = part * C * NS + (8 * nn + gid) * NS + tig
                    WT[tig, 8 * nn + gid] = w[wb]
                    WT[tig + 4, 8 * nn + gid] = w[wb + 4]
        out.append((torch.from_numpy(L), torch.from_numpy(E),
                    torch.from_numpy(WT)))
    (Lh, Eh, Wh), (Ll, El, Wl) = out
    return Lh, Ll, Eh, El, Wh, Wl, torch.from_numpy(act.copy())


_fragments = functools.lru_cache(maxsize=32)(fragments)


def _run_starts(tp, t0, RL, span):
    """The kernel's first[]: for each input t0 - RL + i, the first output
    of the tile whose tap reads it first (-1: none)."""
    first = np.full(span, -1, np.int64)
    starts = np.flatnonzero(np.r_[True, tp[1:] != tp[:-1]])
    idx = tp[starts] - (t0 - RL)
    ok = (idx >= 0) & (idx < span)
    first[idx[ok]] = starts[ok]
    return first


def _gather(first, tp, a, b, t0, RL, Lv, ps):
    """mtap_gather for the inputs ``ps``: the run of outputs from
    first[i] whose tap is p (a, their first-tap parts), then the run from
    first[i - 1] whose tap is p - 1 (b), summed from 0 in output order."""
    i = ps - (t0 - RL)
    out = np.zeros(len(ps), np.float32)
    for want, parts, fi in ((ps, a, first[i]),
                            (ps - 1, b, np.where(i > 0, first[i - 1], -1))):
        s = fi.copy()
        live = s >= 0
        while live.any():
            sc = np.clip(s, 0, Lv - 1)
            live &= (s < Lv) & (tp[sc] == want)
            out = np.where(live, out + np.where(live, parts[sc], 0.0)
                           .astype(np.float32), out).astype(np.float32)
            s = s + 1
    return out


def reverse_walk(ct_y, ct_taps, seeds, ct_hists, recs, stages, shared, B,
                 T, dev=None):
    """The reverse chain kernel's walk in PyTorch, ``chain_reverse_call``'s
    arguments and returns (x's gradient [B, T], per stateful stage its
    gradient: a cascade's [B, 8], a history's [B, n])."""
    K = T // C
    n_tiles = -(-K // KT)
    records, _ = tcr.reverse_records(stages)
    casc, rings = [], []
    mi = 0
    for st in stages:
        if st[0] == "cascade":
            casc.append(dict(m=_fragments(st[1]), gcarry=torch.zeros(B, NS),
                             g=torch.zeros(B, NS), seed=seeds[len(casc)]))
        elif st[0] == "comb":
            D = int(st[2])
            rings.append(dict(ring=torch.zeros(B, -(-D // C) * C),
                              g=torch.zeros(B, D)))
        elif st[0] == "mtap":
            NH = int(st[3])
            q, r, fr = shared[3 * mi:3 * mi + 3]
            mi += 1
            u = (np.repeat(q.numpy().astype(np.int64), C)
                 + r.numpy().astype(np.int64) + np.arange(T) - NH * C)
            rings.append(dict(ring=torch.zeros(B, 2, (NH + 1) * C),
                              g=torch.zeros(B, int(st[2])), tap=u,
                              fr=fr.numpy()))
    gx = torch.zeros(B, T)
    for row in range(B):
        for tile in reversed(range(n_tiles)):
            b0 = tile * KT
            KTv = min(KT, K - b0)
            Lv, t0 = KTv * C, b0 * C
            F = torch.zeros(KT * C)
            if ct_y is not None:
                F[:Lv] = ct_y[row, t0:t0 + Lv]
            ci = len(casc)
            ri = len(rings)
            for st, rec in zip(reversed(stages), reversed(records)):
                kind = st[0]
                if kind == "scale":
                    F = F * float(rec["p"][0])
                elif kind == "tap":
                    if ct_taps[st[1]] is not None:
                        F[:Lv] = F[:Lv] + ct_taps[st[1]][row, t0:t0 + Lv]
                elif kind == "ew":
                    x = recs[int(rec["rec"])][row, t0:t0 + Lv]
                    F[:Lv] = tcyc.ew_adjoint(st[1], F[:Lv].reshape(-1, C),
                                             x.reshape(-1, C), st[2]
                                             ).reshape(Lv)
                elif kind == "cascade":
                    ci -= 1
                    cs = casc[ci]
                    Lh, Ll, Eh, El, Wh, Wl, act = cs["m"]
                    N = int(rec["n"])
                    Y = F.reshape(KT, C)
                    P = _mm3(Y, Lh, Ll)
                    V = _mm3(Y, Eh, El)
                    Cn = np.zeros((KT, NS), np.float32)
                    c = cs["gcarry"][row].numpy().copy()
                    Vn, an = V.numpy(), act.numpy().astype(np.float64)
                    for jb in reversed(range(KTv)):
                        Cn[jb] = c
                        nc = Vn[jb, :N].copy()
                        for j in range(N):            # fmaf, lane by lane
                            nc = (np.float64(c[j]) * an[:N, j]
                                  + nc.astype(np.float64)).astype(np.float32)
                        if b0 + jb == K - 1 and cs["seed"][1] is not None:
                            nc = nc + cs["seed"][1][row, :N].numpy()
                        c = np.zeros(NS, np.float32)
                        c[:N] = nc
                    cs["gcarry"][row] = torch.from_numpy(c)
                    if b0 == 0:
                        cs["g"][row] = torch.from_numpy(c)
                    Cn = torch.from_numpy(Cn)
                    X = P + _mm3(Cn, Wh, Wl)
                    if b0 + KTv == K and cs["seed"][0] is not None:
                        X[KTv - 1] = X[KTv - 1] + cs["seed"][0][row]
                    F = X.reshape(KT * C)
                elif kind == "comb":
                    ri -= 1
                    rg = rings[ri]
                    D, decay = int(st[2]), float(rec["p"][0])
                    ring = rg["ring"][row]
                    RL = ring.shape[0]
                    cth = ct_hists[ri]
                    span = min(D, Lv)
                    for hi in range(Lv, 0, -span):
                        s = torch.arange(max(hi - span, 0), hi)
                        sd = s + D
                        prev = torch.where(sd < Lv, F[sd.clamp(max=Lv - 1)],
                                           ring[(t0 + sd) % RL])
                        v = F[s]
                        if cth is not None:
                            tt = t0 + s
                            on = tt >= T - D
                            v = torch.where(on, v + cth[row, (tt - (T - D))
                                                        .clamp(min=0)], v)
                        v = v + prev * decay
                        F[s] = v
                        tt = t0 + s
                        low = tt < D
                        rg["g"][row, tt[low]] = v[low] * decay
                    s = torch.arange(min(RL, Lv))
                    ring[(t0 + s) % RL] = F[s]
                else:                                           # mtap
                    ri -= 1
                    rg = rings[ri]
                    NH, mix = int(rec["n"]), float(rec["p"][0])
                    L = int(st[2])
                    RL = (NH + 1) * C
                    rin = rg["ring"][row, (tile + 1) & 1].numpy().copy()
                    rout = rg["ring"][row, tile & 1]
                    tp = rg["tap"][t0:t0 + Lv]
                    fr = rg["fr"][t0:t0 + Lv]
                    g = F[:Lv].numpy()
                    gw = (g * np.float32(mix)).astype(np.float32)
                    a = (gw * (np.float32(1.0) - fr)).astype(np.float32)
                    b = (gw * fr).astype(np.float32)
                    first = _run_starts(tp, t0, RL, RL + Lv)
                    ps = np.arange(t0 - RL, t0)
                    v = _gather(first, tp, a, b, t0, RL, Lv, ps)
                    pend = ps >= t0 + Lv - RL
                    v = np.where(pend, rin[np.clip(ps - (t0 + Lv - RL), 0,
                                                   RL - 1)] + v, v)
                    rout[:] = torch.from_numpy(v.astype(np.float32))
                    s = np.arange(Lv)
                    xin = (g * (np.float32(1.0) - np.float32(mix))).astype(
                        np.float32)
                    xin = xin + _gather(first, tp, a, b, t0, RL, Lv, t0 + s)
                    xin = np.where(s >= Lv - RL,
                                   xin + rin[np.clip(s - (Lv - RL), 0,
                                                     RL - 1)], xin)
                    cth = ct_hists[ri]
                    if cth is not None:
                        tt = t0 + s
                        on = tt >= T - L
                        xin = np.where(on, xin + cth[row].numpy()[
                            np.clip(tt - (T - L), 0, L - 1)], xin)
                    F[:Lv] = torch.from_numpy(xin.astype(np.float32))
            gx[row, t0:t0 + Lv] = F[:Lv]
        for rg, st, cth in zip(rings, (s for s in stages
                                       if s[0] in ("comb", "mtap")),
                               ct_hists):
            n = int(st[2])
            if st[0] == "comb":
                for j in range(T, n):
                    rg["g"][row, j] = cth[row, j - T] if cth is not None \
                        else 0.0
            else:
                RL = (int(st[3]) + 1) * C
                v = rg["ring"][row, 0, RL - n:].clone()
                if cth is not None and T < n:
                    v[T:] = v[T:] + cth[row, :n - T]
                rg["g"][row] = v
    g_states = []
    ci = ri = 0
    for st in stages:
        if st[0] == "cascade":
            g_states.append(casc[ci]["g"])
            ci += 1
        elif st[0] in ("comb", "mtap"):
            g_states.append(rings[ri]["g"])
            ri += 1
    return gx, tuple(g_states)


def _case(stages, lfos, B, T, seed, which="all"):
    """Seeded inputs and cotangents of a list over [B, T] (``which``: the
    outputs that carry one), the recorded inputs, and the plain version's
    gradients."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.standard_normal((B, T)) * 0.3)
                         .astype(np.float32))
    st = chip_smoke.seeded_states(stages, B, rng, "cpu", T=T, lfos=lfos)
    outs, recs = tcs.segment_fallback(x, stages, st, record=True)
    flat = tcs.flatten_outputs(outs)
    n_c = sum(1 for s in stages if s[0] == "cascade")
    n_h = sum(1 for s in stages if s[0] in ("comb", "mtap"))
    keep = {"all": range(len(flat)), "y": [0],
            "hists": range(1 + 4 * n_c, 1 + 4 * n_c + n_h)}[which]
    cts = tuple(torch.from_numpy((rng.standard_normal(tuple(o.shape)) * 0.5)
                                 .astype(np.float32)) if i in keep else None
                for i, o in enumerate(flat))
    shapes = tuple(t.shape for t in (x, *st))
    want = tcs.segment_adjoint(cts, shapes, stages, recs, st)
    return x, st, cts, recs, want


def _walk(stages, st, cts, recs, B, T):
    """The model through the kernel path's own packing of its arguments
    (``_kernel_segment_adjoint`` with the model standing in for
    ``chain_reverse_call``)."""
    from unittest import mock
    with mock.patch.object(tcr, "chain_reverse_call", reverse_walk):
        return tcs._kernel_segment_adjoint(
            cts, tuple(t.shape for t in (torch.zeros(B, T), *st)), stages,
            recs, st)


def _held(got, want, stages, scaled=False):
    """x's gradient within X_DB, each state's within STATE_ATOL (``scaled``:
    of its largest magnitude, for states far from 1)."""
    gx, gs = got
    assert _dbfs(gx.numpy(), want[0].numpy()) <= X_DB
    shared = tcs._shared_slots(stages)
    assert len(gs) == len(want[1])
    for i, (g, w) in enumerate(zip(gs, want[1])):
        if i in shared:
            assert g is None and w is None
            continue
        atol = STATE_ATOL * (max(float(w.abs().max()), 1.0) if scaled
                             else 1.0)
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=atol)


@functools.lru_cache(maxsize=1)
def _model_lists():
    lists = {name: (stages, ()) for name, stages
             in chip_smoke.check_lists().items()}
    lists.update(chip_smoke.mtap_lists())
    return lists


@pytest.mark.parametrize("name", sorted(_model_lists()))
def test_walk_matches_adjoint(name):
    """Every list the smoke run checks, over two tiles and a ragged one."""
    stages, lfos = _model_lists()[name]
    B, T = 2, 2 * KT * C + 5 * C
    x, st, cts, recs, want = _case(stages, lfos, B, T, sum(map(ord, name)))
    _held(_walk(stages, st, cts, recs, B, T), want, stages)


@pytest.mark.parametrize("D", [100, 128, KT * C + 476])
def test_walk_comb_delays(D):
    """A comb shorter than a block, of one block, and longer than a tile
    (its ring spans tiles), behind a cascade and a shaper, over three
    tiles and a ragged one, cotangents on every output."""
    stages = (("cascade", (("lp", 0.4),)), ("ew", "distort:Tanh", (1.5,)),
              ("comb", 0.45, D))
    B, T = 2, 3 * KT * C + 3 * C
    x, st, cts, recs, want = _case(stages, (), B, T, D)
    _held(_walk(stages, st, cts, recs, B, T), want, stages)


@pytest.mark.parametrize("T", [C, 5 * C, KT * C, KT * C + C])
def test_walk_tile_shapes(T):
    """The bench list at one block, a ragged only tile, exactly one tile
    and a tile and one block."""
    stages = chip_smoke.bench_stages()
    x, st, cts, recs, want = _case(stages, (), 2, T, T)
    _held(_walk(stages, st, cts, recs, 2, T), want, stages)


@pytest.mark.parametrize("T", [C, KT * C + 3 * C])
def test_walk_carry_seeds(T):
    """A cascade with slow poles, whose final states reach back over the
    whole last block: the info cotangents' seeds on the carry entering it
    and on its input, at one block and past a tile.  Its states' gradients
    run to the hundreds: held within STATE_ATOL of their largest."""
    stages = (("cascade", (("lp", 0.995), ("gain", 0.7))),
              ("ew", "distort:Atan", (1.2,)),
              ("cascade", (("bq", (-1.9, 0.9025, 0.2, 0.1, 0.0)),)))
    x, st, cts, recs, want = _case(stages, (), 2, T, 3)
    _held(_walk(stages, st, cts, recs, 2, T), want, stages, scaled=True)
    assert float(want[1][0].abs().max()) > 0.1     # the seeds carry weight


@pytest.mark.parametrize("which", ["y", "hists"])
@pytest.mark.parametrize("name", ["mtap config2", "mtap config5"])
def test_walk_mtap_crosses_tiles_and_history(name, which):
    """A chorus whose taps reach back past the tile's start (the ring
    across tiles) and, in the first tile, into the history; with the
    cotangent on y alone and on the histories alone (the new history's
    cotangent reaching back into x and, past a render shorter than L,
    into the old history)."""
    stages, lfos = _model_lists()[name]
    for T, B in ((2 * KT * C + C, 1), (5 * C, 2)):
        x, st, cts, recs, want = _case(stages, lfos, B, T, T, which)
        _held(_walk(stages, st, cts, recs, B, T), want, stages)
        L = int(next(s for s in stages if s[0] == "mtap")[2])
        q, r, _ = st[-3:]
        tp = (np.repeat(q.numpy().astype(np.int64), C)
              + r.numpy().astype(np.int64) + np.arange(T)
              - int(next(s for s in stages if s[0] == "mtap")[3]) * C)
        assert (np.diff(tp) >= 0).all()           # monotone: runs
        assert tp.min() < 0 and tp.min() >= -L    # into the history
        if T > KT * C:                            # across a tile's start
            assert (tp[KT * C:KT * C + 4 * C] < KT * C).any()


def test_fuzz_ties_and_clip_edges_in_the_walk():
    """Fuzz with tied block maxima and a shaper at its clip edges, in the
    walk against the plain version."""
    stages = (("cascade", (("gain", 1.0),)), ("ew", "distort:Fuzz", (2.0,)),
              ("ew", "distort:HardClip", (1.0,)))
    B, T = 2, 3 * C
    rng = np.random.default_rng(9)
    x = (rng.standard_normal((B, T)) * 0.3).astype(np.float32)
    x[0, 5] = x[0, 9] = 0.8                  # a tied maximum
    x[0, 7] = -0.8
    x[1, C:C + 4] = [1.0, -1.0, 0.5, -0.5]   # clip edges after Fuzz
    xt = torch.from_numpy(x)
    st = (torch.zeros(B, 2),)
    outs, recs = tcs.segment_fallback(xt, stages, st, record=True)
    flat = tcs.flatten_outputs(outs)
    cts = tuple(torch.from_numpy((rng.standard_normal(tuple(o.shape)) * 0.5)
                                 .astype(np.float32)) for o in flat)
    want = tcs.segment_adjoint(cts, (xt.shape, st[0].shape), stages, recs,
                               st)
    _held(_walk(stages, st, cts, recs, B, T), want, stages)


# -- (b) the model pinned to the source --------------------------------------

def test_fragment_indices_pinned_to_the_source():
    """The kernel's fragment indices are the ones ``fragments`` uses, and
    what they read is Ltg^T, Ecb^T and W^T."""
    src = SRC.read_text()
    for pat in (r"const float\* hb = hs \+ 8 \* d \+ tig - gid \+ 8;",
                r"b\[d\]\[1\] = hb\[4\];", r"b\[d\]\[2\] = hb\[CK_HP\];",
                r"b\[d\]\[3\] = hb\[CK_HP \+ 4\];",
                r"const int d = k - \(CK_P \* i \+ PAR\);",
                r"ecb \+ gid \* CK_C \+ 8 \* k \+ tig;",
                r"cc\.w \+ \(8 \* \(CK_P \* i \+ par\) \+ gid\) \* CK_NS "
                r"\+ tig;"):
        assert re.search(pat, src), pat
    sections = (("bq", (-0.3, 0.05, 0.8, 0.1, 0.0)), ("lp", 0.4))
    Lh, Ll, Eh, El, Wh, Wl, act = fragments(sections)
    Ltg, Wp, Ecb, ACt, _ = tck._casc_consts(sections)
    np.testing.assert_allclose((Lh + Ll).numpy(), Ltg.T, rtol=0,
                               atol=2e-7 * np.abs(Ltg).max())
    np.testing.assert_allclose((Eh + El).numpy(), Ecb.T, rtol=0,
                               atol=2e-7 * np.abs(Ecb).max())
    np.testing.assert_allclose((Wh + Wl).numpy(), Wp.T, rtol=0,
                               atol=2e-7 * np.abs(Wp).max())
    assert np.array_equal(act.numpy(), ACt)


def test_walk_pinned_to_the_source():
    """The walk the model repeats: tiles from the last, the stages in
    reverse, the carry adjoint from the tile's end with the seed on the
    last block, the comb's chains and ring, the mtap's run starts and its
    two ring buffers, the histories after the walk."""
    src = SRC.read_text()
    for pat in (r"for \(int tile = n_tiles - 1, it = 0; tile >= 0;",
                r"for \(int s = n_stages - 1; s >= 0;\)",
                r"for \(int s = s1 - 1; s >= s0; --s\)",
                r"for \(int jb = t\.KTv - 1; jb >= 0; --jb\)",
                r"if \(t\.b0 \+ jb == t\.K - 1 && cc\.seed_c != nullptr\)",
                r"s0\[u\] = i < nch \? Lv - 1 - i : -1;",
                r"ring\[\(t0 \+ Lv - 1 - min\(i, nch - 1\) \+ D\) % RL\]",
                r"if \(tt < D\) gh\[tt\] = __fmul_rn\(v, decay\);",
                r"for \(int s = threadIdx\.x; s < min\(RL, Lv\); "
                r"s \+= CK_NT\)",
                r"const float\* rin = buf \+ \(\(tile \+ 1\) & 1\) \* RL;",
                r"float\* const rout = buf \+ \(tile & 1\) \* RL;",
                r"if \(s == 0 \|\| tap_of\(rg, t0 \+ s - 1, NH\) != tp\)",
                r"const int i = tp - \(t0 - RL\);",
                r"if \(p >= t0 \+ Lv - RL\) "
                r"v = rin\[p - \(t0 \+ Lv - RL\)\] \+ v;",
                r"if \(s >= Lv - RL\) v = v \+ rin\[s - \(Lv - RL\)\];",
                r"float v = buf0\[j - R\.n \+ RL\];",
                r"return __ldg\(rg\.mq \+ \(t >> 7\)\) \+ "
                r"__ldg\(rg\.mr \+ t\) \+ t - NH \* CK_C;"):
        assert re.search(pat, src), pat


# -- (c) the packed records and the wrapper -----------------------------------

def _struct_size(src, name):
    body = re.search(r"typedef struct \{([^{}]*)\} " + name + ";",
                     src).group(1)
    size = 0
    for decl in re.findall(r"^\s*([^/\n][^;]*);", body, re.M):
        n_fields = decl.count(",") + 1
        arr = re.search(r"\[(\d+)\]", decl)
        width = 8 if ("*" in decl or "long long" in decl) else 4
        size += width * n_fields * (int(arr.group(1)) if arr else 1)
    return size


def test_record_sizes_match_cuda_source():
    """The reverse's cascade and ring records are the CUDA structs' (its
    header and stage records are the forward's, chain_tiles.cuh), and its
    shared memory's base size the source's."""
    src = SRC.read_text()
    assert _struct_size(src, "CrvCasc") == tcr.CASC.itemsize == 64
    assert _struct_size(src, "CrvRing") == tcr.RING.itemsize == 64
    tiles = (SRC.parent / "chain_tiles.cuh").read_text()
    assert _struct_size(tiles, "CkHeader") == tck.HEADER.itemsize
    assert _struct_size(tiles, "CkStage") == tck.STAGE.itemsize
    base = re.search(r"SMEM_BASE =\s*\(([^;]*)\) \* \(int\)sizeof\(float\);",
                     src).group(1)
    vals = {"CK_M": KT, "CK_LD": 132, "CK_CLD": 12, "CK_HP": 136}
    assert 4 * eval(re.sub(r"CK_\w+", lambda m: str(vals[m.group(0)]),
                           base)) == tcr.SMEM_BASE


def test_packed_reverse_program():
    """The reverse packs the forward's layout with its own records: the
    stage records with each shaper's ordinal and chebyshev's two
    denominators, 64-byte cascade and ring records, the taps' cotangents
    and the records after them."""
    stages = chip_smoke.long_list()
    records, (n_casc, n_ring, n_tap) = tcr.reverse_records(stages)
    ews = [i for i, s in enumerate(stages) if s[0] == "ew"]
    assert [int(records[i]["rec"]) for i in ews] == list(range(len(ews)))
    cheb = next(i for i, s in enumerate(stages) if s[1:2] == ("chebyshev",))
    for lvl, den in zip(stages[cheb][2], records[cheb]["p"][2:]):
        want = np.float32(np.tanh(np.float32(lvl)))
        assert abs(float(den) - float(want)) <= 2e-7
    casc = [tuple(range(8 * i + 1, 8 * i + 9)) for i in range(n_casc)]
    ring = [(9000 + i, 0, 1, 0, 0, 0, 300, 0) for i in range(n_ring)]
    taps = [7000 + i for i in range(n_tap)]
    recs = [8000 + i for i in range(len(ews))]
    buf = tck.pack_program(records, casc, ring, taps, recs, tcr.CASC,
                           tcr.RING)
    hdr = np.frombuffer(buf[:tck.HEADER.itemsize].tobytes(), tck.HEADER)[0]
    offs = tck.layout(len(stages), n_casc, n_ring, n_tap, len(recs),
                      tcr.CASC, tcr.RING)
    assert [int(hdr[k]) for k in ("off_stage", "off_casc", "off_ring",
                                  "off_tap", "off_rec")] == list(offs[:5])
    assert buf.size == offs[5]

    def part(off, dt, n):
        return np.frombuffer(buf[off:off + n * dt.itemsize].tobytes(), dt)

    assert [tuple(int(v) for v in c)
            for c in part(offs[1], tcr.CASC, n_casc)] == casc
    assert [tuple(int(v) for v in r)[:8]
            for r in part(offs[2], tcr.RING, n_ring)] == ring
    assert list(part(offs[3], np.dtype("<u8"), n_tap)) == taps
    assert list(part(offs[4], np.dtype("<u8"), len(recs))) == recs


def test_reverse_call_refusals():
    """The wrapper raises before any launch: on the CPU, a missing record,
    counts that do not match the list, a T that is not whole blocks, an
    mtap whose run starts would not fit in shared memory."""
    stages = chip_smoke.bench_stages()
    B, T = 2, 256
    z = torch.zeros(B, T)
    seeds = ((None, None),) * 2
    before = tcr.LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        tcr.chain_reverse_call(z, (), seeds, (None,), (z, z, z), stages, (),
                               B, T, torch.device("cpu"))
    cuda = torch.device("cuda", 0)
    with pytest.raises(ValueError, match="recorded"):
        tcr.chain_reverse_call(z, (), seeds, (None,), (z, None, z), stages,
                               (), B, T, cuda)
    with pytest.raises(ValueError, match="list of"):
        tcr.chain_reverse_call(z, (), seeds, (), (z, z, z), stages, (), B, T,
                               cuda)
    with pytest.raises(ValueError, match="multiple"):
        tcr.chain_reverse_call(z, (), seeds, (None,), (z, z, z), stages, (),
                               B, T + 5, cuda)
    big = (("mtap", 0.5, 40_000, 313, 10, 136),)
    with pytest.raises(ValueError, match="shared memory"):
        tcr.chain_reverse_call(z, (), (), (None,), (), big, (z, z, z), B, T,
                               cuda)
    assert tcr.LAUNCHES == before
    assert tcr.run_span(stages) == 0
    assert tcr.run_span(big) == 314 * C + KT * C
