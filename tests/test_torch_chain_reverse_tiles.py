"""The reverse chain kernel's tile walk (csrc/chain_reverse_kernel.cu), on
the CPU.

The CUDA kernel runs only on a GPU (chip_smoke.py holds it against
``segment_adjoint`` there).  Here:

(a) ``reverse_walk``, a PyTorch model of the kernel's walk written for
    this test: a row a CTA, its tiles of 64 blocks from the last to the
    first, the stages of each tile in reverse; every shaper record, tap
    cotangent and mtap r and frac read through a model of the kernel's
    operand ring (``Slots``: issued at the kernel's barriers, slot q %
    nslot, a wait that fails on an operand issued late or overwritten
    early); the cascade's 3xTF32 products with the transposed Toeplitz
    fragments as the kernel indexes them and the carry adjoint as the
    kernel's scan by 8 chunks of 8 blocks (``carry_scan``, with the
    wrapper's packed powers; running between tiles, the info seeds on the
    render's last block); the comb's chains backwards over the ring of
    later adjoints (zeros on the walk's first tile); the mtap's t' by
    output, the run starts written over the inputs the outputs read
    (each once, none read unwritten) and the gather over runs, written
    back in chunks in the tile's order, with the two-buffer ring of
    pending input adjoints; the shapers' derivatives, the taps'
    cotangents; the histories' gradients after the walk.  It is held
    against ``segment_adjoint`` on every list the smoke run checks and at
    the edges: T = 128, a ragged last tile, combs of D < 128, 128, 2,049,
    2,400 and past a tile, mtap taps that cross a tile and reach into the
    history, a chorus at its longest, fewer slots than operands; the scan
    alone at 1, 2, 4 and 8 lanes against the one thread's walk and
    float64; the comb's split;
(b) the model's fragment indices, operand ring, scan, comb split, mtap
    t', run starts and ring buffers pinned to the CUDA source by regex (a
    new walk gets its model first);
(c) the reverse's packed records and operand table against the CUDA
    structs, the packed powers against NumPy, the shared-memory layout
    against the source's SMEM_BASE, the chebyshev denominators in its
    stage records, and the wrapper's refusals before any launch.

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
XC = 8              # mtap inputs a thread gathers before a barrier (CRV_XC)
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


def mv(y, x, P):
    """mv<N>: y[k] + sum_j x[j] P[j][k], one fmaf a j in order (float64
    products of float32 values are exact; the sum rounds to float32), over
    the leading axis of y and x [L, N]."""
    y = np.asarray(y, np.float32).copy()
    for j in range(x.shape[-1]):
        y = (x[..., j:j + 1].astype(np.float64)
             * P[j, :y.shape[-1]].astype(np.float64)
             + y.astype(np.float64)).astype(np.float32)
    return y


def carry_scan(V, c0, P, KTv, seed=None, seed_row=-1):
    """rscan_warp: the carry adjoint over a tile's KTv blocks by 8 lanes of
    a chunk of 8 blocks, V [64, N] and the running adjoint c0 [N] (f32),
    the powers P [4, 8, 8] ((ACt^T)^p, p = 1, 8, 16, 32); ``seed`` [N]
    added on block ``seed_row``.  Each chunk's sum from its end, a
    log-depth scan over the chunks, each chunk again from the adjoint
    entering it.  Returns (Cn [64, 8]: per block the adjoint of the carry
    leaving it, zeros past N; the adjoint entering block 0)."""
    N = V.shape[1]
    cw = tcr.CHUNK
    nl = 64 // cw
    x = np.zeros((64, N), np.float32)
    x[:KTv] = V[:KTv]
    if seed is not None and 0 <= seed_row < 64:
        x[seed_row] = x[seed_row] + seed.astype(np.float32)
    x[KTv - 1] = mv(x[KTv - 1:KTv], c0[None, :N], P[0])[0]
    X = x.reshape(nl, cw, N)
    S = X[:, cw - 1].copy()                     # a chunk's sum
    for u in reversed(range(cw - 1)):
        S = mv(X[:, u], S, P[0])
    lanes = np.arange(nl)
    for i in range(1, len(tcr.POWERS)):
        d = 1 << (i - 1)
        y = np.zeros_like(S)
        y[:nl - d] = S[d:]
        S = np.where((lanes + d < nl)[:, None], mv(S, y, P[i]), S)
    c = np.zeros_like(S)                        # entering each chunk
    c[:nl - 1] = S[1:]
    Cn = np.zeros((64, NS), np.float32)
    for u in reversed(range(cw)):
        Cn[lanes * cw + u, :N] = c
        c = mv(X[:, u], c, P[0])
    Cn[KTv - 1, :N] = c0[:N]
    return Cn, c[0]


def comb_split(nch):
    """comb_rev's split of nch chains over 256 threads: (chains a thread,
    passes, chains a pass)."""
    cb = -(-nch // 256)
    np_ = -(-cb // 16)
    return cb, np_, -(-cb // np_)


def _run_starts(tp, lo, hi):
    """mtap_rev's first[] over [lo, hi], from the tile's t' (relative to
    t0 - RL): output s writes the inputs past its predecessor's tap, its
    own first; -2 marks what no output writes (never read)."""
    first = np.full(hi + 2, -2, np.int64)
    for s in range(len(tp)):
        i1 = tp[s]
        for i in range(tp[s - 1] + 1 if s > 0 else i1, i1 + 1):
            first[i] = s if i == i1 else -1
    assert (first[lo:hi + 1] != -2).all()        # each input written
    return first


def _gather(first, tp, a, b, lo, hi, Lv, ids):
    """mtap_gather for the inputs ``ids`` (relative to t0 - RL): the run of
    outputs from first[i] whose tap is i (a, their first-tap parts), then
    the run from first[i - 1] whose tap is i - 1 (b), summed from 0 in
    output order; first[] read only over [lo, hi]."""
    out = np.zeros(len(ids), np.float32)
    for want, parts, ok, fi in (
            (ids, a, (ids >= lo) & (ids <= hi), ids),
            (ids - 1, b, (ids > lo) & (ids <= hi + 1), ids - 1)):
        s = np.where(ok, first[np.clip(fi, 0, len(first) - 1)], -1)
        assert (s[ok] != -2).all()
        live = s >= 0
        while live.any():
            sc = np.clip(s, 0, Lv - 1)
            live &= (s < Lv) & (tp[sc] == want)
            out = np.where(live, out + np.where(live, parts[sc], 0.0)
                           .astype(np.float32), out).astype(np.float32)
            s = s + 1
    return out


class Slots:
    """The kernel's operand ring (Stager): operand q (n_ops a tile, in
    walk order) copied at its issue into slot q % nslot, read back at its
    wait, which fails if the slot holds another operand (issued late or
    overwritten early)."""

    def __init__(self, ops, nslot, n_tiles, K, row):
        self.ops, self.nslot, self.n_tiles = ops, nslot, n_tiles
        self.K, self.row = K, row
        self.n_ops = len(ops)
        self.total = self.n_ops * n_tiles
        self.issued = 0
        self.slot = [None] * nslot

    def upto(self, q):
        while self.issued < min(q, self.total):
            it, j = divmod(self.issued, self.n_ops)
            b0 = (self.n_tiles - 1 - it) * KT
            n = min(KT, self.K - b0) * C
            src = self.ops[j]
            src = src[self.row] if src.dim() == 2 else src
            self.slot[self.issued % self.nslot] = (
                self.issued, src[b0 * C:b0 * C + n].clone())
            self.issued += 1

    def wait(self, q):
        held = self.slot[q % self.nslot]
        assert held is not None and held[0] == q, (q, held and held[0])
        return held[1]


def reverse_walk(ct_y, ct_taps, seeds, ct_hists, recs, stages, shared, B,
                 T, dev=None):
    """The reverse chain kernel's walk in PyTorch, ``chain_reverse_call``'s
    arguments and returns (x's gradient [B, T], per stateful stage its
    gradient: a cascade's [B, 8], a history's [B, n])."""
    K = T // C
    n_tiles = -(-K // KT)
    taps_live = {i for i, t in enumerate(ct_taps) if t is not None}
    records, _ = tcr.reverse_records(stages, taps_live)
    order = tcr.operands(stages, taps_live)
    nslot = tcr.layout(stages, len(order))[0]
    ordinal = [int(r["rec"]) for r in tck.plan(stages)[0]]
    ops, mi = [], 0
    mtaps = {}
    for i, st in enumerate(stages):
        if st[0] == "mtap":
            mtaps[i] = shared[3 * mi:3 * mi + 3]
            mi += 1
    for i, what in order:
        if what == "rec":
            ops.append(recs[ordinal[i]])
        elif what == "tap":
            ops.append(ct_taps[int(stages[i][1])])
        else:
            ops.append(mtaps[i][1 if what == "r" else 2].view(torch.float32))
    casc, rings = [], []
    for st in stages:
        if st[0] == "cascade":
            casc.append(dict(m=_fragments(st[1]), g=torch.zeros(B, NS),
                             pw=tcr.casc_powers(st[1]),
                             seed=seeds[len(casc)]))
        elif st[0] == "comb":
            D = int(st[2])
            rings.append(dict(ring=torch.full((B, -(-D // C) * C), np.nan),
                              g=torch.zeros(B, D)))
        elif st[0] == "mtap":
            NH = int(st[3])
            rings.append(dict(ring=torch.full((B, 2, (NH + 1) * C), np.nan),
                              g=torch.zeros(B, int(st[2]))))
    gx = torch.zeros(B, T)
    for row in range(B):
        sg = Slots(ops, nslot, n_tiles, K, row)
        sg.upto(nslot)
        carry = [np.zeros(NS, np.float32) for _ in casc]
        for it, tile in enumerate(reversed(range(n_tiles))):
            base = it * len(ops)
            nj = rel = 0
            sg.upto(base + nslot)
            b0 = tile * KT
            KTv = min(KT, K - b0)
            Lv, t0 = KTv * C, b0 * C
            F = torch.zeros(KT * C)
            if ct_y is not None:
                F[:Lv] = ct_y[row, t0:t0 + Lv]
            ci = len(casc)
            ri = len(rings)
            prev_ew = False
            for si in reversed(range(len(stages))):
                st, rec = stages[si], records[si]
                kind = st[0]
                if kind not in ("scale", "ew", "tap") and prev_ew:
                    rel = nj                  # the stage's opening barrier
                    sg.upto(base + rel + nslot)
                prev_ew = kind in ("scale", "ew", "tap")
                if kind == "scale":
                    F = F * float(rec["p"][0])
                    continue
                if kind in ("ew", "tap"):
                    j = int(rec["rec"])
                    if j < 0:
                        continue
                    if j >= rel + nslot:      # a barrier inside the run
                        rel = j
                        sg.upto(base + rel + nslot)
                    op = torch.zeros(KT * C)
                    op[:Lv] = sg.wait(base + j)[:Lv]
                    nj = j + 1
                    if kind == "tap":
                        F[:Lv] = F[:Lv] + op[:Lv]
                    else:
                        F[:Lv] = tcyc.ew_adjoint(
                            st[1], F[:Lv].reshape(-1, C),
                            op[:Lv].reshape(-1, C), st[2]).reshape(Lv)
                    continue
                if kind == "cascade":
                    ci -= 1
                    cs = casc[ci]
                    Lh, Ll, Eh, El, Wh, Wl, _ = cs["m"]
                    N = int(rec["n"])
                    Y = F.reshape(KT, C)
                    P = _mm3(Y, Lh, Ll)
                    V = _mm3(Y, Eh, El).numpy()
                    seed_c = cs["seed"][1]
                    Cn, carry[ci] = carry_scan(
                        V[:, :N], carry[ci][:N].copy(), cs["pw"], KTv,
                        None if seed_c is None else seed_c[row, :N].numpy(),
                        K - 1 - b0)
                    carry[ci] = np.pad(carry[ci], (0, NS - N))
                    if b0 == 0:
                        cs["g"][row] = torch.from_numpy(carry[ci])
                    X = P + _mm3(torch.from_numpy(Cn), Wh, Wl)
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
                        later = ring[(t0 + sd) % RL] if it else \
                            torch.zeros(len(s))
                        prev = torch.where(sd < Lv, F[sd.clamp(max=Lv - 1)],
                                           later)
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
                    s = torch.arange(RL if it == 0 else min(RL, Lv))
                    ring[(t0 + s) % RL] = torch.where(
                        s < Lv, F[s.clamp(max=KT * C - 1)], 0.0)
                else:                                           # mtap
                    ri -= 1
                    rg = rings[ri]
                    NH, mix = int(rec["n"]), float(rec["p"][0])
                    L = int(st[2])
                    RL = (NH + 1) * C
                    j = int(rec["rec"])
                    r = sg.wait(base + j)[:Lv].numpy().view(np.int32)
                    fr = sg.wait(base + j + 1)[:Lv].numpy()
                    nj = j + 2
                    q = mtaps[si][0]
                    s = np.arange(Lv)
                    tp = (q.numpy().astype(np.int64)[(t0 + s) >> 7]
                          + r.astype(np.int64) + s + C)
                    lo, hi = int(tp[0]), int(tp[-1])
                    rin = (rg["ring"][row, (tile + 1) & 1].numpy().copy()
                           if it else np.zeros(RL, np.float32))
                    rout = rg["ring"][row, tile & 1]
                    g = F[:Lv].numpy()
                    gw = (g * np.float32(mix)).astype(np.float32)
                    a = (gw * (np.float32(1.0) - fr)).astype(np.float32)
                    b = (gw * fr).astype(np.float32)
                    first = _run_starts(tp, lo, hi)
                    ids = np.arange(RL)
                    v = _gather(first, tp, a, b, lo, hi, Lv, ids)
                    v = np.where(ids >= Lv, rin[np.clip(ids - Lv, 0, RL - 1)]
                                 + v, v)
                    rout[:] = torch.from_numpy(v.astype(np.float32))
                    cth = ct_hists[ri]
                    for c0 in range(0, Lv, 256 * XC):   # chunks, in order
                        g = F[:Lv].numpy().copy()      # as written so far
                        gw = (g * np.float32(mix)).astype(np.float32)
                        a = (gw * (np.float32(1.0) - fr)).astype(np.float32)
                        b = (gw * fr).astype(np.float32)
                        s = np.arange(c0, min(c0 + 256 * XC, Lv))
                        xin = (g[s] * (np.float32(1.0) - np.float32(mix))
                               ).astype(np.float32)
                        xin = xin + _gather(first, tp, a, b, lo, hi, Lv,
                                            RL + s)
                        xin = np.where(s >= Lv - RL,
                                       xin + rin[np.clip(s - (Lv - RL), 0,
                                                         RL - 1)], xin)
                        if cth is not None:
                            tt = t0 + s
                            on = tt >= T - L
                            xin = np.where(on, xin + cth[row].numpy()[
                                np.clip(tt - (T - L), 0, L - 1)], xin)
                        F[s] = torch.from_numpy(xin.astype(np.float32))
                rel = nj                      # the stage's closing barrier
                sg.upto(base + rel + nslot)
            sg.upto(base + len(ops) + nslot)  # the tile's end
            gx[row, t0:t0 + Lv] = F[:Lv]
        assert sg.issued == sg.total
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


@pytest.mark.parametrize("D", [100, 128, 2049, 2400, KT * C + 476])
def test_walk_comb_delays(D):
    """A comb shorter than a block, of one block, of 2,049 and 2,400 (the
    chain counts that left a pass of the old split mostly empty; rings in
    shared memory) and longer than a tile (its ring spans tiles, in device
    memory), behind a cascade and a shaper, over three tiles and a ragged
    one, cotangents on every output."""
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


def _scan_case(N, KTv, seed):
    """A carry-adjoint scan's operands at N lanes: a cascade of that many
    (N = 1 a one-pole step embedded in the 8 lanes), V [64, N], c0."""
    rng = np.random.default_rng(N * 100 + KTv)
    if N == 1:
        P = np.zeros((len(tcr.POWERS), NS, NS), np.float32)
        P[:, 0, 0] = [np.float32(0.53) ** p for p in tcr.POWERS]
    else:
        secs = ((("lp", 0.995), ("gain", 0.7)),
                (("bq", (-0.3, 0.05, 0.8, 0.1, 0.0)),
                 ("bq", (-1.2, 0.5, 0.3, 0.1, 0.0))),
                (("bq", (-0.3, 0.05, 0.8, 0.1, 0.0)),
                 ("bq", (-1.2, 0.5, 0.3, 0.1, 0.0)),
                 ("bq", (-0.5, 0.1, 0.3, 0.1, 0.0)),
                 ("bq", (0.2, 0.3, 0.3, 0.1, 0.0))))[{2: 0, 4: 1, 8: 2}[N]]
        assert tck._casc_consts(secs)[4] == N
        P = tcr.casc_powers(secs)
    V = (rng.standard_normal((64, N)) * 10).astype(np.float32)
    c0 = (rng.standard_normal(N) * 100).astype(np.float32)
    sd = (rng.standard_normal(N) * 50).astype(np.float32) if seed else None
    return P, V, c0, sd


@pytest.mark.parametrize("seed", [False, True])
@pytest.mark.parametrize("KTv", [KT, 37, 1])
@pytest.mark.parametrize("N", [1, 2, 4, 8])
def test_carry_scan_lanes(N, KTv, seed):
    """The scan by 8 chunks (rscan_warp's model) at N = 1, 2, 4 and 8
    lanes, a full and a ragged tile and a one-block one, with a seed on
    the last block: against the one thread's walk in f32 within 4 ulp of
    the largest adjoint, and against float64 within 1e-6 of it."""
    P, V, c0, sd = _scan_case(N, KTv, seed)
    got, out = carry_scan(V, c0, P, KTv, sd, KTv - 1)
    A = P[0][:N, :N]
    walk = np.zeros((64, NS), np.float32)
    ref = np.zeros((64, N))
    c, c64 = c0.copy(), c0.astype(np.float64)
    for j in reversed(range(KTv)):
        walk[j, :N], ref[j] = c, c64
        x = V[j:j + 1].copy()
        x64 = V[j].astype(np.float64)
        if sd is not None and j == KTv - 1:
            x, x64 = x + sd, x64 + sd
        c = mv(x, c[None], P[0])[0]
        c64 = x64 + c64 @ A.astype(np.float64)
    scale = max(np.abs(ref).max(), np.abs(c64).max())
    ulp = np.spacing(np.float32(scale))
    np.testing.assert_allclose(got, walk, rtol=0, atol=4 * ulp)
    np.testing.assert_allclose(out, c, rtol=0, atol=4 * ulp)
    np.testing.assert_allclose(got[:, :N], ref, rtol=0, atol=1e-6 * scale)
    np.testing.assert_allclose(out, c64, rtol=0, atol=1e-6 * scale)
    assert not got[KTv:].any() and not got[:, N:].any()


@pytest.mark.parametrize("D", [100, 2049, 2400, KT * C, KT * C + 476])
def test_comb_split_even(D):
    """comb_rev's split of a tile's chains: every chain once, in passes of
    at most CR_CB a thread that differ by at most one chain; 2,049 and
    2,400 chains in one pass (the old split ran 2,048 and then a second
    pass of 1 or 352), a tile's 8,192 in two of 16."""
    nch = min(D, KT * C)
    cb, n_pass, per = comb_split(nch)
    seen = []
    for u0 in range(0, cb, per):
        live = [x + (u0 + u) * 256 for x in range(256) for u in range(per)
                if x + (u0 + u) * 256 < nch]
        seen += live
        assert per <= 16
    assert sorted(seen) == list(range(nch))
    assert -(-cb // per) == n_pass == -(-cb // 16)
    if nch <= 4096:
        assert n_pass == 1


def _chorus(rate, depth, base, mix=0.5):
    """An mtap stage as the planner builds it, and its LFO."""
    from dsp_stuff_tpu_torch.ops import modfx
    L = modfx.max_delay_samples(base, depth)
    NH, EV, RS = modfx.mtap_static(rate, depth, base, L)
    return ("mtap", mix, L, NH, EV, RS), (rate, depth, base)


@pytest.mark.parametrize("T", [2 * KT * C + 3 * C, 7 * C])
def test_walk_mtap_long_delay(T):
    """A chorus at its longest (base 50 ms + depth 20 ms: L = 3,362, 27
    history blocks): runs of outputs that cross a tile's start and reach
    into the history from the first tiles, under a cascade, over two tiles
    and a ragged one and a render shorter than the history."""
    mt, lfo = _chorus(0.8, 0.02, 0.05)
    assert mt[3] >= 27
    stages = (("cascade", (("hp", 0.2),)), ("scale", 0.9), mt)
    x, st, cts, recs, want = _case(stages, (lfo,), 2, T, T)
    _held(_walk(stages, st, cts, recs, 2, T), want, stages)


@pytest.mark.parametrize("nslot", [1, 2, 3])
@pytest.mark.parametrize("name", ["40 stages", "taps", "bench"])
def test_walk_with_fewer_slots(name, nslot):
    """The operand ring with fewer slots than a tile has operands (the 40
    stages' 18: a run of up to 2 shapers and taps takes barriers on its
    way): every operand issued before its wait and never overwritten
    before its use (Slots asserts both), gradients as with a slot each."""
    stages = (chip_smoke.long_list() if name == "40 stages"
              else chip_smoke.reverse_lists()[name][0])
    B, T = 1, KT * C + 3 * C
    x, st, cts, recs, want = _case(stages, (), B, T, nslot)
    with chip_smoke.capped_slots(nslot):
        _held(_walk(stages, st, cts, recs, B, T), want, stages)


@pytest.mark.parametrize("name", ["40 stages", "comb D=8,668"])
def test_reverse_edge_lists(name):
    """The lists chip_smoke holds the kernel to on the card past
    reverse_lists() reach the kernel's rarer paths: the 40 stages have
    more operands a tile than slots and cascades whose constants are
    copied in at their stage (coff -1), the long comb its ring in device
    memory (soff -1); chip_smoke.capped_slots caps the slots and puts
    the layout back.  The walk over each against the plain version."""
    stages, lfos = chip_smoke.reverse_edge_lists()[name]
    n_ops = len(tcr.operands(stages))
    nslot, _, _, soffs, coffs = tcr.layout(stages, n_ops)
    if name == "40 stages":
        assert n_ops == 18 and nslot == tcr.SLOTS
        assert -1 in coffs and max(coffs) >= 0
    else:
        assert int(stages[2][2]) > KT * C and soffs == (-1,)
    B, T = 1, KT * C + 3 * C
    x, st, cts, recs, want = _case(stages, lfos, B, T, 12)
    _held(_walk(stages, st, cts, recs, B, T), want, stages)
    if name == "40 stages":
        with chip_smoke.capped_slots(1):
            assert tcr.layout(stages, n_ops)[0] == 1
        assert tcr.layout(stages, n_ops)[0] == nslot


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
    what they read is Ltg^T, Ecb^T (from its copy es, row stride CK_LD, in
    shared memory) and W^T."""
    src = SRC.read_text()
    for pat in (r"const float\* hb = hs \+ 8 \* d \+ tig - gid \+ 8;",
                r"b\[d\]\[1\] = hb\[4\];", r"b\[d\]\[2\] = hb\[CK_HP\];",
                r"b\[d\]\[3\] = hb\[CK_HP \+ 4\];",
                r"const int d = k - \(CK_P \* i \+ PAR\);",
                r"es \+ gid \* CK_LD \+ 8 \* k \+ tig;",
                r"eb\[CK_NS \* CK_LD\],",
                r"es\[\(i >> 7\) \* CK_LD \+ \(i & \(CK_C - 1\)\)\] = "
                r"__ldg\(cc\.ecb \+ i\);",
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
    reverse; the operand ring (its slot and phase, the barriers that
    refill it, a barrier inside a run that outgrows it); the carry
    adjoint's chunks, scan and second pass with the seed and the running
    adjoint on the tile's last block; the comb's even split, first-tile
    zeros and ring; the mtap's t', run starts and gather ranges and its
    two ring buffers; the histories after the walk."""
    src = SRC.read_text()
    for pat in (r"for \(int tile = n_tiles - 1, it = 0; tile >= 0;",
                r"for \(int s = n_stages - 1; s >= 0;\)",
                r"for \(int s = s1 - 1; s >= s0; --s\)",
                # the operand ring
                r"const int slot = q % sg\.nslot;",
                r"const uint32_t parity = \(q / sg\.nslot\) & 1;",
                r"const int b0 = \(n_tiles - 1 - it\) \* CK_M;",
                r"if \(S\.rec >= rel \+ sg\.nslot\) \{",
                r"stage_upto\(sg, base \+ rel \+ sg\.nslot, t, n_tiles\);",
                r"stage_upto\(sg, base \+ nslot, t, n_tiles\);",
                r"stage_upto\(sg, base \+ sg\.n_ops \+ nslot, t, n_tiles\);",
                r"cp\.async\.bulk\.shared::cluster\.global\.mbarrier::"
                r"complete_tx::bytes",
                # the carry adjoint
                r"#define CRV_CW %d\b" % tcr.CHUNK,
                r"#define CRV_XC %d\b" % XC,
                r"y\[k\] = fmaf\(x\[j\], P\[j \* CK_NS \+ k\], y\[k\]\);",
                r"const int js = t\.K - 1 - t\.b0;",
                r"if \(cc\.seed_c != nullptr && js < t\.KTv\)",
                r"y\[k\] = v\[\(t\.KTv - 1\) \* CK_CLD \+ k\];\s*"
                r"mv<N>\(y, c0, pw\);",
                r"if \(u < CRV_CW - 1\) mv<N>\(y, S, pw\);",
                r"y\[k\] = __shfl_down_sync\(0xffffffffu, S\[k\], d, CRV_CW\);",
                r"if \(l \+ d < CRV_CW\) mv<N>\(S, y, pw \+ i \* CK_NS \* "
                r"CK_NS\);",
                r"cn\[j \* CK_CLD \+ k\] = j == t\.KTv - 1 \? c0\[k\] : c\[k\];",
                # the comb
                r"#define CR_CB 16\b",
                r"const int cb = \(nch \+ CK_NT - 1\) / CK_NT;",
                r"const int np = \(cb \+ CR_CB - 1\) / CR_CB;",
                r"const int per = \(cb \+ np - 1\) / np;",
                r"s0\[u\] = live \? Lv - 1 - i : -1;",
                r"const int r0 = \(t0 \+ Lv - 1 \+ D\) % RL;",
                r"const int r = r0 - i;",
                r"prev\[u\] = live && !first \? ring\[r < 0 \? r \+ RL : r\] "
                r": 0\.0f;",
                r"const bool edge = \(cth != nullptr && t0 \+ Lv > tail\) "
                r"\|\| t0 < D;",
                r"if \(t0 \+ s < D\) gh\[t0 \+ s\] = __fmul_rn\(v, decay\);",
                r"const float v = __fadd_rn\(g\[u\], __fmul_rn\(prev\[u\], "
                r"decay\)\);",
                r"ring\[r < RL \? r : r - RL\] = s < Lv \?",
                r"for \(int s = threadIdx\.x; s < \(first \? RL : min\(RL, Lv\)\);",
                # the mtap
                r"q\[k\] = __ldg\(mq \+ \(\(t0 \+ s\) >> 7\)\);",
                r"if \(s < Lv\) tp\[s\] = q\[k\] \+ r\[k\] \+ s \+ CK_C;",
                r"const int s = threadIdx\.x \+ \(c \+ k\) \* CK_NT;",
                r"const int i1 = a\[k\], i0 = s > 0 \? b\[k\] \+ 1 : i1;",
                r"if \(i0 <= i1\) first\[i1\] = s;",
                r"if \(i0 < i1\) first\[i1 - 1\] = -1;",
                r"for \(int i = i0; i < i1 - 1; \+\+i\) first\[i\] = -1;",
                r"const int s1 = i >= lo && i <= hi \? first\[i\] : -1;",
                r"const int s2 = i > lo && i <= hi \+ 1 \? first\[i - 1\] : -1;",
                r"const bool in_b = s1 >= 0 && sa \+ 1 < Lv && tp\[sb\] == i;",
                r"if \(LONG && in_b\)\s*for \(int s = sa \+ 2; s < Lv && "
                r"tp\[s\] == i; \+\+s\)",
                r"longer = longer \|\| \(i0 > i1 && s > 1 && c\[k\] == i1\);",
                r"const bool long_runs = __syncthreads_or\(longer\);",
                r"const float\* rin = buf \+ \(\(tile \+ 1\) & 1\) \* RL;",
                r"float\* const rout = buf \+ \(tile & 1\) \* RL;",
                r"rout\[i\] = !firstw && i >= Lv \? rin\[i - Lv\] \+ gs\[k\] : "
                r"gs\[k\];",
                r"float v = F\[\(s >> 7\) \* CK_LD \+ \(s & \(CK_C - 1\)\)\] \* "
                r"dry \+ xin\[k\];",
                r"if \(!firstw && s >= Lv - RL\) v = v \+ rin\[s - \(Lv - RL\)\];",
                r"float v = buf0\[j - R\.n \+ RL\];"):
        assert re.search(pat, src), pat
    # the ring is refilled at each stage's two barriers
    assert len(re.findall(r"rel = nj;\s*stage_upto\(sg, base \+ rel \+ "
                          r"nslot, t, n_tiles\);", src)) == 2


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
    """The reverse's cascade, ring and operand records are the CUDA
    structs' (its header and stage records are the forward's,
    chain_tiles.cuh), and its shared memory's base size the source's."""
    src = SRC.read_text()
    assert _struct_size(src, "CrvCasc") == tcr.CASC.itemsize == 64
    assert _struct_size(src, "CrvRing") == tcr.RING.itemsize == 48
    assert _struct_size(src, "CrvOp") == tcr.OP.itemsize == 16
    tiles = (SRC.parent / "chain_tiles.cuh").read_text()
    assert _struct_size(tiles, "CkHeader") == tck.HEADER.itemsize
    assert _struct_size(tiles, "CkStage") == tck.STAGE.itemsize
    vals = {"CK_M": KT, "CK_LD": 132, "CK_CLD": 12, "CK_HP": 136, "CK_NS": NS,
            "CRV_NPOW": tcr.NPOW}

    def value(expr):
        return eval(re.sub(r"C[A-Z_]+", lambda m: str(vals[m.group(0)]),
                           " ".join(expr.split())))
    vals["CRV_CONSTS"] = value(re.search(r"#define CRV_CONSTS \((.*)\)",
                                         src).group(1))
    assert 4 * vals["CRV_CONSTS"] == tcr.CONSTS_BYTES == 10_560
    base = re.search(r"SMEM_BASE =\s*\(([^;]*)\) \* \(int\)sizeof\(float\)"
                     r"\s*\+ 8 \* 8;", src).group(1)
    assert 4 * value(base) + 64 == tcr.SMEM_BASE == 84_352
    for name, val in (("CRV_SLOTS", tcr.SLOTS), ("CRV_NPOW", tcr.NPOW),
                      ("CRV_CW", tcr.CHUNK)):
        assert re.search(r"#define %s %d\b" % (name, val), src), name


@pytest.mark.parametrize("sections", [
    (("lp", 0.995), ("gain", 0.7)),
    (("bq", (-1.9, 0.9025, 0.2, 0.1, 0.0)),),
    (("bq", (-0.3, 0.05, 0.8, 0.1, 0.0)), ("bq", (-1.2, 0.5, 0.3, 0.1, 0.0)),
     ("bq", (-0.5, 0.1, 0.3, 0.1, 0.0)), ("bq", (0.2, 0.3, 0.3, 0.1, 0.0)))])
def test_casc_powers_against_numpy(sections):
    """The powers (ACt^T)^p the wrapper packs, p = 1, 8, 16, 32, against
    NumPy's matrix powers of the f32 ACt^T (in float64, rounded to
    float32) within 1e-6 of each power's largest entry, and against
    NumPy's float32 matrix powers within 1e-5 of ACt^T's largest entry
    (float32's own repeated products lose the small powers' digits);
    ACt^T itself exact; zero past N."""
    P = tcr.casc_powers(sections)
    act = tck._casc_consts(sections)[3]
    N = tck._casc_consts(sections)[4]
    assert P.dtype == np.float32 and P.shape == (tcr.NPOW, NS, NS)
    assert tcr.POWERS == (1, 8, 16, 32)
    assert np.array_equal(P[0], act.T)
    for Pi, p in zip(P, tcr.POWERS):
        want = np.linalg.matrix_power(act.T.astype(np.float64), p)
        np.testing.assert_allclose(Pi, want.astype(np.float32), rtol=0,
                                   atol=1e-6 * max(np.abs(want).max(),
                                                   1e-30))
        f32 = np.linalg.matrix_power(act.T.astype(np.float32), p)
        np.testing.assert_allclose(Pi, f32, rtol=0,
                                   atol=1e-5 * np.abs(act).max())
        assert not Pi[N:].any() and not Pi[:, N:].any()


def test_shared_memory_layout():
    """layout's slots, rings, constants and run starts against the
    source's SMEM_BASE: a slot an operand up to SLOTS (two at least with
    an mtap), 32 B a cascade, a comb's ring of a tile or less in shared
    memory, then each cascade's constants while they fit, the run starts
    last; every part 16-byte aligned and within a CTA's 232,448 B; the
    kernel built for one CTA an SM, a CTA a row, whatever the list."""
    lists = dict(chip_smoke.reverse_lists())
    lists["40 stages"] = (chip_smoke.long_list(), ())
    want = {"bench": (3, 213_568), "mtap_config5": (2, 196_320),
            "mtap_config2": (2, 186_752), "40 stages": (4, 228_320)}
    for name, (stages, _) in lists.items():
        n_ops = len(tcr.operands(stages))
        nslot, smem, first_off, soffs, coffs = tcr.layout(stages, n_ops)
        n_casc = sum(1 for st in stages if st[0] == "cascade")
        assert nslot == min(n_ops, tcr.SLOTS)
        slots = tcr.SMEM_BASE + 32 * n_casc
        off = slots + nslot * tcr.SLOT_BYTES
        rings = [st for st in stages if st[0] in ("comb", "mtap")]
        for st, so in zip(rings, soffs):
            rl = 4 * (-(-int(st[2]) // C) * C)
            if so >= 0:
                assert st[0] == "comb" and rl <= tcr.SLOT_BYTES
                assert so * 4 == off and off % 16 == 0
                off += rl
            else:
                assert st[0] == "mtap" or rl > tcr.SLOT_BYTES
        assert len(coffs) == n_casc
        for co in coffs:
            if co >= 0:
                assert co * 4 == off and off % 16 == 0
                off += tcr.CONSTS_BYTES
        assert first_off * 4 == off and slots % 16 == 0
        assert smem == off + 4 * tcr.run_span(stages) <= tcr.SMEM_MAX
        if name in want:
            assert (nslot, smem) == want[name], name
    plain = (("cascade", (("lp", 0.4),)), ("comb", 0.5, 300))
    nslot, smem, _, soffs, coffs = tcr.layout(plain, 0)
    assert nslot == 0 and soffs[0] >= 0 and coffs[0] >= 0
    src = SRC.read_text()
    assert re.search(r"__global__ void __launch_bounds__\(CK_NT, 1\)\s*"
                     r"chain_reverse_kernel\(", src)
    assert "template <int CTAS>" not in src
    assert re.search(r"kern<<<B, CK_NT, smem,", src)
    assert not hasattr(tcr, "geometry")


def test_packed_reverse_program():
    """The reverse packs the forward's layout with its own records: the
    stage records with each stage's first operand in the walk's order
    (shapers, live taps, an mtap's r then frac; -1 elsewhere) and
    chebyshev's two denominators, 64-byte cascade and 48-byte ring
    records, no tap table and the operand table (source, row stride)."""
    stages = chip_smoke.long_list()
    live = {0, 2, 3, 8}
    records, (n_casc, n_ring, n_tap) = tcr.reverse_records(stages, live)
    order = tcr.operands(stages, live)
    walk = [i for i in reversed(range(len(stages)))
            if stages[i][0] == "ew" or (stages[i][0] == "tap"
                                        and stages[i][1] in live)]
    assert [i for i, _ in order] == walk
    for i, st in enumerate(stages):
        j = int(records[i]["rec"])
        if i in walk:
            assert order[j][0] == i
        else:
            assert j == -1
    cheb = next(i for i, s in enumerate(stages) if s[1:2] == ("chebyshev",))
    for lvl, den in zip(stages[cheb][2], records[cheb]["p"][2:]):
        want = np.float32(np.tanh(np.float32(lvl)))
        assert abs(float(den) - float(want)) <= 2e-7
    mt, _ = _chorus(1.0, 0.003, 0.01)
    ms = (("ew", "distort:Tanh", (2.0,)), mt, ("tap", 0))
    assert tcr.operands(ms, {0}) == [(2, "tap"), (1, "r"), (1, "frac"),
                                     (0, "rec")]
    assert [int(r["rec"]) for r in tcr.reverse_records(ms, {0})[0]] == \
        [3, 1, 0]
    casc = [tuple(range(8 * i + 1, 8 * i + 9)) for i in range(n_casc)]
    ring = [(9000 + i, 0, 1, 0, 300, 0, -1, 0) for i in range(n_ring)]
    ops = [v for k in range(len(order)) for v in (8000 + 16 * k, 480_000)]
    buf = tck.pack_program(records, casc, ring, [], ops, tcr.CASC, tcr.RING)
    hdr = np.frombuffer(buf[:tck.HEADER.itemsize].tobytes(), tck.HEADER)[0]
    offs = tck.layout(len(stages), n_casc, n_ring, 0, len(ops), tcr.CASC,
                      tcr.RING)
    assert [int(hdr[k]) for k in ("off_stage", "off_casc", "off_ring",
                                  "off_tap", "off_rec")] == list(offs[:5])
    assert int(hdr["n_tap"]) == 0 and buf.size == offs[5]

    def part(off, dt, n):
        return np.frombuffer(buf[off:off + n * dt.itemsize].tobytes(), dt)

    assert [tuple(int(v) for v in c)[:8]
            for c in part(offs[1], tcr.CASC, n_casc)] == casc
    assert [tuple(int(v) for v in r)
            for r in part(offs[2], tcr.RING, n_ring)] == ring
    assert [(int(o["src"]), int(o["ld"]))
            for o in part(offs[4], tcr.OP, len(order))] == \
        [(8000 + 16 * k, 480_000) for k in range(len(order))]


def test_reverse_call_refusals():
    """The wrapper raises before any launch: on the CPU, a missing record,
    counts that do not match the list, a T that is not whole blocks, an
    mtap whose run starts would not fit in shared memory beside its two
    operand slots."""
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
    # the longest chorus a node allows (70 ms) fits, 12,300 samples do not
    for L, ok in ((3362, True), (12_160, True), (12_300, False)):
        mt = (("mtap", 0.5, L, -(-L // C), 10, 136),)
        if ok:
            assert tcr.layout(mt, 2)[1] <= tcr.SMEM_MAX
        else:
            with pytest.raises(ValueError, match="shared memory"):
                tcr.layout(mt, 2)
    assert tcr.LAUNCHES == before
    assert tcr.run_span(stages) == 0
    assert tcr.run_span(big) == 314 * C + KT * C
