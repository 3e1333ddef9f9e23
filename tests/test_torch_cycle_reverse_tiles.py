"""A CPU model of the reverse cycle kernel's cascade step
(dsp_stuff_tpu_torch/csrc/cycle_reverse_kernel.cu: cr_hold and
cr_cascade_held), held against the transposed products in float64.

The kernel runs only on a GPU.  This model repeats its per-thread index
arithmetic and its float32 operations in its order, over the forward's
packed constants (ops/cycle_kernel.cycle_casc_consts), for one block of
rows: thread t = 4q + e of warp w = t / 32 holds, for each of its steps
s < 8 - 2w (the same count for every lane of a warp), h[k0 - 3 .. k0 + 4]
with k0 = 4(m - q) and m = 8w + e + 4s, two aligned float4s of the first
reversed copy read backwards (zeros below h[0]); it sums, for the four
columns 4q + d of its quad, gy[4m + f] h[4(m - q) + f - d] into an even
and an odd sum a column (fmaf), adds the two, and the quad's lanes trade
partial sums across lane bits 0 and 1 (three shuffles) so that lane d
ends with column d; W^T's column adds gc' W^T.  Warp 3's lane (j, r)
sums gy's quarter r against Ecb's row j (two sums, fmaf), the four
quarters meet across lane bits 3 and 4, and lanes j < 8 add gc' ACt^T:
the carry adjoint entering the block.

``walk_step`` is imported by tests/test_torch_cycle_reverse.py, whose
model of the whole kernel runs it in place of the matrix products.  The
model's step counts and index arithmetic are pinned to the CUDA source by
regex.
"""

import functools
import pathlib
import re

import numpy as np
import pytest

from dsp_stuff_tpu_torch.ops import cycle_kernel as tck
from dsp_stuff_tpu_torch.ops.chain_kernel import _casc_consts

SRC = (pathlib.Path(__file__).resolve().parents[1] / "dsp_stuff_tpu_torch"
       / "csrc" / "cycle_reverse_kernel.cu")
C, NS = 128, 8
T_ = np.arange(C)
W, E, Q = T_ >> 5, T_ & 3, T_ >> 2        # warp, lane in quad, quad
QW = Q & 7                                # quad within the warp
NSTEP = 8 - 2 * W                         # steps of each thread's warp
F32, F64 = np.float32, np.float64
RTOL = 1e-6

#: the four cascades of test_torch_cycle_reverse.py's
#: test_transposed_constants_read_back
SECTIONS = [(("lp", 0.4),), (("lp", 0.3), ("gain", 1.2)),
            (("bq", (-0.5, 0.1, 0.3, 0.2, 0.1)), ("hp", 0.2)),
            (("lp", 0.2), ("hp", 0.1), ("gain", 1.3), ("lp", 0.3))]


def fma(a, b, c):
    """fmaf in float32: the product is exact in float64, one rounding."""
    return (np.asarray(a, F64) * np.asarray(b, F64)
            + np.asarray(c, F64)).astype(F32)


def step_m(s):
    """m of every thread at step s (past a thread's steps: unused)."""
    return 8 * W + E + 4 * s


def k0_of(s):
    return 4 * (E + 4 * s - QW)


@functools.lru_cache(maxsize=None)
def hold(sections: tuple):
    """What cr_hold loads, per thread: hv [128, 8 steps, 8] (h[k0 - 3 +
    i] at i), the first float of each float4 read in copy 0 [128, 8, 2]
    (-1 past a thread's steps), W^T's column [NS, 128], Ecb [NS, 128],
    ACt [NS, NS] and N."""
    k = tck.cycle_casc_consts(sections)
    R0 = k[tck.OFF_R:tck.OFF_R + tck.RS]
    hv = np.zeros((C, 8, 8), F32)
    reads = np.full((C, 8, 2), -1)
    for s in range(8):
        on = s < NSTEP
        k0 = k0_of(s)
        for t in np.nonzero(on)[0]:
            j_lo, j_hi = 128 - k0[t], 124 - k0[t]
            reads[t, s] = j_lo, j_hi
            lo = R0[j_lo:j_lo + 4][::-1]           # read backwards
            hi = R0[j_hi:j_hi + 4][::-1]
            hv[t, s] = np.concatenate([lo, hi])
    Wt = k[tck.OFF_W:tck.OFF_E].reshape(NS, tck.WS)[:, :C]
    return (hv, reads, Wt, k[tck.OFF_E:tck.OFF_A].reshape(NS, C),
            k[tck.OFF_A:].reshape(NS, NS), _casc_consts(sections)[4])


def product(hv, gy):
    """The quad walk of gy [B, 128] f32: sum_{i >= c} gy[i] h[i - c] for
    every column c, in the kernel's order (the shuffles included)."""
    B = gy.shape[0]
    g4 = gy.reshape(B, 32, 4)
    pe = np.zeros((B, C, 4), F32)
    po = np.zeros((B, C, 4), F32)
    for s in range(8):
        on = s < NSTEP
        gv = g4[:, np.minimum(step_m(s), 31)]          # [B, 128, 4]
        hh = hv[:, s]                                  # [128, 8]
        for d in range(4):
            for f, acc in ((0, pe), (1, po), (2, pe), (3, po)):
                acc[:, :, d] = np.where(
                    on, fma(gv[:, :, f], hh[:, 3 + f - d], acc[:, :, d]),
                    acc[:, :, d])
    return quad_sum((pe + po).astype(F32))


def quad_sum(p):
    """The quad's shuffles on partial sums p [B, 128, 4] (lane t's sums of
    columns 4q + d): lane e keeps columns e & 1 and (e & 1) + 2 and adds
    its neighbour's across lane bit 0, then keeps column e and adds its
    neighbour's across bit 1.  Returns [B, 128], lane t's column t."""
    odd, up = (E & 1).astype(bool), (E & 2).astype(bool)
    sel = np.where
    u0 = (sel(odd, p[..., 1], p[..., 0])
          + sel(odd, p[..., 0], p[..., 1])[:, T_ ^ 1]).astype(F32)
    u1 = (sel(odd, p[..., 3], p[..., 2])
          + sel(odd, p[..., 2], p[..., 3])[:, T_ ^ 1]).astype(F32)
    return (sel(up, u1, u0) + sel(up, u0, u1)[:, T_ ^ 2]).astype(F32)


def carry(Ecb, ACt, N, gy, gn):
    """Warp 3's carry adjoint: gc [B, NS] = gy Ecb^T + gn ACt^T, lane (j,
    r) = (lane % 8, lane / 8) summing quarter r, in the kernel's order."""
    B = gy.shape[0]
    lane = np.arange(32)
    j, r = lane & 7, lane >> 3
    s0 = np.zeros((B, 32), F32)
    s1 = np.zeros((B, 32), F32)
    for t in range(8):
        i = 32 * r + 4 * t
        for f, acc in ((0, s0), (1, s1), (2, s0), (3, s1)):
            acc[:] = fma(gy[:, i + f], Ecb[j, i + f], acc)
    s = (s0 + s1).astype(F32)
    s = (s + s[:, lane ^ 8]).astype(F32)
    s = (s + s[:, lane ^ 16]).astype(F32)
    tt = np.zeros((B, NS), F32)
    for k2 in range(N):
        tt = fma(gn[:, k2:k2 + 1], ACt[:NS, k2], tt)
    return (s[:, :NS] + tt).astype(F32)


def walk_step(sections, gy, gn):
    """cr_cascade_held's sums on gy [B, 128] and the carry adjoint leaving
    the block gn [B, NS] (f32): (gX [B, 128], gc [B, NS]) before the
    seeds."""
    hv, _, Wt, Ecb, ACt, N = hold(tuple(sections))
    gy = np.asarray(gy, F32)
    gn = np.asarray(gn, F32)
    wsum = np.zeros((gy.shape[0], C), F32)
    for j in range(N):
        wsum = fma(gn[:, j:j + 1], Wt[j], wsum)
    gx = (product(hv, gy) + wsum).astype(F32)
    return gx, carry(Ecb, ACt, N, gy, gn)


def _inputs(seed, B=5):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, C)).astype(F32),
            rng.standard_normal((B, NS)).astype(F32))


def _max_err(got, want):
    return float(np.abs(np.asarray(got, F64) - want).max()
                 / np.abs(want).max())


# -- the walk's coverage ---------------------------------------------------

@pytest.mark.parametrize("sections", SECTIONS)
def test_triangle_summed_once(sections):
    """Every (column c, gy index i) pair with i >= c is summed exactly
    once, with weight h[i - c]; a product outside the triangle reads a
    zero of the padded copy; every float4 read lies inside copy 0 and is
    16-byte aligned."""
    hv, reads, *_ = hold(tuple(sections))
    h = _casc_consts(sections)[0][0]
    count = np.zeros((C, C), int)
    for t in range(C):
        for s in range(NSTEP[t]):
            m = step_m(s)[t]
            for d in range(4):
                col = 4 * Q[t] + d
                for f in range(4):
                    i, k = 4 * m + f, 4 * (m - Q[t]) + f - d
                    assert k == i - col and k <= C - 1
                    w = hv[t, s, 3 + f - d]
                    if k < 0:
                        assert w == 0.0, (t, s, d, f)
                    else:
                        assert w == h[k], (t, s, d, f)
                        count[col, i] += 1
    np.testing.assert_array_equal(count, np.triu(np.ones((C, C), int)))
    on = reads >= 0
    assert (reads[on] % 4 == 0).all()
    assert reads[on].min() >= 0 and reads[on].max() + 3 < tck.RS
    assert (tck.OFF_R % 4) == 0


def test_warp_uniform_steps_and_banks():
    """A warp's lanes run the same count of steps, its steps cover the
    gy float4s 8w..31 its columns need exactly once, and at each step its
    lanes load four gy float4s on four distinct bank groups (m mod 8)."""
    for w in range(4):
        lanes = np.arange(32 * w, 32 * w + 32)
        assert len(set(NSTEP[lanes])) == 1
        ms = [step_m(s)[lanes] for s in range(NSTEP[lanes[0]])]
        seen = np.concatenate([np.unique(m) for m in ms])
        assert sorted(seen.tolist()) == list(range(8 * w, 32))
        assert min(4 * Q[lanes]) == 32 * w and max(4 * Q[lanes] + 3) <= 127
        for m in ms:
            assert len(np.unique(m)) == 4
            assert len(np.unique(m % 8)) == 4
            assert (m <= 31).all()


def test_quad_shuffles_give_each_lane_its_column():
    """The three shuffles sum the quad's four partials of column d into
    lane d: a one-hot partial (lane src, column col) comes out in the
    quad's lane col, once, and nowhere else."""
    for src in range(4):
        for col in range(4):
            p = np.zeros((1, C, 4), F32)
            p[0, E == src, col] = 1.0
            np.testing.assert_array_equal(quad_sum(p)[0],
                                          (E == col).astype(F32))


# -- the model against float64 ---------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("sections", SECTIONS)
def test_walk_matches_transposed_product(sections, seed):
    """gX of the walk within 1e-6 (max-normalized) of gy Ltg^T + gc' W^T
    in float64."""
    Ltg, Wp, _, _, N = _casc_consts(sections)
    gy, gn = _inputs(seed)
    gn[:, N:] = 0.0                     # lanes past N carry nothing
    gx, _ = walk_step(sections, gy, gn)
    want = gy.astype(F64) @ Ltg.T.astype(F64) + gn[:, :N].astype(F64) @ \
        Wp.T[:N].astype(F64)
    assert _max_err(gx, want) <= RTOL


@pytest.mark.parametrize("sections", SECTIONS)
def test_carry_lanes_match_transposed_product(sections):
    """Warp 3's carry adjoint within 1e-6 of gy Ecb^T + gc' ACt^T in
    float64."""
    _, _, Ecb, ACt, N = _casc_consts(sections)
    gy, gn = _inputs(7)
    gn[:, N:] = 0.0
    _, gc = walk_step(sections, gy, gn)
    want = gy.astype(F64) @ Ecb.T.astype(F64) + gn.astype(F64) @ \
        ACt.T.astype(F64)
    assert _max_err(gc, want) <= RTOL


def test_walk_of_an_impulse_is_the_toeplitz_row():
    """gy = e_i gives column c the weight h[i - c] exactly (one product a
    column, the rest zeros): the walk reads each weight where it lies."""
    sections = SECTIONS[2]
    Ltg = _casc_consts(sections)[0]
    gy = np.eye(C, dtype=F32)
    gx, _ = walk_step(sections, gy, np.zeros((C, NS), F32))
    np.testing.assert_array_equal(gx, Ltg.T)


# -- pinned to the CUDA source ---------------------------------------------

def test_model_pinned_to_the_source():
    """The step count, the steps' m, the copies' float4 offsets, the
    products' weights and the shuffle masks of the model, as
    cr_hold and cr_cascade_held write them."""
    src = SRC.read_text()
    hold_src = src[src.index("void cr_hold("):src.index("void cr_partials(")]
    step_src = src[src.index("void cr_partials("):
                   src.index("float cr_cascade(CrCtx")]
    assert re.search(r"const int ns = 8 - 2 \* w;", hold_src)
    cases = re.findall(r"case (\d): prod = cr_product<(\d)>", step_src)
    cases += re.findall(r"(default): \{[^}]*cr_partials<(\d)>", step_src)
    assert [(int(w.replace("default", "3")), int(n)) for w, n in cases] == [
        (w, 8 - 2 * w) for w in range(4)]
    assert re.search(r"const int k0 = 4 \* \(e \+ 4 \* s - qw\);", hold_src)
    assert re.search(r"R4\[\(128 - k0\) >> 2\], hi = R4\[\(124 - k0\) >> 2\]",
                     hold_src)
    assert "make_float4(lo.w, lo.z, lo.y, lo.x)" in hold_src
    assert re.search(r"kc \+ CY_OFF_R\)", hold_src)
    assert re.search(r"\(GY\) \+ 8 \* w \+ e;", step_src)
    for f, acc, k in ((0, "pe", "x"), (1, "po", "y"), (2, "pe", "z"),
                      (3, "po", "w")):
        assert (f"{acc}[d] = fmaf(gv[s].{k}, hh[{3 + f} - d], {acc}[d]);"
                in step_src)
    assert step_src.count("__shfl_xor_sync") == 5     # 1, 1, 2; 8, 16
    for f, k in enumerate("xyzw"):
        assert f"s{f % 2} = fmaf(yv.{k}, ev.{k}, s{f % 2});" in step_src
    assert "float s = s0 + s1;" in step_src
    assert "for (int s = 0; s < NSTEP; ++s) gv[s] = G4[4 * s];" in step_src
    for mask in (", 1)", ", 2)", ", 8)", ", 16)"):
        assert mask in step_src
