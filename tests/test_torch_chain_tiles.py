"""The chain kernel's tile schedule (csrc/chain_kernel.cu), on the CPU.

The CUDA kernel runs only on a GPU (chip_smoke.py holds it against
``segment_fallback`` there).  Here:

(a) the wrapper's geometry: a CTA a row, the build for one CTA an SM up
    to one row an SM and for two past it; x copied where its start is not
    16-byte aligned;
(b) ``tile_walk``, a PyTorch model of the kernel's walk written for this
    test (a row a CTA in tiles of 64 blocks: the 3xTF32 product of each
    [64, 128] tile with the packed Toeplitz row and W, the carry scan over
    the tile's blocks, the C Ecb product, comb rounds and the mtap ring, a
    ragged last tile, the raw outputs at the render's last block), held
    against ``segment_fallback`` on every list the smoke run checks;
(c) the packed stage program's layout (ops/chain_kernel.pack_program),
    its record sizes against the CUDA source, and a list of 40 stages
    packed up to the wrapper's device check.

Bounds: y and taps <= -120 dBFS and states within 1e-5 against the plain
version: the model rounds in float32 like the kernel, in another order,
and its TF32 parts keep 22 of float32's 24 bits per product."""

import functools
import pathlib
import re

import numpy as np
import pytest
import torch

import chip_smoke
from dsp_stuff_tpu_torch.ops import chain_kernel as tck
from dsp_stuff_tpu_torch.ops import chain_segment as tcs
from dsp_stuff_tpu_torch.utils import precision as tprec

C = 128
Y_DB = -120.0
STATE_ATOL = 1e-5
KT = tck.M_TILE                   # blocks of a tile
B_MODEL = 3
T_MODEL = 3 * KT * C + 5 * C      # three tiles and a ragged one


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


# -- (a) geometry ----------------------------------------------------------

@pytest.mark.parametrize("B", [1, 3, 128, 512, 1024, 4099])
def test_geometry_covers_every_row_once(B):
    n_sm = 132
    grid, ctas = tck.geometry(B, n_sm)
    assert grid == B                   # CTA b walks row b
    assert ctas == (1 if B <= n_sm else 2)
    assert tck.geometry(B, B)[1] == 1 and tck.geometry(B + 1, B)[1] == 2
    with pytest.raises(ValueError):
        tck.geometry(0, n_sm)


def test_misaligned_x_is_copied():
    """The kernel loads x 16 bytes a lane: a view whose start is not
    16-byte aligned reaches it as an aligned copy, an aligned one as
    itself."""
    base = torch.arange(4 * C + 4, dtype=torch.float32)
    ok = base[:4 * C].view(4, C)
    assert tck.aligned(ok) is ok
    for off in (1, 2, 3):
        v = base[off:off + 4 * C].view(4, C)
        assert v.is_contiguous() and v.data_ptr() % 16
        got = tck.aligned(v)
        assert got.data_ptr() % 16 == 0
        assert torch.equal(got, v)


# -- (b) the tile walk -----------------------------------------------------

def _split(a: torch.Tensor):
    """3xTF32 parts (hi, lo) of float32 ``a`` (cvt.rna.tf32.f32)."""
    hi, lo = tck.tf32_split(a.numpy())
    return torch.from_numpy(hi), torch.from_numpy(lo)


def _mm3(a, bh, bl):
    ah, al = _split(a)
    return al @ bh + ah @ bl + ah @ bh


def _casc_mats(sections):
    """([Ltg | W] hi and lo [128, 136], Ecb hi and lo [8, 128], ACt) from
    the packed constants, Ltg built from the padded Toeplitz row."""
    arr, offs, _ = tck.casc_tile_consts(tuple(sections))
    hp = arr[offs[0]:offs[1]].reshape(2, C + 8)
    w = arr[offs[1]:offs[2]].reshape(2, C, 8)
    e = arr[offs[2]:offs[3]].reshape(2, 8, C)
    act = arr[offs[3]:].reshape(8, 8)
    i = np.arange(C)
    d = i[None, :] - i[:, None]                  # c - i
    mats = []
    for part in range(2):
        ltg = np.where(d >= 0, hp[part][np.clip(d, -8, C - 1) + 8], 0.0)
        mats.append(torch.from_numpy(np.concatenate(
            [ltg, w[part]], axis=1).astype(np.float32)))
    return (mats[0], mats[1], torch.from_numpy(e[0]), torch.from_numpy(e[1]),
            torch.from_numpy(act))


def tile_walk(x, stages, state_in):
    """The chain kernel's walk in PyTorch: a CTA a row, tiles of KT = 64
    blocks, the stages on each [64, 128] tile in order.  Returns the
    kernel's raw outputs (y, casc_raw, rings, taps)."""
    B, T = x.shape
    K = T // C
    records, (_, _, n_tap) = tck.plan(stages)
    casc, rings, ring_views = [], [], []
    taps = [torch.zeros(B, T) for _ in range(n_tap)]
    si = 0
    for st in stages:
        if st[0] == "cascade":
            N = tck.casc_tile_consts(st[1])[2]
            carry = torch.zeros(B, 8)
            carry[:, :N] = state_in[si]
            si += 1
            casc.append((_casc_mats(st[1]), carry, torch.zeros(B, 8),
                         torch.zeros(B, C)))
        elif st[0] == "comb":
            D = int(st[2])
            RL = -(-D // C) * C
            rings.append((tck._seeded_ring(state_in[si], B, D, RL,
                                           torch.device("cpu"), "comb"),))
            si += 1
        elif st[0] == "mtap":
            L, NH = int(st[2]), int(st[3])
            RL = (NH + 1) * C
            rings.append((tck._seeded_ring(state_in[si], B, L, RL,
                                           torch.device("cpu"), "mtap"),
                          *state_in[si + 1:si + 4]))
            si += 4
    y = torch.zeros(B, T)
    for row in range(B):
        for b0 in range(0, K, KT):
            KTv = min(KT, K - b0)
            Lv, t0 = KTv * C, b0 * C
            F = torch.zeros(KT * C)                 # M-row m: block b0 + m
            F[:Lv] = x[row, t0:t0 + Lv]
            ci = ri = 0
            for st, rec in zip(stages, records):
                kind = st[0]
                if kind == "cascade":
                    (Lh, Ll, Eh, El, act), carry, cout, xlast = casc[ci]
                    ci += 1
                    if b0 + KTv == K:
                        xlast[row] = F[Lv - C:Lv]
                    Z = _mm3(F.reshape(KT, C), Lh, Ll)      # [64, 136]
                    Cb = torch.zeros(KT, 8)
                    c = carry[row].clone()
                    for jb in range(KTv):
                        Cb[jb] = c
                        if b0 + jb == K - 1:
                            cout[row] = c
                        c = Z[jb, C:] + c @ act
                    carry[row] = c
                    F = (Z[:, :C] + _mm3(Cb, Eh, El)).reshape(KT * C)
                elif kind == "scale":
                    F[:Lv] *= float(rec["p"][0])
                elif kind == "ew":
                    F[:Lv] = tcs.apply_ew(st[1], F[:Lv].reshape(-1, C),
                                          st[2]).reshape(Lv)
                elif kind == "tap":
                    taps[st[1]][row, t0:t0 + Lv] = F[:Lv]
                elif kind == "comb":
                    (ring,) = rings[ri]
                    ri += 1
                    D, decay = int(st[2]), float(rec["p"][0])
                    RL = ring.shape[1]
                    span = min(D, Lv)
                    for lo in range(0, Lv, span):
                        s = torch.arange(lo, min(lo + span, Lv))
                        sd = s - D
                        yd = torch.where(sd >= 0, F[sd.clamp(min=0)],
                                         ring[row, (t0 + sd) % RL])
                        F[s] = F[s] + yd * decay
                    s = torch.arange(Lv - min(RL, Lv), Lv)
                    ring[row, (t0 + s) % RL] = F[s]
                else:                                       # mtap
                    ring, q, rr, fr = rings[ri]
                    ri += 1
                    NH, mix = int(st[3]), float(rec["p"][0])
                    RL = ring.shape[1]
                    t = torch.arange(t0, t0 + Lv)
                    tm = (q.long()[t // C] - NH * C + rr.long()[t] + t)
                    ab = [torch.where(u >= t0, F[(u - t0).clamp(0, Lv - 1)],
                                      ring[row, u % RL])
                          for u in (tm, tm + 1)]
                    wet = ab[0] * (1.0 - fr[t]) + ab[1] * fr[t]
                    out = F[:Lv] * (1.0 - mix) + wet * mix
                    s = torch.arange(Lv - min(RL, Lv), Lv)
                    ring[row, (t0 + s) % RL] = F[s]
                    F[:Lv] = out
            y[row, t0:t0 + Lv] = F[:Lv]
    casc_raw = tuple((cout, xlast) for _, _, cout, xlast in casc)
    ring_raw = tuple(g[0].view(B, -1, C) for g in rings)
    return y, casc_raw, ring_raw, tuple(taps)


@functools.lru_cache(maxsize=1)
def _model_lists():
    lists = {name: (stages, ()) for name, stages
             in chip_smoke.check_lists().items()}
    lists.update(chip_smoke.mtap_lists())
    kt_len = KT * C
    for D in (100, kt_len, kt_len + 476):
        lists[f"comb D={D}"] = ((("cascade", (("lp", 0.4),)),
                                 ("comb", 0.45, D)), ())
    return lists


@pytest.mark.parametrize("name", sorted(_model_lists()))
def test_tile_walk_matches_fallback(name):
    stages, lfos = _model_lists()[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    x = torch.from_numpy((rng.standard_normal((B_MODEL, T_MODEL)) * 0.3)
                         .astype(np.float32))
    st = chip_smoke.seeded_states(stages, B_MODEL, rng, "cpu", T=T_MODEL,
                                  lfos=lfos)
    y, casc_raw, ring_raw, taps = tile_walk(x, stages, st)
    cinfos, hists = tcs.rebuild_states(stages, T_MODEL, casc_raw, ring_raw)
    want = tcs.segment_fallback(x, stages, st)
    assert _dbfs(y.numpy(), want[0].numpy()) <= Y_DB
    assert len(taps) == len(want[3])
    for g, w in zip(taps, want[3]):
        assert _dbfs(g.numpy(), w.numpy()) <= Y_DB
    assert len(cinfos) == len(want[1]) and len(hists) == len(want[2])
    for gi, wi in zip(cinfos, want[1]):
        for g, w in zip(gi, wi):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                       atol=STATE_ATOL)
    for g, w in zip(hists, want[2]):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=STATE_ATOL)


@pytest.mark.parametrize("last", [1, 4, 64])
def test_tile_walk_any_tile_shape(last):
    """The bench list walked with a last tile of 1, 4 and 64 blocks (64:
    no ragged tile)."""
    stages = chip_smoke.bench_stages()
    rng = np.random.default_rng(last)
    B, T = 2, (KT + last) * C
    x = torch.from_numpy((rng.standard_normal((B, T)) * 0.3)
                         .astype(np.float32))
    st = chip_smoke.seeded_states(stages, B, rng, "cpu", T=T)
    y = tile_walk(x, stages, st)[0]
    want = tcs.segment_fallback(x, stages, st)[0]
    assert _dbfs(y.numpy(), want.numpy()) <= Y_DB


def test_tf32_split_rounds_to_nearest_away():
    """hi keeps 10 mantissa bits, rounded to nearest with ties away from
    zero (cvt.rna); hi + lo carries a to 2^-21 of |a|."""
    a = np.array([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12,
                  1.0 / 3.0, -0.1, 3.0e-30, 0.0], np.float32)
    hi, lo = tck.tf32_split(a)
    assert not (hi.view(np.uint32) & 0x1FFF).any()
    assert not (lo.view(np.uint32) & 0x1FFF).any()
    assert hi[0] == np.float32(1.0 + 2.0 ** -10)          # tie, away
    assert hi[1] == -np.float32(1.0 + 2.0 ** -10)
    assert hi[2] == np.float32(1.0)
    err = np.abs(hi.astype(np.float64) + lo - a)
    assert (err <= np.abs(a) * 2.0 ** -21).all()


# -- (c) the packed program ------------------------------------------------

def _decode(buf):
    hdr = np.frombuffer(buf[:tck.HEADER.itemsize].tobytes(), tck.HEADER)[0]

    def part(off, dt, n):
        return np.frombuffer(buf[off:off + n * dt.itemsize].tobytes(), dt)

    return (hdr, part(int(hdr["off_stage"]), tck.STAGE, hdr["n_stages"]),
            part(int(hdr["off_casc"]), tck.CASC, hdr["n_casc"]),
            part(int(hdr["off_ring"]), tck.RING, hdr["n_ring"]),
            part(int(hdr["off_tap"]), np.dtype("<u8"), hdr["n_tap"]))


@pytest.mark.parametrize("which", ["bench", "40 stages"])
def test_packed_program_layout(which):
    stages = (chip_smoke.bench_stages() if which == "bench"
              else chip_smoke.long_list())
    records, (n_casc, n_ring, n_tap) = tck.plan(stages)
    casc_ptrs = [tuple(1000 * (i + 1) + j for j in range(7))
                 for i in range(n_casc)]
    ring_ptrs = [(5000 + i, 0, 0, 0) for i in range(n_ring)]
    tap_ptrs = [9000 + i for i in range(n_tap)]
    buf = tck.pack_program(records, casc_ptrs, ring_ptrs, tap_ptrs)
    hdr, st, casc, ring, taps = _decode(buf)
    want_counts = {"bench": (11, 2, 1, 0), "40 stages": (40, 9, 2, 9)}[which]
    assert (hdr["n_stages"], hdr["n_casc"], hdr["n_ring"],
            hdr["n_tap"]) == want_counts
    offs = [int(hdr[k]) for k in ("off_stage", "off_casc", "off_ring",
                                  "off_tap")]
    assert offs == list(tck.layout(*want_counts)[:4])
    assert all(o % 16 == 0 for o in offs) and offs == sorted(offs)
    assert buf.size == tck.layout(*want_counts)[4] and buf.size % 16 == 0
    assert offs[0] >= tck.HEADER.itemsize
    assert offs[1] >= offs[0] + 32 * want_counts[0]
    np.testing.assert_array_equal(st, records)
    kinds = [tck._KIND[s[0]] for s in stages]
    assert list(st["kind"]) == kinds
    for i, p in enumerate(casc_ptrs):
        assert tuple(casc[i]) == p + (0,)
    assert [tuple(r) for r in ring] == ring_ptrs
    assert list(taps) == tap_ptrs
    # each cascade, ring and tap stage indexes its own record in order
    for kind, n in (("cascade", n_casc), ("tap", n_tap)):
        idx = [int(r["idx"]) for r, s in zip(st, stages) if s[0] == kind]
        assert sorted(idx) == list(range(n))
    ridx = [int(r["idx"]) for r, s in zip(st, stages)
            if s[0] in ("comb", "mtap")]
    assert ridx == list(range(n_ring))


def test_record_sizes_and_codes_match_cuda_source():
    """The packer's record sizes are the CUDA structs' (counted from the
    source's field lists) and the stage kind codes its CK_* codes (the
    header and stage records, shared with the reverse, in
    chain_tiles.cuh)."""
    csrc = pathlib.Path(tck.__file__).parent.parent / "csrc"
    src = "".join((csrc / f).read_text() for f in ("chain_tiles.cuh",
                                                    "chain_kernel.cu"))
    codes = dict(re.findall(r"#define CK_(CASCADE|SCALE|EW|TAP|COMB|MTAP) "
                            r"(\d+)", src))
    assert {k.lower(): int(v) for k, v in codes.items()} == tck._KIND
    for name, dt in (("CkStage", tck.STAGE), ("CkCasc", tck.CASC),
                     ("CkRing", tck.RING), ("CkHeader", tck.HEADER)):
        body = re.search(r"typedef struct \{([^{}]*)\} " + name + ";",
                         src).group(1)
        size = 0
        for decl in re.findall(r"^\s*([^/\n][^;]*);", body, re.M):
            n_fields = decl.count(",") + 1
            arr = re.search(r"\[(\d+)\]", decl)
            width = 8 if ("*" in decl or "long long" in decl) else 4
            size += width * n_fields * (int(arr.group(1)) if arr else 1)
        assert size == dt.itemsize, name


def test_long_list_packs_up_to_the_device_check():
    """A 40-stage list with 9 cascades and 9 taps (past the capacity the
    kernel once had) runs in the plain version, and the wrapper plans and
    packs it and refuses only the CPU tensor, before any launch."""
    stages = chip_smoke.long_list()
    B, T = 2, 512
    rng = np.random.default_rng(40)
    x = torch.from_numpy((rng.standard_normal((B, T)) * 0.3)
                         .astype(np.float32))
    st = chip_smoke.seeded_states(stages, B, rng, "cpu", T=T)
    y, cinfos, hists, taps = tcs.segment_fallback(x, stages, st)
    assert len(cinfos) == 9 and len(taps) == 9 and len(hists) == 2
    assert bool(torch.isfinite(y).all())
    records, counts = tck.plan(stages)
    assert len(records) == 40 and counts == (9, 2, 9)
    before = tck.LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        tck.chain_kernel_call(x, stages, st)
    assert tck.LAUNCHES == before
