"""The port's FIR (dsp_stuff_tpu_torch/ops/fir.py, the Fir node) and its
IR loader (dsp_stuff_tpu_torch/io/) against the JAX package's
(dsp_stuff_tpu/ops/fir.py, io/ir.py) and the per-sample NumPy oracle of
the reference's VecDeque FIR (tests/oracle oracle.fir).

Bounds (dBFS = 20 log10(max|err| / max|reference|)), each with the worst
the CPU measured:
  fir_apply vs JAX and vs oracle.fir, the FIR node from a JAX half-render
                            fast <= -120 (-124.9), parity <= -140 (bitwise:
                            the same f64 sums in the same order)
  warm-up across segments   fast <= -120 (-127.6), parity bitwise
  2 x half vs one call      <= -200 (bitwise)
  chip_smoke.fir_reference (cumsum warm-up + scipy fftconvolve in f64, the
                            smoke's config4 reference) vs oracle.fir
                            <= -130 (-149.2)
  load_ir                   the same taps as the JAX package's, rtol 1e-6
"""

import struct

import numpy as np
import pytest
import torch

import dsp_stuff_tpu as dj
import dsp_stuff_tpu_torch as dt
import oracle
from dsp_stuff_tpu.ops import fir as jfir
from dsp_stuff_tpu_torch import convert
from dsp_stuff_tpu_torch.ids import IdSpace as TIdSpace
from dsp_stuff_tpu_torch.ops import fir as tfir
from dsp_stuff_tpu_torch.utils import precision as tprec

VS_JAX_DB = {"fast": -120.0, "parity": -200.0}
ORACLE_DB = {"fast": -120.0, "parity": -140.0}
CHAIN_DB = -200.0
REF_DB = -130.0
POLICIES = ["fast", "parity"]
# 257 takes the FFT path; 300 taps at T = 4,500 > 4 x 1,024 overlap-save
TAP_COUNTS = [1, 2, 24, 256, 257, 300]


@pytest.fixture(autouse=True)
def _torch_env():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    prev = tprec.get_policy()
    yield
    tprec.set_policy(prev)
    torch.set_num_threads(threads)


def _dbfs(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    return 20 * np.log10(max(err, 1e-30) / max(np.abs(want).max(), 1e-30))


def _case(n_taps, seed, T=None, B=2):
    rng = np.random.default_rng(seed)
    T = T or (4500 if n_taps == 300 else 1536)
    x = (rng.standard_normal((B, T)) * 0.5).astype(np.float32)
    taps_rev = rng.standard_normal(n_taps) * 0.2
    return x, taps_rev


def _divisor(mode, n):
    return np.float32(1.0 / n) if mode == "Average" else np.float32(1.0)


def test_path_switch_points():
    """The taps and lengths above reach the direct, one-transform and
    overlap-save paths."""
    assert tfir.DIRECT_CONV_MAX_TAPS == jfir.DIRECT_CONV_MAX_TAPS == 256
    nfft_os = 1 << max(int(np.ceil(np.log2(2 * 300))), 10)
    assert 4500 + 299 > 4 * nfft_os


@pytest.mark.parametrize("mode", ["Balanced", "Average"])
@pytest.mark.parametrize("pol", POLICIES)
@pytest.mark.parametrize("n_taps", TAP_COUNTS)
def test_fir_apply_matches_jax_and_oracle(n_taps, pol, mode):
    x, taps_rev = _case(n_taps, seed=n_taps)
    div = _divisor(mode, n_taps)
    with dt.policy(pol):
        y, (hist, first, n_seen) = tfir.fir_apply(torch.from_numpy(x),
                                                  taps_rev, None, div)
    with dj.policy(pol):
        yj, (hj, fj, nj) = jfir.fir_apply(x, taps_rev, None, div)
    assert y.dtype == torch.float32 and tuple(y.shape) == x.shape
    assert _dbfs(y.numpy(), np.asarray(yj)) <= VS_JAX_DB[pol]
    want = np.stack([oracle.fir(x[i], taps_rev, mode)[0]
                     for i in range(len(x))])
    assert _dbfs(y.numpy(), want) <= ORACLE_DB[pol]
    if n_taps > 1:
        np.testing.assert_array_equal(hist.numpy(), np.asarray(hj))
        np.testing.assert_array_equal(first.numpy(), np.asarray(fj))
        # the JAX package's raw op keeps per-stream counters for batch state
        assert n_seen == x.shape[-1] and np.all(np.asarray(nj) == n_seen)


@pytest.mark.parametrize("pol", POLICIES)
def test_warmup_crosses_segments(pol):
    """A 200-tap warm-up longer than the first segment (the VecDeque is
    still short when segment two starts), as tests/test_nodes_oracle.py
    holds the JAX package; then a third segment past it."""
    x, taps_rev = _case(200, seed=7, T=768)
    xt = torch.from_numpy(x)
    with dt.policy(pol):
        full, _ = tfir.fir_apply(xt, taps_rev)
        y1, st = tfir.fir_apply(xt[:, :128], taps_rev)
        assert st[2] == 128
        y2, st = tfir.fir_apply(xt[:, 128:256], taps_rev, st)
        y3, st = tfir.fir_apply(xt[:, 256:], taps_rev, st)
    got = torch.cat([y1, y2, y3], dim=-1).numpy()
    assert _dbfs(got, full.numpy()) <= CHAIN_DB
    want = np.stack([oracle.fir(x[i], taps_rev)[0] for i in range(len(x))])
    assert _dbfs(got, want) <= ORACLE_DB[pol]


@pytest.mark.parametrize("n_taps", [37, 300])
def test_half_renders_equal_one(n_taps):
    x, taps_rev = _case(n_taps, seed=11, T=4608)
    xt = torch.from_numpy(x)
    with dt.policy("parity"):
        full, _ = tfir.fir_apply(xt, taps_rev)
        a, st = tfir.fir_apply(xt[:, :2304], taps_rev)
        b, _ = tfir.fir_apply(xt[:, 2304:], taps_rev, st)
    assert _dbfs(torch.cat([a, b], -1).numpy(), full.numpy()) <= CHAIN_DB


def test_smoke_reference_matches_oracle():
    """chip_smoke.py holds config4 on the card against fir_reference,
    since oracle.fir's double loop cannot run 48,000 taps: here the two
    agree at small N, warm-up and steady state."""
    import chip_smoke
    for n_taps, T in ((5, 700), (200, 1500)):
        x, taps_rev = _case(n_taps, seed=n_taps, T=T, B=1)
        want, _ = oracle.fir(x[0], taps_rev)
        assert _dbfs(chip_smoke.fir_reference(x[0], taps_rev), want) <= REF_DB


def _graph(taps_rev, mode):
    g = dt.Graph(TIdSpace())
    inp = g.add("input")
    f = g.add("fir", mode=mode, taps=[float(v) for v in taps_rev])
    out = g.add("output")
    g.chain(inp, f, out)
    return g, f.id


@pytest.mark.parametrize("pol", POLICIES)
def test_fir_node_state_from_jax(pol):
    """The JAX package renders the first half of a 200-tap FIR graph (its
    warm-up crosses the halves); its state (hist and first: f64 arrays
    holding f32 values; n_seen: an int32 scalar) crosses with
    convert.state_from_jax and the port renders the second half."""
    x, taps_rev = _case(200, seed=3, T=512)
    gt, fid = _graph(taps_rev, "Average")
    gj = dj.loads_graph(dt.dumps_graph(gt))
    xb = x[:, None, :]
    with dj.policy(pol):
        cgj = dj.compile_graph(gj)
        yj, _, _ = cgj.render(xb, batch_shape=(2,))
        _, _, sj = cgj.render(xb[..., :128], batch_shape=(2,))
    import jax
    sj = jax.tree.map(np.asarray, sj)
    assert sj[str(fid)]["hist"].dtype == np.float64
    st = convert.state_from_jax(sj, "cpu")
    assert st[str(fid)]["n_seen"] == 128
    assert st[str(fid)]["hist"].dtype == torch.float32
    with dt.policy(pol):
        y2, _, st2 = dt.compile_graph(gt, device="cpu").render(
            xb[..., 128:], state=st, batch_shape=(2,))
    assert _dbfs(y2.numpy(), np.asarray(yj)[..., 128:]) <= VS_JAX_DB[pol]
    assert st2[str(fid)]["n_seen"] == 512


def _write_stereo_wav(path, rate, seed):
    """A 16-bit PCM stereo WAV, written here byte by byte."""
    rng = np.random.default_rng(seed)
    n = 700
    env = np.exp(-np.arange(n) / 150.0)
    data = np.stack([rng.standard_normal(n) * env * 0.3,
                     rng.standard_normal(n) * env * 0.2])
    pcm = (np.clip(data.T, -1, 1) * 32767).astype("<i2").tobytes()
    fmt = struct.pack("<HHIIHH", 1, 2, rate, rate * 4, 4, 16)
    body = (b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt
            + b"data" + struct.pack("<I", len(pcm)) + pcm)
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(body)) + body)


@pytest.mark.parametrize("normalize", [False, True])
def test_load_ir_matches_jax(tmp_path, normalize):
    """A stereo IR at 44.1 kHz: averaged to mono, resampled to 48 kHz with
    sinc-16, stored reversed; set_fir_ir writes taps and file_name."""
    from dsp_stuff_tpu.io import ir as jir
    from dsp_stuff_tpu_torch.io import ir as tir
    path = str(tmp_path / "room.wav")
    _write_stereo_wav(path, 44_100, seed=int(normalize))
    got = tir.load_ir(path, normalize)
    want = jir.load_ir(path, normalize)
    assert len(got) == len(want) == int(np.floor(700 * 48_000 / 44_100))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    g, fid = _graph([1.0], "Balanced")
    node = tir.set_fir_ir(g, fid, path, normalize)
    assert node.params["taps"] == got and node.params["file_name"] == path
    text = dt.dumps_graph(g)
    assert dj.loads_graph(text).nodes[fid].params["taps"] == got
    with pytest.raises(ValueError, match="not fir"):
        tir.set_fir_ir(g, g.nodes[fid - 1].id, path)


def test_wav_round_trip(tmp_path):
    from dsp_stuff_tpu.io import wav as jwav
    from dsp_stuff_tpu_torch.io import wav as twav
    data = (np.random.default_rng(2).standard_normal((2, 300)) * 0.4
            ).astype(np.float32)
    for fl in (True, False):
        path = str(tmp_path / f"x{fl}.wav")
        twav.write_wav(path, data, 44_100, float_format=fl)
        got, rate = twav.read_wav(path)
        want, wrate = jwav.read_wav(path)
        assert rate == wrate == 44_100
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(twav.to_mono(data), data[0] + data[1])
