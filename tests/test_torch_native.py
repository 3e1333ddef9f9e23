"""The port's binding to the host library (dsp_stuff_tpu_torch/io/native.py
over native/dsp_host.cpp) against its NumPy stand-ins, as
tests/test_native.py holds the JAX package's binding.  The stand-ins give
the same bits: WAV decode and encode, the sinc-16 resampler and the ring.
The resampler as a tensor op (ops/resample.py, f32 taps) is held against
the JAX op and the host paths at the JAX file's 5e-6."""

import pathlib

import numpy as np
import pytest
import torch

from dsp_stuff_tpu.ops.resample import resample_sinc16 as resample_jax
from dsp_stuff_tpu_torch.io import native, wav as wav_io
from dsp_stuff_tpu_torch.io.resample import resample_sinc16 as resample_py
from dsp_stuff_tpu_torch.ops.resample import resample_sinc16 as resample_op
from dsp_stuff_tpu_torch.runtime.stream import _PyRing

ROOT = pathlib.Path(__file__).resolve().parents[1]
RATIOS = [0.5, 44100 / 48000, 1.0, 2.0]


@pytest.fixture(autouse=True)
def _built():
    """The library builds with g++ at first use; a machine without g++
    runs the NumPy paths only, and these tests do not apply there."""
    if not native.available():
        pytest.skip("the host library could not be built (no g++)")


def test_library_builds_outside_native():
    """Built into the git-ignored build/native/, keyed by the source."""
    lib = native.lib_path()
    assert lib.exists()
    assert lib.parent == ROOT / "build" / "native"
    assert native.SOURCE == ROOT / "native" / "dsp_host.cpp"


def test_wav_roundtrip_native_vs_python(tmp_path):
    rng = np.random.default_rng(0)
    data = (rng.standard_normal((2, 4096)) * 0.5).astype(np.float32)
    p = str(tmp_path / "t.wav")
    native.wav_write(p, data, 48_000, float_format=True)
    got_n, rate_n = native.wav_read(p)
    got_p, rate_p = wav_io._read_wav_py(p)
    assert rate_n == rate_p == 48_000
    np.testing.assert_array_equal(got_n, data)
    np.testing.assert_array_equal(got_p, data)
    # the two encoders write the same bytes
    q = str(tmp_path / "u.wav")
    wav_io._write_wav_py(q, data, 48_000, float_format=True)
    assert open(p, "rb").read() == open(q, "rb").read()


@pytest.mark.parametrize("bits,fmt", [(16, False), (32, True)])
def test_wav_pcm_formats_cross(tmp_path, bits, fmt):
    rng = np.random.default_rng(1)
    data = (rng.standard_normal((1, 1000)) * 0.5).astype(np.float32)
    p = str(tmp_path / "t.wav")
    wav_io._write_wav_py(p, data, 48_000, float_format=fmt)
    got_n, _ = native.wav_read(p)
    got_p, _ = wav_io._read_wav_py(p)
    np.testing.assert_array_equal(got_n, got_p)


def test_wav_truncated_data_chunk_clamped(tmp_path):
    """A data chunk declared past EOF decodes only the bytes present."""
    rng = np.random.default_rng(2)
    data = (rng.standard_normal((1, 1000)) * 0.5).astype(np.float32)
    p = str(tmp_path / "t.wav")
    native.wav_write(p, data, 48_000, float_format=True)
    raw = open(p, "rb").read()
    open(p, "wb").write(raw[: len(raw) - 400])     # chop 100 samples
    got, rate = native.wav_read(p)
    assert rate == 48_000
    np.testing.assert_array_equal(got[0], data[0, :900])


def test_wav_zero_bits_rejected(tmp_path):
    rng = np.random.default_rng(3)
    data = (rng.standard_normal((1, 64)) * 0.5).astype(np.float32)
    p = str(tmp_path / "t.wav")
    native.wav_write(p, data, 48_000, float_format=True)
    raw = bytearray(open(p, "rb").read())
    i = raw.find(b"fmt ")
    assert i > 0
    raw[i + 8 + 14: i + 8 + 16] = b"\x00\x00"      # bits field -> 0
    open(p, "wb").write(bytes(raw))
    with pytest.raises(ValueError):
        native.wav_read(p)


@pytest.mark.parametrize("ratio", RATIOS)
def test_resample_native_matches_numpy(ratio):
    """Bitwise: the same f64 taps and sums, rounded once to f32."""
    rng = np.random.default_rng(2)
    x = (rng.standard_normal(4096) * 0.5).astype(np.float32)
    got_n = native.resample_sinc16(x, ratio)
    got_p = resample_py(x, ratio)
    assert got_n.shape == got_p.shape
    np.testing.assert_array_equal(got_n, got_p)


@pytest.mark.parametrize("ratio", [0.5, 44100 / 48000, 2.0])
def test_resample_op_matches_numpy_and_jax(ratio):
    """The tensor op rounds its taps to f32, as the JAX op does."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(4096) * 0.5).astype(np.float32)
    got = resample_op(torch.from_numpy(x), ratio).numpy()
    np.testing.assert_allclose(got, resample_py(x, ratio), atol=5e-6)
    np.testing.assert_allclose(got, np.asarray(resample_jax(x, ratio)),
                               atol=5e-6)
    # batched rows resample independently
    xb = np.stack([x, -x])
    yb = resample_op(torch.from_numpy(xb), ratio).numpy()
    np.testing.assert_array_equal(yb[0], got)
    np.testing.assert_array_equal(yb[1], -got)


def test_resample_tone_preserved():
    """A 1 kHz tone resampled 48k -> 44.1k stays a 1 kHz tone."""
    sr_in, sr_out = 48_000, 44_100
    t = np.arange(sr_in, dtype=np.float64) / sr_in
    x = np.sin(2 * np.pi * 1000.0 * t).astype(np.float32)
    y = native.resample_sinc16(x, sr_out / sr_in)
    t2 = np.arange(y.size, dtype=np.float64) / sr_out
    want = np.sin(2 * np.pi * 1000.0 * t2).astype(np.float32)
    err = np.abs(y[64:-64] - want[64:-64]).max()   # past the warm-up edges
    assert err < 5e-3, err


def test_ring_buffer_semantics():
    r = native.Ring(capacity=256)
    assert r.writable == 256 and r.readable == 0
    assert r.write(np.arange(100, dtype=np.float32)) == 100
    assert r.readable == 100
    np.testing.assert_array_equal(r.read(40), np.arange(40, dtype=np.float32))
    assert r.write(np.zeros(500, np.float32)) == 256 - 60   # overrun drops
    assert r.read(1000).size == 256                         # short read
    r.write(np.ones(10, np.float32))
    r.drain()
    assert r.readable == 0


def test_ring_wraparound():
    r = native.Ring(capacity=64)
    for rep in range(10):
        x = np.full(48, float(rep), np.float32)
        assert r.write(x) == 48
        np.testing.assert_array_equal(r.read(48), x)


def test_pyring_matches_native_ring():
    """The NumPy ring gives the native ring's counts and samples under a
    random sequence of writes, reads and drains."""
    rng = np.random.default_rng(4)
    a, b = native.Ring(300), _PyRing(300)
    for _ in range(400):
        op = rng.integers(0, 10)
        if op < 5:
            x = rng.standard_normal(int(rng.integers(0, 200))
                                    ).astype(np.float32)
            assert a.write(x) == b.write(x)
        elif op < 9:
            n = int(rng.integers(0, 250))
            np.testing.assert_array_equal(a.read(n), b.read(n))
        else:
            a.drain()
            b.drain()
        assert (a.readable, a.writable) == (b.readable, b.writable)
