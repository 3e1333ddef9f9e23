"""The port's McLeod pitch detector (ops/pitch_mpm.py) and its Pitch node
against the JAX package's, on the CPU, as tests/test_analysis.py holds
the JAX one: pure tones, a harmonic-rich tone, the noise floor, the node
in a graph, and the note readout.

Bounds: voicing and note numbers equal to the JAX package's; frequency
and clarity within rtol 1e-4 of it (both take the autocorrelation by an
FFT, pocketfft in both here, and sum the energy terms by a cumsum: the
peak's parabolic refinement carries their last-ulp differences); on the
pure tones within 1% of the true pitch (the JAX file's bound)."""

import jax
import numpy as np
import pytest
import torch

import dsp_stuff_tpu as dj
import dsp_stuff_tpu_torch as dt
from dsp_stuff_tpu.ids import IdSpace as JIdSpace
from dsp_stuff_tpu.ops import pitch_mpm as jpitch
from dsp_stuff_tpu_torch.ids import IdSpace
from dsp_stuff_tpu_torch.ops import pitch_mpm as tpitch

SR = 48_000
RTOL = 1e-4
# one trace per shape and thresholds (eager, the associative scans take
# seconds a call)
_jax_detect = jax.jit(jpitch.detect_pitch, static_argnames=(
    "sample_rate", "power_threshold", "clarity_threshold", "pick_threshold",
    "window"))


@pytest.fixture(autouse=True)
def _torch_env():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def tone(freq, T, amp=0.5):
    return (amp * np.sin(2 * np.pi * freq * np.arange(T) / SR)
            ).astype(np.float32)


def _both(x, **kw):
    """(port result, JAX result) as NumPy dicts."""
    got = tpitch.detect_pitch(torch.from_numpy(x), **kw)
    want = _jax_detect(x, **kw)
    return ({k: v.numpy() for k, v in got.items()},
            {k: np.asarray(v) for k, v in want.items()})


def _agree(got, want):
    """Voicing equal; note numbers equal but where the pitch lies within
    the frequency bound of a semitone boundary (110 Hz is A2 exactly: a
    last-ulp difference truncates to A2 or, a hair below, to A#2), and
    there within one."""
    np.testing.assert_array_equal(got["voiced"], want["voiced"])
    f = np.where(want["frequency"] > 0, want["frequency"], 440.0)
    steps = 12.0 * np.log2(f.astype(np.float64) / 440.0)
    edge = ((np.abs(steps - np.round(steps)) < 12.0 * np.log2(1.0 + RTOL))
            & (np.round(steps) != 0))
    dn = np.abs(got["note_nr"] - want["note_nr"])
    assert np.all(dn[~edge] == 0) and np.all(dn[edge] <= 1)
    np.testing.assert_allclose(got["frequency"], want["frequency"], rtol=RTOL)
    np.testing.assert_allclose(got["clarity"], want["clarity"], rtol=RTOL)
    assert got["note_nr"].dtype == np.int32 and got["voiced"].dtype == bool


@pytest.mark.parametrize("freq", [110.0, 440.0, 1000.0])
def test_pitch_detection(freq):
    got, want = _both(tone(freq, 8192, amp=0.8), power_threshold=0.1,
                      clarity_threshold=0.5, pick_threshold=0.7)
    assert got["voiced"].all()
    assert np.all(np.abs(got["frequency"] - freq) / freq < 0.01)
    _agree(got, want)


def test_pitch_rejects_noise_floor():
    x = (np.random.default_rng(0).standard_normal(4096) * 1e-4
         ).astype(np.float32)
    got, want = _both(x, power_threshold=0.5)
    assert not got["voiced"].any()
    _agree(got, want)


def test_pitch_harmonic_rich():
    """Harmonics ripple the nsdf; key-max-per-interval picking still lands
    on the fundamental."""
    t = np.arange(8192) / SR
    f0 = 220.0
    x = (0.5 * np.sin(2 * np.pi * f0 * t) + 0.45 * np.sin(2 * np.pi * 2 * f0 * t)
         + 0.4 * np.sin(2 * np.pi * 3 * f0 * t)).astype(np.float32)
    got, want = _both(x, power_threshold=0.1, clarity_threshold=0.5,
                      pick_threshold=0.85)
    assert got["voiced"].all()
    assert np.all(np.abs(got["frequency"] - f0) / f0 < 0.02)
    _agree(got, want)


def test_pitch_batched_streams():
    """Streams of a batch are detected independently: [4, T] with tones,
    noise and silence, against the JAX package row by row."""
    rng = np.random.default_rng(3)
    x = np.stack([tone(440.0, 4096), tone(97.0, 4096, 0.9),
                  (rng.standard_normal(4096) * 0.3).astype(np.float32),
                  np.zeros(4096, np.float32)])
    got, want = _both(x, power_threshold=0.1)
    assert got["frequency"].shape == (4, 4)
    _agree(got, want)
    assert got["voiced"][0].all() and not got["voiced"][3].any()


def test_nsdf_matches_jax():
    x = (np.random.default_rng(4).standard_normal((3, 1024)) * 0.3
         ).astype(np.float32)
    np.testing.assert_allclose(tpitch.nsdf(torch.from_numpy(x)).numpy(),
                               np.asarray(jpitch.nsdf(x)), rtol=1e-4,
                               atol=1e-6)


def test_interval_max_matches_a_loop():
    """Each position's interval maximum, against a running loop."""
    rng = np.random.default_rng(5)
    d = rng.standard_normal((2, 300)).astype(np.float32)
    rising = rng.random((2, 300)) < 0.05
    ids = np.cumsum(rising, axis=-1)
    got = tpitch._interval_max(torch.from_numpy(d),
                               torch.from_numpy(ids)).numpy()
    for r in range(2):
        for k in np.unique(ids[r]):
            sel = ids[r] == k
            assert np.all(got[r][sel] == d[r][sel].max())


def test_freq_to_note_nr_matches_jax():
    f = np.array([8.0, 27.5, 261.63, 415.31, 440.0, 466.16, 4186.0, 0.0,
                  -3.0], np.float32)
    for nearest in (False, True):
        np.testing.assert_array_equal(
            tpitch.freq_to_note_nr(torch.from_numpy(f), nearest).numpy(),
            np.asarray(jpitch.freq_to_note_nr(f, nearest)))
    for freq in (110.0, 261.63, 466.16, 8.0):
        assert tpitch.describe_pitch(freq) == jpitch.describe_pitch(freq)
        assert tpitch.note_name(57) == jpitch.note_name(57) == "A 4"


def test_pitch_node_in_graph():
    """The pitch sink lands in aux under ``pitch:<id>``, as the JAX
    package's does, beside a spectrogram and a wave view, with its
    thresholds from the node's sliders."""
    def build(pkg, ids):
        g = pkg.Graph(ids)
        inp = g.add("input")
        sp = g.add("spectrogram", fft_size=512)
        pt = g.add("pitch", power_thresh=0.2, pick_thresh=0.6)
        wv = g.add("wave_view")
        for sink in (sp, pt, wv):
            g.connect(inp, "out", sink, "in")
        return g, inp.id, pt.id

    gt, inp, pt = build(dt, IdSpace())
    gj, _, _ = build(dj, JIdSpace())
    assert dt.dumps_graph(gt) == dj.dumps_graph(gj)
    x = tone(440.0, 4096)
    _, aux, _ = dt.render(gt, {str(inp): x}, device="cpu")
    _, aux_j, _ = dj.render(gj, {str(inp): x})
    key = f"pitch:{pt}"
    got = {k: v.numpy() for k, v in aux[key].items()}
    assert np.all(np.abs(got["frequency"] - 440.0) < 5.0)
    _agree(got, {k: np.asarray(v) for k, v in aux_j[key].items()})
    assert aux[f"wave_view:{pt + 1}"]["samples"].shape == (4096,)
