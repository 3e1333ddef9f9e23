"""The port's device-rate output path and WAV rendering on the CPU, as
tests/test_playback.py holds the JAX package's: the streaming sinc-16
resampler, the session's drain_output (underrun, catch-up, stereo),
render_file's export and ingest, and the note-name readout; plus
render_file against the JAX package's on the same WAV files.

Bounds: the streaming resampler and the exports are bitwise (the same
host resampler on the same samples); render_file against the JAX
package's at VS_JAX_DB of tests/test_torch_render (the exports of both
then differ only by what the renders do, through the same resampler)."""

import numpy as np
import pytest
import torch

import dsp_stuff_tpu as dj
import dsp_stuff_tpu_torch as dt
from dsp_stuff_tpu.ops.resample import resample_sinc16 as resample_jax
from dsp_stuff_tpu_torch.ids import IdSpace
from dsp_stuff_tpu_torch.io import wav as wav_io
from dsp_stuff_tpu_torch.io.playback import StreamingSinc16, dup_to_stereo, \
    host_resample
from dsp_stuff_tpu_torch.io.resample import HALF, resample_sinc16
from dsp_stuff_tpu_torch.ops.resample import resample_sinc16 as resample_op
from dsp_stuff_tpu_torch.runtime.stream import StreamSession
from dsp_stuff_tpu_torch.utils import precision as tprec
from test_torch_render import VS_JAX_DB, _bench_chain, _dbfs


@pytest.fixture(autouse=True)
def _torch_env():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    prev = tprec.get_policy()
    yield
    tprec.set_policy(prev)
    torch.set_num_threads(threads)


def _chain_graph():
    g = dt.Graph(IdSpace())
    inp = g.add("input")
    gn = g.add("gain", level=1.1)
    lp = g.add("low_pass", ratio=0.3)
    out = g.add("output")
    g.chain(inp, gn, lp, out)
    return g, inp.id, out.id


def _saved_graph(tmp_path):
    g, inp_id, out_id = _chain_graph()
    gpath = str(tmp_path / "g.json")
    dt.save_graph(g, gpath)
    return gpath


def _wav(tmp_path, name, x, rate=48_000):
    p = str(tmp_path / name)
    wav_io.write_wav(p, x, sample_rate=rate)
    return p


def _render_file(*args, **kw):
    return dt.render_file(*args, device="cpu", **kw)


# -- StreamingSinc16 ----------------------------------------------------------

@pytest.mark.parametrize("rate", [44_100, 96_000, 32_000])
def test_streaming_chunks_match_one_shot(rate):
    """Chained produce() calls over ragged chunk sizes are bit-identical
    to the one-shot resample of the 8-sample-delayed stream."""
    rng = np.random.default_rng(7)
    x = (rng.standard_normal(48_000) * 0.5).astype(np.float32)
    ratio = rate / 48_000.0
    want = resample_sinc16(np.concatenate([np.zeros(HALF, np.float32), x]),
                           ratio)
    rs = StreamingSinc16(rate)
    fed = 0
    got = []
    for n in (1, 7, 128, 444, 1024, 4096):
        need = rs.input_needed(n)
        assert fed + need <= x.size
        got.append(rs.produce(x[fed:fed + need], n))
        fed += need
    while True:
        n = 2048
        need = rs.input_needed(n)
        if fed + need > x.size:
            break
        got.append(rs.produce(x[fed:fed + need], n))
        fed += need
    got = np.concatenate(got)
    np.testing.assert_array_equal(got, want[:got.size])


def test_streaming_skip_continues_timeline():
    """After a skip the output timeline continues onto the post-skip
    input; only the 16-tap window straddling the splice differs."""
    rate = 44_100
    ratio = rate / 48_000.0
    rng = np.random.default_rng(8)
    a = (rng.standard_normal(4800) * 0.5).astype(np.float32)
    b = (rng.standard_normal(9600) * 0.5).astype(np.float32)
    rs = StreamingSinc16(rate)
    n1 = 1000
    y1 = rs.produce(a[:rs.input_needed(n1)], n1)
    consumed1 = rs.consumed
    rs.skip(a[consumed1:])
    n2 = 1000
    y2 = rs.produce(b[:rs.input_needed(n2)], n2)
    assert y1.size == n1 and y2.size == n2
    spliced = np.concatenate([a[:consumed1], b])
    want = resample_sinc16(
        np.concatenate([np.zeros(HALF, np.float32), spliced]), ratio)
    np.testing.assert_array_equal(y1, want[:n1])
    seam = int(np.ceil(16 * ratio)) + 2
    np.testing.assert_array_equal(y2[seam:], want[n1 + seam:n1 + n2])


# -- the session's playback reads --------------------------------------------

def _pump_all(sess, x, inp_id, block=128):
    for i in range(0, len(x) - block + 1, block):
        sess.feed(inp_id, x[i:i + block])
        assert sess.pump()


def test_drain_output_device_rate_matches_one_shot():
    g, inp_id, out_id = _chain_graph()
    rng = np.random.default_rng(9)
    x = (rng.standard_normal(128 * 40) * 0.5).astype(np.float32)
    sess = StreamSession(g, device="cpu")
    _pump_all(sess, x, inp_id)
    sess2 = StreamSession(g, device="cpu")
    _pump_all(sess2, x, inp_id)
    y48 = sess2.drain_output(out_id, 128 * 40)
    rate = 44_100
    got = []
    while True:
        n = 441
        rs = sess._resamplers.get((out_id, rate))
        need = rs.input_needed(n) if rs else int(np.ceil(n / (rate / 48000)))
        if sess.out_rings[out_id].readable < need + 20:
            break
        got.append(sess.drain_output(out_id, n, device_rate=rate))
    got = np.concatenate(got)
    want = resample_sinc16(
        np.concatenate([np.zeros(HALF, np.float32), y48]), rate / 48_000.0)
    np.testing.assert_array_equal(got, want[:got.size])


def test_drain_output_device_rate_underrun_and_catchup():
    g, inp_id, out_id = _chain_graph()
    sess = StreamSession(g, device="cpu")
    rate = 44_100
    z = sess.drain_output(out_id, 441, device_rate=rate)
    assert z.shape == (441,) and not z.any()           # underrun: silence
    assert sess._resamplers[(out_id, rate)].k == 0     # nothing advanced
    rng = np.random.default_rng(10)
    x = (rng.standard_normal(128 * 60) * 0.5).astype(np.float32)
    _pump_all(sess, x, inp_id)
    sess.resync()                                      # counter := 5
    n = 441
    input_len = sess._resamplers[(out_id, rate)].input_needed(n)
    assert sess.out_rings[out_id].readable - input_len >= 2 * input_len
    got = sess.drain_output(out_id, n, device_rate=rate)
    assert got.shape == (n,)
    assert sess.out_rings[out_id].readable == 0        # backlog skipped
    assert sess._catchup[out_id] == 4


def test_drain_output_stereo_dup():
    g, inp_id, out_id = _chain_graph()
    sess = StreamSession(g, device="cpu")
    rng = np.random.default_rng(11)
    _pump_all(sess, (rng.standard_normal(128 * 4) * 0.5).astype(np.float32),
              inp_id)
    inter = sess.drain_output(out_id, 128, stereo=True)
    assert inter.shape == (256,)
    np.testing.assert_array_equal(inter[0::2], inter[1::2])


def test_dup_to_stereo_impls_agree():
    x = np.arange(5, dtype=np.float32)
    inter = dup_to_stereo(x)
    np.testing.assert_array_equal(inter[0::2], x)
    np.testing.assert_array_equal(inter[1::2], x)


# -- render_file ---------------------------------------------------------------

def test_render_file_out_rate_matches_independent_resample(tmp_path):
    gpath = _saved_graph(tmp_path)
    x = (np.random.default_rng(12).standard_normal(48_000) * 0.4
         ).astype(np.float32)
    wpath = _wav(tmp_path, "in.wav", x)
    outs48, _ = _render_file(gpath, wpath)
    out44 = str(tmp_path / "out44.wav")
    outs44, _ = _render_file(gpath, wpath, out_wav=out44, out_rate=44_100)
    ratio = 44_100 / 48_000
    np.testing.assert_array_equal(outs44[0], host_resample(outs48[0], ratio))
    np.testing.assert_array_equal(outs44[0], resample_sinc16(outs48[0], ratio))
    # the tensor op (f32 taps) and the JAX op within the f32-tap budget
    np.testing.assert_allclose(
        outs44[0], resample_op(torch.from_numpy(outs48[0]), ratio).numpy(),
        atol=5e-6)
    np.testing.assert_allclose(
        outs44[0], np.asarray(resample_jax(outs48[0], ratio)), atol=5e-6)
    data, rate = wav_io.read_wav(out44)
    assert rate == 44_100
    np.testing.assert_array_equal(data[0], outs44[0])


def test_render_file_stereo_out(tmp_path):
    gpath = _saved_graph(tmp_path)
    x = (np.random.default_rng(13).standard_normal(4800) * 0.4
         ).astype(np.float32)
    wpath = _wav(tmp_path, "in.wav", x)
    wout = str(tmp_path / "out.wav")
    outs, _ = _render_file(gpath, wpath, out_wav=wout, stereo_out=True)
    assert outs.shape[0] == 2
    np.testing.assert_array_equal(outs[0], outs[1])
    data, rate = wav_io.read_wav(wout)
    assert rate == 48_000 and data.shape[0] == 2


def test_render_file_resample_inputs(tmp_path):
    gpath = _saved_graph(tmp_path)
    x441 = (np.random.default_rng(14).standard_normal(44_100) * 0.4
            ).astype(np.float32)
    wpath = _wav(tmp_path, "in441.wav", x441, rate=44_100)
    with pytest.raises(ValueError, match="48 kHz"):
        _render_file(gpath, wpath)
    with pytest.warns(UserWarning, match="resampling"):
        got, _ = _render_file(gpath, wpath, resample_inputs=True)
    x48 = host_resample(x441, 48_000 / 44_100)
    want, _ = _render_file(gpath, _wav(tmp_path, "in48.wav", x48))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("pol", ["fast", "parity"])
def test_render_file_vs_jax(tmp_path, pol):
    """The port's render_file against the JAX package's on the same WAV
    file: the raw render, the 44.1 kHz stereo export and the file
    written; the bench chain at 0.25 s."""
    g = dt.Graph(IdSpace())
    _bench_chain(g)
    gpath = str(tmp_path / "bench.json")
    dt.save_graph(g, gpath)
    x = (np.random.default_rng(15).standard_normal(12_000) * 0.4
         ).astype(np.float32)
    wpath = _wav(tmp_path, "in.wav", x)
    with dt.policy(pol), dj.policy(pol):
        got, _ = _render_file(gpath, wpath)
        want, _ = dj.render_file(gpath, wpath)
        assert got.shape == np.asarray(want).shape
        assert _dbfs(got, want) <= VS_JAX_DB[pol]
        wt, wj = str(tmp_path / "t.wav"), str(tmp_path / "j.wav")
        got_x, _ = _render_file(gpath, wpath, out_wav=wt, out_rate=44_100,
                                stereo_out=True)
        want_x, _ = dj.render_file(gpath, wpath, out_wav=wj, out_rate=44_100,
                                   stereo_out=True)
    assert got_x.shape == want_x.shape == (2, 11_025)
    assert _dbfs(got_x, want_x) <= VS_JAX_DB[pol]
    # the export is the port's own render through the host resampler
    np.testing.assert_array_equal(got_x[0],
                                  host_resample(got[0], 44_100 / 48_000))
    data, rate = wav_io.read_wav(wt)
    assert rate == 44_100
    np.testing.assert_array_equal(data, got_x)


def test_render_file_generator_graph_and_default_device(tmp_path):
    """A generator graph renders from ``seconds``; without a CUDA device
    the default raises the message naming device="cpu"."""
    g = dt.Graph(IdSpace())
    sg = g.add("signal_gen", frequency=440.0, amplitude=0.5, mode="Sine")
    out = g.add("output")
    g.chain(sg, out)
    gpath = str(tmp_path / "gen.json")
    dt.save_graph(g, gpath)
    outs, _ = _render_file(gpath, seconds=0.01)
    assert outs.shape == (1, 480) and np.abs(outs).max() > 0.4
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            dt.render_file(gpath, seconds=0.01)


# -- the note-name readout -----------------------------------------------------

def test_pitch_note_names():
    from dsp_stuff_tpu_torch.ops.pitch_mpm import (describe_pitch,
                                                   freq_to_note_nr, note_name)
    name, octave, cents = describe_pitch(440.0)
    assert name == "A 4" and octave == 4 and abs(cents) < 1e-6
    name, _, cents = describe_pitch(466.16)         # truncation: still A 4
    assert name == "A 4" and 99.0 < cents < 100.0
    name, _, cents = describe_pitch(466.16, nearest=True)
    assert name == "A# 4" and abs(cents) < 1.0
    name, _, cents = describe_pitch(415.31)
    assert name == "A 4" and -100.0 < cents < -99.0
    assert describe_pitch(415.31, nearest=True)[0] == "G# 4"
    name, _, cents = describe_pitch(261.63)
    assert name == "C# 4" and -100.0 < cents < -99.0
    assert describe_pitch(261.63, nearest=True)[0] == "C 4"
    assert note_name(freq_to_note_nr(np.float64(440.0 / 4))) == "A 2"
    assert int(freq_to_note_nr(np.float64(8.0))) == (
        int(np.trunc(12 * np.log2(8.0 / 440.0))) + 57) & 0xFF


def test_detect_pitch_reports_note_nr():
    from dsp_stuff_tpu_torch.ops.pitch_mpm import detect_pitch, note_name
    t = np.arange(8192) / 48_000.0
    x = torch.from_numpy(np.sin(2 * np.pi * 440.0 * t).astype(np.float32))
    res = detect_pitch(x, power_threshold=0.1, clarity_threshold=0.5)
    voiced = res["voiced"].numpy()
    assert voiced.any()
    assert all(note_name(nr) == "A 4" for nr in res["note_nr"].numpy()[voiced])
