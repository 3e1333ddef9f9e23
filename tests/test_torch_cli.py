"""The port's command line (python -m dsp_stuff_tpu_torch) in subprocesses,
on the CPU: nodes, inspect, render (under fast and exact), fit and debug
with --device cpu, and the refusal of the card by default where there is
none."""

import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import dsp_stuff_tpu as dj
import dsp_stuff_tpu_torch as dt
from dsp_stuff_tpu_torch.io import wav as wav_io

ROOT = pathlib.Path(__file__).resolve().parents[1]
CONFIG1 = str(ROOT / "examples" / "graphs" / "config1.json")
CONFIG2 = str(ROOT / "examples" / "graphs" / "config2.json")


def _cli(*args, check=True):
    r = subprocess.run([sys.executable, "-m", "dsp_stuff_tpu_torch", *args],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    if check and r.returncode:
        raise AssertionError(f"exit {r.returncode}: {r.stderr[-2000:]}")
    return r


def test_nodes_lists_every_jax_node_type():
    out = _cli("nodes").stdout
    listed = {line.split()[0] for line in out.splitlines() if line.strip()}
    assert listed == {s.cfg_name for s in dj.REGISTRY}


def test_inspect():
    out = _cli("inspect", CONFIG2).stdout
    cfg = json.loads(pathlib.Path(CONFIG2).read_text())
    assert out.splitlines()[0] == (f"{len(cfg['nodes'])} nodes, "
                                   f"{len(cfg['links'])} links")


def test_render_on_the_cpu(tmp_path):
    """--seconds 0.25 writes a 12,000-sample WAV equal to render_file's."""
    out = str(tmp_path / "out.wav")
    r = _cli("render", CONFIG2, "--seconds", "0.25", "--out", out,
             "--device", "cpu")
    assert "on cpu" in r.stdout
    data, rate = wav_io.read_wav(out)
    assert rate == 48_000 and data.shape[-1] == 12_000
    with dt.policy("fast"):
        want, _ = dt.render_file(CONFIG2, seconds=0.25, device="cpu")
    np.testing.assert_array_equal(data, want)


def test_render_wav_export(tmp_path):
    """--in with --out-rate 44100 --stereo: the export render_file gives."""
    x = (np.random.default_rng(0).standard_normal(9600) * 0.3
         ).astype(np.float32)
    inp, out = str(tmp_path / "in.wav"), str(tmp_path / "out.wav")
    wav_io.write_wav(inp, x)
    _cli("render", CONFIG2, "--in", inp, "--out", out, "--out-rate", "44100",
         "--stereo", "--device", "cpu")
    data, rate = wav_io.read_wav(out)
    with dt.policy("fast"):                  # the command's default policy
        want, _ = dt.render_file(CONFIG2, inp, out_rate=44_100,
                                 stereo_out=True, device="cpu")
    assert rate == 44_100 and data.shape == (2, 8820)
    np.testing.assert_array_equal(data, want)


def test_debug_on_the_cpu():
    out = _cli("debug", CONFIG2, "--seconds", "0.05", "--device", "cpu").stdout
    rows = out.splitlines()[1:]
    g = dt.load_graph(CONFIG2)
    reported = {int(r.split()[0]) for r in rows}
    assert reported == {nid for nid, n in g.nodes.items() if n.spec.outputs}
    assert all(r.split()[-2:] == ["0", "0"] for r in rows)   # no NaN, no Inf


def test_fit_on_the_cpu(tmp_path):
    """Three Adam steps of input -> gain -> output towards a target at
    twice the level move the slider up and save the graph."""
    g = dt.Graph()
    inp, gn, out = g.add("input"), g.add("gain", level=1.0), g.add("output")
    g.chain(inp, gn, out)
    gpath, fitted = str(tmp_path / "g.json"), str(tmp_path / "fit.json")
    dt.save_graph(g, gpath)
    x = (np.random.default_rng(1).standard_normal(2048) * 0.3
         ).astype(np.float32)
    dry, wet = str(tmp_path / "dry.wav"), str(tmp_path / "wet.wav")
    wav_io.write_wav(dry, x)
    wav_io.write_wav(wet, 2.0 * x)
    r = _cli("fit", gpath, "--in", dry, "--target", wet, "--steps", "3",
             "--out", fitted, "--device", "cpu")
    assert "final loss" in r.stdout
    assert dt.load_graph(fitted).nodes[gn.id].params["level"] > 1.0


def test_card_is_the_default():
    """Without a CUDA device, render exits non-zero with the message that
    names device="cpu"."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    r = _cli("render", CONFIG2, "--seconds", "0.01", check=False)
    assert r.returncode != 0
    assert 'device="cpu"' in r.stderr


def test_render_exact_policy(tmp_path):
    """--policy exact --device cpu writes the WAV of the in-process exact
    render_file, bit for bit (config1: gain into a biquad, the sequential
    solve)."""
    x = (np.random.default_rng(1).standard_normal(4800) * 0.3
         ).astype(np.float32)
    inp, out = str(tmp_path / "in.wav"), str(tmp_path / "out.wav")
    wav_io.write_wav(inp, x)
    r = _cli("render", CONFIG1, "--in", inp, "--out", out, "--policy",
             "exact", "--device", "cpu")
    assert "on cpu" in r.stdout
    data, rate = wav_io.read_wav(out)
    with dt.policy("exact"):
        want, _ = dt.render_file(CONFIG1, inp, device="cpu")
    assert rate == 48_000 and data.shape[-1] == 4800
    np.testing.assert_array_equal(data, want)
