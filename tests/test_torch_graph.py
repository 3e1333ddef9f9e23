"""The port's framework-free core (dsp_stuff_tpu_torch ids / registry /
graph) against the JAX package's: the same graph JSON byte for byte,
loadable in either direction (the node types ported later included), and
a clear error for node types the port does not implement yet.  Also pins
that the port never imports JAX."""

import dataclasses
import json
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import dsp_stuff_tpu as dj
import dsp_stuff_tpu_torch as dt
from dsp_stuff_tpu.ids import IdSpace as JIdSpace
from dsp_stuff_tpu_torch.ids import IdSpace as TIdSpace
from dsp_stuff_tpu_torch.registry import NOT_PORTED
from dsp_stuff_tpu_torch.utils import precision as tprec

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _torch_env():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    prev = tprec.get_policy()
    yield
    tprec.set_policy(prev)
    torch.set_num_threads(threads)


def _bench_chain(pkg, ids):
    """bench.py's 10-node chain (bench.py:100-114)."""
    g = pkg.Graph(ids)
    inp = g.add("input")
    gn = g.add("gain", level=1.2)
    bq = g.add("biquad", a0=1.0, a1=-0.24, a2=0.0, b0=0.758, b1=0.0, b2=0.0)
    od = g.add("overdrive", boost=4.0, drive=0.6, level=0.9)
    lp = g.add("low_pass", ratio=0.6)
    hp = g.add("high_pass", ratio=0.2)
    ds = g.add("distort", mode="Tanh", level=3.0)
    ch = g.add("chebyshev", level_pos=2.0, level_neg=4.0)
    rv = g.add("reverb", seconds=0.05, decay=0.4)
    out = g.add("output")
    g.chain(inp, gn, bq, od, lp, hp, ds, ch, rv, out)
    return g


def _config1(pkg, ids):
    """models/presets.config1_gain_biquad, built with ``pkg``."""
    g = pkg.Graph(ids)
    inp = g.add("input")
    gn = g.add("gain", level=1.5)
    w0 = 2 * np.pi * 1000.0 / 48_000.0
    alpha = np.sin(w0) / (2 * 0.7071)
    cw = np.cos(w0)
    bq = g.add("biquad", a0=1 + alpha, a1=-2 * cw, a2=1 - alpha,
               b0=(1 - cw) / 2, b1=1 - cw, b2=(1 - cw) / 2)
    out = g.add("output")
    g.chain(inp, gn, bq, out)
    return g


BUILDERS = {"bench_chain": _bench_chain, "config1": _config1}


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_dumps_byte_identical(name):
    build = BUILDERS[name]
    text_j = dj.dumps_graph(build(dj, JIdSpace()))
    text_t = dt.dumps_graph(build(dt, TIdSpace()))
    assert text_t == text_j


def test_config1_matches_jax_preset():
    from dsp_stuff_tpu.models import presets
    g, _ = presets.config1_gain_biquad()
    assert dt.dumps_graph(_config1(dt, TIdSpace())) == dj.dumps_graph(g)


@pytest.mark.parametrize("name", sorted(BUILDERS))
@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_json_loads_in_other_package(name, direction):
    build = BUILDERS[name]
    if direction == "jax_to_torch":
        text = dj.dumps_graph(build(dj, JIdSpace()))
        g = dt.loads_graph(text, ids=TIdSpace())
        again = dt.dumps_graph(g)
    else:
        text = dt.dumps_graph(build(dt, TIdSpace()))
        g = dj.loads_graph(text, ids=JIdSpace())
        again = dj.dumps_graph(g)
    assert again == text
    assert sorted(g.nodes) == sorted(int(n["id"]) for n in
                                     json.loads(text)["nodes"])


@pytest.mark.parametrize("typename", ["pitch"])
def test_unported_node_type_raises(typename, monkeypatch):
    """A JAX node type the port lacks is named as not ported, both when
    added by hand and when read from JSON the JAX package wrote.  Every
    type is ported now (NOT_PORTED is empty): the branch is exercised by
    hiding the last one ported."""
    assert not NOT_PORTED
    from dsp_stuff_tpu_torch import graph as tgraph, registry
    monkeypatch.setattr(registry, "NOT_PORTED", frozenset((typename,)))
    monkeypatch.setattr(tgraph, "NOT_PORTED", frozenset((typename,)))
    monkeypatch.delitem(dt.REGISTRY._by_cfg, typename)
    assert typename in dj.REGISTRY and typename not in dt.REGISTRY
    with pytest.raises(KeyError, match="not ported"):
        dt.Graph(TIdSpace()).add(typename)
    g = dj.Graph(JIdSpace())
    g.add(typename)
    with pytest.raises(KeyError, match="not ported"):
        dt.loads_graph(dj.dumps_graph(g), ids=TIdSpace())


#: node types ported after the first slices, each with settings off its
#: defaults, wired as the JAX package's graph JSON writes them
NEWLY_PORTED = {
    "mux": {"in_port": "B"},
    "demux": {"out_port": "B"},
    "muff": {"toan": 0.2, "level": 0.7, "sustain": 0.9},
    "fir": {"mode": "Average", "taps": [0.5, -0.25, 0.125],
            "file_name": "room.wav"},
    "pitch": {"power_thresh": 0.2, "clarity_thresh": 0.7,
              "pick_thresh": 0.6},
}


@pytest.mark.parametrize("typename", sorted(NEWLY_PORTED))
def test_newly_ported_type_loads_jax_json(typename):
    """JSON the JAX package wrote (the node between an input and an
    output, every port linked) loads into the port with its settings and
    writes back byte for byte; built by hand in the port, the same JSON."""
    assert typename not in NOT_PORTED and typename in dt.REGISTRY

    def build(pkg, ids):
        g = pkg.Graph(ids)
        inp = g.add("input")
        n = g.add(typename, **NEWLY_PORTED[typename])
        out = g.add("output")
        for port in n.spec.inputs:
            g.connect(inp, "out", n, port)
        for port in n.spec.outputs:
            g.connect(n, port, out, "in")
        return g, n.id

    gj, nid = build(dj, JIdSpace())
    text = dj.dumps_graph(gj)
    gt = dt.loads_graph(text, ids=TIdSpace())
    assert gt.nodes[nid].cfg_name == typename
    for k, v in NEWLY_PORTED[typename].items():
        assert gt.nodes[nid].params[k] == v
    assert dt.dumps_graph(gt) == text
    assert dt.dumps_graph(build(dt, TIdSpace())[0]) == text


def test_port_registry_covers_jax_registry():
    """The port has every node type of the JAX package."""
    jax_names = {s.cfg_name for s in dj.REGISTRY}
    port_names = {s.cfg_name for s in dt.REGISTRY}
    assert port_names == jax_names
    assert not NOT_PORTED
    for spec in dt.REGISTRY:
        js = dj.REGISTRY.by_cfg_name(spec.cfg_name)
        assert (spec.title, spec.inputs, spec.outputs) == \
            (js.title, js.inputs, js.outputs)
        assert [(type(p).__name__, dataclasses.astuple(p))
                for p in spec.params] == \
            [(type(p).__name__, dataclasses.astuple(p)) for p in js.params]


def test_unknown_node_type_raises():
    with pytest.raises(KeyError, match="unknown node typename"):
        dt.loads_graph('{"nodes": [{"id": 0, "typename": "nope", "cfg": {}}],'
                       ' "links": []}', ids=TIdSpace())


#: the port's modules that the package's own import does not reach
NEW_MODULES = ("runtime.stream", "runtime.checkpoint", "io.native",
               "io.playback", "ops.pitch_mpm", "ops.resample", "utils.obs",
               "__main__")


def test_import_leaves_jax_out():
    code = ("import sys, importlib, dsp_stuff_tpu_torch; "
            f"[importlib.import_module('dsp_stuff_tpu_torch.' + m) "
            f"for m in {NEW_MODULES!r}]; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'dsp_stuff_tpu' or "
            "m.startswith('dsp_stuff_tpu.')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


def test_no_jax_import_in_port_sources():
    pat = re.compile(r"^\s*(import|from)\s+(jax|dsp_stuff_tpu)\b", re.M)
    for path in (ROOT / "dsp_stuff_tpu_torch").rglob("*.py"):
        assert not pat.search(path.read_text()), path
