"""What decides ``correct``: sound runs of the program pass at a small
size on the CPU; the control (the reference in float32 with TF32
products) and each fault a cell can have, planted under the timed path,
fail."""

import pytest
import torch

from portbench.harness import common
from portbench.reference import blocks
from small_cells import SEED, run_small, small_cell

CELLS = ["feedback16.render.b512", "chain10.render.b512",
         "feedback16.stream.b1", "chain10.fit.b512"]


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    r = run_small(name)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["device"]["platform"] == "cpu"


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    import importlib
    cell = small_cell(name)
    kind = importlib.import_module(f"portbench.harness.{cell.kind}")
    job = kind.Job(cell, SEED, "cpu", {})
    job.window(0.2)
    data = job.collect()
    want = kind.reference(data, cell.config, blocks.Prec("f64"))
    ctl = kind.reference(data, cell.config, blocks.Prec("tf32"))
    ok, checks = common.held(kind.readings(ctl, want), cell.limits)
    assert not ok, checks


def _alter(t):
    t = t.clone()
    t[..., t.shape[-1] // 2] += 1e-2
    return t


def test_render_fault_answer_altered(monkeypatch):
    from dsp_stuff_tpu_torch.compiler.compile import CompiledGraph
    real = CompiledGraph.render

    def render(self, *a, **k):
        out, aux, st = real(self, *a, **k)
        return _alter(out), aux, st
    monkeypatch.setattr(CompiledGraph, "render", render)
    assert not run_small("chain10.render.b512")["correct"]


def test_render_fault_half_the_batch_left_out(monkeypatch):
    from dsp_stuff_tpu_torch.compiler.compile import CompiledGraph
    real = CompiledGraph.render

    def render(self, inputs, *a, **k):
        out, aux, st = real(self, inputs, *a, **k)
        out = out.clone()
        out[out.shape[0] // 2:] = 0
        return out, aux, st
    monkeypatch.setattr(CompiledGraph, "render", render)
    assert not run_small("feedback16.render.b512")["correct"]


def test_render_fault_state_unchanged(monkeypatch):
    from dsp_stuff_tpu_torch.compiler.compile import CompiledGraph
    real = CompiledGraph.render

    def render(self, inputs, *a, batch_shape=(), **k):
        out, aux, _ = real(self, inputs, *a, batch_shape=batch_shape, **k)
        return out, aux, self.broadcast_state(self.init_state(), batch_shape)
    monkeypatch.setattr(CompiledGraph, "render", render)
    r = run_small("feedback16.render.b512")
    assert not r["correct"]
    assert r["checks"]["out_rel_err"]["value"] < 1e-5


def test_stream_fault_state_unchanged(monkeypatch):
    from dsp_stuff_tpu_torch.runtime.stream import StreamSession
    real = StreamSession.process

    def process(self, inputs=None):
        saved = self.state
        y = real(self, inputs)
        self.state = saved
        return y
    monkeypatch.setattr(StreamSession, "process", process)
    assert not run_small("feedback16.stream.b1")["correct"]


def test_stream_fault_answer_altered(monkeypatch):
    from dsp_stuff_tpu_torch.runtime.stream import StreamSession
    real = StreamSession.process

    def process(self, inputs=None):
        y = real(self, inputs).copy()
        y[..., 7] += 1e-2
        return y
    monkeypatch.setattr(StreamSession, "process", process)
    assert not run_small("feedback16.stream.b1")["correct"]


def test_fit_fault_state_unchanged(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, *a: None)
    assert not run_small("chain10.fit.b512")["correct"]


def test_fit_fault_half_the_batch(monkeypatch):
    from dsp_stuff_tpu_torch.train import fit
    real = fit.make_loss_fn

    def make_loss_fn(cg, distance=fit.mse_loss):
        loss = real(cg, distance)

        def half(params, state, ext, target):
            n = target.shape[0] // 2
            return loss(params, state, {k: v[:n] for k, v in ext.items()},
                        target[:n])
        return half
    monkeypatch.setattr(fit, "make_loss_fn", make_loss_fn)
    assert not run_small("chain10.fit.b512")["correct"]


def test_fit_fault_loss_altered(monkeypatch):
    from dsp_stuff_tpu_torch.train import fit
    real = fit.make_loss_fn

    def make_loss_fn(cg, distance=fit.mse_loss):
        loss = real(cg, distance)
        return lambda *a: loss(*a) * 1.01
    monkeypatch.setattr(fit, "make_loss_fn", make_loss_fn)
    assert not run_small("chain10.fit.b512")["correct"]
