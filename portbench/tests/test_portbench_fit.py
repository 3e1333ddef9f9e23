"""The training cell's reference: its float64 gradients against autograd
through the program on the CPU, and its Adam against torch.optim.Adam."""

import json

import numpy as np
import pytest
import torch

from portbench.harness import fit as fitkind
from portbench.reference import blocks as b
from small_cells import small_cell


def test_reference_gradients_match_the_programs_autograd():
    import dsp_stuff_tpu_torch as dst
    from dsp_stuff_tpu_torch.train import fit
    cell = small_cell("chain10.fit.b512")
    cfg = cell.config
    gen = torch.Generator().manual_seed(11)
    x = torch.randn((3, 2, 1280), generator=gen) * 0.25
    hidden = fitkind.hidden_sliders(cfg, cell.traffic["hidden"])
    tgt = torch.stack([fitkind.forward_rows(cfg, x[i], hidden, b.Prec())
                       for i in range(3)]).float()[:, :, None]
    with dst.policy("fast"):
        cg = dst.compile_graph(dst.loads_graph(json.dumps(cfg["graph"])),
                               device="cpu")
        p = cg.init_params(requires_grad=True)
        loss = fit.make_loss_fn(cg)(p, cg.init_state(), {"0": x[0]}, tgt[0])
        loss.backward()
    got = {f"{n}/{k}": float(v.grad) if v.grad is not None else 0.0
           for n, e in p.items() for k, v in e.items()}
    p0 = {k: float(p[k.split("/")[0]][k.split("/")[1]].detach()) for k in got}
    data = {"x": x, "target": tgt, "p0": p0, "lr": 0.03,
            "betas": (0.9, 0.999), "eps": 1e-8}
    want = fitkind.reference_steps(data, cfg, b.Prec())
    scale = max(abs(v) for v in want["g1"].values())
    assert len(got) == 16
    for k, v in want["g1"].items():
        assert abs(got[k] - v) <= 1e-4 * scale, (k, got[k], v)
    assert abs(float(loss.detach()) - want["losses"][0]) <= 1e-5 * want["losses"][0]


def test_reference_adam_is_torch_adam():
    w = torch.tensor([0.3, -1.2, 2.0], dtype=torch.float64, requires_grad=True)
    opt = torch.optim.Adam([w], lr=0.03, betas=(0.9, 0.999), eps=1e-8)
    grads = [np.array([0.5, -0.1, 1e-6]), np.array([0.4, 0.2, -1e-6]),
             np.array([-0.3, 0.1, 2e-6])]
    mine = w.detach().numpy().copy()
    m = np.zeros(3)
    v = np.zeros(3)
    for t, g in enumerate(grads, start=1):
        w.grad = torch.as_tensor(g)
        opt.step()
        m = 0.9 * m + 0.1 * g
        v = 0.999 * v + 0.001 * g * g
        mine = mine - (0.03 / (1 - 0.9 ** t)) * m / (
            np.sqrt(v) / np.sqrt(1 - 0.999 ** t) + 1e-8)
    np.testing.assert_allclose(mine, w.detach().numpy(), rtol=1e-12)


def test_leaf_gap_by_the_worst_leaf():
    want = {"a": 1.0, "b": -2.0, "c": 1e-9}
    got = {"a": 1.01, "b": 2.0, "c": 2e-9}
    # c is measured against the median leaf's norm (1.0): a gap of 1e-9
    assert fitkind.leaf_gap(got, want, ["a", "b", "c"]) == pytest.approx(0.01)
    assert fitkind.counted_leaves({"g1": {"a": 1.0, "b": 1.0,
                                          "c": 1e-4}}) == ["a", "b"]
