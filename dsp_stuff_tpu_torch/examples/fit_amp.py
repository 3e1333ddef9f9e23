"""Amp matching: recover distortion-chain settings from a target render
(the port of examples/fit_amp.py).

Builds gain -> overdrive -> low_pass, renders a 'secret' setting as the
target, then fits the sliders from their defaults with
``torch.optim.Adam`` by gradient through the render.

    python -m dsp_stuff_tpu_torch.examples.fit_amp [--device cpu]
        [--steps 400] [--samples 4096]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

import dsp_stuff_tpu_torch as dst
from dsp_stuff_tpu_torch.ids import IdSpace
from dsp_stuff_tpu_torch.train import fit


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="the card (default) or cpu")
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--samples", type=int, default=4096,
                    help="samples of each of the 8 streams")
    args = ap.parse_args(argv)
    g = dst.Graph(IdSpace())
    inp = g.add("input")
    gn = g.add("gain", level=1.0)
    od = g.add("overdrive", boost=5.0, drive=0.5, level=0.8)
    lp = g.add("low_pass", ratio=0.3)
    out = g.add("output")
    g.chain(inp, gn, od, lp, out)

    with dst.policy("fast"):
        cg = dst.compile_graph(g, device=args.device)
        x = torch.as_tensor((np.random.default_rng(0).standard_normal(
            (8, args.samples)) * 0.3).astype(np.float32), device=cg.device)
        ext = {str(inp.id): x}
        secret = cg.init_params()
        secret[str(gn.id)]["level"] = torch.tensor(2.0, device=cg.device)
        secret[str(lp.id)]["ratio"] = torch.tensor(0.7, device=cg.device)
        with torch.no_grad():
            target, _, _ = cg.render(ext, params=secret, batch_shape=(8,))

        params = cg.init_params(requires_grad=True)
        opt = torch.optim.Adam([v for e in params.values()
                                for v in e.values()], lr=0.03)
        loss_fn = fit.make_loss_fn(cg)
        state = cg.init_state()
        for i in range(args.steps):
            opt.zero_grad(set_to_none=True)
            loss = loss_fn(params, state, ext, target)
            loss.backward()
            opt.step()
            fit.clamp_params(cg, params)
            if i % max(args.steps // 10, 1) == 0:
                print(f"step {i:4d}  loss {float(loss):.3e}")
        final = float(loss_fn(params, state, ext, target))

    print("\nrecovered:")
    # gain.level and the overdrive stage are jointly non-identifiable
    # (several settings give near-identical output); the loss is what counts
    print(f"  gain.level    = {float(params[str(gn.id)]['level']):.3f}  "
          f"(true 2.0)")
    print(f"  lowpass.ratio = {float(params[str(lp.id)]['ratio']):.3f}  "
          f"(true 0.7)")
    print(f"final loss {final:.2e} on {cg.device}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
