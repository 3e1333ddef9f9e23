"""Traffic kind "fit": ``train.fit.make_train_step`` (loss, backward, Adam,
clamp) with every slider of the graph a leaf, steps back to back, each
on the next batch of a pool of distinct inputs made on the device from
the seed.  The targets are the reference's render of those inputs under
the hidden sliders the traffic names, made by the benchmark at set-up and
handed to both sides.

Set-up drives the one training object through its first three steps, on
three batches that all differ, then hands it to the window.  The check
follows those three steps with the reference's float64 forward, autograd
backward and Adam (torch.optim.Adam's update, written out) and compares
each step's loss, each leaf's first gradient as Adam holds it after one
step (exp_avg / (1 - beta1)) and each leaf's change after three steps."""

from __future__ import annotations

import json
import time

import numpy as np

from . import common

SPAN = "step"
#: seconds of the profiled window of a --trace 1 run
TRACE_SECONDS = 3.0
#: steps at set-up that the reference follows
N_CHECKED = 3


class Job:
    def __init__(self, cell, seed: int, device: str, parts: dict):
        import torch
        import dsp_stuff_tpu_torch as dst
        from dsp_stuff_tpu_torch.train import fit
        from portbench.reference import blocks
        t = time.perf_counter()
        tr, cfg = cell.traffic, cell.config
        self.cell, self.seed, self.torch = cell, seed, torch
        self.B = int(tr["batch"])
        self.T = int(round(tr["seconds_per_stream"] * cfg["sample_rate"]))
        self.P = int(tr["pool"])
        if self.P < N_CHECKED:
            raise ValueError(f"a fit pool holds at least {N_CHECKED} batches")
        dst.set_policy(tr["policy"])
        self.cg = dst.compile_graph(dst.loads_graph(json.dumps(cfg["graph"])),
                                    device=device)
        self.inp = str(self.cg.input_ids[0])
        self.params = self.cg.init_params(requires_grad=True)
        self.lr = float(tr["learning_rate"])
        self.step, init_opt = fit.make_train_step(self.cg, fit.adam(self.lr))
        self.opt = init_opt(self.params)
        self.state = self.cg.init_state()
        parts["compile_graph"] = time.perf_counter() - t
        t = time.perf_counter()
        gen = torch.Generator(device=device).manual_seed(seed)
        self.pool = torch.randn((self.P, self.B, self.T), generator=gen,
                                device=device) * float(tr["amplitude"])
        self.targets = torch.empty((self.P, self.B, 1, self.T),
                                   device=device)
        hidden = hidden_sliders(cfg, tr["hidden"])
        prec = blocks.Prec("f64", device)
        for i in range(self.P):
            self.targets[i, :, 0] = forward_rows(cfg, self.pool[i], hidden,
                                                 prec).float()
        if device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        parts["inputs_and_targets"] = time.perf_counter() - t
        t = time.perf_counter()
        self.p0 = self.values()
        self.losses, self.g1 = [], None
        self.k = 0
        for _ in range(N_CHECKED):
            self.losses.append(float(self._step()))
            if self.g1 is None:
                b1 = self.opt.param_groups[0]["betas"][0]
                # a leaf the optimizer holds no moment of got no gradient
                self.g1 = {k: float(self.opt.state[v].get("exp_avg", 0.0))
                           / (1 - b1) for k, v in self.leaves()}
        self.p3 = self.values()
        parts["warm_up"] = time.perf_counter() - t

    def leaves(self):
        return [(f"{n}/{k}", v) for n, e in sorted(self.params.items())
                for k, v in sorted(e.items())]

    def values(self) -> dict:
        return {k: float(v.detach()) for k, v in self.leaves()}

    def _step(self):
        i = self.k % self.P
        self.params, self.opt, loss = self.step(
            self.params, self.opt, self.state, {self.inp: self.pool[i]},
            self.targets[i])
        self.k += 1
        return loss

    def units(self, seconds: float, span=None) -> int:
        n = len(common.run_for(seconds, self._step, span, SPAN))
        if self.cg.device.type == "cuda":
            self.torch.cuda.synchronize()
        return n

    def window(self, seconds: float) -> dict:
        t0 = time.perf_counter()
        n = self.units(seconds)
        return {"units": n, "wall_s": time.perf_counter() - t0}

    def collect(self) -> dict:
        data = {"x": self.pool[:N_CHECKED], "target": self.targets[:N_CHECKED],
                "p0": self.p0, "losses": self.losses, "g1": self.g1,
                "change": {k: self.p3[k] - self.p0[k] for k in self.p0},
                "lr": self.lr, "betas": self.opt.param_groups[0]["betas"],
                "eps": self.opt.param_groups[0]["eps"]}
        del self.cg, self.opt, self.params, self.state, self.step
        self.pool = self.targets = None
        return data


def hidden_sliders(cfg: dict, hidden: dict) -> dict:
    """The configuration's sliders with the first node of each named
    type set to the hidden value ({typename: [slider, value]})."""
    from portbench import reference as ref
    s = ref.sliders(cfg)
    for kind, (name, value) in hidden.items():
        nid = next(str(n["id"]) for n in cfg["graph"]["nodes"]
                   if n["typename"] == kind)
        s[nid][name] = value
    return s


def forward_rows(cfg: dict, x, sliders: dict, prec, rows: int = 32):
    """The reference's output [B, T] of x [B, T], a block of rows at a
    time."""
    import torch
    from portbench import reference as ref
    comp = ref.composition(cfg["name"])
    with torch.no_grad():
        return torch.cat([comp.forward(prec.t(x[r:r + rows]), sliders, prec)
                          for r in range(0, x.shape[0], rows)])


def reference_steps(data: dict, cfg: dict, prec, half: bool = False,
                    rows: int = 32) -> dict:
    """The three checked steps by the reference from the same start:
    losses, the first step's gradient of each leaf, each leaf's change.
    ``half``: each loss the mean over the first half of the batch alone
    (a fault the check must catch)."""
    import torch
    from portbench import reference as ref
    comp = ref.composition(cfg["name"])
    base = ref.sliders(cfg)
    keys = list(data["p0"])
    leaf = {k: torch.tensor(data["p0"][k], dtype=prec.dtype,
                            device=prec.device, requires_grad=True)
            for k in keys}
    s = {n: dict(e) for n, e in base.items()}
    for k, v in leaf.items():
        n, name = k.split("/")
        s[n][name] = v
    b1, b2 = data["betas"]
    lr, eps = data["lr"], data["eps"]
    m = {k: 0.0 for k in keys}
    v2 = {k: 0.0 for k in keys}
    losses, g1 = [], None
    lohi = cfg["slider_ranges"]
    for step in range(N_CHECKED):
        x, tgt = data["x"][step], data["target"][step]
        B = x.shape[0] // 2 if half else x.shape[0]
        for t in leaf.values():
            t.grad = None
        total = 0.0
        for r in range(0, B, rows):
            r1 = min(r + rows, B)
            y = comp.forward(prec.t(x[r:r1]), s, prec)
            loss = ((y - prec.t(tgt[r:r1, 0])) ** 2).sum() / (B * x.shape[-1])
            loss.backward()
            total += float(loss.detach())
        losses.append(total)
        g = {k: (float(t.grad) if t.grad is not None else 0.0)
             for k, t in leaf.items()}
        if g1 is None:
            g1 = g
        with torch.no_grad():
            for k, t in leaf.items():
                m[k] = b1 * m[k] + (1 - b1) * g[k]
                v2[k] = b2 * v2[k] + (1 - b2) * g[k] ** 2
                bc1, bc2 = 1 - b1 ** (step + 1), 1 - b2 ** (step + 1)
                upd = (lr / bc1) * m[k] / (np.sqrt(v2[k]) / np.sqrt(bc2) + eps)
                lo, hi = lohi[k]
                t.copy_(torch.clamp(t - upd, lo, hi))
    return {"losses": losses, "g1": g1,
            "change": {k: float(leaf[k].detach()) - data["p0"][k]
                       for k in keys}}


def reference(data: dict, cfg: dict, prec) -> dict:
    return reference_steps(data, cfg, prec)


def leaf_gap(got: dict, want: dict, counted) -> float:
    """The worst counted leaf's gap between the program's and the
    reference's norms, over the larger of the reference leaf's norm and
    the median leaf's."""
    med = float(np.median([abs(want[k]) for k in counted]))
    return max(abs(abs(got[k]) - abs(want[k])) / max(abs(want[k]), med, 1e-30)
               for k in counted)


def counted_leaves(want: dict) -> list:
    """Leaves whose reference gradient is at least a thousandth of the
    median leaf's: the others move under Adam by round-off alone."""
    med = float(np.median([abs(v) for v in want["g1"].values()]))
    return [k for k, v in want["g1"].items() if abs(v) >= 1e-3 * med]


def readings(got: dict, want: dict) -> dict:
    counted = counted_leaves(want)
    loss = max(abs(a - b) / abs(b) for a, b in zip(got["losses"],
                                                     want["losses"]))
    return {"loss_rel_gap": loss,
            "grad_gap": leaf_gap(got["g1"], want["g1"], counted),
            "change_gap": leaf_gap(got["change"], want["change"], counted)}
