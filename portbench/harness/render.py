"""Traffic kind "render": ``CompiledGraph.render`` of [batch, T] streams,
back to back as a batch job dispatches them, over a pool of distinct
inputs made on the device from the seed.  A synchronize ends the window;
every render dispatched in it is complete at its end and counts.

The check: streams drawn from the seed among the newest render of each
pool slot, their whole output and a spectrogram tap's columns, and of
those from the window's last render the state it returned (each stateful
node's and each feedback cycle's), against the reference, once the window
has closed.  Only the last render's state is kept, as a chunked render
keeps its previous chunk's."""

from __future__ import annotations

import json
import time

import numpy as np

from . import common

SPAN = "render"
#: seconds of the profiled window of a --trace 1 run
TRACE_SECONDS = 3.0
#: streams compared with the reference (at most the batch)
CHECK_STREAMS = 16


class Job:
    def __init__(self, cell, seed: int, device: str, parts: dict):
        import torch
        import dsp_stuff_tpu_torch as dst
        t = time.perf_counter()
        tr, cfg = cell.traffic, cell.config
        self.cell, self.seed, self.torch = cell, seed, torch
        self.B = int(tr["batch"])
        self.T = int(round(tr["seconds_per_stream"] * cfg["sample_rate"]))
        self.P = int(tr["pool"])
        dst.set_policy(tr["policy"])
        self.cg = dst.compile_graph(
            dst.loads_graph(json.dumps(cfg["graph"])), device=device)
        self.inp = str(cfg["input"])
        self.spec = (f"spectrogram:{cfg['spectrogram']}"
                     if "spectrogram" in cfg else None)
        parts["compile_graph"] = time.perf_counter() - t
        t = time.perf_counter()
        gen = torch.Generator(device=device).manual_seed(seed)
        self.pool = torch.randn((self.P, self.B, self.T), generator=gen,
                                device=device) * float(tr["amplitude"])
        parts["inputs"] = time.perf_counter() - t
        t = time.perf_counter()
        self.k = 0
        self.newest: dict = {}
        self._render(0)
        self.sync()
        parts["warm_up"] = time.perf_counter() - t
        self.k = 0
        self.newest.clear()

    def sync(self):
        if self.cg.device.type == "cuda":
            self.torch.cuda.synchronize()

    def _render(self, slot):
        out, aux, state = self.cg.render({self.inp: self.pool[slot]},
                                         batch_shape=(self.B,))
        self.newest[slot] = (out, aux[self.spec]["columns"] if self.spec
                             else None)
        self.last = (slot, state)

    def _next(self):
        self._render(self.k % self.P)
        self.k += 1

    def units(self, seconds: float, span=None) -> int:
        """Renders back to back until ``seconds`` have passed, then a
        synchronize; returns how many."""
        self.host_s = common.run_for(seconds, self._next, span, SPAN)
        self.sync()
        return len(self.host_s)

    def window(self, seconds: float) -> dict:
        t0 = time.perf_counter()
        n = self.units(seconds)
        wall = time.perf_counter() - t0
        return {"units": n, "wall_s": wall,
                "audio_s": self.B * self.T / self.cell.config["sample_rate"],
                "host_s": list(self.host_s)}

    def collect(self) -> dict:
        """The checked streams' inputs and outputs on the host; frees the
        program's state.  The first ``S // slots`` (at least one) come
        from the last render, whose state is compared too."""
        rng = np.random.default_rng(self.seed)
        S = min(CHECK_STREAMS, self.B)
        slots = sorted(self.newest)
        last, state = self.last
        n_state = max(1, S // len(slots))
        rows = rng.choice(self.B, size=S, replace=False)
        picks = [(last if i < n_state else
                  slots[int(rng.integers(len(slots)))], int(r))
                 for i, r in enumerate(rows)]
        host = common.host
        data = {"x": np.stack([host(self.pool[s, r]) for s, r in picks]),
                "out": np.stack([host(self.newest[s][0][r, 0])
                                 for s, r in picks]),
                "picks": picks, "state_rows": n_state}
        if self.spec:
            data["spec"] = np.stack([host(self.newest[s][1][r])
                                     for s, r in picks])
        ends = [end_state(state, r) for _, r in picks[:n_state]]
        data["state"] = {k: {e: np.stack([row[k][e] for row in ends])
                             for e in v} for k, v in ends[0].items()}
        del self.cg, self.pool, self.last
        self.newest.clear()
        return data


def end_state(state: dict, row: int) -> dict:
    """One stream's entries of the state a render returned, on the host:
    {key: {entry: array}}.  A delay line held as a ring and a write
    position is read oldest first from the position; a shared counter
    (an int) is given as a number."""
    out = {}
    for k, st in state.items():
        if not isinstance(st, dict):
            continue
        e = {}
        for name, v in st.items():
            if name == "pos":
                continue
            if name == "ring" and "pos" in st:
                D = v.shape[-1]
                v = v[..., (int(st["pos"]) + np.arange(D)) % D]
            if hasattr(v, "detach"):
                e[name] = common.host(v[row] if v.dim() else v)
            else:
                e[name] = np.float32(v)
        if e:
            out[k] = e
    return out


def reference(data: dict, cfg: dict, prec) -> dict:
    from portbench import reference as ref
    r = ref.composition(cfg["name"]).render(data["x"], cfg, prec)
    out = {k: v.detach().cpu().numpy() for k, v in r.items()
           if k != "state"}
    n = data["state_rows"]
    out["state"] = {k: {e: v[:n].detach().cpu().numpy()
                        for e, v in st.items()}
                    for k, st in r["state"].items()}
    return out


def state_err(got: dict, want: dict) -> float:
    """The worst entry of the reference's end state: max |got - want| /
    max |want| over the checked streams; an entry the program did not
    return reads inf."""
    return max((common.rel_err(got.get(k, {}).get(e, np.nan), w)
                for k, st in want.items() for e, w in st.items()),
               default=np.inf)


def readings(got: dict, want: dict) -> dict:
    out = {"out_rel_err": common.rel_err(got["out"], want["out"])}
    if "spec" in want:
        out["spec_rel_err"] = common.rel_err(got["spec"], want["spec"])
    out["state_rel_err"] = state_err(got["state"], want["state"])
    return out
