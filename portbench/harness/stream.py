"""Traffic kind "stream": one ``StreamSession`` fed 128-sample blocks in a
closed loop, as a live rack's audio callback does: the next
``process()`` starts when the last returns.  Every block's wall time is
kept; the input is one continuous stream made on the device from the
seed and read back to the host once.

The check: the concatenated outputs of the first ``CHECK_BLOCKS`` blocks,
with the state carried from the first, against the reference's render
of the same samples."""

from __future__ import annotations

import json
import os
import time

import numpy as np

from . import common

SPAN = "process"
#: seconds of the profiled window of a --trace 1 run
TRACE_SECONDS = 0.5
#: blocks of input made at set-up, replayed in a loop if the window
#: outlasts them
INPUT_BLOCKS = 16384
#: blocks of silence processed to warm up and capture, then reset
WARM_BLOCKS = 2
#: blocks from the first compared with the reference
CHECK_BLOCKS = 3750


class Job:
    def __init__(self, cell, seed: int, device: str, parts: dict):
        import torch
        import dsp_stuff_tpu_torch as dst
        t = time.perf_counter()
        tr, cfg = cell.traffic, cell.config
        self.cell, self.seed, self.torch = cell, seed, torch
        self.n = int(tr["block"])
        dst.set_policy(tr["policy"])
        self.sess = dst.StreamSession(
            dst.loads_graph(json.dumps(cfg["graph"])), block_size=self.n,
            device=device)
        parts["compile_graph"] = time.perf_counter() - t
        t = time.perf_counter()
        nb = max(INPUT_BLOCKS, CHECK_BLOCKS)
        gen = torch.Generator(device=device).manual_seed(seed)
        x = torch.randn((nb, 1, self.n), generator=gen,
                        device=device) * float(tr["amplitude"])
        self.x = common.host(x)
        parts["inputs"] = time.perf_counter() - t
        t = time.perf_counter()
        for _ in range(WARM_BLOCKS):
            self.sess.process(np.zeros((1, self.n), np.float32))
        self.sess.reset()
        parts["warm_up"] = time.perf_counter() - t
        parts["capture"] = self.sess.step.capture_s
        self.k = 0
        self.kept = []

    def _next(self):
        y = self.sess.process(self.x[self.k % len(self.x)])
        if self.k < CHECK_BLOCKS:
            self.kept.append(y)
        self.k += 1

    def units(self, seconds: float, span=None) -> int:
        """process() blocks, each after the last returned, until
        ``seconds`` have passed; returns how many."""
        self.block_s = common.run_for(seconds, self._next, span, SPAN)
        return len(self.block_s)

    def window(self, seconds: float) -> dict:
        t0 = time.perf_counter()
        n = self.units(seconds)
        wall = time.perf_counter() - t0
        return {"units": n, "wall_s": wall, "block_s": list(self.block_s)}

    def facts(self) -> dict:
        """The captured block graph's kernel nodes (its DOT dump)."""
        if self.sess.device.type != "cuda":
            return {}
        path = os.path.join(common.ROOT, "build", "portbench",
                            f"{self.cell.name}.dot")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        self.sess.step.dump_graph(path)
        return {"graph_dot": path}

    def collect(self) -> dict:
        k = len(self.kept)
        data = {"x": self.x[:k, 0].reshape(1, -1),
                "out": np.concatenate(self.kept, axis=-1)[:1]}
        del self.sess
        self.kept = []
        return data


def reference(data: dict, cfg: dict, prec) -> dict:
    from portbench import reference as ref
    r = ref.composition(cfg["name"]).render(data["x"], cfg, prec)
    return {"out": r["out"].detach().cpu().numpy()}


def readings(got: dict, want: dict) -> dict:
    return {"out_rel_err": common.rel_err(got["out"], want["out"])}
