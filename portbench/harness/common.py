"""What every cell shares: finding a cell's files by name, the run's
environment, statistics over a window, the comparison with the limits,
and the result line."""

from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
import time
from contextlib import nullcontext
from dataclasses import dataclass

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
#: top-level modules that must not be loaded in a run (whole names)
FORBIDDEN = ("jax", "jaxlib", "flax", "dsp_stuff_tpu")


@dataclass
class Cell:
    """One entry of BENCHMARK.json's ``workloads`` with its files."""
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list

    @property
    def kind(self) -> str:
        """The traffic's kind: the harness module that runs it."""
        return self.traffic["kind"]


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` of ``root``/BENCHMARK.json: its configuration
    (configs/<config>.json), traffic (traffic/<traffic>.json), limits
    (limits/<cell>.json) and the metrics it reports."""
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    try:
        w = next(w for w in bench["workloads"] if w["name"] == name)
    except StopIteration:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json") from None
    c = next(c for c in bench["configs"] if c["name"] == w["config"])
    here = os.path.join(root, "portbench")
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m
                 else m["moves"] in moved)]
    return Cell(name=name, chips=int(w["chips"]),
                config=_json(os.path.join(root, c["file"])),
                traffic=_json(os.path.join(here, "traffic",
                                           w["traffic"] + ".json")),
                limits=_json(os.path.join(here, "limits", name + ".json")),
                end_to_end=e2e, per_layer=layer)


def forbidden_modules(modules=None) -> list:
    """The loaded modules whose top-level name (before the first dot) is
    one of FORBIDDEN, compared whole."""
    mods = sys.modules if modules is None else modules
    return sorted(m for m in mods if m.split(".")[0] in FORBIDDEN)


def no_span(name):
    """A host span that records nothing (the untraced window)."""
    return nullcontext()


def run_for(seconds: float, unit, span=None, name: str = "unit") -> list:
    """Call ``unit()`` back to back, each under ``span(name)``, until
    ``seconds`` have passed; returns each call's wall seconds."""
    span = span or no_span
    times, end = [], time.perf_counter() + seconds
    while True:
        a = time.perf_counter()
        with span(name):
            unit()
        t = time.perf_counter()
        times.append(t - a)
        if t >= end:
            return times


def host(t):
    """A tensor as a float32 NumPy array on the host."""
    return t.detach().float().cpu().numpy()


def percentile(values, q: float) -> float:
    """The q-th percentile of all ``values`` (linear between the two
    nearest ranks, as numpy's default)."""
    v = sorted(values)
    if not v:
        raise ValueError("percentile of no values")
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def rate(units: int, per_unit: float, wall_s: float) -> float:
    """Work per second over a whole window: ``units`` completed, each
    ``per_unit`` of work, in ``wall_s`` seconds of wall time."""
    return units * per_unit / wall_s


def rel_err(got, want) -> float:
    """max |got - want| / max |want| over whole arrays (float64)."""
    import numpy as np
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape:
        return math.inf
    err = np.abs(got - want).max()
    scale = np.abs(want).max()
    if not np.isfinite(err):
        return math.inf
    return float(err / max(scale, 1e-30))


def held(readings: dict, limits: dict) -> tuple:
    """(correct, checks): every reading finite and at most its limit;
    ``checks`` {name: {"value", "limit"}} in the readings' order."""
    checks = {}
    ok = bool(readings)
    for name, v in readings.items():
        lim = limits.get(name)
        checks[name] = {"value": v, "limit": lim}
        if lim is None or v is None or not math.isfinite(v) or v > lim:
            ok = False
    return ok, checks


def reader(name: str):
    """The ``read(ctx)`` of metrics/<name>.py."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def result_line(correct: bool, attempted: int, failed: int, metrics: dict,
                device: dict, checks: dict, breakdown=None) -> str:
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return json.dumps(out)
