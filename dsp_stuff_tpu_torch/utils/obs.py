"""Observability: logging, profiler traces, NaN hunting, per-node debugging.

The reference's stack (SURVEY.md section 5): tracing-subscriber fmt layer
with span-close durations, EnvFilter (default "dsp_stuff=info"),
tokio-console task profiler, and #[tracing::instrument] on every
process().  The port's analogs:

* ``logger`` / env filter: std logging, level from $DST_LOG (RUST_LOG
  analog), default INFO;
* ``trace(dir)``: a torch.profiler context exporting a Chrome trace (the
  kernels instead of tokio-console's tasks);
* ``debug_render``: node-by-node evaluation on a device that reports
  per-node output stats (max/rms/NaN count) and wall time, the analog of
  per-span durations, plus the NaN detection Rust's runtime never needed;
* ``nan_guard``: wraps a function and raises if outputs go non-finite.
"""

from __future__ import annotations

import contextlib
import logging
import os
import pathlib
import time

import numpy as np
import torch

logger = logging.getLogger("dsp_stuff_tpu_torch")
if not logger.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter(
        "%(asctime)s %(levelname).1s %(name)s: %(message)s", "%H:%M:%S"))
    logger.addHandler(_h)
    logger.setLevel(os.environ.get("DST_LOG", "INFO").upper())

#: where ``trace`` writes by default: the git-ignored build/ of the checkout
TRACE_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "trace"


@contextlib.contextmanager
def trace(log_dir=TRACE_DIR):
    """torch.profiler trace of the CPU and (when there is one) the card
    around a block; writes ``log_dir/trace.json`` (a Chrome trace, for
    chrome://tracing or Perfetto).  Yields the profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    log_dir = pathlib.Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        path = log_dir / "trace.json"
        prof.export_chrome_trace(str(path))
        logger.info("profiler trace written to %s", path)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def debug_render(graph, inputs=None, T: int | None = None,
                 block_size: int = 128, device="cuda"):
    """Node-by-node render on ``device`` (the card by default; "cpu" for
    the CPU) with per-node stats; returns (outs [n_out, T] NumPy, report).

    report: list of dicts {node, cfg, port, ms, out_rms, out_max, nan, inf}
    in execution order.  The compiler's NODE_HOOK fires after every node
    (the fused paths stand down while it is set); in a feedback cycle it
    fires once per block, with that block's values, and the stats
    aggregate.  The stats are computed on the device; on the card each
    node's time ends with a synchronize, so it is the node's own.  For
    debugging, not production."""
    from dsp_stuff_tpu_torch.compiler import compile as C

    report: list[dict] = []
    by_key: dict[tuple, dict] = {}
    last_t = [0.0]

    def hook(nid, cfg_name, outs):
        _sync(cg.device)
        dt_ms = (time.perf_counter() - last_t[0]) * 1e3
        for port, val in outs.items():
            key = (nid, port)
            rec = by_key.get(key)
            if rec is None:
                rec = {"node": nid, "cfg": cfg_name, "port": port,
                       "ms": 0.0, "out_rms": 0.0, "out_max": 0.0,
                       "nan": 0, "inf": 0}
                by_key[key] = rec
                report.append(rec)
            rec["ms"] += dt_ms
            dt_ms = 0.0          # a node's time is charged to its first port
            v = val.detach().to(torch.float32)
            if v.numel():
                stats = torch.stack([
                    torch.sqrt(torch.mean(v * v)), torch.abs(v).max(),
                    torch.isnan(v).sum().to(torch.float32),
                    torch.isinf(v).sum().to(torch.float32)]).cpu().numpy()
                rec["out_rms"] = max(rec["out_rms"], float(stats[0]))
                rec["out_max"] = max(rec["out_max"], float(stats[1]))
                rec["nan"] += int(stats[2])
                rec["inf"] += int(stats[3])
            if rec["nan"] or rec["inf"]:
                logger.warning("node %s (%s) emitted %d NaN / %d Inf",
                               nid, cfg_name, rec["nan"], rec["inf"])
        last_t[0] = time.perf_counter()

    cg = C.compile_graph(graph, block_size, device=device)
    ext = cg._pack_inputs(inputs, T, ())
    T_ = next(iter(ext.values())).shape[-1] if ext else T
    prev = C.NODE_HOOK
    C.NODE_HOOK = hook
    try:
        _sync(cg.device)
        last_t[0] = time.perf_counter()
        with torch.no_grad():
            _state, outs, _aux = cg.fn(cg.init_state(), ext, None)
    finally:
        C.NODE_HOOK = prev
    out_arr = (torch.stack([outs[i].expand(T_) for i in cg.output_ids])
               .cpu().numpy() if cg.output_ids
               else np.zeros((0, T_), np.float32))
    return out_arr, report


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def nan_guard(fn, name: str = "fn"):
    """Wrap fn; raise FloatingPointError if any floating output leaf (a
    tensor or an array, in nested dicts, lists and tuples) is
    non-finite."""
    def inner(*args, **kwargs):
        out = fn(*args, **kwargs)
        for leaf in _leaves(out):
            if isinstance(leaf, torch.Tensor):
                if not leaf.is_floating_point():
                    continue
                n_nan = int(torch.isnan(leaf).sum())
                n_inf = int(torch.isinf(leaf).sum())
            else:
                arr = np.asarray(leaf)
                if arr.dtype.kind != "f":
                    continue
                n_nan, n_inf = int(np.isnan(arr).sum()), int(np.isinf(arr).sum())
            if n_nan or n_inf:
                raise FloatingPointError(
                    f"{name}: non-finite output ({n_nan} NaN, {n_inf} Inf)")
        return out
    return inner
