"""Run one cell of the benchmark of dsp_stuff_tpu_torch once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The cell is an entry of BENCHMARK.json's ``workloads``; its
configuration, traffic, limits and metric readers are files under
portbench/ found by name (README.md).  Set-up (imports, the CUDA
context, compile_graph, kernel loads or builds, inputs, warm-up) is
timed from the start of this process to the first timed unit.  The
window then runs units for ``--seconds``; with ``--trace 1`` a profiled
window of the traffic kind's ``TRACE_SECONDS`` follows it.  Once the windows
have closed and the peak memory is read, the program is freed and the
checked outputs are compared with the reference (portbench/reference).

Prints the set-up's parts and each compared number with its limit on
standard error, and one JSON line last on standard output.  Exits 2
without a result when the cell's CUDA devices are missing, and 3 when a
module of JAX or of the JAX package was loaded."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import glob  # noqa: E402
import importlib  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench.harness import common, trace as tracing  # noqa: E402


class Ctx:
    """What a metric reader reads: the cell, the window's host-clock
    record, the set-up time, the traced window (or None) and the facts
    the job took before it was freed."""

    def __init__(self, cell, window, setup_s, trace, facts):
        self.cell, self.window, self.setup_s = cell, window, setup_s
        self.trace, self.facts = trace, facts


def _libraries() -> int:
    return len(glob.glob(os.path.join(ROOT, "build", "torch_kernels",
                                      "*.so")))


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def run_cell(cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float | None = None) -> dict:
    """One run of ``cell``: the result's fields, and ``setup_parts``."""
    import torch
    from portbench.reference import blocks
    t_start = T_START if t_start is None else t_start
    parts = {"import": time.perf_counter() - t_start}
    kind = importlib.import_module(f"portbench.harness.{cell.kind}")
    on_card = device == "cuda"
    torch.set_num_threads(4)
    t = time.perf_counter()
    if on_card:
        torch.zeros(1, device=device)
        torch.cuda.synchronize()
    parts["cuda_init"] = time.perf_counter() - t
    libs = _libraries()
    job = kind.Job(cell, seed, device, parts)
    parts["kernel_builds"] = _libraries() - libs
    setup_s = time.perf_counter() - t_start
    print("setup " + " ".join(f"{k}={v:.3f}" if isinstance(v, float)
                              else f"{k}={v}" for k, v in parts.items()),
          file=sys.stderr)
    window = job.window(seconds)
    tr = facts = None
    if trace:
        tr = tracing.profile(job.units, kind.TRACE_SECONDS, kind.SPAN)
        print(f"trace units={tr.units} window_s={tr.window_s!r}",
              file=sys.stderr)
        facts = job.facts() if hasattr(job, "facts") else {}
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    data = job.collect()
    del job
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = False
    want = kind.reference(data, cell.config, blocks.Prec("f64", device))
    readings = kind.readings(data, want)
    correct, checks = common.held(readings, cell.limits)
    ctx = Ctx(cell, window, setup_s, tr, facts or {})
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = common.reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": window["units"], "failed": 0,
           "metrics": metrics, "device": dev, "checks": checks,
           "setup_parts": parts}
    if tr is not None:
        dev["busy_s"] = tr.busy_s()
        dev["window_s"] = tr.window_s
        out["breakdown"] = {"device_ops": tr.device_ops(),
                            "idle_gaps": tr.idle_gaps()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = common.load_cell(args.workload, ROOT)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              f" found", file=sys.stderr)
        return 2
    r = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    bad = common.forbidden_modules()
    if bad:
        print(f"loaded in this process, which the benchmark forbids: {bad}",
              file=sys.stderr)
        return 3
    if args.trace:
        print(f"card: {power_limit()}", file=sys.stderr)
    for name, c in r["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(common.result_line(r["correct"], r["attempted"], r["failed"],
                             r["metrics"], r["device"], r["checks"],
                             r.get("breakdown")))
    return 0


if __name__ == "__main__":
    sys.exit(main())
