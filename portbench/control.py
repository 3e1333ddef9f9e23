"""Readings that set a cell's limits: the program's and its control's,
over many seeds in one process, at the cell's own size.

    python3 portbench/control.py --workload <name> --seeds 1,2,3 \
        [--seconds 2]

For each seed the cell's job is set up as a run sets it up, runs a short
window at the cell's load, and hands over what it checks.  Printed, one
JSON line a seed: the program's readings against the float64 reference;
the control's, the reference computed in the precision below the
configuration's (float32 with TF32 products, ``blocks.Prec("tf32")``) put
in the program's place; and for a training cell the reference with half
of each batch left out of the loss (a fault the check must catch).  The
benchmark's own runs do not run this."""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench.harness import common  # noqa: E402


def readings_of(cell, seed: int, seconds: float, device: str = "cuda"):
    import importlib
    import torch
    from portbench.reference import blocks
    kind = importlib.import_module(f"portbench.harness.{cell.kind}")
    job = kind.Job(cell, seed, device, {})
    job.window(seconds)
    data = job.collect()
    del job
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = False
    want = kind.reference(data, cell.config, blocks.Prec("f64", device))
    out = {"seed": seed,
           "program": kind.readings(data, want),
           "control": kind.readings(
               kind.reference(data, cell.config, blocks.Prec("tf32", device)),
               want)}
    if cell.kind == "fit":
        out["half_batch"] = kind.readings(
            kind.reference_steps(data, cell.config,
                                 blocks.Prec("f64", device), half=True),
            want)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    cell = common.load_cell(args.workload, ROOT)
    import torch
    if not torch.cuda.is_available():
        print("control.py runs on the card", file=sys.stderr)
        return 2
    rows = []
    for s in (int(v) for v in args.seeds.split(",")):
        t = time.perf_counter()
        r = readings_of(cell, s, args.seconds)
        r["seconds"] = time.perf_counter() - t
        rows.append(r)
        print(json.dumps(r), flush=True)
    for who in ("program", "control", "half_batch"):
        if who in rows[0]:
            agg = max if who == "program" else min
            print(json.dumps({who: {k: agg(r[who][k] for r in rows)
                                    for k in rows[0][who]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
