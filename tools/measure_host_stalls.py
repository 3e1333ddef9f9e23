#!/usr/bin/env python3
"""How often the host takes a core away from a busy thread, and whether
the other cores stall with it.

    python3 tools/measure_host_stalls.py [SECONDS]

Runs host-only work (NumPy, no CUDA) in iterations of 0.5 ms on one
pinned core for SECONDS (default 50), with the garbage collector off,
while a second process pinned to another core spins on the clock and
records each gap in its own ticks over 1 ms.  Prints the iterations that
took over 1.5 ms and over the 2.667 ms a 128-sample block lasts at
48 kHz, the longest, each stall with the part of it the other core also
lost, and the other core's gaps.  A stall the other core does not share
is the host descheduling one core, not a pause of the whole machine.

This is the witness for the stream timing in chip_smoke.automation_run
(two sessions a stream: a block is over only when it is over in both),
and needs no GPU; it prints the card's name and power limit when
nvidia-smi is there.
"""

from __future__ import annotations

import gc
import os
import subprocess
import sys
import time

import numpy as np

WATCHDOG = """
import os, sys, time
os.sched_setaffinity(0, {int(sys.argv[1])})
gaps, last = [], time.perf_counter()
end = last + float(sys.argv[2])
while last < end:
    t = time.perf_counter()
    if t - last > 1e-3:
        gaps.append((last, t))
    last = t
for a, b in gaps:
    print(a, b)
"""


def main() -> int:
    seconds = float(sys.argv[1]) if len(sys.argv) > 1 else 50.0
    try:
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True).stdout.strip())
    except (OSError, subprocess.CalledProcessError):
        print("no nvidia-smi on this machine")
    cores = sorted(os.sched_getaffinity(0))
    if len(cores) < 2:
        print("measure_host_stalls: needs two cores", file=sys.stderr)
        return 1
    wd = subprocess.Popen([sys.executable, "-c", WATCHDOG, str(cores[-1]),
                           str(seconds + 1.0)], stdout=subprocess.PIPE,
                          text=True)
    a = np.random.default_rng(0).standard_normal(4096)
    its, stalls, longest = 0, [], 0.0
    gc.disable()
    os.sched_setaffinity(0, {cores[0]})
    try:
        time.sleep(0.5)
        end = time.perf_counter() + seconds
        while time.perf_counter() < end:
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < 0.5e-3:
                a = np.sin(a)
            t1 = time.perf_counter()
            its += 1
            longest = max(longest, t1 - t0)
            if t1 - t0 > 1.5e-3:
                stalls.append((t0, t1))
    finally:
        os.sched_setaffinity(0, set(cores))
        gc.enable()
    out, _ = wd.communicate()
    gaps = [tuple(map(float, line.split())) for line in out.splitlines()
            if line.strip()]
    over = sum(1 for s0, s1 in stalls if s1 - s0 > 128 / 48_000)
    print(f"{its} iterations of 0.5 ms host-only work over {seconds:g} s "
          f"on core {cores[0]}: {len(stalls)} over 1.5 ms, {over} over "
          f"2.667 ms, the longest {1e3 * longest:.3f} ms")
    for s0, s1 in stalls:
        shared = sum(max(0.0, min(s1, g1) - max(s0, g0)) for g0, g1 in gaps)
        print(f"  a stall of {1e3 * (s1 - s0):.3f} ms; core {cores[-1]} "
              f"lost {1e3 * shared:.3f} ms of it")
    print(f"core {cores[-1]}'s own gaps over 1 ms: "
          f"{[round(1e3 * (b - a), 3) for a, b in gaps]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
