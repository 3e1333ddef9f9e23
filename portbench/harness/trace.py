"""The traced window: torch.profiler over a run of units, each under a
host span of the harness's own, and the reduction of its device
timeline to busy time, idle gaps and device time by kernel."""

from __future__ import annotations

import bisect
import time
from dataclasses import dataclass

WINDOW = "portbench.window"
LEAD_IN = 64            # spin kernels that open a profile: a trace loses
                        # its first device records


@dataclass
class TraceData:
    """Times in microseconds on the profiler's clock."""
    window: tuple                 # (start, end) of the harness's window span
    device: list                  # (name, start, end, kind) kind: kernel/copy
    spans: list                   # (start, end, name) of the host spans
    units: int                    # units run in the window

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def kernels(self, match=None) -> list:
        return [e for e in self.device if e[3] == "kernel"
                and (match is None or match(e[0]))]

    def busy_s(self) -> float:
        """Seconds of the window in which some device operation ran (the
        union of their intervals)."""
        return sum(b - a for a, b in merged(self.device, self.window)) / 1e6

    def device_ops(self, n: int = 10) -> list:
        """The n kernels (and copies) by name that took most device time,
        [name, seconds]."""
        tot: dict = {}
        for name, a, b, _ in self.device:
            tot[name] = tot.get(name, 0.0) + (b - a) / 1e6
        return [[k[:160], v] for k, v in
                sorted(tot.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list:
        """The n longest stretches of the window with nothing on the
        device, each named by the host span open where it began."""
        iv = merged(self.device, self.window)
        w0, w1 = self.window
        edges = [w0] + [x for a, b in iv for x in (a, b)] + [w1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        starts = [s[0] for s in self.spans]

        def at(t):
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and self.spans[i][1] >= t:
                return self.spans[i][2]
            return "between units"
        gaps.sort(key=lambda g: g[0] - g[1])
        return [[at(a), (b - a) / 1e6] for a, b in gaps[:n]]


def merged(events, window) -> list:
    """The union of the events' [start, end) intervals clipped to the
    window, as sorted disjoint (start, end) pairs."""
    w0, w1 = window
    iv = sorted((max(a, w0), min(b, w1)) for _, a, b, _ in events
                if b > w0 and a < w1)
    out = []
    for a, b in iv:
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def _kind(name: str) -> str:
    low = name.lower()
    if low.startswith(("memcpy", "memset")):
        return "copy"
    return "kernel"


def profile(run_units, seconds: float, span: str) -> TraceData:
    """Run ``run_units(seconds, span_fn)`` under torch.profiler (CPU and
    CUDA activity); span_fn(name) opens a host span.  Returns the
    window's device timeline and host spans."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(LEAD_IN):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(0.001)
        with record_function(WINDOW):
            units = run_units(seconds, record_function)
            torch.cuda.synchronize()
    window, device, spans = None, [], []
    for e in prof.events():
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            n = e.name
            # a record_function's range on the device (the harness's own
            # spans, the optimizer's) spans work and gaps alike: no work
            if (getattr(e, "is_user_annotation", False) or n == WINDOW
                    or n == span or "spin_kernel" in n):
                continue
            device.append((n, a, b, _kind(n)))
        elif e.name == WINDOW:
            window = (a, b)
        elif e.name == span:
            spans.append((a, b, span))
    if window is None:
        raise RuntimeError("the profiler's trace holds no window span")
    spans.sort()
    return TraceData(window=window, device=device, spans=spans, units=units)
