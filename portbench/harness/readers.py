"""Reductions that several metric readers share."""

from __future__ import annotations


def idle_pct(ctx):
    """100 (1 - device busy / window) over the traced window."""
    tr = ctx.trace
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)


def kernels_per_unit(ctx):
    """Device kernels in the traced window over the units run in it."""
    tr = ctx.trace
    if tr is None or tr.units == 0:
        return None
    return len(tr.kernels()) / tr.units
