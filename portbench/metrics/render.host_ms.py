"""Median host wall time of one CompiledGraph.render call until it
returns, unsynced (the harness's span around it), over the window, ms."""

from portbench.harness.common import percentile


def read(ctx):
    return 1e3 * percentile(ctx.window["host_s"], 50)
