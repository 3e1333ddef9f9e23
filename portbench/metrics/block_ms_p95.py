"""The 95th percentile of every process() call's wall time in the
window, ms (host clock)."""

from portbench.harness.common import percentile


def read(ctx):
    return 1e3 * percentile(ctx.window["block_s"], 95)
