"""The cycle kernel's share of its bytes bound a render: the feedback
cycle's feed read and its tap written once over 3.35 TB/s, against the
summed device time of its launches."""

from portbench.harness.rooflines import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "cycle_kernel")
