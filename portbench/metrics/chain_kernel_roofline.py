"""The chain kernel's share of its bytes bound a render: the chain
segments' signals read and written once over 3.35 TB/s, against the
summed device time of its launches."""

from portbench.harness.rooflines import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "chain_kernel")
