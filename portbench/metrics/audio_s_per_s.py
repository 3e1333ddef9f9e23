"""Audio-seconds rendered a second of wall time over the whole window
(host clock; the window ends with a synchronize)."""

from portbench.harness.common import rate


def read(ctx):
    w = ctx.window
    return rate(w["units"], w["audio_s"], w["wall_s"])
