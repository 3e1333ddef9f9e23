"""Window wall time over the training steps completed in it, ms (host
clock; the window ends with a synchronize)."""


def read(ctx):
    w = ctx.window
    return 1e3 * w["wall_s"] / w["units"]
