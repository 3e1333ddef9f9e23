"""Seconds from the start of the process to the first timed unit."""


def read(ctx):
    return ctx.setup_s
