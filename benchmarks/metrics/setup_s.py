"""Seconds from the start of the run to the start of the window: imports,
inputs, kernel builds, the read steps and the warm epoch (and the ranks'
start, where there are ranks)."""


def read(ctx):
    return ctx.setup_s
