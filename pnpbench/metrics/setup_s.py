"""Seconds from the process's start to the window's first request: imports,
the kernels' build or load, weights, masks and the scene pool, the warm-up
requests."""


def read(ctx):
    return ctx.setup_s
