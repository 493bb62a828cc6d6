"""Seconds from the process's start to the window's start: imports, the
kernels' build where it is not cached, the model, the inputs and the
warm-up."""


def read(ctx):
    return ctx.setup_s
