"""The fits' wall time over their temper steps, ms."""


def read(ctx):
    fits = ctx.window.fits
    steps = sum(f.temper_steps for f in fits)
    if not steps:
        return None
    return 1e3 * sum(f.t_done - f.t0 for f in fits) / steps
