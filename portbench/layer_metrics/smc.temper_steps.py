"""Mean temper steps a fit: the SMC's iterations to reach the posterior."""


def read(ctx):
    fits = ctx.window.fits
    return sum(f.temper_steps for f in fits) / len(fits) if fits else None
