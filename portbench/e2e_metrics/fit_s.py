"""All the window's seconds per fit completed: fits start while the window
is open, and the last one runs to its end and is counted."""

from portbench import stats


def read(ctx):
    fits = ctx.window.fits
    return stats.per_item(ctx.window.seconds, len(fits)) if fits else None
