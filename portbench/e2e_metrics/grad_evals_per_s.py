"""Rows of value and gradient completed per second of the whole window."""

from portbench import stats


def read(ctx):
    rows = sum(c.rows for c in ctx.window.calls if c.kind == "grad")
    return stats.rate(rows, ctx.window.seconds) if rows else None
