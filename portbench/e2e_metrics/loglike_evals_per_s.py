"""Rows of likelihood (no gradient) completed per second of the whole window."""

from portbench import stats


def read(ctx):
    rows = sum(c.rows for c in ctx.window.calls if c.kind == "sweep")
    return stats.rate(rows, ctx.window.seconds) if rows else None
