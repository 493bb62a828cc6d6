"""Helpers the per-layer readers share."""

from portbench import counts, stats


def host_issue_ms(ctx, kind):
    """Median host time, in ms, from a call's start to its return, before
    the synchronize, over the window's calls of ``kind``."""
    xs = [(c.t_issue - c.t0) * 1e3 for c in ctx.window.calls if c.kind == kind]
    return stats.median(xs) if xs else None


def cost(ctx, kind):
    """(bytes, operations) of one call of ``kind`` at the cell's shapes."""
    fn = counts.grad_cost if kind == "grad" else counts.forward_cost
    return fn(ctx.batch, ctx.terms, ctx.points)


def roofline_pct(ctx, kind):
    """The call's least time over the device-busy time per traced call, %."""
    tr = ctx.trace
    n = tr.units.get(kind, 0) if tr else 0
    if not n or tr.busy_s <= 0:
        return None
    return 100.0 * counts.least_seconds(*cost(ctx, kind)) / (tr.busy_s / n)


def step_mfu(ctx, kind):
    """Operations of the window's calls of ``kind`` over the window's time at
    the float32 peak, %."""
    n = sum(1 for c in ctx.window.calls if c.kind == kind)
    if not n:
        return None
    ops = cost(ctx, kind)[1] * n
    return 100.0 * ops / (ctx.window.seconds * counts.F32_OPS_S)


def idle_pct(ctx, kind):
    """Share of the traced window with nothing on the card, %."""
    tr = ctx.trace
    if not tr or not tr.units.get(kind) or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
