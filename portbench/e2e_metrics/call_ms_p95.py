"""95th percentile, in ms, of all the window's calls, each timed from the
call to its synchronize."""

from portbench import stats


def read(ctx):
    calls = ctx.window.calls
    if not calls:
        return None
    return stats.percentile([(c.t_done - c.t0) * 1e3 for c in calls], 95.0)
