"""Share of the traced window of sweep calls with no operation on the card, %."""

from portbench.layer_metrics._common import idle_pct


def read(ctx):
    return idle_pct(ctx, "sweep")
