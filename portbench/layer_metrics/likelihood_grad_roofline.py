"""The grad call's least time (counts.py, from shapes alone) over all the
device-busy time per traced call, %."""

from portbench.layer_metrics._common import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "grad")
