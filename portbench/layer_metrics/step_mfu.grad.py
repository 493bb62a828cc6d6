"""The operations of the window's grad calls (counts.py) over the window's
time at the card's float32 peak, %: the whole step's share of the peak,
beside the kernels' roofline."""

from portbench.layer_metrics._common import step_mfu


def read(ctx):
    return step_mfu(ctx, "grad")
