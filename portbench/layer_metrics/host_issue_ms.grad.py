"""Median host time from a grad call's start to its return, before the
synchronize: prior, approximation, autograd and the kernel wrappers."""

from portbench.layer_metrics._common import host_issue_ms


def read(ctx):
    return host_issue_ms(ctx, "grad")
