"""The share of the traced serving window in which no device operation
ran."""

from perfbench.layer_metrics._common import idle_percent


def read(ctx):
    return idle_percent(ctx, "stream")
