"""K3 (``permute_cols``: count pass, then the gather or the pack and
rows kernels): the least time its launches in the window could take on
the card's published peaks, over their time in the trace [%]
(``roofline/k3.py``)."""

from benchmark.metrics_common import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "k3")
