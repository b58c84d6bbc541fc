"""K1 (``rk_fused_advect``): the least time its launches in the window
could take on the card's published peaks, over their time in the trace
[%] (``roofline/k1.py``)."""

from benchmark.metrics_common import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "k1")
