"""K3's selections in the domain-decomposed step's migration: the least
time the traced steps' selections could take on the card's published
bandwidth (``roofline/k3_dd.py``), over the device time of the
``gather_kernel`` launches made inside the program's migration spans
[%] (``dd_spans.migration_gather_s``)."""

from benchmark import dd_spans, program_spans


def read(ctx):
    if ctx.trace is None:
        return None
    busy = dd_spans.migration_gather_s(ctx.trace.events,
                                       program_spans.records(),
                                       program_spans.stamps())
    if busy is None or not dd_spans.selected(dd_spans.tallies()):
        return None
    return 100.0 * ctx.roofline("k3_dd").bound_s(ctx, {}) / busy
