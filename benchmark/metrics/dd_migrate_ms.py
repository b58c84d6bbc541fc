"""Device time a step of the parcel migration: the program's
``dd.migrate`` (owner search, movers, send buffers, stayers),
``dd.exchange`` and ``dd.receive`` spans summed, over the traced steps
without a sort [ms] (``dd_spans.py``)."""

from benchmark import dd_spans, program_spans


def read(ctx):
    return dd_spans.ms_per_step(program_spans.records(),
                                ("dd.migrate", "dd.exchange", "dd.receive"))
