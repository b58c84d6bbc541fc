"""Device ms a steady step of the slowest card in a sharded run: for each
card the mean device time of its ``shard`` spans (the program's step of
its parcels) over the steps without a sort or a met swap, and the
largest of those means (``sharded_spans.py``)."""

from benchmark import program_spans, sharded_spans


def read(ctx):
    return sharded_spans.shard_step_max_ms(program_spans.records())
