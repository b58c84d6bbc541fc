"""Host ms to hand one steady step of a sharded run to every card: the
mean host time of the program's ``step`` span over the steps without a
sort or a met swap (``sharded_spans.py``).  Near ``shard_step_max_ms``
the host sets the pace, or each card's queue of launches is full."""

from benchmark import program_spans, sharded_spans


def read(ctx):
    return sharded_spans.dispatch_ms(program_spans.records())
