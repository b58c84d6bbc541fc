"""Device time a step of every subdomain's physics on its tile: the sum
of the program's ``dd.physics`` spans, over the traced steps without a
sort [ms] (``dd_spans.py``)."""

from benchmark import dd_spans, program_spans


def read(ctx):
    return dd_spans.ms_per_step(program_spans.records(), ("dd.physics",))
