"""Device time of the program's domain-decomposed step: its ``dd.step``
span (every subdomain's physics and the migration) over the traced
steps without a sort [ms] (``dd_spans.py``)."""

from benchmark import dd_spans, program_spans


def read(ctx):
    return dd_spans.ms_per_step(program_spans.records(), ("dd.step",))
