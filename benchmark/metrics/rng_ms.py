"""Device time a step of the program's random draws: its outermost
``rng`` spans (``ops/rng.module_rng3`` and ``module_rng``, whichever
module calls them) inside the step [ms] (``program_spans.py``)."""

from benchmark import program_spans


def read(ctx):
    return program_spans.ms_per_step(program_spans.records(), "rng")
