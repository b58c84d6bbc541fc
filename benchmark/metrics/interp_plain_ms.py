"""Device time a step of the program's plain interpolation: its
outermost ``interp`` spans (the locate and interpolation functions of
``ops/interp``, whichever module calls them) inside the step [ms]
(``program_spans.py``)."""

from benchmark import program_spans


def read(ctx):
    return program_spans.ms_per_step(program_spans.records(), "interp")
