"""Share of the traced device idle time that falls inside the program's
``met.read`` spans (a met file's read, preprocessing and upload), the
idle gaps put on the host's clock by the program's launch stamps [%]
(``program_spans.py``)."""

from benchmark import program_spans


def read(ctx):
    if ctx.trace is None:
        return None
    return program_spans.idle_in_read_pct(
        ctx.trace.events, program_spans.records(), program_spans.stamps())
