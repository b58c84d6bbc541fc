"""Mean host seconds of a met file read in the window, every stage
(``sim.MetBuffer.reads``: read, preprocess, upload) [s]."""


def read(ctx):
    secs = [sum(float(v) for k, v in r.items()
                if k not in ("file", "route", "wait"))
            for r in ctx.reads]
    return sum(secs) / len(secs) if secs else None
