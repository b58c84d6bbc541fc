"""Share of the traced window in which no device activity ran [%]."""


def read(ctx):
    tr = ctx.trace
    if tr is None or tr.window_s <= 0 or tr.busy_s <= 0:
        return None
    return 100.0 * max(tr.window_s - tr.busy_s, 0.0) / tr.window_s
