"""What a met swap adds to its step [ms]: the wall time of the step at a
swap (host clock between two synchronizes) less that step's device time
of ``run_timestep`` and of its sort."""


def read(ctx):
    out = []
    for s in ctx.steps:
        if not s["swap"] or s["wall_ms"] is None:
            continue
        step = [v for i, v in ctx.spans.get("step", []) if i == s["i"]]
        sort = [v for i, v in ctx.spans.get("sort", []) if i == s["i"]]
        out.append(s["wall_ms"] - sum(step) - sum(sort))
    return sum(out) / len(out) if out else None
