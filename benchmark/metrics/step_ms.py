"""Mean device time of ``pipeline.run_timestep`` over the window's steps
without a sort or a met swap [ms] (CUDA events around the call)."""


def read(ctx):
    plain = {s["i"] for s in ctx.steps if not s["sort"] and not s["swap"]}
    ms = [v for i, v in ctx.spans.get("step", []) if i in plain]
    return sum(ms) / len(ms) if ms else None
