"""Device time a step of the turbulent and the mesoscale diffusion, each
with its random draws (``ops/rng.module_rng3``) [ms]."""


def read(ctx):
    ms = ctx.spans.get("diff_turb", []) + ctx.spans.get("diff_meso", [])
    steps = {i for i, _ in ms}
    return sum(v for _, v in ms) / len(steps) if steps else None
