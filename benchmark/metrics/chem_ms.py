"""Device time a step of the chemistry layer: convection, the chemistry
grid, OH and H2O2 chemistry, wet and dry deposition [ms]."""

NAMES = ("convection", "chem_grid", "oh_chem", "h2o2_chem", "wet_depo",
         "dry_depo")


def read(ctx):
    ms = [rec for name in NAMES for rec in ctx.spans.get(name, [])]
    steps = {i for i, _ in ms}
    return sum(v for _, v in ms) / len(steps) if steps else None
