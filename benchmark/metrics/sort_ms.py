"""Mean device time of a sort (``ops/sort.module_sort``: key, argsort,
K3) [ms]."""


def read(ctx):
    ms = [v for _, v in ctx.spans.get("sort", [])]
    return sum(ms) / len(ms) if ms else None
