"""Shared CLI plumbing for the tool layer (reference USAGE macro,
mptrac.h and per-tool usage())."""

from __future__ import annotations

import sys
from typing import Sequence


def run_tool(main, argv=None):
    argv = list(sys.argv if argv is None else argv)
    if any(a in ("-h", "--help") for a in argv[1:]):
        doc = sys.modules.get(main.__module__)
        print((doc.__doc__ if doc else None) or main.__doc__ or "")
        return 0
    try:
        return main(argv)
    except UsageError as e:
        print(str(e), file=sys.stderr)
        return 1


class UsageError(SystemExit):
    pass


def require_args(argv: Sequence[str], n: int, usage: str):
    if len(argv) < n:
        raise UsageError(
            "Missing or invalid command-line arguments.\n\n"
            f"Usage: {usage}\n\nUse -h for full help.")


def pop_option(argv, name, default, choices, usage):
    """Take ``name VALUE`` out of ``argv`` (the rest is the reference's
    ``KEY VALUE`` tail, which must keep its pairing)."""
    if name not in argv:
        return default
    i = argv.index(name)
    if i + 1 >= len(argv) or argv[i + 1] not in choices:
        raise UsageError(f"{name} takes one of {', '.join(choices)}.\n\n"
                         f"Usage: {usage}")
    value = argv[i + 1]
    del argv[i:i + 2]
    return value


def pop_device(argv, usage):
    """``--device cuda|cpu`` out of ``argv``: where a tool's tensors live
    (default ``cuda``, which raises without a GPU)."""
    return pop_option(argv, "--device", "cuda", ("cuda", "cpu"), usage)


def host_columns(atm):
    """(time, p, lon, lat, q) of an Atm's live parcels as numpy arrays."""
    n = atm.np

    def h(x):
        return x[:n].detach().cpu().numpy()

    return (h(atm.time), h(atm.p), h(atm.lon), h(atm.lat),
            {k: h(v) for k, v in atm.q.items()})


def host_atm(time, p, lon, lat, q):
    """An Atm on the CPU (float64) from numpy columns, for the writers."""
    import numpy as np
    import torch

    from mptrac_tpu_torch.types import Atm

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float64))

    return Atm(time=t(time), p=t(p), lon=t(lon), lat=t(lat),
               q={k: t(v) for k, v in q.items()}, np=int(np.size(time)))
