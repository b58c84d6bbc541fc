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
