"""What the readers of a sharded run's spans share (``utils/timers.py``
in the program, through ``program_spans.records``).

In a run over a mesh each step of the program (``Simulation.advance``)
has a ``step`` span on the host thread that hands the step to the cards,
and under it one ``shard`` span a card, recorded on that card's own
thread with the card's index.  The readers take the steps with ``shard``
spans and without a sort or a met swap: the steady steps.  A program
without such spans (one older than the sharded run) reads None.
"""

from __future__ import annotations

from typing import Dict, List, Optional

#: spans that make a step other than a steady one
UNSTEADY = ("sort", "met.read", "met.replicate", "pack.build")


def steady_steps(recs: Optional[List[dict]]) -> set:
    """The step indices with ``shard`` spans and none of ``UNSTEADY``."""
    if not recs:
        return set()
    sharded = {r["step"] for r in recs if r["name"] == "shard"}
    return sharded - {r["step"] for r in recs if r["name"] in UNSTEADY}


def shard_ms_by_card(recs: Optional[List[dict]]) -> Dict[tuple, float]:
    """{(card, thread): the mean device ms (host ms without CUDA events)
    of its ``shard`` spans over the steady steps}."""
    steps = steady_steps(recs)
    by: Dict[tuple, list] = {}
    for r in recs or ():
        if r["name"] == "shard" and r["step"] in steps:
            ms = r["ms"] if r["device_ms"] is None else r["device_ms"]
            by.setdefault((r.get("device"), r["thread"]), []).append(ms)
    return {k: sum(v) / len(v) for k, v in by.items()}


def shard_step_max_ms(recs: Optional[List[dict]]) -> Optional[float]:
    """The slowest card's mean device ms a steady step."""
    by = shard_ms_by_card(recs)
    return max(by.values()) if by else None


def dispatch_ms(recs: Optional[List[dict]]) -> Optional[float]:
    """The mean host ms of the ``step`` span over the steady steps: the
    host's time to hand one step to every card (the step returns once
    every card's thread has launched its share)."""
    steps = steady_steps(recs)
    ms = [r["ms"] for r in recs or () if r["name"] == "step"
          and r["step"] in steps]
    return sum(ms) / len(ms) if ms else None
