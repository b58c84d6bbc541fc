"""What the readers of a domain-decomposed run share: the program's own
spans and counters (``utils/timers.py``, through
``program_spans.records``, ``program_spans.stamps`` and the tracer's
``tallies``).

In a run with ``DD 1`` each step of the program (``Simulation.advance``)
holds one ``dd.step`` span (the decomposed step) and under it, a
subdomain each, ``dd.physics`` (its physics on its tile) and
``dd.migrate`` (its owner search, movers, send buffers and stayers),
then one ``dd.exchange`` and a ``dd.receive`` a subdomain (the received
parcels appended).  The counter ``dd_selected`` counts, a step, the
parcels that the migration's selections gathered with the permute
kernel.  The readers take the steps with a ``dd.step`` span and without
a sort: the steady steps.  A program without such spans (one older than
the decomposed run) reads None.
"""

from __future__ import annotations

from typing import List, Optional

from benchmark.tracing import kernel_match

#: the spans of the migration: the selections of the permute kernel run
#: inside them
MIGRATION = ("dd.migrate", "dd.receive")


def tallies() -> Optional[List[dict]]:
    """The program's counts made while tracing (``timers.tallies()``),
    None where it keeps none."""
    try:
        from mptrac_tpu_torch.utils import timers
    except ImportError:
        return None
    read = getattr(timers, "tallies", None)
    return read() if read is not None else None


def steady_steps(recs: Optional[List[dict]]) -> set:
    """The step indices with a ``dd.step`` span and no ``sort``."""
    if not recs:
        return set()
    dd = {r["step"] for r in recs if r["name"] == "dd.step"}
    return dd - {r["step"] for r in recs if r["name"] == "sort"}


def _ms(r: dict) -> float:
    return r["ms"] if r["device_ms"] is None else r["device_ms"]


def ms_per_step(recs: Optional[List[dict]], names) -> Optional[float]:
    """Device ms (host ms without CUDA events) of the spans ``names``,
    summed over a steady step and averaged over the steady steps."""
    steps = steady_steps(recs)
    if not steps:
        return None
    total = sum(_ms(r) for r in recs
                if r["name"] in names and r["step"] in steps)
    return total / len(steps)


def migration_gather_s(events: List[tuple], recs: Optional[List[dict]],
                       stamped: Optional[List[tuple]],
                       kernel: str = "gather_kernel") -> Optional[float]:
    """Seconds of the trace's ``kernel`` launches that the program
    launched inside its migration spans: the i-th stamp of the kernel is
    the i-th launch of it in the trace, and a stamp (the host's time just
    before the launch) inside a ``dd.migrate`` or ``dd.receive`` span
    marks a launch of the migration.  None where the counts differ or
    nothing matched."""
    if not events or not recs or not stamped:
        return None
    host = sorted(t for k, t in stamped if k == kernel)
    dev = sorted((a, b) for name, a, b in events
                 if kernel in name and kernel_match(name, kernel))
    if not host or len(host) != len(dev):
        return None
    spans = sorted((r["t0_ns"], r["t1_ns"]) for r in recs
                   if r["name"] in MIGRATION)
    busy, j = 0.0, 0
    for t_ns, (a, b) in zip(host, dev):
        while j < len(spans) and spans[j][1] < t_ns:
            j += 1
        if j < len(spans) and spans[j][0] <= t_ns:
            busy += (b - a) * 1e-6
    return busy if busy > 0 else None


def selected(counts: Optional[List[dict]]) -> Optional[int]:
    """The parcels that the traced steps' migrations gathered."""
    if not counts:
        return None
    n = [c["n"] for c in counts if c["name"] == "dd_selected"]
    return sum(n) if n else None
