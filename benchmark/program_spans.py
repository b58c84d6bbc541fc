"""What the readers of the program's own spans share.

The program (``mptrac_tpu_torch.utils.timers``) records spans while a
``torch.profiler`` records, so in a ``--trace 1`` run its records cover
the traced periods of the window.  Each record has a name, a parent, a
step index, a thread, the host's start and end (``perf_counter_ns``) and
the device ms of a CUDA event pair (host ms on the CPU).  While tracing,
the program also stamps each launch of its own kernels with the host's
time: matched with the same launches in the trace, the stamps put the
spans on the profiler's clock.

A checkout whose program has no such records (one older than its
tracer) reads None here, and raises nothing.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from benchmark.tracing import busy_and_gaps, kernel_match


def _tracer():
    try:
        from mptrac_tpu_torch.utils import timers
    except ImportError:
        return None
    if not all(hasattr(timers, a) for a in ("read", "launch_stamps")):
        return None
    return timers


def records() -> Optional[List[dict]]:
    """The program's spans (``timers.read()``), None where it has none."""
    timers = _tracer()
    recs = timers.read() if timers is not None else None
    return recs or None


def stamps() -> Optional[List[tuple]]:
    """(device function, host ns) of the program's stamped launches."""
    timers = _tracer()
    return timers.launch_stamps() if timers is not None else None


def _ms(r: dict) -> float:
    return r["ms"] if r["device_ms"] is None else r["device_ms"]


def ancestors(recs: List[dict], r: dict):
    while r["parent"] is not None:
        r = recs[r["parent"]]
        yield r


def ms_per_step(recs: Optional[List[dict]], name: str) -> Optional[float]:
    """Device ms a traced step (host ms where no event was recorded) of
    the outermost spans ``name`` inside the step span (``step``, which is
    ``pipeline.run_timestep``), over the steps that have a step span."""
    if not recs:
        return None
    steps = {r["step"] for r in recs if r["name"] == "step"}
    if not steps:
        return None
    total = 0.0
    for r in recs:
        if r["name"] != name or r["step"] not in steps:
            continue
        up = [a["name"] for a in ancestors(recs, r)]
        if "step" in up and name not in up:
            total += _ms(r)
    return total / len(steps)


def clock_offset_us(events: List[tuple], stamped: List[tuple]
                    ) -> Optional[float]:
    """Trace time less host time [us]: the least gap between a launch's
    start on the device (profiler clock, us) and its stamp (host clock,
    ns), matching the i-th stamp of each kernel with the i-th launch of
    that kernel in the trace (queueing only adds to a gap, so the least
    is the launch latency, a few us).  None where the counts of any
    stamped kernel differ, or nothing was stamped."""
    by_kernel: Dict[str, List[int]] = {}
    for kernel, t_ns in stamped:
        by_kernel.setdefault(kernel, []).append(t_ns)
    if not by_kernel:
        return None
    best = None
    for kernel, host in by_kernel.items():
        dev = sorted(a for name, a, _ in events
                     if kernel in name and kernel_match(name, kernel))
        if len(dev) != len(host):
            return None
        for a, t_ns in zip(dev, sorted(host)):
            gap = a - 1e-3 * t_ns
            best = gap if best is None else min(best, gap)
    return best


def _segments(recs: List[dict]) -> List[tuple]:
    """(start us, end us, record index) of the innermost span open on the
    host (the threads that ran ``advance``, else every thread), in time
    order: the spans of one thread nest."""
    threads = {r["thread"] for r in recs if r["name"] == "advance"}
    marks = []
    for i, r in enumerate(recs):
        if threads and r["thread"] not in threads:
            continue
        a, b = 1e-3 * r["t0_ns"], 1e-3 * r["t1_ns"]
        if b > a:
            marks.append((a, 1, -b, i))
            marks.append((b, 0, 0.0, i))
    marks.sort()
    out, stack, t_prev = [], [], None
    for t, kind, _, i in marks:
        if stack and t_prev is not None and t > t_prev:
            out.append((t_prev, t, stack[-1]))
        if kind == 1:
            stack.append(i)
        elif i in stack:
            stack.remove(i)
        t_prev = t
    return out


def idle_by_span(events: List[tuple], recs: List[dict],
                 stamped: List[tuple]) -> Optional[Dict[str, float]]:
    """Seconds of the trace's device idle time (``busy_and_gaps`` over the
    events' span) by the innermost program span open on the host at that
    time (``"none"`` outside every span), each gap moved onto the host's
    clock by ``clock_offset_us``; every key of a span with a ``met.read``
    above it, or ``met.read`` itself, is prefixed ``"met.read/"``.  None
    without events, records or matching launch counts."""
    if not events or not recs:
        return None
    off = clock_offset_us(events, stamped or [])
    if off is None:
        return None
    t0 = min(a for _, a, _ in events)
    t1 = max(b for _, _, b in events)
    _, gaps = busy_and_gaps(events, t0, t1)
    segs = _segments(recs)
    labels = {}

    def label(i):
        if i not in labels:
            r = recs[i]
            names = [r["name"]] + [a["name"] for a in ancestors(recs, r)]
            labels[i] = ("met.read/" if "met.read" in names else "") + (
                r["name"])
        return labels[i]

    out: Dict[str, float] = {}
    k = 0
    for ga, gb in sorted(gaps):
        a, b = ga - off, gb - off
        covered = 0.0
        while k < len(segs) and segs[k][1] <= a:
            k += 1
        j = k
        while j < len(segs) and segs[j][0] < b:
            lo, hi = max(a, segs[j][0]), min(b, segs[j][1])
            if hi > lo:
                key = label(segs[j][2])
                out[key] = out.get(key, 0.0) + 1e-6 * (hi - lo)
                covered += hi - lo
            j += 1
        if b - a > covered:
            out["none"] = out.get("none", 0.0) + 1e-6 * (b - a - covered)
    return out


def idle_in_read_pct(events, recs, stamped) -> Optional[float]:
    """100 x the share of the trace's device idle time that falls inside
    ``met.read`` spans (``idle_by_span``)."""
    by = idle_by_span(events, recs, stamped)
    if not by:
        return None
    total = sum(by.values())
    if total <= 0:
        return None
    return 100.0 * sum(v for k, v in by.items()
                       if k.startswith("met.read/")) / total
