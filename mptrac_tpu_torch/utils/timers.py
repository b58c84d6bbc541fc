"""Timers and the tracer of the port.

Rebuild of the reference timer subsystem (SELECT_TIMER / PRINT_TIMERS,
mptrac.h:2240-2282, timer() c:12314-12382): named timers grouped into
categories, accumulating total/min/mean/max/count, reported at run end
(``Timers``).  Counterpart of the JAX package's ``utils/timers.py`` and
of its ``jax.named_scope`` annotations, grown into the port's tracer:

* **Spans.** ``span(name)`` is a context manager and a decorator.  A
  span's record holds its name, its parent (the innermost span open on
  the same thread: every thread keeps its own stack, and a worker thread
  takes the span open where its work was handed out as the parent of its
  own outermost spans, ``adopt``), the step index (that of the latest
  ``advance``), the thread, the card (the index of the CUDA device
  current on the thread, None without CUDA), the host's start and end
  (``time.perf_counter_ns``) and, once CUDA is initialised, a
  ``torch.cuda.Event`` pair on the current stream for the device time.
  Records stay in memory; ``read()`` waits for their events and gives
  each span's host and device ms and its self time (its time less what
  its child spans on its thread cover).  ``span(name, outermost=True)``
  records only where no span of that name is open on the thread.
* **Counters.** ``count(name, n)``; ``counters`` is the dict behind
  ``ops._cuda.launch_counts``: the launches of each kernel, and the
  counters of ``COUNTERS`` (``shards``, ``dd_selected``).  While
  tracing, each ``count`` of a counter of ``COUNTERS`` is also kept
  with the step index it falls in (``tallies()``), and every kernel
  launch of ``ops/_cuda`` is stamped with its device function's name and the
  host's time (``stamp``, ``launch_stamps()``): matched with the
  launches in a ``torch.profiler`` trace, the stamps put the spans on
  the profiler's clock.
* **Switch.** Tracing is on while a ``torch.profiler`` records
  (``torch.autograd.profiler._is_profiler_enabled``, the flag torch
  keeps for fast checks).  ``tracing(True)`` or ``tracing(False)``
  forces it either way, ``tracing(None)`` follows the profiler again.
  Off, a span costs one check: no event, no record, no allocation and
  no synchronize.

The program opens no ``torch.profiler.record_function`` or NVTX range:
a range shows on the device's timeline as an annotation, which a reader
of the trace would take for device work.

``Timers.timer`` times a block on the host clock, which for device work
is the enqueue (PyTorch returns before the device has finished); while
tracing, the block is a span too, and the TIMER table adds its device
time and self time.
"""

from __future__ import annotations

import contextlib
import functools
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch
from torch.autograd import profiler as _profiler

#: None: trace while a profiler records; True / False: forced
_force: Optional[bool] = None
#: whether any span was ever opened (until then a span's exit is one
#: check too)
_opened = False
#: index of the latest step span (``span(..., step=True)``)
_step = -1
#: every span recorded since the last ``reset``, oldest first
_records: list = []
#: (device function, host ns) of every launch stamped while tracing
_stamps: list = []
#: (counter, n, step index) of every ``count`` of ``COUNTERS`` while
#: tracing
_tallies: list = []
#: the counters that count no kernel launch: ``shards``, the shard steps
#: of the sharded step (``parallel.mesh.ShardedStep``, one a device a
#: step); ``dd_selected``, the parcels that a domain-decomposed step's
#: migration gathered with the permute kernel (``parallel.dd``)
COUNTERS = ("shards", "dd_selected")
#: counters by name (``count``); ``ops._cuda.launch_counts`` is this dict:
#: a launch count a device function, and ``COUNTERS``
counters: Dict[str, int] = dict.fromkeys(COUNTERS, 0)
_count_lock = threading.Lock()
_tls = threading.local()


def tracing(on: Optional[bool]) -> Optional[bool]:
    """Force tracing on (True) or off (False), or let it follow the
    profiler again (None); returns the setting it replaces."""
    global _force
    prev, _force = _force, on
    return prev


def enabled() -> bool:
    """Whether spans are recorded now."""
    return _profiler._is_profiler_enabled if _force is None else _force


class _Record:
    __slots__ = ("span", "name", "parent", "step", "thread", "device", "t0",
                 "t1", "e0", "e1")


def _card() -> Optional[int]:
    """The index of the CUDA device current on this thread, None before
    CUDA is initialised."""
    return torch.cuda.current_device() if torch.cuda.is_initialized() \
        else None


def _event():
    if not torch.cuda.is_initialized():
        return None
    e = torch.cuda.Event(enable_timing=True)
    e.record()
    return e


class _Span:
    """One span name: entered as a context manager (``__enter__``
    returns the open record, None while not tracing) or applied as a
    decorator.  Shared by every use of the name; what a use opens lives
    on its thread's stack."""

    __slots__ = ("name", "outermost", "step")

    def __init__(self, name: str, outermost: bool, step: bool):
        self.name, self.outermost, self.step = name, outermost, step

    def __enter__(self):
        if not (_profiler._is_profiler_enabled if _force is None
                else _force):
            return None
        return self._open()

    def __exit__(self, *exc):
        if not _opened:
            return False
        stack = getattr(_tls, "stack", None)
        if stack:
            top = stack[-1]
            if top is self:                  # a suppressed inner use
                stack.pop()
            elif type(top) is _Record and top.span is self:
                stack.pop()
                top.t1 = time.perf_counter_ns()
                if top.e0 is not None:
                    top.e1 = _event()
        return False

    def _open(self):
        global _opened, _step
        _opened = True
        stack = getattr(_tls, "stack", None)
        if stack is None:
            stack = _tls.stack = []
        for r in reversed(stack):
            if type(r) is _Record:
                parent = r
                break
        else:
            parent = getattr(_tls, "base", None)
        if self.outermost and any(
                r is self or (type(r) is _Record and r.span is self)
                for r in stack):
            stack.append(self)
            return None
        if self.step:
            _step += 1
        rec = _Record()
        rec.span, rec.name, rec.parent = self, self.name, parent
        rec.step, rec.thread = _step, threading.get_ident()
        rec.device = _card()
        rec.t1 = rec.e1 = None
        rec.e0 = _event()
        rec.t0 = time.perf_counter_ns()
        stack.append(rec)
        _records.append(rec)
        return rec

    def __call__(self, fn):
        span = self

        @functools.wraps(fn)
        def traced(*args, **kw):
            if not (_profiler._is_profiler_enabled if _force is None
                    else _force):
                return fn(*args, **kw)
            with span:
                return fn(*args, **kw)
        return traced


_SPANS: Dict[str, _Span] = {}


def span(name: str, outermost: bool = False, step: bool = False) -> _Span:
    """The span ``name`` (one object a name: the options of its first
    use hold).  ``outermost``: record only where no span of this name is
    open on the thread.  ``step``: each use starts a new step index."""
    s = _SPANS.get(name)
    if s is None:
        s = _SPANS[name] = _Span(name, outermost, step)
    return s


def innermost():
    """The innermost span open on this thread (its record; None while
    not tracing), to hand to ``adopt`` on another thread."""
    for r in reversed(getattr(_tls, "stack", None) or ()):
        if type(r) is _Record:
            return r
    return getattr(_tls, "base", None)


@contextlib.contextmanager
def adopt(parent):
    """Within the block, spans opened on this thread where none of its
    own is open take ``parent`` (a record from ``innermost`` on the
    thread that handed out the work, or None) as their parent."""
    prev = getattr(_tls, "base", None)
    _tls.base = parent
    try:
        yield
    finally:
        _tls.base = prev


@contextlib.contextmanager
def stage(name: str, timings: Optional[Dict[str, float]] = None,
          key: Optional[str] = None, sync=None):
    """The span ``name``; with ``timings`` (a dict) its host seconds are
    also added to ``timings[key or name]``, after a synchronize of
    ``sync`` where that is a CUDA device, so that the seconds are the
    stage's own (only when ``timings`` is given)."""
    t0 = time.perf_counter()
    with span(name):
        yield
        if (timings is not None and sync is not None
                and torch.device(sync).type == "cuda"):
            torch.cuda.synchronize(sync)
    if timings is not None:
        k = key or name
        timings[k] = timings.get(k, 0.0) + time.perf_counter() - t0


def count(name: str, n: int = 1) -> None:
    with _count_lock:        # the shards' worker threads count too
        counters[name] = counters.get(name, 0) + n
        if name in COUNTERS and (_profiler._is_profiler_enabled
                                 if _force is None else _force):
            _tallies.append((name, n, _step))


def tallies() -> List[dict]:
    """Every ``count`` of a counter of ``COUNTERS`` made while tracing
    since the last ``reset``, oldest first: ``name``, ``n`` and ``step``
    (the step index it fell in)."""
    return [dict(name=k, n=n, step=s) for k, n, s in _tallies]


def stamp(kernel: str) -> None:
    """While tracing: note that device function ``kernel`` is launched
    now (call it just before the launch)."""
    if _profiler._is_profiler_enabled if _force is None else _force:
        _stamps.append((kernel, time.perf_counter_ns()))


def launch_stamps() -> List[tuple]:
    """(device function, host ns) of every launch stamped since the last
    ``reset``, in launch order."""
    return list(_stamps)


def reset() -> None:
    """Drop every record, stamp and tally (the counters stay)."""
    global _step
    del _records[:]
    del _stamps[:]
    del _tallies[:]
    _step = -1


def _ms(a, b) -> Optional[float]:
    if a is None or b is None:
        return None
    b.synchronize()
    return a.elapsed_time(b)


def _times(recs) -> Dict[int, dict]:
    """{id(record): times} of the closed records among ``recs``: host
    and device ms, and self ms (less the closed child spans on its own
    thread among the records kept since the last ``reset``: children on
    other threads run beside it)."""
    pool = {id(r): r for r in _records if r.t1 is not None}
    pool.update((id(r), r) for r in recs if r.t1 is not None)
    base = {rid: {"ms": 1e-6 * (r.t1 - r.t0),
                  "device_ms": _ms(r.e0, r.e1)}
            for rid, r in pool.items()}
    child_ms: Dict[int, float] = {}
    child_dev: Dict[int, float] = {}
    for rid, r in pool.items():
        if r.parent is None or r.parent.thread != r.thread:
            continue
        t, pid = base[rid], id(r.parent)
        child_ms[pid] = child_ms.get(pid, 0.0) + t["ms"]
        if t["device_ms"] is not None:
            child_dev[pid] = child_dev.get(pid, 0.0) + t["device_ms"]
    out = {}
    for r in recs:
        rid = id(r)
        if rid not in base:
            continue
        t = dict(base[rid], self_ms=base[rid]["ms"] - child_ms.get(rid, 0.0))
        t["self_device_ms"] = (None if t["device_ms"] is None
                               else t["device_ms"] - child_dev.get(rid, 0.0))
        out[rid] = t
    return out


def read() -> List[dict]:
    """Every closed span since the last ``reset``, oldest first: ``name``,
    ``parent`` (index into this list, None for a root), ``step``,
    ``thread``, ``device`` (the card's index, None without CUDA),
    ``t0_ns`` and ``t1_ns`` (host), ``ms`` (host), ``device_ms`` (None
    without CUDA events), ``self_ms`` and ``self_device_ms`` (less what
    the child spans on its thread cover).  Waits for the spans' events:
    call it after the run."""
    recs = [r for r in _records if r.t1 is not None]
    times = _times(recs)
    index = {id(r): i for i, r in enumerate(recs)}
    return [dict(name=r.name,
                 parent=None if r.parent is None else index.get(
                     id(r.parent)),
                 step=r.step, thread=r.thread, device=r.device,
                 t0_ns=r.t0, t1_ns=r.t1,
                 **times[id(r)])
            for r in recs]


@dataclass
class _Entry:
    group: str
    total: float = 0.0
    tmin: float = float("inf")
    tmax: float = 0.0
    count: int = 0
    spans: list = field(default_factory=list)

    def add(self, dt: float):
        self.total += dt
        self.tmin = min(self.tmin, dt)
        self.tmax = max(self.tmax, dt)
        self.count += 1


class Timers:
    def __init__(self):
        self._entries: Dict[str, _Entry] = {}

    @contextlib.contextmanager
    def timer(self, name: str, group: str = "DEFAULT",
              span_name: Optional[str] = None):
        """Time a block on the host clock; while tracing, the block is
        also the span ``span_name`` (default ``name``), whose device and
        self time the table adds."""
        t0 = time.perf_counter()
        with span(span_name or name) as rec:
            try:
                yield
            finally:
                entry = self._entries.setdefault(name, _Entry(group))
                entry.add(time.perf_counter() - t0)
                if rec is not None:
                    entry.spans.append(rec)

    def add(self, name: str, group: str, dt: float):
        self._entries.setdefault(name, _Entry(group)).add(dt)

    def _traced(self) -> Dict[str, dict]:
        """{timer: {"device": s, "self": s}} of the timers that ran while
        tracing: device seconds (where CUDA events were recorded) and
        self seconds (less the child spans; on the device where it can
        be)."""
        out = {}
        for name, e in self._entries.items():
            if not e.spans:
                continue
            times = list(_times(e.spans).values())
            on_dev = all(t["device_ms"] is not None for t in times)
            key = "device_ms" if on_dev else "ms"
            out[name] = {"self": 1e-3 * sum(t["self_" + key] for t in times)}
            if on_dev:
                out[name]["device"] = 1e-3 * sum(t[key] for t in times)
        return out

    def report(self, log=print):
        groups: Dict[str, float] = {}
        total = 0.0
        traced = self._traced()
        for name, e in self._entries.items():
            extra = ""
            if name in traced:
                tr = traced[name]
                dev = (f"device= {tr['device']:g} s, " if "device" in tr
                       else "")
                extra = (f"    (traced: {dev}self= {tr['self']:g} s, "
                         f"n= {len(e.spans)})")
            log(f"TIMER_{name} = {e.total:.3f} s    "
                f"(min= {e.tmin:g} s, mean= {e.total / e.count:g} s, "
                f"max= {e.tmax:g} s, n= {e.count}){extra}")
            groups[e.group] = groups.get(e.group, 0.0) + e.total
            total += e.total
        for g, v in groups.items():
            log(f"TIMER_GROUP_{g} = {v:.3f} s")
        log(f"TIMER_TOTAL = {total:.3f} s")

    def as_dict(self):
        traced = self._traced()
        return {name: dict(group=e.group, total=e.total, count=e.count,
                           min=e.tmin, max=e.tmax, **traced.get(name, {}))
                for name, e in self._entries.items()}
