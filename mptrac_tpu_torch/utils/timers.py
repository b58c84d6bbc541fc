"""Wall-clock timer registry.

Rebuild of the reference timer subsystem (SELECT_TIMER / PRINT_TIMERS,
mptrac.h:2240-2282, timer() c:12314-12382): named
timers grouped into categories, accumulating total/min/mean/max/count,
reported at run end.  Counterpart of the JAX package's
``utils/timers.py``.  PyTorch returns from a call before the device has
finished it: a timer that is to include the device's work is given the
device as ``sync`` and waits for it before it stops the clock; the
others time the host only and cost the run no wait.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from typing import Dict, Optional


@dataclass
class _Entry:
    group: str
    total: float = 0.0
    tmin: float = float("inf")
    tmax: float = 0.0
    count: int = 0

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
              sync: Optional[object] = None):
        """Time a block; pass a CUDA ``torch.device`` as ``sync`` to
        wait for the device before stopping the clock (a CPU device
        needs no wait)."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None and sync.type == "cuda":
                import torch
                torch.cuda.synchronize(sync)
            dt = time.perf_counter() - t0
            self._entries.setdefault(name, _Entry(group)).add(dt)

    def add(self, name: str, group: str, dt: float):
        self._entries.setdefault(name, _Entry(group)).add(dt)

    def report(self, log=print):
        groups: Dict[str, float] = {}
        total = 0.0
        for name, e in self._entries.items():
            log(f"TIMER_{name} = {e.total:.3f} s    "
                f"(min= {e.tmin:g} s, mean= {e.total / e.count:g} s, "
                f"max= {e.tmax:g} s, n= {e.count})")
            groups[e.group] = groups.get(e.group, 0.0) + e.total
            total += e.total
        for g, v in groups.items():
            log(f"TIMER_GROUP_{g} = {v:.3f} s")
        log(f"TIMER_TOTAL = {total:.3f} s")

    def as_dict(self):
        return {name: dict(group=e.group, total=e.total, count=e.count,
                           min=e.tmin, max=e.tmax)
                for name, e in self._entries.items()}
