"""Spans and the device trace of a ``--trace 1`` run.

Spans are CUDA events recorded around calls into the program's modules,
from the benchmark's own code: each wrapped function is replaced for the
run by one that records an event pair around the original call (the
pattern of ``chip_smoke.profile_steps``), tagged with the step it falls
in.  The program itself is not edited.  The device's busy time, the
kernels' times and the idle gaps come from ``torch.profiler`` over the
window's first periods (``harness.TRACE_S``).
"""

from __future__ import annotations

import re
import time
from contextlib import contextmanager
from typing import Dict, List, Optional

import torch

#: (module path, function name, span name): the calls timed in a traced
#: run.  ``pipeline.run_timestep`` is the step; the others are its
#: modules, and ``sim.module_sort`` the sort of the run loop.
SPANS = (
    ("mptrac_tpu_torch.physics.pipeline", "run_timestep", "step"),
    ("mptrac_tpu_torch.physics.diffusion", "module_diff_turb", "diff_turb"),
    ("mptrac_tpu_torch.physics.diffusion", "module_diff_meso", "diff_meso"),
    ("mptrac_tpu_torch.physics.diffusion", "module_rng3", "rng3"),
    ("mptrac_tpu_torch.physics.advect", "module_advect_fused", "advect"),
    ("mptrac_tpu_torch.physics.convection", "module_convection",
     "convection"),
    ("mptrac_tpu_torch.physics.chem", "module_chem_grid", "chem_grid"),
    ("mptrac_tpu_torch.physics.chem", "module_oh_chem", "oh_chem"),
    ("mptrac_tpu_torch.physics.chem", "module_h2o2_chem", "h2o2_chem"),
    ("mptrac_tpu_torch.physics.depo", "module_wet_depo", "wet_depo"),
    ("mptrac_tpu_torch.physics.depo", "module_dry_depo", "dry_depo"),
)


class Spans:
    """Event pairs by span name: ``records[name]`` is a list of
    (step index, start event, end event)."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.records: Dict[str, list] = {}
        self.step_index = -1
        self._patched: list = []

    def _mark(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    @contextmanager
    def span(self, name: str):
        a = self._mark()
        try:
            yield
        finally:
            self.records.setdefault(name, []).append(
                (self.step_index, a, self._mark()))

    def wrap(self, module, attr: str, name: str):
        orig = getattr(module, attr)

        def timed(*args, **kw):
            with self.span(name):
                return orig(*args, **kw)

        setattr(module, attr, timed)
        self._patched.append((module, attr, orig))

    def wrap_all(self):
        import importlib
        for mod_name, attr, name in SPANS:
            self.wrap(importlib.import_module(mod_name), attr, name)

    def restore(self):
        for module, attr, orig in reversed(self._patched):
            setattr(module, attr, orig)
        self._patched.clear()

    def ms(self) -> Dict[str, List[tuple]]:
        """{name: [(step index, ms), ...]} (after a synchronize)."""
        out = {}
        for name, recs in self.records.items():
            if self.cuda:
                out[name] = [(i, a.elapsed_time(b)) for i, a, b in recs]
            else:
                out[name] = [(i, 1e3 * (b - a)) for i, a, b in recs]
        return out


#: (module path, function name): the host stages of a met file read
#: (``met/build.read_met``) timed in every run of a file cell
READ_STAGES = (
    ("mptrac_tpu_torch.met.read_nc", "read_met_nc"),
    ("mptrac_tpu_torch.met.process", "extrapolate"),
    ("mptrac_tpu_torch.met.process", "polar_winds"),
    ("mptrac_tpu_torch.met.process", "periodic"),
    ("mptrac_tpu_torch.met.process", "sample_grid"),
    ("mptrac_tpu_torch.met.process", "geopot"),
    ("mptrac_tpu_torch.met.process", "pv"),
    ("mptrac_tpu_torch.met.process", "pbl"),
    ("mptrac_tpu_torch.met.process", "tropopause"),
    ("mptrac_tpu_torch.met.process", "cloud"),
    ("mptrac_tpu_torch.met.cape", "compute_cape"),
    ("mptrac_tpu_torch.met.process", "ozone_column"),
    ("mptrac_tpu_torch.met.process", "detrend"),
)


def _host_counters() -> Dict[str, float]:
    """The process's CPU seconds, its involuntary context switches and
    page faults, and the machine's stolen CPU seconds (``/proc/stat``:
    time a virtual machine's CPUs waited for the host)."""
    import os
    import resource
    ru = resource.getrusage(resource.RUSAGE_SELF)
    out = {"cpu_s": ru.ru_utime + ru.ru_stime,
           "nivcsw": float(ru.ru_nivcsw), "minflt": float(ru.ru_minflt)}
    try:
        with open("/proc/stat") as f:
            cpu = f.readline().split()
        out["steal_s"] = float(cpu[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, IndexError, ValueError):
        pass
    return out


class ReadStages:
    """Host wall seconds of each stage of every met file read, with the
    process's CPU seconds, context switches and page faults and the
    machine's stolen CPU seconds over the read: one dict a read, in
    ``reads``.  Wraps ``sim.read_met`` and the stages named in
    ``READ_STAGES`` for the run (the program is not edited)."""

    def __init__(self):
        self.reads: List[Dict[str, float]] = []
        self._cur: Optional[Dict[str, float]] = None
        self._patched: list = []

    def _wrap(self, module, attr, fn):
        orig = getattr(module, attr)
        setattr(module, attr, fn(orig))
        self._patched.append((module, attr, orig))

    def wrap_all(self):
        import importlib

        def stage(name):
            def make(orig):
                def timed(*args, **kw):
                    t0 = time.perf_counter()
                    try:
                        return orig(*args, **kw)
                    finally:
                        if self._cur is not None:
                            self._cur[name] = self._cur.get(name, 0.0) + (
                                time.perf_counter() - t0)
                return timed
            return make

        def whole(orig):
            def timed(*args, **kw):
                c0, t0 = _host_counters(), time.perf_counter()
                self._cur = {}
                try:
                    return orig(*args, **kw)
                finally:
                    rec = {"wall_s": time.perf_counter() - t0}
                    c1 = _host_counters()
                    rec.update({k: c1[k] - c0[k] for k in c1 if k in c0})
                    rec.update(self._cur)
                    self.reads.append(rec)
                    self._cur = None
            return timed

        for mod_name, attr in READ_STAGES:
            self._wrap(importlib.import_module(mod_name), attr, stage(attr))
        self._wrap(importlib.import_module("mptrac_tpu_torch.sim"),
                   "read_met", whole)

    def restore(self):
        for module, attr, orig in reversed(self._patched):
            setattr(module, attr, orig)
        self._patched.clear()


def card_info() -> dict:
    """Name, power limit and SM clock of card 0 from ``nvidia-smi``
    (empty where it cannot be read)."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader", "-i", "0"], capture_output=True,
            text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return {}
    parts = [s.strip() for s in out.split(",")]
    return dict(zip(("name", "power_limit", "max_sm_clock"), parts))


# ------------------------------------------------------------- profiler

def start_profiler():
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.__enter__()
    return prof


def stop_profiler(prof) -> None:
    prof.__exit__(None, None, None)


def device_events(prof) -> List[tuple]:
    """(name, start us, end us) of every device activity (kernels,
    copies, fills) in the profile."""
    out = []
    for e in prof.events():
        dev = getattr(e, "device_type", None)
        # (a host range of record_function also shows on the device's
        # timeline as an annotation, not as work)
        if (dev is None or "CUDA" not in str(dev)
                or e.name.startswith("bench:")):
            continue
        tr = e.time_range
        out.append((e.name, float(tr.start), float(tr.end)))
    return out


def host_labels(prof, prefix: str = "bench:") -> List[tuple]:
    """(label, start us, end us) of the benchmark's own host ranges
    (``torch.profiler.record_function`` named ``bench:<label>``)."""
    out = []
    for e in prof.events():
        if (e.name.startswith(prefix)
                and "CUDA" not in str(getattr(e, "device_type", ""))):
            out.append((e.name[len(prefix):], float(e.time_range.start),
                        float(e.time_range.end)))
    return out


def busy_and_gaps(events: List[tuple], t0: float, t1: float):
    """(busy us, [(gap start, gap end)]) of the device between t0 and
    t1: the union of the activities' intervals, and the idle gaps."""
    iv = sorted((max(a, t0), min(b, t1)) for _, a, b in events
                if b > t0 and a < t1)
    busy = 0.0
    gaps = []
    cur_a = cur_b = None
    last_end = t0
    for a, b in iv:
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                busy += cur_b - cur_a
                last_end = cur_b
            if a > last_end:
                gaps.append((last_end, a))
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        busy += cur_b - cur_a
        last_end = cur_b
    if t1 > last_end:
        gaps.append((last_end, t1))
    return busy, gaps


def label_at(labels: List[tuple], when: float) -> str:
    """The innermost benchmark label whose host range holds ``when``."""
    best: Optional[tuple] = None
    for name, a, b in labels:
        if a <= when <= b and (best is None or b - a < best[2] - best[1]):
            best = (name, a, b)
    return best[0] if best else "host"


def kernel_match(name: str, kernel: str) -> bool:
    """Whether a device activity's (demangled or mangled) name is the
    kernel function ``kernel``: the name, not a longer word ending in
    it (``vectorized_gather_kernel`` is not ``gather_kernel``)."""
    if f"{len(kernel)}{kernel}" in name:       # an Itanium-mangled name
        return True
    return re.search(r"(?<![A-Za-z_])" + re.escape(kernel) + r"(?![A-Za-z0-9_])",
                     name) is not None
