"""Simulation run loop.

Counterpart of the step loop of the JAX package's ``sim.py``
(``Simulation.advance`` and the sort policy, :201-235, :286-303; the
reference loop is trac.c:122-160): sort when due, run the timestep,
advance the model time.  The met pair and its gather tables are handed
in (``build_pack`` makes the tables that ``TPU_FAST`` asks for);
file-backed met buffering, outputs and checkpoints are not ported yet.
"""

from __future__ import annotations

import math
from typing import Iterable, Optional

from mptrac_tpu_torch.config import Ctl
from mptrac_tpu_torch.ops.fast_interp import MetPack, build_met_pack
from mptrac_tpu_torch.ops.sort import module_sort
from mptrac_tpu_torch.physics import pipeline
from mptrac_tpu_torch.types import Atm, Cache, Clim, Met


def build_pack(ctl: Ctl, met01: Met) -> Optional[MetPack]:
    """The gather tables that the control parameters ask for, as the
    JAX package's ``Simulation._get_pack`` chooses them (rebuild once
    per met interval): ``TPU_FAST 0`` none, the exact interpolation;
    ``TPU_FAST >= 2`` with ``SORT_DT > 0`` the fused RK kernel's;
    otherwise the unfused kernels'."""
    if not ctl.tpu_fast:
        return None
    return build_met_pack(met01,
                          cell=ctl.tpu_fast >= 2 and ctl.sort_dt > 0)


class Simulation:
    """Holds the state of one run and advances it step by step."""

    #: re-sort when the served fraction since the last sort dips below
    #: this.  Every parcel is served by this package's kernels, so
    #: ``cache.served_min`` stays 1.0 and the sort is due only by
    #: ``ctl.sort_dt``; the check keeps the loop's shape.
    SORT_SERVED_THRESH = 0.995

    def __init__(self, ctl: Ctl, clim: Clim, met01: Met, atm: Atm,
                 cache: Cache, pack: Optional[MetPack] = None):
        self.ctl = ctl
        self.clim = clim
        self.met01 = met01
        self.atm = atm
        self.cache = cache
        self.pack = pack
        self.nsorts = 0

    def _sort_due(self) -> bool:
        # served_min is a host float: no device sync
        return (self.cache.served_min is not None
                and self.cache.served_min < self.SORT_SERVED_THRESH)

    def sort(self):
        self.atm, self.cache = module_sort(self.met01, self.atm,
                                           self.cache)
        self.nsorts += 1

    def _flags(self, t: float) -> pipeline.StepFlags:
        ctl = self.ctl

        def hit(dt):
            return dt <= 0 or math.fmod(t, dt) == 0

        return pipeline.StepFlags(
            do_conv=ctl.conv_dt <= 0 or math.fmod(t, ctl.conv_dt) == 0,
            do_mixing=hit(ctl.mixing_dt),
            do_kpp=hit(ctl.dt_kpp),
            do_meteo=(ctl.met_dt_out > 0
                      and (ctl.met_dt_out < ctl.dt_mod
                           or math.fmod(t, ctl.met_dt_out) == 0)),
        )

    def times(self):
        """Iterator over model step times (reference trac.c:122-129)."""
        ctl = self.ctl
        t = ctl.t_start
        while ctl.direction * (t - ctl.t_stop) < ctl.dt_mod:
            yield min(t, ctl.t_stop) if ctl.direction == 1 else max(
                t, ctl.t_stop)
            t += ctl.direction * ctl.dt_mod

    def advance(self, t: float):
        """One step of the run loop at model time ``t``: optional
        sort, then the timestep (reference trac.c:122-160)."""
        if self.ctl.sort_dt > 0 and (
                math.fmod(t, self.ctl.sort_dt) == 0 or self._sort_due()):
            self.sort()
        self.atm, self.cache = pipeline.run_timestep(
            self.ctl, self.clim, self.met01, self.atm, self.cache, t,
            self._flags(t), self.pack)

    def run(self, ts: Optional[Iterable[float]] = None):
        """Advance over ``ts`` (default: every step time of the run)."""
        for t in (self.times() if ts is None else ts):
            self.advance(t)
