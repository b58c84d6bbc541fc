"""Output dispatcher (reference mptrac_write_output,
mptrac.c:7919-8009): per-interval file outputs of particle, grid,
ensemble, CSI, profile, sample, station and VTK data.

Counterpart of the JAX package's ``io/output.py``: the same writers
(``io/writers.py``), file names, ``fmod`` conditions and order.  The
order matters: the station writer runs after the particle output, so
the particle file at time t shows the station flags set up to the
previous write.  Stateful writers (open files, accumulated statistics)
live in an :class:`OutputManager` owned by the Simulation.
"""

from __future__ import annotations

import math
import os

from mptrac_tpu_torch.config import Ctl
from mptrac_tpu_torch.io import atm_io, writers
from mptrac_tpu_torch.timeutil import jsec2time
from mptrac_tpu_torch.types import Atm


def _stamp(t: float) -> str:
    year, mon, day, hour, minute, sec, _ = jsec2time(t)
    return f"{year:04d}_{mon:02d}_{day:02d}_{hour:02d}_{minute:02d}_{sec:02d}"


class OutputManager:
    def __init__(self, dirname: str, ctl: Ctl):
        self.dirname = dirname
        self.ctl = ctl
        self.nvtk = 0

        def tab(base):
            return os.path.join(dirname, f"{base}.tab")

        self.grid = (writers.GridWriter(ctl)
                     if ctl.grid_basename != "-" else None)
        self.ens = (writers.EnsWriter(ctl)
                    if ctl.ens_basename != "-" else None)
        self.vtk = (writers.VtkWriter(ctl)
                    if ctl.vtk_basename != "-" else None)
        self.csi = (writers.CsiWriter(ctl, tab(ctl.csi_basename))
                    if ctl.csi_basename != "-" else None)
        self.prof = (writers.ProfWriter(ctl, tab(ctl.prof_basename))
                     if ctl.prof_basename != "-" else None)
        self.sample = (writers.SampleWriter(ctl, tab(ctl.sample_basename))
                       if ctl.sample_basename != "-" else None)
        self.station = (writers.StationWriter(ctl, tab(ctl.stat_basename))
                        if ctl.stat_basename != "-" else None)

    def write(self, metbuf, atm: Atm, t: float):
        ctl = self.ctl
        stamp = _stamp(t)
        join = os.path.join

        if ctl.atm_basename != "-" and (
                math.fmod(t, ctl.atm_dt_out) == 0 or t == ctl.t_stop):
            ext = {0: "tab", 1: "bin"}.get(ctl.atm_type_out, "nc")
            atm_io.write_atm(
                join(self.dirname, f"{ctl.atm_basename}_{stamp}.{ext}"),
                ctl, atm, t)

        if self.grid and math.fmod(t, ctl.grid_dt_out) == 0:
            ext = "tab" if ctl.grid_type == 0 else "nc"
            self.grid.write(
                join(self.dirname, f"{ctl.grid_basename}_{stamp}.{ext}"),
                metbuf, atm, t)

        if self.csi:
            self.csi.write(atm, t)

        if self.ens and math.fmod(t, ctl.ens_dt_out) == 0:
            self.ens.write(
                join(self.dirname, f"{ctl.ens_basename}_{stamp}.tab"),
                atm, t)

        if self.prof:
            self.prof.write(metbuf, atm, t)

        if self.sample:
            self.sample.write(metbuf, atm, t)

        if self.station:
            self.station.write(atm, t)

        if self.vtk and math.fmod(t, ctl.vtk_dt_out) == 0:
            self.nvtk += 1
            self.vtk.write(
                join(self.dirname, f"{ctl.vtk_basename}_{self.nvtk:05d}.vtk"),
                atm, t)

    def close(self):
        for w in (self.csi, self.prof, self.sample, self.station):
            if w is not None:
                w.close()
