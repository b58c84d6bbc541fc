"""Output dispatcher (reference mptrac_write_output,
mptrac.c:7919-8009).  Counterpart of the JAX package's ``io/output.py``
with the particle (atm) output; the grid, ensemble, CSI, profile,
sample, station and VTK writers (``io/writers.py`` there) are not
ported yet, and a control file that asks for one raises.
"""

from __future__ import annotations

import math
import os

from mptrac_tpu_torch.config import Ctl
from mptrac_tpu_torch.io import atm_io
from mptrac_tpu_torch.timeutil import jsec2time
from mptrac_tpu_torch.types import Atm


def _stamp(t: float) -> str:
    year, mon, day, hour, minute, sec, _ = jsec2time(t)
    return f"{year:04d}_{mon:02d}_{day:02d}_{hour:02d}_{minute:02d}_{sec:02d}"


class OutputManager:
    def __init__(self, dirname: str, ctl: Ctl):
        self.dirname = dirname
        self.ctl = ctl
        for key, writer in (("grid", "GridWriter"), ("ens", "EnsWriter"),
                            ("vtk", "VtkWriter"), ("csi", "CsiWriter"),
                            ("prof", "ProfWriter"),
                            ("sample", "SampleWriter"),
                            ("stat", "StationWriter")):
            if getattr(ctl, f"{key}_basename") != "-":
                raise NotImplementedError(
                    f"{key.upper()}_BASENAME is set, but io/writers."
                    f"{writer} is not ported to mptrac_tpu_torch yet")

    def write(self, metbuf, atm: Atm, t: float):
        ctl = self.ctl
        if ctl.atm_basename != "-" and (
                math.fmod(t, ctl.atm_dt_out) == 0 or t == ctl.t_stop):
            ext = {0: "tab", 1: "bin"}.get(ctl.atm_type_out, "nc")
            atm_io.write_atm(
                os.path.join(self.dirname,
                             f"{ctl.atm_basename}_{_stamp(t)}.{ext}"),
                ctl, atm, t)

    def close(self):
        """Nothing stays open between writes of the atm output."""
