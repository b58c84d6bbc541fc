"""atm2grid — convert a particle file to gridded output
(reference src/atm2grid.c).

Usage: python -m mptrac_tpu_torch.tools.atm2grid <ctl> <atm_in>
       [KEY VALUE ...]
"""

from __future__ import annotations

import sys

from mptrac_tpu_torch.config import read_ctl
from mptrac_tpu_torch.io.atm_io import read_atm
from mptrac_tpu_torch.io.writers import GridWriter
from mptrac_tpu_torch.met.read_nc import time_from_filename
from mptrac_tpu_torch.timeutil import jsec2time
from mptrac_tpu_torch.tools._cli import require_args, run_tool


def main(argv):
    require_args(argv, 3, "atm2grid <ctl> <atm_in> [KEY VALUE ...]")
    ctl = read_ctl(argv[1], argv[2:])
    if ctl.grid_basename == "-":
        raise SystemExit("You need to specify GRID_BASENAME!")
    atm = read_atm(argv[2], ctl, device="cpu")
    offset = 23 if ctl.atm_type < 2 else 22
    t = time_from_filename(argv[2], offset)
    year, mon, day, hour, minute, sec, _ = jsec2time(t)
    ext = "tab" if ctl.grid_type == 0 else "nc"
    fn = (f"{ctl.grid_basename}_{year:04d}_{mon:02d}_{day:02d}"
          f"_{hour:02d}_{minute:02d}_{sec:02d}.{ext}")
    GridWriter(ctl).write(fn, None, atm, t)
    return 0


if __name__ == "__main__":
    sys.exit(run_tool(main))
