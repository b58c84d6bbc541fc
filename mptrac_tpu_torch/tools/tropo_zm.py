"""tropo_zm — zonal means of tropopause data
(reference src/tropo_zm.c).

Usage: python -m mptrac_tpu_torch.tools.tropo_zm <ctl> <zm.tab> <var>
       <tropo.nc>
"""

from __future__ import annotations

import sys

import numpy as np
from scipy.io import netcdf_file

from mptrac_tpu_torch.config import read_ctl
from mptrac_tpu_torch.tools._cli import require_args, run_tool


def main(argv):
    require_args(argv, 5, "tropo_zm <ctl> <zm.tab> <var> <tropo.nc>")
    read_ctl(argv[1], argv[2:])
    nc = netcdf_file(argv[4], mmap=False)
    lat = np.array(nc.variables["lat"][:], np.float64)
    times = np.array(nc.variables["time"][:], np.float64)
    var = np.array(nc.variables[argv[3]][:], np.float64)
    nc.close()

    with open(argv[2], "w") as out:
        out.write("# $1 = time [s]\n# $2 = latitude [deg]\n"
                  f"# $3 = {argv[3]} (zonal mean)\n"
                  f"# $4 = {argv[3]} (zonal sigma)\n"
                  "# $5 = number of data points\n")
        for it, t in enumerate(times):
            out.write("\n")
            for iy, la in enumerate(lat):
                vals = var[it, iy]
                ok = np.isfinite(vals)
                mean = vals[ok].mean() if ok.any() else np.nan
                sig = vals[ok].std() if ok.any() else np.nan
                out.write("%.2f %g %g %g %d\n"
                          % (t, la, mean, sig, ok.sum()))
    return 0


if __name__ == "__main__":
    sys.exit(run_tool(main))
