"""tropo_clim — monthly tropopause climatology from tropo products
(reference src/tropo_clim.c).

Usage: python -m mptrac_tpu_torch.tools.tropo_clim <ctl> <clim.tab>
       <var> <tropo1.nc> [<tropo2.nc> ...]
"""

from __future__ import annotations

import os
import sys

import numpy as np
from scipy.io import netcdf_file

from mptrac_tpu_torch.config import read_ctl
from mptrac_tpu_torch.tools._cli import require_args, run_tool


def main(argv):
    require_args(argv, 5, "tropo_clim <ctl> <clim.tab> <var> "
                          "<tropo1.nc> [...]")
    read_ctl(argv[1], argv[2:])
    files = [a for a in argv[4:] if os.path.exists(a)]
    acc = None
    for f in files:
        nc = netcdf_file(f, mmap=False)
        lat = np.array(nc.variables["lat"][:], np.float64)
        var = np.array(nc.variables[argv[3]][:], np.float64)
        nc.close()
        if acc is None:
            acc = dict(lat=lat, s=0.0, s2=0.0, n=0)
        ok = np.isfinite(var)
        acc["s"] = acc["s"] + np.where(ok, var, 0.0).sum(axis=(0, 2))
        acc["s2"] = acc["s2"] + np.where(ok, var ** 2, 0.0).sum(
            axis=(0, 2))
        acc["n"] = acc["n"] + ok.sum(axis=(0, 2))
    if acc is None:
        raise SystemExit("No tropopause files read!")
    n = np.maximum(acc["n"], 1)
    mean = acc["s"] / n
    var_ = acc["s2"] / n - mean ** 2
    with open(argv[2], "w") as out:
        out.write("# $1 = latitude [deg]\n"
                  f"# $2 = {argv[3]} (mean)\n"
                  f"# $3 = {argv[3]} (sigma)\n"
                  "# $4 = number of data points\n\n")
        for iy, la in enumerate(acc["lat"]):
            out.write("%g %g %g %d\n" % (
                la, mean[iy], np.sqrt(max(var_[iy], 0.0)), acc["n"][iy]))
    return 0


if __name__ == "__main__":
    sys.exit(run_tool(main))
