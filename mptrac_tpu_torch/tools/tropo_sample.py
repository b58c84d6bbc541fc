"""tropo_sample — sample tropopause data at given locations
(reference src/tropo_sample.c).

Usage: python -m mptrac_tpu_torch.tools.tropo_sample <ctl> <sample.tab>
       <tropo.nc> <var> <atm_in>

Reads a tropopause product written by the ``tropo`` tool and bilinearly
samples variable <var> (e.g. wmo_1st_p) at the parcel positions.
"""

from __future__ import annotations

import sys

import numpy as np
from scipy.io import netcdf_file

from mptrac_tpu_torch.config import read_ctl
from mptrac_tpu_torch.constants import H0, P0
from mptrac_tpu_torch.io.atm_io import read_atm
from mptrac_tpu_torch.tools._cli import host_columns, require_args, run_tool


def main(argv):
    require_args(argv, 6, "tropo_sample <ctl> <sample.tab> <tropo.nc> "
                          "<var> <atm_in>")
    ctl = read_ctl(argv[1], argv[2:])
    nc = netcdf_file(argv[3], mmap=False)
    lat = np.array(nc.variables["lat"][:], np.float64)
    lon = np.array(nc.variables["lon"][:], np.float64)
    times = np.array(nc.variables["time"][:], np.float64)
    var = np.array(nc.variables[argv[4]][:], np.float64)
    nc.close()

    at, ap, alon, alat, _ = host_columns(read_atm(argv[5], ctl,
                                                  device="cpu"))

    it = np.clip(np.searchsorted(times, at), 0, times.size - 1)
    iy = np.clip(np.searchsorted(lat, alat) - 1, 0, lat.size - 2)
    ix = np.clip(np.searchsorted(lon, alon) - 1, 0, lon.size - 2)
    wy = (alat - lat[iy]) / (lat[iy + 1] - lat[iy])
    wx = (alon - lon[ix]) / (lon[ix + 1] - lon[ix])
    v00 = var[it, iy, ix]
    v01 = var[it, iy, ix + 1]
    v10 = var[it, iy + 1, ix]
    v11 = var[it, iy + 1, ix + 1]
    vals = ((1 - wy) * ((1 - wx) * v00 + wx * v01)
            + wy * ((1 - wx) * v10 + wx * v11))

    with open(argv[2], "w") as out:
        out.write("# $1 = time [s]\n# $2 = altitude [km]\n"
                  "# $3 = longitude [deg]\n# $4 = latitude [deg]\n"
                  f"# $5 = {argv[4]}\n\n")
        for i in range(at.size):
            out.write("%.2f %g %g %g %g\n" % (
                at[i], H0 * np.log(P0 / ap[i]), alon[i], alat[i],
                vals[i]))
    return 0


if __name__ == "__main__":
    sys.exit(run_tool(main))
