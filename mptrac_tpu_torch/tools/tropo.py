"""tropo — tropopause data products
(reference src/tropo.c).

Usage: python -m mptrac_tpu_torch.tools.tropo <ctl> <tropo.nc> <met0>
       [<met1> ...] [KEY VALUE ...] [--device cuda|cpu]

Computes climatological, cold-point, WMO 1st/2nd and dynamical
tropopause pressure/height/temperature/H2O/O3 per column and writes a
netCDF product.  The met data are read onto ``--device`` (default cuda);
the tropopause search runs on the host, as in the JAX package.
"""

from __future__ import annotations

import os
import sys

import numpy as np
from scipy.io import netcdf_file

from mptrac_tpu_torch.climatology import read_clim
from mptrac_tpu_torch.config import CtlFile, read_ctl
from mptrac_tpu_torch.constants import H0, P0
from mptrac_tpu_torch.met import process
from mptrac_tpu_torch.met.build import interp_columns_at, read_met
from mptrac_tpu_torch.tools._cli import pop_device, require_args, run_tool

#: (variable prefix, met_tropo id)
DEFINITIONS = (("clp", 2), ("wmo_1st", 3), ("wmo_2nd", 4), ("dyn", 5))


_USAGE = "tropo <ctl> <tropo.nc> <met0> [<met1> ...] [--device cuda|cpu]"


def main(argv):
    argv = list(argv)
    device = pop_device(argv, _USAGE)
    require_args(argv, 4, _USAGE)
    ctl = read_ctl(argv[1], argv[2:])
    s = CtlFile(argv[1], argv[2:])
    want_h2o = int(s.scan_float("TROPO_H2O", -1, "1"))
    want_o3 = int(s.scan_float("TROPO_O3", -1, "1"))
    clim = read_clim(ctl, device=device)

    files = [a for a in argv[3:] if os.path.exists(a)]
    nc = None
    try:
        for it, f in enumerate(files):
            met = read_met(f, ctl.replace(met_tropo=0), clim,
                           device=device)
            lon = met.lon.cpu().numpy()
            lat = met.lat.cpu().numpy()
            p = met.p.cpu().numpy()
            f2 = {k: v.cpu().numpy() for k, v in met.fields2d.items()}
            f3 = {k: v.cpu().numpy() for k, v in met.fields3d.items()}

            if nc is None:
                nc = netcdf_file(argv[2], "w")
                nc.createDimension("time", None)
                nc.createDimension("lat", lat.size)
                nc.createDimension("lon", lon.size)
                vtime = nc.createVariable("time", "d", ("time",))
                vlat = nc.createVariable("lat", "d", ("lat",))
                vlat[:] = lat
                vlon = nc.createVariable("lon", "d", ("lon",))
                vlon[:] = lon
                vars_ = {}
                for prefix, _ in DEFINITIONS:
                    for suffix in ("z", "p", "t", "q", "o3"):
                        if suffix == "q" and not want_h2o:
                            continue
                        if suffix == "o3" and not want_o3:
                            continue
                        vars_[f"{prefix}_{suffix}"] = nc.createVariable(
                            f"{prefix}_{suffix}", "f",
                            ("time", "lat", "lon"))
                data = {k: [] for k in vars_}
                times = []

            times.append(float(met.time))
            for prefix, mid in DEFINITIONS:
                ctl_t = ctl.replace(met_tropo=mid)
                f2w = dict(f2)
                process.tropopause(ctl_t, clim, float(met.time), lon,
                                   lat, p, f2w, f3)
                pt = f2w["pt"]
                rec = {
                    "z": f2w["zt"], "p": pt, "t": f2w["tt"],
                    "q": f2w["h2ot"],
                    "o3": interp_columns_at(f3["o3"], lon, lat, p, pt,
                                            ctl.met_coord_type)}
                for suffix in ("z", "p", "t", "q", "o3"):
                    key = f"{prefix}_{suffix}"
                    if key in data:
                        data[key].append(rec[suffix].T)  # [lat, lon]

        if nc is None:
            raise SystemExit("No met files read!")
        vtime[:] = np.asarray(times)
        for k, v in vars_.items():
            v[:] = np.stack(data[k]).astype(np.float32)
    finally:
        if nc is not None:
            nc.close()
    return 0


if __name__ == "__main__":
    sys.exit(run_tool(main))
