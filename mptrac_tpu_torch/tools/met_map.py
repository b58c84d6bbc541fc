"""met_map — horizontal map of meteo + derived fields
(reference src/met_map.c).

Usage: python -m mptrac_tpu_torch.tools.met_map <ctl> <map.tab> <met0>
       [<met1> ...] [KEY VALUE ...] [--device cuda|cpu]

Samples all standard variables (MET_HEADER record) on a lon/lat grid at
MAP_Z0 altitude (or on the MAP_THETA isentrope), averaged over the
given met files.  The met data and the sampling live on ``--device``
(default cuda).
"""

from __future__ import annotations

import os
import sys

import numpy as np

from mptrac_tpu_torch.climatology import read_clim
from mptrac_tpu_torch.config import CtlFile, read_ctl
from mptrac_tpu_torch.constants import H0, P0
from mptrac_tpu_torch.met.build import read_met
from mptrac_tpu_torch.tools._cli import pop_device, require_args, run_tool
from mptrac_tpu_torch.tools._met_sample import (MET_HEADER,
                                                find_theta_level,
                                                record_columns, sample_met)

_USAGE = ("met_map <ctl> <map.tab> <met0> [<met1> ...] "
          "[--device cuda|cpu]")


def main(argv):
    argv = list(argv)
    device = pop_device(argv, _USAGE)
    require_args(argv, 4, _USAGE)
    ctl = read_ctl(argv[1], argv[2:])
    s = CtlFile(argv[1], argv[2:])
    g = s.scan_float
    z0 = g("MAP_Z0", -1, "10")
    lon0, lon1 = g("MAP_LON0", -1, "-180"), g("MAP_LON1", -1, "180")
    dlon = g("MAP_DLON", -1, "-999")
    lat0, lat1 = g("MAP_LAT0", -1, "-90"), g("MAP_LAT1", -1, "90")
    dlat = g("MAP_DLAT", -1, "-999")
    theta = g("MAP_THETA", -1, "-999")
    clim = read_clim(ctl, device=device)

    files = [a for a in argv[3:] if os.path.exists(a)]
    acc = None
    for f in files:
        met = read_met(f, ctl, clim, device=device)
        mlon = met.lon.cpu().numpy()
        mlat = met.lat.cpu().numpy()
        dlo = dlon if dlon > 0 else abs(mlon[1] - mlon[0])
        dla = dlat if dlat > 0 else abs(mlat[1] - mlat[0])
        lo0, lo1 = ((mlon.min(), mlon.max())
                    if lon0 < -360 and lon1 > 360 else (lon0, lon1))
        la0, la1 = ((mlat.min(), mlat.max())
                    if lat0 < -90 and lat1 > 90 else (lat0, lat1))
        lons = np.round(np.arange(lo0, lo1 + 0.001, dlo) * 1e3) / 1e3
        lats = np.round(np.arange(la0, la1 + 0.001, dla) * 1e3) / 1e3
        glon, glat = np.meshgrid(lons, lats, indexing="ij")
        glon_f = glon.ravel()
        glat_f = glat.ravel()
        if theta > 0:
            p0 = find_theta_level(met, theta, glon_f, glat_f)
        else:
            p0 = np.full(glon_f.shape, P0 * np.exp(-z0 / H0))
        smp = sample_met(ctl, clim, met, p0, glon_f, glat_f)
        if acc is None:
            acc = dict(n=0, lons=lons, lats=lats, sums={})
        acc["n"] += 1
        for k, v in smp.items():
            acc["sums"][k] = acc["sums"].get(k, 0.0) + v
        acc["sums"]["_time"] = (acc["sums"].get("_time", 0.0)
                                + np.full(glon_f.shape, float(met.time)))
        acc["sums"]["_p"] = acc["sums"].get("_p", 0.0) + p0

    if acc is None:
        raise SystemExit("No met files read!")
    n = acc["n"]
    lons, lats = acc["lons"], acc["lats"]
    mean = {k: v / n for k, v in acc["sums"].items()}
    with open(argv[2], "w") as out:
        out.write(MET_HEADER)
        nx, ny = lons.size, lats.size
        for iy in range(ny):
            out.write("\n")
            for ix in range(nx):
                i = ix * ny + iy
                pm = mean["_p"][i]
                smp_i = {k: v[i] for k, v in mean.items()
                         if not k.startswith("_")}
                cols = record_columns(mean["_time"][i],
                                      H0 * np.log(P0 / pm),
                                      lons[ix], lats[iy], pm, smp_i,
                                      n, n, n)
                out.write("%.2f " % cols[0]
                          + " ".join("%g" % c for c in cols[1:52])
                          + " %d %d %d\n" % (n, n, n))
    return 0


if __name__ == "__main__":
    sys.exit(run_tool(main))
