"""met_prof — vertical profile of meteo + derived fields
(reference src/met_prof.c).

Usage: python -m mptrac_tpu_torch.tools.met_prof <ctl> <prof.tab> <met0>
       [<met1> ...] [KEY VALUE ...] [--device cuda|cpu]

Area-averages the standard variable record over
PROF_LON0..LON1 x PROF_LAT0..LAT1 on PROF_Z0..Z1 altitude levels.  The
met data and the sampling live on ``--device`` (default cuda).
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
from mptrac_tpu_torch.tools._met_sample import (MET_HEADER, record_columns,
                                                sample_met)

_USAGE = ("met_prof <ctl> <prof.tab> <met0> [<met1> ...] "
          "[--device cuda|cpu]")


def main(argv):
    argv = list(argv)
    device = pop_device(argv, _USAGE)
    require_args(argv, 4, _USAGE)
    ctl = read_ctl(argv[1], argv[2:])
    s = CtlFile(argv[1], argv[2:])
    g = s.scan_float
    z0 = g("PROF_Z0", -1, "-999")
    z1 = g("PROF_Z1", -1, "-999")
    dz = g("PROF_DZ", -1, "-999")
    lon0, lon1 = g("PROF_LON0", -1, "0"), g("PROF_LON1", -1, "0")
    dlon = g("PROF_DLON", -1, "-999")
    lat0, lat1 = g("PROF_LAT0", -1, "0"), g("PROF_LAT1", -1, "0")
    dlat = g("PROF_DLAT", -1, "-999")
    clim = read_clim(ctl, device=device)

    files = [a for a in argv[3:] if os.path.exists(a)]
    acc = {}
    nacc = 0
    for f in files:
        met = read_met(f, ctl, clim, device=device)
        mlon = met.lon.cpu().numpy()
        mlat = met.lat.cpu().numpy()
        mp = met.p.cpu().numpy()
        zlo = z0 if z0 >= 0 else H0 * np.log(P0 / mp[0])
        zhi = z1 if z1 >= 0 else H0 * np.log(P0 / mp[-1])
        dzz = dz if dz > 0 else abs(H0 * np.log(mp[0] / mp[1]))
        zs = np.arange(zlo, zhi + 0.001, dzz)
        dlo = dlon if dlon > 0 else abs(mlon[1] - mlon[0])
        dla = dlat if dlat > 0 else abs(mlat[1] - mlat[0])
        lons = np.arange(lon0, lon1 + 0.001, dlo)
        lats = np.arange(lat0, lat1 + 0.001, dla)
        gz, glon, glat = np.meshgrid(zs, lons, lats, indexing="ij")
        p0 = P0 * np.exp(-gz.ravel() / H0)
        smp = sample_met(ctl, clim, met, p0, glon.ravel(), glat.ravel())
        nh = lons.size * lats.size
        for k, v in smp.items():
            vv = v.reshape(zs.size, nh).mean(axis=1)
            acc[k] = acc.get(k, 0.0) + vv
        acc["_time"] = acc.get("_time", 0.0) + float(met.time)
        nacc += 1
        acc["_zs"] = zs

    if not nacc:
        raise SystemExit("No met files read!")
    zs = acc.pop("_zs")
    tmean = acc.pop("_time") / nacc
    mean = {k: v / nacc for k, v in acc.items()}
    with open(argv[2], "w") as out:
        out.write(MET_HEADER)
        out.write("\n")
        lonm = 0.5 * (lon0 + lon1)
        latm = 0.5 * (lat0 + lat1)
        for iz, z in enumerate(zs):
            p = P0 * np.exp(-z / H0)
            smp_i = {k: v[iz] for k, v in mean.items()}
            cols = record_columns(tmean, z, lonm, latm, p, smp_i)
            out.write("%.2f " % cols[0]
                      + " ".join("%g" % c for c in cols[1:52])
                      + " %d %d %d\n" % (nacc, nacc, nacc))
    return 0


if __name__ == "__main__":
    sys.exit(run_tool(main))
