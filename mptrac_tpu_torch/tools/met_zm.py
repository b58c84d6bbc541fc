"""met_zm — zonal-mean cross-section of meteo + derived fields
(reference src/met_zm.c).

Usage: python -m mptrac_tpu_torch.tools.met_zm <ctl> <zm.tab> <met0>
       [<met1> ...] [KEY VALUE ...] [--device cuda|cpu]

The met data and the sampling live on ``--device`` (default cuda).
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

_USAGE = ("met_zm <ctl> <zm.tab> <met0> [<met1> ...] "
          "[--device cuda|cpu]")


def main(argv):
    argv = list(argv)
    device = pop_device(argv, _USAGE)
    require_args(argv, 4, _USAGE)
    ctl = read_ctl(argv[1], argv[2:])
    s = CtlFile(argv[1], argv[2:])
    g = s.scan_float
    z0, z1 = g("ZM_Z0", -1, "-999"), g("ZM_Z1", -1, "-999")
    dz = g("ZM_DZ", -1, "-999")
    lon0, lon1 = g("ZM_LON0", -1, "-360"), g("ZM_LON1", -1, "360")
    dlon = g("ZM_DLON", -1, "-999")
    lat0, lat1 = g("ZM_LAT0", -1, "-90"), g("ZM_LAT1", -1, "90")
    dlat = g("ZM_DLAT", -1, "-999")
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
        lo0, lo1 = ((mlon.min(), mlon.max())
                    if lon0 < -360 and lon1 > 360 else (lon0, lon1))
        lons = np.arange(lo0, lo1 + 0.001, dlo)
        lats = np.round(np.arange(lat0, lat1 + 0.001, dla) * 1e3) / 1e3
        gz, glat, glon = np.meshgrid(zs, lats, lons, indexing="ij")
        p0 = P0 * np.exp(-gz.ravel() / H0)
        smp = sample_met(ctl, clim, met, p0, glon.ravel(), glat.ravel())
        for k, v in smp.items():
            vv = v.reshape(zs.size, lats.size, lons.size).mean(axis=2)
            acc[k] = acc.get(k, 0.0) + vv
        acc["_time"] = acc.get("_time", 0.0) + float(met.time)
        nacc += 1
        acc["_zs"] = zs
        acc["_lats"] = lats

    if not nacc:
        raise SystemExit("No met files read!")
    zs = acc.pop("_zs")
    lats = acc.pop("_lats")
    tmean = acc.pop("_time") / nacc
    mean = {k: v / nacc for k, v in acc.items()}
    with open(argv[2], "w") as out:
        out.write(MET_HEADER)
        for iz, z in enumerate(zs):
            out.write("\n")
            p = P0 * np.exp(-z / H0)
            for iy, la in enumerate(lats):
                smp_i = {k: v[iz, iy] for k, v in mean.items()}
                cols = record_columns(tmean, z, 0.0, la, p, smp_i)
                out.write("%.2f " % cols[0]
                          + " ".join("%g" % c for c in cols[1:52])
                          + " %d %d %d\n" % (nacc, nacc, nacc))
    return 0


if __name__ == "__main__":
    sys.exit(run_tool(main))
