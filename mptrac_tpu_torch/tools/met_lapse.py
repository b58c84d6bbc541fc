"""met_lapse — temperature lapse rate statistics
(reference src/met_lapse.c).

Usage: python -m mptrac_tpu_torch.tools.met_lapse <ctl> <lapse.tab> <met0>
       [<met1> ...] [KEY VALUE ...] [--device cuda|cpu]

Resamples temperature profiles on 100 m levels and reports min/mean/
max/sigma lapse rates within a LAPSE_DZ layer, averaged over the
LAPSE_LAT0..LAT1 / LAPSE_Z0..Z1 region.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from mptrac_tpu_torch.climatology import read_clim
from mptrac_tpu_torch.config import CtlFile, read_ctl
from mptrac_tpu_torch.constants import G0, H0, P0, RA
from mptrac_tpu_torch.met.build import read_met
from mptrac_tpu_torch.tools._cli import pop_device, require_args, run_tool


def _lapse(p1, t1, p2, t2):
    return (1e3 * G0 / RA * (t2 - t1) / (t2 + t1)
            * (p2 + p1) / (p2 - p1))


_USAGE = ("met_lapse <ctl> <lapse.tab> <met0> [...] "
          "[--device cuda|cpu]")


def main(argv):
    argv = list(argv)
    device = pop_device(argv, _USAGE)
    require_args(argv, 4, _USAGE)
    ctl = read_ctl(argv[1], argv[2:])
    s = CtlFile(argv[1], argv[2:])
    dz = int(s.scan_float("LAPSE_DZ", -1, "10"))
    lat0 = s.scan_float("LAPSE_LAT0", -1, "-90")
    lat1 = s.scan_float("LAPSE_LAT1", -1, "90")
    z0 = s.scan_float("LAPSE_Z0", -1, "0")
    z1 = s.scan_float("LAPSE_Z1", -1, "100")
    clim = read_clim(ctl, device=device)

    z2 = 0.1 * np.arange(251)
    p2 = P0 * np.exp(-z2 / H0)

    files = [a for a in argv[3:] if os.path.exists(a)]
    with open(argv[2], "w") as out:
        out.write("# $1 = time [s]\n# $2 = altitude [km]\n"
                  "# $3 = latitude [deg]\n"
                  "# $4 = lapse rate (mean) [K/km]\n"
                  "# $5 = lapse rate (sigma) [K/km]\n"
                  "# $6 = lapse rate (minimum) [K/km]\n"
                  "# $7 = lapse rate (maximum) [K/km]\n"
                  "# $8 = number of data points\n\n")
        for f in files:
            met = read_met(f, ctl, clim, device=device)
            lat = met.lat.cpu().numpy()
            p = met.p.cpu().numpy()
            zlev = H0 * np.log(P0 / p)
            t3 = met.fields3d["t"].cpu().numpy().astype(np.float64)
            ps = met.fields2d["ps"].cpu().numpy().astype(np.float64)
            sel_lat = (lat >= lat0) & (lat <= lat1)
            # vectorized linear resample of all columns onto z2
            nx, ny, npl = t3.shape
            t2 = np.empty((nx, ny, z2.size))
            for iz, zz in enumerate(z2):
                idx = np.clip(np.searchsorted(zlev, zz) - 1, 0, npl - 2)
                w = (zz - zlev[idx]) / (zlev[idx + 1] - zlev[idx])
                t2[..., iz] = (t3[..., idx] * (1 - w)
                               + t3[..., idx + 1] * w)
            stats = []
            for iz, zz in enumerate(z2):
                if not (z0 <= zz <= z1) or iz + 1 > 250:
                    continue
                top = min(iz + dz, 250)
                lapses = [_lapse(p2[iz], t2[..., iz], p2[iz2],
                                 t2[..., iz2])
                          for iz2 in range(iz + 1, top + 1)]
                if not lapses:
                    continue
                la = np.stack(lapses, -1)   # [nx, ny, nl]
                okcol = (p2[iz] <= ps)[:, :, None] & \
                    sel_lat[None, :, None]
                vals = la[np.broadcast_to(okcol, la.shape)]
                if vals.size == 0:
                    continue
                stats.append((float(met.time), zz,
                              float(lat[sel_lat].mean()),
                              vals.mean(), vals.std(), vals.min(),
                              vals.max(), vals.size))
            for row in stats:
                out.write("%.2f %g %g %g %g %g %g %d\n" % row)
    return 0


if __name__ == "__main__":
    sys.exit(run_tool(main))
