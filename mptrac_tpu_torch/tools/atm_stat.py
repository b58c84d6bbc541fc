"""atm_stat — air parcel statistics over a sequence of files
(reference src/atm_stat.c).

Usage: python -m mptrac_tpu_torch.tools.atm_stat <ctl> <stat.tab>
       <param> <atm1> [<atm2> ...]

param: mean | stddev | min | max | skew | kurt | median | absdev | mad
"""

from __future__ import annotations

import os
import sys

import numpy as np
from scipy import stats as sstats

from mptrac_tpu_torch.config import CtlFile, read_ctl
from mptrac_tpu_torch.constants import H0, P0
from mptrac_tpu_torch.io.atm_io import read_atm
from mptrac_tpu_torch.met.read_nc import time_from_filename
from mptrac_tpu_torch.tools._cli import host_columns, require_args, run_tool

_STATS = {
    "mean": np.mean,
    "stddev": lambda x: np.std(x, ddof=1),
    "min": np.min,
    "max": np.max,
    "skew": lambda x: sstats.skew(x, bias=False),
    "kurt": lambda x: sstats.kurtosis(x, bias=False),
    "median": np.median,
    "absdev": lambda x: np.mean(np.abs(x - np.mean(x))),
    "mad": lambda x: np.median(np.abs(x - np.median(x))),
}


def main(argv):
    require_args(argv, 4, "atm_stat <ctl> <stat.tab> <param> <atm1> "
                          "[<atm2> ...]")
    ctl = read_ctl(argv[1], argv[2:])
    s = CtlFile(argv[1], argv[2:])
    ens = int(s.scan_float("STAT_ENS", -1, "-999"))
    p0 = P0 * np.exp(-s.scan_float("STAT_Z0", -1, "-1000") / H0)
    p1 = P0 * np.exp(-s.scan_float("STAT_Z1", -1, "1000") / H0)
    lat0 = s.scan_float("STAT_LAT0", -1, "-1000")
    lat1 = s.scan_float("STAT_LAT1", -1, "1000")
    lon0 = s.scan_float("STAT_LON0", -1, "-1000")
    lon1 = s.scan_float("STAT_LON1", -1, "1000")
    param = argv[3].lower()
    if param not in _STATS:
        raise SystemExit("Unknown parameter!")
    fstat = _STATS[param]

    files = [a for a in argv[4:] if os.path.exists(a)]
    t_init = None
    with open(argv[2], "w") as out:
        out.write("# $1 = time [s]\n# $2 = time difference [s]\n"
                  f"# $3 = altitude ({argv[3]}) [km]\n"
                  f"# $4 = longitude ({argv[3]}) [deg]\n"
                  f"# $5 = latitude ({argv[3]}) [deg]\n")
        for iq, name in enumerate(ctl.qnt_name):
            out.write(f"# ${iq + 6} = {name} ({argv[3]}) "
                      f"[{ctl.qnt_unit[iq]}]\n")
        out.write(f"# ${ctl.nq + 6} = number of particles\n\n")
        for f in files:
            time, p, lon, lat, q = host_columns(read_atm(f, ctl,
                                                         device="cpu"))
            offset = 23 if ctl.atm_type < 2 else 22
            t = time_from_filename(f, offset)
            if t_init is None:
                t_init = t
            keep = np.isfinite(time)
            if ctl.qnt("ens") > 0:
                keep &= q["ens"] == ens
            keep &= ((p <= p0) & (p >= p1) & (lon >= lon0)
                     & (lon <= lon1) & (lat >= lat0) & (lat <= lat1))
            if keep.sum() == 0:
                continue
            z = H0 * np.log(P0 / p[keep])
            out.write("%.2f %.2f %g %g %g" % (
                t, t - t_init, fstat(z), fstat(lon[keep]),
                fstat(lat[keep])))
            for iq, name in enumerate(ctl.qnt_name):
                out.write(" " + ctl.qnt_format[iq] % fstat(q[name][keep]))
            out.write(" %d\n" % keep.sum())
    return 0


if __name__ == "__main__":
    sys.exit(run_tool(main))
