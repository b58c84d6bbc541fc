"""atm_dist — transport deviations between pairs of particle files
(reference src/atm_dist.c).

Usage: python -m mptrac_tpu_torch.tools.atm_dist <ctl> <dist.tab>
       <param> <atm1a> <atm1b> [<atm2a> <atm2b> ...]

Computes absolute/relative horizontal and vertical transport deviations
(AHTD/RHTD/AVTD/RVTD) and per-quantity differences between matched
particle pairs, reduced by <param> (mean|stddev|min|max|median).
"""

from __future__ import annotations

import os
import sys

import numpy as np

from mptrac_tpu_torch.config import CtlFile, read_ctl
from mptrac_tpu_torch.constants import H0, P0, RE
from mptrac_tpu_torch.io.atm_io import read_atm
from mptrac_tpu_torch.met.read_nc import time_from_filename
from mptrac_tpu_torch.tools._cli import host_columns, require_args, run_tool

_STATS = {
    "mean": np.mean,
    "stddev": lambda x: np.std(x, ddof=1) if x.size > 1 else 0.0,
    "min": np.min,
    "max": np.max,
    "median": np.median,
}


def _geo2cart(lon, lat):
    la, lo = np.deg2rad(lat), np.deg2rad(lon)
    cl = np.cos(la)
    return np.stack([RE * cl * np.cos(lo), RE * cl * np.sin(lo),
                     RE * np.sin(la)], axis=-1)


def _read(filename, ctl):
    """(position columns by name, quantities) of a particle file."""
    time, p, lon, lat, q = host_columns(read_atm(filename, ctl,
                                                 device="cpu"))
    return dict(time=time, p=p, lon=lon, lat=lat), q


def main(argv):
    require_args(argv, 6, "atm_dist <ctl> <dist.tab> <param> <atm1a> "
                          "<atm1b> [<atm2a> <atm2b> ...]")
    ctl = read_ctl(argv[1], argv[2:])
    s = CtlFile(argv[1], argv[2:])
    ens = int(s.scan_float("DIST_ENS", -1, "-999"))
    p0 = P0 * np.exp(-s.scan_float("DIST_Z0", -1, "-1000") / H0)
    p1 = P0 * np.exp(-s.scan_float("DIST_Z1", -1, "1000") / H0)
    lat0 = s.scan_float("DIST_LAT0", -1, "-1000")
    lat1 = s.scan_float("DIST_LAT1", -1, "1000")
    lon0 = s.scan_float("DIST_LON0", -1, "-1000")
    lon1 = s.scan_float("DIST_LON1", -1, "1000")
    zscore = s.scan_float("DIST_ZSCORE", -1, "-999")
    rel_min = [s.scan_float("DIST_REL_MIN", iq, "0")
               for iq in range(ctl.nq)]
    param = argv[3].lower()
    fstat = _STATS[param]

    files = [a for a in argv[4:] if os.path.exists(a)]
    pairs = list(zip(files[0::2], files[1::2]))
    t_init = None
    lh1 = lv1 = lh2 = lv2 = None
    old = {}

    with open(argv[2], "w") as out:
        out.write(
            "# $1 = time [s]\n# $2 = time difference [s]\n"
            f"# $3 = absolute horizontal distance ({argv[3]}) [km]\n"
            f"# $4 = relative horizontal distance ({argv[3]}) [%]\n"
            f"# $5 = absolute vertical distance ({argv[3]}) [km]\n"
            f"# $6 = relative vertical distance ({argv[3]}) [%]\n")
        for iq, name in enumerate(ctl.qnt_name):
            out.write(f"# ${7 + 2 * iq} = {name} absolute difference "
                      f"({argv[3]}) [{ctl.qnt_unit[iq]}]\n"
                      f"# ${8 + 2 * iq} = {name} relative difference "
                      f"({argv[3]}) [%]\n")
        out.write(f"# ${7 + 2 * ctl.nq} = number of particles\n\n")

        for fi, (fa, fb) in enumerate(pairs):
            d1, q1 = _read(fa, ctl)
            d2, q2 = _read(fb, ctl)
            if d1["time"].size != d2["time"].size:
                raise SystemExit("Different numbers of particles!")
            n = d1["time"].size
            offset = 23 if ctl.atm_type < 2 else 22
            t = time_from_filename(fa, offset)
            if t_init is None:
                t_init = t
                lh1 = np.zeros(n)
                lv1 = np.zeros(n)
                lh2 = np.zeros(n)
                lv2 = np.zeros(n)

            keep = np.isfinite(d1["time"]) & np.isfinite(d2["time"])
            if ctl.qnt("ens") > 0:
                keep &= (q1["ens"] == ens) & (q2["ens"] == ens)
            for d in (d1, d2):
                keep &= ((d["p"] <= p0) & (d["p"] >= p1)
                         & (d["lon"] >= lon0) & (d["lon"] <= lon1)
                         & (d["lat"] >= lat0) & (d["lat"] <= lat1))

            x1 = _geo2cart(d1["lon"], d1["lat"])
            x2 = _geo2cart(d2["lon"], d2["lat"])
            z1 = H0 * np.log(P0 / d1["p"])
            z2 = H0 * np.log(P0 / d2["p"])
            ahtd = np.linalg.norm(x1 - x2, axis=-1)
            avtd = z1 - z2
            rhtd = np.zeros(n)
            rvtd = np.zeros(n)
            if fi > 0:
                x1o = _geo2cart(old["lon1"], old["lat1"])
                x2o = _geo2cart(old["lon2"], old["lat2"])
                lh1 += np.where(keep,
                                np.linalg.norm(x1o - x1, axis=-1), 0)
                lv1 += np.where(keep, np.abs(old["z1"] - z1), 0)
                lh2 += np.where(keep,
                                np.linalg.norm(x2o - x2, axis=-1), 0)
                lv2 += np.where(keep, np.abs(old["z2"] - z2), 0)
                lh = lh1 + lh2
                lv = lv1 + lv2
                rhtd = np.where(lh > 0, 200.0 * ahtd / np.where(
                    lh > 0, lh, 1), 0.0)
                rvtd = np.where(lv > 0, 200.0 * avtd / np.where(
                    lv > 0, lv, 1), 0.0)

            old = dict(lon1=d1["lon"], lat1=d1["lat"], z1=z1,
                       lon2=d2["lon"], lat2=d2["lat"], z2=z2)

            ah = ahtd[keep]
            av = avtd[keep]
            rh = rhtd[keep]
            rv = rvtd[keep]
            aq = {name: (q1[name] - q2[name])[keep]
                  for name in ctl.qnt_name}
            rq = {}
            for iq, name in enumerate(ctl.qnt_name):
                denom = (np.abs(q1[name]) + np.abs(q2[name]))[keep]
                rq[name] = np.where(
                    denom <= rel_min[iq], np.nan,
                    200.0 * aq[name] / np.where(denom > 0, denom, 1))

            if zscore > 0 and ah.size > 1:
                muh, sih = ah.mean(), ah.std(ddof=1)
                muv, siv = av.mean(), av.std(ddof=1)
                f = (np.abs((ah - muh) / sih) < zscore) & (
                    np.abs((av - muv) / siv) < zscore)
                ah, av, rh, rv = ah[f], av[f], rh[f], rv[f]
                aq = {k: v[f] for k, v in aq.items()}
                rq = {k: v[f] for k, v in rq.items()}

            if ah.size == 0:
                continue
            out.write("%.2f %.2f %g %g %g %g" % (
                t, t - t_init, fstat(ah), fstat(rh), fstat(av),
                fstat(rv)))
            for name in ctl.qnt_name:
                finite = rq[name][np.isfinite(rq[name])]
                out.write(" %g %g" % (
                    fstat(aq[name]),
                    fstat(finite) if finite.size else np.nan))
            out.write(" %d\n" % ah.size)
    return 0


if __name__ == "__main__":
    sys.exit(run_tool(main))
