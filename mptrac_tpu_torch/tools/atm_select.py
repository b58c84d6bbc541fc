"""atm_select — extract a subset of air parcels
(reference src/atm_select.c).

Usage: python -m mptrac_tpu_torch.tools.atm_select <ctl> <atm_select>
       <atm1> [<atm2> ...] [KEY VALUE ...]

SELECT_STRIDE/IP0/IP1 subset by index; SELECT_T0/T1, SELECT_Z0/Z1,
SELECT_LON0/LON1, SELECT_LAT0/LAT1 subset by range; SELECT_R0/R1 by
distance from (SELECT_LON, SELECT_LAT).  The input files are the
arguments that name existing files.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from mptrac_tpu_torch.config import CtlFile, read_ctl
from mptrac_tpu_torch.constants import H0, P0, RE
from mptrac_tpu_torch.io.atm_io import read_atm, write_atm
from mptrac_tpu_torch.tools._cli import (host_atm, host_columns,
                                         require_args, run_tool)


def main(argv):
    require_args(argv, 4, "atm_select <ctl> <atm_select> <atm1> "
                          "[<atm2> ...] [KEY VALUE ...]")
    ctl = read_ctl(argv[1], argv[2:])
    s = CtlFile(argv[1], argv[2:])
    g = s.scan_float
    stride = int(g("SELECT_STRIDE", -1, "1"))
    ip0 = int(g("SELECT_IP0", -1, "-1"))
    ip1 = int(g("SELECT_IP1", -1, "-1"))
    t0, t1 = g("SELECT_T0", -1, "0"), g("SELECT_T1", -1, "0")
    z0, z1 = g("SELECT_Z0", -1, "0"), g("SELECT_Z1", -1, "0")
    lon0, lon1 = g("SELECT_LON0", -1, "0"), g("SELECT_LON1", -1, "0")
    lat0, lat1 = g("SELECT_LAT0", -1, "0"), g("SELECT_LAT1", -1, "0")
    r0, r1 = g("SELECT_R0", -1, "0"), g("SELECT_R1", -1, "0")
    rlon, rlat = g("SELECT_LON", -1, "0"), g("SELECT_LAT", -1, "0")

    files = [a for a in argv[3:] if os.path.exists(a)]
    if not files:
        raise SystemExit("No input files!")

    outs = []
    for f in files:
        time, p, lon, lat, q = host_columns(read_atm(f, ctl, device="cpu"))
        n = time.size
        keep = np.zeros(n, bool)
        keep[::stride] = True
        if ip0 >= 0:
            idx = np.arange(n)
            lo, hi = ip0, ip1 if ip1 >= ip0 else ip0
            keep &= (idx >= lo) & (idx <= hi)
        z = H0 * np.log(P0 / p)
        if t1 > t0:
            keep &= (time >= t0) & (time <= t1)
        if z1 > z0:
            keep &= (z >= z0) & (z <= z1)
        if lon1 > lon0:
            keep &= (lon >= lon0) & (lon <= lon1)
        if lat1 > lat0:
            keep &= (lat >= lat0) & (lat <= lat1)
        if r1 > r0:
            c = (np.sin(np.deg2rad(rlat)) * np.sin(np.deg2rad(lat))
                 + np.cos(np.deg2rad(rlat)) * np.cos(np.deg2rad(lat))
                 * np.cos(np.deg2rad(lon - rlon)))
            dist = RE * np.arccos(np.clip(c, -1, 1))
            keep &= (dist >= r0) & (dist <= r1)
        outs.append((time[keep], p[keep], lon[keep], lat[keep],
                     {k: v[keep] for k, v in q.items()}))

    write_atm(argv[2], ctl, host_atm(
        *(np.concatenate([o[i] for o in outs]) for i in range(4)),
        {k: np.concatenate([o[4][k] for o in outs])
         for k in ctl.qnt_name}), 0.0)
    return 0


if __name__ == "__main__":
    sys.exit(run_tool(main))
