"""atm_init — create an atmospheric data file with initial air parcel
positions (reference src/atm_init.c).

Usage: python -m mptrac_tpu_torch.tools.atm_init <ctl> <atm_out>
       [KEY VALUE ...]

Builds deterministic grids over INIT_T0..T1 / Z0..Z1 / LON0..LON1 /
LAT0..LAT1 with optional Gaussian (INIT_S*) and uniform (INIT_U*)
scatter, cosine-latitude area weighting (INIT_EVENLY), replication
(INIT_REP), cosine-bell mass (INIT_BELLRAD, Williamson et al. 1992) and
per-parcel mass/vmr.  Randomness uses numpy's PCG64 (the reference uses
GSL mt19937; streams are not bit-compatible), in the JAX package's
order of draws, so that a seeded file is the same byte for byte.
"""

from __future__ import annotations

import sys

import numpy as np

from mptrac_tpu_torch.config import CtlFile, read_ctl
from mptrac_tpu_torch.constants import H0, P0, RE
from mptrac_tpu_torch.io.atm_io import write_atm
from mptrac_tpu_torch.tools._cli import host_atm, require_args, run_tool

FWHM = 2.3548


def main(argv):
    require_args(argv, 3, "atm_init <ctl> <atm_out> [KEY VALUE ...]")
    ctl = read_ctl(argv[1], argv[2:])
    s = CtlFile(argv[1], argv[2:])
    g = s.scan_float
    t0, t1 = g("INIT_T0", -1, "0"), g("INIT_T1", -1, "0")
    dt = g("INIT_DT", -1, "1")
    z0, z1 = g("INIT_Z0", -1, "0"), g("INIT_Z1", -1, "0")
    dz = g("INIT_DZ", -1, "1")
    lon0, lon1 = g("INIT_LON0", -1, "0"), g("INIT_LON1", -1, "0")
    dlon = g("INIT_DLON", -1, "1")
    lat0, lat1 = g("INIT_LAT0", -1, "0"), g("INIT_LAT1", -1, "0")
    dlat = g("INIT_DLAT", -1, "1")
    st, sz = g("INIT_ST", -1, "0"), g("INIT_SZ", -1, "0")
    slon, slat = g("INIT_SLON", -1, "0"), g("INIT_SLAT", -1, "0")
    sx = g("INIT_SX", -1, "0")
    ut, uz = g("INIT_UT", -1, "0"), g("INIT_UZ", -1, "0")
    ulon, ulat = g("INIT_ULON", -1, "0"), g("INIT_ULAT", -1, "0")
    even = int(g("INIT_EVENLY", -1, "0"))
    rep = int(g("INIT_REP", -1, "1"))
    m = g("INIT_MASS", -1, "0")
    vmr = g("INIT_VMR", -1, "0")
    bellrad = g("INIT_BELLRAD", -1, "0")
    idx_offset = int(g("INIT_IDX_OFFSET", -1, "0"))
    ens = int(g("INIT_ENS", -1, "0"))

    rng = np.random.default_rng(
        int(s.scan_float("INIT_SEED", -1, "0")) or None)

    def span(a, b, d):
        n = int(np.floor((b - a) / d)) + 1 if b >= a else 0
        return a + d * np.arange(max(n, 0))

    rows = []
    for t in span(t0, t1, dt):
        for z in span(z0, z1, dz):
            for lon in span(lon0, lon1, dlon):
                for lat in span(lat0, lat1, dlat):
                    for _ in range(rep):
                        tt = (t + rng.normal(0, st / FWHM if st > 0 else 0)
                              + ut * (rng.uniform() - 0.5))
                        zz = (z + rng.normal(0, sz / FWHM if sz > 0 else 0)
                              + uz * (rng.uniform() - 0.5))
                        sx_coord = (_dx2deg(sx, lat)
                                    if ctl.met_coord_type == 0 else sx)
                        lo = (lon
                              + rng.normal(0, slon / FWHM if slon > 0
                                           else 0)
                              + rng.normal(0, sx_coord / FWHM
                                           if sx_coord > 0 else 0)
                              + ulon * (rng.uniform() - 0.5))
                        while True:
                            sy = (_dy2deg(sx)
                                  if ctl.met_coord_type == 0 else sx)
                            la = (lat
                                  + rng.normal(0, slat / FWHM if slat > 0
                                               else 0)
                                  + rng.normal(0, sy / FWHM if sy > 0
                                               else 0)
                                  + ulat * (rng.uniform() - 0.5))
                            if not even or rng.uniform() <= abs(
                                    np.cos(np.deg2rad(la))):
                                break
                        rows.append([tt, zz, lo, la])

    if not rows:
        raise SystemExit("Did not create any air parcels!")
    data = np.array(rows)
    n = data.shape[0]
    q = {name: np.zeros(n) for name in ctl.qnt_name}
    if "ens" in q:
        q["ens"][:] = ens
    if bellrad > 0:
        lon_c, lat_c = 0.5 * (lon0 + lon1), 0.5 * (lat0 + lat1)
        rad = _gc_dist(lon_c, lat_c, data[:, 2], data[:, 3])
        keep = rad <= bellrad
        data = data[keep]
        rad = rad[keep]
        n = data.shape[0]
        q = {name: v[keep] for name, v in q.items()}
        bell = 0.5 * (1.0 + np.cos(np.pi * rad / bellrad))
        if "m" in q:
            q["m"] = bell
        if "vmr" in q:
            q["vmr"] = bell
    else:
        if "m" in q:
            q["m"][:] = m / n
        if "vmr" in q:
            q["vmr"][:] = vmr
    if "idx" in q:
        q["idx"] = idx_offset + np.arange(n, dtype=float)
    if "aoa" in q:
        q["aoa"] = data[:, 0]

    write_atm(argv[2], ctl, host_atm(data[:, 0],
                                     P0 * np.exp(-data[:, 1] / H0),
                                     data[:, 2], data[:, 3], q), 0.0)
    return 0


def _dx2deg(dx, lat):
    if abs(lat) > 89.999:
        return 0.0
    return dx * 180.0 / (np.pi * RE * np.cos(np.deg2rad(lat)))


def _dy2deg(dy):
    return dy * 180.0 / (np.pi * RE)


def _gc_dist(lon0, lat0, lon, lat):
    la0, lo0 = np.deg2rad(lat0), np.deg2rad(lon0)
    la, lo = np.deg2rad(lat), np.deg2rad(lon)
    c = (np.sin(la0) * np.sin(la)
         + np.cos(la0) * np.cos(la) * np.cos(lo - lo0))
    return RE * np.arccos(np.clip(c, -1, 1))


if __name__ == "__main__":
    sys.exit(run_tool(main))
