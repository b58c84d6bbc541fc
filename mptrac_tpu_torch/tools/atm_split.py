"""atm_split — split air parcels into a larger set
(reference src/atm_split.c).

Usage: python -m mptrac_tpu_torch.tools.atm_split <ctl> <atm_in>
       <atm_out> [KEY VALUE ...]

Draws SPLIT_N parcels from the input set (mass-weighted when a mass
quantity exists), scattering time/vertical/horizontal positions by
SPLIT_DT/DZ/DX or uniformly within SPLIT_T0..T1 / Z0..Z1 /
LON0..LON1 x LAT0..LAT1, with optional altitude kernel SPLIT_KERNEL and
total mass SPLIT_M (+/- SPLIT_UM jitter).  The draws are numpy's PCG64
seeded by SPLIT_SEED, in the JAX package's order, so that a seeded
split is the same byte for byte.
"""

from __future__ import annotations

import sys

import numpy as np

from mptrac_tpu_torch.config import CtlFile, read_ctl
from mptrac_tpu_torch.constants import H0, P0, RE
from mptrac_tpu_torch.io.atm_io import read_atm, write_atm
from mptrac_tpu_torch.io.kernel import kernel_weight, read_kernel
from mptrac_tpu_torch.tools._cli import (host_atm, host_columns,
                                         require_args, run_tool)

FWHM = 2.3548


def main(argv):
    require_args(argv, 4,
                 "atm_split <ctl> <atm_in> <atm_out> [KEY VALUE ...]")
    ctl = read_ctl(argv[1], argv[2:])
    s = CtlFile(argv[1], argv[2:])
    g = s.scan_float
    n = int(g("SPLIT_N"))
    m = g("SPLIT_M", -1, "-999")
    um = g("SPLIT_UM", -1, "0")
    dt = g("SPLIT_DT", -1, "0")
    t0, t1 = g("SPLIT_T0", -1, "0"), g("SPLIT_T1", -1, "0")
    dz = g("SPLIT_DZ", -1, "0")
    z0, z1 = g("SPLIT_Z0", -1, "0"), g("SPLIT_Z1", -1, "0")
    dx = g("SPLIT_DX", -1, "0")
    lon0, lon1 = g("SPLIT_LON0", -1, "0"), g("SPLIT_LON1", -1, "0")
    lat0, lat1 = g("SPLIT_LAT0", -1, "0"), g("SPLIT_LAT1", -1, "0")
    kernel_file = s.scan_str("SPLIT_KERNEL", -1, "-")

    time, p, lon, lat, q = host_columns(read_atm(argv[2], ctl,
                                                 device="cpu"))
    n_in = time.size

    kz = kw = None
    if kernel_file != "-":
        kz, kw = read_kernel(kernel_file)

    rng = np.random.default_rng(
        int(s.scan_float("SPLIT_SEED", -1, "0")) or None)

    mtot = 0.0
    if "m" in q:
        mtot = float(q["m"].sum())
        mmax = float(q["m"].max())
    if m >= 0:
        mtot = m

    # Select source parcels (mass-weighted rejection like c:120-127)
    if "m" in q and mmax > 0:
        idx = np.empty(n, int)
        for i in range(n):
            while True:
                ip = rng.integers(n_in)
                if rng.uniform() <= q["m"][ip] / mmax:
                    idx[i] = ip
                    break
    else:
        idx = rng.integers(n_in, size=n)

    # Times
    if t1 > t0:
        t_new = t0 + (t1 - t0) * rng.uniform(size=n)
    else:
        t_new = time[idx] + rng.normal(0, dt / FWHM if dt > 0 else 0,
                                       size=n)

    # Vertical positions
    p_new = np.empty(n)
    pmin = P0 * np.exp(-100.0 / H0)
    pmax = P0 * np.exp(1.0 / H0)
    for i in range(n):
        while True:
            if kz is not None:
                while True:
                    z = kz[0] + (kz[-1] - kz[0]) * rng.uniform()
                    k = kernel_weight(kz, kw, P0 * np.exp(-z / H0))
                    if rng.uniform() <= k:
                        break
                p_new[i] = P0 * np.exp(-z / H0)
            elif z1 > z0:
                p_new[i] = P0 * np.exp(
                    -(z0 + (z1 - z0) * rng.uniform()) / H0)
            else:
                dzr = rng.normal(0, dz / FWHM if dz > 0 else 0)
                p_new[i] = p[idx[i]] - dzr * p[idx[i]] / H0
            if pmin <= p_new[i] <= pmax:
                break

    # Horizontal positions
    if lon1 > lon0 and lat1 > lat0:
        lon_new = lon0 + (lon1 - lon0) * rng.uniform(size=n)
        lat_new = lat0 + (lat1 - lat0) * rng.uniform(size=n)
    else:
        if ctl.met_coord_type == 0:
            near_pole = np.abs(lat[idx]) > 89.999
            dxc = np.where(
                near_pole, 0.0,
                dx * 180.0 / (np.pi * RE
                              * np.cos(np.deg2rad(lat[idx]))))
            dyc = np.full(n, dx * 180.0 / (np.pi * RE))
        else:
            dxc = np.full(n, 1000.0 * dx)
            dyc = np.full(n, 1000.0 * dx)
        lon_new = lon[idx] + rng.normal(size=n) * dxc / FWHM
        lat_new = lat[idx] + rng.normal(size=n) * dyc / FWHM

    q_new = {k: v[idx].copy() for k, v in q.items()}
    if "m" in q_new:
        jitter = (um * (rng.uniform(size=n) - 0.5) if um > 0
                  else np.zeros(n))
        q_new["m"] = (mtot + jitter) / n
    if "idx" in q_new:
        q_new["idx"] = np.arange(n, dtype=float)

    write_atm(argv[3], ctl, host_atm(t_new, p_new, lon_new, lat_new,
                                     q_new), 0.0)
    return 0


if __name__ == "__main__":
    sys.exit(run_tool(main))
