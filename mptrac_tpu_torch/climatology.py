"""Climatological data: built-in tropopause table, zonal means,
photolysis rates, time series.

Counterpart of the JAX package's ``climatology.py`` (reference
clim_tropo/clim_tropo_init, mptrac.c:213-396, clim_zm c:407, clim_ts
c:396, mptrac_read_clim c:6406, read_clim_photo c:8250, read_clim_zm
c:8423, read_clim_ts c:8369).  The NCEP/NCAR tropopause climatology and
the other climatology files ship as data assets of this package
(``data/``).  The readers run on the host with numpy; the tables are
placed on ``device``.

One deliberate difference: a file that the control parameters name and
that is missing raises ``FileNotFoundError`` naming it, where the JAX
reader skips it silently and a later module fails on the absent table.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from mptrac_tpu_torch.config import Ctl
from mptrac_tpu_torch.ops.interp import locate_irr, locate_reg
from mptrac_tpu_torch.types import Clim, ClimTs, ClimZm, resolve_device

_DATA = os.path.join(os.path.dirname(__file__), "data")

_YEAR_S = 365.25 * 86400.0


def load_clim_tropo():
    d = np.load(os.path.join(_DATA, "clim_tropo.npz"))
    return d["time"], d["lat"], d["tropo"]


def _require_file(filename: str, what: str) -> None:
    if not os.path.exists(filename):
        raise FileNotFoundError(
            f"climatology file {filename} ({what}) is named by the "
            "control parameters but does not exist")


def read_clim(ctl: Ctl, device="cuda") -> Clim:
    """Load climatological data per control parameters (reference
    mptrac_read_clim, c:6406).  Photolysis, zonal-mean and time-series
    files are loaded only when the corresponding modules or quantities
    are enabled.  A file name of ``-`` leaves the table absent; a named
    file that is missing raises."""
    dev = resolve_device(device)

    def dv(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    t, lat, tropo = load_clim_tropo()
    zm, ts, photo = {}, {}, {}
    photo_p = photo_sza = photo_o3c = np.zeros(1)

    def named(filename):
        return bool(filename) and filename != "-"

    if (ctl.tracer_chem or ctl.kpp_chem) and named(ctl.clim_photo):
        photo_p, photo_sza, photo_o3c, photo = read_clim_photo(
            ctl.clim_photo)
    # (the reference's diurnal normalization of OH is applied in the OH
    # chemistry module, as in the JAX package)
    for key, varname, filename, wanted in (
            ("oh", "OH", ctl.clim_oh_filename, ctl.oh_chem_reaction != 0),
            ("h2o2", "H2O2", ctl.clim_h2o2_filename,
             ctl.h2o2_chem_reaction != 0),
            ("o1d", "O1D", ctl.clim_o1d_filename, bool(ctl.tracer_chem)),
            ("hno3", "HNO3", ctl.clim_hno3_filename,
             any(q in ctl.qnt_name for q in ("tnat", "tsts", "hno3")))):
        if wanted and named(filename):
            z = read_clim_zm(filename, varname)
            zm[key] = ClimZm(time=dv(z["time"]), lat=dv(z["lat"]),
                             p=dv(z["p"]), vmr=dv(z["vmr"]))
    for key, fname in (("ccl4", ctl.clim_ccl4_timeseries),
                       ("ccl3f", ctl.clim_ccl3f_timeseries),
                       ("ccl2f2", ctl.clim_ccl2f2_timeseries),
                       ("n2o", ctl.clim_n2o_timeseries),
                       ("sf6", ctl.clim_sf6_timeseries)):
        if named(fname):
            tt, vv = read_clim_ts(fname)
            ts[key] = ClimTs(time=dv(tt), vmr=dv(vv))

    return Clim(
        tropo_time=dv(t), tropo_lat=dv(lat), tropo=dv(tropo),
        photo_p=dv(photo_p), photo_sza=dv(photo_sza),
        photo_o3c=dv(photo_o3c),
        photo={k: dv(v) for k, v in photo.items()}, zm=zm, ts=ts)


def read_clim_photo(filename: str):
    """Photolysis rate table (reference read_clim_photo, c:8250):
    (p, sza, o3c, dict of rates [np, nsza, no3c]) as numpy arrays."""
    from scipy.io import netcdf_file
    _require_file(filename, "photolysis rates")
    nc = netcdf_file(filename, mmap=False)
    try:
        v = nc.variables
        p = np.array(v["press"][:], np.float64)
        sza = np.array(v["sza"][:], np.float64)
        o3c = np.array(v["total_o3col"][:], np.float64)
        rates = {}
        for name, var in (("ccl4", "J_CCl4"), ("ccl3f", "J_CFC-11"),
                          ("ccl2f2", "J_CFC-12"), ("n2o", "J_N2O"),
                          ("o2", "J_O2"), ("o3_1", "J_O3b"),
                          ("o3_2", "J_O3a"), ("h2o2", "J_H2O2"),
                          ("h2o", "J_H2O")):
            if var in v:
                rates[name] = np.array(v[var][:], np.float64)
        return p, sza, o3c, rates
    finally:
        nc.close()


#: fixed monthly-mean time grid [s since year start]
#: (reference read_clim_zm, c:8455-8467: the same midpoints as the
#: tropopause table)
ZM_TIME = np.array([
    1209600.00, 3888000.00, 6393600.00, 9072000.00, 11664000.00,
    14342400.00, 16934400.00, 19612800.00, 22291200.00, 24883200.00,
    27561600.00, 30153600.00])


def read_clim_zm(filename: str, varname: str):
    """Zonal-mean monthly climatology (reference read_clim_zm, c:8423):
    fixed monthly time grid, descending pressure, ascending latitude;
    negative values (data gaps) filled from the nearest valid level.
    Returns a dict of numpy arrays time, lat, p, vmr [ntime, nlat, np]."""
    from mptrac_tpu_torch.io.hdf5 import open_netcdf_any
    _require_file(filename, f"{varname} zonal mean")
    v, nc = open_netcdf_any(filename)
    try:
        lat = np.array(v["lat"][:], np.float64)
        p = np.array(v["press"][:], np.float64)
        if p[0] < p[1]:
            raise ValueError("Pressure data are not descending!")
        if lat[0] > lat[1]:
            raise ValueError("Latitude data are not ascending!")
        vmr = np.array(v[varname][:], np.float64)     # [ntime, np, nlat]
        # Fill data gaps per (time, lat) column from valid levels
        bad = vmr < 0
        if bad.any():
            first_valid = np.argmax(~bad, axis=1)           # [nt, nlat]
            filled = np.take_along_axis(
                vmr, first_valid[:, None, :], axis=1)
            vmr = np.where(bad, np.broadcast_to(filled, vmr.shape), vmr)
        vmr = vmr.transpose(0, 2, 1)                  # -> [ntime, nlat, np]
        return dict(time=ZM_TIME.copy(), lat=lat, p=p, vmr=vmr)
    finally:
        if hasattr(nc, "close"):
            nc.close()


def read_clim_ts(filename: str):
    """Time series of yearly mean vmr from an ASCII file (reference
    read_clim_ts, c:8369): rows of ``year vmr``.  Returns (time [s],
    vmr) as numpy arrays."""
    _require_file(filename, "time series")
    times, vmrs = [], []
    with open(filename) as f:
        for line in f:
            toks = line.split()
            if len(toks) >= 2:
                try:
                    year = float(toks[0])
                    vmr = float(toks[1])
                except ValueError:
                    continue
                times.append((year - 2000.0) * _YEAR_S)
                vmrs.append(vmr)
    return np.asarray(times, np.float64), np.asarray(vmrs, np.float64)


def clim_tropo(clim: Clim, t, lat):
    """Climatological tropopause pressure [hPa] (reference clim_tropo,
    c:213).  ``t`` and ``lat`` are tensors of one shape (or ``lat`` a
    Python float).  The JAX package selects the four table corners
    with one-hot products because its device cannot gather; each
    product picks exactly one entry, so plain indexing gives the same
    values."""
    sec = t - torch.floor(t / _YEAR_S) * _YEAR_S
    sec = torch.where(sec < 0, sec + _YEAR_S, sec)
    if not isinstance(lat, torch.Tensor):
        lat = torch.full_like(sec, lat, dtype=clim.tropo_lat.dtype)
    isec = locate_irr(clim.tropo_time, sec)
    ilat = locate_reg(clim.tropo_lat, lat)
    la0 = clim.tropo_lat[ilat]
    la1 = clim.tropo_lat[ilat + 1]
    wlat = (lat - la0) / (la1 - la0)
    p00 = clim.tropo[isec, ilat]
    p01 = clim.tropo[isec, ilat + 1]
    p10 = clim.tropo[isec + 1, ilat]
    p11 = clim.tropo[isec + 1, ilat + 1]
    p0 = p00 + wlat * (p01 - p00)
    p1 = p10 + wlat * (p11 - p10)
    t0 = clim.tropo_time[isec]
    t1 = clim.tropo_time[isec + 1]
    out = p0 + (p1 - p0) / (t1 - t0) * (sec - t0)
    # fp32 mode: follow the caller's latitude dtype (f64 is a no-op)
    return out.to(lat.dtype)


def clim_tropo_np(clim, t, lat):
    """Host-side scalar/vector version for met preprocessing."""
    tt, la, tr = load_clim_tropo()
    sec = t - np.floor(t / _YEAR_S) * _YEAR_S
    if sec < 0:
        sec += _YEAR_S
    isec = np.clip(np.searchsorted(tt, sec, side="right") - 1, 0, 10)
    ilat = np.clip(((lat - la[0]) / (la[1] - la[0])).astype(int)
                   if np.ndim(lat) else int((lat - la[0]) / (la[1] - la[0])),
                   0, 71)
    wlat = (lat - la[ilat]) / (la[ilat + 1] - la[ilat])
    p0 = tr[isec, ilat] * (1 - wlat) + tr[isec, ilat + 1] * wlat
    p1 = tr[isec + 1, ilat] * (1 - wlat) + tr[isec + 1, ilat + 1] * wlat
    w = (sec - tt[isec]) / (tt[isec + 1] - tt[isec])
    return p0 * (1 - w) + p1 * w


def _year_seconds(t):
    sec = t - torch.floor(t / _YEAR_S) * _YEAR_S
    return torch.where(sec < 0, sec + _YEAR_S, sec)


def clim_zm(zm: ClimZm, t, lat, p):
    """Zonal-mean climatology lookup (reference clim_zm, c:414-464):
    lat/p are clamped to the table range; the seasonal time axis is NOT
    clamped: the reference linearly extrapolates beyond the monthly
    midpoints."""
    sec = _year_seconds(t)
    lat_c = torch.clamp(lat, zm.lat[0], zm.lat[-1])
    p_c = torch.clamp(p, torch.minimum(zm.p[0], zm.p[-1]),
                      torch.maximum(zm.p[0], zm.p[-1]))
    isec = locate_irr(zm.time, sec)
    ilat = locate_reg(zm.lat, lat_c)
    ip = locate_irr(zm.p, p_c)

    def lin(x0, y0, x1, y1, x):
        return y0 + (y1 - y0) / (x1 - x0) * (x - x0)

    aux = []
    for ds in (0, 1):
        for dl in (0, 1):
            aux.append(lin(zm.p[ip], zm.vmr[isec + ds, ilat + dl, ip],
                           zm.p[ip + 1], zm.vmr[isec + ds, ilat + dl, ip + 1],
                           p_c))
    a00 = lin(zm.lat[ilat], aux[0], zm.lat[ilat + 1], aux[1], lat_c)
    a10 = lin(zm.lat[ilat], aux[2], zm.lat[ilat + 1], aux[3], lat_c)
    out = lin(zm.time[isec], a00, zm.time[isec + 1], a10, sec)
    return torch.clamp(out, min=0.0).to(lat.dtype)


def clim_ts(ts: ClimTs, t):
    """Interpolate a climatological time series (reference clim_ts,
    c:396): clamped linear interpolation in time."""
    tc = torch.clamp(t, ts.time[0], ts.time[-1])
    i = locate_irr(ts.time, tc)
    return (ts.vmr[i] + (ts.vmr[i + 1] - ts.vmr[i])
            / (ts.time[i + 1] - ts.time[i]) * (tc - ts.time[i]))
