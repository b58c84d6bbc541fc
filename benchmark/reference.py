"""The plain reference of what the timed path computes.

Plain PyTorch on the CPU, written from MPTRAC's equations (mptrac.c
module_timesteps, module_position, module_advect, module_diff_turb,
module_diff_meso, module_convection, module_meteo, module_decay,
module_oh_chem, module_h2o2_chem, module_wet_depo, module_dry_depo,
read_met_nc, read_met_polar_winds, read_met_periodic, read_met_pbl)
and from the float32 mode that the configurations state: the fused
path's order (sigma and temperature at the advected position), the
float32 Squares formulation (a 24-bit radius and phase per draw).  It
imports nothing of the program, and no JAX.  Every function takes the
compute ``dtype``: float64 is the reference, bfloat16 the control
(``control.py``).  The model time stays float64 in both, as the
configurations state it.

A step is computed for sampled parcel slots from the state the program
held before it: ``step`` follows the program one step at a time from
the program's own state (see PERF.md).
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from benchmark.checks import RE  # noqa: F401  (MPTRAC's earth radius, km)

H0 = 7.0
P0 = 1013.25
AVO = 6.02214076e23
RI = 8.3144598
MA = 28.9644
MH2O = 18.01528
MO3 = 48.00
YEAR_S = 365.25 * 86400.0
F64 = torch.float64

_DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")

# --------------------------------------------------------------- Squares

SQUARES_KEY = 0xC8E4FD154CE32F6D
_M32 = 0xFFFFFFFF


def _signed(x: int) -> int:
    x &= (1 << 64) - 1
    return x - (1 << 64) if x >= (1 << 63) else x


_KEY = _signed(SQUARES_KEY)


def _rot32(x):
    return ((x >> 32) & _M32) | (x << 32)


def squares(ctr64: torch.Tensor):
    """(hi, lo) 32-bit words of the Squares generator (Widynski 2022)
    at the counters ``ctr64`` (int64 bit patterns; int64 products wrap
    as uint64 ones do, and every right shift is masked)."""
    x = ctr64 * _KEY
    y = x
    z = y + _KEY
    x = _rot32(x * x + y)
    x = _rot32(x * x + z)
    x = _rot32(x * x + y)
    t = x * x + z
    x = _rot32(t)
    r = t ^ (((x * x + y) >> 32) & _M32)
    return (r >> 32) & _M32, r & _M32


def normals3(ctr: int, total: int, slots: torch.Tensor, dtype):
    """[3, m] standard normals of the parcel ``slots`` of a draw of
    three per parcel for ``total`` parcels from counter ``ctr``: the
    draw of (component c, parcel p) at counter ``ctr + c*total + p``,
    the radius from the high word's top 24 bits (floored at 2^-25), the
    phase from the low word's."""
    out = []
    for c in range(3):
        ctr64 = slots.to(torch.int64) + _signed(ctr + c * total)
        hi, lo = squares(ctr64)
        u_r = torch.clamp((hi >> 8).to(F64) * 0.5 ** 24, min=0.5 ** 25)
        u_phi = (lo >> 8).to(F64) * 0.5 ** 24
        u_r, u_phi = u_r.to(dtype), u_phi.to(dtype)
        r = torch.sqrt(-2.0 * torch.log(u_r))
        out.append(r * torch.cos(2.0 * math.pi * u_phi))
    return out


def uniforms(ctr: int, slots: torch.Tensor, dtype):
    """Uniforms in [0, 1) of the parcel ``slots`` of a draw of one per
    parcel from counter ``ctr``: the high word's top 24 bits."""
    hi, _ = squares(slots.to(torch.int64) + _signed(ctr))
    return ((hi >> 8).to(F64) * 0.5 ** 24).to(dtype)


# ------------------------------------------------------------------ met

@dataclass
class Met:
    """A met pair: float64 axes, fields [2, nx, ny(, npl)] in the
    compute dtype, the two snapshot times."""
    times: tuple
    lon: torch.Tensor
    lat: torch.Tensor
    p: torch.Tensor
    f2: Dict[str, torch.Tensor]
    f3: Dict[str, torch.Tensor]

    def astype(self, dtype) -> "Met":
        return Met(self.times, self.lon, self.lat, self.p,
                   {k: v.to(dtype) for k, v in self.f2.items()},
                   {k: v.to(dtype) for k, v in self.f3.items()})


def met_pair(times, lon, lat, p, f2_0, f3_0, f2_1=None, f3_1=None,
             names2=("ps", "pbl", "cape", "pel", "pct", "pcb", "cl"),
             names3=("u", "v", "w", "t", "lwc", "rwc", "iwc", "swc")) -> Met:
    """A pair from two snapshots' numpy fields (the second defaults to
    the first: the steady flow)."""
    f2_1 = f2_0 if f2_1 is None else f2_1
    f3_1 = f3_0 if f3_1 is None else f3_1

    def two(a, b):
        return torch.from_numpy(np.stack([a, b]).astype(np.float32))

    return Met(tuple(float(t) for t in times),
               torch.from_numpy(np.asarray(lon, np.float64)),
               torch.from_numpy(np.asarray(lat, np.float64)),
               torch.from_numpy(np.asarray(p, np.float64)),
               {k: two(f2_0[k], f2_1[k]) for k in names2},
               {k: two(f3_0[k], f3_1[k]) for k in names3})


def _cell(axis: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Cell index of ``x`` on a monotonic float64 axis, clamped to
    [0, n-2]."""
    n = axis.shape[0]
    xx = x.to(F64).contiguous()
    if axis[1] > axis[0]:
        i = torch.searchsorted(axis, xx, right=True) - 1
    else:
        i = torch.searchsorted(-axis, -xx, right=False) - 1
    return torch.clamp(i, 0, n - 2)


@dataclass
class Loc:
    ix: torch.Tensor
    iy: torch.Tensor
    iz: torch.Tensor
    wx: torch.Tensor
    wy: torch.Tensor
    wz: torch.Tensor


def locate(met: Met, lon, lat, p) -> Loc:
    """Cell and weights (of the lower node) of a position: longitude
    wrapped into the periodic grid, latitude clamped (MPTRAC
    intpol_check_lon_lat, locate_irr, locate_reg)."""
    dtype = lon.dtype
    lon2 = torch.fmod(lon, 360.0)
    lon2 = torch.where(lon2 < float(met.lon[0]), lon2 + 360.0, lon2)
    lon2 = torch.where(lon2 > float(met.lon[-1]), lon2 - 360.0, lon2)
    lat2 = torch.clamp(lat, float(met.lat.min()), float(met.lat.max()))
    ix, iy, iz = (_cell(met.lon, lon2), _cell(met.lat, lat2),
                  _cell(met.p, p))

    def w(axis, i, x):
        # the weight from the float64 nodes, rounded to the compute
        # dtype: in bfloat16 neighbouring nodes of a 1-degree grid
        # coincide (359 and 360 round alike), and every weight of their
        # cell would be NaN
        a0, a1 = axis[i], axis[i + 1]
        return ((a1 - x.to(F64)) / (a1 - a0)).to(dtype)

    return Loc(ix, iy, iz, w(met.lon, ix, lon2), w(met.lat, iy, lat2),
               w(met.p, iz, p))


def time_weight(met: Met, time, dtype):
    t0, t1 = met.times
    return ((t1 - time) / (t1 - t0)).to(dtype)


def _lerp(w, a, b):
    return w * (a - b) + b


def interp3(met: Met, name: str, loc: Loc, wt):
    """Trilinear in space, then linear in time, of a 3-D field."""
    f = met.f3[name]

    def g(dx, dy, dz):
        return f[:, loc.ix + dx, loc.iy + dy, loc.iz + dz]

    a00 = _lerp(loc.wz, g(0, 0, 0), g(0, 0, 1))
    a01 = _lerp(loc.wz, g(0, 1, 0), g(0, 1, 1))
    a10 = _lerp(loc.wz, g(1, 0, 0), g(1, 0, 1))
    a11 = _lerp(loc.wz, g(1, 1, 0), g(1, 1, 1))
    v = _lerp(loc.wx, _lerp(loc.wy, a00, a01), _lerp(loc.wy, a10, a11))
    return _lerp(wt, v[0], v[1])


def interp2(met: Met, name: str, loc: Loc, wt):
    """Bilinear in space, then linear in time, of a 2-D field (a corner
    that is not finite takes MPTRAC's nearest-neighbour fallback)."""
    f = met.f2[name]

    def g(dx, dy):
        return f[:, loc.ix + dx, loc.iy + dy]

    a00, a01, a10, a11 = g(0, 0), g(0, 1), g(1, 0), g(1, 1)
    ok = (torch.isfinite(a00) & torch.isfinite(a01) & torch.isfinite(a10)
          & torch.isfinite(a11))
    bil = _lerp(loc.wx, _lerp(loc.wy, a00, a01), _lerp(loc.wy, a10, a11))
    nn = torch.where(loc.wy < 0.5, torch.where(loc.wx < 0.5, a11, a01),
                     torch.where(loc.wx < 0.5, a10, a00))
    v = torch.where(ok, bil, nn)
    both = torch.isfinite(v[0]) & torch.isfinite(v[1])
    return torch.where(both, _lerp(wt, v[0], v[1]),
                       torch.where(wt < 0.5, v[1], v[0]))


def sigma16(met: Met, name: str, loc: Loc):
    """Standard deviation of a field over the cell's 8 corners in both
    snapshots (MPTRAC module_diff_meso's subgrid variance)."""
    f = met.f3[name]
    mean = msq = 0.0
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                for s in (0, 1):
                    v = f[s, loc.ix + dx, loc.iy + dy, loc.iz + dz]
                    mean = mean + v
                    msq = msq + v * v
    var = msq / 16.0 - (mean / 16.0) ** 2
    return torch.where(var > 0, torch.sqrt(torch.clamp(var, min=0.0)),
                       torch.zeros_like(var))


# ---------------------------------------------------------- climatology

@dataclass
class Clim:
    tropo_time: torch.Tensor
    tropo_lat: torch.Tensor
    tropo: torch.Tensor
    zm: Dict[str, tuple]


#: monthly mid-points of the zonal-mean climatologies [s in the year]
ZM_TIME = np.array([1209600.0, 3888000.0, 6393600.0, 9072000.0, 11664000.0,
                    14342400.0, 16934400.0, 19612800.0, 22291200.0,
                    24883200.0, 27561600.0, 30153600.0])


def load_clim(oh_file: Optional[str] = None,
              h2o2_file: Optional[str] = None) -> Clim:
    """The tropopause climatology (the benchmark's copy of MPTRAC's
    NCEP table) and the zonal-mean OH and H2O2 tables named."""
    d = np.load(os.path.join(_DATA, "clim_tropo.npz"))
    zm = {}
    for key, var, path in (("oh", "OH", oh_file), ("h2o2", "H2O2",
                                                    h2o2_file)):
        if path:
            zm[key] = read_zm(path, var)
    return Clim(torch.from_numpy(d["time"].astype(np.float64)),
                torch.from_numpy(d["lat"].astype(np.float64)),
                torch.from_numpy(d["tropo"].astype(np.float64)), zm)


def read_zm(path: str, var: str):
    """(time, lat, p, vmr [time, lat, p]) of a zonal-mean netCDF-3
    file; negative values take the column's first valid level."""
    from scipy.io import netcdf_file
    nc = netcdf_file(path, "r", mmap=False)
    try:
        lat = np.array(nc.variables["lat"][:], np.float64)
        p = np.array(nc.variables["press"][:], np.float64)
        vmr = np.array(nc.variables[var][:], np.float64)   # [t, p, lat]
    finally:
        nc.close()
    bad = vmr < 0
    if bad.any():
        first = np.argmax(~bad, axis=1)
        filled = np.take_along_axis(vmr, first[:, None, :], axis=1)
        vmr = np.where(bad, np.broadcast_to(filled, vmr.shape), vmr)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in
                 (ZM_TIME, lat, p, vmr.transpose(0, 2, 1)))


def _year_sec(time):
    sec = time - torch.floor(time / YEAR_S) * YEAR_S
    return torch.where(sec < 0, sec + YEAR_S, sec)


def clim_tropo(clim: Clim, time, lat):
    """Climatological tropopause pressure [hPa] (MPTRAC clim_tropo)."""
    dtype = lat.dtype
    sec = _year_sec(time)
    isec = _cell(clim.tropo_time, sec)
    la = clim.tropo_lat
    ilat = torch.clamp(torch.floor((lat.to(F64) - la[0]) / (la[1] - la[0]))
                       .to(torch.int64), 0, la.shape[0] - 2)
    tab = clim.tropo.to(dtype)
    wlat = ((lat.to(F64) - la[ilat]) / (la[ilat + 1] - la[ilat])).to(dtype)
    p0 = tab[isec, ilat] + wlat * (tab[isec, ilat + 1] - tab[isec, ilat])
    p1 = tab[isec + 1, ilat] + wlat * (tab[isec + 1, ilat + 1]
                                       - tab[isec + 1, ilat])
    t0 = clim.tropo_time[isec]
    t1 = clim.tropo_time[isec + 1]
    return p0 + (p1 - p0) * ((sec - t0) / (t1 - t0)).to(dtype)


def clim_zm(table, time, lat, p):
    """Zonal-mean climatology (MPTRAC clim_zm): linear in p, latitude
    and the seasonal time (not clamped: extrapolated beyond the monthly
    mid-points), lat and p clamped to the table, floored at 0."""
    ztime, zlat, zp, vmr = table
    dtype = lat.dtype
    sec = _year_sec(time)
    lat_c = torch.clamp(lat, float(zlat[0]), float(zlat[-1]))
    p_c = torch.clamp(p, float(min(zp[0], zp[-1])), float(max(zp[0], zp[-1])))
    isec = _cell(ztime, sec)
    ilat = torch.clamp(torch.floor((lat_c.to(F64) - zlat[0])
                                   / (zlat[1] - zlat[0])).to(torch.int64),
                       0, zlat.shape[0] - 2)
    ip = _cell(zp, p_c)
    v = vmr.to(dtype)

    def frac(axis, i, x):
        # (as ``locate``: the nodes' spacing in float64)
        return ((x.to(F64) - axis[i]) / (axis[i + 1] - axis[i])).to(dtype)

    fp, fl = frac(zp, ip, p_c), frac(zlat, ilat, lat_c)
    aux = []
    for ds in (0, 1):
        for dl in (0, 1):
            y0 = v[isec + ds, ilat + dl, ip]
            aux.append(y0 + (v[isec + ds, ilat + dl, ip + 1] - y0) * fp)
    a0 = aux[0] + (aux[1] - aux[0]) * fl
    a1 = aux[2] + (aux[3] - aux[2]) * fl
    t0, t1 = ztime[isec], ztime[isec + 1]
    out = a0 + (a1 - a0) * ((sec - t0) / (t1 - t0)).to(dtype)
    return torch.clamp(out, min=0.0)


# --------------------------------------------------------------- the step

def dx2deg(dx_km, lat):
    near = (lat < -89.999) | (lat > 89.999)
    den = math.pi * RE * torch.cos(torch.where(near, 0.0, lat)
                                   * (math.pi / 180.0))
    return torch.where(near, 0.0, dx_km * 180.0 / den)


def dy2deg(dy_km):
    return dy_km * 180.0 / (math.pi * RE)


def dz2dp(dz_km, p):
    return -dz_km * p / H0


def position(met: Met, lon, lat, p, time, active):
    """Wrap and reflect the position (MPTRAC module_position): the
    latitude at the poles, the longitude into [-180, 180), the pressure
    at the model top and, below 300 hPa, at the surface pressure of grid
    cell (1, 1) (MPTRAC's own quirk)."""
    dtype = lon.dtype
    lon2 = torch.fmod(lon, 360.0)
    lat2 = torch.fmod(lat, 360.0)
    for _ in range(2):
        over, under = lat2 > 90.0, lat2 < -90.0
        lon2 = torch.where(over | under, lon2 + 180.0, lon2)
        lat2 = torch.where(over, 180.0 - lat2, lat2)
        lat2 = torch.where(under, -180.0 - lat2, lat2)
    for _ in range(3):
        lon2 = torch.where(lon2 < -180.0, lon2 + 360.0, lon2)
        lon2 = torch.where(lon2 >= 180.0, lon2 - 360.0, lon2)
    ptop = float(met.p[-1])
    p2 = torch.where(p < ptop, ptop * ptop / p, p)
    wt = time_weight(met, time, dtype)
    ps = _lerp(wt, met.f2["ps"][0, 1, 1], met.f2["ps"][1, 1, 1])
    p2 = torch.where((p2 > 300.0) & (p2 > ps), ps * ps / p2, p2)
    return (torch.where(active, lon2, lon), torch.where(active, lat2, lat),
            torch.where(active, p2, p))


def _winds(met, lon, lat, p, wt):
    loc = locate(met, lon, lat, p)
    return tuple(interp3(met, k, loc, wt) for k in ("u", "v", "w"))


def tropo_weight(clim, time, lat, p, pt=None):
    if pt is None:
        pt = clim_tropo(clim, time, lat)
    p1 = pt * 0.866877899
    p0 = pt / 0.866877899
    w = (p - p1) / (p0 - p1)
    return torch.where(p > p0, 1.0, torch.where(p < p1, 0.0, w))


def pbl_weight(ctl, p, pbl, ps):
    p1 = pbl - ctl["turb_pbl_trans"] * (ps - pbl)
    p0 = pbl
    w = (p - p1) / torch.where(p0 != p1, p0 - p1, 1.0)
    return torch.where(p > p0, 1.0, torch.where(p < p1, 0.0, w))


def step(ctl: dict, met: Met, clim: Clim, state: dict, t: float, ctr: int,
         total: int, slots: torch.Tensor, dtype=F64) -> dict:
    """One model step at time ``t`` of the parcels ``slots`` (of
    ``total``) from ``state`` (``time`` float64, ``lon``, ``lat``,
    ``p``, ``t``, ``m``, ``u``, ``v``, ``w``), with the random counter
    ``ctr`` at the step's start.  ``ctl`` holds the control parameters
    (a reference module's ``params``)."""
    return step_versions(ctl, met, clim, state, t, ctr, total, slots,
                         dtype)[0]


#: a parcel whose pressure lies within this share of a threshold's (the
#: top of the convective mixing, the top of the dry deposition layer)
#: takes either branch within float32 rounding (PERF.md section 6)
EDGE = 1e-5


def _near(x, edge):
    return torch.abs(x - edge) <= EDGE * torch.abs(edge)


def step_versions(ctl: dict, met: Met, clim: Clim, state: dict, t: float,
                  ctr: int, total: int, slots: torch.Tensor,
                  dtype=F64) -> list:
    """``step``'s result first, then one for each threshold that some
    parcel lies within ``EDGE`` of: the same step with those parcels on
    the threshold's other side (the other parcels as in the first)."""
    time = state["time"].to(F64)
    lon, lat, p = (state[k].to(dtype) for k in ("lon", "lat", "p"))
    q_t, m = state["t"].to(dtype), state["m"].to(dtype)
    uvwp = [state[k].to(dtype) for k in ("u", "v", "w")]

    # time step (module_timesteps)
    active = ((time - ctl["t_start"] >= 0) & (time - ctl["t_stop"] <= 0)
              & (time - t < 0))
    dt64 = torch.where(active, t - time, 0.0)
    dt = dt64.to(dtype)
    tden = met.times[1] - met.times[0]

    lon, lat, p = position(met, lon, lat, p, time, active)

    # midpoint advection, then sigma and T at the new position
    wt0 = time_weight(met, time, dtype)
    u0, v0, w0 = _winds(met, lon, lat, p, wt0)
    half = 0.5 * dt
    xlon = lon + dx2deg(half * u0 / 1000.0, lat)
    xlat = lat + dy2deg(half * v0 / 1000.0)
    xp = p + half * w0
    u1, v1, w1 = _winds(met, xlon, xlat, xp,
                        time_weight(met, time + 0.5 * dt64, dtype))
    nlon = lon + dx2deg(dt * u1 / 1000.0, xlat)
    nlat = lat + dy2deg(dt * v1 / 1000.0)
    np_ = p + dt * w1
    wtf = time_weight(met, time + dt64, dtype)
    locf = locate(met, nlon, nlat, np_)
    temp = interp3(met, "t", locf, wtf)
    sig = [sigma16(met, k, locf) for k in ("u", "v", "w")]
    time = torch.where(active, time + dt64, time)
    lon = torch.where(active, nlon, lon)
    lat = torch.where(active, nlat, lat)
    p = torch.where(active, np_, p)
    del tden

    # turbulent diffusion
    rs = normals3(ctr, total, slots, dtype)
    ctr += 3 * total + 1
    wt = time_weight(met, time, dtype)
    loc = locate(met, lon, lat, p)
    pbl = interp2(met, "pbl", loc, wt)
    ps = interp2(met, "ps", loc, wt)
    ptop = float(met.p[-1])
    pt_clim = clim_tropo(clim, time, lat)

    def kz_at(pp):
        wpbl = pbl_weight(ctl, pp, pbl, ps)
        wtrop = tropo_weight(clim, time, lat, pp, pt_clim) * (1.0 - wpbl)
        wstrat = 1.0 - wpbl - wtrop
        return (wpbl * ctl["turb_dz_pbl"] + wtrop * ctl["turb_dz_trop"]
                + wstrat * ctl["turb_dz_strat"]), wpbl, wtrop, wstrat

    kz, wpbl, wtrop, wstrat = kz_at(p)
    kx = (wpbl * ctl["turb_dx_pbl"] + wtrop * ctl["turb_dx_trop"]
          + wstrat * ctl["turb_dx_strat"])
    adt = torch.abs(dt)
    sig_h = torch.sqrt(2.0 * torch.clamp(kx, min=0.0) * adt)
    do_h = active & (kx > 0)
    lon_t = torch.where(do_h, lon + dx2deg(rs[0] * sig_h / 1000.0, lat), lon)
    lat_t = torch.where(do_h, lat + dy2deg(rs[1] * sig_h / 1000.0), lat)
    sig_z = torch.sqrt(2.0 * torch.clamp(kz, min=0.0) * adt) * 1e-3

    def clip(x):
        return torch.minimum(torch.clamp(x, min=ptop), ps)

    kz_up = kz_at(clip(p + dz2dp(0.01, p)))[0]
    kz_dn = kz_at(clip(p + dz2dp(-0.01, p)))[0]
    w_drift = (kz_up - kz_dn) / 20.0 + kz * (-1.0 / (1e3 * H0))
    dz_tot = rs[2] * sig_z + w_drift * adt * 1e-3
    ptr = p + dz2dp(dz_tot, p)
    for _ in range(10):
        ptr = torch.where(ptr > ps, ps * ps / ptr, ptr)
        ptr = torch.where(ptr < ptop, ptop * ptop / ptr, ptr)
    p = torch.where(active & (kz > 0), clip(ptr), p)
    lon, lat = lon_t, lat_t

    # mesoscale diffusion (AR(1) winds, sigma from the advected cell)
    rs = normals3(ctr, total, slots, dtype)
    ctr += 3 * total + 1
    r = 1.0 - 2.0 * adt / ctl["dt_met"]
    r2 = torch.sqrt(1.0 - r * r)
    new = []
    for c, mult in ((0, ctl["turb_mesox"]), (1, ctl["turb_mesox"]),
                    (2, ctl["turb_mesoz"])):
        if mult > 0:
            x = r * uvwp[c] + r2 * rs[c] * mult * sig[c]
            new.append(torch.where(active, x, uvwp[c]))
        else:
            new.append(uvwp[c])
    if ctl["turb_mesox"] > 0:
        lon, lat = (torch.where(active, lon + dx2deg(new[0] * dt / 1000.0,
                                                     lat), lon),
                    torch.where(active, lat + dy2deg(new[1] * dt / 1000.0),
                                lat))
    if ctl["turb_mesoz"] > 0:
        p = torch.where(active, p + new[2] * dt, p)

    # convection
    edge_c = None
    if ctl["conv_mix_pbl"] or ctl["conv_cape"] >= 0:
        rs1 = uniforms(ctr, slots, dtype)
        ctr += total + 1
        loc = locate(met, lon, lat, p)
        ps = interp2(met, "ps", loc, wt)
        pbot = ptop_c = ps
        if ctl["conv_mix_pbl"]:
            pbl = interp2(met, "pbl", loc, wt)
            ptop_c = pbl - ctl["conv_pbl_trans"] * (ps - pbl)
        if ctl["conv_cape"] >= 0:
            cape = interp2(met, "cape", loc, wt)
            trig = torch.isfinite(cape) & (cape >= ctl["conv_cape"])
            pel = interp2(met, "pel", loc, wt)
            ptop_c = torch.where(trig, torch.minimum(ptop_c, pel), ptop_c)
        can = active & (ptop_c != pbot)
        mix = can & (p >= ptop_c)
        tbot = interp3(met, "t", locate(met, lon, lat, pbot), wt)
        ttop = interp3(met, "t", locate(met, lon, lat, ptop_c), wt)
        rb, rt = pbot / tbot, ptop_c / ttop
        rho = rb + (rt - rb) * rs1
        pn = pbot + (ptop_c - pbot) / torch.where(rt != rb, rt - rb, 1.0) * (
            rho - rb)
        edge_c = can & _near(p, ptop_c)
        p, p_flip = torch.where(mix, pn, p), torch.where(mix, p, pn)

    def rest(p):
        return _step_rest(ctl, met, clim, time, lon, lat, p, temp, m,
                          active, dt, wt, new)

    out = rest(p)
    if edge_c is not None and bool(edge_c.any()):
        out += rest(torch.where(edge_c, p_flip, p))
    return out


def _step_rest(ctl, met, clim, time, lon, lat, p, temp, m, active, dt, wt,
               new) -> list:
    """The step after the convection: the position, the meteo, decay,
    chemistry and deposition; a second result where some parcel lies at
    the top of the dry deposition layer."""
    lon, lat, p = position(met, lon, lat, p, time, active)

    # meteo: the temperature sampled at the advected position
    q_t = temp

    # exponential decay
    if ctl["tdec_trop"] > 0 and ctl["tdec_strat"] > 0:
        w = tropo_weight(clim, time, lat, p)
        tdec = w * ctl["tdec_trop"] + (1.0 - w) * ctl["tdec_strat"]
        m = torch.where(active, m * torch.exp(-dt / tdec), m)

    def loss(m, rate):
        return torch.where(active, m * torch.exp(-dt * rate), m)

    loc = locate(met, lon, lat, p)
    tt = interp3(met, "t", loc, wt)
    mdens = AVO * 1e-6 * (p * 100.0) / (RI * tt)
    if ctl["oh_chem_reaction"] == 3:
        a, b, c, d = ctl["oh_chem"]
        k0 = a * ((298.0 / tt) ** b if b != 0 else 1.0)
        ki = c * ((298.0 / tt) ** d if d != 0 else 1.0)
        lg = torch.log10(k0 * mdens / ki)
        k = k0 * mdens / (1.0 + k0 * mdens / ki) * 0.6 ** (1.0 / (1.0 + lg * lg))
        m = loss(m, k * clim_zm(clim.zm["oh"], time, lat, p) * mdens)
    elif ctl["oh_chem_reaction"] != 0:
        raise NotImplementedError("OH_CHEM_REACTION other than 3")
    if ctl["h2o2_chem_reaction"] != 0:
        lwc = interp3(met, "lwc", loc, wt)
        rwc = interp3(met, "rwc", loc, wt)
        k = 9.1e7 * torch.exp(-29700.0 / RI * (1.0 / tt - 1.0 / 298.15))
        h_so2 = 1.3e-2 * torch.exp(2900.0 * (1.0 / tt - 1.0 / 298.15)) * RI * tt
        k_1s = 1.23e-2 * torch.exp(2.01e3 * (1.0 / tt - 1.0 / 298.15))
        h_h2o2 = 8.3e2 * torch.exp(7600.0 * (1.0 / tt - 1.0 / 298.15)) * RI * tt
        h2o2 = (h_h2o2 * clim_zm(clim.zm["h2o2"], time, lat, p) * mdens
                * 1000.0 / AVO)
        cwc = (lwc + rwc) * (p / (RI * tt) * MA / 10.0) / 1e3
        rate = torch.where((lwc > 0) | (rwc > 0),
                           k * k_1s * h2o2 * h_so2 * cwc, 0.0)
        m = loss(m, rate)
    if ctl["wet_depo_ic_a"] > 0 and ctl["wet_depo_bc_a"] > 0:
        pct = interp2(met, "pct", loc, wt)
        cl = interp2(met, "cl", loc, wt)
        below = torch.isfinite(pct) & (p > pct)
        pre0, pre1 = ctl["wet_depo_pre"]
        is_ = (torch.clamp(cl, min=0.0) / pre0) ** (1.0 / pre1)
        inside = None
        for name in ("lwc", "rwc", "iwc", "swc"):
            x = interp3(met, name, loc, wt) > 0
            inside = x if inside is None else inside | x
        eta_ic = torch.where(tt > 273.15, 1.0, torch.where(
            tt <= 238.15, ctl["wet_depo_ic_ret_ratio"],
            1.0 + (ctl["wet_depo_ic_ret_ratio"] - 1.0) * (273.15 - tt)
            / (273.15 - 238.15)))
        lam_ic = ctl["wet_depo_ic_a"] * is_ ** ctl["wet_depo_ic_b"] * eta_ic
        eta_bc = torch.where(tt > 270.0, 1.0, ctl["wet_depo_bc_ret_ratio"])
        lam_bc = ctl["wet_depo_bc_a"] * is_ ** ctl["wet_depo_bc_b"] * eta_bc
        lam = torch.where(below & (is_ >= 0.01),
                          torch.where(inside, lam_ic, lam_bc), 0.0)
        m = loss(m, lam)
    elif ctl["wet_depo_ic_a"] > 0 or ctl["wet_depo_bc_a"] > 0:
        raise NotImplementedError("wet deposition by Henry's law")
    m_flip = None
    if ctl["dry_depo_vdep"] > 0:
        ps = interp2(met, "ps", loc, wt)
        dz = 1000.0 * H0 * (torch.log(P0 / (ps - ctl["dry_depo_dp"]))
                            - torch.log(P0 / ps))
        layer = p >= ps - ctl["dry_depo_dp"]
        rate = ctl["dry_depo_vdep"] / dz
        edge_d = active & _near(p, ps - ctl["dry_depo_dp"])
        if bool(edge_d.any()):
            m_flip = torch.where(edge_d, loss(m, torch.where(
                layer, 0.0, rate)), loss(m, torch.where(layer, rate, 0.0)))
        m = loss(m, torch.where(layer, rate, 0.0))

    out = [{"time": time, "lon": lon, "lat": lat, "p": p, "t": q_t, "m": m,
            "u": new[0], "v": new[1], "w": new[2]}]
    if m_flip is not None:
        out.append(dict(out[0], m=m_flip))
    return out



# ------------------------------------------------------------ met ingest

def ingest_nc(path: str, dtype=torch.float32) -> dict:
    """What MPTRAC's reader derives from one netCDF met file for the
    fields the step uses: u, v, w, t on the levels with the pole rows
    averaged from the 89-degree rows and the periodic column appended,
    the surface pressure, and the boundary-layer pressure of MET_PBL 3
    (the level where the potential temperature exceeds the surface's by
    2 K, clamped to 0.1-5 km above the surface).  Arithmetic in float64
    and, for the control, every step rounded to ``dtype``; the result
    in float32 as the program holds it."""
    from scipy.io import netcdf_file
    nc = netcdf_file(path, "r", mmap=False)
    try:
        v = nc.variables
        lon = np.array(v["lon"][:], np.float64)
        lat = np.array(v["lat"][:], np.float64)
        p = np.array(v["lev"][:], np.float64) / 100.0

        def field(name, scale=1.0):
            a = np.array(v[name][:], np.float64)[0]
            a = _round(a * scale, dtype)
            # [lev, lat, lon] or [lat, lon] -> [lon, lat(, lev)]
            return np.ascontiguousarray(a.T)

        u, vv, w, t = (field("u"), field("v"), field("w", 0.01),
                       field("t"))
        ps, ts = field("sp", 0.01), field("t2m")
    finally:
        nc.close()
    f3 = {"u": u, "v": vv, "w": w, "t": t}
    # pole rows from the 89-degree rows
    if abs(lat[0]) >= 89.999 and abs(lat[-1]) >= 89.999:
        nx = lon.size
        for i89, i90 in ((1, 0), (lat.size - 2, lat.size - 1)):
            sign = -1.0 if lat[i90] < 0 else 1.0
            clon = np.cos(sign * math.pi / 180.0 * lon)[:, None]
            slon = np.sin(sign * math.pi / 180.0 * lon)[:, None]
            u89, v89 = f3["u"][:, i89, :], f3["v"][:, i89, :]
            velx = _round(np.sum(u89 * clon - v89 * slon, axis=0) / nx, dtype)
            vely = _round(np.sum(u89 * slon + v89 * clon, axis=0) / nx, dtype)
            f3["u"][:, i90, :] = _round(velx[None] * clon + vely[None] * slon,
                                        dtype)
            f3["v"][:, i90, :] = _round(-velx[None] * slon + vely[None] * clon,
                                        dtype)
    # the periodic column
    if abs(lon[-1] - lon[0] + lon[1] - lon[0] - 360.0) < 0.01:
        lon = np.append(lon, lon[-1] + lon[1] - lon[0])
        f3 = {k: np.concatenate([a, a[:1]], axis=0) for k, a in f3.items()}
        ps = np.concatenate([ps, ps[:1]], axis=0)
        ts = np.concatenate([ts, ts[:1]], axis=0)
    # MET_PBL 3
    ps64, ts64 = ps.astype(np.float64), ts.astype(np.float64)
    th0 = _round(ts64 * (1000.0 / ps64) ** 0.286, dtype)
    th = _round(f3["t"].astype(np.float64)
                * (1000.0 / p[None, None, :]) ** 0.286, dtype)
    cond = (p[None, None, :] >= 300.0) & ((p[None, None, :] > ps64[..., None])
                                          | (th <= th0[..., None] + 2.0))
    npl = p.size
    idx = np.arange(npl - 2, 0, -1)
    sub = cond[..., idx]
    ip = np.where(np.any(sub, axis=-1), idx[0] - np.argmax(sub, axis=-1), 0)
    th_lo = np.take_along_axis(th, ip[..., None] + 1, -1)[..., 0]
    th_hi = np.take_along_axis(th, ip[..., None], -1)[..., 0]
    p_lo, p_hi = p[ip + 1], p[ip]
    pbl = _round(p_lo + (p_hi - p_lo) / np.where(th_hi != th_lo,
                                                 th_hi - th_lo, 1e-30)
                 * (th0 + 2.0 - th_lo), dtype)
    pbl_min = _round(ps64 * np.exp(-0.1 / H0), dtype)
    pbl = np.where((pbl > pbl_min) | (p[ip] > ps64), pbl_min, pbl)
    pbl = _round(pbl, torch.float32)
    lo = _round(ps64 * np.exp(-0.1 / H0), dtype)
    hi = _round(ps64 * np.exp(-5.0 / H0), dtype)
    pbl = np.maximum(np.minimum(pbl, lo), hi)
    f32 = np.float32
    return {"lon": lon, "lat": lat, "p": p,
            "f3": {k: a.astype(f32) for k, a in f3.items()},
            "f2": {"ps": ps.astype(f32), "pbl": pbl.astype(f32)}}


def _round(a: np.ndarray, dtype) -> np.ndarray:
    """``a`` rounded to ``dtype`` and back to float64 (float64: as it
    is)."""
    if dtype == torch.float64:
        return np.asarray(a, np.float64)
    return torch.from_numpy(np.asarray(a, np.float64)).to(dtype).to(
        F64).numpy()
