"""Shared met-field sampling for the met_* tools.

Evaluates the standard 52-variable record (reference MET_HEADER,
mptrac.h:1182-1243 and INTPOL_SPACE_ALL, h:1020) at arbitrary
(p, lon, lat) points of a single met snapshot, plus climatology-based
quantities.  Used by met_map, met_prof, met_zm and met_sample.  The
points are sampled where the snapshot lives (``met.lon.device``), in
float64, with the JAX package's arithmetic for each point; the results
come back to the host as numpy arrays.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from mptrac_tpu_torch import climatology as cl
from mptrac_tpu_torch.config import Ctl
from mptrac_tpu_torch.ops import interp, thermo
from mptrac_tpu_torch.types import Clim, Met

MET_HEADER = (
    "# $1 = time [s]\n# $2 = altitude [km]\n# $3 = longitude [deg]\n"
    "# $4 = latitude [deg]\n# $5 = pressure [hPa]\n"
    "# $6 = temperature [K]\n# $7 = zonal wind [m/s]\n"
    "# $8 = meridional wind [m/s]\n# $9 = vertical velocity [hPa/s]\n"
    "# $10 = H2O volume mixing ratio [ppv]\n"
    "# $11 = O3 volume mixing ratio [ppv]\n"
    "# $12 = geopotential height [km]\n"
    "# $13 = potential vorticity [PVU]\n"
    "# $14 = surface pressure [hPa]\n# $15 = surface temperature [K]\n"
    "# $16 = surface geopotential height [km]\n"
    "# $17 = surface zonal wind [m/s]\n"
    "# $18 = surface meridional wind [m/s]\n"
    "# $19 = eastward turbulent surface stress [N/m^2]\n"
    "# $20 = northward turbulent surface stress [N/m^2]\n"
    "# $21 = surface sensible heat flux [W/m^2]\n"
    "# $22 = land-sea mask [1]\n# $23 = sea surface temperature [K]\n"
    "# $24 = tropopause pressure [hPa]\n"
    "# $25 = tropopause geopotential height [km]\n"
    "# $26 = tropopause temperature [K]\n"
    "# $27 = tropopause water vapor [ppv]\n"
    "# $28 = cloud liquid water content [kg/kg]\n"
    "# $29 = cloud rain water content [kg/kg]\n"
    "# $30 = cloud ice water content [kg/kg]\n"
    "# $31 = cloud snow water content [kg/kg]\n"
    "# $32 = cloud cover [1]\n"
    "# $33 = total column cloud water [kg/m^2]\n"
    "# $34 = cloud top pressure [hPa]\n"
    "# $35 = cloud bottom pressure [hPa]\n"
    "# $36 = pressure at lifted condensation level (LCL) [hPa]\n"
    "# $37 = pressure at level of free convection (LFC) [hPa]\n"
    "# $38 = pressure at equilibrium level (EL) [hPa]\n"
    "# $39 = convective available potential energy (CAPE) [J/kg]\n"
    "# $40 = convective inhibition (CIN) [J/kg]\n"
    "# $41 = relative humidity over water [%]\n"
    "# $42 = relative humidity over ice [%]\n"
    "# $43 = dew point temperature [K]\n"
    "# $44 = frost point temperature [K]\n"
    "# $45 = NAT temperature [K]\n"
    "# $46 = HNO3 volume mixing ratio [ppv]\n"
    "# $47 = OH volume mixing ratio [ppv]\n"
    "# $48 = H2O2 volume mixing ratio [ppv]\n"
    "# $49 = HO2 volume mixing ratio [ppv]\n"
    "# $50 = O(1D) volume mixing ratio [ppv]\n"
    "# $51 = boundary layer pressure [hPa]\n"
    "# $52 = total column ozone [DU]\n"
    "# $53 = number of data points\n"
    "# $54 = number of tropopause data points\n"
    "# $55 = number of CAPE data points\n")

#: 3-D fields sampled by INTPOL_SPACE_ALL, in record order
_F3 = ("t", "u", "v", "w", "h2o", "o3", "z", "pv", "lwc", "rwc", "iwc",
       "swc", "cc")
_F2 = ("ps", "ts", "zs", "us", "vs", "ess", "nss", "shf", "lsm", "sst",
       "pt", "zt", "tt", "h2ot", "cl", "pct", "pcb", "plcl", "plfc",
       "pel", "cape", "cin", "pbl", "o3c")


def _points(met: Met, *arrays):
    dev = met.lon.device
    return [torch.as_tensor(np.asarray(a, np.float64), device=dev)
            for a in arrays]


def sample_met(ctl: Ctl, clim: Clim, met: Met, p, lon, lat
               ) -> Dict[str, np.ndarray]:
    """Sample all standard variables at point arrays (p, lon, lat) on the
    snapshot's device; ``clim`` lies there too."""
    p, lon, lat = _points(met, p, lon, lat)
    loc = interp.locate_3d(met, lon, lat, p)
    out: Dict[str, torch.Tensor] = {}
    for name in _F3:
        out[name] = interp.interp_3d(met.fields3d[name], loc)
    for name in _F2:
        out[name] = interp.interp_2d(met.fields2d[name], loc)
    del loc
    t = out["t"]
    h2o = out["h2o"]
    out["rh"] = thermo.rh(p, t, h2o)
    out["rhice"] = thermo.rhice(p, t, h2o)
    out["tdew"] = thermo.tdew(p, h2o)
    out["tice"] = thermo.tice(p, h2o)
    tj = torch.full_like(lon, float(met.time))
    latr = lat if ctl.met_coord_type == 0 else torch.full_like(
        lat, ctl.met_utm_ref_lat)
    hno3 = (cl.clim_zm(clim.zm["hno3"], tj, latr, p)
            if "hno3" in clim.zm else torch.zeros_like(p))
    out["hno3"] = hno3
    out["tnat"] = thermo.nat_temperature(p, h2o, hno3)
    for key in ("oh", "h2o2", "ho2", "o1d"):
        if key == "oh" and "oh" in clim.zm:
            from mptrac_tpu_torch.physics.chem import clim_oh
            out[key] = clim_oh(ctl, clim, tj, lon, lat, p)
        elif key in clim.zm:
            out[key] = cl.clim_zm(clim.zm[key], tj, latr, p)
        else:
            out[key] = torch.zeros_like(p)
    return {k: v.cpu().numpy() for k, v in out.items()}


def find_theta_level(met: Met, theta: float, lon, lat) -> np.ndarray:
    """Bisect the pressure of an isentropic level (reference
    met_map.c:243-255): 60 halvings on the snapshot's device."""
    lon, lat = _points(met, lon, lat)
    ptop = torch.full(lon.shape, float(met.p[-1]), dtype=torch.float64,
                      device=lon.device)
    pbot = torch.full(lon.shape, float(met.p[0]), dtype=torch.float64,
                      device=lon.device)
    for _ in range(60):
        p0 = 0.5 * (ptop + pbot)
        loc = interp.locate_3d(met, lon, lat, p0)
        t0 = interp.interp_3d(met.fields3d["t"], loc)
        th = thermo.theta(p0, t0)
        above = th > theta
        ptop = torch.where(above, p0, ptop)
        pbot = torch.where(above, pbot, p0)
    return (0.5 * (ptop + pbot)).cpu().numpy()


def record_columns(time, zcol, lon, lat, p, s, npts=1, npt=1, npc=1):
    """Assemble the 55-column record values in MET_HEADER order."""
    return [time, zcol, lon, lat, p,
            s["t"], s["u"], s["v"], s["w"], s["h2o"], s["o3"], s["z"],
            s["pv"], s["ps"], s["ts"], s["zs"], s["us"], s["vs"],
            s["ess"], s["nss"], s["shf"], s["lsm"], s["sst"], s["pt"],
            s["zt"], s["tt"], s["h2ot"], s["lwc"], s["rwc"], s["iwc"],
            s["swc"], s["cc"], s["cl"], s["pct"], s["pcb"], s["plcl"],
            s["plfc"], s["pel"], s["cape"], s["cin"], s["rh"],
            s["rhice"], s["tdew"], s["tice"], s["tnat"], s["hno3"],
            s["oh"], s["h2o2"], s["ho2"], s["o1d"], s["pbl"], s["o3c"],
            npts, npt, npc]


def write_records(out, cols, counts, chunk: int = 65536):
    """Write rows of the record: ``cols`` are record_columns' first 52
    entries as arrays of one length (or scalars), ``counts`` its three
    counts.  Each row is the one that ``"%.2f " % cols[0]`` and ``"%g"``
    of every other value give, formatted a block of rows at a time."""
    n = max(np.size(c) for c in cols[:52])
    table = np.empty((n, 52))
    for k, c in enumerate(cols[:52]):
        table[:, k] = c
    fmt = "%.2f " + " ".join(["%g"] * 51) + " %d %d %d\n" % tuple(counts)
    for s in range(0, n, chunk):
        out.write("".join(fmt % tuple(r)
                          for r in table[s:s + chunk].tolist()))
