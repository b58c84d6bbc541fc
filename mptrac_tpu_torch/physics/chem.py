"""Chemistry: the initialisation of the chemistry quantities and the OH
climatology with its diurnal correction.

Counterpart of the JAX package's ``physics/chem.py:34-114`` (reference
cos_sza c:1857, clim_oh c:89-124, module_chem_init c:4050-4094).  The
chemistry modules themselves (chemistry grid, OH / H2O2 / tracer
chemistry, photolysis lookup) are not ported yet;
``pipeline.run_timestep`` raises when the control parameters enable one.
"""

from __future__ import annotations

import math

import torch

from mptrac_tpu_torch import climatology as cl
from mptrac_tpu_torch.config import Ctl
from mptrac_tpu_torch.ops import interp
from mptrac_tpu_torch.ops.thermo import deg2rad
from mptrac_tpu_torch.types import Atm, Clim, Met


def cos_sza(sec, lon, lat):
    """Cosine of the solar zenith angle (reference cos_sza, c:1857)."""
    D = sec / 86400.0 - 0.5
    g = deg2rad(357.529 + 0.98560028 * D)
    q = 280.459 + 0.98564736 * D
    L = deg2rad(q + 1.915 * torch.sin(g) + 0.020 * torch.sin(2 * g))
    e = deg2rad(23.439 - 0.00000036 * D)
    sindec = torch.sin(e) * torch.sin(L)
    ra = torch.atan2(torch.cos(e) * torch.sin(L), torch.cos(L))
    GMST = 18.697374558 + 24.06570982441908 * D
    LST = GMST + lon / 15.0
    h = LST / 12.0 * math.pi - ra
    lat_r = deg2rad(lat)
    return (torch.sin(lat_r) * sindec
            + torch.cos(lat_r) * torch.sqrt(1.0 - sindec * sindec)
            * torch.cos(h))


def _lat_ref(ctl: Ctl, lat):
    return (lat if ctl.met_coord_type == 0
            else torch.full_like(lat, ctl.met_utm_ref_lat))


def clim_oh(ctl: Ctl, clim: Clim, t, lon, lat, p):
    """OH climatology with optional diurnal SZA correction
    (reference clim_oh, c:89)."""
    lat_ref = _lat_ref(ctl, lat)
    lon_ref = (lon if ctl.met_coord_type == 0
               else torch.full_like(lon, ctl.met_utm_ref_lon))
    lon_ref = torch.remainder(lon_ref + 180.0, 360.0) - 180.0
    oh = cl.clim_zm(clim.zm["oh"], t, lat_ref, p)
    if ctl.oh_chem_beta <= 0:
        return oh
    csza_thresh = math.cos(deg2rad(85.0))
    csza = cos_sza(t, lon_ref, lat_ref)
    denom = torch.clamp(csza, min=csza_thresh)
    return oh * torch.exp(-ctl.oh_chem_beta / denom)


def module_chem_init(ctl: Ctl, clim: Clim, met01: Met, atm: Atm) -> Atm:
    """Initialize chemistry quantities from met + climatology
    (reference module_chem_init, c:4050).  A quantity whose table the
    climatology does not hold is left as it is."""
    q = dict(atm.q)
    wanted = [k for k in ("Ch2o", "Co3", "Coh", "Cho2", "Ch2o2", "Co1d")
              if k in q]
    if not wanted:
        return atm
    if "Ch2o" in q or "Co3" in q:
        loc = interp.locate_3d(met01, atm.lon, atm.lat, atm.p)
        if "Ch2o" in q:
            q["Ch2o"] = interp.interp_time_3d(met01, "h2o", atm.time, loc)
        if "Co3" in q:
            q["Co3"] = interp.interp_time_3d(met01, "o3", atm.time, loc)
    lat_ref = _lat_ref(ctl, atm.lat)
    if "Coh" in q and "oh" in clim.zm:
        q["Coh"] = clim_oh(ctl, clim, atm.time, atm.lon, atm.lat, atm.p)
    for qname, table in (("Cho2", "ho2"), ("Ch2o2", "h2o2"),
                         ("Co1d", "o1d")):
        if qname in q and table in clim.zm:
            q[qname] = cl.clim_zm(clim.zm[table], atm.time, lat_ref, atm.p)
    return atm.replace(q=q)
