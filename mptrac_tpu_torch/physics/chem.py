"""Chemistry modules: chemistry grid, OH / H2O2 / tracer chemistry.

Counterpart of the JAX package's ``physics/chem.py`` (reference
module_chem_grid c:3885-4050, module_chem_init c:4050-4094,
module_oh_chem c:5335-5419, module_h2o2_chem c:4793-4878,
module_tracer_chem c:5889-5963, clim_oh c:89-124, cos_sza c:1857,
clim_photo c:156-213).  ``molec_dens`` is the reference's MOLEC_DENS
macro as the JAX chemistry writes it; ``ops.thermo.molec_dens`` is
another formula (``7.243e21 * p / t``, a factor 1000 larger) that no
module uses, so it is not the one called here.

The chemistry grid sums the mass per box with ``index_add_`` (the JAX
package's ``segment_sum``; see ``physics.mixing``).  Its box centres
are float64, as the JAX package's integer-plus-float promotion makes
them; a quantity the modules write keeps its dtype.
"""

from __future__ import annotations

import math

import torch

from mptrac_tpu_torch import climatology as cl
from mptrac_tpu_torch.config import Ctl
from mptrac_tpu_torch.constants import AVO, MA, RE, RI
from mptrac_tpu_torch.ops import interp
from mptrac_tpu_torch.ops.interp import locate_irr, locate_reg
from mptrac_tpu_torch.ops.thermo import deg2rad, pressure, rho as rho_air
from mptrac_tpu_torch.physics.mixing import box_index, box_sum, grid_indices
from mptrac_tpu_torch.types import Atm, Cache, Clim, Met
from mptrac_tpu_torch.utils.timers import span


def molec_dens(p, t):
    """Molecular density [molec/cm^3] (reference MOLEC_DENS macro,
    mptrac.h:1284): AVO * 1e-6 * (p*100) / (RI * t)."""
    return AVO * 1e-6 * (p * 100.0) / (RI * t)


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


def clim_photo(rate, clim: Clim, p, sza, o3c):
    """Photolysis-rate table lookup [1/s] (reference clim_photo,
    c:156): trilinear in (p, sza, o3c) with range clamping."""
    pp = torch.clamp(p, torch.minimum(clim.photo_p[0], clim.photo_p[-1]),
                     torch.maximum(clim.photo_p[0], clim.photo_p[-1]))
    sz = torch.clamp(sza, clim.photo_sza[0], clim.photo_sza[-1])
    oc = torch.clamp(o3c, clim.photo_o3c[0], clim.photo_o3c[-1])
    ip = locate_irr(clim.photo_p, pp)
    isza = locate_reg(clim.photo_sza, sz)
    io3c = locate_reg(clim.photo_o3c, oc)

    def lin(x0, y0, x1, y1, x):
        return y0 + (y1 - y0) / (x1 - x0) * (x - x0)

    p0, p1 = clim.photo_p[ip], clim.photo_p[ip + 1]
    aux00 = lin(p0, rate[ip, isza, io3c], p1, rate[ip + 1, isza, io3c], pp)
    aux01 = lin(p0, rate[ip, isza, io3c + 1], p1,
                rate[ip + 1, isza, io3c + 1], pp)
    aux10 = lin(p0, rate[ip, isza + 1, io3c], p1,
                rate[ip + 1, isza + 1, io3c], pp)
    aux11 = lin(p0, rate[ip, isza + 1, io3c + 1], p1,
                rate[ip + 1, isza + 1, io3c + 1], pp)
    o0, o1 = clim.photo_o3c[io3c], clim.photo_o3c[io3c + 1]
    aux0 = lin(o0, aux00, o1, aux01, oc)
    aux1 = lin(o0, aux10, o1, aux11, oc)
    s0, s1 = clim.photo_sza[isza], clim.photo_sza[isza + 1]
    return torch.clamp(lin(s0, aux0, s1, aux1, sz), min=0.0)


@span("chem_grid")
def module_chem_grid(ctl: Ctl, met01: Met, atm: Atm, t: float) -> Atm:
    """Per-grid-box volume mixing ratio Cx from the binned mass and the
    temperature at the box centre (reference module_chem_grid, c:3885)."""
    if "m" not in atm.q or "Cx" not in atm.q:
        return atm
    if ctl.molmass <= 0:
        raise ValueError("Molar mass is not defined!")

    nx, ny, nz = ctl.chemgrid_nx, ctl.chemgrid_ny, ctl.chemgrid_nz
    ix, iy, iz, ok = grid_indices(ctl, atm, t, "chemgrid")
    idx, nbox = box_index(ctl, atm, ix, iy, iz, ok, nx, ny, nz)
    mass = box_sum(torch.where(ok, atm.q["m"], 0.0), idx, nbox)

    f64 = torch.float64
    dz = (ctl.chemgrid_z1 - ctl.chemgrid_z0) / nz
    dlon = (ctl.chemgrid_lon1 - ctl.chemgrid_lon0) / nx
    dlat = (ctl.chemgrid_lat1 - ctl.chemgrid_lat0) / ny
    pc = pressure(ctl.chemgrid_z0 + dz * (iz.to(f64) + 0.5))
    lonc = ctl.chemgrid_lon0 + dlon * (ix.to(f64) + 0.5)
    latc = ctl.chemgrid_lat0 + dlat * (iy.to(f64) + 0.5)
    del ix, iy, iz
    area = (dlat * dlon * (RE * math.pi / 180.0) ** 2
            * torch.cos(deg2rad(latc)))

    loc = interp.locate_3d(met01, lonc, latc, pc)
    temp = interp.interp_time_3d(met01, "t", torch.full_like(atm.time, t),
                                 loc)
    del loc, lonc, latc

    cx = MA / ctl.molmass * mass[idx] / (rho_air(pc, temp) * area * dz
                                         * 1e9)
    q = dict(atm.q)
    q["Cx"] = torch.where(ok, cx, q["Cx"]).to(q["Cx"].dtype)
    return atm.replace(q=q)


def _apply_loss(atm: Atm, cache: Cache, rate_coef, mloss_key=None):
    """Common exponential-loss update of m/vmr with bookkeeping."""
    active = (cache.dt != 0.0) & atm.mask
    aux = torch.exp(-cache.dt * rate_coef)
    q = dict(atm.q)

    def put(name, value):
        q[name] = torch.where(active, value, q[name]).to(q[name].dtype)

    if "m" in q:
        if mloss_key and mloss_key in q:
            put(mloss_key, q[mloss_key] + q["m"] * (1.0 - aux))
        put("m", q["m"] * aux)
        if "loss_rate" in q:
            put("loss_rate", q["loss_rate"] + rate_coef)
    if "vmr" in q:
        put("vmr", q["vmr"] * aux)
    return atm.replace(q=q)


def _require_mass_or_vmr(atm: Atm):
    if "m" not in atm.q and "vmr" not in atm.q:
        raise ValueError(
            "Module needs quantity mass or volume mixing ratio!")


def _so2_correction(atm: Atm, a: float, b: float):
    """High-SO2 correction of an oxidant (c:5392-5398, c:4843-4849):
    ``a * Cx**b`` above ``Cx = (1/a)**(1/b)``, 1 below or without Cx."""
    if "Cx" not in atm.q:
        return 1.0
    cx = atm.q["Cx"]
    low = (1.0 / a) ** (1.0 / b)
    return torch.where(cx > low, a * torch.clamp(cx, min=1e-30) ** b, 1.0)


@span("oh_chem")
def module_oh_chem(ctl: Ctl, cache: Cache, clim: Clim, met01: Met,
                   atm: Atm) -> Atm:
    """OH loss chemistry, JPL 19-05 rates (reference c:5335)."""
    _require_mass_or_vmr(atm)
    if ctl.oh_chem_reaction not in (1, 2, 3):
        return atm
    loc = interp.locate_3d(met01, atm.lon, atm.lat, atm.p)
    t = interp.interp_time_3d(met01, "t", atm.time, loc)
    del loc
    M = molec_dens(atm.p, t)

    if ctl.oh_chem_reaction == 1:
        k = ctl.oh_chem[0]
    elif ctl.oh_chem_reaction == 2:
        k = ctl.oh_chem[0] * torch.exp(-ctl.oh_chem[1] / t)
    else:
        k0 = ctl.oh_chem[0] * ((298.0 / t) ** ctl.oh_chem[1]
                               if ctl.oh_chem[1] != 0 else 1.0)
        ki = ctl.oh_chem[2] * ((298.0 / t) ** ctl.oh_chem[3]
                               if ctl.oh_chem[3] != 0 else 1.0)
        c = torch.log10(k0 * M / ki)
        k = k0 * M / (1.0 + k0 * M / ki) * 0.6 ** (1.0 / (1.0 + c * c))

    cor = _so2_correction(atm, 4.71572206e-08, -8.28782867e-01)
    rate = (k * clim_oh(ctl, clim, atm.time, atm.lon, atm.lat, atm.p)
            * M * cor)
    return _apply_loss(atm, cache, rate, "mloss_oh")


@span("h2o2_chem")
def module_h2o2_chem(ctl: Ctl, cache: Cache, clim: Clim, met01: Met,
                     atm: Atm) -> Atm:
    """Aqueous-phase SO2 oxidation by H2O2 inside clouds
    (reference c:4793)."""
    _require_mass_or_vmr(atm)
    loc = interp.locate_3d(met01, atm.lon, atm.lat, atm.p)
    lwc = interp.interp_time_3d(met01, "lwc", atm.time, loc)
    rwc = interp.interp_time_3d(met01, "rwc", atm.time, loc)
    t = interp.interp_time_3d(met01, "t", atm.time, loc)
    del loc
    incloud = (lwc > 0) | (rwc > 0)
    M = molec_dens(atm.p, t)
    k = 9.1e7 * torch.exp(-29700.0 / RI * (1.0 / t - 1.0 / 298.15))
    H_SO2 = 1.3e-2 * torch.exp(2900.0 * (1.0 / t - 1.0 / 298.15)) * RI * t
    K_1S = 1.23e-2 * torch.exp(2.01e3 * (1.0 / t - 1.0 / 298.15))
    H_h2o2 = 8.3e2 * torch.exp(7600.0 * (1.0 / t - 1.0 / 298.15)) * RI * t

    cor = _so2_correction(atm, 3.12541941e-06, -5.72532259e-01)
    h2o2 = (H_h2o2 * cl.clim_zm(clim.zm["h2o2"], atm.time, atm.lat, atm.p)
            * M * cor * 1000.0 / AVO)
    rho_w = atm.p / (RI * t) * MA / 10.0
    CWC = (lwc + rwc) * rho_w / 1e3
    rate = torch.where(incloud, k * K_1S * h2o2 * H_SO2 * CWC, 0.0)
    return _apply_loss(atm, cache, rate, "mloss_h2o2")


#: (quantity, O(1D) Arrhenius A, E/R, photolysis-table key)
_TRACER_REACTIONS = (
    ("Cccl4", 3.30e-10, 0.0, "ccl4"),
    ("Cccl3f", 2.30e-10, 0.0, "ccl3f"),
    ("Cccl2f2", 1.40e-10, -25.0, "ccl2f2"),
    ("Cn2o", 1.19e-10, -20.0, "n2o"),
)


@span("tracer_chem")
def module_tracer_chem(ctl: Ctl, cache: Cache, clim: Clim, met01: Met,
                       atm: Atm) -> Atm:
    """CFC-10/11/12 + N2O photolysis + O(1D) loss (reference c:5889)."""
    if not any(name in atm.q for name, *_ in _TRACER_REACTIONS):
        return atm
    active = (cache.dt != 0.0) & atm.mask
    loc = interp.locate_3d(met01, atm.lon, atm.lat, atm.p)
    t = interp.interp_time_3d(met01, "t", atm.time, loc)
    o3c = interp.interp_time_2d(met01, "o3c", atm.time, loc)
    del loc
    M = molec_dens(atm.p, t)
    sza = torch.arccos(torch.clamp(cos_sza(atm.time, atm.lon, atm.lat),
                                   -1.0, 1.0))
    o1d = (cl.clim_zm(clim.zm["o1d"], atm.time, atm.lat, atm.p)
           if "o1d" in clim.zm else 0.0)

    q = dict(atm.q)
    for name, A, EoverR, photkey in _TRACER_REACTIONS:
        if name not in q:
            continue
        k_o1d = A * torch.exp(-EoverR / t) * o1d * M
        k_hv = (clim_photo(clim.photo[photkey], clim, atm.p, sza, o3c)
                if photkey in clim.photo else 0.0)
        q[name] = torch.where(
            active, q[name] * torch.exp(-cache.dt * (k_hv + k_o1d)),
            q[name]).to(q[name].dtype)
    return atm.replace(q=q)
