"""Meteo sampling to particle attributes (reference module_meteo,
mptrac.c:5054-5161): interpolates met and derived quantities onto each
parcel for every registered quantity.  Counterpart of the JAX package's
``physics/meteo.py``.  A climatological quantity whose table the
climatology does not hold is left as it is, as there.

Runs for ALL parcels regardless of dt (PARTICLE_LOOP check_dt=0)."""

from __future__ import annotations

import torch

from mptrac_tpu_torch import climatology as cl
from mptrac_tpu_torch.config import Ctl
from mptrac_tpu_torch.constants import CPD, EPS, G0, H0, LV, RA
from mptrac_tpu_torch.ops import interp, thermo
from mptrac_tpu_torch.physics.chem import clim_oh
from mptrac_tpu_torch.ops.slab_interp import (SFC_FIELDS, sfc_from_loc,
                                              uvwt_from_loc)
from mptrac_tpu_torch.types import Atm, Cache, Clim, Met
from mptrac_tpu_torch.utils.timers import span

#: quantity name -> stacked 2-D met field (straight samplings)
_Q2D = {"ps": "ps", "ts": "ts", "zs": "zs", "us": "us", "vs": "vs",
        "ess": "ess", "nss": "nss", "shf": "shf", "lsm": "lsm",
        "sst": "sst", "pbl": "pbl", "pt": "pt", "tt": "tt", "zt": "zt",
        "h2ot": "h2ot", "pct": "pct", "pcb": "pcb", "cl": "cl",
        "plcl": "plcl", "plfc": "plfc", "pel": "pel", "cape": "cape",
        "cin": "cin", "o3c": "o3c"}

#: quantity name -> stacked 3-D met field
_Q3D = {"zg": "z", "t": "t", "u": "u", "v": "v", "w": "w", "pv": "pv",
        "h2o": "h2o", "o3": "o3", "lwc": "lwc", "rwc": "rwc",
        "iwc": "iwc", "swc": "swc", "cc": "cc"}

#: quantities derived from t, u, v, w and h2o at the parcel
_DERIV3 = ("rho", "vh", "vz", "psat", "psice", "pw", "sh", "rh",
           "rhice", "theta", "tvirt", "lapse", "tdew", "tice", "tnat",
           "tsts", "zeta_d")


@span("meteo")
def module_meteo(ctl: Ctl, cache: Cache, clim: Clim, met01: Met,
                 atm: Atm, pack=None, pre3d=None) -> Atm:
    """``pre3d`` supplies 3-D met values already interpolated at the
    parcel positions by the fused RK kernel, currently {"t": T}.
    ``pack`` is the MetPack whose tables serve u, v, w, T (``packT``,
    the uvwt kernel) and the surface quantities (``sfcT``) in float32
    compute mode; what they do not serve comes from the exact
    interpolation."""
    names = set(ctl.qnt_name)
    if not names:
        return atm
    q = dict(atm.q)
    pre3d = pre3d or {}
    fp32 = met01.lon.dtype == torch.float32
    packT = pack.packT if pack is not None and fp32 else None
    sfcT = pack.sfcT if pack is not None and fp32 else None
    derived = bool(names & set(_DERIV3))

    # The locate is shared by every interpolation below; skipped
    # entirely when pre3d and the quantity list leave nothing to gather.
    _loc = [None]

    def loc():
        if _loc[0] is None:
            _loc[0] = interp.locate_3d(met01, atm.lon, atm.lat, atm.p)
        return _loc[0]

    # One kernel call serves u, v, w and T
    kern_uvwt = None
    if packT is not None and any(
            (f in names or derived) and f not in pre3d
            for f in ("t", "u", "v", "w")):
        ku, kv, kw, kt = uvwt_from_loc(packT, met01, atm.time, loc())
        kern_uvwt = {"u": ku, "v": kv, "w": kw, "t": kt}

    vals3 = {}
    for qname, fname in _Q3D.items():
        if qname in names or (qname in ("t", "u", "v", "w", "h2o")
                              and derived):
            if fname in pre3d:
                vals3[fname] = pre3d[fname]
            elif kern_uvwt is not None and fname in kern_uvwt:
                vals3[fname] = kern_uvwt[fname]
            else:
                vals3[fname] = interp.interp_time_3d(met01, fname,
                                                     atm.time, loc())
    sfc_names = [f for q2, f in _Q2D.items()
                 if q2 in names and f in SFC_FIELDS]
    sfc_vals = (sfc_from_loc(sfcT, met01, sfc_names, atm.time, loc())
                if sfcT is not None and sfc_names else {})
    for qname, fname in _Q2D.items():
        if qname in names:
            q[qname] = (sfc_vals[fname] if fname in sfc_vals else
                        interp.interp_time_2d(met01, fname, atm.time,
                                              loc()))
    for qname, fname in _Q3D.items():
        if qname in names:
            q[qname] = vals3[fname]

    t = vals3.get("t")
    h2o = vals3.get("h2o")
    u = vals3.get("u")
    v = vals3.get("v")
    w = vals3.get("w")
    p = atm.p

    if "p" in names:
        q["p"] = p
    if "rho" in names:
        q["rho"] = thermo.rho(p, t)
    if "vh" in names:
        q["vh"] = torch.sqrt(u * u + v * v)
    if "vz" in names:
        q["vz"] = -1e3 * H0 / p * w
    if "psat" in names:
        q["psat"] = thermo.psat(t)
    if "psice" in names:
        q["psice"] = thermo.psice(t)
    if "pw" in names:
        q["pw"] = thermo.pw(p, h2o)
    if "sh" in names:
        q["sh"] = thermo.sh(h2o)
    if "rh" in names:
        q["rh"] = thermo.rh(p, t, h2o)
    if "rhice" in names:
        q["rhice"] = thermo.rhice(p, t, h2o)
    if "theta" in names:
        q["theta"] = thermo.theta(p, t)
    if "tvirt" in names:
        q["tvirt"] = thermo.tvirt(t, h2o)
    if "lapse" in names:
        q["lapse"] = _lapse_rate(t, h2o)
    if "zeta_d" in names:
        ps_v = q.get("ps")
        if ps_v is None:
            ps_v = interp.interp_time_2d(met01, "ps", atm.time, loc())
        q["zeta_d"] = thermo.zeta(ps_v, p, t)
    if "tdew" in names:
        q["tdew"] = thermo.tdew(p, h2o)
    if "tice" in names:
        q["tice"] = thermo.tice(p, h2o)

    lat_ref = (atm.lat if ctl.met_coord_type == 0
               else torch.full_like(atm.lat, ctl.met_utm_ref_lat))
    if "hno3" in names and "hno3" in clim.zm:
        q["hno3"] = cl.clim_zm(clim.zm["hno3"], atm.time, lat_ref, p)
    if "oh" in names and "oh" in clim.zm:
        q["oh"] = clim_oh(ctl, clim, atm.time, atm.lon, atm.lat, p)
    for qname in ("h2o2", "ho2", "o1d"):
        if qname in names and qname in clim.zm:
            q[qname] = cl.clim_zm(clim.zm[qname], atm.time, lat_ref, p)
    if "tnat" in names and "hno3" in clim.zm:
        q["tnat"] = thermo.nat_temperature(
            p, h2o, cl.clim_zm(clim.zm["hno3"], atm.time, atm.lat, p))
    if "tsts" in names:
        q["tsts"] = 0.5 * (q["tice"] + q["tnat"])
    return atm.replace(q=q)


def _lapse_rate(t, h2o):
    """Moist adiabatic lapse rate [K/km] (reference lapse_rate,
    c:12332)."""
    a = RA * t * t
    r = thermo.sh(h2o) / (1.0 - thermo.sh(h2o))
    return 1e3 * G0 * (a + LV * r * t) / (CPD * a + LV * LV * r * EPS)
