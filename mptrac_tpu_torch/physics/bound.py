"""Boundary conditions (reference module_bound_cond,
mptrac.c:3789-3885): re-initialize mass/vmr and climatological tracer
vmrs inside a latitude/pressure/surface-layer region, and tag the age
of air.

Counterpart of the JAX package's ``physics/bound.py``.  One difference
of dtype, not of value: a quantity keeps its dtype.  The JAX package's
``where`` with the float64 parcel time promotes a float32 ``m``,
``vmr``, ``aoa`` or tracer to float64; here the new value is rounded to
the quantity's dtype (float64 runs are unaffected)."""

from __future__ import annotations

import torch

from mptrac_tpu_torch.climatology import clim_ts
from mptrac_tpu_torch.config import Ctl
from mptrac_tpu_torch.ops import interp, thermo
from mptrac_tpu_torch.types import Atm, Cache, Clim, Met
from mptrac_tpu_torch.utils.timers import span

#: quantities the module writes, and the time series of each tracer
_WANTED = {"m", "vmr", "Cccl4", "Cccl3f", "Cccl2f2", "Cn2o", "Csf6", "aoa"}
_TRACERS = (("Cccl4", "ccl4"), ("Cccl3f", "ccl3f"), ("Cccl2f2", "ccl2f2"),
            ("Cn2o", "n2o"), ("Csf6", "sf6"))


@span("bound")
def module_bound_cond(ctl: Ctl, cache: Cache, clim: Clim, met01: Met,
                      atm: Atm) -> Atm:
    if not set(atm.q) & _WANTED:
        return atm

    sel = ((cache.dt != 0.0) & atm.mask
           & (atm.lat >= ctl.bound_lat0) & (atm.lat <= ctl.bound_lat1)
           & (atm.p <= ctl.bound_p0) & (atm.p >= ctl.bound_p1))

    if (ctl.bound_dps > 0 or ctl.bound_dzs > 0 or ctl.bound_zetas > 0
            or ctl.bound_pbl):
        loc = interp.locate_3d(met01, atm.lon, atm.lat, atm.p)
        ps = interp.interp_time_2d(met01, "ps", atm.time, loc)
        if ctl.bound_dps > 0:
            sel = sel & ~(atm.p < ps - ctl.bound_dps)
        if ctl.bound_dzs > 0:
            sel = sel & ~(thermo.altitude(atm.p)
                          > thermo.altitude(ps) + ctl.bound_dzs)
        if ctl.bound_zetas > 0:
            t = interp.interp_time_3d(met01, "t", atm.time, loc)
            sel = sel & ~(thermo.zeta(ps, atm.p, t) > ctl.bound_zetas)
        if ctl.bound_pbl:
            pbl = interp.interp_time_2d(met01, "pbl", atm.time, loc)
            sel = sel & ~(atm.p < pbl)

    q = dict(atm.q)

    def put(name, value):
        q[name] = torch.where(sel, value, q[name]).to(q[name].dtype)

    if "m" in q and ctl.bound_mass >= 0:
        put("m", ctl.bound_mass + ctl.bound_mass_trend * atm.time)
    if "vmr" in q and ctl.bound_vmr >= 0:
        put("vmr", ctl.bound_vmr + ctl.bound_vmr_trend * atm.time)
    for qn, key in _TRACERS:
        if qn in q and key in clim.ts:
            put(qn, clim_ts(clim.ts[key], atm.time))
    if "aoa" in q:
        put("aoa", atm.time)
    return atm.replace(q=q)
