"""Extreme convection parameterization (reference module_convection,
mptrac.c:4094-4168): where CAPE exceeds the threshold (and optionally
within the PBL), parcels are redistributed at random in the vertical,
uniform in density, between the surface and the equilibrium level.

Counterpart of the JAX package's ``physics/convection.py``.  The uniform
draws come from the Squares counter (``ops.rng.module_rng``, method 0),
one per parcel slot, so the counter advances as there."""

from __future__ import annotations

import torch

from mptrac_tpu_torch.config import Ctl
from mptrac_tpu_torch.ops import interp
from mptrac_tpu_torch.ops.rng import module_rng
from mptrac_tpu_torch.types import Atm, Cache, Met
from mptrac_tpu_torch.utils.timers import span


@span("convection")
def module_convection(ctl: Ctl, cache: Cache, met01: Met, atm: Atm):
    rs, ctr = module_rng(ctl.rng_type, cache.rng_ctr, atm.npmax, 0,
                         dtype=atm.lon.dtype, device=atm.lon.device,
                         part=cache.rng_part)
    cache = cache.replace(rng_ctr=ctr)

    active = (cache.dt != 0.0) & atm.mask
    loc = interp.locate_3d(met01, atm.lon, atm.lat, atm.p)
    ps = interp.interp_time_2d(met01, "ps", atm.time, loc)

    pbot = ps
    ptop = ps
    if ctl.conv_mix_pbl:
        pbl = interp.interp_time_2d(met01, "pbl", atm.time, loc)
        ptop = pbl - ctl.conv_pbl_trans * (ps - pbl)
        del pbl
    if ctl.conv_cape >= 0:
        cape = interp.interp_time_2d(met01, "cape", atm.time, loc)
        trig = torch.isfinite(cape) & (cape >= ctl.conv_cape)
        del cape
        if ctl.conv_cin > 0:
            cin = interp.interp_time_2d(met01, "cin", atm.time, loc)
            trig &= torch.isfinite(cin) & (cin >= ctl.conv_cin)
            del cin
        pel = interp.interp_time_2d(met01, "pel", atm.time, loc)
        ptop = torch.where(trig, torch.minimum(ptop, pel), ptop)
        del pel, trig
    del loc

    mix = active & (ptop != pbot) & (atm.p >= ptop)
    del active

    loc_b = interp.locate_3d(met01, atm.lon, atm.lat, pbot)
    tbot = interp.interp_time_3d(met01, "t", atm.time, loc_b)
    del loc_b
    loc_t = interp.locate_3d(met01, atm.lon, atm.lat, ptop)
    ttop = interp.interp_time_3d(met01, "t", atm.time, loc_t)
    del loc_t
    rhobot = pbot / tbot
    rhotop = ptop / ttop
    rho = rhobot + (rhotop - rhobot) * rs
    p_new = pbot + (ptop - pbot) / torch.where(
        rhotop != rhobot, rhotop - rhobot, 1.0) * (rho - rhobot)
    return atm.replace(p=torch.where(mix, p_new, atm.p)), cache
