"""Wet and dry deposition.

Reference: module_wet_depo (mptrac.c:5963-6098), module_dry_depo
(c:4730-4793).  Counterpart of the JAX package's ``physics/depo.py``.
The Henry's-law constants of a gas come from the ``SPECIES`` preset
(``config.SPECIES_TABLE``) unless ``WET_DEPO_IC_H`` / ``WET_DEPO_BC_H``
set them."""

from __future__ import annotations

import torch

from mptrac_tpu_torch.config import Ctl
from mptrac_tpu_torch.constants import RI
from mptrac_tpu_torch.ops import interp, thermo
from mptrac_tpu_torch.physics.chem import _apply_loss, _require_mass_or_vmr
from mptrac_tpu_torch.types import Atm, Cache, Met
from mptrac_tpu_torch.utils.timers import span


@span("wet_depo")
def module_wet_depo(ctl: Ctl, cache: Cache, met01: Met, atm: Atm) -> Atm:
    """In-cloud / below-cloud scavenging (c:5963): precipitation rate
    from total column cloud water (Pisso et al. 2019), exponential
    coefficients for particles (Bakels et al. 2024) or Henry's law for
    gases, with temperature-dependent retention."""
    _require_mass_or_vmr(atm)
    loc = interp.locate_3d(met01, atm.lon, atm.lat, atm.p)
    pct = interp.interp_time_2d(met01, "pct", atm.time, loc)
    below_top = torch.isfinite(pct) & (atm.p > pct)
    pcb = interp.interp_time_2d(met01, "pcb", atm.time, loc)
    cl_ = interp.interp_time_2d(met01, "cl", atm.time, loc)

    Is = (torch.clamp(cl_, min=0.0) / ctl.wet_depo_pre[0]) ** (
        1.0 / ctl.wet_depo_pre[1])
    del cl_
    raining = Is >= 0.01

    inside = None
    for name in ("lwc", "rwc", "iwc", "swc"):
        wc = interp.interp_time_3d(met01, name, atm.time, loc) > 0
        inside = wc if inside is None else inside | wc
    t = interp.interp_time_3d(met01, "t", atm.time, loc)
    del loc

    dz = 1e3 * (thermo.altitude(pct) - thermo.altitude(pcb))
    dz = torch.where(dz != 0, dz, 1e30)
    del pct, pcb

    # In-cloud coefficient
    eta_ic = torch.where(
        t > 273.15, 1.0,
        torch.where(t <= 238.15, ctl.wet_depo_ic_ret_ratio,
                    1.0 + (ctl.wet_depo_ic_ret_ratio - 1.0)
                    * (273.15 - t) / (273.15 - 238.15)))
    if ctl.wet_depo_ic_a > 0:
        lam_ic = ctl.wet_depo_ic_a * Is ** ctl.wet_depo_ic_b * eta_ic
    elif ctl.wet_depo_ic_h[0] > 0:
        h = ctl.wet_depo_ic_h[0] * torch.exp(
            ctl.wet_depo_ic_h[1] * (1.0 / t - 1.0 / 298.15))
        if ctl.wet_depo_so2_ph > 0:
            H_ion = 10.0 ** (-ctl.wet_depo_so2_ph)
            K_1 = 1.23e-2 * torch.exp(2.01e3 * (1.0 / t - 1.0 / 298.15))
            K_2 = 6e-8 * torch.exp(1.12e3 * (1.0 / t - 1.0 / 298.15))
            h = h * (1.0 + K_1 / H_ion + K_1 * K_2 / (H_ion * H_ion))
        lam_ic = h * RI * t * Is / 3.6e6 / dz * eta_ic
    else:
        lam_ic = torch.zeros_like(t)

    # Below-cloud coefficient
    eta_bc = torch.where(t > 270.0, 1.0, ctl.wet_depo_bc_ret_ratio)
    if ctl.wet_depo_bc_a > 0:
        lam_bc = ctl.wet_depo_bc_a * Is ** ctl.wet_depo_bc_b * eta_bc
    elif ctl.wet_depo_bc_h[0] > 0:
        h = ctl.wet_depo_bc_h[0] * torch.exp(
            ctl.wet_depo_bc_h[1] * (1.0 / t - 1.0 / 298.15))
        lam_bc = h * RI * t * Is / 3.6e6 / dz * eta_bc
    else:
        lam_bc = torch.zeros_like(t)

    lam = torch.where(below_top & raining,
                      torch.where(inside, lam_ic, lam_bc), 0.0)
    return _apply_loss(atm, cache, lam, "mloss_wet")


@span("dry_depo")
def module_dry_depo(ctl: Ctl, cache: Cache, met01: Met, atm: Atm) -> Atm:
    """Deposition-velocity mass loss inside the surface layer
    (c:4730)."""
    _require_mass_or_vmr(atm)
    loc = interp.locate_3d(met01, atm.lon, atm.lat, atm.p)
    ps = interp.interp_time_2d(met01, "ps", atm.time, loc)
    in_layer = atm.p >= ps - ctl.dry_depo_dp
    dz = 1000.0 * (thermo.altitude(ps - ctl.dry_depo_dp)
                   - thermo.altitude(ps))
    if ctl.qnt("rp") >= 0 and ctl.qnt("rhop") >= 0:
        t = interp.interp_time_3d(met01, "t", atm.time, loc)
        v_dep = thermo.sedi_velocity(atm.p, t, atm.q["rp"], atm.q["rhop"])
    else:
        v_dep = ctl.dry_depo_vdep
    rate = torch.where(in_layer, v_dep / dz, 0.0)
    return _apply_loss(atm, cache, rate, "mloss_dry")
