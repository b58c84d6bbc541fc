"""Exponential and radioactive decay.

Reference: module_decay (mptrac.c:4219-4258), module_radio_decay
(c:5477-5535).  Counterpart of the JAX package's ``physics/decay.py``."""

from __future__ import annotations

import math

import torch

from mptrac_tpu_torch.config import Ctl
from mptrac_tpu_torch.physics.diffusion import tropo_weight
from mptrac_tpu_torch.types import Atm, Cache, Clim
from mptrac_tpu_torch.utils.timers import span

_LN2 = math.log(2.0)

#: decay constants [1/s] of the fixed chains (c:5487-5493)
LAMBDA = {
    "Arn222": _LN2 / (3.8235 * 86400.0),
    "Apb210": _LN2 / (22.3 * 365.25 * 86400.0),
    "Abe7": _LN2 / (53.22 * 86400.0),
    "Acs137": _LN2 / (30.05 * 365.25 * 86400.0),
    "Ai131": _LN2 / (8.02 * 86400.0),
    "Axe133": _LN2 / (5.2474 * 86400.0),
}


@span("decay")
def module_decay(ctl: Ctl, cache: Cache, clim: Clim, atm: Atm) -> Atm:
    """Exponential mass/vmr loss with troposphere/stratosphere
    lifetimes blended across the tropopause (c:4219)."""
    if ctl.qnt("m") < 0 and ctl.qnt("vmr") < 0:
        raise ValueError(
            "Module needs quantity mass or volume mixing ratio!")
    active = (cache.dt != 0.0) & atm.mask
    w = tropo_weight(ctl, clim, atm.time, atm.lat, atm.p)
    tdec = w * ctl.tdec_trop + (1.0 - w) * ctl.tdec_strat
    aux = torch.exp(-cache.dt / tdec)
    q = dict(atm.q)
    if "m" in q:
        if "mloss_decay" in q:
            q["mloss_decay"] = torch.where(
                active, q["mloss_decay"] + q["m"] * (1.0 - aux),
                q["mloss_decay"])
        q["m"] = torch.where(active, q["m"] * aux, q["m"])
        if "loss_rate" in q:
            q["loss_rate"] = torch.where(
                active, q["loss_rate"] + 1.0 / tdec, q["loss_rate"])
    if "vmr" in q:
        q["vmr"] = torch.where(active, q["vmr"] * aux, q["vmr"])
    return atm.replace(q=q)


@span("radio_decay")
def module_radio_decay(ctl: Ctl, cache: Cache, atm: Atm) -> Atm:
    """Fixed radioactive decay chains, incl. Rn-222 -> Pb-210 in-growth
    (c:5477)."""
    active = (cache.dt != 0.0) & atm.mask
    dt = cache.dt
    q = dict(atm.q)

    if "Apb210" in q:
        q["Apb210"] = torch.where(
            active, q["Apb210"] * torch.exp(-dt * LAMBDA["Apb210"]),
            q["Apb210"])
    if "Arn222" in q:
        old = q["Arn222"]
        aux = torch.exp(-dt * LAMBDA["Arn222"])
        lost = old * (1.0 - aux)
        q["Arn222"] = torch.where(active, old * aux, old)
        if "Apb210" in q:
            q["Apb210"] = torch.where(
                active,
                q["Apb210"] + lost * LAMBDA["Apb210"] / LAMBDA["Arn222"],
                q["Apb210"])
        del aux, lost
    for name in ("Abe7", "Acs137", "Ai131", "Axe133"):
        if name in q:
            q[name] = torch.where(
                active, q[name] * torch.exp(-dt * LAMBDA[name]), q[name])
    return atm.replace(q=q)
